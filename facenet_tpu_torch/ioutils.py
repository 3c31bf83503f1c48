"""Run-directory artifacts: append-only text logs, elapsed-time records,
the arguments dump and provenance (revision_info.txt); image files read
and written with PIL, which is imported only there."""

from __future__ import annotations

import subprocess
import sys
import time
from datetime import datetime
from pathlib import Path

import numpy as np

SEPARATOR = '-' * 64


def _as_path(p, prefix=None):
    p = Path(str(p)).expanduser()
    if prefix is not None:
        p = Path(str(prefix)).expanduser() / p
    return p


def _writable(p):
    """Normalize a target path and make sure its parent directory exists."""
    p = _as_path(p)
    p.parent.mkdir(parents=True, exist_ok=True)
    return p


def makedirs(p):
    Path(str(p)).expanduser().mkdir(parents=True, exist_ok=True)


def read_image(file):
    """Decode an image file to a uint8 RGB array (IOError if unreadable)."""
    from PIL import Image
    path = _as_path(file)
    try:
        with Image.open(path) as img:
            return np.asarray(img.convert('RGB'))
    except Exception as exc:
        raise IOError(f'cannot read image {path}: {exc}') from exc


def write_image(image, filename):
    """Save a uint8 RGB array or PIL image; parent directories are created."""
    from PIL import Image
    path = _writable(filename)
    if not isinstance(image, Image.Image):
        image = Image.fromarray(np.asarray(image, np.uint8), mode='RGB')
    try:
        image.convert('RGB').save(path)
    except Exception as exc:
        raise IOError(f'cannot write image {path}: {exc}') from exc


def write_to_file(file, text, mode='w'):
    with _writable(file).open(mode) as f:
        f.write(text)


def write_text_log(file, info):
    """Append one separator-framed entry to a run log."""
    entry = f'{SEPARATOR}\n{info}'
    if not entry.endswith('\n'):
        entry += '\n'
    write_to_file(file, entry, mode='a')


def get_time():
    """Start-time token for write_elapsed_time (monotonic clock)."""
    return time.monotonic()


def write_elapsed_time(targets, start_time):
    """Record minutes elapsed since `start_time` into each target; targets
    ending in .h5 get an appendable dataset, others an appended text line."""
    from facenet_tpu_torch import h5utils

    minutes = (time.monotonic() - start_time) / 60
    if not isinstance(targets, (list, tuple)):
        targets = [targets]

    for target in targets:
        path = _as_path(target)
        if path.suffix == '.h5':
            h5utils.write_dict(path, {'elapsed_time': minutes})
        else:
            write_to_file(path, f'elapsed time: {minutes:.3f}\n', mode='a')


def write_arguments(args, path, mode='a'):
    """Dump the run's config repr as <app>.yaml inside the run dir (or to
    an explicit .yaml/.yml path)."""
    path = _as_path(path)
    if path.suffix not in ('.yaml', '.yml'):
        path = path / (Path(sys.argv[0]).stem + '.yaml')
    write_to_file(path, f'{args}\n', mode=mode)


def _run_git(*args):
    """Output of a git command run from the package checkout, never raising
    (provenance must not be able to break a run)."""
    try:
        proc = subprocess.run(
            ['git', *args], cwd=Path(__file__).resolve().parent,
            capture_output=True, timeout=30)
        return proc.stdout.decode('utf-8', errors='replace').strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f'git {" ".join(args)} failed: {exc}'


def provenance():
    """Everything needed to reproduce a run, as an ordered dict of lines."""
    import platform

    import torch

    return {
        'release version': platform.version(),
        'python version': sys.version,
        'torch version': torch.__version__,
        'arguments': ' '.join(sys.argv),
        'git hash': _run_git('rev-parse', 'HEAD'),
        'git diff': _run_git('diff', 'HEAD'),
    }


def store_revision_info(target, mode='a'):
    """Write a provenance block to <run_dir>/revision_info.txt (or to an
    explicit .txt path)."""
    path = _as_path(target)
    if path.suffix != '.txt':
        path = path / 'revision_info.txt'

    lines = [SEPARATOR, f'store_revision_info {datetime.now()}']
    lines += [f'{key}: {value}' for key, value in provenance().items()]
    write_to_file(path, '\n'.join(lines) + '\n\n', mode=mode)
