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


def glob_single_file(directory, pattern):
    """The unique file matching `pattern` under `directory`, or ValueError."""
    matches = sorted(Path(str(directory)).expanduser().glob(pattern))
    if len(matches) != 1:
        raise ValueError(
            f'expected exactly one match for {pattern!r} in {directory}, '
            f'found {len(matches)}')
    return matches[0]


def pil2array(image, mode='RGB'):
    """PIL image -> numpy uint8 array in the requested channel order."""
    return np.asarray(image.convert(mode.upper()))


def array2pil(image, mode='RGB'):
    """Numpy HWC array -> PIL RGB image; `mode` names the array's channel
    order (a 'BGR' array is reordered into RGB)."""
    from PIL import Image
    order = [mode.upper().index(c) for c in 'RGB']
    return Image.fromarray(np.ascontiguousarray(np.asarray(image)[..., order]),
                           mode='RGB')


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


class ImageLoader:
    """Restartable iterator over image files yielding uint8 RGB arrays.

    Accepts a directory (its files, sorted) or a list of files; `filename`
    is the file of the most recent image and `size` the number of files.
    Every `display` images it prints (or logs, with ``log=True``) the
    count and the rate.
    """

    def __init__(self, source, prefix=None, display=100, log=False):
        if isinstance(source, (list, tuple)):
            self.files = [_as_path(f, prefix) for f in source]
        else:
            root = _as_path(source)
            if not root.is_dir():
                raise IOError(f'not a directory or file list: {source}')
            self.files = sorted(p for p in root.glob('*') if p.is_file())

        self.display = display
        self.log = log
        self.size = len(self.files)
        self.start_time = time.time()
        self.filename = None
        self._cursor = 0

    def __len__(self):
        return self.size

    def __iter__(self):
        return self

    def __next__(self):
        if self._cursor >= self.size:
            raise StopIteration
        path = self.files[self._cursor]
        self._cursor += 1
        self.filename = str(path)
        if self.display and self._cursor % int(self.display) == 0:
            elapsed = time.time() - self.start_time
            info = (f'{self._cursor}/{self.size} images '
                    f'({self._cursor / max(elapsed, 1e-9):.1f} img/s)')
            if self.log:
                from facenet_tpu_torch.logging import logger
                logger.info(info)
            else:
                print(info, flush=True)
        return read_image(path)

    def reset(self):
        self._cursor = 0
        return self


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


def git_hash():
    return _run_git('rev-parse', 'HEAD')


def git_diff():
    return _run_git('diff', 'HEAD')


def provenance():
    """Everything needed to reproduce a run, as an ordered dict of lines."""
    import platform

    import torch

    return {
        'release version': platform.version(),
        'python version': sys.version,
        'torch version': torch.__version__,
        'arguments': ' '.join(sys.argv),
        'git hash': git_hash(),
        'git diff': git_diff(),
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
