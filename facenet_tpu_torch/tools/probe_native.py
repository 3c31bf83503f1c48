"""Probe a machine for the port's native image library
(``facenet_tpu_torch/native``): g++, the system's libjpeg, libpng and
zlib headers (the system build), the libjpeg-turbo and libpng16 that the
installed Pillow wheel carries (the other build: their names, each one's
SONAME and NEEDED entries), the linker cache's zlib, libjpeg and libpng;
then build and load the library as the port does, say which build it
took and in how long, and hold its decode of seeded JPEG and PNG files of
1x37 to 1080x1440 pixels to PIL's (max |d|; PIL decodes with the same
libjpeg-turbo where the library links Pillow's). Host only; needs PIL for
the decode check.

    python -m facenet_tpu_torch.tools.probe_native
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from facenet_tpu_torch import native


def _run(cmd):
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f'{cmd[0]}: {exc}'
    return (proc.stdout + proc.stderr).strip()


def summary():
    """One line: g++, the system headers the system build includes, and
    Pillow's libjpeg and libpng (what the other build links)."""
    try:
        _, jpeg, png = native.pillow_libs()
        pillow = f"Pillow's {jpeg.name} and {png.name}"
    except RuntimeError as exc:
        pillow = f"Pillow's libraries: {exc}"
    version = _run(['g++', '--version']).splitlines()
    if not version or 'g++' not in version[0]:
        return f'g++ not found; {pillow}'
    # imageio.cc's includes, in its order (jpeglib.h needs stdio's FILE)
    check = subprocess.run(
        ['g++', '-fsyntax-only', '-x', 'c++', '-'],
        input='#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n'
              '#include <zlib.h>\n',
        capture_output=True, text=True, timeout=60)
    errors = [line.split('error:')[-1].strip()
              for line in check.stderr.splitlines() if 'error:' in line]
    found = 'found' if check.returncode == 0 else f'not found: {errors[0]}'
    return f'{version[0]}; jpeglib.h, png.h, zlib.h {found}; {pillow}'


def decode_check(root):
    """Seeded JPEGs (quality 90) and PNGs through the library and PIL:
    [(name, max |d|)]."""
    from PIL import Image

    rng = np.random.default_rng(0)
    rows = []
    for h, w in ((250, 250), (97, 203), (1080, 1440), (1, 37)):
        img = np.clip(rng.normal(128, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        for suffix, kwargs in (('jpg', {'quality': 90}), ('png', {})):
            path = Path(root) / f'{h}x{w}.{suffix}'
            Image.fromarray(img).save(path, **kwargs)
            with Image.open(path) as pil:
                want = np.asarray(pil.convert('RGB'))
            got = native.decode_image_native_size(path)
            diff = (-1 if got is None or got.shape != want.shape else
                    int(np.abs(got.astype(np.int32) - want).max()))
            rows.append((path.name, diff))
    return rows


def main():
    print(_run(['nvidia-smi', '--query-gpu=name,power.limit',
                '--format=csv,noheader']))
    print(f'python {sys.version.split()[0]}')
    print(summary())
    try:
        libs = native.pillow_libs()
    except RuntimeError as exc:
        libs = ()
        print(exc)
    for lib in libs[1:]:
        entries = [f'{line.split("(")[1].split(")")[0]} '
                   f'{line.split("[")[1].rstrip("]")}'
                   for line in _run(['readelf', '-d', str(lib)]).splitlines()
                   if '(SONAME)' in line or '(NEEDED)' in line]
        print(f'{lib} ({lib.stat().st_size} bytes): '
              f'{"; ".join(entries) or "no readelf"}')
    print('ldconfig: ' + '; '.join(
        line.strip() for line in _run(['ldconfig', '-p']).splitlines()
        if any(key in line for key in ('libz.', 'libjpeg', 'libpng'))))

    t0 = time.monotonic()
    built = native.available()
    print(f'native.available() {built} in {time.monotonic() - t0:.1f} s; '
          f'library_source() {native.library_source()}')
    if not built:
        print(native.build_error())
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        rows = decode_check(tmp)
    print('decode against PIL, max |d|: '
          + ', '.join(f'{name} {diff}' for name, diff in rows))
    return 0 if all(diff == 0 for _, diff in rows) else 1


if __name__ == '__main__':
    sys.exit(main())
