"""Inspect a dataset: print its index statistics and find the images that
do not decode (checked by the native library's header probe, or with PIL's
verify where the library was not built), so that a corrupt file shows
before a training run reaches it.

    python -m facenet_tpu_torch.apps.dataset --path <dataset dir>
"""

from __future__ import annotations

import argparse
from pathlib import Path

from facenet_tpu_torch import dataset, native


def check_file(path):
    """None if the image decodes, else a line naming the file and why."""
    if native.available():
        return None if native.probe_image(path) else f'unreadable: {path}'
    from PIL import Image
    try:
        with Image.open(path) as image:
            image.verify()
        return None
    except Exception as err:    # any decode error marks the file
        return f'unreadable: {path} ({err})'


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--path', type=Path, required=True,
                        help='Path to dataset directory to check for '
                             'invalid files.')
    args = parser.parse_args(argv)

    dbase = dataset.DBase(dataset.DefaultConfig(args.path))
    print(dbase)

    problems = [p for p in map(check_file, dbase.files) if p]
    for problem in problems:
        print(problem)
    print(f'number of invalid files: {len(problems)}')
    return problems


if __name__ == '__main__':
    main()
