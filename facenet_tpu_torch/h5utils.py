"""HDF5 writers for run artifacts. ``h5py`` is imported only when a file is
written, so the package imports on a machine without it."""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np

GZIP = {'compression': 'gzip'}


@contextlib.contextmanager
def _open(file, mode):
    """Open an h5 file by path-ish, creating parent dirs for writes."""
    import h5py

    path = Path(str(file)).expanduser()
    if mode != 'r':
        path.parent.mkdir(parents=True, exist_ok=True)
    handle = h5py.File(str(path), mode=mode)
    try:
        yield handle
    finally:
        handle.close()


def _flatten(tree, prefix=''):
    """Yield (name, value) pairs for every non-dict leaf of a nested dict."""
    for key, value in tree.items():
        name = f'{prefix}/{key}' if prefix else str(key)
        if isinstance(value, dict):
            yield from _flatten(value, name)
        else:
            yield name, value


def write(file, name, data, mode='a'):
    """Store `data` under `name`, replacing any existing dataset."""
    array = np.atleast_1d(data)
    with _open(file, mode) as hf:
        if str(name) in hf:
            del hf[str(name)]
        hf.create_dataset(str(name), data=array, dtype=array.dtype, **GZIP)


def write_dict(file, dct, group=None):
    """Append a (nested) dict of scalars/arrays into growable datasets.

    Each call extends every leaf dataset along axis 0 — the per-epoch
    metric-history format the validation reports use.
    """
    with _open(file, 'a') as hf:
        for name, value in _flatten(dct, prefix=group or ''):
            chunk = np.atleast_1d(value)
            if name not in hf:
                hf.create_dataset(name, data=chunk, maxshape=(None,),
                                  dtype=chunk.dtype, **GZIP)
                continue
            ds = hf[name]
            old = ds.shape[0]
            ds.resize(old + chunk.shape[0], axis=0)
            ds[old:] = chunk


def filename2key(filename, key):
    """Map <...>/<class>/<image>.<ext> to '<class>/<image>/<key>'."""
    path = Path(filename)
    return '/'.join([path.parent.stem, path.stem, str(key)])
