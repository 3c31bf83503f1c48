"""HDF5 storage for run artifacts and stored embeddings. ``h5py`` is
imported only when a file is opened, so the package imports on a machine
without it."""

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


def read(file, name, default=None):
    """Read dataset `name`; return `default` if absent (None raises)."""
    with _open(file, 'r') as hf:
        if name in hf:
            return hf[name][...]
    if default is not None:
        return default
    raise KeyError(f'Invalid key {name} in H5 file {file}')


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


def keys(file):
    with _open(file, 'r') as f:
        return list(f.keys())


def write_image(file, name, image, mode='a', check_name=True):
    """Store a uint8 image; refuses to overwrite unless check_name=False."""
    with _open(file, mode) as f:
        exists = name in f
        if exists and check_name:
            raise IOError(f'data set {name} has already existed')
        if exists:
            f[name][...] = image
        else:
            f.create_dataset(name=name, data=image, dtype='uint8',
                             compression='gzip', compression_opts=9)


def visit(file, func=print):
    """Call `func` on the name of every group and dataset in the file."""
    with _open(file, 'r') as f:
        f.visit(func)


def visititems(file, func=None):
    """Walk every object of the file with ``func(name, obj)``; with no
    func, return ``[{'name', 'shape', 'type'}, ...]`` of its datasets."""
    import h5py

    collected = []
    if func is None:
        def func(name, obj):
            if isinstance(obj, h5py.Dataset):
                collected.append({'name': name, 'shape': obj.shape,
                                  'type': obj.dtype})
    with _open(file, 'r') as f:
        f.visititems(func)
    return collected
