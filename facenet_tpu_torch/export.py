"""Reading the JAX package's model bundles.

A bundle is a directory:

    <path>/
      model.yaml        — architecture config + image preprocessing contract
      params.msgpack    — flax-serialized {params, batch_stats}

``params.msgpack`` is read with this module's own decoder of flax's msgpack
format: a nested map of names whose array leaves are msgpack ext type 1 (3
for numpy scalars) holding a msgpack ``(shape, dtype name, C-order bytes)``
triple; arrays above 1 GiB are split into ``__msgpack_chunked_array__``
maps. ``yaml`` is imported only to read ``model.yaml``.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

MODEL_FILE = 'model.yaml'
PARAMS_FILE = 'params.msgpack'

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


@dataclasses.dataclass
class ModelBundle:
    """Variables (flax layout, numpy leaves) and the bundle's metadata."""
    variables: dict
    meta: dict

    @property
    def model_class(self):
        return self.meta.get('model_class', 'InceptionResnetV1')

    @property
    def config(self):
        return self.meta.get('config')

    @property
    def image_size(self):
        return int(self.meta.get('image_size', 160))

    @property
    def normalization(self):
        return int(self.meta.get('normalization', 0))


class _Reader:
    """A minimal msgpack decoder over one bytes buffer."""

    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        chunk = self.data[self.pos:self.pos + n]
        if len(chunk) != n:
            raise ValueError('truncated msgpack data')
        self.pos += n
        return chunk

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self):
        b = self.unpack('>B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return bytes(self.take(b & 0x1f)).decode('utf-8')
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I'}           # bin
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        sized = {0xd9: '>B', 0xda: '>H', 0xdb: '>I'}           # str
        if b in sized:
            return bytes(self.take(self.unpack(sized[b]))).decode('utf-8')
        numbers = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H',
                   0xce: '>I', 0xcf: '>Q', 0xd0: '>b', 0xd1: '>h',
                   0xd2: '>i', 0xd3: '>q'}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xdc, 0xdd):
            return self.array(self.unpack('>H' if b == 0xdc else '>I'))
        if b in (0xde, 0xdf):
            return self.map(self.unpack('>H' if b == 0xde else '>I'))
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            code = self.unpack('>b')
            return _ext(code, self.take(fixext[b]))
        sized = {0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}           # ext
        if b in sized:
            n = self.unpack(sized[b])
            code = self.unpack('>b')
            return _ext(code, self.take(n))
        raise ValueError(f'unsupported msgpack type byte 0x{b:02x}')

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ext(code, payload):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f'unsupported msgpack ext type {code}')
    shape, dtype_name, buffer = _Reader(payload).value()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == 'bfloat16':
        # widen bf16 bit patterns to float32 (bf16 is the top half)
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buffer, np.dtype(dtype_name)).copy()
    arr = arr.reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    """Reassemble flax's chunked array leaves in a decoded tree."""
    if not isinstance(tree, dict):
        return tree
    if tree.get('__msgpack_chunked_array__'):
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def msgpack_restore(data):
    """Decode flax msgpack bytes into a nested dict of numpy arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError('trailing bytes after the msgpack object')
    return _unchunk(tree)


def load_model(path):
    """Load an IRv1 bundle saved by ``facenet_tpu.export.save_model``.

    :raises NotImplementedError: for an Inception-ResNet-v2 bundle
    """
    import yaml

    path = Path(str(path)).expanduser()
    with (path / MODEL_FILE).open('rt') as f:
        meta = yaml.safe_load(f)

    bundle = ModelBundle(variables={}, meta=meta)
    if bundle.model_class != 'InceptionResnetV1':
        raise NotImplementedError(
            f'{bundle.model_class} bundles are not supported by the PyTorch '
            'port yet (only InceptionResnetV1)')

    variables = msgpack_restore((path / PARAMS_FILE).read_bytes())
    return ModelBundle(variables=variables, meta=meta)
