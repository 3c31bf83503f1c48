"""TFRecord + tf.train.Example interchange, dependency-free.

A pure-Python encoder/decoder for the TFRecord framing (length +
masked-CRC32C records) and the subset of the protobuf wire format that
tf.train.Example uses, so embeddings files stay readable by TensorFlow
tooling without a TensorFlow dependency. The bytes written equal those of
the JAX package's writer for the same inputs.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (software, slice-by-1) with the TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding for tf.train.Example
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def bytes_feature(values) -> bytes:
    """Feature{bytes_list=BytesList(value=values)}."""
    if isinstance(values, (bytes, str)):
        values = [values]
    items = b''.join(
        _len_delim(1, v.encode() if isinstance(v, str) else v)
        for v in values)
    return _len_delim(1, items)           # Feature.bytes_list = field 1


def float_feature(values) -> bytes:
    """Feature{float_list=FloatList(value=values)}."""
    arr = np.asarray(values, dtype='<f4').ravel()
    packed = _tag(1, 2) + _varint(4 * arr.size) + arr.tobytes()
    return _len_delim(2, packed)          # Feature.float_list = field 2


def int64_feature(values) -> bytes:
    """Feature{int64_list=Int64List(value=values)}."""
    if np.isscalar(values):
        values = [values]
    items = b''.join(_tag(1, 0) + _varint(int(v) & (2**64 - 1))
                     for v in values)
    return _len_delim(3, items)           # Feature.int64_list = field 3


def make_example(features: dict) -> bytes:
    """Serialize Example{features=Features(feature={k: v})}."""
    entries = b''
    for key, feature in features.items():
        entry = _len_delim(1, key.encode()) + _len_delim(2, feature)
        entries += _len_delim(1, entry)    # Features.feature map entry
    return _len_delim(1, entries)          # Example.features = field 1


# ---------------------------------------------------------------------------
# minimal protobuf decoding (for the features we write)
# ---------------------------------------------------------------------------

def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 2:
            length, pos = _read_varint(buf, pos)
            yield field, buf[pos:pos + length]
            pos += length
        elif wire == 0:
            value, pos = _read_varint(buf, pos)
            yield field, value
        else:
            raise ValueError(f'unsupported wire type {wire}')


def parse_example(buf: bytes) -> dict:
    """Decode an Example produced by make_example (or TF) into python values."""
    out = {}
    for field, features_buf in _iter_fields(buf):
        if field != 1:
            continue
        for f2, entry in _iter_fields(features_buf):
            if f2 != 1:
                continue
            key = None
            feature = None
            for f3, val in _iter_fields(entry):
                if f3 == 1:
                    key = val.decode()
                elif f3 == 2:
                    feature = val
            if key is None or feature is None:
                continue
            for f4, payload in _iter_fields(feature):
                if f4 == 1:      # bytes_list
                    out[key] = [v for f5, v in _iter_fields(payload) if f5 == 1]
                elif f4 == 2:    # float_list (packed)
                    for f5, raw in _iter_fields(payload):
                        if f5 == 1:
                            out[key] = np.frombuffer(raw, dtype='<f4')
                elif f4 == 3:    # int64_list
                    out[key] = [v for f5, v in _iter_fields(payload) if f5 == 1]
    return out


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

class TFRecordWriter:
    def __init__(self, path):
        self._f = open(Path(str(path)).expanduser(), 'wb')

    def write(self, record: bytes):
        header = struct.pack('<Q', len(record))
        self._f.write(header)
        self._f.write(struct.pack('<I', _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack('<I', _masked_crc(record)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecord(path):
    """Yield raw records from a TFRecord file (with crc verification)."""
    with open(Path(str(path)).expanduser(), 'rb') as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack('<Q', header)
            (hcrc,) = struct.unpack('<I', f.read(4))
            if hcrc != _masked_crc(header):
                raise IOError('corrupt TFRecord: header crc mismatch')
            record = f.read(length)
            (rcrc,) = struct.unpack('<I', f.read(4))
            if rcrc != _masked_crc(record):
                raise IOError('corrupt TFRecord: record crc mismatch')
            yield record


# ---------------------------------------------------------------------------
# embeddings round-trip
# ---------------------------------------------------------------------------

def write_embeddings_tfrecord(path, embeddings, labels, files):
    """Write one Example per embedding: {embedding, label, file}."""
    with TFRecordWriter(path) as writer:
        for embedding, label, file in zip(embeddings, labels, files):
            example = make_example({
                'embedding': float_feature(embedding),
                'label': int64_feature(int(label)),
                'file': bytes_feature(str(file)),
            })
            writer.write(example)


class TFRecord:
    """Load an embeddings TFRecord back into arrays."""

    def __init__(self, path):
        embeddings, labels, files = [], [], []
        for record in read_tfrecord(path):
            ex = parse_example(record)
            embeddings.append(np.asarray(ex['embedding'], np.float32))
            labels.append(int(ex['label'][0]))
            files.append(ex['file'][0].decode())

        self.embeddings = np.stack(embeddings) if embeddings else \
            np.zeros((0, 0), np.float32)
        self.labels = np.asarray(labels)
        self.files = files

    @property
    def data(self):
        return self.embeddings
