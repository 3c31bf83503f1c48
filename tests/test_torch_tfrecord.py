"""The port's TFRecord codec against the JAX package's: CRC32C, byte-equal
files for the same embeddings, round trip, corruption detected."""

import numpy as np
import pytest

from facenet_tpu.utils import tfrecord as jax_tfrecord
from facenet_tpu_torch.utils import tfrecord


@pytest.mark.parametrize('data, crc', [
    (b'', 0x00000000),
    (b'123456789', 0xE3069283),           # the CRC-32C check value
    (bytes(32), 0x8A9136AA),              # RFC 3720 B.4: 32 zero bytes
    (b'\xff' * 32, 0x62A8AB43),           # RFC 3720 B.4: 32 0xff bytes
    (bytes(range(32)), 0x46DD794E),       # RFC 3720 B.4: incrementing
])
def test_crc32c_known_vectors(data, crc):
    assert tfrecord.crc32c(data) == crc
    assert tfrecord.crc32c(data) == jax_tfrecord.crc32c(data)


def _embeddings(rng, n=12, d=16):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    files = [f'/data/id_{int(c):02d}/img_{i:04d}.png'
             for i, c in enumerate(labels)]
    return emb, labels, files


def test_files_are_byte_identical_to_jax(tmp_path):
    emb, labels, files = _embeddings(np.random.default_rng(0))
    ours, theirs = tmp_path / 'port.tfrecord', tmp_path / 'jax.tfrecord'
    tfrecord.write_embeddings_tfrecord(ours, emb, labels, files)
    jax_tfrecord.write_embeddings_tfrecord(theirs, emb, labels, files)
    assert ours.read_bytes() == theirs.read_bytes()


def test_round_trip(tmp_path):
    emb, labels, files = _embeddings(np.random.default_rng(1))
    path = tmp_path / 'emb.tfrecord'
    tfrecord.write_embeddings_tfrecord(path, emb, labels, files)
    loaded = tfrecord.TFRecord(path)
    np.testing.assert_array_equal(loaded.embeddings, emb)
    np.testing.assert_array_equal(loaded.labels, labels)
    assert loaded.files == files
    # the JAX reader reads the port's file alike
    other = jax_tfrecord.TFRecord(path)
    np.testing.assert_array_equal(other.embeddings, emb)
    assert other.files == files
    np.testing.assert_array_equal(loaded.data, other.data)


@pytest.mark.parametrize('offset, match', [(9, 'header crc'),
                                           (-6, 'record crc')])
def test_corruption_is_detected(tmp_path, offset, match):
    emb, labels, files = _embeddings(np.random.default_rng(2), n=1)
    path = tmp_path / 'emb.tfrecord'
    tfrecord.write_embeddings_tfrecord(path, emb, labels, files)
    data = bytearray(path.read_bytes())
    data[offset] ^= 0x01
    path.write_bytes(bytes(data))
    with pytest.raises(IOError, match=match):
        list(tfrecord.read_tfrecord(path))
