"""The port's `utils.debug` == the JAX package's (tests/test_debug_utils.py's
4 cases, each against JAX's function on the same inputs)."""

import numpy as np
import pytest
from PIL import Image

from facenet_tpu.utils import debug as jax_debug
from facenet_tpu_torch import utils
from facenet_tpu_torch.utils.debug import (ConcatenateImages, file2text,
                                           generate_filename, label_array)


def test_file2text():
    path = '/data/lfw/Alice_X/Alice_X_0001.png'
    assert file2text(path) == 'Alice_X/Alice_X_0001' == \
        jax_debug.file2text(path)


def test_generate_filename_same_and_different_class(tmp_path):
    for args in ((0.5, '/d/A/x.png', '/d/A/y.png'),
                 (1.25, '/d/A/x.png', '/d/B/y.png')):
        assert generate_filename(tmp_path, *args) == \
            jax_debug.generate_filename(tmp_path, *args)
    assert generate_filename(tmp_path, 0.5, '/d/A/x.png',
                             '/d/A/y.png').endswith('A|x & y & 0.500.png')


def test_label_array_matches_pdist_convention():
    labels = [0, 0, 1, 2, 1]
    out = label_array(labels)
    np.testing.assert_array_equal(out, jax_debug.label_array(labels))
    assert out.dtype == np.uint8
    with pytest.raises(ValueError):
        label_array('not-an-array')
    np.testing.assert_array_equal(label_array(np.array(labels)), out)
    assert utils.label_array is label_array


def test_concatenate_images_renders_and_saves(tmp_path):
    d = tmp_path / 'clsA'
    d.mkdir()
    f1, f2 = d / 'a.png', d / 'b.png'
    Image.fromarray(np.full((20, 20, 3), 50, np.uint8)).save(f1)
    Image.fromarray(np.full((20, 20, 3), 200, np.uint8)).save(f2)

    pair = ConcatenateImages(str(f1), str(f2), 0.75)
    want = jax_debug.ConcatenateImages(str(f1), str(f2), 0.75)
    assert pair.img.size == (40, 20)
    np.testing.assert_array_equal(np.asarray(pair.img), np.asarray(want.img))
    out = pair.save(tmp_path / 'port')
    assert (tmp_path / 'port' / 'clsA|a & b & 0.750.png').exists()
    assert out.endswith('0.750.png')
