"""The small helpers ported in slice 12, each against the JAX package's on
the same inputs: `ioutils` (PIL <-> array, ImageLoader, git provenance,
glob_single_file), `h5utils` (visit, visititems, write_image),
`facenet.inputs`, `check_output_size` and `detectors.pretrained.save_params`."""

import numpy as np
import pytest
import torch
from PIL import Image

import facenet_tpu
import facenet_tpu_torch
from facenet_tpu import facenet as jax_facenet
from facenet_tpu import h5utils as jax_h5utils
from facenet_tpu import ioutils as jax_ioutils
from facenet_tpu.config import Config as JaxConfig
from facenet_tpu.detectors import pretrained as jax_pretrained
from facenet_tpu_torch import facenet, h5utils, ioutils
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.detectors import pretrained
from facenet_tpu_torch.models.inception_resnet_v1 import InceptionResnetV1
from torch_testing import few_threads  # noqa: F401


def test_pil_array_round_trips_equal_jax():
    rng = np.random.RandomState(0)
    bgr = rng.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    for mode in ('RGB', 'BGR'):
        got, want = ioutils.array2pil(bgr, mode), jax_ioutils.array2pil(bgr,
                                                                         mode)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        for out in ('RGB', 'L'):
            np.testing.assert_array_equal(ioutils.pil2array(got, out),
                                          jax_ioutils.pil2array(want, out))


def test_node_name_contract_equals_jax():
    assert facenet_tpu_torch.nodes == facenet_tpu.nodes
    assert facenet_tpu_torch.config_nodes == facenet_tpu.config_nodes


def test_image_loader_equals_jax(tmp_path, capsys):
    rng = np.random.RandomState(1)
    for i in range(5):
        Image.fromarray(rng.randint(0, 256, (6, 4, 3)).astype(np.uint8)) \
            .save(tmp_path / f'{i}.png')
    port = ioutils.ImageLoader(tmp_path, display=2)
    jax = jax_ioutils.ImageLoader(tmp_path, display=0)
    assert len(port) == port.size == 5
    for got, want in zip(port, jax):
        np.testing.assert_array_equal(got, want)
        assert port.filename == jax.filename
    assert '4/5 images' in capsys.readouterr().out
    assert len(list(port.reset())) == 5
    files = sorted(str(p) for p in tmp_path.glob('*.png'))[:2]
    assert len(list(ioutils.ImageLoader(files))) == 2
    with pytest.raises(IOError):
        ioutils.ImageLoader(tmp_path / '0.png')


def test_git_provenance_and_glob_single_file(tmp_path):
    assert ioutils.git_hash() == jax_ioutils.git_hash()
    assert ioutils.git_diff() == jax_ioutils.git_diff()
    (tmp_path / 'a.txt').write_text('a')
    (tmp_path / 'b.txt').write_text('b')
    assert ioutils.glob_single_file(tmp_path, 'a.*') == tmp_path / 'a.txt'
    for pattern in ('*.txt', '*.png'):
        with pytest.raises(ValueError, match='exactly one'):
            ioutils.glob_single_file(tmp_path, pattern)


def test_h5_visit_and_write_image_equal_jax(tmp_path):
    image = np.random.RandomState(2).randint(0, 256, (4, 4, 3)) \
        .astype(np.uint8)
    for package, name in ((h5utils, 'port'), (jax_h5utils, 'jax')):
        file = tmp_path / f'{name}.h5'
        package.write_image(file, 'faces/a', image)
        with pytest.raises(IOError):
            package.write_image(file, 'faces/a', image)
        package.write_image(file, 'faces/a', image[::-1].copy(),
                            check_name=False)
        package.write(file, 'emb', np.zeros((2, 3), np.float32))
    names = []
    h5utils.visit(tmp_path / 'port.h5', names.append)
    want = []
    jax_h5utils.visit(tmp_path / 'jax.h5', want.append)
    assert names == want == ['emb', 'faces', 'faces/a']
    assert h5utils.visititems(tmp_path / 'port.h5') == \
        jax_h5utils.visititems(tmp_path / 'jax.h5')
    np.testing.assert_array_equal(
        h5utils.read(tmp_path / 'port.h5', 'faces/a'), image[::-1])


def test_inputs_and_check_output_size():
    got = facenet.inputs(Config({'size': 96}))
    want = jax_facenet.inputs(JaxConfig({'size': 96}))
    assert got.shape == want.shape == (1, 96, 96, 3)
    assert got.dtype == want.dtype == np.uint8 and not got.any()
    for config in (None, {'output': {'size': 64}}):
        model = InceptionResnetV1(config)
        from facenet_tpu.models.inception_resnet_v1 import \
            InceptionResnetV1 as JaxIRv1
        assert facenet_tpu_torch.check_output_size(model) == \
            facenet_tpu.check_output_size(JaxIRv1(config=config))


def test_save_params_round_trips_and_equals_jax(tmp_path):
    tree = {'pnet': {'conv1': {'kernel': np.arange(6, dtype=np.float32)
                               .reshape(2, 3),
                               'bias': torch.ones(3)}},
            'scale': np.float32(2.0)}
    path = pretrained.save_params(tmp_path / 'port' / 'p.npz', tree)
    jax_path = jax_pretrained.save_params(
        tmp_path / 'jax.npz',
        {'pnet': {'conv1': {'kernel': tree['pnet']['conv1']['kernel'],
                            'bias': np.ones(3, np.float32)}},
         'scale': np.float32(2.0)})
    got, want = pretrained.load_params(path), jax_pretrained.load_params(
        jax_path)
    assert sorted(got) == sorted(want)
    for key in ('kernel', 'bias'):
        np.testing.assert_array_equal(got['pnet']['conv1'][key],
                                      want['pnet']['conv1'][key])
    assert got['scale'] == want['scale'] == 2.0
