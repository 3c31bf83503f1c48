"""Port FaceNet on a bundle written by facenet_tpu.export.save_model ==
facenet_tpu.FaceNet on the same bundle (cosine > 0.999), and the port's
own msgpack reader == flax's."""

import jax
import numpy as np
import pytest
import yaml
from flax import serialization

import facenet_tpu
import facenet_tpu_torch
from facenet_tpu import export as jax_export
from facenet_tpu.config import Config as JaxConfig
from facenet_tpu.models.inception_resnet_v1 import \
    InceptionResnetV1 as JaxIRv1
from facenet_tpu_torch import export
from facenet_tpu_torch.config import Config
from torch_testing import few_threads  # noqa: F401

TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}, 'output': {'size': 32}}


@pytest.fixture(scope='module')
def bundle(tmp_path_factory):
    path = tmp_path_factory.mktemp('model') / 'bundle'
    model = JaxIRv1(config=TINY)
    variables = model.init(jax.random.PRNGKey(0),
                           np.zeros((1, 160, 160, 3), np.uint8), train=False)
    jax_export.save_model(path, model, variables)
    return path


@pytest.fixture(scope='module')
def images():
    return np.random.RandomState(0).randint(0, 256, (3, 160, 160, 3),
                                            dtype=np.uint8)


@pytest.mark.parametrize('normalize', [True, False])
def test_facenet_matches_jax_facenet(bundle, images, normalize):
    ref = facenet_tpu.FaceNet(JaxConfig({'path': str(bundle),
                                         'normalize': normalize}))
    port = facenet_tpu_torch.FaceNet(Config({'path': str(bundle),
                                             'normalize': normalize}),
                                     device='cpu')
    assert port.normalize is normalize
    assert port.embedding_size == ref.embedding_size == 32
    want = ref.image_to_embedding(images)
    got = port.image_to_embedding(images)
    assert got.dtype == np.float32 and got.shape == want.shape
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert cos.min() > 0.999, cos
    single = port.image_to_embedding(images[0])
    np.testing.assert_allclose(single, got[:1], atol=1e-6)


def test_normalization_spelling_is_honored(bundle, images):
    port = facenet_tpu_torch.FaceNet(
        Config({'path': str(bundle), 'normalization': False}), device='cpu')
    assert port.normalize is False


def test_msgpack_reader_matches_flax(bundle):
    raw = (bundle / export.PARAMS_FILE).read_bytes()
    ours = export.msgpack_restore(raw)
    ref = serialization.msgpack_restore(raw)
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_msgpack_reader_scalars_and_chunks():
    tree = {'a': np.arange(6, dtype=np.int32).reshape(2, 3),
            'b': {'c': np.float32(1.5), 'd': [1, -2, 300, -40000, 2 ** 40],
                  'e': 'text', 'f': None, 'g': True, 'h': 0.25}}
    ours = export.msgpack_restore(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(ours['a'], tree['a'])
    assert ours['b']['c'] == np.float32(1.5)
    assert ours['b']['d'] == tree['b']['d']
    assert (ours['b']['e'], ours['b']['f'], ours['b']['g'],
            ours['b']['h']) == ('text', None, True, 0.25)

    chunked = {'__msgpack_chunked_array__': True,
               'shape': {'0': 2, '1': 2},
               'chunks': {'0': np.arange(3.0), '1': np.arange(3.0, 4.0)}}
    out = export.msgpack_restore(serialization.msgpack_serialize(
        {'w': chunked}))
    np.testing.assert_array_equal(out['w'], np.arange(4.0).reshape(2, 2))


def test_irv2_bundle_raises(tmp_path):
    """An IRv2 bundle passes the class check (the port serves the family:
    tests/test_torch_model_v2.py) and then needs its parameters; a bundle
    of any other class raises before that."""
    meta = {'model_class': 'InceptionResnetV2', 'config': None,
            'image_size': 160, 'normalization': 0, 'version': 1}
    (tmp_path / export.MODEL_FILE).write_text(yaml.safe_dump(meta))
    with pytest.raises(FileNotFoundError, match=export.PARAMS_FILE):
        export.load_model(tmp_path)
    meta['model_class'] = 'SqueezeNet'
    (tmp_path / export.MODEL_FILE).write_text(yaml.safe_dump(meta))
    with pytest.raises(NotImplementedError, match='SqueezeNet'):
        export.load_model(tmp_path)


def test_quantize_raises(bundle, images):
    """int8 serving needs calibration images, and int8 is the one mode."""
    with pytest.raises(ValueError, match='calib'):
        facenet_tpu_torch.FaceNet(Config({'path': str(bundle),
                                          'quantize': 'int8'}), device='cpu')
    with pytest.raises(ValueError, match='fp4'):
        facenet_tpu_torch.FaceNet(Config({'path': str(bundle),
                                          'quantize': 'fp4',
                                          'calib': images}), device='cpu')


def test_missing_path_raises():
    with pytest.raises(ValueError, match='config.path'):
        facenet_tpu_torch.FaceNet(Config({'normalize': True}), device='cpu')
