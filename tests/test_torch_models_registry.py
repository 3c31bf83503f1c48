"""The port's model zoo (`facenet_tpu_torch.models`) == the JAX package's
(tests/test_models_registry.py's 8 cases, each against the port), and the
zoo's two YAML files build the flax variable trees JAX's build: the same
keys and shapes from `init_variables` / `flax_variables` as from flax's
``init`` (through ``jax.eval_shape``)."""

import jax
import numpy as np
import pytest
import torch

from facenet_tpu import models as jax_models
from facenet_tpu_torch import export, models
from facenet_tpu_torch.config import Config
from torch_testing import few_threads  # noqa: F401

TINY_V1 = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
           'block8_1': {'repeat': 1}, 'output': {'size': 32}}
TINY_V2 = {'repeat': [1, 1, 1], 'embedding_size': 32}
NAMES = ('inception_resnet_v1', 'inception_resnet_v2')


def test_zoo_names_resolve():
    m1 = models.create_model_from_config('inception_resnet_v1')
    m2 = models.create_model_from_config('inception_resnet_v2')
    assert type(m1).__name__ == 'InceptionResnetV1'
    assert type(m2).__name__ == 'InceptionResnetV2'


@pytest.mark.parametrize('prefix', ['facenet.models.', 'facenet_tpu.models.',
                                    '', 'facenet_tpu_torch.models.'])
def test_reference_module_names_map(prefix):
    for name in NAMES:
        mod = models.resolve_module(prefix + name)
        assert mod.__name__ == f'facenet_tpu_torch.models.{name}'


def test_yaml_configs_load():
    for name in NAMES:
        cfg = models.load_model_config(name)
        assert cfg.module == f'facenet_tpu_torch.models.{name}'
        assert cfg.config.as_dict == \
            jax_models.load_model_config(name).config.as_dict
        # JAX's own YAML loads into the port's zoo
        jax_file = jax_models.config_dir / f'{name}.yaml'
        assert type(models.create_model_from_config(str(jax_file))) is \
            type(models.create_model_from_config(name))


def test_unknown_config_raises():
    with pytest.raises(ValueError, match='unknown model config'):
        models.load_model_config('resnet9000')


def test_module_key_selects_v2():
    model = models.create_model_from_config(
        Config({'module': 'inception_resnet_v2', 'config': TINY_V2}))
    assert type(model).__name__ == 'InceptionResnetV2'
    from facenet_tpu_torch.models.inception_resnet_v2 import init_variables
    model.from_flax_variables(init_variables(TINY_V2))
    images = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 160, 160, 3), dtype=np.uint8))
    with torch.no_grad():
        out = model(images).numpy()
    assert out.shape == (2, 32)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


def test_bare_topology_defaults_to_v1():
    model = models.create_model_from_config(Config(TINY_V1))
    assert type(model).__name__ == 'InceptionResnetV1'
    assert model.embedding_size == 32
    assert type(models.create_model_from_config(None)).__name__ == \
        'InceptionResnetV1'


def test_model_block_ignores_run_keys():
    model = models.create_model_from_config(
        Config({'path': '/tmp/x', 'checkpoint': None, 'config': TINY_V1}))
    assert type(model).__name__ == 'InceptionResnetV1'
    model = models.create_model_from_config(
        Config({'path': '/tmp/x', 'weights': None, **TINY_V1}))
    assert model.embedding_size == 32


def test_export_roundtrip_preserves_model_class(tmp_path):
    """An IRv2 bundle the port writes loads as IRv2 in both packages."""
    from facenet_tpu import export as jax_export
    from facenet_tpu_torch.models.inception_resnet_v2 import init_variables

    model = models.create_model_from_config(
        Config({'module': 'inception_resnet_v2', 'config': TINY_V2}))
    model.from_flax_variables(init_variables(TINY_V2))
    path = export.save_model(tmp_path / 'bundle', model)
    assert export.load_model(path).model_class == 'InceptionResnetV2'
    bundle = jax_export.load_model(path)
    assert type(bundle.model).__name__ == 'InceptionResnetV2'
    want = model.to_flax_variables()
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray,
                                                  dict(bundle.variables)),
                           want)


def _shapes(tree):
    if isinstance(tree, dict) or hasattr(tree, 'items'):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize('name', NAMES)
def test_zoo_trees_equal_jax(name):
    """Keys and shapes of the whole flax tree from each zoo YAML."""
    port = models.create_model_from_config(name)
    params, stats = port.flax_variables(np.random.RandomState(0))
    flax = jax_models.create_model_from_config(name)
    want = jax.eval_shape(lambda: flax.init(
        jax.random.PRNGKey(0), np.zeros((1, 160, 160, 3), np.uint8),
        train=False))
    assert _shapes(params) == _shapes(dict(want['params']))
    assert _shapes(stats) == _shapes(dict(want['batch_stats']))
    cfg = models.load_model_config(name).config
    if name == 'inception_resnet_v2':
        assert port.keep == cfg.keep_probability == 0.5
