"""Port Inception-ResNet-v2 == the flax model on the same weights.

The unfused module and the fused fast path are held against
facenet_tpu's InceptionResnetV2.apply(train=False) / FastEmbedderV2 on the
TINY config (``repeat [1, 1, 1]``, 64-d) with BatchNorm statistics drawn
from a numpy seed (mean N(0, 0.1), var U(0.5, 1.5), so no layer's ReLU
zeroes all of its input): float32 at atol 2e-4 / rtol 1e-3 (the bound of
tests/test_torch_model.py), bf16 at min cosine 0.999 and unit norms to 1e-5.
At the full default config the port's init tree and fused parameter shapes
equal the JAX ones (shapes only, through ``jax.eval_shape``). `FaceNet`
serves a bundle that ``facenet_tpu.export.save_model`` wrote.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facenet_tpu_torch
from facenet_tpu import export as jax_export
from facenet_tpu.models import irv2_fast as jax_fast
from facenet_tpu.models.inception_resnet_v2 import \
    InceptionResnetV2 as JaxIRv2
from facenet_tpu.models.inception_resnet_v2 import \
    check_input_config as jax_check_input_config
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.models import irv2_fast
from facenet_tpu_torch.models.inception_resnet_v2 import (InceptionResnetV2,
                                                           check_input_config,
                                                           init_variables)
from torch_testing import few_threads  # noqa: F401

TINY = {'repeat': [1, 1, 1], 'embedding_size': 64}


@pytest.fixture(scope='module')
def tiny():
    variables = init_variables(TINY, seed=0)
    rng = np.random.RandomState(1)

    def stats(path, a):
        if path[-1].key == 'mean':
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    variables['batch_stats'] = jax.tree_util.tree_map_with_path(
        stats, variables['batch_stats'])
    images = np.random.RandomState(0).randint(0, 256, (3, 160, 160, 3),
                                              dtype=np.uint8)
    return variables, images


def _flax_apply(variables, images, dtype, normalize=True):
    model = JaxIRv2(config=TINY, dtype=dtype)
    return np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, train=False, normalize=normalize))(variables, images))


def test_defaults_match_flax():
    ours = check_input_config(None)
    assert ours.as_dict == jax_check_input_config(None).as_dict
    assert list(ours.repeat) == [10, 20, 9]
    assert ours.mixed_5a.branch == [[96], [48, 64], [64, 96, 96], [64]]


@pytest.mark.parametrize('normalize', [True, False])
def test_unfused_module_matches_flax_f32(tiny, normalize):
    variables, images = tiny
    ref = _flax_apply(variables, images, jnp.float32, normalize)
    port = InceptionResnetV2(TINY).from_flax_variables(variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(images), normalize=normalize).numpy()
    assert got.shape == (3, 64)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_fast_forward_matches_jax_fast_f32(tiny):
    variables, images = tiny
    ref = np.asarray(jax_fast.FastEmbedderV2(variables, config=TINY,
                                             dtype=jnp.float32)(images))
    got = irv2_fast.FastEmbedderV2(variables, config=TINY,
                                   dtype=torch.float32,
                                   device='cpu')(images).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_fast_forward_matches_jax_bf16(tiny):
    variables, images = tiny
    ref = np.asarray(jax_fast.FastEmbedderV2(variables, config=TINY)(images))
    got = irv2_fast.FastEmbedderV2(variables, config=TINY,
                                   device='cpu')(images).numpy()
    cos = np.sum(ref * got, axis=1)
    assert cos.min() >= 0.999, cos
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.fixture(scope='module')
def full_shapes():
    model = JaxIRv2()
    images = np.zeros((1, 160, 160, 3), np.uint8)
    return jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), images, train=False))


def test_init_variables_match_flax_init_at_full_config(full_shapes):
    ours = init_variables(seed=0)
    ref = jax.tree_util.tree_map(lambda s: (s.shape, str(s.dtype)),
                                 full_shapes)
    got = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), ours)
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(got)
    assert jax.tree_util.tree_leaves(ref) == jax.tree_util.tree_leaves(got)
    assert ours['params']['Bottleneck']['kernel'].shape == (1536, 512)
    n = sum(a.size for a in jax.tree_util.tree_leaves(ours['params']))
    assert 50e6 < n < 60e6


def test_fused_param_shapes_match_jax_at_full_config(full_shapes):
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   full_shapes)
    zeros['batch_stats'] = jax.tree_util.tree_map(np.ones_like,
                                                  zeros['batch_stats'])
    ref, _ = jax_fast.build_fast_params(zeros)
    ours, cfg = irv2_fast.build_fast_params(zeros, device='cpu')
    assert list(cfg.repeat) == [10, 20, 9]

    def shapes(tree, torch_side):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = shapes(value, torch_side)
            elif torch_side and value.ndim == 4:     # OIHW -> HWIO
                out[key] = tuple(value.permute(2, 3, 1, 0).shape)
            elif torch_side and value.ndim == 2:     # [out, in] -> [in, out]
                out[key] = tuple(value.t().shape)
            else:
                out[key] = tuple(value.shape)
        return out

    assert shapes(ours, True) == shapes(ref, False)
    assert ours['Mixed_5a']['heads']['k'].shape[0] == 208
    assert ours['Repeat_2.block8_1']['heads']['k'].shape[0] == 384
    assert ours['Conv2d_7b_1x1']['k'].is_contiguous(
        memory_format=torch.channels_last)


def test_facenet_serves_irv2_bundle(tiny, tmp_path):
    variables, images = tiny
    model = JaxIRv2(config=TINY)
    jax_export.save_model(tmp_path / 'bundle', model, variables)
    net = facenet_tpu_torch.FaceNet(
        Config({'path': str(tmp_path / 'bundle'), 'normalize': True}),
        device='cpu')
    assert isinstance(net._forward, irv2_fast.FastEmbedderV2)
    assert net.embedding_size == 64
    got = net.image_to_embedding(images)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, images))
    assert (got * ref).sum(axis=1).min() >= 0.999
    with pytest.raises(ValueError, match='stem'):
        facenet_tpu_torch.FaceNet(Config({'path': str(tmp_path / 'bundle'),
                                          'stem': 'fused'}), device='cpu')
