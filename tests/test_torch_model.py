"""Port Inception-ResNet-v1 == the flax model on the same weights.

The unfused module and the fused fast path are held against
facenet_tpu's InceptionResnetV1.apply(train=False) / FastEmbedder on the
TINY config with non-trivial BN statistics: float32 at atol 2e-4 / rtol
1e-3 (the bound of tests/test_irv1_fast.py), bf16 at min cosine 0.999 and
unit norms to 1e-5. At the full default config the port's init tree and
fused parameter shapes equal the JAX ones (no full-width forward here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facenet_tpu.models import irv1_fast as jax_fast
from facenet_tpu.models.inception_resnet_v1 import \
    InceptionResnetV1 as JaxIRv1
from facenet_tpu_torch.models import irv1_fast
from facenet_tpu_torch.models.inception_resnet_v1 import (InceptionResnetV1,
                                                           init_variables)
from torch_testing import few_threads  # noqa: F401

TINY = {'block35': {'repeat': 2}, 'block17': {'repeat': 2},
        'block8_1': {'repeat': 2}, 'output': {'size': 64}}


def _flax_variables(dtype, image_size=160, seed=0):
    model = JaxIRv1(config=TINY, dtype=dtype, image_size=image_size)
    images = np.random.RandomState(seed).randint(
        0, 256, (4, 160, 160, 3), dtype=np.uint8)
    variables = model.init(jax.random.PRNGKey(seed), images[:1], train=False)
    rng = np.random.RandomState(seed + 1)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(rng.normal(0.5, 0.2, a.shape)).astype(np.float32),
        variables['batch_stats'])
    params = jax.tree_util.tree_map(np.asarray, variables['params'])
    return model, {'params': params, 'batch_stats': stats}, images


@pytest.fixture(scope='module')
def tiny_f32():
    return _flax_variables(jnp.float32)


def test_unfused_module_matches_flax_f32(tiny_f32):
    model, variables, images = tiny_f32
    ref = np.asarray(model.apply(variables, images, train=False))
    port = InceptionResnetV1(TINY).from_flax_variables(variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_unfused_module_raw_bottleneck_matches_flax(tiny_f32):
    model, variables, images = tiny_f32
    ref = np.asarray(model.apply(variables, images, train=False,
                                 normalize=False))
    port = InceptionResnetV1(TINY).from_flax_variables(variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(images), normalize=False).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_fast_forward_matches_jax_fast_f32(tiny_f32):
    _, variables, images = tiny_f32
    ref = np.asarray(jax_fast.FastEmbedder(variables, config=TINY,
                                           dtype=jnp.float32)(images))
    got = irv1_fast.FastEmbedder(variables, config=TINY, dtype=torch.float32,
                                 device='cpu')(images).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_fast_forward_matches_jax_bf16():
    _, variables, images = _flax_variables(jnp.bfloat16)
    ref = np.asarray(jax_fast.FastEmbedder(variables, config=TINY,
                                           dtype=jnp.bfloat16)(images))
    got = irv1_fast.FastEmbedder(variables, config=TINY,
                                 device='cpu')(images).numpy()
    cos = np.sum(ref * got, axis=1)
    assert cos.min() > 0.999, cos
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_odd_image_size_flattens_nhwc():
    """At 299 px the head pools to 2x2, so the flatten order reaches the
    bottleneck, and the odd size takes the plain (non space-to-depth) stem."""
    model, variables, _ = _flax_variables(jnp.float32, image_size=299)
    images = np.random.RandomState(3).randint(
        0, 256, (2, 299, 299, 3), dtype=np.uint8)
    ref = np.asarray(jax_fast.FastEmbedder(
        variables, config=TINY, image_size=299, dtype=jnp.float32)(images))
    got = irv1_fast.FastEmbedder(variables, config=TINY, image_size=299,
                                 dtype=torch.float32, device='cpu')(images)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)
    port = InceptionResnetV1(TINY, image_size=299).from_flax_variables(
        variables).eval()
    with torch.no_grad():
        unfused = port(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(
        unfused, np.asarray(model.apply(variables, images, train=False)),
        atol=2e-4, rtol=1e-3)


@pytest.fixture(scope='module')
def full_shapes():
    model = JaxIRv1()
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
    assert ours['params']['Bottleneck']['kernel'].shape == (1792, 512)


def test_fused_param_shapes_match_jax_at_full_config(full_shapes):
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   full_shapes)
    zeros['batch_stats'] = jax.tree_util.tree_map(np.ones_like,
                                                  zeros['batch_stats'])
    ref, _ = jax_fast.build_fast_params(zeros)
    ours, cfg = irv1_fast.build_fast_params(zeros, device='cpu')
    assert int(cfg.block17.repeat) == 10

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
    assert ours['Mixed_7a']['heads']['k'].shape[0] == 768
    assert ours['Conv2d_2a_3x3']['k'].dtype == torch.bfloat16
    assert ours['Conv2d_2a_3x3']['b'].dtype == torch.bfloat16
    assert ours['Conv2d_2a_3x3']['k'].is_contiguous(
        memory_format=torch.channels_last)
