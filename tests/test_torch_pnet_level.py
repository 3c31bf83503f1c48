"""Port one-level P-Net entry points (B4, B6, B7) against the JAX package on
the same weights and seeded inputs. On the CPU the port's wrappers run their
plain version (`pnet.level_plain`, the kernels' arithmetic); the JAX kernels
run in interpret mode.

- B4 `pnet_forward_flat` against `pallas_pnet.pnet_forward_flat` on planes
  at a pitch rounded up to 128 with N(0, 3) noise past the true width;
- B6 `pnet_forward_level` against `pallas_pnet.pnet_forward_pallas` and
  against the flax `PNet` in float32 and bf16;
- B7 `pnet_trunk_nhwc` against the trunk of the JAX tool
  ``tools/try_pnet_v3.py`` (`ref_trunk`, restated here: the tool reads
  ``sys.argv`` when imported) at its relative bound of 5e-2;
- the cascade with ``pnet_impl='flat'`` against JAX's
  ``pnet_impl='flat-interpret'`` on the scene of tests/test_pallas_pnet.py.

Bounds are those of tests/test_pallas_pnet.py: probs 0.02, reg 0.05, boxes
1.5 px. Weights are randomly initialized (PRNGKey 3): on the trained bundle
flax's bf16 bias and PReLU differ from the kernels' float32 ones by up to
0.07 in probs, in JAX too. The CUDA kernels are held to the plain version
in tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facenet_tpu.detectors import pretrained as jpretrained
from facenet_tpu.detectors.mtcnn import cascade as jcascade
from facenet_tpu.detectors.mtcnn import networks as jnets
from facenet_tpu.detectors.mtcnn import pallas_pnet
from facenet_tpu.utils.synthetic import render_scene
from facenet_tpu_torch.detectors import pretrained
from facenet_tpu_torch.detectors.mtcnn import cascade, networks, pnet
from facenet_tpu_torch.tools import try_pnet_v3
from torch_testing import few_threads  # noqa: F401

FLAT_SHAPES = [(24, 100), (61, 83), (40, 129)]
LEVEL_SHAPES = [(24, 24), (61, 83), (40, 129)]


@pytest.fixture(scope='module')
def random_pnet():
    tree = jnets.PNet().init(jax.random.PRNGKey(3),
                             jnp.zeros((1, 24, 24, 3)))['params']
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return tree, networks.PNet().from_flax_params(tree)


def _normalized(rng, b, h, w):
    x = rng.randint(0, 256, (b, h, w, 3)).astype(np.float32)
    return np.asarray(jnets.normalize_crops(jnp.asarray(x)))


def _close(got, want, bound):
    assert tuple(got.shape) == tuple(want.shape)
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) < bound


@pytest.mark.parametrize('shape', FLAT_SHAPES)
def test_flat_matches_pallas_flat_interpret(random_pnet, shape):
    tree, net = random_pnet
    sh, true_sw = shape
    sw = -(-true_sw // 128) * 128
    rng = np.random.RandomState(1)
    xn = _normalized(rng, 2, sh, true_sw)
    pad = rng.normal(0, 3, (2, sh, sw, 3)).astype(np.float32)
    pad[:, :, :true_sw] = xn
    planes = np.ascontiguousarray(np.transpose(pad, (0, 3, 1, 2))).reshape(
        2, 3, sh * sw)

    p_ref, r_ref = pallas_pnet.pnet_forward_flat(
        pallas_pnet.pack_v3(tree), jnp.asarray(planes), sh, sw, true_sw,
        interpret=True)
    before = pnet.pnet_forward_flat.launches
    p, r = pnet.pnet_forward_flat(
        net, torch.from_numpy(planes).to(torch.bfloat16), sh, sw, true_sw)
    assert pnet.pnet_forward_flat.launches == before   # CPU: plain version
    assert p.dtype == r.dtype == torch.float32
    assert _close(p, p_ref, 0.02) and _close(r, r_ref, 0.05)
    # and the flax P-Net on the clean level
    p_flax, r_flax = jnets.PNet().apply({'params': tree}, xn)
    assert _close(p, p_flax, 0.02) and _close(r, r_flax, 0.05)


def test_flat_ignores_what_lies_past_the_true_width(random_pnet):
    _, net = random_pnet
    sh, sw, true_sw = 30, 64, 41
    rng = np.random.RandomState(2)
    level = torch.from_numpy(_normalized(rng, 2, sh, true_sw).copy()).permute(
        0, 3, 1, 2).to(torch.bfloat16).contiguous()
    outs = []
    for fill in (0.0, 1e4):
        pad = torch.full((2, 3, sh, sw), fill, dtype=torch.bfloat16)
        pad[..., :true_sw] = level
        outs.append(pnet.pnet_forward_flat(net, pad.reshape(2, 3, -1), sh,
                                           sw, true_sw))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    # pitch == true width: the planes of an NCHW level as they lie
    tight = pnet.pnet_forward_flat(net, level.reshape(2, 3, -1), sh, true_sw,
                                   true_sw)
    assert torch.equal(tight[0], outs[0][0])


@pytest.mark.parametrize('shape', LEVEL_SHAPES)
def test_level_matches_flax_and_pallas_interpret(random_pnet, shape):
    """B6: float32 weights (not rounded to bf16), input rounded to bf16."""
    tree, net = random_pnet
    xn = _normalized(np.random.RandomState(0), 2, *shape)
    nchw = np.ascontiguousarray(np.transpose(xn, (0, 3, 1, 2)))
    weights = pnet.pack_level_weights(net)
    before = pnet.pnet_forward_level.launches
    p, r = pnet.pnet_forward_level(weights, torch.from_numpy(nchw))
    assert pnet.pnet_forward_level.launches == before
    for dtype in (jnp.float32, jnp.bfloat16):
        p_ref, r_ref = jnets.PNet(dtype=dtype).apply({'params': tree}, xn)
        assert _close(p, p_ref, 0.02) and _close(r, r_ref, 0.05)
    if shape == LEVEL_SHAPES[0]:      # interpret mode costs ~8 s a shape
        p_ref, r_ref = pallas_pnet.pnet_forward_pallas(
            pallas_pnet.pack_weights(tree), nchw, interpret=True)
        assert _close(p, p_ref, 0.02) and _close(r, r_ref, 0.05)


def test_pack_level_weights_keeps_float32_values(random_pnet):
    tree, net = random_pnet
    ref = pallas_pnet.pack_weights(tree)
    packed = pnet.pack_level_weights(net)
    assert packed.shape == (pnet.N_WEIGHTS,) and packed.dtype == torch.float32
    off = pnet.OFFSETS
    # JAX rows are [(dy * 3 + dx) * ci_n + ci, co]; the port's [ci][ky][kx][co]
    for name, ci, co in (('w1', 3, 10), ('w2', 10, 16), ('w3', 16, 32)):
        want = ref[name].reshape(3, 3, ci, co).transpose(2, 0, 1, 3)
        got = packed[off[name]:off[name] + want.size].reshape(want.shape)
        np.testing.assert_array_equal(got.numpy(), want)
    heads = np.concatenate([ref['wc'], ref['wr']], axis=1)          # [32, 6]
    np.testing.assert_array_equal(
        packed[off['wh']:off['wh'] + 192].reshape(32, 6).numpy(), heads)
    np.testing.assert_array_equal(
        packed[off['bh']:off['bh'] + 6].numpy(),
        np.concatenate([ref['bc'], ref['br']], axis=1)[0])
    rounded = pnet.pack_weights(net)
    assert not torch.equal(rounded, packed)
    w = rounded[off['w3']:off['b3']]
    assert torch.equal(w, w.to(torch.bfloat16).float())


def _jax_ref_trunk(x, weights):
    """`ref_trunk` of the JAX tool tools/try_pnet_v3.py, restated."""
    (w1, b1, a1, w2, b2, a2, w3, b3, a3, wh, bh) = weights
    dn = ('NHWC', 'HWIO', 'NHWC')

    def prelu(z, a):
        return jnp.maximum(z, 0) + jnp.asarray(a, z.dtype) * jnp.minimum(z, 0)

    def conv(z, w, b):
        return jax.lax.conv_general_dilated(
            z, jnp.asarray(w, z.dtype), (1, 1), 'VALID',
            dimension_numbers=dn) + jnp.asarray(b, z.dtype)

    x = prelu(conv(x, w1, b1), a1)
    x = jax.lax.reduce_window(x, jnp.finfo(x.dtype).min, jax.lax.max,
                              (1, 2, 2, 1), (1, 2, 2, 1), 'SAME')
    x = prelu(conv(x, w2, b2), a2)
    x = prelu(conv(x, w3, b3), a3)
    return conv(x, wh, bh)


@pytest.mark.parametrize('shape', [(40, 128), (33, 57)])
def test_trunk_nhwc_matches_jax_reference_trunk(shape):
    rng = np.random.RandomState(0)
    weights = try_pnet_v3.make_weights(rng)
    x = rng.randint(0, 256, (2,) + shape + (3,)).astype(np.float32) / 128 - 1
    ref = np.asarray(_jax_ref_trunk(jnp.asarray(x, jnp.float32), weights))

    port_ref = try_pnet_v3.ref_trunk(torch.from_numpy(x), weights).numpy()
    np.testing.assert_allclose(port_ref, ref, atol=1e-4)

    before = try_pnet_v3.pnet_trunk_nhwc.launches
    got = try_pnet_v3.pnet_trunk_nhwc(torch.from_numpy(x),
                                      try_pnet_v3.pack_all(weights)).numpy()
    assert try_pnet_v3.pnet_trunk_nhwc.launches == before
    assert got.shape == ref.shape and got.dtype == np.float32
    assert got.shape[1:3] == pnet.out_geometry(*shape)
    assert np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-6) < 5e-2


def test_trunk_heads_softmax_to_the_flat_probabilities(random_pnet):
    """B7 is B4 before the softmax: same trunk, same arithmetic."""
    _, net = random_pnet
    xn = torch.from_numpy(_normalized(np.random.RandomState(4), 2, 31,
                                      45).copy())
    z = try_pnet_v3.pnet_trunk_nhwc(xn, pnet.pack_weights(net))
    nchw = xn.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
    p, r = pnet.pnet_forward_flat(net, nchw.reshape(2, 3, -1), 31, 45, 45)
    assert torch.allclose(torch.softmax(z[..., :2], -1)[..., 1], p, atol=2e-3)
    assert torch.allclose(z[..., 2:], r, atol=5e-3)


def test_cascade_flat_matches_jax_flat_interpret_on_scene():
    rng = np.random.RandomState(5)
    img, _, _ = render_scene(rng, shape=(192, 192), n_faces=4,
                             min_face=30, max_face=80)
    imgs = img[None]
    ref = jcascade.MTCNN(pnet_impl='flat-interpret', image_shape=(192, 192),
                         params=jpretrained.load_bundled('mtcnn'))
    out_a = ref.detect_batch(imgs)
    port = cascade.MTCNN(pnet_impl='flat', image_shape=(192, 192),
                         params=pretrained.load_bundled('mtcnn'),
                         device='cpu')
    assert port.pnet_impl == 'flat'
    before = pnet.pnet_forward_pyramid.launches, \
        pnet.pnet_forward_flat.launches
    out_b = port.detect_batch(imgs)
    assert (pnet.pnet_forward_pyramid.launches,
            pnet.pnet_forward_flat.launches) == before

    va, vb = np.asarray(out_a['valid']), out_b['valid']
    np.testing.assert_array_equal(va, vb)
    assert va.sum() >= 2
    for key, bound in (('boxes', 1.5), ('landmarks', 1.5), ('scores', 0.02)):
        assert np.abs(np.asarray(out_a[key], np.float32)[va]
                      - out_b[key][vb]).max() < bound, key


def test_flat_cascade_calls_the_kernel_wrapper_once_per_level(monkeypatch):
    calls = []
    real = pnet.pnet_forward_flat

    def spy(net, planes, sh, sw, true_sw):
        calls.append((tuple(planes.shape), sh, sw, true_sw))
        return real(net, planes, sh, sw, true_sw)

    monkeypatch.setattr(pnet, 'pnet_forward_flat', spy)
    det = cascade.MTCNN(pnet_impl='flat', image_shape=(96, 128), device='cpu')
    det.detect_batch(np.zeros((2, 96, 128, 3), np.uint8))
    assert len(calls) == len(det.scales) >= 3
    for (shape, sh, sw, true_sw), (v, hm) in zip(calls, det._resize_mats):
        assert (sh, sw, true_sw) == (v.shape[0], hm.shape[1], hm.shape[1])
        assert shape == (2, 3, sh * sw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            cascade.MTCNN(pnet_impl='flat', image_shape=(96, 128))
