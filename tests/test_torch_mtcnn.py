"""Port MTCNN (facenet_tpu_torch/detectors/mtcnn/) against the JAX package
with the same bundled weights and seeded inputs.

- networks: `from_flax_params` in float32 on both sides, to 1e-4;
- B3's plain version (`pnet.pnet_forward_pyramid_plain`, the kernel's
  arithmetic) against the flax P-Net in bf16 and the JAX flat-lane Pallas
  P-Net in interpret mode, at probs 0.02 / reg 0.05
  (tests/test_pallas_pnet.py's bounds);
- the pyramid resize matrices bit-equal in bf16 to `MTCNN._resize_mats`;
- the whole cascade on the CPU against JAX's flax cascade.

The CUDA kernel itself is held to its plain version in
tests/test_torch_cuda_kernels.py.
"""

import filecmp

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
from facenet_tpu_torch.detectors.mtcnn.weights import validate_params


@pytest.fixture(scope='module')
def params():
    return pretrained.load_bundled('mtcnn')


@pytest.fixture(scope='module')
def torch_pnet(params):
    return networks.PNet().from_flax_params(params['pnet'])


@pytest.fixture(scope='module')
def random_pnet():
    """Randomly initialized P-Net params (PRNGKey 3), as
    tests/test_pallas_pnet.py compares the kernels with the flax P-Net: with
    the trained bundle the two arithmetics (bf16 bias and PReLU in flax,
    float32 in the kernel) differ by up to 0.07 in probs, in JAX too."""
    tree = jnets.PNet().init(jax.random.PRNGKey(3),
                             jnp.zeros((1, 24, 24, 3)))['params']
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return tree, networks.PNet().from_flax_params(tree)


def _normalized(rng, b, h, w):
    x = rng.randint(0, 256, (b, h, w, 3)).astype(np.float32)
    return np.asarray(jnets.normalize_crops(jnp.asarray(x)))


def _bf16_nchw(xn):
    return torch.from_numpy(xn.transpose(0, 3, 1, 2).copy()).to(
        torch.bfloat16)


def test_weights_copy_is_byte_identical():
    assert filecmp.cmp(pretrained.bundled_path('mtcnn'),
                       jpretrained.bundled_path('mtcnn'), shallow=False)


@pytest.mark.parametrize('name,size', [('pnet', 31), ('rnet', 24),
                                       ('onet', 48)])
def test_networks_from_flax_params_float32(params, name, size):
    jnet = {'pnet': jnets.PNet, 'rnet': jnets.RNet,
            'onet': jnets.ONet}[name](dtype=jnp.float32)
    tnet = {'pnet': networks.PNet, 'rnet': networks.RNet,
            'onet': networks.ONet}[name](dtype=torch.float32)
    tnet.from_flax_params(params[name])
    xn = _normalized(np.random.RandomState(0), 3, size, size + 5 * (
        name == 'pnet'))
    want = jnet.apply({'params': params[name]}, xn)
    with torch.no_grad():
        got = tnet(torch.from_numpy(xn.copy()))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_pnet_plain_matches_flax_bf16_per_level(random_pnet):
    tree, torch_pnet = random_pnet
    rng = np.random.RandomState(1)
    jnet = jnets.PNet()
    for sh, sw in [(24, 100), (61, 83), (40, 129)]:
        xn = _normalized(rng, 2, sh, sw)
        p_ref, r_ref = jnet.apply({'params': tree}, xn)
        (p, r), = pnet.pnet_forward_pyramid_plain(torch_pnet, [_bf16_nchw(xn)])
        assert p.shape == p_ref.shape and r.shape == r_ref.shape
        assert float(np.abs(p.numpy() - np.asarray(p_ref)).max()) < 0.02
        assert float(np.abs(r.numpy() - np.asarray(r_ref)).max()) < 0.05


def test_pnet_plain_matches_pallas_flat_interpret(params, torch_pnet):
    """One level (24, 100) against the TPU kernel's own per-level body."""
    sh, true_sw = 24, 100
    sw = -(-true_sw // 128) * 128
    xn = _normalized(np.random.RandomState(2), 2, sh, true_sw)
    pad = np.zeros((2, sh, sw, 3), np.float32)
    pad[:, :, :true_sw] = xn
    planes = np.transpose(pad, (0, 3, 1, 2)).reshape(2, 3, sh * sw)
    p_ref, r_ref = pallas_pnet.pnet_forward_flat(
        pallas_pnet.pack_v3(params['pnet']), jnp.asarray(planes), sh, sw,
        true_sw, interpret=True)
    (p, r), = pnet.pnet_forward_pyramid(torch_pnet, [_bf16_nchw(xn)])
    assert p.shape == p_ref.shape
    assert float(np.abs(p.numpy() - np.asarray(p_ref)).max()) < 0.02
    assert float(np.abs(r.numpy() - np.asarray(r_ref)).max()) < 0.05


def test_pnet_plain_pyramid_of_odd_sizes(random_pnet):
    """A 3-level pyramid with odd sides, down to the 14x18 level whose head
    grid is 2x4, against the flax P-Net level by level."""
    tree, torch_pnet = random_pnet
    rng = np.random.RandomState(3)
    jnet = jnets.PNet()
    xs = [_normalized(rng, 2, sh, sw) for sh, sw in [(41, 57), (29, 39),
                                                     (14, 18)]]
    heads = pnet.pnet_forward_pyramid(torch_pnet, [_bf16_nchw(x) for x in xs])
    assert heads[-1][0].shape == (2, 2, 4)
    for xn, (p, r) in zip(xs, heads):
        p_ref, r_ref = jnet.apply({'params': tree}, xn)
        assert p.shape == p_ref.shape and r.shape == r_ref.shape
        assert float(np.abs(p.numpy() - np.asarray(p_ref)).max()) < 0.02
        assert float(np.abs(r.numpy() - np.asarray(r_ref)).max()) < 0.05


def test_pack_weights_layout(torch_pnet):
    packed = pnet.pack_weights(torch_pnet)
    assert packed.shape == (pnet.N_WEIGHTS,)
    # conv2's [ci][ky][kx][co] block: input channel 3, tap (1, 2), output 5
    w2 = torch_pnet.conv2.weight
    want = w2[5, 3, 1, 2].to(torch.bfloat16).float()
    assert packed[pnet.OFFSETS['w2'] + ((3 * 3 + 1) * 3 + 2) * 16 + 5] == want
    assert all(off % 4 == 0 for off in pnet.OFFSETS.values())


@pytest.mark.parametrize('shape', [(96, 96), (192, 192), (480, 640)])
def test_resize_matrices_bit_equal(params, shape):
    ref = jcascade.MTCNN(image_shape=shape, params=params)
    assert len(ref.scales) == len(cascade.pyramid_scales(*shape))
    for scale, (v, hm) in zip(ref.scales, ref._resize_mats):
        tv, thm = cascade.level_resize_matrices(shape, scale)
        for got, want in ((tv, v), (thm, hm)):
            got = torch.from_numpy(got).to(torch.bfloat16)
            want = torch.from_numpy(np.asarray(want, np.float32)).to(
                torch.bfloat16)
            assert torch.equal(got, want), (shape, scale)


def test_cascade_matches_jax_flax_on_scene(params):
    """The port's cascade with the pyramid P-Net (its plain version on the
    CPU) finds what JAX's flax cascade finds on the scene of
    tests/test_pallas_pnet.py."""
    rng = np.random.RandomState(5)
    img, _, _ = render_scene(rng, shape=(192, 192), n_faces=4,
                             min_face=30, max_face=80)
    imgs = img[None]
    ref = jcascade.MTCNN(pnet_impl='flax', image_shape=(192, 192),
                         params=jpretrained.load_bundled('mtcnn'))
    out_a = ref.detect_batch(imgs)
    port = cascade.MTCNN(image_shape=(192, 192), params=params, device='cpu')
    assert port.pnet_impl == 'pyramid'
    out_b = port.detect_batch(imgs)

    va, vb = np.asarray(out_a['valid']), out_b['valid']
    np.testing.assert_array_equal(va, vb)
    assert va.sum() >= 2
    assert np.abs(np.asarray(out_a['boxes'])[va] - out_b['boxes'][vb]).max() \
        < 1.5
    assert np.abs(np.asarray(out_a['scores'])[va]
                  - out_b['scores'][vb]).max() < 0.02
    assert np.abs(np.asarray(out_a['landmarks'])[va]
                  - out_b['landmarks'][vb]).max() < 1.5
    # valid slots first, best score first
    k = int(vb.sum())
    assert vb[0, :k].all()
    assert np.all(np.diff(out_b['scores'][0, :k]) <= 0)
    for stage, counts in out_b['overflow'].items():
        assert counts.shape == (1,), stage


def test_cascade_flax_impl_and_unported_impls(params):
    rng = np.random.RandomState(5)
    img, _, _ = render_scene(rng, shape=(192, 192), n_faces=4,
                             min_face=30, max_face=80)
    kw = dict(image_shape=(192, 192), params=params, device='cpu')
    a = cascade.MTCNN(**kw).detect_batch(img[None])
    b = cascade.MTCNN(pnet_impl='flax', **kw).detect_batch(img[None])
    np.testing.assert_array_equal(a['valid'], b['valid'])
    assert np.abs(a['boxes'][a['valid']] - b['boxes'][b['valid']]).max() < 1.5
    for impl in ('flat', 'pyramid-dots', 'pyramid-skip'):
        with pytest.raises(NotImplementedError, match='B4'):
            cascade.MTCNN(pnet_impl=impl, **kw)
    with pytest.raises(ValueError, match='letterbox'):
        cascade.MTCNN(**kw).detect_batch(np.zeros((1, 96, 96, 3), np.uint8))


def test_validate_params(params):
    det = cascade.MTCNN(image_shape=(96, 96), params=params, device='cpu')
    assert validate_params(params, det) is params
    bad = {k: dict(v) for k, v in params.items()}
    bad['rnet'] = dict(bad['rnet'])
    bad['rnet']['fc1'] = {'kernel': np.zeros((10, 128)),
                          'bias': np.zeros(128)}
    del bad['onet']['landmarks']
    with pytest.raises(ValueError, match='rnet/fc1/kernel') as err:
        validate_params(bad, det)
    assert 'missing: onet/landmarks/kernel' in str(err.value)


def test_letterbox_geometry_matches_jax():
    from facenet_tpu import native
    rng = np.random.RandomState(6)
    for _ in range(50):
        h, w = rng.randint(20, 2000, 2)
        assert cascade.letterbox_geometry(h, w, (480, 640)) == \
            native.letterbox_geometry(h, w, (480, 640))
    imgs = [rng.randint(0, 256, (50, 70, 3), np.uint8),
            rng.randint(0, 256, (90, 40), np.uint8)]
    batch, scales, pads = cascade.letterbox_batch(imgs, (64, 64))
    want = jcascade.letterbox_batch(imgs, (64, 64))
    np.testing.assert_array_equal(scales, want[1])
    np.testing.assert_array_equal(pads, want[2])
    assert batch.shape == (2, 64, 64, 3)



def test_capacity_overflow_is_counted_and_reported(params, monkeypatch):
    from facenet_tpu_torch.logging import logger
    rng = np.random.RandomState(5)
    img, _, _ = render_scene(rng, shape=(192, 192), n_faces=4,
                             min_face=30, max_face=80)
    warned = []
    monkeypatch.setattr(logger, 'warning',
                        lambda msg, *args: warned.append(msg % args))
    det = cascade.MTCNN(image_shape=(192, 192), params=params, device='cpu',
                        max_proposals=8, max_refined=4, max_outputs=2)
    out = det.detect_batch(img[None])
    assert out['valid'].shape == (1, 2)
    assert out['overflow']['pnet_level'][0] > 0
    assert len(warned) == 1 and 'pnet_level' in warned[0]
