"""The port's CUDA kernels against their plain versions.

This file imports neither JAX nor the JAX package, so it runs on the GPU
machine too:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

The `cuda`-marked tests build the kernels with nvcc and skip without a
GPU; the others check, on the CPU, that each wrapper routes CPU tensors to
its plain version without counting a launch.
"""

import numpy as np
import pytest
import torch

from facenet_tpu_torch.detectors import pretrained
from facenet_tpu_torch.detectors.mtcnn import networks, pnet
from facenet_tpu_torch.ops import pair_counts, warp


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')


def _warp_inputs(rng, n=6, h=48, w=40):
    imgs = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    th = rng.uniform(-1, 1, n)
    sc = rng.uniform(0.5, 1.5, n)
    mats = np.zeros((n, 2, 3), np.float32)
    mats[:, 0, 0] = mats[:, 1, 1] = sc * np.cos(th)
    mats[:, 0, 1] = -sc * np.sin(th)
    mats[:, 1, 0] = sc * np.sin(th)
    mats[:, :, 2] = rng.uniform(-20, 40, (n, 2))
    return torch.from_numpy(imgs), torch.from_numpy(mats)


def _levels(rng, shapes, b=3):
    out = []
    for sh, sw in shapes:
        x = rng.randint(0, 256, (b, 3, sh, sw)).astype(np.float32)
        out.append(networks.normalize_crops(torch.from_numpy(x))
                   .to(torch.bfloat16))
    return out


@pytest.fixture(scope='module')
def bundled_pnet():
    return networks.PNet().from_flax_params(
        pretrained.load_bundled('mtcnn')['pnet'])


def test_wrappers_take_the_plain_version_on_cpu(bundled_pnet):
    rng = np.random.RandomState(0)
    imgs, mats = _warp_inputs(rng)
    before = warp.dense_warp.launches, pnet.pnet_forward_pyramid.launches
    np.testing.assert_array_equal(
        warp.dense_warp(imgs, mats, (24, 32)).numpy(),
        warp.dense_warp_plain(imgs, mats, (24, 32)).numpy())
    levels = _levels(rng, [(41, 57), (14, 18)])
    for (p, r), (pw, rw) in zip(
            pnet.pnet_forward_pyramid(bundled_pnet, levels),
            pnet.pnet_forward_pyramid_plain(bundled_pnet, levels)):
        assert torch.equal(p, pw) and torch.equal(r, rw)
    assert (warp.dense_warp.launches,
            pnet.pnet_forward_pyramid.launches) == before


def test_build_all_waits_for_every_build_before_raising():
    from facenet_tpu_torch.ops import cuda_build

    class Fake:
        def __init__(self, fails):
            self.fails, self.started, self.loaded = fails, False, False

        def start(self):
            self.started = True

        def load(self):
            self.loaded = True
            if self.fails:
                raise RuntimeError('nvcc failed')
            return self

    kernels = [Fake(True), Fake(False)]
    with pytest.raises(RuntimeError, match='nvcc failed'):
        cuda_build.build_all(kernels)
    assert all(k.started and k.loaded for k in kernels)
    ok = [Fake(False), Fake(False)]
    assert cuda_build.build_all(ok) == ok


@pytest.mark.cuda
def test_dense_warp_kernel_matches_plain():
    _gpu()
    imgs, mats = _warp_inputs(np.random.RandomState(1))
    imgs, mats = imgs.cuda(), mats.cuda()
    before = warp.dense_warp.launches
    got = warp.dense_warp(imgs, mats, (24, 32))
    torch.cuda.synchronize()
    assert warp.dense_warp.launches == before + 1
    want = warp.dense_warp_plain(imgs, mats, (24, 32))
    assert float((got - want).abs().max()) < 1e-3
    for channels in (1, 4):       # the kernel takes any channel count
        more = imgs[..., :1].repeat(1, 1, 1, channels).contiguous()
        got = warp.dense_warp(more, mats, (24, 32))
        want = warp.dense_warp_plain(more, mats, (24, 32))
        assert got.shape == (6, 24, 32, channels)
        assert float((got - want).abs().max()) < 1e-3
    with pytest.raises(ValueError, match='float32'):
        warp.dense_warp(imgs.double(), mats, (24, 32))


@pytest.mark.cuda
def test_pnet_pyramid_kernel_matches_plain(bundled_pnet):
    _gpu()
    net = bundled_pnet.cuda()
    levels = [lv.cuda() for lv in _levels(np.random.RandomState(2),
                                          [(61, 83), (29, 39), (14, 18),
                                           (12, 12)])]
    before = pnet.pnet_forward_pyramid.launches
    got = pnet.pnet_forward_pyramid(net, levels)
    torch.cuda.synchronize()
    assert pnet.pnet_forward_pyramid.launches == before + 1
    for (p, r), (pw, rw) in zip(got, pnet.pnet_forward_pyramid_plain(
            net, levels)):
        assert p.shape == pw.shape and r.shape == rw.shape
        assert float((p - pw).abs().max()) < 0.02
        assert float((r - rw).abs().max()) < 0.05
    with pytest.raises(ValueError, match='bfloat16'):
        pnet.pnet_forward_pyramid(net, [levels[0].float()])


@pytest.mark.cuda
def test_pair_below_counts_kernel_matches_plain():
    _gpu()
    rng = np.random.RandomState(3)
    centres = rng.standard_normal((12, 64))
    labels = np.repeat(np.arange(12), 10)
    emb = centres[labels] + 0.5 * rng.standard_normal((120, 64))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    inputs = pair_counts.prepare(torch.from_numpy(emb.astype(np.float32))
                                 .cuda(), labels, np.linspace(0, 4, 50), 0)
    kern = pair_counts.pair_histogram(inputs)
    plain = pair_counts.pair_histogram_plain(inputs)
    np.testing.assert_allclose(kern.cumsum(1).cpu().numpy(),
                               plain.cumsum(1).cpu().numpy(),
                               rtol=1e-6, atol=1e-12)
