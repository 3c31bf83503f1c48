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
from facenet_tpu_torch.models import irv1_fast
from facenet_tpu_torch.models.inception_resnet_v1 import init_variables
from facenet_tpu_torch.ops import pair_counts, stem, warp
from facenet_tpu_torch.ops.preprocessing import image_processing
from facenet_tpu_torch.tools import try_pallas_pnet, try_pnet_v3

TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}, 'output': {'size': 32}}
LEVEL_SHAPES = [(24, 100), (61, 83), (40, 129), (12, 12)]
# on the card also a level smaller than one tile and level 0 of the 480x640
# pyramid; (61, 83) and (40, 129) have odd conv1 extents (SAME-pool edges)
CARD_SHAPES = LEVEL_SHAPES + [(14, 18), (288, 384)]


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


def _flat_planes(rng, sh, true_sw, b=2, nan=False):
    """bf16 planes [b, 3, sh * sw] at a pitch rounded up to 128, with
    N(0, 3) garbage (or NaN) past true_sw, and the clean [b, 3, sh, true_sw]
    level."""
    sw = -(-true_sw // 128) * 128
    level = _levels(rng, [(sh, true_sw)], b)[0]
    pad = torch.from_numpy(rng.normal(0, 3, (b, 3, sh, sw))
                           .astype(np.float32)).to(torch.bfloat16)
    if nan:
        pad[:] = float('nan')
    pad[..., :true_sw] = level
    return pad.reshape(b, 3, sh * sw), sw, level


@pytest.mark.parametrize('shape', LEVEL_SHAPES)
def test_level_wrappers_take_the_plain_version_on_cpu(bundled_pnet, shape):
    """B4, B6 and B7 on CPU tensors: the plain version, no launch counted;
    B4 is blind to what lies past true_sw; B7's heads softmax to B4's
    probabilities."""
    sh, true_sw = shape
    rng = np.random.RandomState(4)
    planes, sw, level = _flat_planes(rng, sh, true_sw)
    counters = (pnet.pnet_forward_flat, pnet.pnet_forward_level,
                try_pnet_v3.pnet_trunk_nhwc)
    before = [fn.launches for fn in counters]
    p4, r4 = pnet.pnet_forward_flat(bundled_pnet, planes, sh, sw, true_sw)
    (p3, r3), = pnet.pnet_forward_pyramid_plain(bundled_pnet, [level])
    assert torch.equal(p4, p3) and torch.equal(r4, r3)
    assert p4.shape == (2, *pnet.out_geometry(sh, true_sw))

    unrounded = pnet.pack_level_weights(bundled_pnet)
    assert not torch.equal(unrounded, pnet.pack_weights(bundled_pnet))
    p6, r6 = pnet.pnet_forward_level(unrounded, level.float())
    pw, rw = pnet.level_plain(unrounded, level)
    assert torch.equal(p6, pw) and torch.equal(r6, rw)
    assert p6.shape == p4.shape and r6.shape == r4.shape

    z = try_pnet_v3.pnet_trunk_nhwc(level.permute(0, 2, 3, 1),
                                    pnet.packed_weights(bundled_pnet,
                                                        level.device))
    assert z.shape == (*p4.shape, 6)
    # NHWC input reaches the convolutions in another memory format, so the
    # sums differ in their last bits
    assert torch.allclose(torch.softmax(z[..., :2], -1)[..., 1], p4,
                          atol=2e-3)
    assert torch.allclose(z[..., 2:], r4, atol=5e-3)
    assert [fn.launches for fn in counters] == before


def test_level_wrappers_raise_on_what_the_kernels_do_not_take(bundled_pnet):
    planes, sw, level = _flat_planes(np.random.RandomState(5), 24, 100)
    with pytest.raises(ValueError, match='bfloat16'):
        pnet.pnet_forward_flat(bundled_pnet, planes.float(), 24, sw, 100)
    with pytest.raises(ValueError, match='pitch'):
        pnet.pnet_forward_flat(bundled_pnet, planes, 24, sw, sw + 1)
    with pytest.raises(ValueError, match='12x12'):
        pnet.pnet_forward_flat(bundled_pnet,
                               planes[:, :, :10 * sw].contiguous(), 10, sw,
                               100)
    with pytest.raises(ValueError, match='pack_level_weights'):
        pnet.pnet_forward_level(torch.zeros(7), level)
    with pytest.raises(ValueError, match='float'):
        pnet.pnet_forward_level(pnet.pack_level_weights(bundled_pnet),
                                torch.zeros(1, 3, 24, 24, dtype=torch.uint8))
    with pytest.raises(ValueError, match='pack_all'):
        try_pnet_v3.pnet_trunk_nhwc(level.permute(0, 2, 3, 1),
                                    torch.zeros(7))


def test_kernel_library_is_named_by_source_and_headers(tmp_path, monkeypatch):
    from facenet_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, 'CSRC', tmp_path)
    (tmp_path / 'k.cu').write_text('#include "h.cuh"\n')
    (tmp_path / 'h.cuh').write_text('// one\n')
    kernel = cuda_build.CudaKernel('k.cu', {}, headers=('h.cuh',))
    first = kernel.library_path().name
    assert first == kernel.library_path().name
    (tmp_path / 'h.cuh').write_text('// two\n')
    assert kernel.library_path().name != first
    assert pnet.KERNEL.headers and pnet.LEVEL_KERNEL.headers
    assert all(h.exists() for h in pnet.LEVEL_KERNEL.headers)
    flags = cuda_build.NVCC_FLAGS
    assert flags[flags.index('-I') + 1].endswith('csrc')


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


def _assert_counts_match(inputs):
    """Kernel vs plain cumulative counts to rtol 1e-6, beyond the weight of
    the pairs whose float64 similarity lies within 1e-6 of a cutoff (float32
    sums in another order may put exactly those on either side)."""
    before = pair_counts.pair_histogram.launches
    kern = pair_counts.pair_histogram(inputs)
    torch.cuda.synchronize()
    assert pair_counts.pair_histogram.launches == before + 1
    plain = pair_counts.pair_histogram_plain(inputs).cumsum(1)
    e64 = inputs.embeddings.double()
    sims = torch.clamp(e64 @ e64.T, -1.0, 1.0)
    upper = torch.triu(torch.ones_like(sims, dtype=torch.bool), 1)
    pos = inputs.labels[:, None] == inputs.labels[None, :]
    weight = torch.where(pos, inputs.w_pos[:, None].expand_as(sims),
                         inputs.inv_n[:, None] * inputs.inv_n[None, :])
    allowed = torch.zeros_like(plain)
    for k, cut in enumerate(inputs.cutoffs.double()):
        near = ((sims - cut).abs() <= 1e-6) & upper
        allowed[0, k] = (weight * (near & pos)).sum()
        allowed[1, k] = (weight * (near & ~pos)).sum()
    diff = (kern.cumsum(1) - plain).abs()
    assert not bool((diff > allowed + 1e-6 * plain.abs() + 1e-12).any())


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['1000x17', '936x512', '130 on the diagonal',
                                  'T=1'])
def test_pair_below_counts_kernel_shapes(case):
    """B1 where its tiling is ragged: D = 17 (rows not 16-byte aligned, one
    partial depth chunk), N = 936 (7.3 tiles of 128 rows), N = 130 (two
    diagonal tiles and one sliver, labels sorted so positives abound), and
    one threshold (every pair on one of two bins)."""
    _gpu()
    rng = np.random.RandomState(12)
    n, d = {'1000x17': (1000, 17), '936x512': (936, 512),
            '130 on the diagonal': (130, 64), 'T=1': (936, 512)}[case]
    per_class = 13 if n == 130 else 26
    labels = np.arange(n) // per_class
    centres = rng.standard_normal((labels.max() + 1, d))
    emb = centres[labels] + 0.8 * rng.standard_normal((n, d))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    thresholds = np.array([1.0]) if case == 'T=1' else np.linspace(0, 4, 100)
    for metric in (0, 1):
        if metric == 1 and case != 'T=1':
            thresholds = np.linspace(0, np.pi, 100)
        _assert_counts_match(pair_counts.prepare(
            torch.from_numpy(emb).cuda(), labels, thresholds, metric))


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1024, 512), (1000, 17), (130, 64)])
def test_pair_similarities_kernel_is_float32_accurate(shape):
    """B1's own product (3xTF32 on the tensor cores) against the float64
    product: max |s - s64| <= 5e-7, pairs at s ~ 0.5 and duplicated rows
    (s = 1, which the clip must hold at 1) included."""
    _gpu()
    n, d = shape
    rng = np.random.RandomState(9)
    centres = rng.standard_normal((8, d))
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    noise = rng.standard_normal((n, d)) / np.sqrt(d)
    e = centres[rng.randint(0, 8, n)] + noise
    e = (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32)
    e[1::7] = e[0::7][:e[1::7].shape[0]]                  # exact duplicates
    x = torch.from_numpy(e).cuda()
    before = pair_counts.pair_similarities.launches
    got = pair_counts.pair_similarities(x)
    torch.cuda.synchronize()
    assert pair_counts.pair_similarities.launches == before + 1
    s64 = torch.clamp(x.double() @ x.double().T, -1.0, 1.0)
    assert float((got.double() - s64).abs().max()) <= 5e-7
    assert float(got.max()) <= 1.0
    with pytest.raises(ValueError, match='float32'):
        pair_counts.pair_similarities(x.double())


@pytest.mark.cuda
@pytest.mark.parametrize('shape', CARD_SHAPES)
def test_pnet_level_kernels_match_plain(bundled_pnet, shape):
    """B4 (pitch rounded up to 128, NaN past true_sw), B3 on the level
    alone, B6 (float32 weights as three bf16 parts on the tensor-core tile)
    and B7 (NHWC in, raw heads out) against their plain versions: probs
    0.02, reg and raw heads 0.05."""
    _gpu()
    sh, true_sw = shape
    net = bundled_pnet.cuda()
    planes, sw, level = _flat_planes(np.random.RandomState(6), sh, true_sw,
                                     b=3, nan=True)
    planes, level = planes.cuda(), level.cuda()
    rounded = pnet.packed_weights(net, level.device)
    unrounded = pnet.pack_level_weights(net).cuda()
    nhwc = level.permute(0, 2, 3, 1).contiguous()
    counters = (pnet.pnet_forward_flat, pnet.pnet_forward_level,
                try_pnet_v3.pnet_trunk_nhwc)
    before = [fn.launches for fn in counters]
    p4, r4 = pnet.pnet_forward_flat(net, planes, sh, sw, true_sw)
    p6, r6 = pnet.pnet_forward_level(unrounded, level)
    z7 = try_pnet_v3.pnet_trunk_nhwc(nhwc, rounded)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [n + 1 for n in before]
    (p3, r3), = pnet.pnet_forward_pyramid(net, [level])
    torch.cuda.synchronize()
    pw, rw = pnet.level_plain(rounded, level)
    assert p4.shape == pw.shape and r4.shape == rw.shape
    assert float((p4 - pw).abs().max()) < 0.02     # NaN would fail here
    assert float((r4 - rw).abs().max()) < 0.05
    # B3 and B4 share the tile function: equal to the last bit
    assert torch.equal(p3, p4) and torch.equal(r3, r4)
    pw, rw = pnet.level_plain(unrounded, level)
    assert float((p6 - pw).abs().max()) < 0.02
    assert float((r6 - rw).abs().max()) < 0.05
    zw = pnet.level_plain(rounded, level, raw=True)
    assert z7.shape == zw.shape
    assert float((z7 - zw).abs().max()) < 0.05


@pytest.fixture(scope='module')
def random_pnet():
    """PyTorch's random init (seed 3): float32 weights far from bf16."""
    torch.manual_seed(3)
    return networks.PNet()


@pytest.mark.cuda
@pytest.mark.parametrize('shape', CARD_SHAPES)
def test_pnet_level_uses_all_three_weight_parts(random_pnet, shape):
    """B6 with random unrounded weights: within probs 0.02 and reg 0.05 of
    `level_plain` on the unrounded vector, and nearer to it (mean |d| of
    probs and of reg) than to `level_plain` on the rounded one, which the
    hi part alone would compute."""
    _gpu()
    sh, sw = shape
    level = _levels(np.random.RandomState(8), [(sh, sw)])[0].cuda()
    unrounded = pnet.pack_level_weights(random_pnet).cuda()
    rounded = pnet.pack_weights(random_pnet).cuda()
    got = pnet.pnet_forward_level(unrounded, level)
    torch.cuda.synchronize()
    dist = [[float((a - b).abs().max()), float((a - b).abs().mean())]
            for packed in (unrounded, rounded)
            for a, b in zip(got, pnet.level_plain(packed, level))]
    (p_max, p_mean), (r_max, r_mean) = dist[:2]
    assert p_max < 0.02 and r_max < 0.05
    assert p_mean < dist[2][1] and r_mean < dist[3][1]


@pytest.mark.cuda
def test_pnet_level_conv_sums_are_float32_accurate(random_pnet):
    """B6's conv3 sums (the accuracy probe) against float64 sums of the
    same bf16 activations and float32 weights: with each depth step summed
    from zero, as B6 runs, no worse than twice what float32 fused
    multiply-adds in a CUDA-core loop's order give."""
    _gpu()
    level = _levels(np.random.RandomState(9), [(61, 83)])[0].cuda()
    errors = try_pallas_pnet.conv_sum_errors(
        pnet.pack_level_weights(random_pnet).cuda(), level)
    assert errors['scale'] > 0
    assert errors['step sums'] <= 2 * errors['fma chain'] + 1e-7 * errors[
        'scale']


@pytest.mark.cuda
@pytest.mark.parametrize('batch', [1, 8, 133])
def test_stem_fused_kernel_matches_plain(batch):
    """B5 against its plain version on the first three convs of a
    random-weight IRv1, uint8 noise and the constant images 0 and 255: max
    |d| / max |ref| <= 0.01, compared through NCHW indexing. 133 images
    are 3,325 items, which no grid of one block an SM divides."""
    _gpu()
    params, _ = irv1_fast.build_fast_params(init_variables(TINY, seed=0), TINY,
                                            device='cuda')
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (batch, 160, 160, 3), dtype=np.uint8)
    if batch > 2:
        images[0], images[1] = 0, 255
    x = image_processing(torch.from_numpy(images).cuda(), 160, 0,
                         dtype=torch.bfloat16)
    before = stem.stem_forward.launches
    got = stem.stem_forward(params, x)
    torch.cuda.synchronize()
    assert stem.stem_forward.launches == before + 1
    want = stem.stem_forward_plain(params, x)
    assert tuple(got.shape) == (batch, 64, 37, 37)
    assert got.is_contiguous(memory_format=torch.channels_last)
    scale = float(want.float().abs().max())
    assert scale > 0
    assert float((got.float() - want.float()).abs().max()) <= 0.01 * scale
    with pytest.raises(ValueError, match='contiguous'):
        stem.stem_forward(params, x.permute(0, 2, 1, 3))
