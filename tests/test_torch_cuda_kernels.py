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
from facenet_tpu_torch.ops import crop, nms, pair_counts, stem, warp
from facenet_tpu_torch.ops.preprocessing import image_processing
from facenet_tpu_torch.tools import try_pallas_pnet, try_pnet_v3
from facenet_tpu_torch.utils import synthetic

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


def _crop_boxes(rng, b, k, shape, lo=12, hi=200):
    """[b, k, 4] float32 square-ish (x1, y1, x2, y2) boxes of lo-hi px,
    their centres anywhere in an image of `shape`, so some cross an edge."""
    size = rng.uniform(lo, hi, (b, k, 1)) * rng.uniform(0.8, 1.25, (b, k, 2))
    centre = rng.uniform(0, 1, (b, k, 2)) * np.array(shape[::-1])
    return np.concatenate([centre - size / 2, centre + size / 2],
                          -1).astype(np.float32)


@pytest.mark.parametrize('dtype', ['float32', 'uint8 strided'])
def test_crop_wrapper_takes_the_plain_version_on_cpu(dtype):
    rng = np.random.RandomState(8)
    imgs = torch.from_numpy(rng.uniform(0, 255, (2, 40, 56, 3))
                            .astype(np.float32))
    if dtype != 'float32':
        imgs = imgs.to(torch.uint8).permute(0, 2, 1, 3)   # a strided view
    boxes = torch.from_numpy(_crop_boxes(rng, 2, 5, imgs.shape[1:3], 4, 30))
    before = crop.crop_and_resize.launches
    got = crop.crop_and_resize(imgs, boxes, 24)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 24, 24, 3)
    assert torch.equal(got, crop.crop_and_resize_plain(imgs, boxes, 24))
    assert crop.crop_and_resize.launches == before


@pytest.mark.parametrize('b, k', [(2, 0), (0, 3)])
def test_crop_wrapper_gives_empty_crops_for_no_boxes(b, k):
    before = crop.crop_and_resize.launches
    out = crop.crop_and_resize(torch.zeros(b, 10, 12, 3), torch.zeros(b, k, 4),
                               5)
    assert out.shape == (b, k, 5, 5, 3) and out.dtype == torch.float32
    assert crop.crop_and_resize.launches == before


def test_crop_wrapper_raises_on_what_the_kernel_does_not_take():
    imgs, boxes = torch.zeros(1, 10, 12, 3), torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match='unsupported device'):
        crop.crop_and_resize(imgs.to('meta'), boxes.to('meta'), 5)
    with pytest.raises(ValueError, match='no backward'):
        crop.crop_and_resize(imgs.requires_grad_(), boxes, 5)
    with torch.no_grad():                     # no gradient asked for
        assert crop.crop_and_resize(imgs, boxes, 5).shape == (1, 2, 5, 5, 3)


def _nms_case(case, b, k, seed=4):
    """([B, K, 4] boxes, [B, K] scores, [B, K] valid) on the CPU: boxes of
    16-300 px over a 1080 x 1920 frame ('random'), or the same with scores
    on 5 levels, whole rows repeated and degenerate boxes ('tied')."""
    rng = np.random.RandomState(seed)
    centre = rng.uniform(0, 1, (b, k, 2)) * np.array([1920, 1080])
    side = rng.uniform(16, 300, (b, k, 1)) * rng.uniform(0.7, 1.4, (b, k, 2))
    boxes = np.concatenate([centre - side / 2, centre + side / 2], -1)
    scores = rng.uniform(0, 1, (b, k))
    valid = rng.uniform(0, 1, (b, k)) < 0.9
    if case == 'tied':
        scores = np.round(scores * 4) / 4
        boxes[:, 1::7] = boxes[:, 0::7][:, :boxes[:, 1::7].shape[1]]
        scores[:, 1::7] = scores[:, 0::7][:, :scores[:, 1::7].shape[1]]
        boxes[:, 3::11, 2:] = boxes[:, 3::11, :2]          # zero area
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(scores.astype(np.float32)),
            torch.from_numpy(valid))


def _nms_sorted(boxes, scores, valid):
    """The candidates in descending score order (a stable sort, as
    `nms.nms_mask` makes them), and the order."""
    order = torch.argsort(-torch.where(valid, scores, float('-inf')), dim=-1,
                          stable=True)
    return (torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
            torch.gather(valid, 1, order), order)


def _unsorted(keep, order):
    return torch.zeros_like(keep).scatter(-1, order, keep)


def test_nms_wrapper_takes_the_loop_on_cpu():
    boxes, scores, valid = _nms_case('tied', 2, 40)
    sb, sv, order = _nms_sorted(boxes, scores, valid)
    before = nms.greedy_keep.launches
    for mode, offset in (('union', 0.0), ('min', 1.0)):
        got, kept = nms.greedy_keep(sb, sv, 0.4, mode, offset)
        want, count = nms.greedy_keep_plain(sb, sv, 0.4, mode, offset)
        assert torch.equal(got, want) and torch.equal(kept, count)
        assert got.any()
    assert torch.equal(nms.nms_mask(boxes, scores, valid, 0.4, 'min'),
                       _unsorted(nms.greedy_keep_plain(sb, sv, 0.4,
                                                       'min')[0], order))
    assert nms.greedy_keep.launches == before
    with pytest.raises(ValueError, match='mode'):
        nms.greedy_keep(boxes, valid, 0.4, mode='max')


@pytest.mark.parametrize('max_keep', [None, 0, 7])
def test_nms_capacity_marks_the_first_kept(max_keep):
    boxes, scores, valid = _nms_case('random', 3, 64)
    boxes, valid, _ = _nms_sorted(boxes, scores, valid)
    every, count = nms.greedy_keep_plain(boxes, valid, 0.4, offset=1.0)
    keep, kept = nms.greedy_keep(boxes, valid, 0.4, offset=1.0,
                                 max_keep=max_keep)
    assert torch.equal(kept, count) and torch.equal(kept, every.sum(-1,
                                                    dtype=torch.int32))
    rank = torch.cumsum(every, -1)
    cap = 64 if max_keep is None else max_keep
    assert torch.equal(keep, every & (rank <= cap))


@pytest.mark.cuda
@pytest.mark.parametrize('k', [32, 5000])
@pytest.mark.parametrize('case', ['random', 'tied'])
@pytest.mark.parametrize('mode, offset', [('union', 0.0), ('union', 1.0),
                                          ('min', 0.0), ('min', 1.0)])
def test_nms_kernel_keeps_what_the_loop_keeps(k, case, mode, offset):
    """The NMS kernel's keep mask and kept count are the loop's, bit for
    bit, on the card and on the CPU, with and without a capacity; and
    `nms_mask` runs the kernel on the card."""
    _gpu()
    b = 8 if k == 5000 else 16
    boxes, scores, valid = _nms_case(case, b, k)
    sb, sv, order = _nms_sorted(boxes.cuda(), scores.cuda(), valid.cuda())
    want, count = nms.greedy_keep_plain(sb, sv, 0.4, mode, offset)
    before = nms.greedy_keep.launches
    keep, kept = nms.greedy_keep(sb, sv, 0.4, mode, offset)
    torch.cuda.synchronize()
    assert nms.greedy_keep.launches == before + 1
    assert torch.equal(keep, want) and torch.equal(kept, count)
    assert int(kept.min()) > 0
    if k == 32:
        cpu, cpu_count = nms.greedy_keep_plain(sb.cpu(), sv.cpu(), 0.4, mode,
                                               offset)
        assert torch.equal(keep.cpu(), cpu)
        assert torch.equal(kept.cpu(), cpu_count)
    if offset == 0.0:
        got = nms.nms_mask(boxes.cuda(), scores.cuda(), valid.cuda(), 0.4,
                           mode)
        assert nms.greedy_keep.launches == before + 2
        assert torch.equal(got, _unsorted(want, order))
    keep, kept = nms.greedy_keep(sb, sv, 0.4, mode, offset, max_keep=750)
    want, count = nms.greedy_keep_plain(sb, sv, 0.4, mode, offset,
                                        max_keep=750)
    assert torch.equal(keep, want) and torch.equal(kept, count)


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


def _warp_case(case):
    """(images, matrices, out size) on the card for one B2 case."""
    if case in ('rotated 45', 'rotated 30'):
        degrees = float(case.split()[1])
        return (*synthetic.alignment_inputs(4, 7, 'cuda', degrees),
                (160, 160))
    rng = np.random.RandomState(7)
    # chip_smoke's phase 8: similarity warps 240 -> 160 that push samples
    # off every edge
    n = 133 if case == '133 crops' else 32
    imgs = rng.uniform(0, 255, (n, 240, 240, 3)).astype(np.float32)
    th, sc = rng.uniform(-0.7, 0.7, n), rng.uniform(0.7, 2.0, n)
    mats = np.zeros((n, 2, 3), np.float32)
    mats[:, 0, 0] = mats[:, 1, 1] = sc * np.cos(th)
    mats[:, 0, 1] = -sc * np.sin(th)
    mats[:, 1, 0] = sc * np.sin(th)
    mats[:, :, 2] = rng.uniform(-80, 160, (n, 2))
    imgs, mats = torch.from_numpy(imgs).cuda(), torch.from_numpy(mats).cuda()
    if case == 'identity':
        return imgs[:4], torch.eye(2, 3).repeat(4, 1, 1).cuda(), (240, 240)
    if case == 'non-square':
        return imgs[:8], mats[:8].contiguous(), (96, 200)
    if case == 'one channel':
        return (imgs[:8, ..., :1].contiguous(), mats[:8].contiguous(),
                (160, 160))
    return imgs, mats, (160, 160)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['identity', 'off the edge', 'non-square',
                                  'one channel', '133 crops', 'rotated 45',
                                  'rotated 30'])
def test_dense_warp_kernel_shapes(case):
    """B2 against its plain version at 1e-3 (0-255 scale) on chip_smoke's
    phase 8 shapes, a crop count that does not fill the grid's last round,
    and the landmark alignment's largest footprints (45 and 30 degrees)."""
    _gpu()
    src, mats, size = _warp_case(case)
    got = warp.dense_warp(src, mats, size)
    torch.cuda.synchronize()
    want = warp.dense_warp_plain(src, mats, size)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-3


def _crop_case(case):
    """(images, boxes [B, K, 4], out size) on the card for one case of the
    crop kernel: the main path's geometries on 480x640 scenes of 0-255
    noise (the harshest for a coordinate rounded otherwise), a 64-channel
    feature map through a permuted view, boxes off the image, and
    non-finite boxes."""
    rng = np.random.RandomState(9)
    scenes = torch.from_numpy(rng.uniform(0, 255, (2, 480, 640, 3))
                              .astype(np.float32)).cuda()
    geometry = {'rnet 24': (64, 24, 12, 200), 'onet 48': (32, 48, 12, 200),
                'align 240': (4, 240, 40, 180), 'box 160': (1, 160, 48, 200)}
    if case in geometry:
        k, size, lo, hi = geometry[case]
        boxes = _crop_boxes(rng, 2, k, (480, 640), lo, hi)
        if case == 'box 160':                 # the scenes as uint8 too
            scenes = scenes.to(torch.uint8)
        return scenes, torch.from_numpy(boxes).cuda(), size
    if case == 'feature map':
        fmap = torch.from_numpy(rng.normal(0, 1, (2, 64, 30, 40))
                                .astype(np.float32)).cuda()
        boxes = _crop_boxes(rng, 2, 16, (30, 40), 1, 12)
        return fmap.permute(0, 2, 3, 1), torch.from_numpy(boxes).cuda(), 7
    boxes = _crop_boxes(rng, 2, 8, (480, 640), 20, 100)
    boxes[0, :4] += np.array([700, 0, 700, 0], np.float32)     # right of it
    boxes[1, :4] -= np.array([0, 600, 0, 600], np.float32)     # above it
    boxes[0, 4:] = [[-30, -40, 50, 60], [600, 440, 700, 520],
                    [-100, 100, 800, 300], [300, -50, 340, 600]]
    return scenes, torch.from_numpy(boxes).cuda(), 48


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['rnet 24', 'onet 48', 'align 240',
                                  'box 160', 'feature map', 'off the image'])
def test_crop_kernel_matches_plain(case):
    """The crop kernel against its plain version at 1e-3 (0-255 scale)."""
    _gpu()
    images, boxes, size = _crop_case(case)
    before = crop.crop_and_resize.launches
    got = crop.crop_and_resize(images, boxes, size)
    torch.cuda.synchronize()
    assert crop.crop_and_resize.launches == before + 1
    want = crop.crop_and_resize_plain(images, boxes, size)
    assert got.shape == want.shape == (*boxes.shape[:2], size, size,
                                       images.shape[-1])
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_crop_kernel_reads_inside_the_image_for_non_finite_boxes():
    """NaN and inf boxes (an empty slot's landmarks) read inside the
    image; the finite boxes' crops are those of the batch without them."""
    _gpu()
    images, boxes, size = _crop_case('align 240')
    bad = boxes.clone()
    bad[0, 1] = float('nan')
    bad[1, 0, 2:] = float('inf')
    bad[1, 2, :2] = -float('inf')
    got = crop.crop_and_resize(images, bad, size)
    torch.cuda.synchronize()
    finite = bad.isfinite().all(-1)
    assert int(finite.sum()) == 5
    clean = crop.crop_and_resize(images, boxes, size)
    assert torch.equal(got[finite], clean[finite])
    want = crop.crop_and_resize_plain(images, boxes, size)
    assert float((got[finite] - want[finite]).abs().max()) <= 1e-3


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


# int8 conv geometries of full-width IRv1 and IRv2 at their serving sizes
# (chip_smoke.py phase 22 takes every one from the forwards themselves):
# (c, h, w, oc, kh, kw, stride, padding)
INT8_SHAPES = {
    '1x1 block35 heads': (256, 17, 17, 96, 1, 1, 1, 'SAME'),
    '3x3 SAME': (32, 17, 17, 48, 3, 3, 1, 'SAME'),
    '3x3 VALID stem': (80, 38, 38, 192, 3, 3, 1, 'VALID'),
    '3x3 stride 2': (320, 17, 17, 384, 3, 3, 2, 'VALID'),
    '1x7': (128, 8, 8, 160, 1, 7, 1, 'SAME'),
    '7x1': (160, 8, 8, 192, 7, 1, 1, 'SAME'),
    '1x3': (192, 3, 3, 224, 1, 3, 1, 'SAME'),
    '3x1': (224, 3, 3, 256, 3, 1, 1, 'SAME'),
    '5x5': (48, 17, 17, 64, 5, 5, 1, 'SAME'),
    '2x2 space-to-depth': (12, 80, 80, 32, 2, 2, 1, 'VALID'),
    'K=27, padded to 32': (3, 160, 160, 32, 3, 3, 2, 'VALID'),
    'K=45 N=12, padded': (5, 9, 9, 12, 3, 3, 1, 'SAME'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('name', INT8_SHAPES)
def test_int8_gemm_matches_plain(name):
    """The int8 conv's GEMM path (im2col + torch._int_mm) against its plain
    version (F.conv2d in float64) at batch 8 and at batch 1 (9 rows on the
    3x3 grid, padded to what cuBLASLt takes): the int32 sums are equal."""
    from facenet_tpu_torch.ops import int8_conv
    _gpu()
    c, h, w, oc, kh, kw, stride, padding = INT8_SHAPES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    k = rng.randint(-127, 128, (oc, c, kh, kw)).astype(np.int8)
    entry = int8_conv.quantized_entry(k, np.ones(oc), 1.0, np.zeros(oc),
                                      'cuda')
    for batch in (8, 1):
        xq = torch.from_numpy(rng.randint(-127, 128, (batch, h, w, c))
                              .astype(np.int8)).cuda()
        got = int8_conv.int8_sums(xq, entry, stride, padding)
        torch.cuda.synchronize()
        want = int8_conv.int8_sums_plain(xq, entry, stride, padding)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert torch.equal(got, want), name


@pytest.mark.cuda
def test_int8_conv_on_the_card_matches_the_cpu():
    """The whole int8 conv (quantize, GEMM, rescale) on the card equals the
    CPU's (plain sums) on a bf16 input: the same integer sums, and the same
    float32 rescale rounded to bf16."""
    from facenet_tpu_torch.ops import int8_conv
    _gpu()
    rng = np.random.RandomState(3)
    k = rng.randint(-127, 128, (64, 48, 5, 5)).astype(np.int8)
    x = torch.from_numpy(rng.standard_normal((8, 48, 17, 17)).astype(
        np.float32)).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
    entry = dict(ws=rng.uniform(1e-3, 2e-3, 64), xs=0.02,
                 b=rng.standard_normal(64))
    cpu = int8_conv.int8_conv(x, int8_conv.quantized_entry(k, **entry,
                                                           device='cpu'))
    card = int8_conv.int8_conv(x.cuda(), int8_conv.quantized_entry(
        k, **entry, device='cuda'))
    assert card.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(card.cpu(), cpu)


def test_int8_conv_takes_the_plain_sums_on_cpu(monkeypatch):
    """A CPU tensor goes to the plain version (the GEMM path is not
    called); its output is a channels_last NCHW view in the input's dtype."""
    from facenet_tpu_torch.ops import int8_conv

    def refuse(*args, **kwargs):
        raise AssertionError('the GEMM path ran on a CPU tensor')

    monkeypatch.setattr(int8_conv, 'int8_sums', refuse)
    rng = np.random.RandomState(4)
    k = rng.randint(-127, 128, (16, 8, 3, 3)).astype(np.int8)
    entry = int8_conv.quantized_entry(k, np.full(16, 1e-3), 0.05,
                                      np.zeros(16), 'cpu')
    x = torch.from_numpy(rng.standard_normal((2, 8, 9, 9)).astype(
        np.float32)).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
    y = int8_conv.int8_conv(x, entry, 1, 'SAME')
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (2, 16, 9, 9)
    assert y.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match='stride 1'):
        int8_conv.int8_conv(x, entry, 2, 'SAME')


TRAIN_LOSSES = {
    'softmax + center': {'center_factor': 0.5, 'center_alfa': 0.9},
    'triplet': {'softmax_factor': 0.0, 'triplet_factor': 1.0},
}


def _train_batch(batch, classes, seed=0):
    """uint8 images of `batch // 2` identities (a base image each plus
    noise), two of each, and their labels."""
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(batch // 2), 2).astype(np.int32)
    base = rng.randint(0, 256, (classes, 160, 160, 3)).astype(np.float32)
    images = np.clip(base[labels % classes]
                     + 20 * rng.randn(batch, 160, 160, 3), 0,
                     255).astype(np.uint8)
    return images, labels


# (metric rtol, leaf atol, leaf bound as a fraction of its largest update)
TRAIN_BOUNDS = {'float32': (1e-4, 1e-6, 0.5), 'float64': (1e-5, 1e-12, 1e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', sorted(TRAIN_BOUNDS))
@pytest.mark.parametrize('loss', sorted(TRAIN_LOSSES))
def test_train_step_on_the_card_matches_the_cpu(loss, dtype):
    """A TINY train step with TF32 off: the losses (the forward before the
    update) and every parameter, BN statistic and center against the
    CPU's. float32 holds each leaf within half its largest update + 1e-6
    (the float32 backward through train-mode BatchNorm at batch 8 is
    ill-conditioned; see tests/test_torch_train.py); float64 within 1e-5
    of it + 1e-12, the metrics at rtol 1e-5 (the losses keep their float32
    casts: the triplet loss, a mean of hinge terms, is float32 to ~1e-6
    of itself)."""
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.train.softmax import step_on_devices

    _gpu()
    rtol, atol, bound = TRAIN_BOUNDS[dtype]
    cfg = Config({'image': {'size': 160},
                  'train': {'epoch': {'size': 1},
                            'learning_rate': {'value': 1e-3}},
                  'loss': TRAIN_LOSSES[loss]})
    (card, cpu), worst, _ = step_on_devices(
        cfg, 4, *_train_batch(8, 4), model_cfg=TINY,
        dtype=getattr(torch, dtype), atol=atol)
    assert sorted(card) == sorted(cpu)
    for key in cpu:
        np.testing.assert_allclose(card[key], cpu[key], rtol=rtol,
                                   atol=atol, err_msg=key)
    assert worst <= bound, worst


@pytest.mark.cuda
def test_grid_step_on_the_card_equals_one_rank():
    """chip_smoke phase 32's (data=2, model=1) check at TINY width, through
    the same function: two gloo ranks share the card, one float64 step of
    softmax + center at global batch 8 with TF32 off against the same step
    on one rank; every leaf within 1e-5 of its update + 1e-12, the metrics
    at rtol 1e-5."""
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.train.softmax import step_on_grid

    _gpu()
    cfg = Config({'image': {'size': 160},
                  'train': {'epoch': {'size': 1},
                            'learning_rate': {'value': 1e-3}},
                  'loss': TRAIN_LOSSES['softmax + center']})
    (grid, one), worst, _ = step_on_grid(
        cfg, 4, *_train_batch(8, 4), (2, 1), model_cfg=TINY,
        dtype=torch.float64, atol=1e-12, backend='gloo', device='cuda',
        timeout=600)
    assert sorted(grid) == sorted(one)
    for key in one:
        np.testing.assert_allclose(grid[key], one[key], rtol=1e-5,
                                   atol=1e-12, err_msg=key)
    assert worst <= 1e-5, worst


# Faster-RCNN serving and training on the card (chip_smoke phases 35 and
# 37 at 128 x 128): no hand-written kernel runs on these paths.

def _frcnn_scenes(n, seed=0):
    rng = np.random.RandomState(seed)
    scenes = [synthetic.render_scene(rng, shape=(128, 128), n_faces=2,
                                     min_face=30, max_face=80)
              for _ in range(n)]
    return np.stack([s[0] for s in scenes]), [s[1] for s in scenes]


@pytest.mark.cuda
def test_frcnn_detection_on_the_card_matches_the_cpu():
    _gpu()
    from facenet_tpu_torch.detectors.evaluation import compare_outputs
    from facenet_tpu_torch.detectors.frcnn import FasterRCNN
    images, _ = _frcnn_scenes(4)
    params = pretrained.load_bundled('frcnnv3')
    outs = [FasterRCNN(image_shape=(128, 128), params=params,
                       device=device).detect_batch(images)
            for device in ('cuda', 'cpu')]
    gap = compare_outputs(*outs)
    assert gap['n_b'] >= 4 and gap['unmatched'] == 0, gap
    assert gap['box_px'] <= 1.5 and gap['score'] <= 0.02, gap


@pytest.mark.cuda
def test_frcnn_train_step_on_the_card_matches_the_cpu():
    _gpu()
    from facenet_tpu_torch.detectors.frcnn import detector
    images, gts = _frcnn_scenes(2, seed=1)
    (card, cpu), worst = detector.step_on_devices(
        pretrained.load_bundled('frcnnv3'), images, gts)
    for k, v in cpu.items():
        assert card[k] == pytest.approx(v, rel=1e-4), k
    assert worst <= 1e-3


TINY_V2 = {'repeat': [1, 1, 1], 'embedding_size': 32}


@pytest.mark.cuda
@pytest.mark.parametrize('keep', [1.0, 0.5])
def test_irv2_train_step_on_the_card_matches_the_cpu(keep):
    """chip_smoke phase 43 at TINY width: one float64 IRv2 softmax step
    with TF32 off on the card and on the CPU, through `step_on_devices`.
    Both draw the dropout mask from the state's generator on the host, so
    the keep-0.5 step is the same step on both: the metrics at rtol 1e-5,
    every leaf within 1e-5 of its update + 1e-12."""
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.train.softmax import step_on_devices

    _gpu()
    cfg = Config({'image': {'size': 160},
                  'train': {'epoch': {'size': 1},
                            'learning_rate': {'value': 1e-3}},
                  'loss': {'center_factor': 0.0, 'triplet_factor': 0.0}})
    (card, cpu), worst, _ = step_on_devices(
        cfg, 4, *_train_batch(8, 4),
        model_cfg={'module': 'inception_resnet_v2',
                   'config': dict(TINY_V2, keep_probability=keep)},
        dtype=torch.float64, atol=1e-12)
    for key in cpu:
        np.testing.assert_allclose(card[key], cpu[key], rtol=1e-5,
                                   atol=1e-12, err_msg=key)
    assert worst <= 1e-5, worst


@pytest.mark.cuda
@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_compiled_artifact_on_the_card_matches_the_cpu(tmp_path, quantize):
    """An artifact exported on the card runs on the CPU and one exported
    on the CPU runs on the card; the four runs agree at cosine >= 0.999
    (bf16 convolutions of two libraries; int8 sums are exact)."""
    from facenet_tpu_torch import export

    _gpu()
    bundle = export.ModelBundle(init_variables(TINY, seed=0), {
        'model_class': 'InceptionResnetV1', 'config': TINY,
        'image_size': 160, 'normalization': 0})
    rng = np.random.RandomState(0)
    calib = rng.randint(0, 256, (8, 160, 160, 3), np.uint8)
    images = rng.randint(0, 256, (3, 160, 160, 3), np.uint8)
    outs = []
    for made in ('cuda', 'cpu'):
        path = export.save_compiled(tmp_path / made, bundle,
                                    quantize=quantize, calib_images=calib,
                                    device=made)
        for run in ('cuda', 'cpu'):
            outs.append(export.load_compiled(path, device=run)(images)
                        .float().cpu().numpy())
    for got in outs[1:]:
        assert (got * outs[0]).sum(axis=1).min() >= 0.999
