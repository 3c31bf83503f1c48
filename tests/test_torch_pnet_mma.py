"""The tensor-core P-Net tile's weight vector and index maps, on the CPU.

The CUDA tile (facenet_tpu_torch/csrc/pnet_tile_mma.cuh) runs only on the
card, where tests/test_torch_cuda_kernels.py and chip_smoke.py hold it
against `pnet.level_plain`. Here its host side is checked:

- `pnet.pack_mma` against `pnet.pack_arrays`: every kernel entry of the
  fragment-ordered vector is the packed float32 vector's entry that the
  kernel's index maps name, with zeros where the kernel relies on them
  (taps outside a pool position's 3x3, conv2's input channels 10..15,
  padding of the float section);
- the kernel's arithmetic restated in numpy with the kernel's own index
  maps (pixel-major patch, window GEMM for conv1 with the masked pool,
  cell-major tiles in the fragments' channel order, (tap, 16 channels)
  GEMMs, heads) against `level_plain` on levels with odd edges: probs 0.02,
  reg 0.05, the gates the card holds the kernel to;
- B6's three-part weights: `pnet.split_bf16` is exact (hi + mid + lo == w
  in float64) on the bundle, on a random init and on magnitudes from 1e-30
  to 1e3 of both signs; the three-part vector mirrors the source's
  constants; the tile restated with the three parts read from their own
  offsets agrees with `level_plain` on the unrounded vector and lies nearer
  to it than to `level_plain` on the rounded one.
"""

import re

import numpy as np
import pytest
import torch

from facenet_tpu_torch.detectors import pretrained
from facenet_tpu_torch.detectors.mtcnn import networks, pnet
from facenet_tpu_torch.ops.cuda_build import CSRC
from facenet_tpu_torch.ops.stem import DEPTH_ORDER

POOL, C2, TILE, IN = 20, 18, 16, 42       # tile sides, as in the source
IN_ROW = 3 * IN


@pytest.fixture(scope='module')
def bundled():
    net = networks.PNet().from_flax_params(
        pretrained.load_bundled('mtcnn')['pnet'])
    packed = pnet.pack_weights(net)
    return net, packed, pnet.pack_mma(packed)


def _sections(vector, parts=1):
    """(bf16 kernels of every part as float32 numpy, float32 section) of
    the vector."""
    start = parts * pnet.MMA_PART_HALFS
    halfs = vector[:start].view(torch.bfloat16).float().numpy()
    return halfs, vector[start:].view(torch.float32).numpy()


def _fragment_matrix(halfs, name, steps, columns, part=0):
    """[steps * 16, columns] as the kernel's B fragments address it: the
    value of depth step s, position pos, column n of a part lies at
    part * MMA_PART_HALFS + offset + (s * columns + n) * 16 + pos."""
    start = part * pnet.MMA_PART_HALFS + pnet.MMA_OFFSETS[name]
    block = halfs[start:start + steps * columns * 16]
    return block.reshape(steps, columns, 16).transpose(0, 2, 1).reshape(
        steps * 16, columns)


def _block(packed, name, *shape):
    start = pnet.OFFSETS[name]
    return packed[start:start + int(np.prod(shape))].reshape(shape).numpy()


def test_vector_sizes_mirror_the_source():
    assert pnet.MMA_OFFSETS == {'w1': 0, 'w2': 3 * 40 * 16,
                                'w3': 3 * 40 * 16 + 9 * 16 * 16,
                                'floats': 3 * 40 * 16 + 9 * 48 * 16}
    assert pnet.MMA_N_HALFS == 8832 + 2 * 392 and pnet.MMA_N_HALFS % 8 == 0
    assert sorted(DEPTH_ORDER) == list(range(16))
    # one thread's four depth values of a step lie together
    for t in range(4):
        assert tuple(DEPTH_ORDER[4 * t:4 * t + 4]) == (2 * t, 2 * t + 1,
                                                       2 * t + 8, 2 * t + 9)
    assert 'pnet_tile_mma.cuh' in [h.name for h in pnet.KERNEL.headers]
    assert 'pnet_tile_mma.cuh' in [h.name for h in pnet.LEVEL_KERNEL.headers]
    assert all(h.exists() for h in pnet.KERNEL.headers)


def _check_against_pack_arrays(vector, packed, parts=1):
    """Every entry of the tile's vector (the sum of its parts, in float64)
    is the packed float32 vector's entry that the kernel's index maps name,
    with zeros where the kernel relies on them."""
    halfs, floats = _sections(vector, parts)
    inverse = np.argsort(DEPTH_ORDER)        # depth value -> position

    def depth_rows(name, steps, columns):
        """The parts' sum, fragment positions back to depth order within
        each step."""
        matrix = sum(_fragment_matrix(halfs, name, steps, columns, part)
                     .astype(np.float64) for part in range(parts))
        k = steps * 16
        return matrix.reshape(steps, 16, columns)[:, inverse].reshape(
            k, columns)

    # conv1: depth k = wy * 12 + wx * 3 + c of the 4x4 window; column
    # p * 8 + ch (ch < 8) or 32 + p * 2 + (ch - 8) of pool position p
    w1 = _block(packed, 'w1', 3, 3, 3, 10)                # [c][ky][kx][co]
    m1 = depth_rows('w1', 3, 40)
    seen = np.zeros_like(m1, dtype=bool)
    for p in range(4):
        sy, sx = divmod(p, 2)
        for ch in range(10):
            col = p * 8 + ch if ch < 8 else 32 + p * 2 + ch - 8
            for wy in range(4):
                for wx in range(4):
                    for c in range(3):
                        k = wy * 12 + wx * 3 + c
                        ky, kx = wy - sy, wx - sx
                        inside = 0 <= ky < 3 and 0 <= kx < 3
                        want = w1[c, ky, kx, ch] if inside else 0.0
                        assert m1[k, col] == want
                        seen[k, col] = True
    assert seen.all() and np.count_nonzero(m1) <= 4 * 270

    # conv2 and conv3: depth k = tap * 16 + ci; conv2's ci >= 10 are zeros
    w2 = _block(packed, 'w2', 10, 3, 3, 16)
    m2 = depth_rows('w2', 9, 16).reshape(3, 3, 16, 16)
    np.testing.assert_array_equal(m2[:, :, :10], w2.transpose(1, 2, 0, 3))
    assert not m2[:, :, 10:].any()
    w3 = _block(packed, 'w3', 16, 3, 3, 32)
    m3 = depth_rows('w3', 9, 32).reshape(3, 3, 16, 32)
    np.testing.assert_array_equal(m3, w3.transpose(1, 2, 0, 3))

    # float section: biases and slopes as they are, heads as [32][8]
    used = np.zeros(floats.size, dtype=bool)
    for name, start in pnet.MMA_FLOATS.items():
        if name == 'wh':
            heads = floats[start:start + 256].reshape(32, 8)
            np.testing.assert_array_equal(heads[:, :6],
                                          _block(packed, 'wh', 32, 6))
            used[start:start + 256].reshape(32, 8)[:, :6] = True
        else:
            size = {'1': 10, '2': 16, '3': 32, 'h': 6}[name[1]]
            np.testing.assert_array_equal(floats[start:start + size],
                                          _block(packed, name, size))
            used[start:start + size] = True
    assert not floats[~used].any()


def test_pack_mma_against_pack_arrays(bundled):
    net, packed, vector = bundled
    assert vector.shape == (pnet.MMA_N_HALFS,) and vector.dtype == torch.int16
    assert torch.equal(vector, pnet.pack_weights_mma(net))
    _check_against_pack_arrays(vector, packed)
    # the thread t = 1 of column 3 reads depth 2, 3, 10, 11 of tap (0, 0)
    halfs, _ = _sections(vector)
    w3 = _block(packed, 'w3', 16, 3, 3, 32)
    at = pnet.MMA_OFFSETS['w3'] + 3 * 16 + 4
    np.testing.assert_array_equal(halfs[at:at + 4], w3[[2, 3, 10, 11], 0, 0, 3])


def test_mma_weights_are_cached_on_the_vector(bundled):
    net, _, vector = bundled
    packed = pnet.packed_weights(net, torch.device('cpu'))
    first = pnet.mma_weights(packed)
    assert first is pnet.mma_weights(packed)
    assert torch.equal(first, vector)
    clone = packed.clone()
    before = pnet.mma_weights(clone)
    clone[pnet.OFFSETS['b1']] += 1.0          # written to: packed anew
    after = pnet.mma_weights(clone)
    assert after is not before and not torch.equal(after, before)
    with torch.inference_mode():              # such a vector counts no writes
        frozen = packed.clone()
        assert pnet.mma_weights(frozen) is pnet.mma_weights(frozen)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _prelu(z, slope):
    return np.where(z >= 0, z, slope * z)


def _tile_by_kernel_indexing(vector, level, gy0, gx0, parts=1):
    """One 16x16 head tile of one image in the kernel's arithmetic and
    index maps: (six head outputs [16, 16, 6], valid mask [16, 16]). With
    three parts every product is exact, as on the tensor core: the sums run
    in float64 over the parts' own fragment matrices."""
    halfs, floats = _sections(vector, parts)

    def weights(name, steps, columns):
        return sum(_fragment_matrix(halfs, name, steps, columns, part)
                   .astype(np.float64) for part in range(parts))

    f = pnet.MMA_FLOATS
    _, sh, sw = level.shape
    h1, w1 = sh - 2, sw - 2
    hp, wp = (h1 + 1) // 2, (w1 + 1) // 2
    gh, gw = pnet.out_geometry(sh, sw)

    # stage 0: the 42x42 patch, pixel-major, zeros beyond the level
    s_in = np.zeros(IN * IN_ROW, np.float32)
    for py in range(IN):
        for px in range(IN):
            y, x = 2 * gy0 + py, 2 * gx0 + px
            if y < sh and x < sw:
                s_in[py * IN_ROW + px * 3:py * IN_ROW + px * 3 + 3] = \
                    level[:, y, x]

    # stage 1: conv1 as the window GEMM, masked pool, permuted cells
    m = np.arange(POOL * POOL)
    base = 2 * (m // POOL) * IN_ROW + 6 * (m % POOL)
    k = np.arange(48)
    a1 = s_in[base[:, None] + ((k // 12) * IN_ROW + k % 12)[None, :]]
    inverse = np.argsort(DEPTH_ORDER)
    frag1 = weights('w1', 3, 40)                      # rows: (step, position)
    w1m = frag1.reshape(3, 16, 40)[:, inverse].reshape(48, 40)
    c1 = a1 @ w1m                                     # [400, 40]
    s_pool = np.zeros((POOL * POOL, 16), np.float64)
    py, px = gy0 + m // POOL, gx0 + m % POOL
    cell = (py < hp) & (px < wp)
    for ch in range(10):
        best = np.full(m.size, -np.inf)
        for p in range(4):
            col = p * 8 + ch if ch < 8 else 32 + p * 2 + ch - 8
            counts = (2 * py + p // 2 < h1) & (2 * px + p % 2 < w1)
            z = _prelu(c1[:, col] + floats[f['b1'] + ch], floats[f['a1'] + ch])
            best = np.where(counts, np.maximum(best, z), best)
        s_pool[:, inverse[ch]] = np.where(cell, _bf16(best), 0.0)
    assert np.isfinite(s_pool).all()

    # stage 2: conv2, depth (tap, position) straight from the permuted cells
    m = np.arange(C2 * C2)
    base = (m // C2) * POOL + m % C2
    taps = (np.arange(9) // 3) * POOL + np.arange(9) % 3
    a2 = s_pool[base[:, None] + taps[None, :]].reshape(m.size, 144)
    c2 = a2 @ weights('w2', 9, 16)
    c2 = _bf16(_prelu(c2 + floats[f['b2']:f['b2'] + 16],
                      floats[f['a2']:f['a2'] + 16]))
    s_c2 = c2[:, list(DEPTH_ORDER)]                   # position <- channel

    # stage 3: conv3 and the heads
    m = np.arange(TILE * TILE)
    base = (m // TILE) * C2 + m % TILE
    taps = (np.arange(9) // 3) * C2 + np.arange(9) % 3
    a3 = s_c2[base[:, None] + taps[None, :]].reshape(m.size, 144)
    c3 = a3 @ weights('w3', 9, 32)
    c3 = _bf16(_prelu(c3 + floats[f['b3']:f['b3'] + 32],
                      floats[f['a3']:f['a3'] + 32]))
    heads = floats[f['wh']:f['wh'] + 256].reshape(32, 8)[:, :6]
    z = c3 @ heads + floats[f['bh']:f['bh'] + 6]
    gy, gx = gy0 + m // TILE, gx0 + m % TILE
    valid = (gy < gh) & (gx < gw)
    return z.reshape(TILE, TILE, 6), valid.reshape(TILE, TILE)


def _level_by_kernel_indexing(vector, level, parts=1):
    """Every tile of one image's level [3, sh, sw] through
    `_tile_by_kernel_indexing`: the six head outputs [gh, gw, 6]."""
    _, sh, sw = level.shape
    gh, gw = pnet.out_geometry(sh, sw)
    got = np.full((gh, gw, 6), np.nan, np.float32)
    for gy0 in range(0, gh, TILE):
        for gx0 in range(0, gw, TILE):
            z, valid = _tile_by_kernel_indexing(vector, level, gy0, gx0,
                                                parts)
            rows, cols = min(TILE, gh - gy0), min(TILE, gw - gx0)
            assert valid[:rows, :cols].all() and valid.sum() == rows * cols
            got[gy0:gy0 + rows, gx0:gx0 + cols] = z[:rows, :cols]
    assert np.isfinite(got).all()
    return got


def _level(shape, seed=11):
    sh, sw = shape
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (1, 3, sh, sw)).astype(np.float32)
    return networks.normalize_crops(torch.from_numpy(x)).to(torch.bfloat16)


@pytest.mark.parametrize('shape', [(41, 129), (14, 18), (45, 44)])
def test_kernel_index_maps_against_level_plain(bundled, shape):
    """Every tile of a level through the numpy restatement of the kernel;
    (41, 129) has odd conv1 extents both ways (the SAME pool's one-element
    windows) and a ragged last tile, (14, 18) is smaller than one tile."""
    _, packed, vector = bundled
    level = _level(shape)
    want = pnet.level_plain(packed, level, raw=True)[0].numpy()
    got = _level_by_kernel_indexing(vector, level[0].float().numpy())
    logits = torch.from_numpy(got[..., :2])
    probs = torch.softmax(logits, -1)[..., 1].numpy()
    want_probs = torch.softmax(torch.from_numpy(want[..., :2]), -1)[..., 1]
    assert np.abs(probs - want_probs.numpy()).max() < 0.02
    assert np.abs(got[..., 2:] - want[..., 2:]).max() < 0.05
    assert np.abs(got - want).max() < 0.05            # raw heads (B7)


@pytest.fixture(scope='module')
def random_pnet():
    """A P-Net with PyTorch's random init (seed 3): float32 weights far
    from bf16 values."""
    torch.manual_seed(3)
    return networks.PNet()


@pytest.mark.parametrize('case', ['bundle', 'random init', 'magnitudes'])
def test_three_part_split_is_exact(bundled, random_pnet, case):
    """hi + mid + lo == w in float64, each part a bf16 value, for every
    weight B6 multiplies; and the packed vector's three parts, read back at
    their offsets, sum to the float32 matrices."""
    if case == 'magnitudes':
        rng = np.random.RandomState(5)
        w = (rng.choice([-1.0, 1.0], 20000)
             * 10.0 ** rng.uniform(-30, 3, 20000)).astype(np.float32)
        w = torch.from_numpy(np.concatenate([w, [0.0, -0.0, 1e-30, 1e3]])
                             .astype(np.float32))
    else:
        net = bundled[0] if case == 'bundle' else random_pnet
        packed = pnet.pack_level_weights(net)
        w = torch.cat([packed[pnet.OFFSETS[k]:pnet.OFFSETS[k] + n]
                       for k, n in (('w1', 270), ('w2', 1440), ('w3', 4608),
                                    ('wh', 192))])
        assert not torch.equal(w, w.to(torch.bfloat16).float())
    parts = pnet.split_bf16(w)
    assert len(parts) == 3
    for part in parts:
        assert torch.equal(part, part.to(torch.bfloat16).float())
    total = sum(part.double() for part in parts)
    assert torch.equal(total, w.double())
    if case == 'magnitudes':
        return

    vector = pnet.pack_mma(packed, 3)
    assert vector.shape == (pnet.MMA3_N_HALFS,) and vector.dtype == torch.int16
    _check_against_pack_arrays(vector, packed, parts=3)
    # part 0 is the one-part vector's kernels: the rounding to bf16
    one_part = pnet.pack_mma(packed)
    assert torch.equal(vector[:pnet.MMA_PART_HALFS],
                       one_part[:pnet.MMA_PART_HALFS])
    assert torch.equal(vector[3 * pnet.MMA_PART_HALFS:],
                       one_part[pnet.MMA_PART_HALFS:])
    assert pnet.mma_weights(packed, 3) is pnet.mma_weights(packed, 3)
    assert torch.equal(pnet.mma_weights(packed, 3), vector)
    assert torch.equal(pnet.mma_weights(packed), one_part)


def _source_constant(text, name):
    return int(re.search(rf'constexpr int {name} = (\d+);', text).group(1))


def test_three_part_vector_mirrors_the_source():
    """The sizes the wrappers pass and the kernels check: parts of
    W_HALFS, then N_FLOATS floats; the three-part tile's shared memory
    leaves room for two blocks an SM."""
    text = (CSRC / 'pnet_tile_mma.cuh').read_text()
    assert _source_constant(text, 'W_HALFS') == pnet.MMA_PART_HALFS
    assert _source_constant(text, 'N_FLOATS') == pnet.MMA_N_FLOATS
    for name, (key, start) in zip(('OFF_W1', 'OFF_W2', 'OFF_W3'),
                                  list(pnet.MMA_OFFSETS.items())[:3]):
        assert _source_constant(text, name) == start, key
    assert pnet.MMA3_N_HALFS == 3 * 8832 + 2 * 392 == 27280
    assert pnet.MMA3_N_HALFS % 8 == 0
    assert 'tc::N_HALFS3' in (CSRC / 'pnet_level.cu').read_text()
    tile_halfs = 5296 + 20 * 20 * 16           # A_HALFS + POOL_HALFS
    assert 2 * (pnet.MMA3_N_HALFS + tile_halfs) == 77952
    assert 2 * (77952 + 1024) <= 233472 < 3 * (77952 + 1024)


@pytest.mark.parametrize('shape', [(24, 100), (61, 83), (40, 129)])
def test_three_part_tile_against_level_plain(random_pnet, shape):
    """B6's tile restated with its three weight parts, each read at its own
    offset: within probs 0.02 and reg 0.05 of `level_plain` on the
    unrounded vector, and nearer to it (mean |d|) than to `level_plain` on
    the rounded one, which shows that mid and lo are used."""
    unrounded = pnet.pack_level_weights(random_pnet)
    rounded = pnet.pack_weights(random_pnet)
    level = _level(shape, seed=12)
    got = _level_by_kernel_indexing(pnet.mma_weights(unrounded, 3),
                                    level[0].float().numpy(), parts=3)
    probs = torch.softmax(torch.from_numpy(got[..., :2]), -1)[..., 1].numpy()
    dist = {}
    for name, packed in (('unrounded', unrounded), ('rounded', rounded)):
        p, r = (t[0].numpy() for t in pnet.level_plain(packed, level))
        dist[name] = (np.abs(probs - p), np.abs(got[..., 2:] - r))
    dp, dr = dist['unrounded']
    assert dp.max() < 0.02 and dr.max() < 0.05
    for i in range(2):
        assert dist['unrounded'][i].mean() < dist['rounded'][i].mean()
