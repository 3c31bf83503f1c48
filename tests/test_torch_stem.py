"""Port fused stem (facenet_tpu_torch/ops/stem.py, B5) against the JAX
package on the same folded weights and seeded uint8 images.

- `stem_forward` on the CPU (its plain version, the kernel's arithmetic)
  against `pallas_stem.stem_forward_flat(interpret=True)`: max |d| / max
  |ref| < 0.01 (both round to bf16 after each conv, so they differ by
  summation order and single bf16 roundings, at most 2^-7 of a value), and
  against the JAX XLA prefix at 0.03, the bound of tests/test_pallas_stem.py;
- `pack_stem`'s layout: the kernel's index arithmetic, restated with the
  packed vector, gives the plain version's output;
- `fast_forward(stem='fused')` on TINY against JAX
  `fast_forward(stem='pallas-interpret')` and against the port's
  `stem='cudnn'`: min cosine > 0.999;
- the errors the JAX entry point raises, and the wrapper's alignment check;
- the kernel's persistent walk over (image, tile) items, restated: every
  item exactly once, for several grids and batches.

The CUDA kernel itself is held to the plain version in
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from facenet_tpu.models import irv1_fast as jax_fast
from facenet_tpu.models.inception_resnet_v1 import create_model
from facenet_tpu.ops import pallas_stem
from facenet_tpu.ops.preprocessing import image_processing as jax_processing
from facenet_tpu_torch.models import irv1_fast
from facenet_tpu_torch.ops import stem
from facenet_tpu_torch.ops.preprocessing import image_processing
from torch_testing import few_threads  # noqa: F401

TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}, 'output': {'size': 32}}


def _variables(config, seed):
    """Flax-initialized variables with non-trivial BN statistics, as numpy."""
    model = create_model(config)
    x0 = np.zeros((1, 160, 160, 3), np.uint8)
    variables = model.init(jax.random.PRNGKey(seed), x0, train=False)
    rng = np.random.RandomState(seed + 1)

    def stat(path, a):          # small means keep the ReLUs alive
        if path[-1].key == 'mean':
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return np.abs(rng.normal(0.5, 0.2, a.shape)).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(stat, variables['batch_stats'])
    return {'params': jax.tree_util.tree_map(np.asarray, variables['params']),
            'batch_stats': stats}


@pytest.fixture(scope='module')
def tiny():
    variables = _variables(TINY, 1)
    jparams, jcfg = jax_fast.build_fast_params(variables, TINY)
    params, cfg = irv1_fast.build_fast_params(variables, TINY, device='cpu')
    return (jparams, jcfg), (params, cfg)


def _jax_xla_prefix(params, images):
    x = jax_processing(jnp.asarray(images), 160, 0, dtype=jnp.bfloat16)
    b, h, w, c = x.shape
    xs = x.reshape(b, h // 2, 2, w // 2, 2, c)
    xs = xs.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    x = jax.nn.relu(jax_fast._conv(xs, params['Conv2d_1a_s2d'], 1, 'VALID'))
    x = jax_fast._crelu(x, params['Conv2d_2a_3x3'], 1, 'VALID')
    x = jax_fast._crelu(x, params['Conv2d_2b_3x3'], 1, 'VALID')
    return jax.lax.reduce_window(
        x, jnp.finfo(x.dtype).min, jax.lax.max,
        (1, 3, 3, 1), (1, 2, 2, 1), 'VALID')


def _rel(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)


def _nhwc(out):
    """The wrapper's NCHW bf16 output as float32 NHWC numpy."""
    return out.float().permute(0, 2, 3, 1).numpy()


def test_stem_forward_matches_pallas_interpret_and_xla_prefix(tiny):
    (jparams, _), (params, _) = tiny
    images = np.random.RandomState(3).randint(0, 256, (2, 160, 160, 3),
                                              dtype=np.uint8)
    planes = pallas_stem.to_planes(
        jax_processing(jnp.asarray(images), 160, 0, dtype=jnp.bfloat16))
    ref = np.asarray(pallas_stem.stem_forward_flat(
        pallas_stem.pack_stem(jparams), planes, interpret=True), np.float32)
    xla = np.asarray(_jax_xla_prefix(jparams, images), np.float32)

    before = stem.stem_forward.launches
    x = image_processing(torch.from_numpy(images), 160, 0,
                         dtype=torch.bfloat16)
    out = stem.stem_forward(params, x)
    assert stem.stem_forward.launches == before       # CPU: the plain version
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 64, 37, 37)
    assert out.is_contiguous(memory_format=torch.channels_last)
    got = _nhwc(out)
    assert got.shape == ref.shape == (2, 37, 37, 64)
    assert np.abs(ref).max() > 0.1
    assert _rel(got, ref) < 0.01
    assert _rel(got, xla) < 0.03


def _unpack(packed):
    """The packed vector as the kernel reads it: [K, co] matrices of the
    three convs (bf16 values as float32) and the float32 biases."""
    off = stem.OFFSETS
    halfs = packed[:off['bias']].view(torch.bfloat16).float()
    inverse = np.argsort(stem.DEPTH_ORDER)
    mats = []
    for name, k, co in (('w1', 48, 32), ('w2', 288, 32), ('w3', 288, 64)):
        steps = halfs[off[name]:off[name] + k * co].reshape(k // 16, co, 16)
        mats.append(steps[:, :, inverse].permute(0, 2, 1).reshape(k, co))
    return mats, packed[off['bias']:].view(torch.float32)


def _by_kernel_indexing(packed, x):
    """The kernel's arithmetic restated with the packed vector and the
    kernel's index maps: conv1 over the 4x4 pixel window at (2i, 2j) with
    depth k = (py * 4 + px) * 3 + c, the 3x3 convs with depth
    k = (ky * 3 + kx) * 32 + ci."""
    (w1, w2, w3), bias = _unpack(packed)

    def bf16(t):
        return t.to(torch.bfloat16).float()

    b = x.shape[0]
    px = x.float().permute(0, 3, 1, 2)                          # [B, 3, H, W]
    win = F.unfold(px, kernel_size=4, stride=2)       # [B, 3*16, 79*79] (c,py,px)
    win = win.reshape(b, 3, 16, 79 * 79).permute(0, 3, 2, 1)    # (py*4+px, c)
    c1 = bf16(F.relu(win.reshape(b, 79 * 79, 48) @ w1 + bias[:32]))
    c1 = c1.reshape(b, 79, 79, 32).permute(0, 3, 1, 2)

    def conv(z, w, co, bias):                 # [(ky, kx, ci), co] -> OIHW
        return F.conv2d(z, w.reshape(3, 3, 32, co).permute(3, 2, 0, 1), bias)

    c2a = bf16(F.relu(conv(c1, w2, 32, bias[32:64])))
    c2b = bf16(F.relu(conv(c2a, w3, 64, bias[64:])))
    return F.max_pool2d(c2b, 3, 2)


def test_pack_stem_layout(tiny):
    _, (params, _) = tiny
    packed = stem.pack_stem(params)
    assert packed.shape == (stem.N_HALFS,) and packed.dtype == torch.int16
    assert all(o % 8 == 0 for o in stem.OFFSETS.values())
    assert sorted(stem.DEPTH_ORDER) == list(range(16))
    (w1, w2, w3), bias = _unpack(packed)
    # the biases are the params' own, in float32
    assert torch.equal(bias, torch.cat([params[k]['b'].float()
                                        for k in stem.STEM_KEYS]))
    # tap (a, b) = (1, 0) of plane (dy, dx) = (0, 1), channel 2, output 5 sits
    # at pixel offset (py, px) = (2, 1) of the cell's 4x4 window
    k = params['Conv2d_1a_s2d']['k'].float()
    assert w1[(2 * 4 + 1) * 3 + 2, 5] == k[5, (0 * 2 + 1) * 3 + 2, 1, 0]
    k3 = params['Conv2d_2b_3x3']['k'].float()
    assert w3[(2 * 3 + 1) * 32 + 7, 40] == k3[40, 7, 2, 1]
    # one thread's four values of a depth step lie together: step 0 of
    # conv2a, output 3, thread t = 1 reads depth 2, 3, 10, 11 (tap (0, 0))
    k2 = params['Conv2d_2a_3x3']['k'].float()
    at = stem.OFFSETS['w2'] + 3 * 16 + 4
    assert torch.equal(packed[at:at + 4].view(torch.bfloat16).float(),
                       k2[3, [2, 3, 10, 11], 0, 0])

    images = np.random.RandomState(4).randint(0, 256, (1, 160, 160, 3),
                                              dtype=np.uint8)
    x = image_processing(torch.from_numpy(images), 160, 0,
                         dtype=torch.bfloat16)
    want = stem.stem_forward_plain(params, x).float()
    got = _by_kernel_indexing(packed, x)
    assert _rel(got.numpy(), want.numpy()) < 0.01
    # cached per parameter set and device
    assert stem.packed_stem(params, torch.device('cpu')) is \
        stem.packed_stem(params, torch.device('cpu'))


@pytest.mark.parametrize('blocks', [1, 7, 132, 264])
@pytest.mark.parametrize('batch', [1, 3, 128])
def test_persistent_walk_visits_every_item_once(blocks, batch):
    """The kernel's walk (csrc/stem_fused.cu): group k of block b takes
    items GROUPS * b + k, then every GROUPS * blocks-th; together the groups
    cover the batch's items exactly once, and no two groups' loads differ
    by more than one item."""
    items = batch * stem.TILES ** 2

    def walk(blocks):
        stride = stem.GROUPS * blocks
        return [list(range(stem.GROUPS * b + k, items, stride))
                for b in range(blocks) for k in range(stem.GROUPS)]

    mine = walk(blocks)
    assert sorted(i for group in mine for i in group) == list(range(items))
    sizes = [len(group) for group in mine]
    assert max(sizes) - min(sizes) <= 1
    # the launch's own grid: one block an SM, none idle at a small batch
    grid = stem.launch_blocks(batch, 132)
    assert grid == min(132, -(-batch * 25 // 2))
    assert all(walk(grid)[stem.GROUPS * b] for b in range(grid))


def test_schedule_mirrors_the_source():
    """`stem.SCHEDULE` (what chip_smoke counts the shared loads of) is the
    source's schedule; the packed vector's size is the source's."""
    import re

    from facenet_tpu_torch.ops.cuda_build import CSRC
    text = (CSRC / 'stem_fused.cu').read_text()

    def constant(name):
        return int(re.search(rf'constexpr int {name} = (\d+);',
                             text).group(1))

    assert stem.SCHEDULE == ((constant('CONV1_MT'), 4),
                             (constant('CONV2A_MT'), 4),
                             (constant('CONV2B_MT'), constant('CONV2B_NT')))
    assert constant('OFF_BIAS') + 256 == stem.N_HALFS
    assert (constant('P'), constant('GROUPS')) == (8, stem.GROUPS)


def test_stem_forward_refuses_a_misaligned_view():
    """The kernel copies the image in 8-byte pieces: a contiguous view that
    starts 2 bytes into its storage is refused before any launch."""
    n = 160 * 160 * 3
    base = torch.zeros(n + 4, dtype=torch.bfloat16)
    weights = torch.zeros(16, dtype=torch.int16)
    stem._check_aligned(base[:n].view(1, 160, 160, 3), weights)
    with pytest.raises(ValueError, match='8 bytes'):
        stem._check_aligned(base[1:n + 1].view(1, 160, 160, 3), weights)
    with pytest.raises(ValueError, match='16'):
        stem._check_aligned(base[:n].view(1, 160, 160, 3), weights[1:9])


def test_fast_forward_fused_stem_matches_jax_and_cudnn(tiny):
    (jparams, jcfg), (params, cfg) = tiny
    images = np.random.RandomState(5).randint(0, 256, (2, 160, 160, 3),
                                              dtype=np.uint8)
    ref = np.asarray(jax_fast.fast_forward(jparams, jcfg, images,
                                           stem='pallas-interpret'),
                     np.float32)
    with torch.inference_mode():
        fused = irv1_fast.fast_forward(params, cfg, torch.from_numpy(images),
                                       stem='fused').numpy()
        cudnn = irv1_fast.fast_forward(params, cfg, torch.from_numpy(images),
                                       stem='cudnn').numpy()
    assert fused.shape == ref.shape == (2, 32)
    np.testing.assert_allclose(np.linalg.norm(fused, axis=1), 1, atol=1e-5)
    assert (fused * ref).sum(axis=1).min() > 0.999
    assert (fused * cudnn).sum(axis=1).min() > 0.999


def test_fast_embedder_takes_the_stem_option():
    variables = _variables(TINY, 2)
    images = np.random.RandomState(6).randint(0, 256, (2, 160, 160, 3),
                                              dtype=np.uint8)
    fused = irv1_fast.FastEmbedder(variables, TINY, device='cpu',
                                   stem='fused')
    cudnn = irv1_fast.FastEmbedder(variables, TINY, device='cpu')
    assert (fused.stem, cudnn.stem) == ('fused', 'cudnn')
    cos = (fused(images) * cudnn(images)).sum(dim=1)
    assert float(cos.min()) > 0.999
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            irv1_fast.FastEmbedder(variables, TINY, stem='fused')
    assert 'Conv2d_1a_s2d' in irv1_fast.STEM_SKIP


def test_build_fast_params_default_device_without_gpu_raises():
    """Like every entry point, the fused params go to the GPU unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        irv1_fast.build_fast_params({}, TINY)


@pytest.mark.parametrize('case', ['size', 'params', 'stem', 'dtype',
                                  'embedder'])
def test_fused_stem_raises_as_the_jax_entry_point_does(tiny, case):
    _, (params, cfg) = tiny
    images = torch.zeros((1, 160, 160, 3), dtype=torch.uint8)
    if case == 'size':
        with pytest.raises(ValueError, match=r'160, 160'):
            irv1_fast.fast_forward(params, cfg,
                                   torch.zeros((1, 128, 128, 3),
                                               dtype=torch.uint8),
                                   image_size=128, stem='fused')
        with pytest.raises(ValueError, match='160'):
            stem.stem_forward(params, torch.zeros((1, 128, 128, 3),
                                                  dtype=torch.bfloat16))
    elif case == 'params':
        bare = {k: v for k, v in params.items() if k != 'Conv2d_1a_s2d'}
        with pytest.raises(ValueError, match='s2d'):
            irv1_fast.fast_forward(bare, cfg, images, stem='fused')
        with pytest.raises(ValueError, match='Conv2d_1a_s2d'):
            stem.pack_stem(bare)
    elif case == 'stem':
        with pytest.raises(ValueError, match='unknown stem'):
            irv1_fast.fast_forward(params, cfg, images, stem='pallas')
    elif case == 'dtype':
        with pytest.raises(ValueError, match='bfloat16'):
            irv1_fast.fast_forward(params, cfg, images, dtype=torch.float32,
                                   stem='fused')
    else:
        with pytest.raises(ValueError, match='unknown stem'):
            irv1_fast.FastEmbedder({}, TINY, device='cpu', stem='xla')
