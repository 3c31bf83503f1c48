"""Fused IRv1 stem prefix: the B5 kernel, its wrapper and its plain version.

`stem_forward` is the wrapper of the CUDA kernel ``csrc/stem_fused.cu``,
which replaces the Pallas TPU kernel
``facenet_tpu/ops/pallas_stem.py::_make_stem_kernel`` (entry
``stem_forward_flat``): Conv2d_1a (in its space-to-depth form), Conv2d_2a,
Conv2d_2b and MaxPool_3a of the fused Inception-ResNet-v1 on a 160x160
image, in one launch. On CUDA tensors it launches the kernel, or raises; on
CPU tensors it runs `stem_forward_plain`, which repeats the kernel's
arithmetic (bf16 operands, float32 sums, float32 bias and ReLU, a rounding
to bf16 after each conv) with ``F.conv2d``.

The kernel reads the normalized NHWC image as `image_processing` returns it:
the space-to-depth transform is an index map inside the kernel, so the
TPU version's ``to_planes`` relayout has no counterpart here. Its grid is
persistent: one block an SM (`launch_blocks`), as two groups of 8 warps
that walk the (image, 8x8 pooled tile) items in a fixed stride, with all
weights staged once per block. Its weights
come packed into one vector of 16-bit values (`pack_stem`: the bf16 kernels
in the order the tensor-core fragments read them, then the float32 biases;
cached on the parameter dict per device by `packed_stem`); the offsets
mirror the constants of the source.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from facenet_tpu_torch.ops.cuda_build import CudaKernel, check

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel('stem_fused.cu', {
    'stem_fused_launch': [_ptr, _i32, _ptr, _i32, _ptr, _ptr]})

IMAGE = 160                     # the only input size the kernel takes
OUT = 37                        # pooled output side
TILES = 5                       # 8x8 pooled tiles a side (37 = 4 * 8 + 5)
GROUPS = 2                      # groups of 8 warps in a block
# (cell tiles, column tiles of 8 channels) of a warp's item in conv1,
# conv2a and conv2b, as the source's CONV*_MT / CONV2B_NT constants
SCHEDULE = ((2, 4), (3, 4), (2, 4))
STEM_KEYS = ('Conv2d_1a_s2d', 'Conv2d_2a_3x3', 'Conv2d_2b_3x3')
# offsets in 16-bit values: three bf16 kernels [depth step][co][16], then
# the float32 biases b1 [32], b2 [32], b3 [64] (two 16-bit values each)
OFFSETS = {'w1': 0, 'w2': 1536, 'w3': 10752, 'bias': 29184}
N_HALFS = 29440
# where the 16 depth values of one step lie: the four that one thread feeds
# to one tensor-core instruction (k = 2t, 2t + 1, 2t + 8, 2t + 9) together
DEPTH_ORDER = (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15)
_CACHE_KEY = '_packed_stem'


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _check_params(params):
    for name in STEM_KEYS:
        if 'k' not in params.get(name, {}):
            raise ValueError(
                f'the fused stem needs the space-to-depth fast params '
                f'(build_fast_params): {name!r} is missing')


def depth_steps(matrix):
    """[K, co] -> [K / 16 steps][co][16] with each step's depth values in
    `DEPTH_ORDER` (the order every mma.sync bf16 kernel of the port reads
    its weight fragments in)."""
    k, co = matrix.shape
    steps = matrix.reshape(k // 16, 16, co)[:, list(DEPTH_ORDER), :]
    return steps.permute(0, 2, 1)


def pack_stem(params):
    """Fast params -> the kernel's weight vector [N_HALFS] int16 (CPU).

    Expects `build_fast_params` output: ``Conv2d_1a_s2d`` [32, 12, 2, 2],
    ``Conv2d_2a_3x3`` [32, 32, 3, 3], ``Conv2d_2b_3x3`` [64, 32, 3, 3]
    (OIHW, BN folded), each with its bias. Kernels are rounded to bf16 and
    stored as their bits; biases stay float32 (two 16-bit values each).
    Each conv is a matrix [depth K, co] cut into steps of 16 depth values,
    stored [step][co][16] with the 16 in `DEPTH_ORDER`. conv1's depth is the
    4x4 pixel window of a cell, k = (py * 4 + px) * 3 + c (py = 2a + dy,
    px = 2b + dx for tap (a, b) of plane (dy, dx)); the 3x3 convs' depth is
    k = (ky * 3 + kx) * 32 + ci.
    """
    _check_params(params)

    def kernel(name):
        return params[name]['k'].detach().float().cpu()

    w1 = kernel('Conv2d_1a_s2d')
    if tuple(w1.shape) != (32, 12, 2, 2):
        raise ValueError(f'Conv2d_1a_s2d kernel {tuple(w1.shape)} is not '
                         '[32, 12, 2, 2]')
    # [co, dy, dx, c, a, b] -> [a, dy, b, dx, c, co]
    w1 = w1.reshape(32, 2, 2, 3, 2, 2).permute(4, 1, 5, 2, 3, 0)
    w2 = kernel('Conv2d_2a_3x3').permute(2, 3, 1, 0)          # [ky,kx,ci,co]
    w3 = kernel('Conv2d_2b_3x3').permute(2, 3, 1, 0)
    if tuple(w2.shape) != (3, 3, 32, 32) or tuple(w3.shape) != (3, 3, 32, 64):
        raise ValueError('Conv2d_2a_3x3 / Conv2d_2b_3x3 kernels are not '
                         '[32, 32, 3, 3] / [64, 32, 3, 3]')
    kernels = torch.cat([
        depth_steps(w1.reshape(48, 32)).reshape(-1),
        depth_steps(w2.reshape(288, 32)).reshape(-1),
        depth_steps(w3.reshape(288, 64)).reshape(-1)])
    biases = torch.cat([params[name]['b'].detach().float().cpu().reshape(-1)
                        for name in STEM_KEYS])
    packed = torch.cat([kernels.to(torch.bfloat16).view(torch.int16),
                        biases.contiguous().view(torch.int16)])
    if packed.numel() != N_HALFS:
        raise ValueError(f'packed stem has {packed.numel()} values, not '
                         f'{N_HALFS}')
    return packed


def packed_stem(params, device):
    """`pack_stem` on `device`, cached in the parameter dict (under a
    private key) so that a serving loop packs once."""
    cached = params.get(_CACHE_KEY)
    if cached is None or cached.device != device:
        cached = pack_stem(params).to(device)
        params[_CACHE_KEY] = cached
    return cached


def launch_blocks(batch, sms):
    """The kernel's grid on a card with `sms` multiprocessors: one block an
    SM, fewer when the batch has fewer than two items an SM."""
    return min(sms, -(-batch * TILES * TILES // GROUPS))


def _check_input(x):
    if (x.dim() != 4 or tuple(x.shape[1:]) != (IMAGE, IMAGE, 3)
            or x.dtype != torch.bfloat16):
        raise ValueError(
            f'the fused stem takes normalized bfloat16 [B, {IMAGE}, {IMAGE}, '
            f'3] images, got {x.dtype} {tuple(x.shape)}')


def _check_aligned(x, weights):
    """The kernel copies the image in 8-byte and the weights in 16-byte
    pieces; a view that starts between them would fault on the card."""
    if x.data_ptr() % 8 or weights.data_ptr() % 16:
        raise ValueError(
            'the fused stem takes an image that starts on 8 bytes and '
            'weights that start on 16 (got a view at a storage offset)')


def stem_forward_plain(params, x):
    """Plain PyTorch version of `stem_forward` in the kernel's arithmetic
    (float32 convolutions of bf16 values, TF32 off, bf16 after each ReLU).

    :returns: [B, 64, 37, 37] bfloat16 in channels_last memory
    """
    _check_params(params)
    _check_input(x)
    b = x.shape[0]
    half = IMAGE // 2
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            xs = x.float().reshape(b, half, 2, half, 2, 3)
            xs = xs.permute(0, 2, 4, 5, 1, 3).reshape(b, 12, half, half)
            for name in STEM_KEYS:
                w = params[name]
                z = F.conv2d(xs, _bf16(w['k'].float()), w['b'].float())
                xs = _bf16(F.relu(z))
            out = F.max_pool2d(xs, 3, 2).to(torch.bfloat16)
            return out.contiguous(memory_format=torch.channels_last)
    finally:
        torch.backends.cudnn.allow_tf32 = allow


def stem_forward(params, x):
    """The IRv1 stem prefix (conv1, conv2a, conv2b, 3x3/s2 max pool).

    :param params: `build_fast_params` output (its ``Conv2d_1a_s2d``,
        ``Conv2d_2a_3x3`` and ``Conv2d_2b_3x3`` entries)
    :param x: normalized bfloat16 images [B, 160, 160, 3], contiguous and
        8-byte aligned, as `image_processing` returns them
    :returns: [B, 64, 37, 37] bfloat16 in channels_last memory, what
        ``Conv2d_3b_1x1`` takes

    CUDA tensors go to the kernel (counted in ``stem_forward.launches``),
    CPU tensors to `stem_forward_plain`.
    """
    _check_params(params)
    _check_input(x)
    device = x.device
    if device.type == 'cpu':
        return stem_forward_plain(params, x)
    if device.type != 'cuda':
        raise ValueError(f'unsupported device {device}')
    if not x.is_contiguous():
        raise ValueError('the fused stem takes a contiguous NHWC tensor')
    b = x.shape[0]
    weights = packed_stem(params, device)
    _check_aligned(x, weights)
    out = torch.empty((b, 64, OUT, OUT), dtype=torch.bfloat16, device=device,
                      memory_format=torch.channels_last)
    lib = KERNEL.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stem_fused_launch(x.data_ptr(), b, weights.data_ptr(),
                                    N_HALFS, out.data_ptr(), stream)
    check(err, 'stem_fused')
    stem_forward.launches += 1
    return out


stem_forward.launches = 0
