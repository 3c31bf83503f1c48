"""The P-Net kernels: their wrappers and their plain versions.

`pnet_forward_pyramid` (B3) is the wrapper of ``csrc/pnet_pyramid.cu``,
which replaces the Pallas TPU kernel
``facenet_tpu/detectors/mtcnn/pallas_pnet.py::_make_v4_kernel``: the P-Net
over every level of an image pyramid in one launch.

``csrc/pnet_level.cu`` holds the P-Net on one level, with two wrappers
here: `pnet_forward_flat` (B4, replaces ``pallas_pnet.py::_make_v3_kernel``)
on planes whose rows may be wider than the image, and `pnet_forward_level`
(B6, replaces ``pallas_pnet.py::_make_kernel``) on NCHW input with weights
that were not rounded to bf16. Its third entry point, on NHWC pixels, has
its wrapper in ``facenet_tpu_torch/tools/try_pnet_v3.py``. All of them run
the tile code of ``csrc/pnet_tile.cuh``.

On CUDA tensors a wrapper launches its kernel, or raises; on CPU tensors it
runs the plain version, `level_plain`, which repeats the kernels'
arithmetic with the same packed weights.

The kernels take their weights packed into one float32 vector
(`pack_weights`; cached on the module per device by `packed_weights`): conv
kernels as [ci][ky][kx][co], rounded to bf16 unless the caller asks
otherwise, biases and PReLU slopes in float32, each block 16-float aligned
for the kernels' vector loads. The offsets mirror the constants of
``csrc/pnet_tile.cuh``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from facenet_tpu_torch.detectors.mtcnn.networks import max_pool_same
from facenet_tpu_torch.ops.cuda_build import CudaKernel, check

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
_HEADERS = ('pnet_tile.cuh',)
KERNEL = CudaKernel('pnet_pyramid.cu', {
    'pnet_pyramid_launch': [_ptr, _i32, _i32, _ptr, _i32, _ptr]}, _HEADERS)
LEVEL_KERNEL = CudaKernel('pnet_level.cu', {
    'pnet_flat_launch': [_ptr, _i32, _i32, _i32, _i32, _ptr, _i32, _ptr,
                         _ptr, _ptr],
    'pnet_level_launch': [_ptr, _i32, _i32, _i32, _ptr, _i32, _ptr, _ptr,
                          _ptr],
    'pnet_trunk_nhwc_launch': [_ptr, _i32, _i32, _i32, _ptr, _i32, _ptr,
                               _ptr]}, _HEADERS)

MAX_LEVELS = 24
# (name, offset) of each packed block; N_WEIGHTS is the total
OFFSETS = {'w1': 0, 'b1': 272, 'a1': 284, 'w2': 296, 'b2': 1736, 'a2': 1752,
           'w3': 1768, 'b3': 6376, 'a3': 6408, 'wh': 6440, 'bh': 6632}
N_WEIGHTS = 6640


def out_geometry(sh, sw):
    """P-Net head grid (gh, gw) of an (sh, sw) level."""
    return -(-(sh - 2) // 2) - 4, -(-(sw - 2) // 2) - 4


def pack_arrays(blocks, rounded=True):
    """Weight blocks -> the kernels' float32 vector [N_WEIGHTS] (CPU).

    :param blocks: {'w1', 'w2', 'w3': OIHW conv kernels; 'wh': [6, 32] head
        kernel (2 class rows, then 4 box rows); 'b1'..'b3', 'bh': biases;
        'a1'..'a3': PReLU slopes}, float tensors
    :param rounded: round the conv and head kernels to bf16 values, the
        arithmetic of B3 and B4; False keeps them as given (B6)
    """
    def maybe_round(w):
        return _bf16(w) if rounded else w

    packed = torch.zeros(N_WEIGHTS, dtype=torch.float32)
    for name, start in OFFSETS.items():
        value = blocks[name].detach().float().cpu()
        if name in ('w1', 'w2', 'w3'):       # OIHW -> [ci][ky][kx][co]
            value = maybe_round(value.permute(1, 2, 3, 0))
        elif name == 'wh':                   # [6, 32] -> [32][6]
            value = maybe_round(value.t())
        value = value.reshape(-1)
        packed[start:start + value.numel()] = value
    return packed


def pack_weights(pnet, rounded=True):
    """The kernels' float32 weight vector [N_WEIGHTS] (on the CPU) of a
    `networks.PNet`; see `pack_arrays` for `rounded`."""
    return pack_arrays({
        'w1': pnet.conv1.weight, 'b1': pnet.conv1.bias,
        'a1': pnet.prelu1.alpha,
        'w2': pnet.conv2.weight, 'b2': pnet.conv2.bias,
        'a2': pnet.prelu2.alpha,
        'w3': pnet.conv3.weight, 'b3': pnet.conv3.bias,
        'a3': pnet.prelu3.alpha,
        'wh': torch.cat([pnet.cls.weight, pnet.reg.weight])[:, :, 0, 0],
        'bh': torch.cat([pnet.cls.bias, pnet.reg.bias]),
    }, rounded)


def pack_level_weights(pnet):
    """B6's weights: `pack_weights` without the rounding to bf16 (the TPU
    kernel of that entry point reads float32 scalars)."""
    return pack_weights(pnet, rounded=False)


def packed_weights(pnet, device):
    """`pack_weights` on `device`, cached on the module until its weights
    are reloaded (`from_flax_params` clears the cache)."""
    cached = getattr(pnet, '_packed', None)
    if cached is None or cached.device != device:
        cached = pack_weights(pnet).to(device)
        pnet._packed = cached
    return cached


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _unpack(packed):
    """The packed vector as conv operands: [(OIHW kernel, bias, slope)] of
    the three convs, then the head kernel [6, 32, 1, 1] and bias."""
    def block(name, *shape):
        start = OFFSETS[name]
        n = 1
        for side in shape:
            n *= side
        return packed[start:start + n].reshape(shape)

    convs = []
    for i, (ci, co) in enumerate(((3, 10), (10, 16), (16, 32)), start=1):
        kernel = block(f'w{i}', ci, 3, 3, co).permute(3, 0, 1, 2).contiguous()
        convs.append((kernel, block(f'b{i}', co), block(f'a{i}', co)))
    head = block('wh', 32, 6).t().reshape(6, 32, 1, 1).contiguous()
    return convs, head, block('bh', 6)


def level_plain(packed, x, raw=False):
    """One level in the kernels' arithmetic, plain PyTorch: bf16 inputs,
    the packed weights as they are, float32 sums, bias and PReLU,
    activations rounded to bf16 after each PReLU, float32 heads.

    :param packed: `pack_weights` / `pack_arrays` vector on x's device
    :param x: [B, 3, sh, sw], any float dtype (rounded to bf16 here)
    :param raw: return the six head outputs [B, gh, gw, 6] before the
        softmax (B7) instead of (probs [B, gh, gw], reg [B, gh, gw, 4])
    """
    convs, head, head_bias = _unpack(packed)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            x = _bf16(x.float())
            for i, (kernel, bias, alpha) in enumerate(convs):
                z = F.conv2d(x, kernel, bias)
                x = _bf16(torch.where(z >= 0, z,
                                      alpha[None, :, None, None] * z))
                if i == 0:
                    x = max_pool_same(x, 2, 2)
            z = F.conv2d(x, head, head_bias)
            if raw:
                return z.permute(0, 2, 3, 1).contiguous()
            probs = torch.softmax(z[:, 0:2], dim=1)[:, 1]
            return probs, z[:, 2:6].permute(0, 2, 3, 1).contiguous()
    finally:
        torch.backends.cudnn.allow_tf32 = allow


def pnet_forward_pyramid_plain(pnet, levels):
    """Plain PyTorch version of `pnet_forward_pyramid`, level by level in
    the kernel's arithmetic (float32 convolutions, TF32 off): [(probs
    [B, gh, gw], reg [B, gh, gw, 4])], float32."""
    levels = list(levels)
    if not levels:
        return []
    packed = packed_weights(pnet, levels[0].device)
    return [level_plain(packed, level) for level in levels]


def _launch_stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_level(x, name, shape_text, dims):
    """Raise unless x is a contiguous bfloat16 CUDA/CPU tensor of `dims`
    dimensions; returns its device."""
    if (x.dtype != torch.bfloat16 or x.dim() != dims
            or not x.is_contiguous()):
        raise ValueError(f'{name}: expected a contiguous bfloat16 '
                         f'{shape_text} tensor, got {x.dtype} '
                         f'{tuple(x.shape)} with strides {x.stride()}')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {x.device}')
    return x.device


def _check_geometry(sh, sw):
    gh, gw = out_geometry(sh, sw)
    if gh < 1 or gw < 1:
        raise ValueError(f'{sh}x{sw} is below the 12x12 P-Net window')
    return gh, gw


def pnet_forward_flat(pnet, planes, sh, sw, true_sw):
    """P-Net on one pyramid level given as channel planes (B4).

    :param pnet: a `networks.PNet` (its weights, rounded to bf16)
    :param planes: [B, 3, sh * sw] normalized bfloat16 planes, contiguous;
        `sw` is the row pitch, of which the first `true_sw` columns are the
        image. What lies in the columns past `true_sw` reaches no output:
        the kernel never reads them
    :returns: (probs [B, gh, gw] float32, reg [B, gh, gw, 4] float32) of
        the (sh, true_sw) level, the contract of `PNet`

    CUDA tensors go to the kernel (counted in
    ``pnet_forward_flat.launches``), CPU tensors to `level_plain`.
    """
    sh, sw, true_sw = int(sh), int(sw), int(true_sw)
    device = _check_level(planes, 'planes', f'[B, 3, {sh * sw}]', 3)
    b = planes.shape[0]
    if tuple(planes.shape[1:]) != (3, sh * sw) or not 0 < true_sw <= sw:
        raise ValueError(f'planes {tuple(planes.shape)} do not hold a '
                         f'{sh}x{true_sw} level at pitch {sw}')
    gh, gw = _check_geometry(sh, true_sw)
    weights = packed_weights(pnet, device)
    if device.type == 'cpu':
        return level_plain(weights,
                           planes.view(b, 3, sh, sw)[..., :true_sw].contiguous())
    probs = torch.empty(b, gh, gw, dtype=torch.float32, device=device)
    reg = torch.empty(b, gh, gw, 4, dtype=torch.float32, device=device)
    lib = LEVEL_KERNEL.load()
    with torch.cuda.device(device):
        err = lib.pnet_flat_launch(
            planes.data_ptr(), b, sh, sw, true_sw, weights.data_ptr(),
            N_WEIGHTS, probs.data_ptr(), reg.data_ptr(),
            _launch_stream(device))
    check(err, 'pnet_flat')
    pnet_forward_flat.launches += 1
    return probs, reg


pnet_forward_flat.launches = 0


def pnet_forward_level(weights, x_nchw):
    """P-Net on one pyramid level from NCHW input with float32 weights (B6).

    The JAX package calls this entry point ``pnet_forward_pallas``, after
    the language its TPU kernel is written in; that name says nothing here.

    :param weights: `pack_level_weights(pnet)` on x's device: the weights
        as they are, not rounded to bf16
    :param x_nchw: [B, 3, sh, sw] normalized image, any float dtype; it is
        rounded to bfloat16, as the TPU kernel's wrapper does
    :returns: (probs [B, gh, gw] float32, reg [B, gh, gw, 4] float32); the
        class softmax runs in the kernel

    CUDA tensors go to the kernel (counted in
    ``pnet_forward_level.launches``), CPU tensors to `level_plain`.
    """
    if x_nchw.dim() != 4 or x_nchw.shape[1] != 3 \
            or not x_nchw.is_floating_point():
        raise ValueError(f'expected a float [B, 3, sh, sw] tensor, got '
                         f'{x_nchw.dtype} {tuple(x_nchw.shape)}')
    x = x_nchw.to(torch.bfloat16).contiguous()
    device = _check_level(x, 'x_nchw', '[B, 3, sh, sw]', 4)
    if (weights.device != device or weights.dtype != torch.float32
            or tuple(weights.shape) != (N_WEIGHTS,)
            or not weights.is_contiguous()):
        raise ValueError(f'weights: expected pack_level_weights() on '
                         f'{device}, got {weights.dtype} '
                         f'{tuple(weights.shape)} on {weights.device}')
    b, _, sh, sw = x.shape
    gh, gw = _check_geometry(sh, sw)
    if device.type == 'cpu':
        return level_plain(weights, x)
    probs = torch.empty(b, gh, gw, dtype=torch.float32, device=device)
    reg = torch.empty(b, gh, gw, 4, dtype=torch.float32, device=device)
    lib = LEVEL_KERNEL.load()
    with torch.cuda.device(device):
        err = lib.pnet_level_launch(
            x.data_ptr(), b, sh, sw, weights.data_ptr(), N_WEIGHTS,
            probs.data_ptr(), reg.data_ptr(), _launch_stream(device))
    check(err, 'pnet_level')
    pnet_forward_level.launches += 1
    return probs, reg


pnet_forward_level.launches = 0


def pnet_forward_pyramid(pnet, levels):
    """P-Net over every pyramid level in one launch.

    :param pnet: a `networks.PNet` (its weights; the kernel's arithmetic is
        bf16 in, float32 sums, bf16 activations)
    :param levels: per-level normalized bfloat16 images [B, 3, sh, sw],
        contiguous, one device, one batch size
    :returns: per level (probs [B, gh, gw] float32, reg [B, gh, gw, 4]
        float32), the contract of `PNet`

    CUDA tensors go to the kernel (counted in
    ``pnet_forward_pyramid.launches``), CPU tensors to
    `pnet_forward_pyramid_plain`.
    """
    levels = list(levels)
    if not levels:
        return []
    device = levels[0].device
    if device.type == 'cpu':
        return pnet_forward_pyramid_plain(pnet, levels)
    if device.type != 'cuda':
        raise ValueError(f'unsupported device {device}')
    if len(levels) > MAX_LEVELS:
        raise ValueError(f'at most {MAX_LEVELS} pyramid levels, '
                         f'got {len(levels)}')
    b = levels[0].shape[0]
    geoms = []
    for i, level in enumerate(levels):
        if (level.device != device or level.dtype != torch.bfloat16
                or level.dim() != 4 or level.shape[0] != b
                or level.shape[1] != 3 or not level.is_contiguous()):
            raise ValueError(
                f'level {i}: expected a contiguous bfloat16 [{b}, 3, sh, sw] '
                f'tensor on {device}, got {level.dtype} {tuple(level.shape)} '
                f'on {level.device}')
        sh, sw = level.shape[2:]
        gh, gw = out_geometry(sh, sw)
        if gh < 1 or gw < 1:
            raise ValueError(f'level {i}: {sh}x{sw} is below the 12x12 '
                             'P-Net window')
        geoms.append((sh, sw, gh, gw))

    cells = [gh * gw for _, _, gh, gw in geoms]
    probs = torch.empty(b * sum(cells), dtype=torch.float32, device=device)
    reg = torch.empty(b * sum(cells) * 4, dtype=torch.float32, device=device)
    outputs, table, start = [], [], 0
    for level, (sh, sw, gh, gw), n in zip(levels, geoms, cells):
        p = probs[b * start:b * (start + n)].view(b, gh, gw)
        r = reg[4 * b * start:4 * b * (start + n)].view(b, gh, gw, 4)
        outputs.append((p, r))
        table += [level.data_ptr(), p.data_ptr(), r.data_ptr(), sh, sw, gh, gw]
        start += n
    weights = packed_weights(pnet, device)

    lib = KERNEL.load()
    rows = (ctypes.c_longlong * len(table))(*table)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pnet_pyramid_launch(rows, len(levels), b,
                                      weights.data_ptr(), N_WEIGHTS, stream)
    check(err, 'pnet_pyramid')
    pnet_forward_pyramid.launches += 1
    return outputs


pnet_forward_pyramid.launches = 0
