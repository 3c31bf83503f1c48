"""Whole-pyramid P-Net: the B3 kernel, its wrapper and its plain version.

`pnet_forward_pyramid` is the wrapper of the CUDA kernel
``csrc/pnet_pyramid.cu``, which replaces the Pallas TPU kernel
``facenet_tpu/detectors/mtcnn/pallas_pnet.py::_make_v4_kernel``: the
P-Net over every level of an image pyramid in one launch. On CUDA tensors
it launches the kernel, or raises; on CPU tensors it runs
`pnet_forward_pyramid_plain`, which repeats the kernel's arithmetic level
by level with the `PNet` module's weights.

The kernel takes its weights packed into one float32 vector (`pack_weights`,
cached on the module per device): conv kernels as [ci][ky][kx][co] rounded
to bf16, biases and PReLU slopes in float32, each block 16-float aligned for
the kernel's vector loads. The offsets mirror the constants of the source.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from facenet_tpu_torch.detectors.mtcnn.networks import max_pool_same
from facenet_tpu_torch.ops.cuda_build import CudaKernel, check

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel('pnet_pyramid.cu', {
    'pnet_pyramid_launch': [_ptr, _i32, _i32, _ptr, _i32, _ptr]})

MAX_LEVELS = 24
# (name, offset) of each packed block; N_WEIGHTS is the total
OFFSETS = {'w1': 0, 'b1': 272, 'a1': 284, 'w2': 296, 'b2': 1736, 'a2': 1752,
           'w3': 1768, 'b3': 6376, 'a3': 6408, 'wh': 6440, 'bh': 6632}
N_WEIGHTS = 6640


def out_geometry(sh, sw):
    """P-Net head grid (gh, gw) of an (sh, sw) level."""
    return -(-(sh - 2) // 2) - 4, -(-(sw - 2) // 2) - 4


def pack_weights(pnet):
    """The kernel's float32 weight vector [N_WEIGHTS] (on the CPU)."""
    def conv(layer):                   # OIHW -> [ci][ky][kx][co], bf16 values
        w = layer.weight.detach().float().permute(1, 2, 3, 0)
        return w.to(torch.bfloat16).float().reshape(-1)

    head_w = torch.cat([pnet.cls.weight, pnet.reg.weight]).detach().float()
    blocks = {
        'w1': conv(pnet.conv1), 'b1': pnet.conv1.bias,
        'a1': pnet.prelu1.alpha,
        'w2': conv(pnet.conv2), 'b2': pnet.conv2.bias,
        'a2': pnet.prelu2.alpha,
        'w3': conv(pnet.conv3), 'b3': pnet.conv3.bias,
        'a3': pnet.prelu3.alpha,
        'wh': head_w[:, :, 0, 0].t().to(torch.bfloat16).float().reshape(-1),
        'bh': torch.cat([pnet.cls.bias, pnet.reg.bias]),
    }
    packed = torch.zeros(N_WEIGHTS, dtype=torch.float32)
    for name, value in blocks.items():
        value = value.detach().float().reshape(-1)
        start = OFFSETS[name]
        packed[start:start + value.numel()] = value
    return packed


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


def _pnet_level_plain(pnet, x):
    """One level in the kernel's arithmetic: bf16 inputs and weights,
    float32 sums, bias and PReLU, activations rounded to bf16 after each
    PReLU, float32 heads and softmax."""
    def conv_prelu(conv, prelu, x):
        z = F.conv2d(x, _bf16(conv.weight.float()), conv.bias.float())
        alpha = prelu.alpha.float()[None, :, None, None]
        return _bf16(torch.where(z >= 0, z, alpha * z))

    x = conv_prelu(pnet.conv1, pnet.prelu1, _bf16(x.float()))
    x = max_pool_same(x, 2, 2)
    x = conv_prelu(pnet.conv2, pnet.prelu2, x)
    x = conv_prelu(pnet.conv3, pnet.prelu3, x)
    w = _bf16(torch.cat([pnet.cls.weight, pnet.reg.weight]).float())
    z = F.conv2d(x, w, torch.cat([pnet.cls.bias, pnet.reg.bias]).float())
    probs = torch.softmax(z[:, 0:2], dim=1)[:, 1]
    return probs, z[:, 2:6].permute(0, 2, 3, 1).contiguous()


def pnet_forward_pyramid_plain(pnet, levels):
    """Plain PyTorch version of `pnet_forward_pyramid`, level by level in
    the kernel's arithmetic (float32 convolutions, TF32 off): [(probs
    [B, gh, gw], reg [B, gh, gw, 4])], float32."""
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            return [_pnet_level_plain(pnet, level) for level in levels]
    finally:
        torch.backends.cudnn.allow_tf32 = allow


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
