"""The int8 convolution of quantized serving (PyTorch).

Counterpart of the int8 branch of ``facenet_tpu.models.irv1_fast._conv``:
the input is quantized with one scale a tensor, the int8 x int8 products
are summed in int32, and the sums are scaled back per output channel, in
this order of operations:

    xq  = clip(round(x.float() / xs), -127, 127)         int8
    y   = conv(xq, kq)                                   int32
    out = (y.float() * (ws * xs) + b).to(x.dtype)

``torch.round`` rounds half to even, as ``jnp.round`` does. In the JAX
package the convolution is an XLA conv, not a Pallas kernel, so here it maps
onto the library: the quantized input's NHWC view is unfolded into patch
rows (``F.pad`` + ``Tensor.unfold``; a 1x1 conv at stride 1 needs none) and
multiplied with ``torch._int_mm`` (cuBLASLt, int8 in, int32 out). The
weights are stored once, at quantization time, in the layout that GEMM
takes (`quantized_entry`).

int8 and not FP8 e4m3: int8 sums reproduce the JAX package's integer sums
exactly; FP8 would be a different quantizer, which the JAX package lacks.

The plain version (`int8_sums_plain`) takes the same sums with ``F.conv2d``
in float64 on the int8 values: every partial sum is an integer below 2^53
at any width of either network, so it is exact. CPU tensors take it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

ALIGN = 8       # cuBLASLt's int8 GEMM takes K and N in multiples of 8
MIN_ROWS = 17   # ... and more than 16 rows


def _round_up(n, multiple):
    return -(-n // multiple) * multiple


def quantized_entry(kq, ws, xs, b, device):
    """An int8 conv entry of the port's serving tree.

    :param kq: int8 OIHW kernel (numpy)
    :param ws: float32 [oc] weight scales; `xs`: the float32 input scale;
        `b`: float32 [oc] bias
    :returns: ``{'kq': int8 [N, K], 'ws', 'xs', 'b', 'wxs': ws * xs,
        'shape': (oc, ic, kh, kw)}`` on `device`. ``kq`` holds one row an
        output channel and one column a (kh, kw, ic) tap, zero-padded to
        multiples of `ALIGN`; the GEMM takes its transposed view. Channels
        last in a tap make each im2col row a copy of kh * kw runs of ic
        contiguous bytes of the NHWC input.
    """
    kq = np.asarray(kq, np.int8)
    oc, ic, kh, kw = kq.shape
    k = ic * kh * kw
    matrix = np.zeros((_round_up(oc, ALIGN), _round_up(k, ALIGN)), np.int8)
    matrix[:oc, :k] = kq.transpose(0, 2, 3, 1).reshape(oc, k)
    ws = torch.from_numpy(np.asarray(ws, np.float32).copy()).to(device)
    xs = torch.tensor(np.float32(xs), device=device)
    return {'kq': torch.from_numpy(matrix).to(device),
            'ws': ws,
            'xs': xs,
            'b': torch.from_numpy(np.asarray(b, np.float32).copy()).to(device),
            'wxs': ws * xs,
            'shape': (oc, ic, kh, kw)}


def kernel_oihw(w):
    """The entry's int8 kernel as OIHW (a view of its GEMM matrix)."""
    oc, ic, kh, kw = w['shape']
    return w['kq'][:oc, :ic * kh * kw].reshape(oc, kh, kw, ic).permute(
        0, 3, 1, 2)


def quantize(x, xs):
    """NCHW activations (channels_last memory) -> int8 NHWC."""
    # a one-element scale takes part in type promotion, so this divides
    # x.float() by xs in float32, in one pass and without touching x
    v = torch.div(x.permute(0, 2, 3, 1), xs.view(1))
    return v.round_().clamp_(-127, 127).to(torch.int8)


def _check(shape, stride, padding):
    if padding not in ('SAME', 'VALID'):
        raise ValueError(f'unknown padding {padding!r}')
    if padding == 'SAME' and stride != 1:
        raise ValueError('SAME padding is supported at stride 1 only')


def patch_rows(xq, shape, stride=1, padding='SAME'):
    """int8 NHWC [B, H, W, C] -> (rows [B*OH*OW, kh*kw*C], (B, OH, OW)):
    the im2col of the GEMM, columns in the order (kh, kw, c) of
    `quantized_entry`'s matrix."""
    _, _, kh, kw = shape
    _check(shape, stride, padding)
    if padding == 'SAME' and (kh > 1 or kw > 1):
        ph, pw = kh - 1, kw - 1
        xq = F.pad(xq, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    b, h, w, c = xq.shape
    if kh == kw == 1 and stride == 1:
        return xq.reshape(b * h * w, c), (b, h, w)
    # the copy moves one element a thread: move up to 8 channels as one
    xq = xq.contiguous()
    for wide in (torch.int64, torch.int32, torch.int16):
        if c % wide.itemsize == 0:
            xq = xq.view(wide)
            break
    # [B, OH, OW, C', kh, kw] -> [B, OH, OW, kh, kw, C']
    patches = xq.unfold(1, kh, stride).unfold(2, kw, stride)
    oh, ow = patches.shape[1], patches.shape[2]
    patches = patches.permute(0, 1, 2, 4, 5, 3).reshape(b * oh * ow, -1)
    return patches.view(torch.int8), (b, oh, ow)


def int8_sums(xq, w, stride=1, padding='SAME'):
    """int32 sums [B, OH, OW, oc] of int8 NHWC `xq` with the entry's kernel,
    through ``torch._int_mm`` (on the CPU too, where torch has it). Rows
    and columns are zero-padded to what cuBLASLt takes; zeros change no
    sum. Inside `torch.export`, where the batch is symbolic, a conv whose
    output has fewer than `MIN_ROWS` pixels an image always gets
    `MIN_ROWS` more rows."""
    rows, (b, oh, ow) = patch_rows(xq, w['shape'], stride, padding)
    m, k = rows.shape
    kp = w['kq'].shape[1]
    if torch.compiler.is_exporting():
        # the batch, and so m, is symbolic in an exported program: the
        # rows get MIN_ROWS more wherever one image has fewer than that
        extra = MIN_ROWS if oh * ow < MIN_ROWS else 0
    else:
        extra = max(MIN_ROWS - m, 0)
    if k != kp or extra:
        rows = F.pad(rows, (0, kp - k, 0, extra))
    y = torch._int_mm(rows, w['kq'].t())
    oc = w['shape'][0]
    if extra or y.shape[1] != oc:     # no slice (a graph node) otherwise
        y = y[:m, :oc]
    return y.view(b, oh, ow, oc)


def int8_sums_plain(xq, w, stride=1, padding='SAME'):
    """`int8_sums` by ``F.conv2d`` in float64 on the int8 values."""
    _check(w['shape'], stride, padding)
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), kernel_oihw(w).double(),
                 None, stride, 'same' if padding == 'SAME' else 0)
    return y.to(torch.int32).permute(0, 2, 3, 1)


def int8_conv(x, w, stride=1, padding='SAME'):
    """The quantized conv: NCHW `x` (channels_last memory) -> NCHW output of
    x's dtype, a channels_last view of the NHWC result. A CUDA tensor goes
    through the GEMM, a CPU tensor through the plain version."""
    xq = quantize(x, w['xs'])
    sums = (int8_sums if x.is_cuda else int8_sums_plain)(xq, w, stride,
                                                          padding)
    # int32 * float32 casts the sums to float32 first, as y.float() does
    y = torch.mul(sums, w['wxs']).add_(w['b'])
    return y.to(x.dtype).permute(0, 3, 1, 2)
