"""Weighted below-threshold pair counts: the validation hot loop.

For L2-normalized embeddings [N, D] and labels [N], every unordered pair
i < j has the similarity s = clip(<e_i, e_j>, -1, 1) in float32 and the
weight 1/pos_pairs(class) when both share a label, 1/(n_i n_j) otherwise.
Threshold t_k on the distance (metric 0: 2(1 - s), metric 1: arccos s)
becomes a similarity cutoff c_k (1 - t/2, or cos t, in float32), and the
pair counts as "below t_k" iff s > c_k. The result is the cumulative weight
below each threshold, for positive and negative pairs, plus the totals.

`pair_histogram` is the wrapper of the CUDA kernel
``csrc/pair_below_counts.cu`` (it replaces the Pallas TPU kernel
``facenet_tpu/ops/pallas_stats.py::_kernel``). On a CUDA tensor it launches
the kernel, or raises; on a CPU tensor it runs `pair_histogram_plain`, the
plain PyTorch version of the same function. The kernel is compiled with
``nvcc`` for sm_90a at first use, into ``facenet_tpu_torch/_build/``.

The kernel takes the product on the tensor cores as three TF32 products of
float32 values split in two (`split_tf32`, `product_3xtf32` restate that
arithmetic in plain PyTorch); `pair_similarities` is the wrapper of its
second entry point, which writes the clipped similarities themselves so
that a test can hold the arithmetic against a float64 product.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from facenet_tpu_torch.ops.cuda_build import CudaKernel, check

MAX_THRESHOLDS = 127

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel('pair_below_counts.cu', {
    'pair_below_counts_launch': [_ptr, _ptr, _ptr, _ptr, _ptr,
                                 _i32, _i32, _i32, _ptr, _ptr],
    'pair_similarities_launch': [_ptr, _i32, _i32, _ptr, _ptr]})


class PairInputs(NamedTuple):
    """Kernel-ready inputs, all on one device."""
    embeddings: torch.Tensor   # [N, D] float32, contiguous
    labels: torch.Tensor       # [N] int32 dense class ids
    w_pos: torch.Tensor        # [N] float64, 1/pos_pairs(label)
    inv_n: torch.Tensor        # [N] float64, 1/count(label)
    cutoffs: torch.Tensor      # [T] float32, non-increasing


def cutoffs_for(thresholds, metric):
    """Similarity cutoffs (float32) of ascending distance thresholds."""
    thresholds = np.asarray(thresholds, dtype=np.float32).reshape(-1)
    if thresholds.size > MAX_THRESHOLDS:
        raise ValueError(f'at most {MAX_THRESHOLDS} thresholds, '
                         f'got {thresholds.size}')
    if metric == 0:
        cut = 1.0 - thresholds / np.float32(2.0)   # d0 = 2(1-s) < t
    elif metric == 1:
        cut = np.cos(thresholds)                     # d1 = arccos(s) < t
    else:
        raise ValueError(f'Undefined similarity metric {metric}')
    cut = cut.astype(np.float32)
    if np.any(np.diff(cut) > 0):
        raise ValueError('thresholds must be sorted ascending (and lie in '
                         '[0, pi] for metric 1)')
    return cut


def prepare(embeddings, labels, thresholds, metric=0, num_classes=None):
    """Move the inputs to the embeddings' device in kernel-ready form.

    :param embeddings: [N, D] float32 tensor (its device is used)
    :param labels: [N] dense int class ids (tensor or array)
    :param thresholds: [T] distance thresholds, ascending, T <= 127
    """
    device = embeddings.device
    emb = embeddings.to(torch.float32).contiguous()
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.asarray(labels, dtype=np.int64))
    labels = labels.to(device=device, dtype=torch.int64)
    if num_classes is None:
        num_classes = int(labels.max()) + 1 if labels.numel() else 0

    counts = torch.bincount(labels, minlength=num_classes).to(torch.float64)
    inv_n = torch.where(counts > 0, 1.0 / counts, 0.0)
    pos_pairs = counts * (counts - 1) / 2
    inv_pos = torch.where(pos_pairs > 0, 1.0 / pos_pairs, 0.0)
    cut = torch.from_numpy(cutoffs_for(thresholds, metric)).to(device)
    return PairInputs(emb, labels.to(torch.int32).contiguous(),
                      inv_pos[labels].contiguous(), inv_n[labels].contiguous(),
                      cut)


def pair_histogram(inputs: PairInputs) -> torch.Tensor:
    """Weights of pairs by (side, bin): float64 [2, T + 1] on the inputs'
    device. Bin b holds pairs with exactly b cutoffs >= s; side 0 is
    positive pairs, 1 negative.

    CUDA tensors go to the kernel (counted in ``pair_histogram.launches``);
    CPU tensors to `pair_histogram_plain`.
    """
    emb = inputs.embeddings
    if emb.device.type == 'cpu':
        return pair_histogram_plain(inputs)
    if emb.device.type != 'cuda':
        raise ValueError(f'unsupported device {emb.device}')

    if emb.dtype != torch.float32 or not emb.is_contiguous() or emb.ndim != 2:
        raise ValueError('embeddings must be a contiguous float32 [N, D] tensor')
    n, d = emb.shape
    t = inputs.cutoffs.numel()
    lib = KERNEL.load()
    for name, tensor, dtype in (('labels', inputs.labels, torch.int32),
                                ('w_pos', inputs.w_pos, torch.float64),
                                ('inv_n', inputs.inv_n, torch.float64),
                                ('cutoffs', inputs.cutoffs, torch.float32)):
        size = t if name == 'cutoffs' else n
        if (tensor.device != emb.device or tensor.dtype != dtype
                or not tensor.is_contiguous() or tensor.shape != (size,)):
            raise ValueError(f'{name} must be a contiguous {dtype} [{size}] '
                             f'tensor on {emb.device}')

    hist = torch.zeros((2, t + 1), dtype=torch.float64, device=emb.device)
    if n == 0:                      # no pairs, and an empty grid cannot launch
        return hist
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pair_below_counts_launch(
            emb.data_ptr(), inputs.labels.data_ptr(), inputs.w_pos.data_ptr(),
            inputs.inv_n.data_ptr(), inputs.cutoffs.data_ptr(), n, d, t,
            hist.data_ptr(), stream)
    check(err, 'pair_below_counts')
    pair_histogram.launches += 1
    return hist


pair_histogram.launches = 0


def pair_histogram_plain(inputs: PairInputs, chunk=1024) -> torch.Tensor:
    """Plain PyTorch version of `pair_histogram` (any device): row chunks
    of a full-float32 product, searchsorted binning, float64 bincount."""
    emb, labels, w_pos, inv_n, cut = inputs
    n = emb.shape[0]
    t = cut.numel()
    neg_cut = -cut                  # ascending, for searchsorted
    hist = torch.zeros(2 * (t + 1), dtype=torch.float64, device=emb.device)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            sims = torch.clamp(emb[start:stop] @ emb[start:].T, -1.0, 1.0)
            rows = torch.arange(start, stop, device=emb.device)[:, None]
            cols = torch.arange(start, n, device=emb.device)[None, :]
            valid = rows < cols
            bins = torch.searchsorted(neg_cut, -sims, right=True)
            pos = labels[start:stop, None] == labels[None, start:]
            weight = torch.where(pos, w_pos[start:stop, None],
                                 inv_n[start:stop, None] * inv_n[None, start:])
            index = torch.where(pos, bins, bins + (t + 1))
            hist += torch.bincount(index[valid], weights=weight[valid],
                                   minlength=2 * (t + 1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return hist.view(2, t + 1)


def split_tf32(x):
    """float32 x as (hi, lo), the kernel's split: hi is x rounded to TF32's
    11 significant bits (half a unit of its last place added to the
    magnitude bits, the 13 bits below masked off), lo = x - hi exactly; the
    tensor core then reads lo's leading 11 bits, which the mask repeats."""
    x = x.to(torch.float32).contiguous()
    hi = ((x.view(torch.int32) + 0x1000) & ~0x1fff).view(torch.float32)
    lo = x - hi
    lo = (lo.view(torch.int32) & ~0x1fff).view(torch.float32)
    return hi, lo


def product_3xtf32(emb):
    """[N, N] similarities in the kernel's arithmetic, plain PyTorch: per
    8-deep step lo_a hi_b + hi_a lo_b + hi_a hi_b as three float32 products
    (every term is exact in float32: 11 x 11 bits), small terms first, the
    steps' sums added in float32, then the clip. float32 sums round to
    nearest here; the tensor core may truncate a step's sum."""
    hi, lo = split_tf32(emb)
    n, d = emb.shape
    pad = -d % 8
    hi, lo = (torch.nn.functional.pad(v, (0, pad)) for v in (hi, lo))
    acc = torch.zeros(n, n, dtype=torch.float32, device=emb.device)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for k in range(0, d + pad, 8):
            h, l = hi[:, k:k + 8], lo[:, k:k + 8]
            acc += (l @ h.T + h @ l.T) + h @ h.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return torch.clamp(acc, -1.0, 1.0)


def pair_similarities(embeddings):
    """clip(E E^T, -1, 1) as float32 [N, N] by the counts kernel's own
    product code (its 3xTF32 arithmetic, with nothing binned): what a test
    holds against a float64 product.

    CUDA tensors go to the kernel (counted in
    ``pair_similarities.launches``), CPU tensors to `product_3xtf32`.
    """
    emb = embeddings
    if emb.dtype != torch.float32 or not emb.is_contiguous() or emb.ndim != 2:
        raise ValueError('embeddings must be a contiguous float32 [N, D] tensor')
    if emb.device.type == 'cpu':
        return product_3xtf32(emb)
    if emb.device.type != 'cuda':
        raise ValueError(f'unsupported device {emb.device}')
    n, d = emb.shape
    out = torch.empty((n, n), dtype=torch.float32, device=emb.device)
    if n == 0:
        return out
    lib = KERNEL.load()
    with torch.cuda.device(emb.device):
        err = lib.pair_similarities_launch(
            emb.data_ptr(), n, d, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(err, 'pair_similarities')
    pair_similarities.launches += 1
    return out


pair_similarities.launches = 0


def _below(hist):
    """(below_pos [T], below_neg [T], total_pos, total_neg) on the host.
    The totals are the last cumulative sums, so a threshold above every
    pair leaves exactly zero above it."""
    cum = np.cumsum(hist.cpu().numpy(), axis=1)
    return cum[0, :-1], cum[1, :-1], float(cum[0, -1]), float(cum[1, -1])


def pair_below_counts(embeddings, labels, thresholds, metric=0,
                      num_classes=None):
    """Weighted counts of pairs with distance below each threshold.

    :param embeddings: [N, D] L2-normalized float32 tensor; a CUDA tensor
        runs the kernel, a CPU tensor the plain version
    :param labels: [N] dense class ids
    :param thresholds: [T] sorted ascending, T <= 127
    :param metric: 0 squared-Euclidean 2(1-cos), 1 arccos
    :returns: (below_pos [T], below_neg [T], total_pos, total_neg), float64
    """
    return _below(pair_histogram(prepare(embeddings, labels, thresholds,
                                         metric, num_classes)))


def pair_below_counts_plain(embeddings, labels, thresholds, metric=0,
                            num_classes=None):
    """`pair_below_counts` through the plain version on any device."""
    return _below(pair_histogram_plain(prepare(embeddings, labels, thresholds,
                                               metric, num_classes)))
