"""Fixed-capacity non-maximum suppression and box utilities.

MTCNN's post-processing (score threshold -> NMS -> bbox regression) keeps
fixed shapes here: boxes live in [K, 4] buffers with a validity mask,
selection (threshold, top-k) produces masks, never ragged tensors, and no
step goes back to the host.

The greedy NMS (`nms_mask`, `greedy_keep`) is the hand-written kernel
``csrc/nms_greedy.cu`` on a CUDA tensor (two launches: a bitmask of the
overlapping pairs, then a scan a frame) and the K-step loop of tensor
operations `greedy_keep_plain` on a CPU tensor; the two keep the same
boxes.

Boxes are (x1, y1, x2, y2) in pixel coordinates, widths w = x2 - x1 +
`offset` (0, or 1 for the +1 pixel areas of py-faster-rcnn's
``py_cpu_nms``, which RetinaFace's post-processing uses).
Functions take a leading batch dimension where their name says so
(`batched_nms_mask`) or where the docstring shows one.
"""

from __future__ import annotations

import ctypes

import torch

from facenet_tpu_torch.ops.cuda_build import CudaKernel, check

_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel('nms_greedy.cu', {
    'nms_greedy_launch': [_ptr, _ptr, _i32, _i32, _f32, _f32, _i32, _i32,
                          _ptr, _ptr, _ptr, _ptr]})
MODES = ('union', 'min')


def box_area(boxes, offset=0.0):
    """[..., 4] -> [...] areas (x2 - x1 + offset) * (y2 - y1 + offset),
    each side clamped at 0."""
    return (_side(boxes[..., 2] - boxes[..., 0], offset)
            * _side(boxes[..., 3] - boxes[..., 1], offset))


def _side(extent, offset):
    return torch.clamp(extent + offset if offset else extent, min=0.0)


def iou_matrix(boxes, mode='union', offset=0.0):
    """Pairwise IoU of a [..., K, 4] box set -> [..., K, K].

    mode 'union': standard IoU; mode 'min': intersection over the smaller
    area (MTCNN uses 'min' for the final O-Net suppression). `offset` is
    added to every side, intersections' included (1 for py_cpu_nms's
    pixel-inclusive boxes).
    """
    a, b = boxes[..., :, None, :], boxes[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])

    inter = _side(x2 - x1, offset) * _side(y2 - y1, offset)
    areas = box_area(boxes, offset)
    if mode == 'min':
        denom = torch.minimum(areas[..., :, None], areas[..., None, :])
    else:
        denom = areas[..., :, None] + areas[..., None, :] - inter
    return inter / torch.clamp(denom, min=1e-10)


def greedy_keep_plain(boxes, valid, iou_threshold, mode='union', offset=0.0,
                      max_keep=None):
    """Greedy NMS over [B, K] candidates already in descending score order,
    as a K-step loop of tensor operations.

    A candidate is kept iff it is valid and no kept candidate before it
    overlaps it by more than `iou_threshold`.

    :returns: (keep [B, K] bool: the first `max_keep` kept candidates (all
        of them when None), kept [B] int32: every kept candidate)
    """
    k = boxes.shape[-2]
    overlaps = iou_matrix(boxes, mode=mode, offset=offset) > iou_threshold
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    overlaps = overlaps & later

    keep = torch.zeros_like(valid)
    suppressed = torch.zeros_like(valid)
    for i in range(k):
        kept = valid[..., i] & ~suppressed[..., i]
        keep[..., i] = kept
        suppressed = suppressed | (kept[..., None] & overlaps[..., i, :])
    count = keep.sum(-1, dtype=torch.int32)
    if max_keep is not None:
        keep = keep & (torch.cumsum(keep, -1) <= int(max_keep))
    return keep, count


def greedy_keep(boxes, valid, iou_threshold, mode='union', offset=0.0,
                max_keep=None):
    """`greedy_keep_plain`'s result: the kernel ``csrc/nms_greedy.cu`` on
    a CUDA tensor (counted in ``greedy_keep.launches``, one a call), the
    loop on a CPU tensor.

    :param boxes: [B, K, 4] float32 candidates in descending score order
        (ties in index order)
    :param valid: [B, K] bool
    :param mode: 'union' | 'min'
    :param offset: added to every side (0, or 1 for py_cpu_nms)
    :param max_keep: the capacity: only the first `max_keep` kept
        candidates are marked; `kept` still counts every one
    """
    if mode not in MODES:
        raise ValueError(f'mode must be one of {MODES}, got {mode!r}')
    if boxes.device.type == 'cpu':
        return greedy_keep_plain(boxes, valid, iou_threshold, mode, offset,
                                 max_keep)
    if boxes.device.type != 'cuda':
        raise ValueError(f'unsupported device {boxes.device}')
    if (boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape
            != boxes.shape[:2] or valid.device != boxes.device):
        raise ValueError(f'boxes must be [B, K, 4] and valid [B, K] on one '
                         f'device, got {tuple(boxes.shape)} and '
                         f'{tuple(valid.shape)}')
    b, k = valid.shape
    keep = torch.zeros((b, k), dtype=torch.bool, device=boxes.device)
    kept = torch.zeros(b, dtype=torch.int32, device=boxes.device)
    if b * k == 0:
        return keep, kept
    boxes = boxes.float().contiguous()
    if boxes.data_ptr() % 16:                 # read as float4
        boxes = boxes.clone()
    valid = valid.to(torch.bool).contiguous()
    words = -(-k // 64)
    mask = torch.empty((b, k, words), dtype=torch.int64, device=boxes.device)
    cap = k if max_keep is None else max(int(max_keep), 0)
    lib = KERNEL.load()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nms_greedy_launch(
            boxes.data_ptr(), valid.data_ptr(), b, k, float(iou_threshold),
            float(offset), int(mode == 'min'), min(cap, k), mask.data_ptr(),
            keep.data_ptr(), kept.data_ptr(), stream)
    check(err, 'nms_greedy')
    greedy_keep.launches += 1
    return keep, kept


greedy_keep.launches = 0


def nms_mask(boxes, scores, valid, iou_threshold, mode='union'):
    """Greedy NMS over [B, K] fixed-capacity box sets -> keep mask [B, K].

    The classic algorithm: visit boxes in descending score order (a stable
    sort, so ties go to the lower index); keep a box iff it is valid and no
    kept box before it overlaps it by more than `iou_threshold`. The kernel
    on a CUDA tensor, the loop on a CPU tensor (`greedy_keep`).
    """
    order = torch.argsort(-torch.where(valid, scores, float('-inf')),
                          dim=-1, stable=True)
    sorted_boxes = torch.gather(boxes, -2, order[..., None].expand_as(boxes))
    sorted_valid = torch.gather(valid, -1, order)
    keep, _ = greedy_keep(sorted_boxes, sorted_valid, iou_threshold, mode)
    return torch.zeros_like(keep).scatter(-1, order, keep)   # original order


def nms_mask_fast(boxes, scores, valid, iou_threshold, mode='union'):
    """One-shot matrix NMS over [B, K] box sets -> keep mask [B, K].

    A box is dropped when ANY higher-scored valid box overlaps it (Fast
    NMS, Bolya et al. 2019): the suppressor may itself be suppressed, so
    this drops a superset of greedy's victims. Used for candidate pruning
    between cascade stages, where the next net re-scores the survivors.
    Ties go to the lower index.
    """
    k = boxes.shape[-2]
    iou = iou_matrix(boxes, mode=mode)
    s = torch.where(valid, scores, float('-inf'))
    idx = torch.arange(k, device=boxes.device)
    # j suppresses i iff score_j > score_i (ties: lower index wins)
    higher = (s[..., :, None] > s[..., None, :]) | (
        (s[..., :, None] == s[..., None, :]) & (idx[:, None] < idx[None, :]))
    suppressed = torch.any(higher & (iou > iou_threshold) & valid[..., :, None],
                           dim=-2)
    return valid & ~suppressed


def batched_nms_mask(boxes, scores, valid, iou_threshold, mode='union',
                     algorithm='greedy'):
    """NMS keep masks [B, K] of [B, K, 4] boxes, greedy or 'fast'."""
    fn = nms_mask_fast if algorithm == 'fast' else nms_mask
    return fn(boxes, scores, valid, iou_threshold, mode=mode)


def top_k_boxes(boxes, scores, valid, k):
    """Select the top-k valid boxes by score into fixed [B, k] buffers.

    :param boxes: [B, N, 4]; scores, valid: [B, N]
    :returns: (boxes [B, k, 4], scores [B, k], valid [B, k]); slots beyond
        N, and slots holding invalid entries, are invalid with score 0.

    A stable descending sort, so tied scores keep index order, as
    ``jax.lax.top_k`` does (and ``approx_max_k``, which is exact off the
    TPU).
    """
    b, n = scores.shape
    kk = min(int(k), n)
    masked = torch.where(valid, scores, float('-inf'))
    top_scores, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :kk], idx[:, :kk]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(b, kk, 4))
    top_valid = torch.isfinite(top_scores)
    top_scores = torch.where(top_valid, top_scores, 0.0)
    if kk < k:
        pad = int(k) - kk
        top_boxes = torch.cat([top_boxes, top_boxes.new_zeros(b, pad, 4)], 1)
        top_scores = torch.cat([top_scores, top_scores.new_zeros(b, pad)], 1)
        top_valid = torch.cat([top_valid, top_valid.new_zeros(b, pad)], 1)
    return top_boxes, top_scores, top_valid


def square_boxes(boxes):
    """Expand boxes to squares around their centers (MTCNN 'rerec')."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    side = torch.maximum(w, h)
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    return torch.stack([cx - side / 2, cy - side / 2,
                        cx + side / 2, cy + side / 2], dim=-1)


def apply_bbox_regression(boxes, reg):
    """Apply MTCNN bbox regression offsets (dx1, dy1, dx2, dy2) scaled by w/h."""
    w = (boxes[..., 2] - boxes[..., 0])[..., None]
    h = (boxes[..., 3] - boxes[..., 1])[..., None]
    return boxes + reg * torch.cat([w, h, w, h], dim=-1)
