"""Fixed-capacity non-maximum suppression and box utilities.

MTCNN's post-processing (score threshold -> NMS -> bbox regression) keeps
fixed shapes here: boxes live in [K, 4] buffers with a validity mask,
selection (threshold, top-k) produces masks, never ragged tensors, and the
greedy NMS is a K-step loop of tensor operations on the device with no
host round trip.

Boxes are (x1, y1, x2, y2) in pixel coordinates, widths w = x2 - x1.
Functions take a leading batch dimension where their name says so
(`batched_nms_mask`) or where the docstring shows one.
"""

from __future__ import annotations

import torch


def box_area(boxes):
    """[..., 4] -> [...] areas; clamped at 0."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def iou_matrix(boxes, mode='union'):
    """Pairwise IoU of a [..., K, 4] box set -> [..., K, K].

    mode 'union': standard IoU; mode 'min': intersection over the smaller
    area (MTCNN uses 'min' for the final O-Net suppression).
    """
    a, b = boxes[..., :, None, :], boxes[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])

    inter = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    areas = box_area(boxes)
    if mode == 'min':
        denom = torch.minimum(areas[..., :, None], areas[..., None, :])
    else:
        denom = areas[..., :, None] + areas[..., None, :] - inter
    return inter / torch.clamp(denom, min=1e-10)


def nms_mask(boxes, scores, valid, iou_threshold, mode='union'):
    """Greedy NMS over [B, K] fixed-capacity box sets -> keep mask [B, K].

    The classic algorithm: visit boxes in descending score order (a stable
    sort, so ties go to the lower index); keep a box iff it is valid and no
    kept box before it overlaps it by more than `iou_threshold`.
    """
    k = boxes.shape[-2]
    order = torch.argsort(-torch.where(valid, scores, float('-inf')),
                          dim=-1, stable=True)
    sorted_boxes = torch.gather(boxes, -2, order[..., None].expand_as(boxes))
    sorted_valid = torch.gather(valid, -1, order)
    iou = iou_matrix(sorted_boxes, mode=mode)
    overlaps = iou > iou_threshold                          # [B, K, K]
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    overlaps = overlaps & later

    keep = torch.zeros_like(sorted_valid)
    suppressed = torch.zeros_like(sorted_valid)
    for i in range(k):
        kept = sorted_valid[..., i] & ~suppressed[..., i]
        keep[..., i] = kept
        suppressed = suppressed | (kept[..., None] & overlaps[..., i, :])
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
