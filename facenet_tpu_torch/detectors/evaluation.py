"""Detection quality metrics: recall / precision / IoU over annotated data.

The quality gate of the bundled detector weights: greedy one-to-one
matching of predicted to ground-truth boxes at an IoU threshold. Numpy
only.
"""

from __future__ import annotations

import numpy as np

__all__ = ['iou_matrix', 'match_detections', 'evaluate_detector',
           'compare_outputs']


def iou_matrix(a, b):
    """Pairwise IoU of two box sets [N, 4] x [M, 4] (x1, y1, x2, y2)."""
    a = np.asarray(a, np.float32).reshape(-1, 4)
    b = np.asarray(b, np.float32).reshape(-1, 4)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area_a = np.maximum((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]), 0)
    area_b = np.maximum((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]), 0)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def match_detections(gt_boxes, pred_boxes, iou_threshold=0.5):
    """Greedy one-to-one matching of predictions to ground truth.

    :returns: (n_matched, matched_ious list) — each gt matches at most one
        prediction, highest IoU first.
    """
    if len(gt_boxes) == 0 or len(pred_boxes) == 0:
        return 0, []
    iou = iou_matrix(gt_boxes, pred_boxes)
    matched, ious = 0, []
    used_gt = np.zeros(len(gt_boxes), bool)
    used_pred = np.zeros(len(pred_boxes), bool)
    order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None),
                                       iou.shape))[0]
    for gi, pi in order:
        if used_gt[gi] or used_pred[pi] or iou[gi, pi] < iou_threshold:
            continue
        used_gt[gi] = used_pred[pi] = True
        matched += 1
        ious.append(float(iou[gi, pi]))
    return matched, ious


def compare_outputs(a, b, iou_threshold=0.5):
    """Two detectors' batch outputs ('boxes', 'scores', 'valid') on the
    same images, matched one to one by IoU within each image (slots may
    order differently where scores tie or round otherwise).

    :returns: dict with the valid counts 'n_a' and 'n_b', 'unmatched' (the
        valid boxes of either side left without a partner), 'box_px' (the
        largest coordinate difference of a matched pair) and 'score' (the
        largest score difference of a matched pair)
    """
    out = {'n_a': 0, 'n_b': 0, 'unmatched': 0, 'box_px': 0.0, 'score': 0.0}
    for i in range(len(a['valid'])):
        va, vb = np.flatnonzero(a['valid'][i]), np.flatnonzero(b['valid'][i])
        out['n_a'] += len(va)
        out['n_b'] += len(vb)
        iou = iou_matrix(a['boxes'][i][va], b['boxes'][i][vb])
        used = np.zeros(len(vb), bool)
        matched = 0
        for r in range(len(va)):
            cand = np.where(used, -1.0, iou[r]) if len(vb) else iou[r]
            if not len(vb) or cand.max() < iou_threshold:
                continue
            c = int(cand.argmax())
            used[c] = True
            matched += 1
            out['box_px'] = max(out['box_px'], float(np.abs(
                a['boxes'][i][va[r]] - b['boxes'][i][vb[c]]).max()))
            out['score'] = max(out['score'], float(abs(
                a['scores'][i][va[r]] - b['scores'][i][vb[c]])))
        out['unmatched'] += len(va) + len(vb) - 2 * matched
    return out


def evaluate_detector(detector, images, gt_boxes_list, iou_threshold=0.5,
                      batch_size=16):
    """Run `detector.detect_images` over a labeled set and score it.

    :param detector: facade with `detect_images(images) -> [[BoundingBox]]`
    :param images: list of uint8 [H, W, 3] arrays
    :param gt_boxes_list: list of [G_i, 4] pixel boxes per image
    :returns: dict with recall / precision / mean_iou / counts
    """
    n_gt = n_pred = n_matched = 0
    all_ious = []
    for start in range(0, len(images), batch_size):
        chunk = images[start:start + batch_size]
        results = detector.detect_images(chunk)
        for faces, gt in zip(results, gt_boxes_list[start:start + batch_size]):
            # exact extents: BoundingBox.right/.bottom carry the
            # reference's +1 convention (face_detector.py:51-54), which
            # would inflate every box 1px right/down and bias IoU low
            # (a perfect 2px-face match would score 4/9 and "miss")
            pred = np.array([[f.left, f.top,
                              f.left + f.width, f.top + f.height]
                             for f in faces], np.float32).reshape(-1, 4)
            gt = np.asarray(gt, np.float32).reshape(-1, 4)
            matched, ious = match_detections(gt, pred, iou_threshold)
            n_gt += len(gt)
            n_pred += len(pred)
            n_matched += matched
            all_ious.extend(ious)
    return {
        'recall': n_matched / max(n_gt, 1),
        'precision': n_matched / max(n_pred, 1),
        'mean_iou': float(np.mean(all_ious)) if all_ious else 0.0,
        'n_gt': n_gt, 'n_pred': n_pred, 'n_matched': n_matched,
    }
