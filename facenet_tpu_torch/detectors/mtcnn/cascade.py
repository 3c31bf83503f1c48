"""Batched MTCNN detection cascade in PyTorch.

Fixed geometry and fixed capacities, as in the JAX package's cascade:

  * images are letterboxed to a static (H, W); the image pyramid is a
    static list of scales derived from min_face_size and the scale factor;
  * proposals live in [B, K, 4] buffers with validity masks
    (K_pnet -> K_rnet -> K_onet), so threshold, NMS and top-k never make
    ragged shapes, and a batch needs no host round trip between stages.

Stage protocol (thresholds and NMS from the MTCNN paper, arXiv:1604.02878):
  P-Net over each pyramid level -> score >= t1, per-level NMS 0.5 ->
  cross-level NMS 0.7, bbox regression, square;
  R-Net on 24x24 crops -> score >= t2, NMS 0.7, regression, square;
  O-Net on 48x48 crops -> score >= t3, regression, NMS 0.7 (mode 'min'),
  5 landmarks.

The P-Net runs over the whole pyramid in one launch of the B3 kernel
(`pnet.pnet_forward_pyramid`) by default; `pnet_impl='flat'` runs it level
by level through the B4 kernel (`pnet.pnet_forward_flat`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from facenet_tpu_torch.detectors.batched import BatchedDetector
from facenet_tpu_torch.detectors.mtcnn import pnet as pnet_kernel
from facenet_tpu_torch.detectors.mtcnn.networks import (ONet, PNet, RNet,
                                                        normalize_crops)
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.ops.crop import crop_and_resize
from facenet_tpu_torch.ops.image_ops import align_by_landmarks
from facenet_tpu_torch.ops.nms import (apply_bbox_regression, batched_nms_mask,
                                       square_boxes, top_k_boxes)
from facenet_tpu_torch.utils import profiling

PNET_CELL = 12
PNET_STRIDE = 2


def _overflow_count(valid, k):
    """Valid candidates beyond a top-k capacity, per image: what the
    fixed-size buffer drops. [B, N] bool mask -> [B] int32 (>= 0)."""
    return torch.clamp(valid.sum(dim=-1, dtype=torch.int32) - int(k), min=0)


def pyramid_scales(height, width, min_face_size=20, factor=0.709,
                   min_level=12):
    """Static list of pyramid scales (largest first)."""
    m = PNET_CELL / float(min_face_size)
    side = min(height, width) * m
    scales = []
    s = m
    while side >= min_level:
        scales.append(s)
        s *= factor
        side *= factor
    return scales


def pnet_base_boxes(gh, gw, scale, convention='exact', device=None):
    """Base boxes [gh, gw, 4] for a P-Net output grid at pyramid `scale`.

    'exact': cell (y, x) covers its true receptive window [2x, 2x+12) /
    scale, the convention of the bundled weights' regression targets.
    'caffe': the upstream davidsandberg generateBoundingBox form
    q1 = (2x+1)/scale, q2 = (2x+12)/scale (11 wide), which Caffe-era
    pretrained P-Net regressors were trained against.
    """
    off = 1.0 if convention == 'caffe' else 0.0
    ys = (torch.arange(gh, dtype=torch.float32, device=device) * PNET_STRIDE
          + off) / scale
    xs = (torch.arange(gw, dtype=torch.float32, device=device) * PNET_STRIDE
          + off) / scale
    y1 = ys[:, None].expand(gh, gw)
    x1 = xs[None, :].expand(gh, gw)
    cell = (PNET_CELL - off) / scale
    return torch.stack([x1, y1, x1 + cell, y1 + cell], dim=-1)


def compute_weight_mat(input_size, output_size, scale, translation=0.0,
                       antialias=True):
    """[input_size, output_size] float32 triangle-kernel resampling weights,
    the arithmetic of ``jax.image.resize(method='bilinear')`` (its
    ``compute_weight_mat``): antialiased when downsampling, columns
    normalized to sum 1, samples outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = ((np.arange(output_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(translation) * inv_scale - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(input_size, dtype=f32)[:, None])
         / kernel_scale)
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.zeros((1, output_size), f32)
    for row in weights:                      # in input order, as XLA sums
        total += row
    weights = np.where(
        np.abs(total) > f32(1000.0) * np.finfo(np.float32).eps,
        weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(input_size) - f32(0.5))
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def level_resize_matrices(image_shape, scale):
    """(V [sh, H], Hm [W, sw]) float32 resize matrices of one level, so the
    level is V @ image @ Hm; sh = ceil(H * scale), and the resampling scale
    is sh / H, as ``jax.image.resize`` of an identity matrix gives them."""
    h, w = image_shape
    sh = int(math.ceil(h * scale))
    sw = int(math.ceil(w * scale))
    v = compute_weight_mat(h, sh, sh / h).T
    hm = compute_weight_mat(w, sw, sw / w)
    return v, hm


class MTCNN(BatchedDetector):
    """Batched MTCNN detector (the `BatchedDetector` front end).

        det = MTCNN(image_shape=(480, 640))          # device=None: cuda
        out = det.detect_batch(images_uint8)         # [B, H, W, 3]
        out['boxes'], out['scores'], out['landmarks'], out['valid']

    `detect_batch` returns numpy 'boxes' [B, K, 4], 'scores' [B, K],
    'landmarks' [B, K, 5, 2], 'valid' [B, K] and the per-stage 'overflow'
    counts.

    :param params: flax-layout param tree {'pnet', 'rnet', 'onet'} of
        arrays (`pretrained.load_bundled`); None initializes the networks
        at random from `seed`
    :param pnet_impl: 'auto' (= 'pyramid') runs the whole pyramid through
        the B3 kernel in one launch; 'flat' runs the B4 kernel once per
        level on that level's channel planes; 'flax' runs the `PNet` module
        level by level through cuDNN. The JAX package's 'auto' picks its
        XLA convs for throughput at batch 64, a choice measured on a TPU
        v5e that says nothing of this card. Its 'pyramid-dots' and
        'pyramid-skip' are an assembly experiment and a wrong-numerics
        timing probe inside the TPU version of B3, not kernels of their
        own, and raise here.
    :param device: torch device; None means cuda (raises without a GPU)
    """

    overflow_warning = (
        'MTCNN capacity overflow: dropped valid proposals %s '
        '(raise max_proposals/max_refined/max_outputs for dense scenes)')

    def __init__(self, image_shape=(480, 640), min_face_size=20,
                 factor=0.709, thresholds=(0.6, 0.7, 0.7),
                 max_proposals=256, max_refined=64, max_outputs=32,
                 params=None, seed=0, dtype=torch.bfloat16,
                 pnet_impl='auto', pnet_box_convention='exact',
                 device=None):
        if pnet_box_convention not in ('exact', 'caffe'):
            raise ValueError(
                f'unknown pnet_box_convention {pnet_box_convention!r}')
        if pnet_impl == 'auto':
            pnet_impl = 'pyramid'
        if pnet_impl in ('pyramid-dots', 'pyramid-skip'):
            raise NotImplementedError(
                f"pnet_impl {pnet_impl!r} is not ported: 'pyramid-dots' and "
                "'pyramid-skip' are probes inside the TPU version of the "
                "whole-pyramid kernel (B3), not kernels of their own; use "
                "'pyramid', 'flat' or 'flax'")
        if pnet_impl not in ('pyramid', 'flat', 'flax'):
            raise ValueError(f'unknown pnet_impl {pnet_impl!r}')
        self.pnet_impl = pnet_impl
        self.pnet_box_convention = pnet_box_convention
        self.device = resolve_device(device)
        self.image_shape = (int(image_shape[0]), int(image_shape[1]))
        self.min_face_size = min_face_size
        self.factor = factor
        self.thresholds = tuple(thresholds)
        self.k_pnet = int(max_proposals)
        self.k_rnet = int(max_refined)
        self.k_onet = int(max_outputs)
        self.dtype = dtype

        self.scales = pyramid_scales(*self.image_shape,
                                     min_face_size=min_face_size,
                                     factor=factor)
        if not self.scales:
            raise ValueError(
                f'image {self.image_shape} too small for min_face_size '
                f'{min_face_size}')

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(seed))
            self.pnet = PNet(dtype=dtype)
            self.rnet = RNet(dtype=dtype)
            self.onet = ONet(dtype=dtype)
        if params is not None:
            self.pnet.from_flax_params(params['pnet'])
            self.rnet.from_flax_params(params['rnet'])
            self.onet.from_flax_params(params['onet'])
        for net in (self.pnet, self.rnet, self.onet):
            net.to(self.device).eval().requires_grad_(False)

        # Pyramid resizes as two products, V_l @ image @ H_l, with the
        # matrices of jax.image.resize on identity matrices rounded to bf16
        self._resize_mats = []
        self._base_boxes = []
        for scale in self.scales:
            v, hm = level_resize_matrices(self.image_shape, scale)
            self._resize_mats.append(
                (torch.from_numpy(v).to(self.device, torch.bfloat16),
                 torch.from_numpy(hm).to(self.device, torch.bfloat16)))
            gh, gw = pnet_kernel.out_geometry(v.shape[0], hm.shape[1])
            self._base_boxes.append(pnet_base_boxes(
                gh, gw, scale, pnet_box_convention, self.device))

    # ------------------------------------------------------------------
    def pyramid_levels(self, base_norm):
        """Normalized bf16 scenes [B, H, W, 3] -> per-level bf16 planes
        [B, 3, sh, sw] (two bf16 products per level)."""
        b, h, w, _ = base_norm.shape
        flat = base_norm.reshape(b, h, w * 3)
        levels = []
        for v, hm in self._resize_mats:
            t = torch.matmul(v, flat)                             # [B, sh, W*3]
            t = t.reshape(b, -1, w, 3).permute(0, 3, 1, 2)       # [B, 3, sh, W]
            levels.append(torch.matmul(t, hm).contiguous())      # [B, 3, sh, sw]
        return levels

    def _pnet_select(self, probs, reg, level):
        """One level's P-Net heads -> fixed-size pruned candidate set."""
        b = probs.shape[0]
        base = self._base_boxes[level].reshape(1, -1, 4).expand(b, -1, 4)
        boxes = apply_bbox_regression(base, reg.reshape(b, -1, 4))
        scores = probs.reshape(b, -1)
        valid = scores >= self.thresholds[0]
        k = min(self.k_pnet, boxes.shape[1])
        overflow = _overflow_count(valid, k)
        boxes, scores, valid = top_k_boxes(boxes, scores, valid, k)
        keep = batched_nms_mask(boxes, scores, valid, 0.5, algorithm='fast')
        return boxes, scores, valid & keep, overflow

    @torch.inference_mode()
    def _detect(self, images):
        """uint8 [B, H, W, 3] tensor on this device -> output dict of
        tensors (see `detect_batch`). The three stages are the spans
        ``mtcnn.pnet``, ``mtcnn.rnet`` and ``mtcnn.onet``
        (`utils.profiling`)."""
        b = images.shape[0]

        # ---- stage 1: P-Net over the pyramid
        with profiling.annotate('mtcnn.pnet'):
            images_f32 = images.float()
            levels = self.pyramid_levels(normalize_crops(images_f32).to(
                torch.bfloat16))
            if self.pnet_impl == 'pyramid':
                heads = pnet_kernel.pnet_forward_pyramid(self.pnet, levels)
            elif self.pnet_impl == 'flat':
                # the level's planes as they lie: the pitch is the true
                # width
                heads = [pnet_kernel.pnet_forward_flat(
                    self.pnet, level.view(b, 3, -1), *level.shape[2:],
                    level.shape[3]) for level in levels]
            else:
                heads = [self.pnet.forward_nchw(level) for level in levels]
            per_level = [self._pnet_select(probs, reg, level)
                         for level, (probs, reg) in enumerate(heads)]
            overflow = {'pnet_level': sum(ov for *_, ov in per_level)}
            boxes = torch.cat([bx for bx, *_ in per_level], dim=1)
            scores = torch.cat([sc for _, sc, *_ in per_level], dim=1)
            valid = torch.cat([va for _, _, va, _ in per_level], dim=1)

            # cross-level NMS 0.7 on the top-K_pnet proposals
            overflow['pnet'] = _overflow_count(valid, self.k_pnet)
            boxes, scores, valid = top_k_boxes(boxes, scores, valid,
                                               self.k_pnet)
            valid = valid & batched_nms_mask(boxes, scores, valid, 0.7,
                                             algorithm='fast')
            boxes = square_boxes(boxes)

        # ---- stage 2: R-Net on 24x24 crops
        with profiling.annotate('mtcnn.rnet'):
            overflow['rnet'] = _overflow_count(valid, self.k_rnet)
            boxes, scores, valid = top_k_boxes(boxes, scores, valid,
                                               self.k_rnet)
            crops = crop_and_resize(images_f32, boxes, 24)
            probs, reg = self.rnet(normalize_crops(
                crops.reshape(-1, 24, 24, 3)))
            probs = probs.reshape(b, -1)
            reg = reg.reshape(b, -1, 4)
            valid = valid & (probs >= self.thresholds[1])
            scores = probs
            valid = valid & batched_nms_mask(boxes, scores, valid, 0.7,
                                             algorithm='fast')
            boxes = square_boxes(apply_bbox_regression(boxes, reg))

        # ---- stage 3: O-Net on 48x48 crops
        with profiling.annotate('mtcnn.onet'):
            overflow['onet'] = _overflow_count(valid, self.k_onet)
            boxes, scores, valid = top_k_boxes(boxes, scores, valid,
                                               self.k_onet)
            crops = crop_and_resize(images_f32, boxes, 48)
            probs, reg, lmk = self.onet(normalize_crops(
                crops.reshape(-1, 48, 48, 3)))
            probs = probs.reshape(b, -1)
            reg = reg.reshape(b, -1, 4)
            lmk = lmk.reshape(b, -1, 10)
            valid = valid & (probs >= self.thresholds[2])
            scores = probs

            # landmarks are predicted relative to the (square) box
            w = (boxes[..., 2] - boxes[..., 0])[..., None]
            h = (boxes[..., 3] - boxes[..., 1])[..., None]
            lx = boxes[..., 0:1] + lmk[..., 0:5] * w
            ly = boxes[..., 1:2] + lmk[..., 5:10] * h
            landmarks = torch.stack([lx, ly], dim=-1)          # [B, K, 5, 2]

            boxes = apply_bbox_regression(boxes, reg)
            valid = valid & batched_nms_mask(boxes, scores, valid, 0.7,
                                             mode='min')

            # valid detections to the front, best score first (stable, as
            # jnp.argsort): consumers read the first `num_faces` slots
            order = torch.argsort(-torch.where(valid, scores, -1.0), dim=-1,
                                  stable=True)
            boxes = torch.gather(boxes, 1,
                                 order[..., None].expand_as(boxes))
            scores = torch.gather(scores, 1, order)
            landmarks = torch.gather(
                landmarks, 1, order[..., None, None].expand_as(landmarks))
            valid = torch.gather(valid, 1, order)
            scores = torch.where(valid, scores, 0.0)
        return {
            'boxes': boxes,                  # [B, K_onet, 4] (x1, y1, x2, y2)
            'scores': scores,
            'landmarks': landmarks,          # [B, K_onet, 5, 2]
            'valid': valid,
            # per-image candidates lost to each capacity
            'overflow': overflow,
        }

    def align_batch(self, images, landmarks, out_size=160):
        """Landmark alignment of one face per image -> numpy
        [B, out_size, out_size, 3] float32."""
        images = torch.as_tensor(np.asarray(images, np.float32))
        landmarks = torch.as_tensor(np.asarray(landmarks, np.float32))
        with torch.inference_mode():
            out = align_by_landmarks(images.to(self.device),
                                     landmarks.to(self.device), int(out_size))
        return out.cpu().numpy()
