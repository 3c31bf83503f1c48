"""Faster-RCNN face detector networks: backbone, RPN and RoI head.

The JAX package's networks (facenet_tpu/detectors/frcnn/network.py) as
PyTorch modules with its flax names, so a flax parameter tree loads as is
(`load_flax_tree`). Parameters are float32; activations run in the
module's ``dtype`` (bfloat16 by default): inputs, weights and biases are
cast to it, and the heads come back as float32.

Two places where flax's layout decides the numbers:

  * flax's ``'SAME'`` padding at stride 2 pads a 3x3 kernel (0, 1) on an
    even size and (1, 1) on an odd one (total (out - 1) * 2 + 3 - size,
    the smaller half first); ``padding=1`` would shift every feature by a
    pixel, so each stride-2 conv pads explicitly (`_pad_same`);
  * `RoIHead.fc1` reads the [P, P, C] RoI flattened in NHWC order, which is
    the layout `crop_and_resize` returns, so fc1's rows are flax's as they
    are.

Boxes are (x1, y1, x2, y2) pixels; the anchor grid is stride 16 with 4
scales x 3 ratios at each cell, in (y, x, scale, ratio) order, the order
of the RPN's flattened outputs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

STRIDE = 16
ANCHOR_SCALES = (32, 64, 128, 256)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
NUM_ANCHORS = len(ANCHOR_SCALES) * len(ANCHOR_RATIOS)
FEATURES = (32, 64, 128, 256)


def _pad_same(x, kernel, stride):
    """Zero padding of an NCHW map as flax's ``'SAME'`` places it."""
    pads = []
    for size in (x.shape[3], x.shape[2]):          # F.pad order: W, then H
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _Module(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def _conv(self, layer, x, stride=1):
        d = self.dtype
        if layer.kernel_size != (1, 1):
            x = _pad_same(x, layer.kernel_size[0], stride)
        return F.conv2d(x, layer.weight.to(d), layer.bias.to(d),
                        stride=stride)

    def _dense(self, layer, x):
        d = self.dtype
        return F.linear(x, layer.weight.to(d), layer.bias.to(d))


class Backbone(_Module):
    """Compact stride-16 conv backbone: four stages of a 3x3 stride-2 conv
    and a 3x3 conv, each with ReLU. [B, 3, H, W] -> [B, 256, H/16, W/16]
    in ``dtype`` (NCHW)."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__(dtype)
        channels = 3
        for i, feats in enumerate(FEATURES):
            setattr(self, f'conv{i + 1}', nn.Conv2d(channels, feats, 3))
            setattr(self, f'conv{i + 1}b', nn.Conv2d(feats, feats, 3))
            channels = feats

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(len(FEATURES)):
            x = F.relu(self._conv(getattr(self, f'conv{i + 1}'), x, 2))
            x = F.relu(self._conv(getattr(self, f'conv{i + 1}b'), x))
        return x


class RPN(_Module):
    """Region proposal head on the NCHW feature map: objectness [B, G*A]
    and box deltas [B, G*A, 4], float32, in anchor-grid order."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__(dtype)
        self.conv = nn.Conv2d(FEATURES[-1], 256, 3)
        self.obj = nn.Conv2d(256, NUM_ANCHORS, 1)
        self.deltas = nn.Conv2d(256, NUM_ANCHORS * 4, 1)

    def forward(self, feats):
        x = F.relu(self._conv(self.conv, feats))
        obj = self._conv(self.obj, x).permute(0, 2, 3, 1)
        deltas = self._conv(self.deltas, x).permute(0, 2, 3, 1)
        b = obj.shape[0]
        return (obj.float().reshape(b, -1),
                deltas.float().reshape(b, -1, 4))


class RoIHead(_Module):
    """Second stage: pooled RoIs [B, K, P, P, C] (NHWC crops) -> face
    logits [B, K, 2] and box refinements [B, K, 4], float32."""

    def __init__(self, dtype=torch.bfloat16, roi_size=7):
        super().__init__(dtype)
        self.fc1 = nn.Linear(roi_size * roi_size * FEATURES[-1], 512)
        self.fc2 = nn.Linear(512, 256)
        self.cls = nn.Linear(256, 2)
        self.reg = nn.Linear(256, 4)

    def forward(self, rois):
        b, k = rois.shape[:2]
        x = rois.reshape(b * k, -1).to(self.dtype)
        x = F.relu(self._dense(self.fc1, x))
        x = F.relu(self._dense(self.fc2, x))
        return (self._dense(self.cls, x).float().reshape(b, k, 2),
                self._dense(self.reg, x).float().reshape(b, k, 4))


def anchor_grid(height, width):
    """Fixed [G*A, 4] float32 anchor boxes (x1, y1, x2, y2) for an input
    H x W (numpy)."""
    gh, gw = height // STRIDE, width // STRIDE
    cy = (np.arange(gh) + 0.5) * STRIDE
    cx = (np.arange(gw) + 0.5) * STRIDE

    anchors = []
    for y in cy:
        for x in cx:
            for s in ANCHOR_SCALES:
                for r in ANCHOR_RATIOS:
                    w = s * np.sqrt(r)
                    h = s / np.sqrt(r)
                    anchors.append([x - w / 2, y - h / 2,
                                    x + w / 2, y + h / 2])
    return np.asarray(anchors, np.float32)


def decode_deltas(anchors, deltas):
    """RCNN box decoding of (dx, dy, dw, dh) against anchors -> boxes
    (tensors); dw and dh clipped to [-4, 4] before the exponential."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = anchors[..., 0] + aw / 2
    acy = anchors[..., 1] + ah / 2

    dx, dy, dw, dh = (deltas[..., 0], deltas[..., 1],
                      deltas[..., 2], deltas[..., 3])
    cx = acx + dx * aw
    cy = acy + dy * ah
    w = aw * torch.exp(torch.clamp(dw, -4.0, 4.0))
    h = ah * torch.exp(torch.clamp(dh, -4.0, 4.0))
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def encode_deltas(anchors, boxes):
    """Inverse of `decode_deltas`, the training targets (numpy)."""
    aw = np.maximum(anchors[..., 2] - anchors[..., 0], 1e-6)
    ah = np.maximum(anchors[..., 3] - anchors[..., 1], 1e-6)
    acx = anchors[..., 0] + aw / 2
    acy = anchors[..., 1] + ah / 2

    bw = np.maximum(boxes[..., 2] - boxes[..., 0], 1e-6)
    bh = np.maximum(boxes[..., 3] - boxes[..., 1], 1e-6)
    bcx = boxes[..., 0] + bw / 2
    bcy = boxes[..., 1] + bh / 2

    return np.stack([(bcx - acx) / aw, (bcy - acy) / ah,
                     np.log(bw / aw), np.log(bh / ah)], axis=-1)
