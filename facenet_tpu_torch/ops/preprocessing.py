"""In-model image preprocessing: uint8 NHWC batch -> float, resize to the
configured size, then one of two per-image normalizations:

  normalization == 0: min/max dynamic-range scaling to [-1, 1], eps 1e-3
  normalization == 1: (x - mean) / max(std, 1/sqrt(N)), the semantics of
                      tf.image.per_image_standardization

The reductions read the input as given (the raw uint8 bytes when no resize
is needed), and the variance comes from E[x^2] - E[x]^2, so both moments
come from one pass over the input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_EPS = 1e-3


def image_processing(image_batch, size, normalization=0, dtype=torch.float32):
    """Preprocess a uint8 (or float) NHWC image batch.

    :param image_batch: [B, H, W, 3] uint8/float tensor
    :param size: target square size (int)
    :param normalization: 0 (min/max dynamic range) or 1 (standardization)
    :param dtype: output dtype (bfloat16 feeds the bf16 conv stack)
    :return: [B, size, size, 3] normalized batch in `dtype`
    """
    x = image_batch
    if x.shape[1] != size or x.shape[2] != size:
        # bilinear with half-pixel centres and no antialiasing filter, as
        # tf.image.resize does by default
        x = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(size, size),
                          mode='bilinear', align_corners=False,
                          antialias=False).permute(0, 2, 3, 1)

    flat = x.reshape(x.shape[0], -1)
    bcast = (slice(None),) + (None,) * (x.ndim - 1)
    if normalization == 0:
        min_value = flat.amin(dim=1)[bcast].float()
        max_value = flat.amax(dim=1)[bcast].float()
        dynamic_range = torch.clamp(max_value - min_value, min=_EPS)
        scale = 2.0 / dynamic_range
        shift = (min_value + max_value) / dynamic_range
        x = x.float() * scale - shift
    elif normalization == 1:
        n = x.shape[1] * x.shape[2] * x.shape[3]
        ff = flat.float()
        mean = ff.mean(dim=1)[bcast]
        sq_mean = ff.square().mean(dim=1)[bcast]
        std = torch.sqrt(torch.clamp(sq_mean - mean.square(), min=0.0))
        adjusted_std = torch.clamp(std, min=1.0 / math.sqrt(float(n)))
        x = x.float() * (1.0 / adjusted_std) - mean / adjusted_std
    else:
        raise ValueError('Invalid image normalization algorithm')

    return x.to(dtype)
