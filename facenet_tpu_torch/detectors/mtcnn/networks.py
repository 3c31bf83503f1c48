"""MTCNN P-Net / R-Net / O-Net as PyTorch modules.

The architectures follow the MTCNN paper (Zhang et al., 2016,
arXiv:1604.02878): three small CNNs with PReLU activations.

  P-Net (fully convolutional, 12x12 receptive field, stride 2):
    conv3x3/10 - maxpool2 - conv3x3/16 - conv3x3/32 -> cls 2 + reg 4
  R-Net (24x24): conv3x3/28 - maxpool3s2 - conv3x3/48 - maxpool3s2 -
    conv2x2/64 - FC 128 -> cls 2 + reg 4
  O-Net (48x48): conv3x3/32 - maxpool3s2 - conv3x3/64 - maxpool3s2 -
    conv3x3/64 - maxpool2s2 - conv2x2/128 - FC 256 -> cls 2 + reg 4 +
    landmarks 10

The public layout is the JAX package's: inputs [B, H, W, 3] normalized
NHWC, parameters in the flax tree (`from_flax_params`). Parameters are
float32; activations run in the module's ``dtype`` (bfloat16 by default):
inputs, weights and biases are cast to it, PReLU casts its alpha to it, and
the heads come back as float32 with a float32 softmax.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def normalize_crops(x):
    """MTCNN input normalization: (pixel - 127.5) / 128, float32."""
    return (x.float() - 127.5) * (1.0 / 128.0)


def max_pool_same(x, window, stride):
    """NCHW max pool with flax's 'SAME' padding: -inf padding split as
    total // 2 low and the rest high (F.max_pool2d pads symmetrically)."""
    pads = []
    for size in (x.shape[3], x.shape[2]):          # F.pad order: W, then H
        out = -(-size // stride)
        total = max((out - 1) * stride + window - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=float('-inf'))
    return F.max_pool2d(x, window, stride)


class PReLU(nn.Module):
    """Channel-wise parametric ReLU over axis 1 (NCHW or [B, C]); alpha is
    cast to the activation dtype."""

    def __init__(self, channels):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        alpha = self.alpha.to(x.dtype).reshape(1, -1, *[1] * (x.dim() - 2))
        return torch.where(x >= 0, x, alpha * x)


class _Net(nn.Module):
    """Shared plumbing: flax-tree loading and dtype casts."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def _conv(self, layer, x):
        d = self.dtype
        return F.conv2d(x, layer.weight.to(d), layer.bias.to(d))

    def _dense(self, layer, x):
        d = self.dtype
        return F.linear(x, layer.weight.to(d), layer.bias.to(d))

    @torch.no_grad()
    def from_flax_params(self, params):
        """Load a flax param tree ({'conv1': {'kernel', 'bias'},
        'prelu1': {'alpha'}, ...} of arrays, HWIO conv kernels and [in, out]
        dense kernels) into this module; returns self."""
        for name, child in self.named_children():
            tree = params[name]
            if isinstance(child, PReLU):
                child.alpha.copy_(_tensor(tree['alpha']))
                continue
            kernel = _tensor(tree['kernel'])
            if isinstance(child, nn.Conv2d):
                kernel = kernel.permute(3, 2, 0, 1)        # HWIO -> OIHW
            else:
                kernel = kernel.t()                         # [in, out] -> [out, in]
            if tuple(kernel.shape) != tuple(child.weight.shape):
                raise ValueError(f'{type(self).__name__}.{name}: kernel '
                                 f'{tuple(kernel.shape)} != '
                                 f'{tuple(child.weight.shape)}')
            child.weight.copy_(kernel)
            child.bias.copy_(_tensor(tree['bias']))
        return self


def _tensor(value):
    return torch.tensor(np.asarray(value, np.float32))      # a copy


def _heads(cls, *rest):
    """Face probability (float32 softmax) and the other heads in float32."""
    return (torch.softmax(cls.float(), dim=-1)[..., 1],
            *(r.float() for r in rest))


class PNet(_Net):
    """Proposal network, fully convolutional: input [B, H, W, 3] normalized.

    Returns (probs [B, H', W'], reg [B, H', W', 4]) with
    H' = ceil((H - 2) / 2) - 4; each output cell maps to a 12x12 window at
    stride 2 in the input.
    """

    def __init__(self, dtype=torch.bfloat16):
        super().__init__(dtype)
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = PReLU(10)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = PReLU(32)
        self.cls = nn.Conv2d(32, 2, 1)
        self.reg = nn.Conv2d(32, 4, 1)
        self._packed = None      # the B3 kernel's weights (mtcnn/pnet.py)

    def from_flax_params(self, params):
        self._packed = None
        return super().from_flax_params(params)

    def forward(self, x):
        return self.forward_nchw(x.permute(0, 3, 1, 2))

    def forward_nchw(self, x):
        """The same network on [B, 3, H, W] input."""
        x = x.to(self.dtype)
        x = self.prelu1(self._conv(self.conv1, x))
        x = max_pool_same(x, 2, 2)
        x = self.prelu2(self._conv(self.conv2, x))
        x = self.prelu3(self._conv(self.conv3, x))
        cls = self._conv(self.cls, x).permute(0, 2, 3, 1)
        reg = self._conv(self.reg, x).permute(0, 2, 3, 1)
        return _heads(cls, reg)


class RNet(_Net):
    """Refinement network: input [B, 24, 24, 3] normalized crops."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__(dtype)
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = PReLU(28)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = PReLU(48)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = PReLU(64)
        self.fc1 = nn.Linear(576, 128)
        self.prelu4 = PReLU(128)
        self.cls = nn.Linear(128, 2)
        self.reg = nn.Linear(128, 4)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.prelu1(self._conv(self.conv1, x))
        x = max_pool_same(x, 3, 2)
        x = self.prelu2(self._conv(self.conv2, x))
        x = F.max_pool2d(x, 3, 2)
        x = self.prelu3(self._conv(self.conv3, x))
        x = x.permute(0, 2, 3, 1).flatten(1)               # NHWC flatten
        x = self.prelu4(self._dense(self.fc1, x))
        return _heads(self._dense(self.cls, x), self._dense(self.reg, x))


class ONet(_Net):
    """Output network: input [B, 48, 48, 3]; adds 5-landmark regression."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__(dtype)
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = PReLU(32)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = PReLU(64)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = PReLU(64)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = PReLU(128)
        self.fc1 = nn.Linear(1152, 256)
        self.prelu5 = PReLU(256)
        self.cls = nn.Linear(256, 2)
        self.reg = nn.Linear(256, 4)
        self.landmarks = nn.Linear(256, 10)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.prelu1(self._conv(self.conv1, x))
        x = max_pool_same(x, 3, 2)
        x = self.prelu2(self._conv(self.conv2, x))
        x = F.max_pool2d(x, 3, 2)
        x = self.prelu3(self._conv(self.conv3, x))
        x = max_pool_same(x, 2, 2)
        x = self.prelu4(self._conv(self.conv4, x))
        x = x.permute(0, 2, 3, 1).flatten(1)               # NHWC flatten
        x = self.prelu5(self._dense(self.fc1, x))
        return _heads(self._dense(self.cls, x), self._dense(self.reg, x),
                      self._dense(self.landmarks, x))
