"""Inception-ResNet-v1 embedding network, eval mode (PyTorch).

The architecture of ``facenet_tpu.models.inception_resnet_v1`` with the same
submodule names, so a flax ``{'params', 'batch_stats'}`` tree loads into it
directly (`from_flax_variables`) and `init_variables` can make such a tree
without JAX:

  stem: 6 convs + maxpool; 5x Block35 scale .17; ReductionA; 10x Block17
  scale .10; ReductionB; 5x Block8 scale .2 + a final Block8 scale 1 without
  activation; head AvgPool 3x3 -> Dense (no bias) -> BatchNorm; L2
  normalization with eps 1e-10 at inference.

BatchNorm is center-only (bias, no scale) with eps 1e-3 and runs on its
running statistics; train-mode BN is not part of this module. Flax names
hold dots ('Repeat.block35_1'), which torch forbids in module names, so
each child is registered under an attribute name and keeps its flax name
beside it.
Activations are NCHW inside; the public forward takes NHWC images.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facenet_tpu_torch.config import Config
from facenet_tpu_torch.ops.preprocessing import image_processing

default_config = {
    'reduction_a': {'filters': [[384], [192, 192, 256]]},
    'reduction_b': {'filters': [[256, 384], [256, 256], [256, 256, 256]]},
    'block35': {'repeat': 5, 'scale': 0.17, 'activation': 'relu'},
    'block17': {'repeat': 10, 'scale': 0.10, 'activation': 'relu'},
    'block8_1': {'repeat': 5, 'scale': 0.2, 'activation': 'relu'},
    'block8_2': {'scale': 1.0, 'activation': None},
    'output': {'size': 512},
}

BN_EPS = 1e-3


def check_input_config(cfg=None):
    """Fill missing model-config fields with the defaults."""
    base = Config(default_config)
    if cfg is None:
        return base
    if not isinstance(cfg, Config):
        cfg = Config(cfg)
    base.update(cfg)
    return base


def _glorot_uniform(rng, shape):
    """flax's glorot_uniform for a kernel whose last two axes are (in, out)."""
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def _valid(size, kernel=3, stride=2):
    return (size - kernel) // stride + 1


class _Flax(nn.Module):
    """A module whose children carry flax names; loads and makes flax trees."""

    def __init__(self):
        super().__init__()
        self.flax_names = []

    def child(self, flax_name, module, attr=None):
        """Register `module` under `attr` (default: the flax name with '.'
        replaced by '_') and remember its flax name."""
        attr = attr or flax_name.replace('.', '_')
        self.add_module(attr, module)
        self.flax_names.append((flax_name, attr))
        return module

    def named_flax_children(self):
        for name, attr in self.flax_names:
            yield name, getattr(self, attr)

    def load_flax(self, params, stats):
        for name, module in self.named_flax_children():
            module.load_flax(params[name], stats.get(name, {}))

    def flax_variables(self, rng):
        params, stats = {}, {}
        for name, module in self.named_flax_children():
            p, s = module.flax_variables(rng)
            params[name] = p
            if s:
                stats[name] = s
        return params, stats


def _copy(param, array):
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(array, np.float32)))


class Conv(nn.Module):
    """Conv2d holding a flax HWIO kernel as OIHW; 'SAME' or 'VALID' padding."""

    def __init__(self, cin, cout, kernel, stride=1, padding='SAME',
                 bias=False):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = stride
        self.padding = 'same' if padding == 'SAME' else 0
        if padding == 'SAME' and stride != 1:
            raise ValueError('SAME padding is supported at stride 1 only')
        self.weight = nn.Parameter(torch.zeros(cout, cin, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)

    def load_flax(self, params, stats=None):
        _copy(self.weight, np.transpose(params['kernel'], (3, 2, 0, 1)))
        if self.bias is not None:
            _copy(self.bias, params['bias'])

    def flax_variables(self, rng):
        cout, cin = self.weight.shape[:2]
        params = {'kernel': _glorot_uniform(rng, self.kernel + (cin, cout))}
        if self.bias is not None:
            params['bias'] = np.zeros((cout,), np.float32)
        return params, {}


class Dense(nn.Module):
    """Bias-free dense layer holding a flax [in, out] kernel as [out, in]."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))

    def forward(self, x):
        return F.linear(x, self.weight)

    def load_flax(self, params, stats=None):
        _copy(self.weight, np.transpose(params['kernel']))

    def flax_variables(self, rng):
        cout, cin = self.weight.shape
        return {'kernel': _glorot_uniform(rng, (cin, cout))}, {}


class BatchNorm(nn.Module):
    """Center-only BatchNorm on running statistics over axis 1."""

    def __init__(self, features):
        super().__init__()
        self.register_buffer('bias', torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = torch.rsqrt(self.var + BN_EPS)
        return ((x - self.mean.view(shape)) * scale.view(shape)
                + self.bias.view(shape))

    def load_flax(self, params, stats):
        _copy(self.bias, params['bias'])
        _copy(self.mean, stats['mean'])
        _copy(self.var, stats['var'])

    def flax_variables(self, rng):
        n = self.bias.shape[0]
        return ({'bias': np.zeros((n,), np.float32)},
                {'mean': np.zeros((n,), np.float32),
                 'var': np.ones((n,), np.float32)})


class ConvBnRelu(_Flax):
    """Conv (no bias) -> BatchNorm(center, no scale) -> optional ReLU."""

    def __init__(self, cin, cout, kernel=(3, 3), stride=1, padding='SAME',
                 relu=True):
        super().__init__()
        self.relu = relu
        self.cout = cout
        self.child('conv', Conv(cin, cout, kernel, stride, padding))
        self.child('bn', BatchNorm(cout))

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class _Residual(_Flax):
    """Shared tail of Block35/17/8: concat branches, 1x1 up-projection,
    scaled residual add, optional ReLU."""

    def __init__(self, cin, mixed, scale, activation):
        super().__init__()
        self.scale = float(scale)
        self.activation = activation
        self.child('Conv2d_1x1', Conv(mixed, cin, (1, 1), bias=True), 'up')

    def residual(self, x, branches):
        x = x + self.scale * self.up(torch.cat(branches, dim=1))
        return F.relu(x) if self.activation else x


class Block35(_Residual):
    """Inception-ResNet-A block."""

    def __init__(self, cin, scale=0.17, activation='relu'):
        super().__init__(cin, 96, scale, activation)
        c = self.child
        c('Branch_0.Conv2d_1x1', ConvBnRelu(cin, 32, (1, 1)), 'b0')
        c('Branch_1.Conv2d_0a_1x1', ConvBnRelu(cin, 32, (1, 1)), 'b1a')
        c('Branch_1.Conv2d_0b_3x3', ConvBnRelu(32, 32, (3, 3)), 'b1b')
        c('Branch_2.Conv2d_0a_1x1', ConvBnRelu(cin, 32, (1, 1)), 'b2a')
        c('Branch_2.Conv2d_0b_3x3', ConvBnRelu(32, 32, (3, 3)), 'b2b')
        c('Branch_2.Conv2d_0c_3x3', ConvBnRelu(32, 32, (3, 3)), 'b2c')

    def forward(self, x):
        return self.residual(x, [self.b0(x), self.b1b(self.b1a(x)),
                                 self.b2c(self.b2b(self.b2a(x)))])


class Block17(_Residual):
    """Inception-ResNet-B block."""

    def __init__(self, cin, scale=0.10, activation='relu'):
        super().__init__(cin, 256, scale, activation)
        c = self.child
        c('Branch_0.Conv2d_1x1', ConvBnRelu(cin, 128, (1, 1)), 'b0')
        c('Branch_1.Conv2d_0a_1x1', ConvBnRelu(cin, 128, (1, 1)), 'b1a')
        c('Branch_1.Conv2d_0b_1x7', ConvBnRelu(128, 128, (1, 7)), 'b1b')
        c('Branch_1.Conv2d_0c_7x1', ConvBnRelu(128, 128, (7, 1)), 'b1c')

    def forward(self, x):
        return self.residual(x, [self.b0(x), self.b1c(self.b1b(self.b1a(x)))])


class Block8(_Residual):
    """Inception-ResNet-C block."""

    def __init__(self, cin, scale=0.2, activation='relu'):
        super().__init__(cin, 384, scale, activation)
        c = self.child
        c('Branch_0.Conv2d_1x1', ConvBnRelu(cin, 192, (1, 1)), 'b0')
        c('Branch_1.Conv2d_0a_1x1', ConvBnRelu(cin, 192, (1, 1)), 'b1a')
        c('Branch_1.Conv2d_0b_1x3', ConvBnRelu(192, 192, (1, 3)), 'b1b')
        c('Branch_1.Conv2d_0c_3x1', ConvBnRelu(192, 192, (3, 1)), 'b1c')

    def forward(self, x):
        return self.residual(x, [self.b0(x), self.b1c(self.b1b(self.b1a(x)))])


class ReductionA(_Flax):
    """17x17 -> 8x8 grid reduction."""

    def __init__(self, cin, filters=((384,), (192, 192, 256))):
        super().__init__()
        (f0,), (f1a, f1b, f1c) = filters
        c = self.child
        c('Branch_0.Conv2d_1a_3x3',
          ConvBnRelu(cin, f0, (3, 3), 2, 'VALID'), 'b0')
        c('Branch_1.Conv2d_0a_1x1', ConvBnRelu(cin, f1a, (1, 1)), 'b1a')
        c('Branch_1.Conv2d_0b_3x3', ConvBnRelu(f1a, f1b, (3, 3)), 'b1b')
        c('Branch_1.Conv2d_1a_3x3',
          ConvBnRelu(f1b, f1c, (3, 3), 2, 'VALID'), 'b1c')
        self.cout = f0 + f1c + cin

    def forward(self, x):
        return torch.cat([self.b0(x), self.b1c(self.b1b(self.b1a(x))),
                          F.max_pool2d(x, 3, 2)], dim=1)


class ReductionB(_Flax):
    """8x8 -> 3x3 grid reduction."""

    def __init__(self, cin, filters=((256, 384), (256, 256), (256, 256, 256))):
        super().__init__()
        (f0a, f0b), (f1a, f1b), (f2a, f2b, f2c) = filters
        c = self.child
        c('Branch_0.Conv2d_0a_1x1', ConvBnRelu(cin, f0a, (1, 1)), 'b0a')
        c('Branch_0.Conv2d_1a_3x3',
          ConvBnRelu(f0a, f0b, (3, 3), 2, 'VALID'), 'b0b')
        c('Branch_1.Conv2d_0a_1x1', ConvBnRelu(cin, f1a, (1, 1)), 'b1a')
        c('Branch_1.Conv2d_1a_3x3',
          ConvBnRelu(f1a, f1b, (3, 3), 2, 'VALID'), 'b1b')
        c('Branch_2.Conv2d_0a_1x1', ConvBnRelu(cin, f2a, (1, 1)), 'b2a')
        c('Branch_2.Conv2d_0b_3x3', ConvBnRelu(f2a, f2b, (3, 3)), 'b2b')
        c('Branch_2.Conv2d_1a_3x3',
          ConvBnRelu(f2b, f2c, (3, 3), 2, 'VALID'), 'b2c')
        self.cout = f0b + f1b + f2c + cin

    def forward(self, x):
        return torch.cat([self.b0b(self.b0a(x)), self.b1b(self.b1a(x)),
                          self.b2c(self.b2b(self.b2a(x))),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionResnetV1(_Flax):
    """The full embedding network, eval mode: uint8 NHWC images in,
    [B, output.size] float32 embeddings out (L2-normalized unless
    ``normalize=False``)."""

    def __init__(self, config=None, image_size=160, normalization=0):
        super().__init__()
        cfg = check_input_config(config)
        self.cfg = cfg
        self.image_size = int(image_size)
        self.normalization = int(normalization)
        c = self.child

        stem = [('Conv2d_1a_3x3', 3, 32, 2), ('Conv2d_2a_3x3', 32, 32, 1),
                ('Conv2d_2b_3x3', 32, 64, 1)]
        self.stem1 = [c(n, ConvBnRelu(i, o, (3, 3), s, 'VALID'))
                      for n, i, o, s in stem]
        self.stem2 = [c('Conv2d_3b_1x1', ConvBnRelu(64, 80, (1, 1), 1, 'VALID')),
                      c('Conv2d_4a_3x3', ConvBnRelu(80, 192, (3, 3), 1, 'VALID')),
                      c('Conv2d_4b_3x3', ConvBnRelu(192, 256, (3, 3), 2, 'VALID'))]

        self.blocks35 = [
            c(f'Repeat.block35_{i + 1}',
              Block35(256, cfg.block35.scale, cfg.block35.activation))
            for i in range(int(cfg.block35.repeat))]
        filters = tuple(tuple(f) for f in cfg.reduction_a.filters)
        c('Mixed_6a', ReductionA(256, filters), 'reduction_a')
        ch = self.reduction_a.cout
        self.blocks17 = [
            c(f'Repeat_1.block17_{i + 1}',
              Block17(ch, cfg.block17.scale, cfg.block17.activation))
            for i in range(int(cfg.block17.repeat))]
        filters = tuple(tuple(f) for f in cfg.reduction_b.filters)
        c('Mixed_7a', ReductionB(ch, filters), 'reduction_b')
        ch = self.reduction_b.cout
        self.blocks8 = [
            c(f'Repeat_2.block8_{i + 1}',
              Block8(ch, cfg.block8_1.scale, cfg.block8_1.activation))
            for i in range(int(cfg.block8_1.repeat))]
        c('Block8', Block8(ch, cfg.block8_2.scale, cfg.block8_2.activation),
          'block8_final')

        side = _valid(self.image_size) - 4       # Conv2d_1a /2, 2a, 2b
        side = _valid(_valid(side) - 2)           # MaxPool /2, 4a, 4b /2
        side = _valid(_valid(side))               # Mixed_6a, Mixed_7a
        side = _valid(side, 3, 3)                 # head avg pool
        size = int(cfg.output.size)
        c('Bottleneck', Dense(ch * side * side, size), 'bottleneck')
        c('Bottleneck.bn', BatchNorm(size), 'bottleneck_bn')

    def forward(self, images, normalize=True):
        """[B,H,W,3] uint8 (or float) -> [B, output.size] float32."""
        dtype = self.bottleneck.weight.dtype
        x = image_processing(images, self.image_size, self.normalization,
                             dtype=dtype).permute(0, 3, 1, 2)
        for layer in self.stem1:
            x = layer(x)
        x = F.max_pool2d(x, 3, 2)
        for layer in self.stem2:
            x = layer(x)
        for block in self.blocks35:
            x = block(x)
        x = self.reduction_a(x)
        for block in self.blocks17:
            x = block(x)
        x = self.reduction_b(x)
        for block in self.blocks8:
            x = block(x)
        x = self.block8_final(x)

        x = F.avg_pool2d(x, 3, 3)
        x = x.permute(0, 2, 3, 1).flatten(1)        # NHWC flatten order
        x = self.bottleneck_bn(self.bottleneck(x)).float()
        if normalize:
            norm = torch.sqrt(torch.clamp(
                x.square().sum(dim=1, keepdim=True), min=1e-10))
            x = x / norm
        return x

    def from_flax_variables(self, variables):
        """Load a flax ``{'params', 'batch_stats'}`` tree of numpy arrays."""
        self.load_flax(variables['params'], variables['batch_stats'])
        return self


def init_variables(config=None, seed=0, image_size=160):
    """A numpy ``{'params', 'batch_stats'}`` tree with the flax init's keys
    and shapes: glorot-uniform kernels, zero biases, BN mean 0 / var 1."""
    model = InceptionResnetV1(config, image_size=image_size)
    params, stats = model.flax_variables(np.random.RandomState(seed))
    return {'params': params, 'batch_stats': stats}
