"""Inception-ResNet-v1 embedding network (PyTorch).

The architecture of ``facenet_tpu.models.inception_resnet_v1`` with the same
submodule names, so a flax ``{'params', 'batch_stats'}`` tree loads into it
directly (`from_flax_variables`) and `init_variables` can make such a tree
without JAX:

  stem: 6 convs + maxpool; 5x Block35 scale .17; ReductionA; 10x Block17
  scale .10; ReductionB; 5x Block8 scale .2 + a final Block8 scale 1 without
  activation; head AvgPool 3x3 -> Dense (no bias) -> BatchNorm; L2
  normalization with eps 1e-10 at inference.

BatchNorm is center-only (a trainable bias, no scale) with eps 1e-3. At
inference it runs on its running statistics; with ``train=True`` it
normalizes with the batch's statistics as flax 0.12 computes them
(reductions in at least float32, the biased variance max(0, E[x^2] - E[x]^2)) and moves the
running statistics by ra = 0.99 ra + 0.01 batch. On a process grid
(`set_batch_group`) the batch's statistics are the global batch's: one
all_reduce per layer of (sum x, sum x^2) over the data ranks, through which
the backward runs as well. Every conv and dense
kernel carries L2(5e-4) weight decay, added to the loss by
`l2_regularization`.

Each layer computes in the dtype of its input and casts its parameters to
it, as flax's ``dtype``/``param_dtype`` split does: float32 parameters
with a bfloat16 input run the layer in bfloat16 (BatchNorm's arithmetic in
float32, its output rounded to the input's dtype).

Flax names hold dots ('Repeat.block35_1'), which torch forbids in module
names, so each child is registered under an attribute name and keeps its
flax name beside it; `from_flax_variables` loads a flax tree and
`to_flax_variables` writes the current weights as one. Activations are
NCHW inside; the public forward takes NHWC images.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facenet_tpu_torch.config import Config, value_or
from facenet_tpu_torch.ops.preprocessing import image_processing
from facenet_tpu_torch.parallel.mesh import group_size, sum_over

default_config = {
    'reduction_a': {'filters': [[384], [192, 192, 256]]},
    'reduction_b': {'filters': [[256, 384], [256, 256], [256, 256, 256]]},
    'block35': {'repeat': 5, 'scale': 0.17, 'activation': 'relu'},
    'block17': {'repeat': 10, 'scale': 0.10, 'activation': 'relu'},
    'block8_1': {'repeat': 5, 'scale': 0.2, 'activation': 'relu'},
    'block8_2': {'scale': 1.0, 'activation': None},
    'output': {'size': 512},
}

WEIGHT_DECAY = 0.0005  # L2(5e-4) on every conv and dense kernel
BN_EPS = 1e-3
BN_MOMENTUM = 0.99


def check_input_config(cfg=None):
    """Fill missing model-config fields with the defaults."""
    base = Config(default_config)
    if cfg is None:
        return base
    if not isinstance(cfg, Config):
        cfg = Config(cfg)
    base.update(cfg)
    return base


def glorot_uniform(rng, shape):
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

    def dump_flax(self):
        """The current weights as flax (params, batch_stats) trees."""
        params, stats = {}, {}
        for name, module in self.named_flax_children():
            p, s = module.dump_flax()
            params[name] = p
            if s:
                stats[name] = s
        return params, stats

    def to_flax_variables(self):
        """The current weights as a flax ``{'params', 'batch_stats'}`` tree
        of float32 numpy arrays, float64 for a float64 model (the reverse of
        `from_flax_variables`)."""
        params, stats = self.dump_flax()
        return {'params': params, 'batch_stats': stats}


def _copy(param, array):
    wide = np.float64 if param.dtype == torch.float64 else np.float32
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(array, wide)))


def _numpy(tensor):
    """float64 tensors as float64 arrays, any other float as float32."""
    tensor = tensor.detach()
    if tensor.dtype != torch.float64:
        tensor = tensor.float()
    return tensor.cpu().numpy().copy()


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
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding)

    def load_flax(self, params, stats=None):
        _copy(self.weight, np.transpose(params['kernel'], (3, 2, 0, 1)))
        if self.bias is not None:
            _copy(self.bias, params['bias'])

    def flax_variables(self, rng):
        cout, cin = self.weight.shape[:2]
        params = {'kernel': glorot_uniform(rng, self.kernel + (cin, cout))}
        if self.bias is not None:
            params['bias'] = np.zeros((cout,), np.float32)
        return params, {}

    def dump_flax(self):
        params = {'kernel': _numpy(self.weight.permute(2, 3, 1, 0))}
        if self.bias is not None:
            params['bias'] = _numpy(self.bias)
        return params, {}


class Dense(nn.Module):
    """Dense layer holding a flax [in, out] kernel as [out, in]; bias-free
    unless ``bias=True``."""

    def __init__(self, cin, cout, bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)

    def load_flax(self, params, stats=None):
        _copy(self.weight, np.transpose(params['kernel']))
        if self.bias is not None:
            _copy(self.bias, params['bias'])

    def flax_variables(self, rng):
        cout, cin = self.weight.shape
        params = {'kernel': glorot_uniform(rng, (cin, cout))}
        if self.bias is not None:
            params['bias'] = np.zeros((cout,), np.float32)
        return params, {}

    def dump_flax(self):
        params = {'kernel': _numpy(self.weight.T)}
        if self.bias is not None:
            params['bias'] = _numpy(self.bias)
        return params, {}


class BatchNorm(nn.Module):
    """Center-only BatchNorm over axis 1: running statistics at inference,
    the batch's in training (see the module docstring).

    `momentum` is the running statistics' decay (0.99 here, 0.995 in
    Inception-ResNet-v2). `update_running` false keeps the running
    statistics as they are in a train-mode forward (a recomputing backward sets it, so that one step
    moves them once).

    `group` (a data group of the process grid, None on one rank) makes the
    train-mode statistics the global batch's (`global_batch_statistics`).
    The recomputing forward then reuses the sums of the step's first
    forward instead of reducing them a second time."""

    def __init__(self, features, momentum=BN_MOMENTUM):
        super().__init__()
        self.momentum = float(momentum)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))
        self.update_running = True
        self.group = None
        self._sums = None

    def forward(self, x, train=False):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if train:
            if self.group is None:
                mean, var = batch_statistics(x)
            else:
                reuse = None if self.update_running else self._sums
                mean, var, sums = global_batch_statistics(x, self.group,
                                                          reuse)
                self._sums = sums.detach()
            if self.update_running:
                m = self.momentum
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        scale = torch.rsqrt(var + BN_EPS)
        y = (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    def load_flax(self, params, stats):
        _copy(self.bias, params['bias'])
        _copy(self.mean, stats['mean'])
        _copy(self.var, stats['var'])

    def flax_variables(self, rng):
        n = self.bias.shape[0]
        return ({'bias': np.zeros((n,), np.float32)},
                {'mean': np.zeros((n,), np.float32),
                 'var': np.ones((n,), np.float32)})

    def dump_flax(self):
        return ({'bias': _numpy(self.bias)},
                {'mean': _numpy(self.mean), 'var': _numpy(self.var)})


def batch_statistics(x):
    """Per-channel (mean, biased variance) of an NC... tensor over every
    axis but 1, as flax's BatchNorm computes them: reductions in at least
    float32 and var = max(0, E[x^2] - E[x]^2)."""
    axes = [0] + list(range(2, x.ndim))
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x.mean(dim=axes)
    mean2 = x.square().mean(dim=axes)
    var = torch.maximum(mean2 - mean.square(),
                        torch.zeros((), dtype=mean.dtype, device=mean.device))
    return mean, var


def global_batch_statistics(x, group, reuse=None):
    """`batch_statistics` over the global batch whose rows the ranks of
    `group` hold in equal parts: (mean, biased variance, the reduced sums).

    Each rank's per-channel (sum x, sum x^2) go through one all_reduce
    (`parallel.mesh.sum_over`, whose backward sums the gradient over the
    ranks, so the backward is global too); `reuse`, the sums an earlier
    forward of the step reduced, stands in for that all_reduce."""
    axes = [0] + list(range(2, x.ndim))
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    local = torch.cat([x.sum(dim=axes), x.square().sum(dim=axes)])
    sums = sum_over(local, group, reuse)
    count = x.numel() // x.shape[1] * group_size(group)
    mean, mean2 = (sums / count).chunk(2)
    var = torch.maximum(mean2 - mean.square(),
                        torch.zeros((), dtype=mean.dtype, device=mean.device))
    return mean, var, sums


def set_batch_group(module, group):
    """Every BatchNorm under `module` takes its train-mode statistics over
    the global batch of `group` (None: its own batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class ConvBnRelu(_Flax):
    """Conv (no bias) -> BatchNorm(center, no scale) -> optional ReLU."""

    def __init__(self, cin, cout, kernel=(3, 3), stride=1, padding='SAME',
                 relu=True, momentum=BN_MOMENTUM):
        super().__init__()
        self.relu = relu
        self.cout = cout
        self.child('conv', Conv(cin, cout, kernel, stride, padding))
        self.child('bn', BatchNorm(cout, momentum))

    def forward(self, x, train=False):
        x = self.bn(self.conv(x), train)
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

    def forward(self, x, train=False):
        t = train
        return self.residual(x, [self.b0(x, t), self.b1b(self.b1a(x, t), t),
                                 self.b2c(self.b2b(self.b2a(x, t), t), t)])


class Block17(_Residual):
    """Inception-ResNet-B block."""

    def __init__(self, cin, scale=0.10, activation='relu'):
        super().__init__(cin, 256, scale, activation)
        c = self.child
        c('Branch_0.Conv2d_1x1', ConvBnRelu(cin, 128, (1, 1)), 'b0')
        c('Branch_1.Conv2d_0a_1x1', ConvBnRelu(cin, 128, (1, 1)), 'b1a')
        c('Branch_1.Conv2d_0b_1x7', ConvBnRelu(128, 128, (1, 7)), 'b1b')
        c('Branch_1.Conv2d_0c_7x1', ConvBnRelu(128, 128, (7, 1)), 'b1c')

    def forward(self, x, train=False):
        t = train
        return self.residual(x, [self.b0(x, t),
                                 self.b1c(self.b1b(self.b1a(x, t), t), t)])


class Block8(_Residual):
    """Inception-ResNet-C block."""

    def __init__(self, cin, scale=0.2, activation='relu'):
        super().__init__(cin, 384, scale, activation)
        c = self.child
        c('Branch_0.Conv2d_1x1', ConvBnRelu(cin, 192, (1, 1)), 'b0')
        c('Branch_1.Conv2d_0a_1x1', ConvBnRelu(cin, 192, (1, 1)), 'b1a')
        c('Branch_1.Conv2d_0b_1x3', ConvBnRelu(192, 192, (1, 3)), 'b1b')
        c('Branch_1.Conv2d_0c_3x1', ConvBnRelu(192, 192, (3, 1)), 'b1c')

    def forward(self, x, train=False):
        t = train
        return self.residual(x, [self.b0(x, t),
                                 self.b1c(self.b1b(self.b1a(x, t), t), t)])


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

    def forward(self, x, train=False):
        t = train
        return torch.cat([self.b0(x, t),
                          self.b1c(self.b1b(self.b1a(x, t), t), t),
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

    def forward(self, x, train=False):
        t = train
        return torch.cat([self.b0b(self.b0a(x, t), t),
                          self.b1b(self.b1a(x, t), t),
                          self.b2c(self.b2b(self.b2a(x, t), t), t),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionResnetV1(_Flax):
    """The full embedding network: uint8 NHWC images in, [B, output.size]
    float32 embeddings out, L2-normalized at inference."""

    def __init__(self, config=None, image_size=160, normalization=0):
        super().__init__()
        cfg = check_input_config(config)
        self.config = config            # as given; a bundle records it
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

    def forward(self, images, train=False, normalize=None, dtype=None):
        """[B,H,W,3] uint8 (or float) -> [B, output.size] float32.

        :param train: BatchNorm on the batch's statistics, moving the
            running ones (see the module docstring)
        :param normalize: L2-normalize the output; defaults to ``not
            train`` (False reads the raw bottleneck)
        :param dtype: the compute dtype; defaults to the weights' dtype
        """
        dtype = dtype or self.bottleneck.weight.dtype
        t = train
        x = image_processing(images, self.image_size, self.normalization,
                             dtype=dtype).permute(0, 3, 1, 2)
        for layer in self.stem1:
            x = layer(x, t)
        x = F.max_pool2d(x, 3, 2)
        for layer in self.stem2:
            x = layer(x, t)
        for block in self.blocks35:
            x = block(x, t)
        x = self.reduction_a(x, t)
        for block in self.blocks17:
            x = block(x, t)
        x = self.reduction_b(x, t)
        for block in self.blocks8:
            x = block(x, t)
        x = self.block8_final(x, t)

        x = F.avg_pool2d(x, 3, 3)
        x = x.permute(0, 2, 3, 1).flatten(1)        # NHWC flatten order
        x = self.bottleneck_bn(self.bottleneck(x), t).float()
        if normalize is None:
            normalize = not train
        if normalize:
            norm = torch.sqrt(torch.clamp(
                x.square().sum(dim=1, keepdim=True), min=1e-10))
            x = x / norm
        return x

    @property
    def embedding_size(self):
        return int(self.cfg.output.size)

    def from_flax_variables(self, variables):
        """Load a flax ``{'params', 'batch_stats'}`` tree of numpy arrays."""
        self.load_flax(variables['params'], variables['batch_stats'])
        return self


def create_model(model_cfg=None, image_cfg=None, dtype=None):
    """An InceptionResnetV1 from the model zoo's config objects: the
    topology dict and the ``image`` section (size 160, normalization 0 by
    default). `dtype` is accepted for the zoo's signature and not stored:
    the port picks the compute dtype at each call (``forward(dtype=...)``,
    else the weights' dtype)."""
    image_cfg = image_cfg or Config({'size': 160, 'normalization': 0})
    return InceptionResnetV1(
        config=model_cfg, image_size=int(image_cfg.size or 160),
        # normalization 0 is a mode of its own, so no `or`
        normalization=int(value_or(image_cfg.normalization, 0)))


def l2_regularization(module, weight_decay=WEIGHT_DECAY):
    """weight_decay * sum(w ** 2) over every conv and dense kernel under
    `module` (the leaves a flax tree names 'kernel'; biases and BatchNorm
    excluded), in float32; either Inception-ResNet family, head included
    when `module` holds one."""
    return weight_decay * torch.stack(
        [m.weight.float().square().sum() for m in module.modules()
         if isinstance(m, (Conv, Dense))]).sum()


def init_variables(config=None, seed=0, image_size=160):
    """A numpy ``{'params', 'batch_stats'}`` tree with the flax init's keys
    and shapes: glorot-uniform kernels, zero biases, BN mean 0 / var 1."""
    model = InceptionResnetV1(config, image_size=image_size)
    params, stats = model.flax_variables(np.random.RandomState(seed))
    return {'params': params, 'batch_stats': stats}
