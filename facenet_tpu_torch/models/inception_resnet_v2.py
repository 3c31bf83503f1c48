"""Inception-ResNet-v2 embedding network (PyTorch).

The architecture of ``facenet_tpu.models.inception_resnet_v2`` with the same
flax names (its module docstring gives the reference lines), built from the
IRv1 module's pieces, so a flax ``{'params', 'batch_stats'}`` tree loads
into it directly (`from_flax_variables`) and `init_variables` makes one
without JAX:

  stem: conv32 s2 VALID, conv32 VALID, conv64 SAME, maxpool 3/2, conv80
  1x1, conv192 3x3 VALID, maxpool 3/2; Mixed_5a (four branches from the
  config, the last on a 3x3 SAME average pool that counts the padding);
  10x Block35 scale .17; Mixed_6a; 20x Block17 scale .10; Mixed_7a; 9x
  Block8 scale .2 + a final Block8 scale 1 without activation; Conv2d_7b
  1536 1x1; global average pool -> Dense (no bias) -> BatchNorm; L2
  normalization with eps 1e-10 at inference.

BatchNorm is center-only with eps 1e-3, the Bottleneck's included; it is
the IRv1 module's `BatchNorm` with the reference's decay 0.995, so with
``train=True`` it normalizes with the batch's statistics (the global
batch's on a process grid, `set_batch_group`) and moves the running ones.
In training, dropout at rate 1 - keep_probability sits between the
average pool and the Bottleneck: kept entries are divided by the keep
probability and the rest zeroed, as flax's Dropout does; the caller
draws the mask from its own torch.Generator (`dropout_mask`), never from
torch's global RNG. At inference dropout is the identity. The Mixed
blocks' convs are top-level children with dotted flax names
('Mixed_5a.Branch_0.Conv2d_1x1'), as in the flax module.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from facenet_tpu_torch.config import Config, value_or
from facenet_tpu_torch.models.inception_resnet_v1 import (BatchNorm,
                                                           ConvBnRelu, Dense,
                                                           _Flax, _Residual)
from facenet_tpu_torch.ops.preprocessing import image_processing

BN_MOMENTUM_V2 = 0.995    # the reference's slim batch_norm decay

# reference models/configs/inception_resnet_v2.yaml
default_config = {
    'mixed_5a': {'branch': [[96], [48, 64], [64, 96, 96], [64]]},
    'mixed_6a': {'branch': [[384], [256, 256, 384]]},
    'mixed_7a': {'branch': [[256, 384], [256, 288], [256, 288, 320]]},
    'repeat': [10, 20, 9],
    'embedding_size': 512,
    'keep_probability': 0.8,
    'weight_decay': 0.0005,
}


def check_input_config(cfg=None):
    """Fill missing model-config fields with the defaults."""
    base = Config(default_config)
    if cfg is None:
        return base
    if not isinstance(cfg, Config):
        cfg = Config(cfg)
    base.update(cfg)
    return base


def _cbr(cin, cout, kernel=(1, 1), stride=1, padding='SAME', relu=True):
    """A ConvBnRelu with the v2 BatchNorm decay."""
    return ConvBnRelu(cin, cout, kernel, stride, padding, relu,
                      momentum=BN_MOMENTUM_V2)


class Block35V2(_Residual):
    """35x35 resnet block."""

    def __init__(self, cin, scale=0.17, activation='relu'):
        super().__init__(cin, 128, scale, activation)
        c = self.child
        c('Branch_0.Conv2d_1x1', _cbr(cin, 32), 'b0')
        c('Branch_1.Conv2d_0a_1x1', _cbr(cin, 32), 'b1a')
        c('Branch_1.Conv2d_0b_3x3', _cbr(32, 32, (3, 3)), 'b1b')
        c('Branch_2.Conv2d_0a_1x1', _cbr(cin, 32), 'b2a')
        c('Branch_2.Conv2d_0b_3x3', _cbr(32, 48, (3, 3)), 'b2b')
        c('Branch_2.Conv2d_0c_3x3', _cbr(48, 64, (3, 3)), 'b2c')

    def forward(self, x, train=False):
        t = train
        return self.residual(x, [self.b0(x, t), self.b1b(self.b1a(x, t), t),
                                 self.b2c(self.b2b(self.b2a(x, t), t), t)])


class Block17V2(_Residual):
    """17x17 resnet block."""

    def __init__(self, cin, scale=0.10, activation='relu'):
        super().__init__(cin, 384, scale, activation)
        c = self.child
        c('Branch_0.Conv2d_1x1', _cbr(cin, 192), 'b0')
        c('Branch_1.Conv2d_0a_1x1', _cbr(cin, 128), 'b1a')
        c('Branch_1.Conv2d_0b_1x7', _cbr(128, 160, (1, 7)), 'b1b')
        c('Branch_1.Conv2d_0c_7x1', _cbr(160, 192, (7, 1)), 'b1c')

    def forward(self, x, train=False):
        t = train
        return self.residual(x, [self.b0(x, t),
                                 self.b1c(self.b1b(self.b1a(x, t), t), t)])


class Block8V2(_Residual):
    """8x8 resnet block."""

    def __init__(self, cin, scale=0.2, activation='relu'):
        super().__init__(cin, 448, scale, activation)
        c = self.child
        c('Branch_0.Conv2d_1x1', _cbr(cin, 192), 'b0')
        c('Branch_1.Conv2d_0a_1x1', _cbr(cin, 192), 'b1a')
        c('Branch_1.Conv2d_0b_1x3', _cbr(192, 224, (1, 3)), 'b1b')
        c('Branch_1.Conv2d_0c_3x1', _cbr(224, 256, (3, 1)), 'b1c')

    def forward(self, x, train=False):
        t = train
        return self.residual(x, [self.b0(x, t),
                                 self.b1c(self.b1b(self.b1a(x, t), t), t)])


class InceptionResnetV2(_Flax):
    """The full embedding network: uint8 NHWC images in, [B,
    embedding_size] float32 embeddings out, L2-normalized at inference."""

    def __init__(self, config=None, image_size=160, normalization=0):
        super().__init__()
        cfg = check_input_config(config)
        self.config = config            # as given; a bundle records it
        self.cfg = cfg
        self.image_size = int(image_size)
        self.normalization = int(normalization)
        # flax's Dropout(rate=1 - keep): kept entries divided by 1 - rate
        keep = float(cfg.keep_probability or 0.8)
        self.keep = 1.0 - (1.0 - keep)
        c = self.child

        self.stem1 = [
            c('Conv2d_1a_3x3', _cbr(3, 32, (3, 3), 2, 'VALID')),
            c('Conv2d_2a_3x3', _cbr(32, 32, (3, 3), 1, 'VALID')),
            c('Conv2d_2b_3x3', _cbr(32, 64, (3, 3), 1, 'SAME'))]
        self.stem2 = [
            c('Conv2d_3b_1x1', _cbr(64, 80, (1, 1), 1, 'VALID')),
            c('Conv2d_4a_3x3', _cbr(80, 192, (3, 3), 1, 'VALID'))]

        (f0,), (f1a, f1b), (f2a, f2b, f2c), (f3,) = cfg.mixed_5a.branch
        m = 'Mixed_5a.'
        c(m + 'Branch_0.Conv2d_1x1', _cbr(192, f0, (1, 1)), 'm5a_b0')
        c(m + 'Branch_1.Conv2d_0a_1x1', _cbr(192, f1a, (1, 1)),
          'm5a_b1a')
        c(m + 'Branch_1.Conv2d_0b_5x5', _cbr(f1a, f1b, (5, 5)),
          'm5a_b1b')
        c(m + 'Branch_2.Conv2d_0a_1x1', _cbr(192, f2a, (1, 1)),
          'm5a_b2a')
        c(m + 'Branch_2.Conv2d_0b_3x3', _cbr(f2a, f2b, (3, 3)),
          'm5a_b2b')
        c(m + 'Branch_2.Conv2d_0c_3x3', _cbr(f2b, f2c, (3, 3)),
          'm5a_b2c')
        c(m + 'Branch_3.Conv2d_0b_1x1', _cbr(192, f3, (1, 1)),
          'm5a_b3')
        ch = f0 + f1b + f2c + f3

        repeat = [int(r) for r in cfg.repeat]
        self.blocks35 = [c(f'Repeat.block35_{i + 1}', Block35V2(ch))
                         for i in range(repeat[0])]

        (f0,), (f1a, f1b, f1c) = cfg.mixed_6a.branch
        m = 'Mixed_6a.'
        c(m + 'Branch_0.Conv2d_1a_3x3', _cbr(ch, f0, (3, 3), 2, 'VALID'),
          'm6a_b0')
        c(m + 'Branch_1.Conv2d_0a_1x1', _cbr(ch, f1a, (1, 1)), 'm6a_b1a')
        c(m + 'Branch_1.Conv2d_0b_3x3', _cbr(f1a, f1b, (3, 3)),
          'm6a_b1b')
        c(m + 'Branch_1.Conv2d_1a_3x3',
          _cbr(f1b, f1c, (3, 3), 2, 'VALID'), 'm6a_b1c')
        ch += f0 + f1c

        self.blocks17 = [c(f'Repeat_1.block17_{i + 1}', Block17V2(ch))
                         for i in range(repeat[1])]

        (f0a, f0b), (f1a, f1b), (f2a, f2b, f2c) = cfg.mixed_7a.branch
        m = 'Mixed_7a.'
        c(m + 'Branch_0.Conv2d_0a_1x1', _cbr(ch, f0a, (1, 1)), 'm7a_b0a')
        c(m + 'Branch_0.Conv2d_1a_3x3',
          _cbr(f0a, f0b, (3, 3), 2, 'VALID'), 'm7a_b0b')
        c(m + 'Branch_1.Conv2d_0a_1x1', _cbr(ch, f1a, (1, 1)), 'm7a_b1a')
        c(m + 'Branch_1.Conv2d_1a_3x3',
          _cbr(f1a, f1b, (3, 3), 2, 'VALID'), 'm7a_b1b')
        c(m + 'Branch_2.Conv2d_0a_1x1', _cbr(ch, f2a, (1, 1)), 'm7a_b2a')
        c(m + 'Branch_2.Conv2d_0b_3x3', _cbr(f2a, f2b, (3, 3)),
          'm7a_b2b')
        c(m + 'Branch_2.Conv2d_1a_3x3',
          _cbr(f2b, f2c, (3, 3), 2, 'VALID'), 'm7a_b2c')
        ch += f0b + f1b + f2c

        self.blocks8 = [c(f'Repeat_2.block8_{i + 1}', Block8V2(ch))
                        for i in range(repeat[2])]
        c('Block8', Block8V2(ch, scale=1.0, activation=None), 'block8_final')
        c('Conv2d_7b_1x1', _cbr(ch, 1536, (1, 1)), 'conv_7b')

        size = int(cfg.embedding_size)
        c('Bottleneck', Dense(1536, size), 'bottleneck')
        c('Bottleneck.bn', BatchNorm(size, BN_MOMENTUM_V2), 'bottleneck_bn')

    @property
    def embedding_size(self):
        return int(self.cfg.embedding_size)

    def dropout_mask(self, batch, generator):
        """The keep mask of one training forward: bool [batch, 1536] on the
        CPU, an entry kept with the keep probability (``uniform <
        keep``, drawn from `generator`, a CPU torch.Generator); None when
        the keep probability is 1 (no dropout)."""
        if self.keep >= 1.0:
            return None
        width = self.conv_7b.cout
        return torch.rand((int(batch), width), generator=generator) \
            < self.keep

    def forward(self, images, train=False, normalize=None, dtype=None,
                dropout=None):
        """[B,H,W,3] uint8 (or float) -> [B, embedding_size] float32.

        :param train: BatchNorm on the batch's statistics, moving the
            running ones, and dropout before the Bottleneck
        :param normalize: L2-normalize the output; defaults to ``not
            train``
        :param dtype: the compute dtype; defaults to the weights' dtype
        :param dropout: in training with a keep probability below 1, the
            keep mask, a bool [B, 1536] tensor (`dropout_mask`)
        :raises ValueError: in training with dropout on and no mask
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
        x = F.max_pool2d(x, 3, 2)

        tp = F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)
        x = torch.cat([self.m5a_b0(x, t), self.m5a_b1b(self.m5a_b1a(x, t), t),
                       self.m5a_b2c(self.m5a_b2b(self.m5a_b2a(x, t), t), t),
                       self.m5a_b3(tp, t)], dim=1)
        for block in self.blocks35:
            x = block(x, t)

        x = torch.cat([self.m6a_b0(x, t),
                       self.m6a_b1c(self.m6a_b1b(self.m6a_b1a(x, t), t), t),
                       F.max_pool2d(x, 3, 2)], dim=1)
        for block in self.blocks17:
            x = block(x, t)

        x = torch.cat([self.m7a_b0b(self.m7a_b0a(x, t), t),
                       self.m7a_b1b(self.m7a_b1a(x, t), t),
                       self.m7a_b2c(self.m7a_b2b(self.m7a_b2a(x, t), t), t),
                       F.max_pool2d(x, 3, 2)], dim=1)
        for block in self.blocks8:
            x = block(x, t)
        x = self.conv_7b(self.block8_final(x, t), t)

        x = x.mean(dim=(2, 3))
        if train and self.keep < 1.0:
            x = self._dropout(x, dropout)
        x = self.bottleneck_bn(self.bottleneck(x), t).float()
        if normalize is None:
            normalize = not train
        if normalize:
            norm = torch.sqrt(torch.clamp(
                x.square().sum(dim=1, keepdim=True), min=1e-10))
            x = x / norm
        return x

    def _dropout(self, x, mask):
        if mask is None:
            raise ValueError(
                f'training with keep_probability {self.keep} needs a '
                'dropout mask')
        mask = mask.to(x.device)
        return torch.where(mask, x / self.keep, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))

    def from_flax_variables(self, variables):
        """Load a flax ``{'params', 'batch_stats'}`` tree of numpy arrays."""
        self.load_flax(variables['params'], variables['batch_stats'])
        return self


def create_model(model_cfg=None, image_cfg=None, dtype=None):
    """An InceptionResnetV2 from the model zoo's config objects: the
    topology dict and the ``image`` section (size 160, normalization 0 by
    default). `dtype` is accepted for the zoo's signature and not stored:
    the port picks the compute dtype at each call (``forward(dtype=...)``,
    else the weights' dtype)."""
    image_cfg = image_cfg or Config({'size': 160, 'normalization': 0})
    return InceptionResnetV2(
        config=model_cfg, image_size=int(image_cfg.size or 160),
        # normalization 0 is a mode of its own, so no `or`
        normalization=int(value_or(image_cfg.normalization, 0)))


def init_variables(config=None, seed=0, image_size=160):
    """A numpy ``{'params', 'batch_stats'}`` tree with the flax init's keys
    and shapes: glorot-uniform kernels, zero biases, BN mean 0 / var 1."""
    model = InceptionResnetV2(config, image_size=image_size)
    params, stats = model.flax_variables(np.random.RandomState(seed))
    return {'params': params, 'batch_stats': stats}
