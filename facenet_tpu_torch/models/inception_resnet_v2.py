"""Inception-ResNet-v2 embedding network, eval mode (PyTorch).

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

BatchNorm is center-only with eps 1e-3 on its running statistics, the
Bottleneck's included; dropout is the identity at inference. The Mixed
blocks' convs are top-level children with dotted flax names
('Mixed_5a.Branch_0.Conv2d_1x1'), as in the flax module.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from facenet_tpu_torch.config import Config
from facenet_tpu_torch.models.inception_resnet_v1 import (BatchNorm,
                                                           ConvBnRelu, Dense,
                                                           _Flax, _Residual)
from facenet_tpu_torch.ops.preprocessing import image_processing

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


class Block35V2(_Residual):
    """35x35 resnet block."""

    def __init__(self, cin, scale=0.17, activation='relu'):
        super().__init__(cin, 128, scale, activation)
        c = self.child
        c('Branch_0.Conv2d_1x1', ConvBnRelu(cin, 32, (1, 1)), 'b0')
        c('Branch_1.Conv2d_0a_1x1', ConvBnRelu(cin, 32, (1, 1)), 'b1a')
        c('Branch_1.Conv2d_0b_3x3', ConvBnRelu(32, 32, (3, 3)), 'b1b')
        c('Branch_2.Conv2d_0a_1x1', ConvBnRelu(cin, 32, (1, 1)), 'b2a')
        c('Branch_2.Conv2d_0b_3x3', ConvBnRelu(32, 48, (3, 3)), 'b2b')
        c('Branch_2.Conv2d_0c_3x3', ConvBnRelu(48, 64, (3, 3)), 'b2c')

    def forward(self, x):
        return self.residual(x, [self.b0(x), self.b1b(self.b1a(x)),
                                 self.b2c(self.b2b(self.b2a(x)))])


class Block17V2(_Residual):
    """17x17 resnet block."""

    def __init__(self, cin, scale=0.10, activation='relu'):
        super().__init__(cin, 384, scale, activation)
        c = self.child
        c('Branch_0.Conv2d_1x1', ConvBnRelu(cin, 192, (1, 1)), 'b0')
        c('Branch_1.Conv2d_0a_1x1', ConvBnRelu(cin, 128, (1, 1)), 'b1a')
        c('Branch_1.Conv2d_0b_1x7', ConvBnRelu(128, 160, (1, 7)), 'b1b')
        c('Branch_1.Conv2d_0c_7x1', ConvBnRelu(160, 192, (7, 1)), 'b1c')

    def forward(self, x):
        return self.residual(x, [self.b0(x), self.b1c(self.b1b(self.b1a(x)))])


class Block8V2(_Residual):
    """8x8 resnet block."""

    def __init__(self, cin, scale=0.2, activation='relu'):
        super().__init__(cin, 448, scale, activation)
        c = self.child
        c('Branch_0.Conv2d_1x1', ConvBnRelu(cin, 192, (1, 1)), 'b0')
        c('Branch_1.Conv2d_0a_1x1', ConvBnRelu(cin, 192, (1, 1)), 'b1a')
        c('Branch_1.Conv2d_0b_1x3', ConvBnRelu(192, 224, (1, 3)), 'b1b')
        c('Branch_1.Conv2d_0c_3x1', ConvBnRelu(224, 256, (3, 1)), 'b1c')

    def forward(self, x):
        return self.residual(x, [self.b0(x), self.b1c(self.b1b(self.b1a(x)))])


class InceptionResnetV2(_Flax):
    """The full embedding network, eval mode: uint8 NHWC images in,
    [B, embedding_size] float32 embeddings out (L2-normalized unless
    ``normalize=False``)."""

    def __init__(self, config=None, image_size=160, normalization=0):
        super().__init__()
        cfg = check_input_config(config)
        self.config = config            # as given; a bundle records it
        self.cfg = cfg
        self.image_size = int(image_size)
        self.normalization = int(normalization)
        c = self.child

        self.stem1 = [
            c('Conv2d_1a_3x3', ConvBnRelu(3, 32, (3, 3), 2, 'VALID')),
            c('Conv2d_2a_3x3', ConvBnRelu(32, 32, (3, 3), 1, 'VALID')),
            c('Conv2d_2b_3x3', ConvBnRelu(32, 64, (3, 3), 1, 'SAME'))]
        self.stem2 = [
            c('Conv2d_3b_1x1', ConvBnRelu(64, 80, (1, 1), 1, 'VALID')),
            c('Conv2d_4a_3x3', ConvBnRelu(80, 192, (3, 3), 1, 'VALID'))]

        (f0,), (f1a, f1b), (f2a, f2b, f2c), (f3,) = cfg.mixed_5a.branch
        m = 'Mixed_5a.'
        c(m + 'Branch_0.Conv2d_1x1', ConvBnRelu(192, f0, (1, 1)), 'm5a_b0')
        c(m + 'Branch_1.Conv2d_0a_1x1', ConvBnRelu(192, f1a, (1, 1)),
          'm5a_b1a')
        c(m + 'Branch_1.Conv2d_0b_5x5', ConvBnRelu(f1a, f1b, (5, 5)),
          'm5a_b1b')
        c(m + 'Branch_2.Conv2d_0a_1x1', ConvBnRelu(192, f2a, (1, 1)),
          'm5a_b2a')
        c(m + 'Branch_2.Conv2d_0b_3x3', ConvBnRelu(f2a, f2b, (3, 3)),
          'm5a_b2b')
        c(m + 'Branch_2.Conv2d_0c_3x3', ConvBnRelu(f2b, f2c, (3, 3)),
          'm5a_b2c')
        c(m + 'Branch_3.Conv2d_0b_1x1', ConvBnRelu(192, f3, (1, 1)),
          'm5a_b3')
        ch = f0 + f1b + f2c + f3

        repeat = [int(r) for r in cfg.repeat]
        self.blocks35 = [c(f'Repeat.block35_{i + 1}', Block35V2(ch))
                         for i in range(repeat[0])]

        (f0,), (f1a, f1b, f1c) = cfg.mixed_6a.branch
        m = 'Mixed_6a.'
        c(m + 'Branch_0.Conv2d_1a_3x3', ConvBnRelu(ch, f0, (3, 3), 2, 'VALID'),
          'm6a_b0')
        c(m + 'Branch_1.Conv2d_0a_1x1', ConvBnRelu(ch, f1a, (1, 1)), 'm6a_b1a')
        c(m + 'Branch_1.Conv2d_0b_3x3', ConvBnRelu(f1a, f1b, (3, 3)),
          'm6a_b1b')
        c(m + 'Branch_1.Conv2d_1a_3x3',
          ConvBnRelu(f1b, f1c, (3, 3), 2, 'VALID'), 'm6a_b1c')
        ch += f0 + f1c

        self.blocks17 = [c(f'Repeat_1.block17_{i + 1}', Block17V2(ch))
                         for i in range(repeat[1])]

        (f0a, f0b), (f1a, f1b), (f2a, f2b, f2c) = cfg.mixed_7a.branch
        m = 'Mixed_7a.'
        c(m + 'Branch_0.Conv2d_0a_1x1', ConvBnRelu(ch, f0a, (1, 1)), 'm7a_b0a')
        c(m + 'Branch_0.Conv2d_1a_3x3',
          ConvBnRelu(f0a, f0b, (3, 3), 2, 'VALID'), 'm7a_b0b')
        c(m + 'Branch_1.Conv2d_0a_1x1', ConvBnRelu(ch, f1a, (1, 1)), 'm7a_b1a')
        c(m + 'Branch_1.Conv2d_1a_3x3',
          ConvBnRelu(f1a, f1b, (3, 3), 2, 'VALID'), 'm7a_b1b')
        c(m + 'Branch_2.Conv2d_0a_1x1', ConvBnRelu(ch, f2a, (1, 1)), 'm7a_b2a')
        c(m + 'Branch_2.Conv2d_0b_3x3', ConvBnRelu(f2a, f2b, (3, 3)),
          'm7a_b2b')
        c(m + 'Branch_2.Conv2d_1a_3x3',
          ConvBnRelu(f2b, f2c, (3, 3), 2, 'VALID'), 'm7a_b2c')
        ch += f0b + f1b + f2c

        self.blocks8 = [c(f'Repeat_2.block8_{i + 1}', Block8V2(ch))
                        for i in range(repeat[2])]
        c('Block8', Block8V2(ch, scale=1.0, activation=None), 'block8_final')
        c('Conv2d_7b_1x1', ConvBnRelu(ch, 1536, (1, 1)), 'conv_7b')

        size = int(cfg.embedding_size)
        c('Bottleneck', Dense(1536, size), 'bottleneck')
        c('Bottleneck.bn', BatchNorm(size), 'bottleneck_bn')

    def forward(self, images, normalize=True):
        """[B,H,W,3] uint8 (or float) -> [B, embedding_size] float32."""
        dtype = self.bottleneck.weight.dtype
        x = image_processing(images, self.image_size, self.normalization,
                             dtype=dtype).permute(0, 3, 1, 2)
        for layer in self.stem1:
            x = layer(x)
        x = F.max_pool2d(x, 3, 2)
        for layer in self.stem2:
            x = layer(x)
        x = F.max_pool2d(x, 3, 2)

        tp = F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)
        x = torch.cat([self.m5a_b0(x), self.m5a_b1b(self.m5a_b1a(x)),
                       self.m5a_b2c(self.m5a_b2b(self.m5a_b2a(x))),
                       self.m5a_b3(tp)], dim=1)
        for block in self.blocks35:
            x = block(x)

        x = torch.cat([self.m6a_b0(x),
                       self.m6a_b1c(self.m6a_b1b(self.m6a_b1a(x))),
                       F.max_pool2d(x, 3, 2)], dim=1)
        for block in self.blocks17:
            x = block(x)

        x = torch.cat([self.m7a_b0b(self.m7a_b0a(x)),
                       self.m7a_b1b(self.m7a_b1a(x)),
                       self.m7a_b2c(self.m7a_b2b(self.m7a_b2a(x))),
                       F.max_pool2d(x, 3, 2)], dim=1)
        for block in self.blocks8:
            x = block(x)
        x = self.conv_7b(self.block8_final(x))

        x = x.mean(dim=(2, 3))
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
    model = InceptionResnetV2(config, image_size=image_size)
    params, stats = model.flax_variables(np.random.RandomState(seed))
    return {'params': params, 'batch_stats': stats}
