"""Fused inference fast path for Inception-ResNet-v2 (PyTorch).

The same two exact transformations as the IRv1 fast path (models/irv1_fast.py,
where the shared helpers live), as ``facenet_tpu.models.irv2_fast`` applies
them: BatchNorm folded into conv biases, and the parallel 1x1 branch-head
convs concatenated into one wide conv (Block35 3x32 -> 96, Block17 192+128
-> 320, Block8 2x192 -> 384, Mixed_5a 96+48+64 -> 208, Mixed_7a 3x256 ->
768). The Block35/17/8 heads are split at the reference's fixed widths
(32/32/64, 192, 192), Mixed_5a's and Mixed_7a's by the config. Weights are
in the serving dtype, activations NCHW in channels_last memory, the mean
pool comes before the bottleneck, whose matmul accumulates in float32. An
int8 tree (models/quantize.py) runs through the same `_conv`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.models.inception_resnet_v1 import BN_EPS
from facenet_tpu_torch.models.inception_resnet_v2 import check_input_config
from facenet_tpu_torch.models.irv1_fast import (_concat_folded, _conv, _crelu,
                                                _fold, _scale, to_torch)
from facenet_tpu_torch.models.quantize import check_mode, quantize_fast_params
from facenet_tpu_torch.ops.preprocessing import image_processing
from facenet_tpu_torch.utils import profiling
from facenet_tpu_torch.utils.staging import HostStager


def _fold_numpy(variables, cfg):
    """The fused parameter tree in numpy: HWIO kernels, float32."""
    p, s = variables['params'], variables['batch_stats']
    out = {}

    def conv(name, block=None):
        k, b = _fold(p[block][name] if block else p[name],
                     s[block][name] if block else s[name])
        return {'k': k, 'b': b}

    def fused_heads(names, block=None):
        k, b = _concat_folded([_fold(p[block][n] if block else p[n],
                                     s[block][n] if block else s[n])
                               for n in names])
        return {'k': k, 'b': b}

    def up(block):
        return {'k': np.asarray(p[block]['Conv2d_1x1']['kernel'], np.float32),
                'b': np.asarray(p[block]['Conv2d_1x1']['bias'], np.float32)}

    for name in ('Conv2d_1a_3x3', 'Conv2d_2a_3x3', 'Conv2d_2b_3x3',
                 'Conv2d_3b_1x1', 'Conv2d_4a_3x3', 'Conv2d_7b_1x1'):
        out[name] = conv(name)

    out['Mixed_5a'] = {
        'heads': fused_heads(['Mixed_5a.Branch_0.Conv2d_1x1',
                              'Mixed_5a.Branch_1.Conv2d_0a_1x1',
                              'Mixed_5a.Branch_2.Conv2d_0a_1x1']),
        'b1b': conv('Mixed_5a.Branch_1.Conv2d_0b_5x5'),
        'b2b': conv('Mixed_5a.Branch_2.Conv2d_0b_3x3'),
        'b2c': conv('Mixed_5a.Branch_2.Conv2d_0c_3x3'),
        'b3': conv('Mixed_5a.Branch_3.Conv2d_0b_1x1'),
    }

    repeat = [int(r) for r in cfg.repeat]
    for i in range(repeat[0]):
        blk = f'Repeat.block35_{i + 1}'
        out[blk] = {
            'heads': fused_heads(['Branch_0.Conv2d_1x1',
                                  'Branch_1.Conv2d_0a_1x1',
                                  'Branch_2.Conv2d_0a_1x1'], blk),
            'b1b': conv('Branch_1.Conv2d_0b_3x3', blk),
            'b2b': conv('Branch_2.Conv2d_0b_3x3', blk),
            'b2c': conv('Branch_2.Conv2d_0c_3x3', blk),
            'up': up(blk),
        }

    out['Mixed_6a'] = {
        'b0': conv('Mixed_6a.Branch_0.Conv2d_1a_3x3'),
        'b1a': conv('Mixed_6a.Branch_1.Conv2d_0a_1x1'),
        'b1b': conv('Mixed_6a.Branch_1.Conv2d_0b_3x3'),
        'b1c': conv('Mixed_6a.Branch_1.Conv2d_1a_3x3'),
    }

    for i in range(repeat[1]):
        blk = f'Repeat_1.block17_{i + 1}'
        out[blk] = {
            'heads': fused_heads(['Branch_0.Conv2d_1x1',
                                  'Branch_1.Conv2d_0a_1x1'], blk),
            'b1b': conv('Branch_1.Conv2d_0b_1x7', blk),
            'b1c': conv('Branch_1.Conv2d_0c_7x1', blk),
            'up': up(blk),
        }

    out['Mixed_7a'] = {
        'heads': fused_heads(['Mixed_7a.Branch_0.Conv2d_0a_1x1',
                              'Mixed_7a.Branch_1.Conv2d_0a_1x1',
                              'Mixed_7a.Branch_2.Conv2d_0a_1x1']),
        'b0b': conv('Mixed_7a.Branch_0.Conv2d_1a_3x3'),
        'b1b': conv('Mixed_7a.Branch_1.Conv2d_1a_3x3'),
        'b2b': conv('Mixed_7a.Branch_2.Conv2d_0b_3x3'),
        'b2c': conv('Mixed_7a.Branch_2.Conv2d_1a_3x3'),
    }

    for i in range(repeat[2] + 1):
        blk = 'Block8' if i == repeat[2] else f'Repeat_2.block8_{i + 1}'
        out[blk] = {
            'heads': fused_heads(['Branch_0.Conv2d_1x1',
                                  'Branch_1.Conv2d_0a_1x1'], blk),
            'b1b': conv('Branch_1.Conv2d_0b_1x3', blk),
            'b1c': conv('Branch_1.Conv2d_0c_3x1', blk),
            'up': up(blk),
        }

    # Bottleneck dense + its BN fold into one biased matmul
    kb = np.asarray(p['Bottleneck']['kernel'], np.float32)
    beta = np.asarray(p['Bottleneck.bn']['bias'], np.float32)
    mean = np.asarray(s['Bottleneck.bn']['mean'], np.float32)
    var = np.asarray(s['Bottleneck.bn']['var'], np.float32)
    sc = 1.0 / np.sqrt(var + BN_EPS)
    out['Bottleneck'] = {'k': kb * sc, 'b': beta - mean * sc}
    return out


def build_fast_params(variables, config=None, dtype=torch.bfloat16,
                      device=None):
    """Fold + fuse a trained IRv2 variable tree for `fast_forward`: (params
    on `device` in `dtype`, cfg); None means the GPU, as everywhere."""
    device = resolve_device(device)
    cfg = check_input_config(config)
    return to_torch(_fold_numpy(variables, cfg), dtype, device), cfg


def fast_forward(params, cfg, images, image_size=160, normalization=0,
                 dtype=torch.bfloat16, normalize=True):
    """Fused IRv2 inference forward: uint8/float NHWC images -> [B, D]
    float32 (the contract of InceptionResnetV2.forward)."""
    x = image_processing(images, image_size, normalization,
                         dtype=dtype).permute(0, 3, 1, 2)

    x = _crelu(x, params['Conv2d_1a_3x3'], 2, 'VALID')
    x = _crelu(x, params['Conv2d_2a_3x3'], 1, 'VALID')
    x = _crelu(x, params['Conv2d_2b_3x3'], 1, 'SAME')
    x = F.max_pool2d(x, 3, 2)
    x = _crelu(x, params['Conv2d_3b_1x1'], 1, 'VALID')
    x = _crelu(x, params['Conv2d_4a_3x3'], 1, 'VALID')
    x = F.max_pool2d(x, 3, 2)

    # Mixed_5a: fused 1x1 heads, 5x5 and 3x3 tails, the average-pool branch
    w = params['Mixed_5a']
    c0, c1 = (int(b[0]) for b in list(cfg.mixed_5a.branch)[:2])
    heads = _crelu(x, w['heads'])
    t0, t1, t2 = heads.split([c0, c1, heads.shape[1] - c0 - c1], dim=1)
    t1 = _crelu(t1, w['b1b'])
    t2 = _crelu(_crelu(t2, w['b2b']), w['b2c'])
    # flax's avg_pool divides by the full window, padding included
    t3 = _crelu(F.avg_pool2d(x, 3, 1, 1, count_include_pad=True), w['b3'])
    x = torch.cat([t0, t1, t2, t3], dim=1)

    repeat = [int(r) for r in cfg.repeat]
    s35 = _scale(0.17, dtype)
    for i in range(repeat[0]):
        w = params[f'Repeat.block35_{i + 1}']
        heads = _crelu(x, w['heads'])
        t0, t1, t2 = heads.split([32, 32, heads.shape[1] - 64], dim=1)
        t1 = _crelu(t1, w['b1b'])
        t2 = _crelu(_crelu(t2, w['b2b']), w['b2c'])
        up = _conv(torch.cat([t0, t1, t2], dim=1), w['up'])
        x = F.relu(x + s35 * up)

    w = params['Mixed_6a']
    t0 = _crelu(x, w['b0'], 2, 'VALID')
    t1 = _crelu(_crelu(_crelu(x, w['b1a']), w['b1b']), w['b1c'], 2, 'VALID')
    x = torch.cat([t0, t1, F.max_pool2d(x, 3, 2)], dim=1)

    s17 = _scale(0.10, dtype)
    for i in range(repeat[1]):
        w = params[f'Repeat_1.block17_{i + 1}']
        heads = _crelu(x, w['heads'])
        t0, t1 = heads.split([192, heads.shape[1] - 192], dim=1)
        t1 = _crelu(_crelu(t1, w['b1b']), w['b1c'])
        up = _conv(torch.cat([t0, t1], dim=1), w['up'])
        x = F.relu(x + s17 * up)

    w = params['Mixed_7a']
    c0, c1 = (int(b[0]) for b in list(cfg.mixed_7a.branch)[:2])
    heads = _crelu(x, w['heads'])
    h0, h1, h2 = heads.split([c0, c1, heads.shape[1] - c0 - c1], dim=1)
    t0 = _crelu(h0, w['b0b'], 2, 'VALID')
    t1 = _crelu(h1, w['b1b'], 2, 'VALID')
    t2 = _crelu(_crelu(h2, w['b2b']), w['b2c'], 2, 'VALID')
    x = torch.cat([t0, t1, t2, F.max_pool2d(x, 3, 2)], dim=1)

    for i in range(repeat[2] + 1):
        final = i == repeat[2]
        w = params['Block8' if final else f'Repeat_2.block8_{i + 1}']
        heads = _crelu(x, w['heads'])
        t0, t1 = heads.split([192, heads.shape[1] - 192], dim=1)
        t1 = _crelu(_crelu(t1, w['b1b']), w['b1c'])
        up = _conv(torch.cat([t0, t1], dim=1), w['up'])
        x = x + _scale(1.0 if final else 0.2, dtype) * up
        if not final:
            x = F.relu(x)

    x = _crelu(x, params['Conv2d_7b_1x1'])

    x = x.mean(dim=(2, 3))            # dropout is the identity at inference
    w = params['Bottleneck']
    x = F.linear(x.float(), w['k'].float(), w['b'].float())

    if normalize:
        norm = torch.sqrt(torch.clamp(
            x.square().sum(dim=1, keepdim=True), min=1e-10))
        x = x / norm
    return x


class FastEmbedderV2:
    """Fused IRv2 forward bound to one parameter set on one device.

    :param quantize: None, or 'int8' (models/quantize.py), calibrated on
        `calib_images`, as for `irv1_fast.FastEmbedder`
    """

    def __init__(self, variables, config=None, image_size=160,
                 normalization=0, dtype=torch.bfloat16, normalize=True,
                 device=None, quantize=None, calib_images=None):
        check_mode(quantize, calib_images)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params, self.cfg = build_fast_params(variables, config, dtype,
                                                  self.device)
        self.image_size = int(image_size)
        self.normalization = int(normalization)
        self.normalize = bool(normalize)
        self.stager = HostStager(self.device)
        if quantize:
            self.params = quantize_fast_params(
                self.params, self.cfg, calib_images, self.image_size,
                self.normalization, forward=fast_forward, dtype=dtype)

    @property
    def embedding_size(self):
        return int(self.cfg.embedding_size)

    def __call__(self, images):
        """uint8 [B, H, W, 3] (numpy or tensor) -> [B, D] float32 tensor on
        this embedder's device, not synchronized. A host batch reaches a
        CUDA device through `HostStager`'s pinned ring and copy stream; the
        caller may reuse its array once the call returns."""
        with profiling.annotate('facenet.h2d'):
            images = self.stager(images)
        with profiling.annotate('facenet.forward'), torch.inference_mode():
            return fast_forward(self.params, self.cfg, images,
                                self.image_size, self.normalization,
                                self.dtype, normalize=self.normalize)
