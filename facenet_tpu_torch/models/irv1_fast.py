"""Fused inference fast path for Inception-ResNet-v1 (PyTorch).

Serving-time form of `models/inception_resnet_v1.py`, the same two exact
transformations as ``facenet_tpu.models.irv1_fast``, applied once per
parameter set in numpy:

  1. **BN folding**: Conv(no bias) + BatchNorm(center-only) collapses to
     Conv + bias, W' = W / sqrt(var + eps), b = beta - mean / sqrt(var + eps).
  2. **Branch-head fusion**: the 1x1 convs that several branches of a block
     apply to the same input are concatenated along the output axis into one
     wider conv (three 32s in Block35, two 128s in Block17, two 192s in
     Block8, three 256s in ReductionB).

The stride-2 stem conv also runs as its space-to-depth rewrite: a 3x3/s2
conv on [H, W, 3] is exactly a 2x2/s1 conv on the 2x2-block-to-channel
transform [H/2, W/2, 12].

Weights and biases are stored in the serving dtype (bf16 by default), the
residual scales are rounded to that dtype, the bottleneck matmul accumulates
in float32, and activations run NCHW in channels_last memory. The
convolutions are cuDNN work through ``F.conv2d``; with ``stem='fused'`` the
prefix up to the first max pool runs as one hand-written kernel
(`ops.stem.stem_forward`). A tree quantized by `models.quantize` carries
int8 entries, which `_conv` runs through `ops.int8_conv`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.models.inception_resnet_v1 import (BN_EPS,
                                                           check_input_config)
from facenet_tpu_torch.models.quantize import (DEFAULT_SKIP, _Calibration,
                                               check_mode,
                                               quantize_fast_params)
from facenet_tpu_torch.ops import int8_conv
from facenet_tpu_torch.ops.preprocessing import image_processing
from facenet_tpu_torch.ops.stem import stem_forward

# entries an int8 quantizer must leave in bf16 when the fused stem is to
# run: the kernel takes bf16 weights
STEM_SKIP = ('Bottleneck', 'Conv2d_1a_s2d', 'Conv2d_1a_3x3',
             'Conv2d_2a_3x3', 'Conv2d_2b_3x3')
STEMS = ('cudnn', 'fused')


def _fold(tree_p, tree_s):
    """Fold one ConvBnRelu's BN into (HWIO kernel, bias), both float32."""
    w = np.asarray(tree_p['conv']['kernel'], np.float32)
    beta = np.asarray(tree_p['bn']['bias'], np.float32)
    mean = np.asarray(tree_s['bn']['mean'], np.float32)
    var = np.asarray(tree_s['bn']['var'], np.float32)
    s = 1.0 / np.sqrt(var + BN_EPS)
    return w * s, beta - mean * s


def _concat_folded(parts):
    """Concatenate (kernel, bias) pairs along the output-channel axis."""
    return (np.concatenate([k for k, _ in parts], axis=3),
            np.concatenate([b for _, b in parts], axis=0))


def _fold_numpy(variables, cfg):
    """The fused parameter tree in numpy: HWIO kernels, float32."""
    p, s = variables['params'], variables['batch_stats']
    out = {}

    def plain(block, name):
        k, b = _fold(p[block][name], s[block][name])
        return {'k': k, 'b': b}

    def fused_heads(block, names):
        k, b = _concat_folded([_fold(p[block][n], s[block][n])
                               for n in names])
        return {'k': k, 'b': b}

    def up(block):
        return {'k': np.asarray(p[block]['Conv2d_1x1']['kernel'], np.float32),
                'b': np.asarray(p[block]['Conv2d_1x1']['bias'], np.float32)}

    for name in ('Conv2d_1a_3x3', 'Conv2d_2a_3x3', 'Conv2d_2b_3x3',
                 'Conv2d_3b_1x1', 'Conv2d_4a_3x3', 'Conv2d_4b_3x3'):
        k, b = _fold(p[name], s[name])
        out[name] = {'k': k, 'b': b}

    # space-to-depth stem: tap (a, b) of plane (dy, dx) reads the original
    # offset (2a+dy, 2b+dx), zero where that leaves the 3x3 support
    k1, b1 = out['Conv2d_1a_3x3']['k'], out['Conv2d_1a_3x3']['b']
    cin = k1.shape[2]
    k_s2d = np.zeros((2, 2, 4 * cin, k1.shape[3]), np.float32)
    for a in range(2):
        for b_ in range(2):
            for dy in range(2):
                for dx in range(2):
                    ky, kx = 2 * a + dy, 2 * b_ + dx
                    if ky <= 2 and kx <= 2:
                        c0 = (dy * 2 + dx) * cin
                        k_s2d[a, b_, c0:c0 + cin] = k1[ky, kx]
    out['Conv2d_1a_s2d'] = {'k': k_s2d, 'b': b1}

    for i in range(int(cfg.block35.repeat)):
        blk = f'Repeat.block35_{i + 1}'
        out[blk] = {
            'heads': fused_heads(blk, ['Branch_0.Conv2d_1x1',
                                       'Branch_1.Conv2d_0a_1x1',
                                       'Branch_2.Conv2d_0a_1x1']),
            'b1b': plain(blk, 'Branch_1.Conv2d_0b_3x3'),
            'b2b': plain(blk, 'Branch_2.Conv2d_0b_3x3'),
            'b2c': plain(blk, 'Branch_2.Conv2d_0c_3x3'),
            'up': up(blk),
        }

    ra = 'Mixed_6a'
    out[ra] = {
        'b0': plain(ra, 'Branch_0.Conv2d_1a_3x3'),
        'b1a': plain(ra, 'Branch_1.Conv2d_0a_1x1'),
        'b1b': plain(ra, 'Branch_1.Conv2d_0b_3x3'),
        'b1c': plain(ra, 'Branch_1.Conv2d_1a_3x3'),
    }

    for i in range(int(cfg.block17.repeat)):
        blk = f'Repeat_1.block17_{i + 1}'
        out[blk] = {
            'heads': fused_heads(blk, ['Branch_0.Conv2d_1x1',
                                       'Branch_1.Conv2d_0a_1x1']),
            'b1b': plain(blk, 'Branch_1.Conv2d_0b_1x7'),
            'b1c': plain(blk, 'Branch_1.Conv2d_0c_7x1'),
            'up': up(blk),
        }

    rb = 'Mixed_7a'
    out[rb] = {
        'heads': fused_heads(rb, ['Branch_0.Conv2d_0a_1x1',
                                  'Branch_1.Conv2d_0a_1x1',
                                  'Branch_2.Conv2d_0a_1x1']),
        'b0b': plain(rb, 'Branch_0.Conv2d_1a_3x3'),
        'b1b': plain(rb, 'Branch_1.Conv2d_1a_3x3'),
        'b2b': plain(rb, 'Branch_2.Conv2d_0b_3x3'),
        'b2c': plain(rb, 'Branch_2.Conv2d_1a_3x3'),
    }

    n8 = int(cfg.block8_1.repeat)
    for i in range(n8 + 1):
        blk = 'Block8' if i == n8 else f'Repeat_2.block8_{i + 1}'
        out[blk] = {
            'heads': fused_heads(blk, ['Branch_0.Conv2d_1x1',
                                       'Branch_1.Conv2d_0a_1x1']),
            'b1b': plain(blk, 'Branch_1.Conv2d_0b_1x3'),
            'b1c': plain(blk, 'Branch_1.Conv2d_0c_3x1'),
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


def to_torch(tree, dtype, device):
    """A numpy fast-params tree as tensors on `device` in `dtype`: conv
    kernels HWIO -> OIHW in channels_last memory, the bottleneck kernel
    [in, out] -> [out, in]."""
    def convert(node, name=None):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, np.float32))
        if name == 'k' and t.ndim == 4:
            t = t.permute(3, 2, 0, 1)                    # HWIO -> OIHW
            return t.to(device=device, dtype=dtype).contiguous(
                memory_format=torch.channels_last)
        if name == 'k':
            t = t.t()                                    # [in, out] -> [out, in]
        return t.to(device=device, dtype=dtype).contiguous()

    return convert(tree)


def build_fast_params(variables, config=None, dtype=torch.bfloat16,
                      device=None):
    """Fold + fuse a trained IRv1 variable tree into the fast-path params.

    :param variables: flax-layout ``{'params', 'batch_stats'}`` of numpy
        arrays (as `export.load_model` or `init_variables` give them)
    :param device: where the params go; None means the GPU (raises without
        one), as for every entry point; pass ``'cpu'`` for the CPU
    :returns: (params: nested dict of tensors on `device` in `dtype`, cfg).
        Conv kernels are OIHW in channels_last memory; the bottleneck kernel
        is [out, in].
    """
    device = resolve_device(device)
    cfg = check_input_config(config)
    return to_torch(_fold_numpy(variables, cfg), dtype, device), cfg


def _conv(x, w, stride=1, padding='SAME'):
    if 'kq' in w:
        # int8 serving entry (models/quantize.py)
        return int8_conv.int8_conv(x, w, stride, padding)
    if 'tag' in w and _Calibration.active is not None:
        _Calibration.active.record(w['tag'], x)
    return F.conv2d(x, w['k'], w['b'], stride,
                    'same' if padding == 'SAME' else 0)


def _crelu(x, w, stride=1, padding='SAME'):
    return F.relu(_conv(x, w, stride, padding))


def _in_ch(w):
    """Input width of a (possibly int8) conv entry: the fused branch-head
    outputs are split by what each consumer conv takes."""
    return int(w['shape'][1] if 'kq' in w else w['k'].shape[1])


def _scale(value, dtype):
    """A residual scale rounded to the activation dtype, as the reference
    multiplies by a constant of that dtype."""
    return float(torch.tensor(float(value), dtype=dtype))


def _check_stem(stem):
    if stem not in STEMS:
        raise ValueError(f'unknown stem {stem!r}')


def stem_prefix(params, x):
    """conv1 (space-to-depth form when the size allows), conv2a, conv2b and
    the 3x3/s2 max pool through ``F.conv2d``: normalized NHWC [B, H, W, 3]
    -> NCHW [B, 64, H', W'] in channels_last memory."""
    b, h, w, c = x.shape
    if 'Conv2d_1a_s2d' in params and h % 2 == 0 and w % 2 == 0:
        xs = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        xs = xs.reshape(b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)
        x = _crelu(xs, params['Conv2d_1a_s2d'], 1, 'VALID')
    else:
        x = _crelu(x.permute(0, 3, 1, 2), params['Conv2d_1a_3x3'], 2, 'VALID')
    x = _crelu(x, params['Conv2d_2a_3x3'], 1, 'VALID')
    x = _crelu(x, params['Conv2d_2b_3x3'], 1, 'VALID')
    return F.max_pool2d(x, 3, 2)


def fast_forward(params, cfg, images, image_size=160, normalization=0,
                 dtype=torch.bfloat16, normalize=True, stem='cudnn'):
    """Fused inference forward: uint8/float NHWC images -> [B, D] float32.

    Same contract as InceptionResnetV1.forward: in-model preprocessing,
    L2-normalized float32 output (eps 1e-10) unless ``normalize=False``.

    :param stem: 'cudnn' (default) runs the conv1/2a/2b/pool prefix through
        ``F.conv2d``; 'fused' runs it as one kernel (`ops.stem`; 160x160
        only, bfloat16 only, needs the space-to-depth stem params)
    """
    _check_stem(stem)
    x = image_processing(images, image_size, normalization, dtype=dtype)

    if stem == 'fused':
        # raises ValueError on params without the s2d stem, on a size other
        # than 160x160 and on a dtype other than bfloat16
        x = stem_forward(params, x)
    else:
        x = stem_prefix(params, x)
    x = _crelu(x, params['Conv2d_3b_1x1'], 1, 'VALID')
    x = _crelu(x, params['Conv2d_4a_3x3'], 1, 'VALID')
    x = _crelu(x, params['Conv2d_4b_3x3'], 2, 'VALID')

    scale35 = _scale(cfg.block35.scale, dtype)
    for i in range(int(cfg.block35.repeat)):
        w = params[f'Repeat.block35_{i + 1}']
        heads = _crelu(x, w['heads'])
        n1, n2 = _in_ch(w['b1b']), _in_ch(w['b2b'])
        t0, t1, t2 = heads.split([heads.shape[1] - n1 - n2, n1, n2], dim=1)
        t1 = _crelu(t1, w['b1b'])
        t2 = _crelu(_crelu(t2, w['b2b']), w['b2c'])
        up = _conv(torch.cat([t0, t1, t2], dim=1), w['up'])
        x = F.relu(x + scale35 * up)

    w = params['Mixed_6a']
    t0 = _crelu(x, w['b0'], 2, 'VALID')
    t1 = _crelu(_crelu(_crelu(x, w['b1a']), w['b1b']), w['b1c'], 2, 'VALID')
    x = torch.cat([t0, t1, F.max_pool2d(x, 3, 2)], dim=1)

    scale17 = _scale(cfg.block17.scale, dtype)
    for i in range(int(cfg.block17.repeat)):
        w = params[f'Repeat_1.block17_{i + 1}']
        heads = _crelu(x, w['heads'])
        n1 = _in_ch(w['b1b'])
        t0, t1 = heads.split([heads.shape[1] - n1, n1], dim=1)
        t1 = _crelu(_crelu(t1, w['b1b']), w['b1c'])
        up = _conv(torch.cat([t0, t1], dim=1), w['up'])
        x = F.relu(x + scale17 * up)

    w = params['Mixed_7a']
    heads = _crelu(x, w['heads'])
    n0, n1 = _in_ch(w['b0b']), _in_ch(w['b1b'])
    h0, h1, h2 = heads.split([n0, n1, heads.shape[1] - n0 - n1], dim=1)
    t0 = _crelu(h0, w['b0b'], 2, 'VALID')
    t1 = _crelu(h1, w['b1b'], 2, 'VALID')
    t2 = _crelu(_crelu(h2, w['b2b']), w['b2c'], 2, 'VALID')
    x = torch.cat([t0, t1, t2, F.max_pool2d(x, 3, 2)], dim=1)

    n8 = int(cfg.block8_1.repeat)
    for i in range(n8 + 1):
        final = i == n8
        w = params['Block8' if final else f'Repeat_2.block8_{i + 1}']
        heads = _crelu(x, w['heads'])
        n1 = _in_ch(w['b1b'])
        t0, t1 = heads.split([heads.shape[1] - n1, n1], dim=1)
        t1 = _crelu(_crelu(t1, w['b1b']), w['b1c'])
        up = _conv(torch.cat([t0, t1], dim=1), w['up'])
        block = cfg.block8_2 if final else cfg.block8_1
        x = x + _scale(block.scale, dtype) * up
        if block.activation:
            x = F.relu(x)

    # head: avg pool 3x3/3 VALID -> NHWC flatten -> folded dense+BN in f32
    x = F.avg_pool2d(x, 3, 3).permute(0, 2, 3, 1).flatten(1)
    w = params['Bottleneck']
    x = F.linear(x.float(), w['k'].float(), w['b'].float())

    if normalize:
        norm = torch.sqrt(torch.clamp(
            x.square().sum(dim=1, keepdim=True), min=1e-10))
        x = x / norm
    return x


class FastEmbedder:
    """Fused forward bound to one parameter set on one device.

    :param stem: 'cudnn' or 'fused', see `fast_forward`
    :param quantize: None, or 'int8' for post-training int8 serving
        (models/quantize.py), calibrated on `calib_images` (a uint8 batch).
        Under ``stem='fused'`` the stem's convs stay bf16 (`STEM_SKIP`), so
        the fused stem kernel runs on the int8 path too.
    """

    def __init__(self, variables, config=None, image_size=160,
                 normalization=0, dtype=torch.bfloat16, normalize=True,
                 device=None, stem='cudnn', quantize=None, calib_images=None):
        _check_stem(stem)
        check_mode(quantize, calib_images)
        self.stem = stem
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params, self.cfg = build_fast_params(variables, config, dtype,
                                                  self.device)
        self.image_size = int(image_size)
        self.normalization = int(normalization)
        self.normalize = bool(normalize)
        if quantize:
            self.params = quantize_fast_params(
                self.params, self.cfg, calib_images, self.image_size,
                self.normalization,
                skip=STEM_SKIP if stem == 'fused' else DEFAULT_SKIP,
                dtype=dtype)

    @property
    def embedding_size(self):
        return int(self.cfg.output.size)

    def __call__(self, images):
        """uint8 [B, H, W, 3] (numpy or tensor) -> [B, D] float32 tensor on
        this embedder's device, not synchronized."""
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        with torch.inference_mode():
            return fast_forward(self.params, self.cfg, images,
                                self.image_size, self.normalization,
                                self.dtype, normalize=self.normalize,
                                stem=self.stem)
