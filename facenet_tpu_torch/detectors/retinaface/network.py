"""RetinaFace-R50 (Deng et al., arXiv:1905.00641) as biubug6/Pytorch_Retinaface
releases it (``cfg_re50``): the network, its priors and its decode.

`RetinaFaceNet` holds the published parameters, float32, by the
published names (``body.*`` a torchvision ResNet-50 cut after layer4,
``fpn.*``, ``ssh1-3.*``, ``ClassHead/BboxHead/LandmarkHead.{0,1,2}``), so
``Resnet50_Final.pth`` loads as it is (`load_weights`).

`FoldedNet` is what inference runs: every BatchNorm folded into its
convolution (in float64, then cast), activations in ``dtype``
(bfloat16 on the card) and channels-last. On the card each convolution
that a ReLU follows is one cuDNN call with the bias and the ReLU in its
epilogue (``torch.cudnn_convolution_relu``), and a bottleneck's last
convolution takes the shortcut too (``torch.cudnn_convolution_add_relu``;
the projection shortcut's bias is folded into it), so no pass over an
activation adds a bias or clamps it apart; on the CPU the same sums run
as ``F.conv2d`` and elementwise passes. The SSH module's ReLU after the
concatenation is each branch's own ReLU (it acts channel by channel), so
every SSH convolution is one of those; its two convolutions that read the
same input are one convolution (256 -> 128 + 64, then 64 -> 64 + 64). A
level's three 1 x 1 heads are one float32 product of its 256 channels
with a [256, 32] matrix, so the heads and all that follows them are
float32. The body, the FPN with the SSH modules, and the heads are the
spans ``retinaface.backbone``, ``retinaface.neck`` and
``retinaface.heads``.

The network:

  * body: ResNet-50 v1.5 (the stride on each bottleneck's 3 x 3),
    BatchNorm eps 1e-5, returning layer2/3/4 (512/1024/2048 channels at
    strides 8/16/32, each output size ceil(previous / 2));
  * FPN: a 1 x 1 conv + BN + ReLU to 256 on each level; the coarser level
    upsampled (nearest) to the finer one's exact size and added, then a
    3 x 3 conv + BN + ReLU merge (level 2, then level 1);
  * SSH on each level: a 3 x 3 256 -> 128 conv + BN; a 3 x 3 256 -> 64
    conv + BN + ReLU feeding a 3 x 3 64 -> 64 conv + BN (the 5 x 5 branch)
    and a 3 x 3 64 -> 64 conv + BN + ReLU, then a 3 x 3 64 -> 64 conv + BN
    (the 7 x 7 branch); concatenated (128 + 64 + 64), then ReLU (the
    LeakyReLU's slope is 0 at 256 channels);
  * heads: 1 x 1 convs 256 -> 2 anchors x (2 classes, 4 deltas, 10
    landmark deltas), in (y, x, anchor) order;
  * priors: ``min_sizes`` [[16, 32], [64, 128], [256, 512]] at steps 8,
    16, 32 on ceil(H / step) x ceil(W / step) grids, unclipped (cx, cy,
    w, h) over the image's size;
  * decode: variances 0.1 (centres, landmarks) and 0.2 (log sizes).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facenet_tpu_torch.utils import profiling

BN_EPS = 1e-5
MEAN_BGR = (104.0, 117.0, 123.0)
MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STEPS = (8, 16, 32)
VARIANCES = (0.1, 0.2)
ANCHORS = 2
WIDTH = 256                                   # cfg_re50's out_channel
# ResNet-50's stages: (bottleneck width, blocks, first stride)
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
EXPANSION = 4
HEADS = (('ClassHead', 2), ('BboxHead', 4), ('LandmarkHead', 10))


def _conv_bn(cin, cout, kernel):
    """conv (no bias) + BN, as ``net.py``'s conv_bn* give them: [0] the
    conv, [1] the BatchNorm."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, 1, kernel // 2, bias=False),
        nn.BatchNorm2d(cout, eps=BN_EPS))


class Bottleneck(nn.Module):
    def __init__(self, cin, width, stride):
        super().__init__()
        cout = width * EXPANSION
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, cout, 1, stride, bias=False),
            nn.BatchNorm2d(cout, eps=BN_EPS))
            if stride != 1 or cin != cout else None)


class Body(nn.Module):
    """torchvision's ResNet-50 up to layer4 (IntermediateLayerGetter)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        cin = 64
        for i, (width, blocks, stride) in enumerate(STAGES):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, width, stride if b == 0 else 1))
                cin = width * EXPANSION
            setattr(self, f'layer{i + 1}', nn.Sequential(*layer))


class FPN(nn.Module):
    def __init__(self, channels=(512, 1024, 2048), width=WIDTH):
        super().__init__()
        for i, cin in enumerate(channels):
            setattr(self, f'output{i + 1}', _conv_bn(cin, width, 1))
        self.merge1 = _conv_bn(width, width, 3)
        self.merge2 = _conv_bn(width, width, 3)


class SSH(nn.Module):
    def __init__(self, width=WIDTH):
        super().__init__()
        self.conv3X3 = _conv_bn(width, width // 2, 3)
        self.conv5X5_1 = _conv_bn(width, width // 4, 3)
        self.conv5X5_2 = _conv_bn(width // 4, width // 4, 3)
        self.conv7X7_2 = _conv_bn(width // 4, width // 4, 3)
        self.conv7x7_3 = _conv_bn(width // 4, width // 4, 3)


class Head(nn.Module):
    def __init__(self, values, width=WIDTH):
        super().__init__()
        self.conv1x1 = nn.Conv2d(width, ANCHORS * values, 1)


class RetinaFaceNet(nn.Module):
    """The published network's parameters and BatchNorm statistics, by
    its names; `FoldedNet` computes with them."""

    def __init__(self):
        super().__init__()
        self.body = Body()
        self.fpn = FPN()
        self.ssh1, self.ssh2, self.ssh3 = SSH(), SSH(), SSH()
        for name, values in HEADS:
            setattr(self, name, nn.ModuleList(Head(values) for _ in range(3)))

    @torch.no_grad()
    def load_weights(self, state):
        """Load a state dict by the published names (a leading ``module.``,
        as a DataParallel checkpoint has, is dropped; BatchNorm's
        ``num_batches_tracked`` is not needed). Values are tensors or
        arrays; raises on a missing, unknown or misshapen entry."""
        state = {(k[7:] if k.startswith('module.') else k): v
                 for k, v in state.items()
                 if not k.endswith('num_batches_tracked')}
        own = {k: v for k, v in self.state_dict().items()
               if not k.endswith('num_batches_tracked')}
        missing = sorted(set(own) - set(state))
        unknown = sorted(set(state) - set(own))
        if missing or unknown:
            raise ValueError(f'RetinaFace weights: missing {missing[:5]}, '
                             f'unknown {unknown[:5]}')
        for name, target in own.items():
            value = torch.as_tensor(np.asarray(state[name], np.float32)
                                    if not torch.is_tensor(state[name])
                                    else state[name])
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f'{name}: {tuple(value.shape)} != '
                                 f'{tuple(target.shape)}')
            target.copy_(value.float())
        return self


def seeded_net(seed=0):
    """`RetinaFaceNet` with torch's default initialisation from a
    generator seeded with `seed` (BatchNorm at its identity statistics)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(seed))
        return RetinaFaceNet()


# -- inference -------------------------------------------------------------

def _fold(seq_or_conv, bn=None):
    """(weight [O, I, kh, kw], bias [O]) float64 of a conv with its
    BatchNorm folded in."""
    if bn is None:
        seq_or_conv, bn = seq_or_conv[0], seq_or_conv[1]
    w = seq_or_conv.weight.detach().double()
    scale = bn.weight.detach().double() / torch.sqrt(
        bn.running_var.detach().double() + bn.eps)
    mean = bn.running_mean.detach().double()
    bias = bn.bias.detach().double() - mean * scale
    return w * scale[:, None, None, None], bias


class FoldedNet:
    """The inference form of a `RetinaFaceNet` (see the module docstring):
    `__call__` takes preprocessed frames in ``dtype``, NCHW channels-last,
    and returns float32 (class logits [B, N, 2], box deltas [B, N, 4],
    landmark deltas [B, N, 10])."""

    def __init__(self, net, dtype=torch.bfloat16, device='cpu'):
        self.dtype = dtype
        self.device = torch.device(device)
        self.convs = {}

        def put(name, wb, stride=1):
            w, b = wb
            self.convs[name] = (
                w.to(self.device, dtype).contiguous(
                    memory_format=torch.channels_last),
                None if b is None else b.to(self.device, dtype), stride,
                w.shape[-1] // 2)

        body = net.body
        put('stem', _fold(body.conv1, body.bn1), 2)
        self.blocks = []
        for i in range(len(STAGES)):
            for b, block in enumerate(getattr(body, f'layer{i + 1}')):
                name = f'layer{i + 1}.{b}'
                stride = block.conv2.stride[0]
                put(f'{name}.conv1', _fold(block.conv1, block.bn1))
                put(f'{name}.conv2', _fold(block.conv2, block.bn2), stride)
                w3, b3 = _fold(block.conv3, block.bn3)
                if block.downsample is not None:
                    # the shortcut's bias joins the last convolution's
                    wd, bd = _fold(block.downsample)
                    put(f'{name}.down', (wd, None), stride)
                    b3 = b3 + bd
                put(f'{name}.conv3', (w3, b3))
                self.blocks.append((name, block.downsample is not None,
                                    i >= 1 and b == STAGES[i][1] - 1))
        for n in (1, 2, 3):
            put(f'fpn.output{n}', _fold(getattr(net.fpn, f'output{n}')))
        for n in (1, 2):
            put(f'fpn.merge{n}', _fold(getattr(net.fpn, f'merge{n}')))
        self.heads = []
        for level in range(3):
            ssh = getattr(net, f'ssh{level + 1}')
            name = f'ssh{level + 1}'
            # the two convs that read the level: 128 (no ReLU) + 64 (ReLU);
            # then the two that read the 5x5 branch's first: 64 + 64 (ReLU)
            put(f'{name}.a', _cat(_fold(ssh.conv3X3), _fold(ssh.conv5X5_1)))
            put(f'{name}.b', _cat(_fold(ssh.conv5X5_2),
                                  _fold(ssh.conv7X7_2)))
            put(f'{name}.c', _fold(ssh.conv7x7_3))
            convs = [getattr(net, head)[level].conv1x1 for head, _ in HEADS]
            weight = torch.cat([c.weight.detach().float()[:, :, 0, 0]
                                for c in convs]).t().contiguous()
            bias = torch.cat([c.bias.detach().float() for c in convs])
            self.heads.append((weight.to(self.device), bias.to(self.device)))

    def conv(self, x, name, relu=True, add=None):
        """The folded convolution `name` of x, plus `add`, then ReLU (with
        `relu`; `add` only with it)."""
        w, b, stride, pad = self.convs[name]
        if relu and x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
            s, p = (stride, stride), (pad, pad)
            if add is None:
                return torch.cudnn_convolution_relu(x, w, b, s, p, (1, 1), 1)
            return torch.cudnn_convolution_add_relu(x, w, add, 1.0, b, s, p,
                                                    (1, 1), 1)
        y = F.conv2d(x, w, b, stride, pad)
        if add is not None:
            y = y.add_(add)
        return F.relu_(y) if relu else y

    def body(self, x):
        x = F.max_pool2d(self.conv(x, 'stem'), 3, 2, 1)
        outs = []
        for name, down, returned in self.blocks:
            out = self.conv(x, f'{name}.conv1')
            out = self.conv(out, f'{name}.conv2')
            shortcut = (self.conv(x, f'{name}.down', relu=False) if down
                        else x)
            x = self.conv(out, f'{name}.conv3', add=shortcut)
            if returned:                      # the ends of layer2, 3 and 4
                outs.append(x)
        return outs

    def neck(self, c2, c3, c4):
        o1 = self.conv(c2, 'fpn.output1')
        o2 = self.conv(c3, 'fpn.output2')
        o3 = self.conv(c4, 'fpn.output3')
        o2 = self.conv(o2.add_(F.interpolate(o3, size=o2.shape[2:],
                                             mode='nearest')), 'fpn.merge2')
        o1 = self.conv(o1.add_(F.interpolate(o2, size=o1.shape[2:],
                                             mode='nearest')), 'fpn.merge1')
        feats = []
        half, quarter = WIDTH // 2, WIDTH // 4
        for level, x in enumerate((o1, o2, o3)):
            name = f'ssh{level + 1}'
            # [relu(conv3X3), relu(conv5X5_1)], then [relu(conv5X5_2),
            # relu(conv7X7_2)], then relu(conv7x7_3)
            a = self.conv(x, f'{name}.a')
            bb = self.conv(a[:, half:], f'{name}.b')
            c7 = self.conv(bb[:, quarter:], f'{name}.c')
            feats.append(torch.cat([a[:, :half], bb[:, :quarter], c7], 1))
        return feats

    def head(self, feats):
        parts = []
        for (weight, bias), f in zip(self.heads, feats):
            b = f.shape[0]
            rows = f.permute(0, 2, 3, 1).float().reshape(-1, f.shape[1])
            parts.append(torch.addmm(bias, rows, weight).reshape(b, -1, 32))
        out = torch.cat(parts, 1)
        b = out.shape[0]
        conf = out[..., :4].reshape(b, -1, 2)
        loc = out[..., 4:12].reshape(b, -1, 4)
        landm = out[..., 12:].reshape(b, -1, 10)
        return conf, loc, landm

    def __call__(self, x):
        with profiling.annotate('retinaface.backbone'):
            c2, c3, c4 = self.body(x)
        with profiling.annotate('retinaface.neck'):
            feats = self.neck(c2, c3, c4)
        with profiling.annotate('retinaface.heads'):
            return self.head(feats)


def _cat(*folded):
    return (torch.cat([w for w, _ in folded]),
            torch.cat([b for _, b in folded]))


def prior_boxes(height, width):
    """[N, 4] float32 priors (cx, cy, w, h) over the image's size, in
    (level, y, x, min size) order on ceil(H / step) x ceil(W / step) grids
    (which the body's rounding-up strides also give), computed in float64
    as ``layers/functions/prior_box.py`` computes them."""
    levels = []
    for sizes, step in zip(MIN_SIZES, STEPS):
        gh, gw = math.ceil(height / step), math.ceil(width / step)
        cy, cx = np.meshgrid((np.arange(gh) + 0.5) * step / height,
                             (np.arange(gw) + 0.5) * step / width,
                             indexing='ij')
        per_size = [np.stack([cx, cy, np.full_like(cx, s / width),
                              np.full_like(cx, s / height)], -1)
                    for s in sizes]
        levels.append(np.stack(per_size, 2).reshape(-1, 4))
    return np.concatenate(levels).astype(np.float32)


def decode(loc, priors, variances=VARIANCES):
    """Box deltas [..., 4] against priors [N, 4] (cx, cy, w, h) -> boxes
    (x1, y1, x2, y2) over the image's size, as ``utils/box_utils.py::
    decode`` computes them (x2 = x1 + w)."""
    boxes = torch.cat((
        priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:],
        priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])), -1)
    boxes[..., :2] -= boxes[..., 2:] / 2
    boxes[..., 2:] += boxes[..., :2]
    return boxes


def decode_landmarks(pre, priors, variances=VARIANCES):
    """Landmark deltas [..., 10] -> 5 (x, y) points [..., 10] over the
    image's size (``decode_landm``)."""
    return torch.cat([priors[..., :2] + pre[..., 2 * i:2 * i + 2]
                      * variances[0] * priors[..., 2:] for i in range(5)], -1)
