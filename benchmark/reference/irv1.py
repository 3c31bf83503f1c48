"""Plain PyTorch reference of Inception-ResNet-v1: inference embeddings and
one training step (softmax head, cross-entropy, L2 on every kernel, Adam).

Written from the architecture (Szegedy et al. 2016, arXiv:1602.07261, in
the form of davidsandberg/facenet's ``inception_resnet_v1.py``) and the
topology of the configuration file, in float32 with no kernel, fusion or
folding: every convolution is followed by its BatchNorm as a separate
step. Nothing of the program under test is imported or taken: the weights
are the benchmark's own tree (flax layout, see `spec`), and whatever the
program derives from them (folded BatchNorm, fused branch heads, bf16
copies) is worked out here again in its plain form.

One departure from davidsandberg's network, which the repository's model
makes too: ``Conv2d_2b_3x3`` is VALID (davidsandberg: SAME), so the stem
reads 79 -> 77 -> 75 -> 37 at 160 px; the grid after ``Conv2d_4b_3x3`` is
17 x 17 either way.

`precision` says in which dtype the activations are held and how each
convolution and dense layer reads its operands: `FLOAT32` for the reference
itself, `BF16` for the configuration's own precision, `FP8` for the
precision below it (a control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-3
WEIGHT_DECAY = 5e-4
NORM_EPS = 1e-3          # the dynamic range's floor of normalization 0


def identity(t):
    return t


def _round_fp8(t, dtype, largest):
    """`t` rounded to `dtype` under one per-tensor scale (its largest
    magnitude onto the format's largest finite value), back in t's dtype."""
    scale = t.abs().amax().clamp(min=1e-30) / largest
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Forward(torch.autograd.Function):
    """e4m3 rounding of a matmul's operand; the gradient passes through."""

    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Fp8Backward(torch.autograd.Function):
    """Identity forward; e5m2 rounding of the gradient of a matmul's
    output, the operand its backward matmuls read."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad, torch.float8_e5m2, 57344.0)


class Precision:
    """How a forward and its backward compute: the activations' dtype, and
    how each convolution and dense layer reads its operands and the
    gradient of its output."""

    def __init__(self, dtype=torch.float32, operand=identity,
                 output=identity):
        self.dtype = dtype
        self.operand = operand
        self.output = output


# the reference itself
FLOAT32 = Precision()
# the configuration's precision: activations and matmuls in bf16, the
# BatchNorm statistics, the bottleneck's normalization, the logits and the
# loss in float32, float32 weights and gradients
BF16 = Precision(torch.bfloat16)
# the precision below it, as fp8 training runs: BF16 with each matmul's
# input and weight in e4m3 and the gradient of its output in e5m2, each
# under one per-tensor scale
FP8 = Precision(torch.bfloat16, _Fp8Forward.apply, _Fp8Backward.apply)


class Recorder:
    """Stands in for a weight tree while a forward runs on an empty batch
    (or on the 'meta' device): every leaf it is asked for is recorded as
    (shape, kind) and handed out uninitialised."""

    def __init__(self, device='cpu'):
        self.spec = {}
        self.device = device

    def __call__(self, name, shape, kind):
        self.spec[name] = (tuple(shape), kind)
        return torch.empty(shape, device=self.device)


class Tree:
    """A flat {name: tensor} weight tree as the forward reads it."""

    def __init__(self, leaves):
        self.leaves = leaves

    def __call__(self, name, shape, kind):
        leaf = self.leaves[name]
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(f'{name}: {tuple(leaf.shape)} != {shape}')
        return leaf


class Net:
    """The forward over a weight source `p` (a `Tree` or a `Recorder`).

    Leaf names are flax paths: ``params/<layer>/conv/kernel`` (HWIO),
    ``params/<layer>/bn/bias``, ``batch_stats/<layer>/bn/mean`` and
    ``.../var``, ``params/<block>/Conv2d_1x1/kernel`` and ``bias`` (the
    residual up-projection), ``params/Bottleneck/kernel`` ([in, out]),
    ``params/Bottleneck.bn/bias``, and for training
    ``params/logits/kernel`` and ``bias``.

    :param train: BatchNorm on the batch's statistics (biased variance,
        float32), else on the running ones
    :param remat: recompute each block's activations in the backward
        (torch.utils.checkpoint), so a large training batch fits
    """

    def __init__(self, p, topology, train=False, precision=FLOAT32,
                 remat=False):
        self.p = p
        self.t = topology
        self.train = train
        self.dtype = precision.dtype
        self.q = precision.operand
        self.qg = precision.output
        self.remat = remat

    # -- layers -------------------------------------------------------------
    def conv(self, x, name, cin, cout, kh, kw, stride=1, same=True,
             bias=False):
        kernel = self.p(f'params/{name}/kernel', (kh, kw, cin, cout),
                        'kernel')
        b = (self.p(f'params/{name}/bias', (cout,), 'bias').to(self.dtype)
             if bias else None)
        pad = (kh // 2, kw // 2) if same else 0
        w = kernel.permute(3, 2, 0, 1).to(self.dtype)
        return self.qg(F.conv2d(self.q(x), self.q(w), b, stride, pad))

    def bn(self, x, name, c):
        bias = self.p(f'params/{name}/bias', (c,), 'bn_bias')
        shape = (1, c) + (1,) * (x.ndim - 2)
        dtype, x = x.dtype, x.float()
        if self.train:
            axes = [0] + list(range(2, x.ndim))
            mean = x.mean(dim=axes)
            var = (x - mean.view(shape)).square().mean(dim=axes)
        else:
            mean = self.p(f'batch_stats/{name}/mean', (c,), 'mean')
            var = self.p(f'batch_stats/{name}/var', (c,), 'var')
        return ((x - mean.view(shape)) * torch.rsqrt(var + BN_EPS).view(shape)
                + bias.view(shape)).to(dtype)

    def cbr(self, x, name, cin, cout, kh, kw, stride=1, same=True):
        y = self.conv(x, f'{name}/conv', cin, cout, kh, kw, stride, same)
        return F.relu(self.bn(y, f'{name}/bn', cout))

    def residual(self, x, name, branches, cin, scale, activation):
        mixed = torch.cat(branches, dim=1)
        up = self.conv(mixed, f'{name}/Conv2d_1x1', mixed.shape[1], cin, 1, 1,
                       bias=True)
        x = x + scale * up
        return F.relu(x) if activation else x

    # -- blocks -------------------------------------------------------------
    def block35(self, x, name, cfg):
        c = x.shape[1]
        b0 = self.cbr(x, f'{name}/Branch_0.Conv2d_1x1', c, 32, 1, 1)
        b1 = self.cbr(x, f'{name}/Branch_1.Conv2d_0a_1x1', c, 32, 1, 1)
        b1 = self.cbr(b1, f'{name}/Branch_1.Conv2d_0b_3x3', 32, 32, 3, 3)
        b2 = self.cbr(x, f'{name}/Branch_2.Conv2d_0a_1x1', c, 32, 1, 1)
        b2 = self.cbr(b2, f'{name}/Branch_2.Conv2d_0b_3x3', 32, 32, 3, 3)
        b2 = self.cbr(b2, f'{name}/Branch_2.Conv2d_0c_3x3', 32, 32, 3, 3)
        return self.residual(x, name, [b0, b1, b2], c, cfg['scale'],
                             cfg['activation'])

    def block17(self, x, name, cfg):
        c = x.shape[1]
        b0 = self.cbr(x, f'{name}/Branch_0.Conv2d_1x1', c, 128, 1, 1)
        b1 = self.cbr(x, f'{name}/Branch_1.Conv2d_0a_1x1', c, 128, 1, 1)
        b1 = self.cbr(b1, f'{name}/Branch_1.Conv2d_0b_1x7', 128, 128, 1, 7)
        b1 = self.cbr(b1, f'{name}/Branch_1.Conv2d_0c_7x1', 128, 128, 7, 1)
        return self.residual(x, name, [b0, b1], c, cfg['scale'],
                             cfg['activation'])

    def block8(self, x, name, cfg):
        c = x.shape[1]
        b0 = self.cbr(x, f'{name}/Branch_0.Conv2d_1x1', c, 192, 1, 1)
        b1 = self.cbr(x, f'{name}/Branch_1.Conv2d_0a_1x1', c, 192, 1, 1)
        b1 = self.cbr(b1, f'{name}/Branch_1.Conv2d_0b_1x3', 192, 192, 1, 3)
        b1 = self.cbr(b1, f'{name}/Branch_1.Conv2d_0c_3x1', 192, 192, 3, 1)
        return self.residual(x, name, [b0, b1], c, cfg['scale'],
                             cfg['activation'])

    def reduction_a(self, x, filters):
        (f0,), (f1a, f1b, f1c) = filters
        c = x.shape[1]
        n = 'Mixed_6a'
        b0 = self.cbr(x, f'{n}/Branch_0.Conv2d_1a_3x3', c, f0, 3, 3, 2, False)
        b1 = self.cbr(x, f'{n}/Branch_1.Conv2d_0a_1x1', c, f1a, 1, 1)
        b1 = self.cbr(b1, f'{n}/Branch_1.Conv2d_0b_3x3', f1a, f1b, 3, 3)
        b1 = self.cbr(b1, f'{n}/Branch_1.Conv2d_1a_3x3', f1b, f1c, 3, 3, 2,
                      False)
        return torch.cat([b0, b1, F.max_pool2d(x, 3, 2)], dim=1)

    def reduction_b(self, x, filters):
        (f0a, f0b), (f1a, f1b), (f2a, f2b, f2c) = filters
        c = x.shape[1]
        n = 'Mixed_7a'
        b0 = self.cbr(x, f'{n}/Branch_0.Conv2d_0a_1x1', c, f0a, 1, 1)
        b0 = self.cbr(b0, f'{n}/Branch_0.Conv2d_1a_3x3', f0a, f0b, 3, 3, 2,
                      False)
        b1 = self.cbr(x, f'{n}/Branch_1.Conv2d_0a_1x1', c, f1a, 1, 1)
        b1 = self.cbr(b1, f'{n}/Branch_1.Conv2d_1a_3x3', f1a, f1b, 3, 3, 2,
                      False)
        b2 = self.cbr(x, f'{n}/Branch_2.Conv2d_0a_1x1', c, f2a, 1, 1)
        b2 = self.cbr(b2, f'{n}/Branch_2.Conv2d_0b_3x3', f2a, f2b, 3, 3)
        b2 = self.cbr(b2, f'{n}/Branch_2.Conv2d_1a_3x3', f2b, f2c, 3, 3, 2,
                      False)
        return torch.cat([b0, b1, b2, F.max_pool2d(x, 3, 2)], dim=1)

    def _run(self, fn, x, *args):
        if self.remat and self.train:
            return checkpoint(fn, x, *args, use_reentrant=False)
        return fn(x, *args)

    # -- whole network --------------------------------------------------------
    def bottleneck(self, images):
        """uint8 NHWC images -> the bottleneck [B, output size] after its
        BatchNorm, float32, not normalized."""
        t = self.t
        x = normalize_images(images).to(self.dtype).permute(0, 3, 1, 2)
        x = self.cbr(x, 'Conv2d_1a_3x3', 3, 32, 3, 3, 2, False)
        x = self.cbr(x, 'Conv2d_2a_3x3', 32, 32, 3, 3, 1, False)
        x = self.cbr(x, 'Conv2d_2b_3x3', 32, 64, 3, 3, 1, False)
        x = F.max_pool2d(x, 3, 2)
        x = self.cbr(x, 'Conv2d_3b_1x1', 64, 80, 1, 1, 1, False)
        x = self.cbr(x, 'Conv2d_4a_3x3', 80, 192, 3, 3, 1, False)
        x = self.cbr(x, 'Conv2d_4b_3x3', 192, 256, 3, 3, 2, False)
        for i in range(t['block35']['repeat']):
            x = self._run(self.block35, x, f'Repeat.block35_{i + 1}',
                          t['block35'])
        x = self._run(self.reduction_a, x, t['reduction_a']['filters'])
        for i in range(t['block17']['repeat']):
            x = self._run(self.block17, x, f'Repeat_1.block17_{i + 1}',
                          t['block17'])
        x = self._run(self.reduction_b, x, t['reduction_b']['filters'])
        for i in range(t['block8_1']['repeat']):
            x = self._run(self.block8, x, f'Repeat_2.block8_{i + 1}',
                          t['block8_1'])
        x = self._run(self.block8, x, 'Block8', t['block8_2'])
        x = F.avg_pool2d(x, 3, 3).permute(0, 2, 3, 1).flatten(1)
        size = t['output']['size']
        kernel = self.p('params/Bottleneck/kernel', (x.shape[1], size),
                        'kernel')
        x = self.qg(F.linear(self.q(x), self.q(kernel.t().to(self.dtype))))
        return self.bn(x, 'Bottleneck.bn', size).float()

    def embeddings(self, images):
        """L2-normalized embeddings, float32."""
        x = self.bottleneck(images)
        return x / torch.sqrt(torch.clamp(x.square().sum(1, keepdim=True),
                                          min=1e-10))

    def logits(self, images, classes):
        """(logits [B, classes], bottleneck) of the softmax classifier."""
        pre = self.bottleneck(images)
        size = pre.shape[1]
        kernel = self.p('params/logits/kernel', (size, classes), 'kernel')
        bias = self.p('params/logits/bias', (classes,), 'bias')
        d = self.dtype
        logits = self.qg(F.linear(self.q(pre.to(d)), self.q(kernel.t().to(d)),
                                  bias.to(d)))
        return logits.float(), pre


def normalize_images(images):
    """uint8 NHWC -> float32 in [-1, 1] per image: (x - mid) / half range,
    the range floored at 1e-3 (normalization 0)."""
    x = images.float()
    flat = x.flatten(1)
    lo = flat.amin(1).view(-1, 1, 1, 1)
    hi = flat.amax(1).view(-1, 1, 1, 1)
    half = torch.clamp(hi - lo, min=NORM_EPS) / 2
    return (x - (lo + hi) / 2) / half


def spec(topology, image_size=160, classes=None):
    """{leaf name: (shape, kind)} of the network's weight tree; with
    `classes`, the softmax head's too. Kinds: 'kernel', 'bias' (the
    up-projections' and the head's), 'bn_bias', 'mean', 'var'."""
    rec = Recorder()
    net = Net(rec, topology)
    # a batch of none: every layer's shape, no arithmetic
    images = torch.zeros((0, image_size, image_size, 3), dtype=torch.uint8)
    if classes:
        net.logits(images, classes)
    else:
        net.embeddings(images)
    return rec.spec


def cross_entropy(logits, labels):
    """Mean sparse softmax cross-entropy."""
    return -F.log_softmax(logits, dim=1).gather(1, labels[:, None]).mean()


def l2(leaves):
    """WEIGHT_DECAY x the sum of squares of every kernel of the tree."""
    return WEIGHT_DECAY * sum(v.square().sum() for k, v in leaves.items()
                              if k.endswith('/kernel'))


class Adam:
    """Adam over a flat tree: betas (0.9, 0.999), eps added to the
    bias-corrected second moment's square root."""

    def __init__(self, eps, betas=(0.9, 0.999)):
        self.eps = float(eps)
        self.b1, self.b2 = betas
        self.m, self.v, self.count = {}, {}, 0

    def step(self, params, grads, lr):
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g))
            v = self.v.get(k, torch.zeros_like(g))
            self.m[k] = m = self.b1 * m + (1 - self.b1) * g
            self.v[k] = v = self.b2 * v + (1 - self.b2) * g * g
            denom = torch.sqrt(v) / c2 ** 0.5 + self.eps
            params[k] = params[k] - (lr / c1) * m / denom


def train_steps(leaves, topology, batches, classes, lr, eps,
                precision=FLOAT32, remat=True, on_step=None):
    """Plain training steps of the softmax classifier from `leaves` (its
    trainable leaves, float32, moved in place of a copy), one per
    (images, labels) of `batches`.

    :param lr: the learning rate of each step, a function of the step's
        index (0-based)
    :param on_step: called after each step with (index, loss, gradients)
    :return: the trainable leaves after the last step
    """
    params = {k: v.detach().clone() for k, v in leaves.items()}
    adam = Adam(eps)
    for i, (images, labels) in enumerate(batches):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        net = Net(Tree(live), topology, train=True, precision=precision,
                  remat=remat)
        logits, _ = net.logits(images, classes)
        loss = cross_entropy(logits, labels) + l2(live)
        names = list(live)
        grads = torch.autograd.grad(loss, [live[k] for k in names])
        grads = dict(zip(names, grads))
        if on_step is not None:
            on_step(i, float(loss.detach()), grads)
        adam.step(params, grads, lr(i))
        del live, net, logits, loss
    return params
