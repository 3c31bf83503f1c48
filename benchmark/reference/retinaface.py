"""Plain PyTorch reference of RetinaFace-R50 as biubug6/Pytorch_Retinaface
releases it (``data/config.py::cfg_re50``, ``models/retinaface.py``,
``models/net.py``, ``layers/functions/prior_box.py``,
``utils/box_utils.py::decode/decode_landm``, ``utils/nms/py_cpu_nms.py``
and ``detect.py``'s post-processing), after Deng et al., arXiv:1905.00641.

Float32 with no kernel, fusion or folding: every convolution is followed
by its BatchNorm (eps 1e-5) as a separate step, the FPN upsamples with
``F.interpolate(mode='nearest', size=...)``, the SSH modules run their five
convolutions one by one, and the NMS is ``py_cpu_nms``'s loop over sorted
boxes. Nothing of the program under test is imported; the weights are the
benchmark's own tree (`spec`: the published parameter names, convolution
kernels stored HWIO, as `core.weights.make` draws them). TF32 is off
wherever this runs (the driver sets ``torch.backends.cuda.matmul.
allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` False).

Departures from biubug6's code, none of which changes a detection:

  * the frames arrive RGB (the program's convention); the swap to the
    published BGR is done here, before the mean (104, 117, 123) is taken;
  * fixed capacities in place of ragged outputs: a frame's detections are
    the first ``keep_top_k`` slots of [B, keep_top_k] buffers with a
    validity mask;
  * ties: ``detect.py`` ranks by a reversed numpy ``argsort`` and
    ``py_cpu_nms`` ranks again the same way, so its tied scores fall to
    the higher index; here both ranks are a stable descending sort, which
    gives them to the lower index, as the program's top-k and NMS do;
  * the BatchNorm scales (absent from `core.weights`' kinds) are drawn as
    its variances are, in [0.5, 1.5).

`precision` is as in `irv1`: `irv1.FLOAT32` for the reference itself,
`irv1.FP8` for the control (bf16 activations, e4m3 operands).
"""

from __future__ import annotations

from itertools import product
from math import ceil

import torch
import torch.nn.functional as F

from benchmark.reference.irv1 import FLOAT32, Recorder, Tree

__all__ = ['Net', 'Tree', 'spec', 'published_state', 'priors', 'decode',
           'decode_landm', 'py_cpu_nms', 'select']

BN_EPS = 1e-5
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


class Net:
    """The forward over a weight source `p` (a `Tree` or a `Recorder`),
    with `cfg` the configuration's detector settings (``in_channel``,
    ``out_channel``, ``anchors``, ``mean_bgr``)."""

    def __init__(self, p, cfg, precision=FLOAT32):
        self.p = p
        self.cfg = cfg
        self.dtype = precision.dtype
        self.q = precision.operand
        self.qg = precision.output

    def conv(self, x, name, cin, cout, k, stride=1, bias=False):
        kernel = self.p(f'{name}.weight', (k, k, cin, cout), 'kernel')
        b = (self.p(f'{name}.bias', (cout,), 'bias').to(self.dtype)
             if bias else None)
        w = kernel.permute(3, 2, 0, 1).to(self.dtype)
        return self.qg(F.conv2d(self.q(x), self.q(w), b, stride, k // 2))

    def bn(self, x, name, c):
        gamma = self.p(f'{name}.weight', (c,), 'var')
        beta = self.p(f'{name}.bias', (c,), 'bn_bias')
        mean = self.p(f'{name}.running_mean', (c,), 'mean')
        var = self.p(f'{name}.running_var', (c,), 'var')
        shape = (1, c, 1, 1)
        dtype, x = x.dtype, x.float()
        y = ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS)
             * gamma.view(shape) + beta.view(shape))
        return y.to(dtype)

    def conv_bn(self, x, name, cin, cout, k, stride=1, relu=True):
        """``net.py``'s conv_bn / conv_bn1X1 (relu) and conv_bn_no_relu:
        the Sequential's [0] conv and [1] BatchNorm; the LeakyReLU's slope
        is 0 at out_channel 256."""
        y = self.bn(self.conv(x, f'{name}.0', cin, cout, k, stride),
                    f'{name}.1', cout)
        return F.relu(y) if relu else y

    # -- ResNet-50 (torchvision, v1.5) -------------------------------------
    def bottleneck(self, x, name, cin, width, stride):
        cout = width * 4
        out = F.relu(self.bn(self.conv(x, f'{name}.conv1', cin, width, 1),
                             f'{name}.bn1', width))
        out = F.relu(self.bn(self.conv(out, f'{name}.conv2', width, width, 3,
                                       stride), f'{name}.bn2', width))
        out = self.bn(self.conv(out, f'{name}.conv3', width, cout, 1),
                      f'{name}.bn3', cout)
        if stride != 1 or cin != cout:
            x = self.bn(self.conv(x, f'{name}.downsample.0', cin, cout, 1,
                                  stride), f'{name}.downsample.1', cout)
        return F.relu(out + x)

    def body(self, x):
        x = F.relu(self.bn(self.conv(x, 'body.conv1', 3, 64, 7, 2),
                           'body.bn1', 64))
        x = F.max_pool2d(x, 3, 2, 1)
        outs, cin = [], 64
        for i, (width, blocks, stride) in enumerate(STAGES):
            for b in range(blocks):
                x = self.bottleneck(x, f'body.layer{i + 1}.{b}', cin, width,
                                    stride if b == 0 else 1)
                cin = width * 4
            if i >= 1:
                outs.append(x)
        return outs

    # -- FPN, SSH, heads ---------------------------------------------------
    def fpn(self, c2, c3, c4):
        n = self.cfg['out_channel']
        c = self.cfg['in_channel']
        o1 = self.conv_bn(c2, 'fpn.output1', 2 * c, n, 1)
        o2 = self.conv_bn(c3, 'fpn.output2', 4 * c, n, 1)
        o3 = self.conv_bn(c4, 'fpn.output3', 8 * c, n, 1)
        up3 = F.interpolate(o3, size=[o2.size(2), o2.size(3)],
                            mode='nearest')
        o2 = self.conv_bn(o2 + up3, 'fpn.merge2', n, n, 3)
        up2 = F.interpolate(o2, size=[o1.size(2), o1.size(3)],
                            mode='nearest')
        o1 = self.conv_bn(o1 + up2, 'fpn.merge1', n, n, 3)
        return [o1, o2, o3]

    def ssh(self, x, name):
        n = self.cfg['out_channel']
        conv3x3 = self.conv_bn(x, f'{name}.conv3X3', n, n // 2, 3,
                               relu=False)
        conv5x5_1 = self.conv_bn(x, f'{name}.conv5X5_1', n, n // 4, 3)
        conv5x5 = self.conv_bn(conv5x5_1, f'{name}.conv5X5_2', n // 4,
                               n // 4, 3, relu=False)
        conv7x7_2 = self.conv_bn(conv5x5_1, f'{name}.conv7X7_2', n // 4,
                                 n // 4, 3)
        conv7x7 = self.conv_bn(conv7x7_2, f'{name}.conv7x7_3', n // 4,
                               n // 4, 3, relu=False)
        return F.relu(torch.cat([conv3x3, conv5x5, conv7x7], dim=1))

    def head(self, x, name, values):
        a = self.cfg['anchors']
        out = self.conv(x, f'{name}.conv1x1', x.shape[1], a * values, 1,
                        bias=True)
        b, _, h, w = out.shape
        out = out.permute(0, 2, 3, 1).contiguous()
        return out.view(b, h * w * a, values).float()

    def forward(self, images):
        """uint8 RGB NHWC frames -> float32 (class logits [B, N, 2], box
        deltas [B, N, 4], landmark deltas [B, N, 10])."""
        x = images.float()[..., [2, 1, 0]]                  # RGB -> BGR
        x = x - torch.tensor(self.cfg['mean_bgr'], dtype=torch.float32,
                             device=x.device)
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        feats = [self.ssh(f, f'ssh{i + 1}')
                 for i, f in enumerate(self.fpn(*self.body(x)))]
        conf = torch.cat([self.head(f, f'ClassHead.{i}', 2)
                          for i, f in enumerate(feats)], dim=1)
        loc = torch.cat([self.head(f, f'BboxHead.{i}', 4)
                         for i, f in enumerate(feats)], dim=1)
        landm = torch.cat([self.head(f, f'LandmarkHead.{i}', 10)
                           for i, f in enumerate(feats)], dim=1)
        return conf, loc, landm


def spec(cfg):
    """{leaf name: (shape, kind)} of the network's weight tree, by the
    published names; kernels HWIO."""
    rec = Recorder()
    h, w = 64, 64
    Net(rec, cfg).forward(torch.zeros((0, h, w, 3), dtype=torch.uint8))
    return rec.spec


def published_state(leaves):
    """The tree as biubug6's checkpoint holds it: kernels OIHW."""
    return {name: (v.permute(3, 2, 0, 1) if v.dim() == 4 else v)
            for name, v in leaves.items()}


# -- priors, decode, selection ------------------------------------------------

def priors(cfg, image_size):
    """[N, 4] float32 (cx, cy, w, h), ``PriorBox.forward`` as published."""
    steps, min_sizes = cfg['steps'], cfg['min_sizes']
    feature_maps = [[ceil(image_size[0] / step), ceil(image_size[1] / step)]
                    for step in steps]
    anchors = []
    for k, f in enumerate(feature_maps):
        for i, j in product(range(f[0]), range(f[1])):
            for min_size in min_sizes[k]:
                s_kx = min_size / image_size[1]
                s_ky = min_size / image_size[0]
                cx = (j + 0.5) * steps[k] / image_size[1]
                cy = (i + 0.5) * steps[k] / image_size[0]
                anchors += [cx, cy, s_kx, s_ky]
    out = torch.tensor(anchors, dtype=torch.float32).view(-1, 4)
    if cfg['clip']:
        out.clamp_(max=1, min=0)
    return out


def decode(loc, priors, variances):
    """``box_utils.decode`` over a leading batch dimension."""
    boxes = torch.cat((
        priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:],
        priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])), -1)
    boxes[..., :2] -= boxes[..., 2:] / 2
    boxes[..., 2:] += boxes[..., :2]
    return boxes


def decode_landm(pre, priors, variances):
    """``box_utils.decode_landm`` over a leading batch dimension."""
    return torch.cat(
        (priors[..., :2] + pre[..., :2] * variances[0] * priors[..., 2:],
         priors[..., :2] + pre[..., 2:4] * variances[0] * priors[..., 2:],
         priors[..., :2] + pre[..., 4:6] * variances[0] * priors[..., 2:],
         priors[..., :2] + pre[..., 6:8] * variances[0] * priors[..., 2:],
         priors[..., :2] + pre[..., 8:10] * variances[0] * priors[..., 2:]),
        dim=-1)


def py_cpu_nms(boxes, scores, thresh):
    """``py_cpu_nms`` in float32 torch: (the indices kept, best first (ties
    to the lower index, see the module docstring), the pair tests it made:
    each kept box against every later box not yet suppressed)."""
    x1, y1, x2, y2 = boxes.unbind(1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = torch.argsort(scores, descending=True, stable=True)
    keep, tested = [], 0
    while order.numel() > 0:
        i = int(order[0])
        keep.append(i)
        rest = order[1:]
        tested += rest.numel()
        xx1 = torch.maximum(x1[i], x1[rest])
        yy1 = torch.maximum(y1[i], y1[rest])
        xx2 = torch.minimum(x2[i], x2[rest])
        yy2 = torch.minimum(y2[i], y2[rest])
        w = torch.clamp(xx2 - xx1 + 1, min=0.0)
        h = torch.clamp(yy2 - yy1 + 1, min=0.0)
        inter = w * h
        ovr = inter / (areas[i] + areas[rest] - inter)
        order = rest[ovr <= thresh]
    return keep, tested


def select(conf, loc, landm, cfg):
    """``detect.py``'s post-processing of dense outputs [B, N, ...] of one
    batch at ``cfg['image_shape']``: decode, score > confidence_threshold,
    the best top_k, py_cpu_nms at nms_threshold, the first keep_top_k.

    :returns: {'boxes' [B, keep_top_k, 4], 'scores', 'landmarks'
        [B, keep_top_k, 5, 2], 'valid', 'kept' [B] (every box py_cpu_nms
        kept), 'over' [B] (priors over the threshold), 'tested' [B] (the
        pair tests py_cpu_nms made)}, float32 / bool / int64 on the
        inputs' device
    """
    h, w = cfg['image_shape']
    device = conf.device
    prior = priors(cfg, (h, w)).to(device)
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=device)
    scale1 = torch.tensor([w, h] * 5, dtype=torch.float32, device=device)
    scores_all = F.softmax(conf, dim=-1)[..., 1]
    boxes_all = decode(loc, prior, cfg['variance']) * scale
    landms_all = decode_landm(landm, prior, cfg['variance']) * scale1
    b, cap = conf.shape[0], cfg['keep_top_k']
    out = {'boxes': torch.zeros((b, cap, 4)),
           'scores': torch.zeros((b, cap)),
           'landmarks': torch.zeros((b, cap, 5, 2)),
           'valid': torch.zeros((b, cap), dtype=torch.bool),
           'kept': torch.zeros(b, dtype=torch.int64),
           'over': torch.zeros(b, dtype=torch.int64),
           'tested': torch.zeros(b, dtype=torch.int64)}
    for f in range(b):
        scores = scores_all[f].cpu()
        inds = torch.nonzero(scores > cfg['confidence_threshold'])[:, 0]
        scores = scores[inds]
        order = torch.argsort(scores, descending=True,
                              stable=True)[:cfg['top_k']]
        boxes = boxes_all[f].cpu()[inds][order]
        landms = landms_all[f].cpu()[inds][order]
        scores = scores[order]
        kept, tested = py_cpu_nms(boxes, scores, cfg['nms_threshold'])
        n = min(len(kept), cap)
        keep = torch.tensor(kept[:n], dtype=torch.long)
        out['boxes'][f, :n] = boxes[keep]
        out['scores'][f, :n] = scores[keep]
        out['landmarks'][f, :n] = landms[keep].view(n, 5, 2)
        out['valid'][f, :n] = True
        out['kept'][f] = len(kept)
        out['over'][f] = len(inds)
        out['tested'][f] = tested
    return {k: v.to(device) for k, v in out.items()}

