"""Plain PyTorch reference of the MTCNN detection cascade and the two face
alignments that feed the embedding, in float32.

Written from the MTCNN paper (Zhang et al. 2016, arXiv:1604.02878; the
networks as davidsandberg/facenet's ``detect_face.py`` builds them) and
the protocol the configuration file states: a fixed pyramid, fixed
capacities between the stages, Fast NMS between the stages and greedy NMS
at the end. Nothing of the program under test is imported; the weights are
read from the bundled npz file as raw arrays (flax layout: HWIO conv
kernels, [in, out] dense kernels, PReLU slopes).

Conventions, as the configuration states them:

- pixels are normalized as (x - 127.5) / 128;
- the pyramid's levels are antialiased triangle-filter resamplings of the
  normalized scene (the ``jax.image.resize`` 'bilinear' method) to
  ceil(side x scale), scale = 12 / min_face x factor^i while the shorter
  side stays >= 12 px;
- a P-Net cell (y, x) of a level at `scale` covers [2x, 2x + 12) / scale;
  box regression moves each edge by its offset times the box's width or
  height; 'square' grows a box to a square about its centre;
- crops are bilinear with pixel centres at half steps and both taps
  clamped to the image from the unclipped floor;
- maximum pools use flax's 'SAME' padding where the network says so;
- landmark alignment maps the 5 points onto the canonical template by a
  least-squares similarity, crops the square it covers (plus 4 px) onto a
  t x t intermediate (t = 240 for 160 px faces), then samples that with
  clamped bilinear taps.

`precision` is `irv1.FLOAT32` for the reference, or a lower one for a
control (the same `Precision` objects as the embedding's reference).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.irv1 import FLOAT32

CELL, STRIDE = 12, 2
# ArcFace's 5-point template of a 112 x 112 crop (left eye, right eye,
# nose, left and right mouth corner), scaled to the crop's size
TEMPLATE_112 = np.array([[38.2946, 51.6963], [73.5318, 51.5014],
                         [56.0252, 71.7366], [41.5493, 92.3655],
                         [70.7299, 92.2041]], np.float32)


def load_weights(path, device):
    """{'pnet': {layer: {leaf: tensor}}, 'rnet': ..., 'onet': ...}, float32."""
    tree = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            net, layer, leaf = key.split('/')
            tree.setdefault(net, {}).setdefault(layer, {})[leaf] = \
                torch.from_numpy(z[key].astype(np.float32)).to(device)
    return tree


def normalize(x):
    return (x.float() - 127.5) / 128.0


# -- the three networks ------------------------------------------------------

class Nets:
    """P-Net, R-Net and O-Net over NCHW float input at `precision`."""

    def __init__(self, weights, precision=FLOAT32):
        self.w = weights
        self.d = precision.dtype
        self.q = precision.operand
        self.qg = precision.output

    def conv(self, x, net, layer):
        p = self.w[net][layer]
        k = p['kernel'].permute(3, 2, 0, 1).to(self.d)
        return self.qg(F.conv2d(self.q(x.to(self.d)), self.q(k),
                                p['bias'].to(self.d)))

    def dense(self, x, net, layer):
        p = self.w[net][layer]
        return self.qg(F.linear(self.q(x.to(self.d)),
                                self.q(p['kernel'].t().to(self.d)),
                                p['bias'].to(self.d)))

    def prelu(self, x, net, layer):
        a = self.w[net][layer]['alpha'].to(x.dtype)
        a = a.reshape(1, -1, *[1] * (x.ndim - 2))
        return torch.where(x >= 0, x, a * x)

    def pnet(self, x):
        """[B, 3, H, W] -> (face probability [B, H', W'], reg [B, H', W', 4])."""
        x = self.prelu(self.conv(x, 'pnet', 'conv1'), 'pnet', 'prelu1')
        x = pool_same(x, 2, 2)
        x = self.prelu(self.conv(x, 'pnet', 'conv2'), 'pnet', 'prelu2')
        x = self.prelu(self.conv(x, 'pnet', 'conv3'), 'pnet', 'prelu3')
        cls = self.conv(x, 'pnet', 'cls').float()
        reg = self.conv(x, 'pnet', 'reg').float()
        return torch.softmax(cls, dim=1)[:, 1], reg.permute(0, 2, 3, 1)

    def rnet(self, x):
        """[N, 24, 24, 3] normalized -> (probability [N], reg [N, 4])."""
        x = x.permute(0, 3, 1, 2)
        x = self.prelu(self.conv(x, 'rnet', 'conv1'), 'rnet', 'prelu1')
        x = pool_same(x, 3, 2)
        x = self.prelu(self.conv(x, 'rnet', 'conv2'), 'rnet', 'prelu2')
        x = F.max_pool2d(x, 3, 2)
        x = self.prelu(self.conv(x, 'rnet', 'conv3'), 'rnet', 'prelu3')
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = self.prelu(self.dense(x, 'rnet', 'fc1'), 'rnet', 'prelu4')
        cls = self.dense(x, 'rnet', 'cls').float()
        return torch.softmax(cls, dim=1)[:, 1], self.dense(x, 'rnet',
                                                           'reg').float()

    def onet(self, x):
        """[N, 48, 48, 3] normalized -> (probability, reg, landmarks
        [N, 10]: five x offsets then five y offsets, box-relative)."""
        x = x.permute(0, 3, 1, 2)
        x = self.prelu(self.conv(x, 'onet', 'conv1'), 'onet', 'prelu1')
        x = pool_same(x, 3, 2)
        x = self.prelu(self.conv(x, 'onet', 'conv2'), 'onet', 'prelu2')
        x = F.max_pool2d(x, 3, 2)
        x = self.prelu(self.conv(x, 'onet', 'conv3'), 'onet', 'prelu3')
        x = pool_same(x, 2, 2)
        x = self.prelu(self.conv(x, 'onet', 'conv4'), 'onet', 'prelu4')
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = self.prelu(self.dense(x, 'onet', 'fc1'), 'onet', 'prelu5')
        cls = self.dense(x, 'onet', 'cls').float()
        return (torch.softmax(cls, dim=1)[:, 1],
                self.dense(x, 'onet', 'reg').float(),
                self.dense(x, 'onet', 'landmarks').float())


def pool_same(x, window, stride):
    """Max pool with 'SAME' padding: -inf, total // 2 before, the rest
    after."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + window - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float('-inf')), window, stride)


# -- geometry ----------------------------------------------------------------

def scales(height, width, min_face, factor):
    s, side, out = CELL / min_face, min(height, width) * CELL / min_face, []
    while side >= CELL:
        out.append(s)
        s *= factor
        side *= factor
    return out


def resample_matrix(n_in, n_out, device):
    """[n_out, n_in] antialiased triangle-filter weights of a resize from
    n_in to n_out samples: each output sample's weights sum to 1, samples
    whose centre lies outside the input get none."""
    scale = n_out / n_in
    width = max(1.0 / scale, 1.0)
    centre = (torch.arange(n_out, dtype=torch.float64, device=device)
              + 0.5) / scale - 0.5
    src = torch.arange(n_in, dtype=torch.float64, device=device)
    w = torch.clamp(1 - (centre[:, None] - src[None]).abs() / width, min=0)
    w = w / w.sum(1, keepdim=True)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return (w * inside[:, None]).float()


def pnet_grid(sh, sw):
    return -(-(sh - 2) // 2) - 4, -(-(sw - 2) // 2) - 4


def regress(boxes, reg):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes + reg * torch.stack([w, h, w, h], -1)


def square(boxes):
    side = torch.maximum(boxes[..., 2] - boxes[..., 0],
                         boxes[..., 3] - boxes[..., 1])
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    return torch.stack([cx - side / 2, cy - side / 2, cx + side / 2,
                        cy + side / 2], -1)


def iou(a, b, mode='union'):
    """[..., N, 4] x [..., M, 4] -> [..., N, M]."""
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)

    def area(t):
        return ((t[..., 2] - t[..., 0]).clamp(min=0)
                * (t[..., 3] - t[..., 1]).clamp(min=0))
    aa, bb = area(a)[..., :, None], area(b)[..., None, :]
    denom = torch.minimum(aa, bb) if mode == 'min' else aa + bb - inter
    return inter / denom.clamp(min=1e-10)


def top_k(boxes, scores, valid, k):
    """The k best valid boxes by score (ties to the lower index) into
    fixed [B, k] slots; empty slots invalid with score 0."""
    b, n = scores.shape
    kk = min(k, n)
    s = torch.where(valid, scores, torch.full_like(scores, -math.inf))
    s, idx = torch.sort(s, dim=1, descending=True, stable=True)
    s, idx = s[:, :kk], idx[:, :kk]
    boxes = torch.gather(boxes, 1, idx[..., None].expand(b, kk, 4))
    valid = torch.isfinite(s)
    s = torch.where(valid, s, torch.zeros_like(s))
    if kk < k:
        boxes = F.pad(boxes, (0, 0, 0, k - kk))
        s = F.pad(s, (0, k - kk))
        valid = F.pad(valid, (0, k - kk))
    return boxes, s, valid


def fast_nms(boxes, scores, valid, threshold):
    """Drop a box when any valid box scored higher (ties: the lower index)
    overlaps it by more than `threshold` (Fast NMS)."""
    k = boxes.shape[1]
    s = torch.where(valid, scores, torch.full_like(scores, -math.inf))
    idx = torch.arange(k, device=boxes.device)
    higher = (s[:, :, None] > s[:, None, :]) | (
        (s[:, :, None] == s[:, None, :]) & (idx[:, None] < idx[None, :]))
    hit = higher & (iou(boxes, boxes) > threshold) & valid[:, :, None]
    return valid & ~hit.any(dim=1)


def greedy_nms(boxes, scores, valid, threshold, mode='union'):
    """Visit boxes best first (ties: the lower index); keep one when it is
    valid and no kept box overlaps it by more than `threshold`."""
    keep = torch.zeros_like(valid)
    for i in range(boxes.shape[0]):
        order = sorted(range(boxes.shape[1]),
                       key=lambda j: (-float(scores[i, j]) if valid[i, j]
                                      else math.inf, j))
        kept = []
        for j in order:
            if not valid[i, j]:
                continue
            if kept and bool((iou(boxes[i, j][None], boxes[i, kept],
                                  mode)[0] > threshold).any()):
                continue
            kept.append(j)
            keep[i, j] = True
    return keep


def crop(images, boxes, size):
    """Bilinear crops [B, K, size, size, C] of boxes [B, K, 4] (x1, y1, x2,
    y2) from images [B, H, W, C], float32."""
    b, h, w, c = images.shape
    k = boxes.shape[1]
    grid = (torch.arange(size, dtype=torch.float32, device=images.device)
            + 0.5) / size

    def taps(lo, hi, n):
        pos = lo[..., None] + grid * (hi - lo)[..., None] - 0.5
        p0 = torch.floor(pos)
        frac = pos - p0
        p0 = p0.long()
        return p0.clamp(0, n - 1), (p0 + 1).clamp(0, n - 1), frac

    y0, y1, fy = taps(boxes[..., 1], boxes[..., 3], h)      # [B, K, S]
    x0, x1, fx = taps(boxes[..., 0], boxes[..., 2], w)
    img = images.float()
    bi = torch.arange(b, device=images.device)[:, None, None, None]
    out = 0
    for yy, wy in ((y0, 1 - fy), (y1, fy)):
        for xx, wx in ((x0, 1 - fx), (x1, fx)):
            px = img[bi, yy[..., :, None], xx[..., None, :]]   # [B,K,S,S,C]
            out = out + px * (wy[..., :, None] * wx[..., None, :])[..., None]
    return out


# -- the cascade -------------------------------------------------------------

def detect(images, nets, cfg):
    """uint8 scenes [B, H, W, 3] on a device -> dict of 'boxes' [B, K, 4],
    'scores', 'valid', 'landmarks' [B, K, 5, 2], valid detections first,
    best score first (K = the O-Net's capacity)."""
    b, h, w, _ = images.shape
    t1, t2, t3 = cfg['thresholds']
    x = normalize(images)
    found = []
    for s in scales(h, w, cfg['min_face_size'], cfg['factor']):
        sh, sw = math.ceil(h * s), math.ceil(w * s)
        v = resample_matrix(h, sh, images.device)
        hm = resample_matrix(w, sw, images.device)
        level = torch.einsum('yh,bhwc,xw->bcyx', v, x, hm)
        prob, reg = nets.pnet(level)
        gh, gw = pnet_grid(sh, sw)
        ys = torch.arange(gh, device=images.device, dtype=torch.float32)
        xs = torch.arange(gw, device=images.device, dtype=torch.float32)
        y1 = (STRIDE * ys / s)[:, None].expand(gh, gw)
        x1 = (STRIDE * xs / s)[None, :].expand(gh, gw)
        base = torch.stack([x1, y1, x1 + CELL / s, y1 + CELL / s], -1)
        boxes = regress(base.reshape(1, -1, 4).expand(b, -1, 4),
                        reg.reshape(b, -1, 4))
        scores = prob.reshape(b, -1)
        boxes, scores, valid = top_k(boxes, scores, scores >= t1,
                                     cfg['max_proposals'])
        valid = fast_nms(boxes, scores, valid, 0.5)
        found.append((boxes, scores, valid))
    boxes = torch.cat([f[0] for f in found], 1)
    scores = torch.cat([f[1] for f in found], 1)
    valid = torch.cat([f[2] for f in found], 1)
    boxes, scores, valid = top_k(boxes, scores, valid, cfg['max_proposals'])
    valid = fast_nms(boxes, scores, valid, 0.7)
    boxes = square(boxes)

    boxes, scores, valid = top_k(boxes, scores, valid, cfg['max_refined'])
    k = boxes.shape[1]
    prob, reg = nets.rnet(normalize(crop(images, boxes, 24)).reshape(
        -1, 24, 24, 3))
    scores = prob.reshape(b, k)
    valid = valid & (scores >= t2)
    valid = fast_nms(boxes, scores, valid, 0.7)
    boxes = square(regress(boxes, reg.reshape(b, k, 4)))

    boxes, scores, valid = top_k(boxes, scores, valid, cfg['max_outputs'])
    k = boxes.shape[1]
    prob, reg, lmk = nets.onet(normalize(crop(images, boxes, 48)).reshape(
        -1, 48, 48, 3))
    scores = prob.reshape(b, k)
    valid = valid & (scores >= t3)
    lmk = lmk.reshape(b, k, 10)
    bw = (boxes[..., 2] - boxes[..., 0])[..., None]
    bh = (boxes[..., 3] - boxes[..., 1])[..., None]
    landmarks = torch.stack([boxes[..., 0:1] + lmk[..., :5] * bw,
                             boxes[..., 1:2] + lmk[..., 5:] * bh], -1)
    boxes = regress(boxes, reg.reshape(b, k, 4))
    valid = valid & greedy_nms(boxes.cpu(), scores.cpu(), valid.cpu(), 0.7,
                               'min').to(valid.device)
    key = torch.where(valid, scores, torch.full_like(scores, -1.0))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    return {'boxes': torch.gather(boxes, 1, order[..., None].expand(b, k, 4)),
            'scores': torch.where(valid, scores, 0).gather(1, order),
            'valid': valid.gather(1, order),
            'landmarks': torch.gather(landmarks, 1, order[..., None, None]
                                      .expand(b, k, 5, 2))}


# -- alignment ---------------------------------------------------------------

def similarity(src, dst):
    """Least-squares similarity [.., 2, 3] taking points src [.., N, 2]
    onto dst [N, 2] (Umeyama, no reflection), float64."""
    src = src.double()
    dst = dst.double().expand_as(src)
    ms, md = src.mean(-2, keepdim=True), dst.mean(-2, keepdim=True)
    s0, d0 = src - ms, dst - md
    var = s0.square().sum(-1).mean(-1)
    cov = d0.transpose(-1, -2) @ s0 / src.shape[-2]
    u, sv, vh = torch.linalg.svd(cov)
    sign = torch.sign(torch.linalg.det(u @ vh))
    fix = torch.ones_like(sv)
    fix[..., 1] = sign
    rot = u @ torch.diag_embed(fix) @ vh
    scale = (sv * fix).sum(-1) / var
    m = scale[..., None, None] * rot
    t = md[..., 0, :] - (m @ ms[..., 0, :, None])[..., 0]
    return torch.cat([m, t[..., None]], -1)


def invert(m):
    a = torch.linalg.inv(m[..., :2])
    return torch.cat([a, -a @ m[..., 2:]], -1)


def warp_geometry(landmarks, size):
    """For faces' landmarks [N, 5, 2]: (boxes [N, 4] of the intermediate
    crops, matrices [N, 2, 3] from an aligned pixel to its intermediate
    pixel, the intermediate side t)."""
    template = torch.from_numpy(TEMPLATE_112 * (size / 112.0)).to(
        landmarks.device)
    inv = invert(similarity(landmarks, template))          # out -> source
    t = -(-int(size * 1.4 + 16) // 8) * 8
    corners = torch.tensor([[0.0, 0.0], [size - 1.0, 0.0], [0.0, size - 1.0],
                            [size - 1.0, size - 1.0]], dtype=torch.float64,
                           device=landmarks.device)
    src = corners @ inv[..., :2].transpose(-1, -2) + inv[..., None, :, 2]
    lo, hi = src.amin(-2) - 4.0, src.amax(-2) + 4.0
    sc = t / (hi - lo)
    a = inv[..., :2] * sc[..., None]
    off = (inv[..., 2] + 0.5 - lo) * sc - 0.5
    return torch.cat([lo, hi], -1), torch.cat([a, off[..., None]], -1), t


def warp(images, mats, size):
    """Clamped bilinear samples [N, size, size, C] of images [N, t, t, C]
    at mats [N, 2, 3] x (x, y, 1) of each output pixel."""
    n, h, w, c = images.shape
    ys, xs = torch.meshgrid(torch.arange(size, dtype=torch.float64,
                                         device=images.device),
                            torch.arange(size, dtype=torch.float64,
                                         device=images.device),
                            indexing='ij')
    m = mats[:, :, :, None, None]
    sx = (m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]).clamp(0, w - 1)
    sy = (m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]).clamp(0, h - 1)
    x0, y0 = sx.floor(), sy.floor()
    fx, fy = (sx - x0).float()[..., None], (sy - y0).float()[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    ni = torch.arange(n, device=images.device)[:, None, None]
    img = images.float()
    top = img[ni, y0, x0] * (1 - fx) + img[ni, y0, x1] * fx
    bot = img[ni, y1, x0] * (1 - fx) + img[ni, y1, x1] * fx
    return top * (1 - fy) + bot * fy


def align_landmarks(images, landmarks, size):
    """Aligned crops [B, K, size, size, C] of the faces whose landmarks
    [B, K, 5, 2] are given, float32."""
    b, k = landmarks.shape[:2]
    boxes, mats, t = warp_geometry(landmarks.reshape(b * k, 5, 2), size)
    inter = crop(images, boxes.float().reshape(b, k, 4), t)
    out = warp(inter.reshape(b * k, t, t, -1), mats, size)
    return out.reshape(b, k, size, size, -1)


def align_boxes(images, boxes, size, margin):
    """Crops [B, K, size, size, C] of boxes grown by `margin` of their
    size in all (half on each side)."""
    wh = boxes[..., 2:] - boxes[..., :2]
    grown = torch.cat([boxes[..., :2] - wh * margin / 2,
                       boxes[..., 2:] + wh * margin / 2], -1)
    return crop(images, grown, size)


def to_uint8(crops):
    """Crops as the embedding receives them: rounded to uint8."""
    return torch.clamp(crops + 0.5, 0, 255).to(torch.uint8)
