"""Operations and bytes of the work a cell does, from shapes alone: the
same whatever implements the work.

Convolution and matrix-multiply operations (2 a multiply-add) are counted
by torch's FlopCounterMode over the plain reference run on the 'meta'
device, which allocates and computes nothing; a training step's count is
its forward and its backward (the input and weight gradients).
"""

from __future__ import annotations

import functools
import json
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import irv1


@functools.lru_cache(maxsize=None)
def _irv1(topology_json, image_size, classes, train):
    topology = json.loads(topology_json)
    spec = irv1.spec(topology, image_size, classes or None)
    leaves = {k: torch.empty(shape, device='meta', requires_grad=train)
              for k, (shape, kind) in spec.items() if k.startswith('params/')
              or not train}
    images = torch.empty((1, image_size, image_size, 3), device='meta')
    with FlopCounterMode(display=False) as counter:
        net = irv1.Net(irv1.Tree(leaves), topology, train=train)
        if train:
            logits, _ = net.logits(images, classes)
            labels = torch.zeros(1, dtype=torch.long, device='meta')
            loss = irv1.cross_entropy(logits, labels)
            torch.autograd.grad(loss, list(leaves.values()))
        else:
            net.embeddings(images)
    return counter.get_total_flops()


def irv1_forward_flops(topology, image_size=160):
    """Operations of one image's inference forward."""
    return _irv1(json.dumps(topology, sort_keys=True), int(image_size), 0,
                 False)


def irv1_train_flops(topology, classes, image_size=160):
    """Operations of one image's training step, backbone and softmax head:
    the forward and the backward."""
    return _irv1(json.dumps(topology, sort_keys=True), int(image_size),
                 int(classes), True)


# -- the detection pipeline ----------------------------------------------

PNET_WEIGHTS = 6640     # float32 weights B3 reads: convs, heads, slopes


def pnet_work(levels):
    """(flops, bytes) of the P-Net over levels given as (batch, sh, sw):
    multiply-adds of the three convs and the heads (x2), bf16 inputs read
    once, float32 heads written once, weights read once.

    Copied from ``chip_smoke.py::pnet_work`` (which reads the shapes off
    the level tensors and takes the weight count and the head grid from
    the program's ``detectors/mtcnn/pnet.py``, `N_WEIGHTS` and
    `out_geometry`; both are restated here)."""
    from benchmark.reference.mtcnn import pnet_grid
    flops = nbytes = 0
    for b, sh, sw in levels:
        h1, w1 = sh - 2, sw - 2
        hp, wp = -(-h1 // 2), -(-w1 // 2)
        gh, gw = pnet_grid(sh, sw)
        macs = (h1 * w1 * 10 * 27 + (hp - 2) * (wp - 2) * 16 * 90
                + gh * gw * (32 * 144 + 6 * 32))
        flops += 2 * b * macs
        nbytes += b * (3 * sh * sw * 2 + gh * gw * 5 * 4)
    return flops, nbytes + PNET_WEIGHTS * 4


def pyramid_levels(batch, height, width, min_face, factor):
    """(batch, sh, sw) of each level of the cascade's pyramid."""
    from benchmark.reference import mtcnn
    return [(batch, math.ceil(height * s), math.ceil(width * s))
            for s in mtcnn.scales(height, width, min_face, factor)]


def warp_coords(mats, size):
    """Unclamped source coordinates (sx, sy) [N, oh, ow] of every output
    pixel of an affine warp by mats [N, 2, 3], in float32.

    Copied from ``chip_smoke.py::_warp_coords``."""
    ys, xs = torch.meshgrid(
        torch.arange(size[0], dtype=torch.float32, device=mats.device),
        torch.arange(size[1], dtype=torch.float32, device=mats.device),
        indexing='ij')
    m = mats.float()[:, :, :, None, None]
    return (m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2],
            m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2])


def warp_touched_pixels(mats, size, h, w):
    """Source pixels, summed over the crops, that some output pixel's
    two-tap sample reads with a nonzero weight: what the warp must read.

    Copied from ``chip_smoke.py::warp_touched_pixels``."""
    sx, sy = warp_coords(mats, size)
    sx, sy = sx.clamp(0, w - 1), sy.clamp(0, h - 1)
    x0, y0 = sx.floor(), sy.floor()
    wx, wy = sx - x0, sy - y0
    base = torch.arange(mats.shape[0], device=mats.device)[:, None, None] \
        * h * w
    touched = torch.zeros(mats.shape[0] * h * w, dtype=torch.bool,
                          device=mats.device)
    for yi, ty in ((y0, None), (y0 + 1, wy)):
        for xi, tx in ((x0, None), (x0 + 1, wx)):
            keep = torch.ones_like(wx, dtype=torch.bool)
            if ty is not None:
                keep &= ty > 0
            if tx is not None:
                keep &= tx > 0
            touched[(base + yi.long() * w + xi.long())[keep]] = True
    return int(touched.sum())


def b2_bytes(mats, size, t, channels=3):
    """Bytes B2 must move to warp t x t float32 intermediates by mats
    [N, 2, 3] into size x size crops: the source pixels its taps read, the
    matrices, and the crops written once.

    Copied from ``chip_smoke.py`` (phase 12's ``b2_bytes_n``)."""
    touched = warp_touched_pixels(mats, (size, size), t, t)
    n = mats.shape[0]
    return (touched * channels + mats.numel() + n * size * size * channels) * 4


@functools.lru_cache(maxsize=None)
def _mtcnn_net_flops(net, size):
    from benchmark.reference import mtcnn
    shapes = {
        'rnet': {'conv1': (3, 3, 3, 28), 'conv2': (3, 3, 28, 48),
                 'conv3': (2, 2, 48, 64), 'fc1': (576, 128), 'cls': (128, 2),
                 'reg': (128, 4)},
        'onet': {'conv1': (3, 3, 3, 32), 'conv2': (3, 3, 32, 64),
                 'conv3': (3, 3, 64, 64), 'conv4': (2, 2, 64, 128),
                 'fc1': (1152, 256), 'cls': (256, 2), 'reg': (256, 4),
                 'landmarks': (256, 10)}}[net]
    slopes = {'rnet': (28, 48, 64, 128), 'onet': (32, 64, 64, 128, 256)}[net]
    weights = {net: {layer: {'kernel': torch.empty(shape, device='meta'),
                             'bias': torch.empty(shape[-1], device='meta')}
                     for layer, shape in shapes.items()}}
    for i, n in enumerate(slopes):
        weights[net][f'prelu{i + 1}'] = {'alpha': torch.empty(n,
                                                              device='meta')}
    nets = mtcnn.Nets(weights)
    x = torch.empty((1, size, size, 3), device='meta')
    with FlopCounterMode(display=False) as counter:
        getattr(nets, net)(x)
    return counter.get_total_flops()


def pipeline_flops(detector, embedding, batch, num_faces, image_shape):
    """Operations of one batch of the detection pipeline: the P-Net over
    the pyramid, the R-Net and O-Net over their capacities, and the IRv1
    forward over batch x num_faces crops. Resampling (the pyramid, the
    crops, the alignment) is counted at no operations: it is memory work,
    which the rooflines of B2 and B3 measure."""
    h, w = image_shape
    levels = pyramid_levels(batch, h, w, detector['min_face_size'],
                            detector['factor'])
    pnet, _ = pnet_work(levels)
    rnet = batch * detector['max_refined'] * _mtcnn_net_flops('rnet', 24)
    onet = batch * detector['max_outputs'] * _mtcnn_net_flops('onet', 48)
    emb = batch * num_faces * irv1_forward_flops(embedding['topology'],
                                                 embedding['image_size'])
    return pnet + rnet + onet + emb
