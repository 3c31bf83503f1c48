"""Import the davidsandberg MTCNN weights, and check a parameter tree.

The davidsandberg upstream ships Caffe-trained P/R/O-Net weights as
``det1.npy / det2.npy / det3.npy`` dicts of dicts:

    {'conv1': {'weights': [h, w, in, out], 'biases': [out]},
     'PReLU1': {'alpha': [C]},
     ...,
     'conv4-1': ...cls head..., 'conv4-2': ...reg head...}

`load_davidsandberg_weights` maps them onto the flax tree the port's
networks load (`MTCNN(params=...)`), as the JAX package's importer does:

  * the dense layers after a flatten assume the NHWC flatten order;
    ``fc_order='nchw'`` permutes weights made for a channels-first flatten;
  * the upstream runtime feeds transposed (W, H) images to the nets;
    ``transpose=True`` converts such weights to upright inputs exactly:
    conv kernels transposed spatially, the flatten rows permuted (h <-> w),
    the box-regression channels' x and y swapped, and the landmark x-block
    and y-block swapped.

`validate_params` shape-checks a tree against a cascade's networks.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from torch import nn

from facenet_tpu_torch.detectors.mtcnn.networks import PReLU


def _norm_keys(d):
    return {str(k).lower(): v for k, v in d.items()}


def _conv(entry, transpose=False, out_perm=None):
    w = np.asarray(entry['weights'], np.float32)
    b = np.asarray(entry['biases'], np.float32)
    if w.ndim != 4:
        raise ValueError(f'conv weights must be [h,w,in,out], got {w.shape}')
    if transpose:
        w = w.transpose(1, 0, 2, 3)         # swap kernel spatial axes
    if out_perm is not None:
        w = w[..., out_perm]
        b = b[out_perm]
    return {'kernel': w, 'bias': b}


def _dense(entry, feature_hwc=None, fc_order='nhwc', transpose=False,
           out_perm=None):
    w = np.asarray(entry['weights'], np.float32)
    b = np.asarray(entry['biases'], np.float32)
    if w.ndim != 2:
        raise ValueError(f'dense weights must be [in, out], got {w.shape}')
    if feature_hwc is not None and fc_order == 'nchw':
        # weights were built for a (C, H, W) flatten; our nets flatten NHWC
        h, wd, c = feature_hwc
        w = (w.reshape(c, h, wd, -1).transpose(1, 2, 0, 3)
             .reshape(h * wd * c, -1))
    if transpose and feature_hwc is not None:
        # upstream fed transposed feature maps: its flatten order is
        # (w, h, c) of our upright map — permute the input rows
        h, wd, c = feature_hwc
        w = (w.reshape(wd, h, c, -1).transpose(1, 0, 2, 3)
             .reshape(h * wd * c, -1))
    if out_perm is not None:
        w = w[:, out_perm]
        b = b[out_perm]
    return {'kernel': w, 'bias': b}


# output-channel permutations for transpose=True: box regression swaps
# (dx1, dy1, dx2, dy2) -> (dy1, dx1, dy2, dx2); landmarks swap the x-block
# and y-block ([x1..x5, y1..y5] layout)
_REG_PERM = [1, 0, 3, 2]
_LMK_PERM = list(range(5, 10)) + list(range(0, 5))


def _prelu(entry):
    return {'alpha': np.asarray(entry['alpha'], np.float32).reshape(-1)}


def pnet_params(data, fc_order='nhwc', transpose=False):
    d = _norm_keys(data)
    t = transpose
    return {
        'conv1': _conv(d['conv1'], transpose=t),
        'prelu1': _prelu(d['prelu1']),
        'conv2': _conv(d['conv2'], transpose=t),
        'prelu2': _prelu(d['prelu2']),
        'conv3': _conv(d['conv3'], transpose=t),
        'prelu3': _prelu(d['prelu3']),
        'cls': _conv(d['conv4-1'], transpose=t),
        'reg': _conv(d['conv4-2'], transpose=t,
                     out_perm=_REG_PERM if t else None),
    }


def rnet_params(data, fc_order='nhwc', transpose=False):
    d = _norm_keys(data)
    t = transpose
    return {
        'conv1': _conv(d['conv1'], transpose=t),
        'prelu1': _prelu(d['prelu1']),
        'conv2': _conv(d['conv2'], transpose=t),
        'prelu2': _prelu(d['prelu2']),
        'conv3': _conv(d['conv3'], transpose=t),
        'prelu3': _prelu(d['prelu3']),
        # R-Net flatten feature map is [3, 3, 64]
        'fc1': _dense(d['conv4'], feature_hwc=(3, 3, 64), fc_order=fc_order,
                      transpose=t),
        'prelu4': _prelu(d['prelu4']),
        'cls': _dense(d['conv5-1']),
        'reg': _dense(d['conv5-2'], out_perm=_REG_PERM if t else None),
    }


def onet_params(data, fc_order='nhwc', transpose=False):
    d = _norm_keys(data)
    t = transpose
    return {
        'conv1': _conv(d['conv1'], transpose=t),
        'prelu1': _prelu(d['prelu1']),
        'conv2': _conv(d['conv2'], transpose=t),
        'prelu2': _prelu(d['prelu2']),
        'conv3': _conv(d['conv3'], transpose=t),
        'prelu3': _prelu(d['prelu3']),
        'conv4': _conv(d['conv4'], transpose=t),
        'prelu4': _prelu(d['prelu4']),
        # O-Net flatten feature map is [3, 3, 128]
        'fc1': _dense(d['conv5'], feature_hwc=(3, 3, 128), fc_order=fc_order,
                      transpose=t),
        'prelu5': _prelu(d['prelu5']),
        'cls': _dense(d['conv6-1']),
        'reg': _dense(d['conv6-2'], out_perm=_REG_PERM if t else None),
        'landmarks': _dense(d['conv6-3'],
                            out_perm=_LMK_PERM if t else None),
    }


def load_davidsandberg_weights(path, fc_order='nhwc', transpose=False):
    """Load det1/det2/det3.npy from a directory (or a tuple of 3 paths).

    :param transpose: convert weights that expect transposed (W, H) inputs
        (the upstream runtime's convention) to upright-image inputs
    :returns: the flax tree {'pnet', 'rnet', 'onet'} for MTCNN(params=...)
    """
    if isinstance(path, (tuple, list)):
        p1, p2, p3 = (Path(str(p)).expanduser() for p in path)
    else:
        base = Path(str(path)).expanduser()
        p1, p2, p3 = base / 'det1.npy', base / 'det2.npy', base / 'det3.npy'

    def load(p):
        # the original davidsandberg files are Python-2 pickles; latin1 is
        # the standard decode for them and is harmless for py3 pickles
        data = np.load(p, allow_pickle=True, encoding='latin1')
        return data.item() if hasattr(data, 'item') else dict(data)

    return {
        'pnet': pnet_params(load(p1), fc_order=fc_order, transpose=transpose),
        'rnet': rnet_params(load(p2), fc_order=fc_order, transpose=transpose),
        'onet': onet_params(load(p3), fc_order=fc_order, transpose=transpose),
    }


def _flax_shapes(net):
    """{layer: {leaf: shape}} of a network in the flax param layout."""
    out = {}
    for name, child in net.named_children():
        if isinstance(child, PReLU):
            out[name] = {'alpha': tuple(child.alpha.shape)}
        elif isinstance(child, nn.Conv2d):
            o, i, kh, kw = child.weight.shape
            out[name] = {'kernel': (kh, kw, i, o), 'bias': (o,)}
        else:
            o, i = child.weight.shape
            out[name] = {'kernel': (i, o), 'bias': (o,)}
    return out


def validate_params(params, mtcnn):
    """Shape-check an MTCNN param tree against a cascade's networks.

    Raises ValueError naming every missing or mismatched leaf; returns
    `params` unchanged when all fit.
    """
    errors = []
    for net_name in ('pnet', 'rnet', 'onet'):
        for layer, leaves in _flax_shapes(getattr(mtcnn, net_name)).items():
            for leaf, want in leaves.items():
                name = f'{net_name}/{layer}/{leaf}'
                try:
                    val = params[net_name][layer][leaf]
                except (KeyError, TypeError):
                    errors.append(f'missing: {name}')
                    continue
                if tuple(np.shape(val)) != want:
                    errors.append(f'shape mismatch at {name}: got '
                                  f'{np.shape(val)}, want {want}')
    if errors:
        raise ValueError('imported MTCNN params invalid:\n  ' +
                         '\n  '.join(errors))
    return params
