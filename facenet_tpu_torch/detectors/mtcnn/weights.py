"""Shape check of an MTCNN parameter tree against the port's networks.

Importing the davidsandberg ``det1/det2/det3.npy`` files is not ported yet
(ROADMAP); only the check `FaceDetector` runs on the params it is given.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from facenet_tpu_torch.detectors.mtcnn.networks import PReLU


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
