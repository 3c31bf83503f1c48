"""A network's weights made on the device from the seed, in one draw.

Both the program and the reference take the same tree: the program as
the flax-layout numpy tree its loaders read (`nested_numpy`), the
reference as the flat tree of tensors itself. The reference makes the
tree again from the seed after the window, so no copy stays on the card
while the program runs.

Kernels are glorot-uniform, as flax and the program initialise them. For
inference the BatchNorm biases, running means and variances and the
residual up-projections' biases are drawn too, so that folding them is
real work; for training they start as a fresh model's do (biases 0, mean
0, variance 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.core.seeds import device_generator


def make(spec, seed, device, trained_stats=True):
    """{name: float32 tensor on `device`} for a `spec` {name: (shape,
    kind)}; one uniform draw for the whole tree."""
    names = sorted(spec)
    sizes = [math.prod(spec[n][0]) for n in names]
    gen = device_generator(seed, device, 'weights')
    u = torch.rand(sum(sizes), generator=gen, device=device)
    leaves, start = {}, 0
    for name, size in zip(names, sizes):
        shape, kind = spec[name]
        x = u[start:start + size].view(shape)
        start += size
        if kind == 'kernel':
            receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
            fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
            x = (2 * x - 1) * math.sqrt(6.0 / (fan_in + fan_out))
        elif kind == 'var':
            x = 0.5 + x if trained_stats else torch.ones_like(x)
        elif kind in ('bias', 'bn_bias', 'mean'):
            x = (0.2 * x - 0.1) if trained_stats else torch.zeros_like(x)
        else:
            raise ValueError(f'{name}: unknown kind {kind!r}')
        leaves[name] = x.clone()
    return leaves


def nested_numpy(leaves, rename=None):
    """A flat {a/b/c: tensor} tree as nested dicts of float32 numpy
    arrays; `rename` maps a flat name to another first."""
    tree = {}
    for name, value in leaves.items():
        name = rename(name) if rename else name
        *path, leaf = name.split('/')
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.detach().float().cpu().numpy()
    return tree


def flat(tree, prefix=''):
    """The inverse of `nested_numpy`: {a/b/c: array}."""
    out = {}
    for key, value in tree.items():
        name = f'{prefix}{key}'
        if isinstance(value, dict):
            out.update(flat(value, name + '/'))
        else:
            out[name] = np.asarray(value)
    return out
