"""The reference's folded-BN h5 weight format for Inception-ResNet-v1.

The reference exports a trained model as one pair of datasets per conv or
dense unit, ``<tf_scope>/weights`` and ``<tf_scope>/biases``, with
BatchNorm folded into them (``scale = 1/sqrt(var + eps)``, ``weights *=
scale``, ``biases = beta - mean * scale``). The tf scopes are the
tf-slim graph's, e.g.::

    InceptionResnetV1/Conv2d_1a_3x3/weights
    InceptionResnetV1/Repeat/block35_1/Branch_0/Conv2d_1x1/weights
    InceptionResnetV1/Bottleneck/weights

The flax names of the network (kept by the port's modules) are those
scopes with '.' where tf has '/', so the units are found by walking the
flax-layout parameter tree (`iter_units`) and every topology the config
expresses maps without a name table. Conv kernels are HWIO and dense
kernels [in, out] in both formats, so values copy through.

Every function works on the flax-layout ``{'params', 'batch_stats'}``
tree of numpy arrays that the port's modules load (`from_flax_variables`)
and make (`init_variables`). An imported tree carries identity BatchNorm
statistics (mean 0, var 1 - eps, so ``rsqrt(var + eps)`` is 1) and the
folded bias in the BN beta, which reproduces the inference forward; the
fold discards the raw statistics.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from facenet_tpu_torch import h5utils
from facenet_tpu_torch.models.inception_resnet_v1 import (BN_EPS,
                                                           init_variables)

DEFAULT_SCOPE = 'InceptionResnetV1'


def _is_conv_bn(node):
    return isinstance(node, dict) and 'conv' in node and 'bn' in node


def _is_plain_conv(node):
    return isinstance(node, dict) and 'kernel' in node and 'bias' in node


def iter_units(params):
    """Yield (scope, kind, path) for every unit of a backbone param tree.

    scope: the '/'-separated tf scope (flax '.' separators expanded);
    kind: 'conv_bn' (ConvBnRelu), 'conv' (a conv with bias) or 'dense_bn'
    (the Bottleneck and its sibling '<name>.bn'); path: the keys from the
    root to the unit's dict.
    """
    def scope(sub):
        return '/'.join(p.replace('.', '/') for p in sub)

    def walk(node, path):
        if not isinstance(node, dict):
            return
        for key, child in sorted(node.items()):
            sub = path + (key,)
            if _is_conv_bn(child):
                yield scope(sub), 'conv_bn', sub
            elif _is_plain_conv(child):
                yield scope(sub), 'conv', sub
            elif isinstance(child, dict) and 'kernel' in child and (
                    key + '.bn') in node:
                yield scope(sub), 'dense_bn', sub
            elif key.endswith('.bn'):
                continue   # its dense sibling takes it
            else:
                yield from walk(child, sub)

    yield from walk(params, ())


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _fold(kernel, beta, mean, var):
    scale = 1.0 / np.sqrt(np.asarray(var, np.float32) + BN_EPS)
    return (np.asarray(kernel, np.float32) * scale,
            np.asarray(beta, np.float32) - np.asarray(mean, np.float32) * scale)


def reference_units(variables):
    """A backbone's variables ({'params', 'batch_stats'}) as the
    reference's folded units: {tf scope: (weights, biases)}, float32, the
    model scope not prefixed. What `export_ref_h5` writes and
    `import_units` reads."""
    params = variables['params']
    stats = variables['batch_stats']
    units = {}
    for scope_path, kind, path in iter_units(params):
        node = _get(params, path)
        if kind == 'conv_bn':
            snode = _get(stats, path)
            units[scope_path] = _fold(node['conv']['kernel'],
                                      node['bn']['bias'],
                                      snode['bn']['mean'], snode['bn']['var'])
        elif kind == 'dense_bn':
            bn_path = path[:-1] + (path[-1] + '.bn',)
            bn = _get(params, bn_path)
            sbn = _get(stats, bn_path)
            units[scope_path] = _fold(node['kernel'], bn['bias'],
                                      sbn['mean'], sbn['var'])
        else:
            units[scope_path] = (np.asarray(node['kernel'], np.float32),
                                 np.asarray(node['bias'], np.float32))
    return units


def export_ref_h5(variables, h5file, scope=DEFAULT_SCOPE):
    """Write a backbone's variables in the reference's folded h5 schema,
    ``<scope>/<tf scope>/{weights,biases}``; the inverse of
    `import_h5_weights`."""
    h5file = Path(h5file)
    for scope_path, (w, b) in reference_units(variables).items():
        h5utils.write(h5file, f'{scope}/{scope_path}/weights', w)
        h5utils.write(h5file, f'{scope}/{scope_path}/biases', b)
    return h5file


def _read_pairs(h5file):
    """Every (scope, weights, biases) of the file, the model scope
    stripped. A dump of the reference's export_h5 also holds a top-level
    'checkpoint/' group and per-unit '<path>/checkpoint/...' activations:
    datasets under a 'checkpoint' group are skipped at either level."""
    names = [d['name'] for d in h5utils.visititems(h5file)
             if d['name'].endswith('/weights')]
    pairs = {}
    for name in names:
        scope_path = name[:-len('/weights')]
        if 'checkpoint' in scope_path.split('/'):
            continue
        pairs[scope_path] = (h5utils.read(h5file, name),
                             h5utils.read(h5file, scope_path + '/biases'))
    if not pairs:
        raise ValueError(f'no <scope>/weights datasets in {h5file}')
    roots = {p.split('/', 1)[0] for p in pairs}
    if len(roots) == 1 and all('/' in p for p in pairs):
        pairs = {p.split('/', 1)[1]: v for p, v in pairs.items()}
    return pairs


def _identity_stats(stats):
    stats['mean'] = np.zeros_like(stats['mean'])
    stats['var'] = np.full_like(stats['var'], 1.0 - BN_EPS)


def _like(array, target):
    return np.asarray(array, np.float32).reshape(target.shape)


def import_h5_weights(h5file, config=None, image_size=160, normalization=0):
    """Reference-schema h5 -> the ``{'params', 'batch_stats'}`` tree of an
    InceptionResnetV1 of `config` (`import_units` on the file's units).
    `normalization` is the bundle's and does not change the tree."""
    return import_units(_read_pairs(h5file), config, image_size,
                        source=h5file)


def import_units(units, config=None, image_size=160, source='the units'):
    """Folded units ({tf scope: (weights, biases)}, `reference_units`) ->
    the ``{'params', 'batch_stats'}`` tree of an InceptionResnetV1 of
    `config` (numpy, flax layout), ready for `from_flax_variables`,
    `FaceNet`'s bundles or `irv1_fast.build_fast_params`; BatchNorm
    statistics are the identity.

    :raises KeyError: when a unit of the model is missing from `units`, or
        a unit of `units` has no target in the model
    """
    template = init_variables(config, image_size=image_size)
    params = _zeros(template['params'])
    stats = _zeros(template['batch_stats'])
    unused = set(units)

    for scope_path, kind, path in iter_units(params):
        if scope_path not in units:
            raise KeyError(
                f'model unit {scope_path!r} ({kind}) missing from {source}')
        w, b = units[scope_path]
        unused.discard(scope_path)
        node = _get(params, path)
        if kind == 'conv_bn':
            node['conv']['kernel'] = _like(w, node['conv']['kernel'])
            node['bn']['bias'] = _like(b, node['bn']['bias'])
            _identity_stats(_get(stats, path)['bn'])
        elif kind == 'dense_bn':
            node['kernel'] = _like(w, node['kernel'])
            bn_path = path[:-1] + (path[-1] + '.bn',)
            bn = _get(params, bn_path)
            bn['bias'] = _like(b, bn['bias'])
            _identity_stats(_get(stats, bn_path))
        else:
            node['kernel'] = _like(w, node['kernel'])
            node['bias'] = _like(b, node['bias'])

    if unused:
        raise KeyError(f'h5 weight units with no model target: '
                       f'{sorted(unused)[:5]}{"..." if len(unused) > 5 else ""}')

    return {'params': params, 'batch_stats': stats}


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return np.zeros(np.shape(tree), np.float32)
