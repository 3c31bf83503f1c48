"""How far the train steps of the two packages lie from float64.

    PYTHONPATH=. python tests/precision_probe.py     # from the repo root, ~10 minutes on a CPU

On the TINY Inception-ResNet-v1 and the batches of tests/test_torch_train.py
it prints, for its softmax and its triplet-only loss:

  * the step-0 gradient of every parameter leaf, from JAX's float32 run,
    the port's float32 run and the port's float64 run, against JAX's
    float64 run (``jax.enable_x64``, op by op): the worst leaf's max
    |g - g64| over that leaf's max |g64| (leaves whose exact gradient is 0
    left out);
  * after 1 and after 3 steps, the worst leaf's max |d - d64| over the
    largest entry of that leaf's change d64 in JAX's float64 step run op
    by op (leaves that move by less than 1e-6 left out: their exact
    gradient is 0), for JAX's float64 step under `jax.jit`, the port's
    float64 step, JAX's float32 step under `jax.jit` and the port's
    float32 step.

These are the figures behind the bounds of tests/test_torch_train.py and
tests/test_torch_train_float64.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_testing as T
from facenet_tpu.ops import losses as jax_losses
from facenet_tpu.train import softmax as jax_softmax
from facenet_tpu.models.inception_resnet_v1 import \
    InceptionResnetV1 as JaxIRv1
from facenet_tpu.models.inception_resnet_v1 import \
    l2_regularization as jax_l2
from facenet_tpu_torch.models import inception_resnet_v1 as irv1
from facenet_tpu_torch.ops import losses
from facenet_tpu_torch.train.softmax import SoftmaxClassifier, create_backbone


def jax_gradient(variables, loss, images, labels, dtype):
    model = jax_softmax.SoftmaxClassifier(
        backbone=JaxIRv1(config=T.TINY, dtype=dtype), nrof_classes=T.C,
        dtype=dtype)
    wdt = jnp.float64 if dtype == jnp.float64 else jnp.float32
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, wdt), variables)

    def total(params):
        (logits, prelogits), _ = model.apply(
            {'params': params, 'batch_stats': v['batch_stats']}, images,
            train=True, mutable=['batch_stats'])
        out = (float(loss.get('softmax_factor', 1.0))
               * jax_losses.softmax_cross_entropy_with_logits(logits, labels)
               + jax_l2(params))
        if loss.get('triplet_factor'):
            e = prelogits / jnp.sqrt(jnp.maximum(
                jnp.sum(prelogits ** 2, axis=1, keepdims=True), 1e-10))
            out = out + jax_losses.triplet_semihard_loss(e, labels, 0.2)
        return out

    return jax.tree_util.tree_map(np.asarray, jax.grad(total)(v['params']))


def port_gradient(variables, loss, images, labels, dtype):
    model = SoftmaxClassifier(create_backbone(T.TINY), T.C)
    model.from_flax_variables(variables).to(dtype)
    logits, prelogits = model(torch.from_numpy(images), train=True,
                              dtype=dtype)
    lab = torch.from_numpy(labels)
    out = (float(loss.get('softmax_factor', 1.0))
           * losses.softmax_cross_entropy_with_logits(logits, lab)
           + irv1.l2_regularization(model))
    if loss.get('triplet_factor'):
        e = prelogits / torch.sqrt(torch.clamp(
            prelogits.square().sum(1, keepdim=True), min=1e-10))
        out = out + losses.triplet_semihard_loss(e, lab, 0.2)
    out.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return model.to(torch.float64).to_flax_variables()['params']


def worst(tree, reference):
    """The worst leaf's relative error, among leaves whose gradient is not
    0 but for rounding (largest entry above 1e-6 of the largest of all)."""
    leaves = jax.tree_util.tree_leaves_with_path(reference)
    floor = 1e-6 * max(np.abs(want).max() for _, want in leaves)
    rows = []
    for path, want in leaves:
        got = tree
        for key in path:
            got = got[key.key]
        scale = np.abs(want).max()
        if scale > floor:
            rows.append((np.abs(np.asarray(got, np.float64) - want).max()
                         / scale, jax.tree_util.keystr(path)))
    return max(rows)


def main():
    variables = T.carried_variables(T.TINY)
    for name in ('softmax', 'triplet'):
        loss = T.LOSSES[name]
        images, labels = T._batches(1, pk=name == 'triplet',
                                    seed=len(name))[0]
        with jax.enable_x64(True):
            ref = jax_gradient(variables, loss, images, labels, jnp.float64)
        rows = {
            'JAX float32': jax_gradient(variables, loss, images, labels,
                                        jnp.float32),
            'port float32': port_gradient(variables, loss, images, labels,
                                          torch.float32),
            'port float64': port_gradient(variables, loss, images, labels,
                                          torch.float64),
        }
        for label, grads in rows.items():
            err, leaf = worst(grads, ref)
            print(f'{name}: step-0 gradient, {label} vs JAX float64: worst '
                  f'leaf {err:.3e} of its largest entry ({leaf})')

        for steps in (1, 3):
            batches = T._batches(steps, pk=name == 'triplet', seed=len(name))
            with jax.enable_x64(True):
                _, exact = T._jax_run(variables, loss, batches, jnp.float64,
                                      jit=False)
                _, jit64 = T._jax_run(variables, loss, batches, jnp.float64)
            rows = {
                'JAX float64 jitted': jit64['params'],
                'port float64': port_params(variables, loss, batches,
                                            torch.float64),
                'JAX float32 jitted': T._jax_run(variables, loss,
                                                 batches)[1]['params'],
                'port float32': port_params(variables, loss, batches,
                                            torch.float32),
            }
            for label, params in rows.items():
                err, leaf = worst_change(params, exact['params'],
                                         variables['params'])
                print(f'{name}: after {steps} step(s), {label} vs JAX float64 '
                      f'op by op: worst leaf {err:.3e} of its largest change '
                      f'({leaf})')


def port_params(variables, loss, batches, dtype):
    _, state = T._port_run(variables, loss, batches, dtype)
    return state.model.to_flax_variables()['params']


def worst_change(tree, exact, start):
    """The worst leaf's max |got - exact| over the largest entry of its
    exact change, among leaves that move by more than 1e-6."""
    rows = []
    for path, want in jax.tree_util.tree_leaves_with_path(exact):
        got, before = tree, start
        for key in path:
            got, before = got[key.key], before[key.key]
        moved = np.abs(np.asarray(want) - before).max()
        if moved > 1e-6:
            rows.append((np.abs(np.asarray(got, np.float64) - want).max()
                         / moved, jax.tree_util.keystr(path)))
    return max(rows)

if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')
    main()
