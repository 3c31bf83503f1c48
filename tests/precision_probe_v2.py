"""How far the TINY Inception-ResNet-v2's float64 train steps of the two
packages lie apart, and where the port's own run leaves JAX's.

    PYTHONPATH=.:tests python tests/precision_probe_v2.py   # from the repo root, ~6 minutes on a CPU

On the carried variables and batches of tests/test_torch_train_v2.py it
prints:

  * the float32 train-mode forward's gradients (sum(out * w) w.r.t. every
    backbone parameter) against flax's jitted ones: the worst leaf's max
    |g - g_flax| over its max |g_flax|, the zero-gradient leaf left out;
  * the step-0 float64 gradient of every backbone leaf, the port's against
    JAX's run op by op, the same measure (the leaf whose exact gradient is
    0, the last block's up-projection bias ahead of the Conv2d_7b
    BatchNorm, left out);
  * after each of 3 softmax steps of each package's own run, the worst
    leaf's max |port - jax| over the largest entry of JAX's change of
    that leaf, against JAX's step op by op and under `jax.jit`;
  * each step of the port from the state JAX's op-by-op run reached
    before it (weights, statistics, Adam's moments and count): the same
    measure for the weights and statistics, Adam's first and its second
    moment;
  * every ReLU whose input changes sign, and every max-pool whose choice
    changes, between the forward of steps 2 and 3 from the port's own
    state and from JAX's: the module, the element and the input there
    from each state.

These are the figures behind the bounds of tests/test_torch_train_v2.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

import torch_testing as T
from facenet_tpu.models.inception_resnet_v1 import \
    l2_regularization as jax_l2
from facenet_tpu.models.inception_resnet_v2 import \
    InceptionResnetV2 as JaxIRv2
from facenet_tpu.ops import losses as jax_losses
from facenet_tpu.train import softmax as jax_softmax
from facenet_tpu_torch.models import inception_resnet_v1 as irv1
from facenet_tpu_torch.models import inception_resnet_v2 as irv2
from facenet_tpu_torch.ops import losses
from facenet_tpu_torch.train.softmax import SoftmaxClassifier, create_backbone


def step0_gradients(variables, images, labels):
    model = T._jax_model(jnp.float64)
    put = lambda t: jax.tree_util.tree_map(     # noqa: E731
        lambda a: jnp.asarray(a, jnp.float64), t)
    stats = put(variables['batch_stats'])

    def loss(params):
        (logits, _), _ = model.apply(
            {'params': params, 'batch_stats': stats}, images, train=True,
            mutable=['batch_stats'], rngs={'dropout': jax.random.PRNGKey(0)})
        return (jax_losses.softmax_cross_entropy_with_logits(logits, labels)
                + jax_l2(params))

    with jax.enable_x64(True):
        want = jax.grad(loss)(put(variables['params']))['backbone']
    port = SoftmaxClassifier(create_backbone(T.MODEL_V2), T.C)
    port.from_flax_variables(variables)
    port.double()
    logits, _ = port(torch.from_numpy(images), train=True,
                     dtype=torch.float64)
    (losses.softmax_cross_entropy_with_logits(
        logits, torch.from_numpy(labels).long())
     + irv1.l2_regularization(port)).backward()
    got = T._grads(port.backbone)
    worst = 0.0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        if jax.tree_util.keystr(path) == "['Block8']['Conv2d_1x1']['bias']":
            continue
        g = got
        for key in path:
            g = g[key.key]
        w = np.asarray(w)
        worst = max(worst, np.abs(g - w).max() / np.abs(w).max())
    return worst


def float32_gradients(variables):
    images, _ = T._batches(1, seed=5)[0]
    weight = np.random.RandomState(6).randn(8, 32).astype(np.float32)
    flax = JaxIRv2(config=T.TINY_V2, dtype=jnp.float32)
    bb = {'params': variables['params']['backbone'],
          'batch_stats': variables['batch_stats']['backbone']}

    def loss(params):
        out, _ = flax.apply({'params': params,
                             'batch_stats': bb['batch_stats']},
                            images, train=True, mutable=['batch_stats'])
        return jnp.sum(out * weight)

    want = jax.jit(jax.grad(loss))(bb['params'])
    port = irv2.InceptionResnetV2(T.TINY_V2).from_flax_variables(bb)
    (port(torch.from_numpy(images), train=True)
     * torch.from_numpy(weight)).sum().backward()
    got = T._grads(port)
    worst = 0.0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        if jax.tree_util.keystr(path) == "['Block8']['Conv2d_1x1']['bias']":
            continue
        g = got
        for key in path:
            g = g[key.key]
        w = np.asarray(w)
        worst = max(worst, np.abs(g - w).max() / np.abs(w).max())
    return worst


def weights(state):
    """The parameters and BatchNorm statistics of a `_jax_steps` state."""
    return {'params': state['params'], 'batch_stats': state['batch_stats']}


def port_states(variables, batches):
    trainer, state = T._port_trainer_v2(variables, torch.float64)
    states = []
    for images, labels in batches:
        state, _ = trainer.step_fn(state, *trainer.placed(images, labels))
        states.append(state.model.to_flax_variables())
    return states


def forced_steps(variables, batches, jax_states):
    """Each step of the port from the state JAX reached before it: the
    worst leaf of the weights and statistics, of Adam's first and of its
    second moment."""
    trainer, state = T._port_trainer_v2(variables, torch.float64)
    start = {**variables, **jax.tree_util.tree_map(
        np.zeros_like, {'mu': jax_states[0]['mu'],
                        'nu': jax_states[0]['nu']})}
    out = []
    for (images, labels), want in zip(batches, jax_states):
        if 'count' in start:
            T._set_state(state, start)
        state, _ = trainer.step_fn(state, *trainer.placed(images, labels))
        port = {**state.model.to_flax_variables(), **T._adam_moments(state)}
        out.append([T._worst_leaf({k: port[k] for k in keys},
                                  {k: want[k] for k in keys},
                                  {k: start[k] for k in keys})
                    for keys in (('params', 'batch_stats'), ('mu',),
                                 ('nu',))])
        start = want
    return out


def decisions(tree, images):
    """The sign of every ReLU's input and the choice of every max-pool of
    one float64 train-mode forward of the TINY IRv2 from a variables tree,
    in call order, each with the name of the module that makes it."""
    trainer, state = T._port_trainer_v2(tree, torch.float64)
    backbone = state.model.backbone
    names = {m: n for n, m in backbone.named_modules()}
    stack, out = [], []

    def enter(module, args):
        stack.append(names[module])

    def leave(module, args, output):
        stack.pop()

    hooks = [m.register_forward_pre_hook(enter) for m in backbone.modules()]
    hooks += [m.register_forward_hook(leave) for m in backbone.modules()]
    relu, pool = F.relu, F.max_pool2d

    def record_relu(x, *args, **kwargs):
        out.append((stack[-1], 'relu', x > 0, x.detach().clone()))
        return relu(x, *args, **kwargs)

    def record_pool(x, *args, **kwargs):
        y, index = pool(x, *args, return_indices=True, **kwargs)
        out.append((stack[-1], 'max_pool', index, None))
        return y

    F.relu, F.max_pool2d = record_relu, record_pool
    try:
        with torch.no_grad():
            backbone(trainer.placed(images, np.zeros(8, np.int32))[0],
                     train=True, dtype=torch.float64)
    finally:
        F.relu, F.max_pool2d = relu, pool
        for hook in hooks:
            hook.remove()
    return out


def flips(port_tree, jax_tree, images):
    """The decisions that differ between the forwards from the port's and
    from JAX's state: (module, kind, element, the input there from each)."""
    out = []
    for (name, kind, a, x), (_, _, b, y) in zip(
            decisions(port_tree, images), decisions(jax_tree, images)):
        for element in (a != b).nonzero().tolist():
            at = tuple(element)
            out.append((name or 'the network', kind, at,
                        None if x is None else (float(x[at]), float(y[at]))))
    return out


def main():
    torch.set_num_threads(4)
    variables = T.carried_variables(T.MODEL_V2)
    batches = T._batches(3, seed=9)
    print('float32 train-mode gradients, port vs flax jitted: '
          f'{float32_gradients(variables):.3e}')
    print('step-0 float64 gradient, port vs JAX op by op: '
          f'{step0_gradients(variables, *batches[0]):.3e}')
    port = port_states(variables, batches)
    with jax.enable_x64(True):
        by_op = [s for _, s in T._jax_steps(variables, batches)]
        make = jax_softmax.make_train_step
        jax_softmax.make_train_step = lambda *a, **k: jax.jit(make(*a, **k))
        try:
            jitted = [s for _, s in T._jax_steps(variables, batches)]
        finally:
            jax_softmax.make_train_step = make
    for name, ref in (('op by op', by_op), ('jitted', jitted)):
        print(f'port vs JAX {name}, steps 1-3 of each run: ' + ', '.join(
            f'{T._worst_leaf(port[i], weights(ref[i]), variables):.3e}'
            for i in range(3)))
    for step, worst in enumerate(forced_steps(variables, batches, by_op)):
        print(f'step {step + 1} from JAX\'s state before it (weights and '
              f'statistics, mu, nu): ' + ', '.join(f'{w:.3e}' for w in worst))
    for step in (1, 2):
        found = flips(port[step - 1], weights(by_op[step - 1]),
                      batches[step][0])
        print(f'decisions of step {step + 1}\'s forward that differ between '
              f'the port\'s state and JAX\'s: {found or "none"}')


if __name__ == '__main__':
    main()
