"""Fixtures and helpers the port's test modules share (not collected: no
test module imports another, they import from here).

  * `few_threads`: two torch threads for a module (autouse once imported);
  * the TINY Inception-ResNet-v1 trainer of tests/test_torch_train.py and
    tests/test_torch_train_float64.py: its config, batches, carried
    `variables`, JAX's own run (`_jax_run`) and the port's (`_port_run`);
  * the TINY Inception-ResNet-v2's float64 steps of
    tests/test_torch_train_v2.py: JAX's op by op (`_jax_steps`), the port's
    trainer (`_port_trainer_v2`) moved to a JAX state (`_set_state`), and
    the per-leaf measure (`_worst_leaf`);
  * the train app's synthetic identity set (`identity_tree`), config and
    checks;
  * TINY variables with BatchNorm statistics and biases off their init
    (`randomized_variables`).

The precision probes (tests/precision_probe.py, tests/precision_probe_v2.py)
use the same helpers. JAX is imported inside the helpers that run it, so
that a module which takes only `few_threads` imports none of it.
"""

import copy

import numpy as np
import pytest
import torch

from facenet_tpu_torch.config import Config
from facenet_tpu_torch.models.inception_resnet_v1 import init_variables
from facenet_tpu_torch.train.softmax import (SoftmaxClassifier,
                                             SoftmaxTrainer, create_backbone)
from facenet_tpu_torch.utils.synthetic import write_identity_dataset


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two torch threads: the suite runs six workers on the machine's
    cores, and a worker whose CPU convolutions ask for all of them waits
    on the others' (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The TINY Inception-ResNet-v1 trainer
# ---------------------------------------------------------------------------

TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}, 'output': {'size': 32}}
C = 4
SCHEDULE = [[1, 1e-3], [2, 4e-4], [100, 2e-4]]     # one step an epoch
LOSSES = {
    'softmax': {'center_factor': 0.0, 'triplet_factor': 0.0},
    'softmax + center': {'center_factor': 0.5, 'center_alfa': 0.9,
                         'triplet_factor': 0.0},
    'triplet': {'softmax_factor': 0.0, 'triplet_factor': 1.0,
                'triplet_margin': 0.2, 'center_factor': 0.0},
}


def _batches(n, pk=False, seed=0, size=8):
    """uint8 batches of `size`: a class base image plus noise; class-major
    P x K (4 x 2) labels when `pk`, random labels otherwise."""
    rng = np.random.RandomState(seed)
    bases = rng.randint(0, 255, (C, 160, 160, 3)).astype(np.float32)
    out = []
    for _ in range(n):
        labels = (np.repeat(np.arange(C), 2) if pk
                  else rng.randint(0, C, size)).astype(np.int32)
        images = np.clip(bases[labels] + 30 * rng.randn(size, 160, 160, 3),
                         0, 255).astype(np.uint8)
        out.append((images, labels))
    return out


def _train_cfg(loss, **train):
    return Config({
        'image': {'size': 160, 'normalization': 0},
        'train': {'adam_epsilon': 0.1, 'epoch': {'size': 1},
                  'learning_rate': {'schedule': SCHEDULE}, **train},
        'loss': loss,
    })


def carried_variables(model_cfg):
    """A classifier's variables with its BN statistics moved off their
    init."""
    import jax
    model = SoftmaxClassifier(create_backbone(model_cfg), C)
    tree = model.init_variables(seed=3)
    rng = np.random.RandomState(4)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(rng.normal(0.5, 0.2, a.shape)).astype(np.float32),
        tree['batch_stats'])
    return {'params': tree['params'], 'batch_stats': stats}


@pytest.fixture(scope='module')
def variables():
    """The carried variables of the TINY IRv1 classifier."""
    return carried_variables(TINY)


def _jax_run(variables, loss, batches, dtype=None, jit=True):
    """JAX's own step over `batches`: per-step metrics and the final
    state as numpy trees. Weights are held in float64 when `dtype` is
    (call under ``jax.enable_x64(True)``), else in float32 (`dtype` None:
    float32). `jit` false runs the step op by op (see
    tests/test_torch_train_float64.py)."""
    import jax
    import jax.numpy as jnp
    import optax
    from facenet_tpu.config import Config as JaxConfig
    from facenet_tpu.models.inception_resnet_v1 import \
        InceptionResnetV1 as JaxIRv1
    from facenet_tpu.ops import lr_schedules as jax_lr
    from facenet_tpu.train import softmax as jax_softmax

    dtype = jnp.float32 if dtype is None else dtype
    model = jax_softmax.SoftmaxClassifier(
        backbone=JaxIRv1(config=TINY, dtype=dtype), nrof_classes=C,
        dtype=dtype)
    tx = optax.adam(jax_lr.piecewise_schedule(SCHEDULE, 1), eps=0.1)
    step = jax_softmax.make_train_step(model, tx, JaxConfig(loss))
    if jit:
        step = jax.jit(step)
    wdt = jnp.float64 if dtype == jnp.float64 else jnp.float32

    def put(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, wdt), tree)

    params = put(variables['params'])
    centers = (jnp.zeros((C, 32), wdt) if loss['center_factor'] else None)
    state = jax_softmax.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=put(variables['batch_stats']),
        opt_state=tx.init(params), centers=centers,
        rng=jax.random.PRNGKey(0))
    metrics = []
    for images, labels in batches:
        state, m = step(state, images, labels)
        metrics.append({k: float(v) for k, v in m.items()})
    host = jax.tree_util.tree_map(np.asarray, {
        'params': state.params, 'batch_stats': state.batch_stats,
        'centers': state.centers})
    return metrics, host


def _port_trainer(variables, loss, dtype=torch.float32, model=TINY,
                  **train):
    trainer = SoftmaxTrainer(_train_cfg(loss, **train), C, model_cfg=model,
                             device='cpu', dtype=dtype)
    state = trainer.init_state(seed=0)
    state.model.from_flax_variables(variables)
    return trainer, state


def _port_run(variables, loss, batches, dtype=torch.float32, **train):
    trainer, state = _port_trainer(variables, loss, dtype, **train)
    metrics = []
    for images, labels in batches:
        state, m = trainer.step_fn(state, *trainer.placed(images, labels))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


# ---------------------------------------------------------------------------
# The TINY Inception-ResNet-v2's float64 steps
# ---------------------------------------------------------------------------

TINY_V2 = {'repeat': [1, 1, 1], 'embedding_size': 32,
           'keep_probability': 1.0}
MODEL_V2 = {'module': 'inception_resnet_v2', 'config': TINY_V2}
SOFTMAX = LOSSES['softmax']


def _jax_model(dtype):
    from facenet_tpu.models.inception_resnet_v2 import \
        InceptionResnetV2 as JaxIRv2
    from facenet_tpu.train import softmax as jax_softmax
    return jax_softmax.SoftmaxClassifier(
        backbone=JaxIRv2(config=TINY_V2, dtype=dtype), nrof_classes=C,
        dtype=dtype)


def _grads(module):
    """The parameters' gradients as a flax-layout tree (HWIO kernels)."""
    saved = {}
    for name, p in module.named_parameters():
        saved[name] = p.data.clone()
        p.data.copy_(p.grad)
    try:
        params, _ = module.dump_flax()
    finally:
        for name, p in module.named_parameters():
            p.data.copy_(saved[name])
    return params


def _jax_steps(variables, batches):
    """JAX's own float64 step, op by op (see tests/test_torch_train_v2.py),
    yielding after each step the metrics and the state: the parameters,
    the BatchNorm statistics and Adam's moments ('mu', 'nu') and count."""
    import jax
    import jax.numpy as jnp
    import optax
    from facenet_tpu.config import Config as JaxConfig
    from facenet_tpu.ops import lr_schedules as jax_lr
    from facenet_tpu.train import softmax as jax_softmax

    model = _jax_model(jnp.float64)
    tx = optax.adam(jax_lr.piecewise_schedule(SCHEDULE, 1), eps=0.1)
    step = jax_softmax.make_train_step(model, tx, JaxConfig(SOFTMAX))

    def put(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      tree)

    params = put(variables['params'])
    state = jax_softmax.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=put(variables['batch_stats']),
        opt_state=tx.init(params), centers=None, rng=jax.random.PRNGKey(0))
    for images, labels in batches:
        state, m = step(state, images, labels)
        adam = state.opt_state[0]
        yield {k: float(v) for k, v in m.items()}, jax.tree_util.tree_map(
            np.asarray, {'params': state.params,
                         'batch_stats': state.batch_stats,
                         'mu': adam.mu, 'nu': adam.nu,
                         'count': adam.count})


def _port_trainer_v2(variables, dtype, model=MODEL_V2, **train):
    return _port_trainer(variables, SOFTMAX, dtype, model, **train)


def _set_state(state, jax_state):
    """`state` moved to a JAX state of `_jax_steps`: the weights, the
    BatchNorm statistics, Adam's moments and its count (the schedule's
    step)."""
    model = state.model
    model.from_flax_variables(jax_state)
    moments = copy.deepcopy(model)
    for key, name in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
        moments.from_flax_variables({'params': jax_state[key],
                                     'batch_stats': jax_state['batch_stats']})
        for p, m in zip(model.parameters(), moments.parameters()):
            state.optimizer.state[p][name] = m.detach().clone()
    count = int(jax_state['count'])
    for p in model.parameters():
        state.optimizer.state[p]['step'] = torch.tensor(float(count))
    state.step = count
    return state


def _adam_moments(state):
    """The port's Adam moments as flax-layout trees {'mu', 'nu'}."""
    moments = copy.deepcopy(state.model)
    out = {}
    for key, name in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
        with torch.no_grad():
            for p, m in zip(state.model.parameters(), moments.parameters()):
                m.copy_(state.optimizer.state[p][name])
        out[key] = moments.to_flax_variables()['params']
    return out


def _worst_leaf(port_state, jax_state, start):
    """max over leaves of max |port - jax| / max |jax's change| (+1e-12
    forgiven outright), both float64."""
    import jax
    worst = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(jax_state):
        got, before = port_state, start
        for key in path:
            got, before = got[key.key], before[key.key]
        assert got.dtype == want.dtype == np.float64, path
        moved = np.abs(want - np.asarray(before, np.float64)).max()
        worst = max(worst, (np.abs(got - want).max() - 1e-12)
                    / max(moved, 1e-300))
    return worst


# ---------------------------------------------------------------------------
# The train app
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def identity_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('identities')
    write_identity_dataset(root / 'train', 5, 6, size=160, seed=0)
    write_identity_dataset(root / 'test', range(5, 9), 5, size=160, seed=1)
    return root


def _app_config(root, run_dir):
    return {
        'dataset': {'path': str(root / 'train')},
        'model': {'path': str(run_dir), 'config': TINY},
        'batch_size': 8,
        'seed': 0,
        'train': {'adam_epsilon': 0.1,
                  'epoch': {'max_nrof_epochs': 2, 'size': 2},
                  'learning_rate': {'schedule': [[2, 0.01]]}},
        'loss': {'center_factor': 0.0, 'triplet_factor': 0.0},
        'image': {'size': 160, 'normalization': 0},
        'mesh': {'data': 1, 'model': 1},
        'checkpoint': {'max_to_keep': 1},
        'validate': {'every_n_epochs': 1,
                     'dataset': {'path': str(root / 'test')},
                     'validate': {'metric': 0, 'nrof_folds': 2,
                                  'far_target': 0.1}},
    }


def _check_run(run_root):
    runs = list(run_root.glob('*'))
    assert len(runs) == 1
    run = runs[0]
    report = (run / 'logs' / 'report.txt').read_text()
    assert 'epoch [2/2]' in report
    assert report.count('FaceToFaceValidation') == 2       # every epoch
    assert 'MaximumAccuracy' in report
    assert (run / 'model.yaml').is_file() and (run / 'params.msgpack').is_file()
    assert list((run / 'checkpoints').glob('*'))
    return run


# ---------------------------------------------------------------------------
# Weights with work for the BatchNorm fold
# ---------------------------------------------------------------------------

def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def randomized_variables(seed=0):
    """TINY variables whose BN statistics and biases are off their init,
    so that the fold does work."""
    variables = init_variables(TINY, seed=seed)
    rng = np.random.RandomState(seed + 1)

    def params(path, leaf):
        if leaf.ndim == 1:
            return rng.normal(0, 0.2, leaf.shape).astype(np.float32)
        return leaf

    def stats(path, leaf):
        if path[-1] == 'mean':
            return rng.normal(0, 0.3, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    return {'params': _map(variables['params'], params),
            'batch_stats': _map(variables['batch_stats'], stats)}
