"""The port's train step on a (data, model) process grid == the step on one
rank == the JAX package's step on its mesh, on the TINY Inception-ResNet-v1.

One group of 4 spawned gloo ranks on the CPU (`parallel.launch.spawn`,
tests/torch_grid_worker.py) takes one step of the same carried variables
on the (2,1), (1,2) and (2,2) grids in float64 and on the (2,2) grid in
float32, for softmax + center and for the triplet loss (a 4 x 2 P x K
batch), at global batch 8. Bounds:

  * float64 against the port's single-process step on the same global
    batch (random flips on: every rank draws the global batch's flips from
    the same generator): each leaf (parameters, BatchNorm statistics,
    centers) within 1e-6 of the largest entry of its update + 1e-12, the
    metrics at rtol 1e-5. The math is the same but the order of the sums,
    and the float32 casts the float64 path keeps (the losses) see the same
    sums: the loss runs on whole rows of logits. The values read are
    printed: 2.9e-13 of a leaf's update at most on (2,1) and (2,2), 0 on
    (1,2) (a log-softmax sharded by columns read 1.1e-6 to 1.4e-6 there);
  * float32 on (2,2), the grid that splits both the batch and the head,
    against JAX's `make_train_step` jitted over a 2 x 2 JAX mesh
    (tests/conftest.py's virtual CPU devices, the head split over 'model'),
    without augmentation: tests/test_torch_train.py's float32 bounds,
    metrics at rtol 1e-2 + 3% of the metric, each leaf's change within
    half the largest entry of JAX's change + 1e-6. The (2,1) and (1,2)
    grids are held to one rank in float64 above, and one rank to JAX's
    step in tests/test_torch_train.py and tests/test_torch_train_float64.py;
  * a checkpoint written on (2,2) restores on one rank and gives the next
    step within the float64 bound, and on (2,2) again exactly;
  * shard_state of a single-process state holding the (2,2) grid's whole
    state, gathered back, is that state exactly; remat on the (2,1) grid is
    the step without it, exactly.

The group runs on its own thread while this process runs JAX's steps.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from facenet_tpu.config import Config as JaxConfig
from facenet_tpu.models.inception_resnet_v1 import \
    InceptionResnetV1 as JaxIRv1
from facenet_tpu.ops import lr_schedules as jax_lr
from facenet_tpu.parallel import mesh as jax_mesh
from facenet_tpu.train import softmax as jax_softmax
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.parallel import launch
from facenet_tpu_torch.parallel.mesh import Mesh
from facenet_tpu_torch.train.checkpoint import CheckpointManager
from facenet_tpu_torch.train.softmax import (SoftmaxClassifier,
                                             SoftmaxTrainer, create_backbone)
from torch_grid_worker import grid_modes
from torch_testing import few_threads  # noqa: F401

TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}, 'output': {'size': 32}}
C = 4
SCHEDULE = [[1, 1e-3], [2, 4e-4], [100, 2e-4]]
LOSSES = {
    'softmax + center': {'center_factor': 0.5, 'center_alfa': 0.9,
                         'triplet_factor': 0.0},
    'triplet': {'softmax_factor': 0.0, 'triplet_factor': 1.0,
                'triplet_margin': 0.2, 'center_factor': 0.0},
}
GRIDS = [(2, 1), (1, 2), (2, 2)]
JAX_GRID = (2, 2)


def _cfg(loss, dtype, **train):
    """float64 runs flip at random (the port against itself); float32 runs
    do not (JAX draws its own flips)."""
    return {'image': {'size': 160, 'normalization': 0,
                      'random_flip': dtype == 'float64'},
            'train': {'adam_epsilon': 0.1, 'epoch': {'size': 1},
                      'learning_rate': {'schedule': SCHEDULE}, **train},
            'loss': LOSSES[loss]}


CFGS = {(loss, dtype): _cfg(loss, dtype)
        for loss in LOSSES for dtype in ('float64', 'float32')}


def _batch(rng, pk):
    bases = rng.randint(0, 255, (C, 160, 160, 3)).astype(np.float32)
    labels = (np.repeat(np.arange(C), 2) if pk
              else rng.randint(0, C, 8)).astype(np.int32)
    images = np.clip(bases[labels] + 30 * rng.randn(8, 160, 160, 3),
                     0, 255).astype(np.uint8)
    return images, labels


@pytest.fixture(scope='module')
def inputs():
    model = SoftmaxClassifier(create_backbone(TINY), C)
    tree = model.init_variables(seed=3)
    rng = np.random.RandomState(4)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(rng.normal(0.5, 0.2, a.shape)).astype(np.float32),
        tree['batch_stats'])
    variables = {'params': tree['params'], 'batch_stats': stats}
    rng = np.random.RandomState(5)
    batch = {'softmax + center': _batch(rng, False),
             'triplet': _batch(rng, True)}
    return variables, batch, _batch(rng, False)


def _single(variables, loss, dtype, images, labels):
    trainer = SoftmaxTrainer(Config(CFGS[loss, dtype]), C, model_cfg=TINY,
                             device='cpu', dtype=getattr(torch, dtype))
    state = trainer.init_state(seed=0)
    state.model.from_flax_variables(variables)
    state, metrics = trainer.step_fn(state, *trainer.placed(images, labels))
    return trainer, state, {k: float(v) for k, v in metrics.items()}


def _tree(state):
    tree = state.model.to_flax_variables()
    tree['centers'] = (None if state.centers is None
                       else state.centers.double().numpy())
    return tree


def _jax_mesh_step(variables, loss, grid, images, labels):
    """JAX's step on the grid's mesh, compiled at XLA's backend
    optimization level 0 (LLVM's code generation, not the partitioning:
    ~2 s less a compile)."""
    model = jax_softmax.SoftmaxClassifier(
        backbone=JaxIRv1(config=TINY, dtype=jnp.float32), nrof_classes=C,
        dtype=jnp.float32)
    tx = optax.adam(jax_lr.piecewise_schedule(SCHEDULE, 1), eps=0.1)
    step = jax.jit(jax_softmax.make_train_step(model, tx,
                                               JaxConfig(LOSSES[loss])))
    mesh = jax_mesh.create_mesh(*grid)
    params = jax.tree_util.tree_map(
        lambda a, s: jax.device_put(jnp.asarray(a, jnp.float32), s),
        variables['params'],
        jax_mesh.param_shardings(mesh, variables['params']))
    rep = jax_mesh.replicated(mesh)
    centers = (jax.device_put(jnp.zeros((C, 32), jnp.float32), rep)
               if LOSSES[loss]['center_factor'] else None)
    state = jax_softmax.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(
            lambda a: jax.device_put(jnp.asarray(a), rep),
            variables['batch_stats']),
        opt_state=tx.init(params), centers=centers,
        rng=jax.random.PRNGKey(0))
    shard = jax_mesh.batch_sharding(mesh)
    args = (state, jax.device_put(images, shard),
            jax.device_put(labels, shard))
    compiled = step.lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})
    state, metrics = compiled(*args)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, {
                'params': state.params, 'batch_stats': state.batch_stats,
                'centers': state.centers}))


@pytest.fixture(scope='module')
def runs(inputs, tmp_path_factory):
    """The 4-rank group's results, beside the single-process and JAX
    steps this process computed meanwhile."""
    variables, batch, next_batch = inputs
    checkpoints = tmp_path_factory.mktemp('grid_checkpoints')
    remat = _cfg('softmax + center', 'float64', remat=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        group = pool.submit(
            launch.spawn, grid_modes, 4, 'gloo', 'cpu',
            (CFGS, remat, variables, batch, next_batch, TINY, C,
             str(checkpoints), [JAX_GRID]), timeout=280, threads=1)
        single = {(loss, 'float64'): _single(variables, loss, 'float64',
                                             *batch[loss])
                  for loss in LOSSES}
        # JAX traces in Python and compiles outside the interpreter's
        # lock: two at a time overlap the one with the other
        with concurrent.futures.ThreadPoolExecutor(2) as compiles:
            jax_runs = {loss: compiles.submit(
                _jax_mesh_step, variables, loss, JAX_GRID, *batch[loss])
                for loss in LOSSES}
            jax_runs = {k: v.result() for k, v in jax_runs.items()}
        grid = group.result()[0]
    return {'grid': grid, 'single': single, 'jax': jax_runs,
            'checkpoints': checkpoints}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    elif tree is not None:
        yield '/'.join(path), np.asarray(tree, np.float64)


def _check_leaves(got, want, start, bound, atol):
    """Every leaf within `bound` of the largest entry of its update (want
    - start) + `atol`; returns the largest max |got - want| / max |want -
    start| read, and its leaf, over the leaves that moved by more than
    1e-9 (a leaf whose exact gradient is 0 moves by rounding alone)."""
    start = dict(_leaves(start))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(dict(_leaves(want)))
    worst = (0.0, '')
    for name, w in _leaves(want):
        moved = np.abs(w - start.get(name, 0.0)).max()
        err = np.abs(got[name] - w).max()
        assert err <= bound * moved + atol, (name, err, moved)
        if moved > 1e-9:
            worst = max(worst, (err / moved, name))
    return worst


def _start(variables, loss):
    return dict(variables, centers=(np.zeros((C, 32))
                                    if LOSSES[loss]['center_factor']
                                    else None))


@pytest.mark.parametrize('loss', sorted(LOSSES))
@pytest.mark.parametrize('grid', GRIDS, ids=str)
def test_grid_step_equals_one_rank_in_float64(runs, inputs, grid, loss):
    metrics, tree = runs['grid'][grid, loss, 'float64']
    _, state, want_metrics = runs['single'][loss, 'float64']
    worst, leaf = _check_leaves(tree, _tree(state), _start(inputs[0], loss),
                                1e-6, 1e-12)
    print(f'{grid} {loss}: worst leaf {leaf} at {worst:.3e} of its update')
    assert sorted(metrics) == sorted(want_metrics)
    for key, value in want_metrics.items():
        np.testing.assert_allclose(metrics[key], value, rtol=1e-5,
                                   atol=1e-12, err_msg=key)


@pytest.mark.parametrize('loss', sorted(LOSSES))
def test_grid_step_matches_jax_mesh_step_in_float32(runs, inputs, loss):
    grid = JAX_GRID
    metrics, tree = runs['grid'][grid, loss, 'float32']
    assert not any(key[2:] == ('float32',) and key[0] != grid
                   for key in runs['grid'] if isinstance(key[0], tuple))
    want_metrics, want = runs['jax'][loss]
    assert sorted(metrics) == sorted(want_metrics)
    for key, value in want_metrics.items():
        np.testing.assert_allclose(metrics[key], value, rtol=1e-2,
                                   atol=3e-2 * abs(value), err_msg=key)
    start = dict(_leaves(_start(inputs[0], loss)))
    got = dict(_leaves(tree))
    for name, w in _leaves(want):
        moved = np.abs(w - start.get(name, 0.0)).max()
        err = np.abs(got[name] - w).max()
        assert err <= 0.5 * moved + 1e-6, (grid, loss, name, err, moved)


def test_checkpoint_written_on_2x2_restores_on_one_rank(runs, inputs):
    """The (2,2) grid saved its state after the first step and took the
    next; one process restores the checkpoint and takes the same next
    step. The (2,2) grid's own restore gave back the saved state."""
    variables, _, next_batch = inputs
    assert runs['grid']['restored']
    trainer, _, _ = runs['single']['softmax + center', 'float64']
    state = trainer.init_state(seed=7)
    manager = CheckpointManager(runs['checkpoints'])
    assert manager.steps() == [1]
    state = manager.restore(state)
    start = _tree(state)
    state, metrics = trainer.step_fn(state, *trainer.placed(*next_batch))
    assert state.step == 2
    got_metrics, got = runs['grid']['next']
    worst, leaf = _check_leaves(got, _tree(state), start, 1e-6, 1e-12)
    print(f'next step after the restore: worst leaf {leaf} at {worst:.3e}')
    for key, value in metrics.items():
        np.testing.assert_allclose(got_metrics[key], float(value),
                                   rtol=1e-5, err_msg=key)


def test_shard_state_then_gather_is_the_identity(runs):
    assert runs['grid']['gathered']


def test_remat_on_a_grid_equals_the_step_without_it(runs):
    """The recompute reuses each BatchNorm's reduced sums: the same step,
    the running statistics moved once."""
    metrics, tree = runs['grid']['remat']
    want_metrics, want = runs['grid'][(2, 1), 'softmax + center', 'float64']
    assert metrics == want_metrics
    for (name, a), (_, b) in zip(_leaves(tree), _leaves(want)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_model_axis_refuses_a_head_it_cannot_split():
    """7 classes on 2 model ranks: the port raises, as JAX's device_put
    of the head onto a mesh with model=2 does; the head is never
    padded."""
    mesh = Mesh(data=1, model=2, rank=1, world_size=2,
                device=torch.device('cpu'))
    with pytest.raises(ValueError, match='7 classes'):
        SoftmaxClassifier(create_backbone(TINY), 7, mesh=mesh)
    jmesh = jax_mesh.create_mesh(2, 2)
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((4, 7), np.float32),
                       NamedSharding(jmesh, P(None, 'model')))
    head = SoftmaxClassifier(create_backbone(TINY), 8, mesh=mesh)
    tree = head.init_variables()
    head.from_flax_variables(tree)
    np.testing.assert_array_equal(head.logits.weight.detach().numpy().T,
                                  tree['params']['logits']['kernel'][:, 4:])
