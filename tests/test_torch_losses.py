"""The port's training losses and learning-rate schedules == the JAX
package's, on the same seeded numpy inputs.

Losses in value and in gradient (autograd against jax.grad), float32:
rtol 1e-5 / atol 1e-6 (the same arithmetic in another summation order).
The triplet loss is checked on batches whose distances tie (duplicated
embeddings, so semi-hard minima and hardest maxima are shared by several
negatives, and positive pairs sit at distance 0): the gradient split
among tied entries must be JAX's. The center loss's table update with
repeated labels must accumulate, as ``centers.at[labels].add`` does.
Schedules: every step of a few hundred, exactly (both round to float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facenet_tpu.config import Config as JaxConfig
from facenet_tpu.ops import losses as jax_losses
from facenet_tpu.ops import lr_schedules as jax_lr
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.ops import losses, lr_schedules
from torch_testing import few_threads  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _value_and_grad_torch(fn, *arrays):
    """fn's value and its gradient w.r.t. the first array."""
    x = torch.tensor(arrays[0], requires_grad=True)
    rest = [torch.as_tensor(a) for a in arrays[1:]]
    value = fn(x, *rest)
    value.backward()
    return value.detach().numpy(), x.grad.numpy()


def _value_and_grad_jax(fn, *arrays):
    value, grad = jax.value_and_grad(fn)(*[jnp.asarray(a) for a in arrays])
    return np.asarray(value), np.asarray(grad)


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('shape', [(8, 5), (33, 120)])
def test_cross_entropy_matches_jax(shape):
    rng = np.random.RandomState(shape[0])
    logits = (3 * rng.randn(*shape)).astype(np.float32)
    labels = rng.randint(0, shape[1], shape[0]).astype(np.int32)
    _close(_value_and_grad_torch(losses.softmax_cross_entropy_with_logits,
                                 logits, labels),
           _value_and_grad_jax(jax_losses.softmax_cross_entropy_with_logits,
                               logits, labels))


@pytest.mark.parametrize('labels', [[0, 0, 1, 1, 2, 2],
                                    [3, 3, 3, 0, 3, 1, 0, 3]])
def test_center_loss_matches_jax(labels):
    """Repeated labels accumulate their updates; the loss reads the old
    table; no gradient reaches the table."""
    labels = np.asarray(labels, np.int32)
    rng = np.random.RandomState(len(labels))
    feats = rng.randn(len(labels), 7).astype(np.float32)
    centers = rng.randn(5, 7).astype(np.float32)

    def port(f, lab, c):
        loss, new = losses.center_loss(f, lab, c, 0.95)
        port.new = new
        assert not new.requires_grad
        return loss

    def ref(f, lab, c):
        return jax_losses.center_loss(f, lab, c, 0.95)[0]

    _close(_value_and_grad_torch(port, feats, labels, centers),
           _value_and_grad_jax(ref, feats, labels, centers))
    want = jax_losses.center_loss(jnp.asarray(feats), jnp.asarray(labels),
                                  jnp.asarray(centers), 0.95)[1]
    np.testing.assert_allclose(port.new.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    # the accumulated form: each class moves by the sum of its rows' diffs
    diff = 0.05 * (centers[labels] - feats)
    manual = centers.copy()
    np.add.at(manual, labels, -diff)
    np.testing.assert_allclose(port.new.numpy(), manual, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('p,k', [(3, 2), (4, 5)])
def test_pair_loss_matches_jax(p, k):
    rng = np.random.RandomState(p * k)
    logits = (2 * rng.randn(p * k, p * k)).astype(np.float32)
    _close(_value_and_grad_torch(
        lambda x: losses.binary_cross_entropy_pair_loss(x, p, k), logits),
        _value_and_grad_jax(
            lambda x: jax_losses.binary_cross_entropy_pair_loss(x, p, k),
            logits))


def test_pair_loss_raises_without_positive_pairs():
    logits = torch.zeros(4, 4)
    with pytest.raises(ValueError, match='nrof_examples_per_class'):
        losses.binary_cross_entropy_pair_loss(logits, 4, 1)
    with pytest.raises(ValueError, match='nrof_examples_per_class'):
        jax_losses.binary_cross_entropy_pair_loss(jnp.zeros((4, 4)), 4, 1)


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _triplet_case(name):
    rng = np.random.RandomState(7)
    if name == 'random':
        emb = _unit(rng.randn(20, 16))
        labels = np.repeat(np.arange(5), 4)
    elif name == 'tied negatives':
        # two copies of every row: each anchor sees every negative twice,
        # so each semi-hard minimum and hardest maximum is a tie
        base = _unit(rng.randn(6, 8))
        emb = np.concatenate([base, base])
        labels = np.concatenate([np.repeat(np.arange(3), 2)] * 2)
    elif name == 'no semi-hard negative':
        # one tight cluster a class far apart: d(a, p) < every d(a, n), so
        # there is a semi-hard negative; then shuffle a far positive in so
        # some (a, p) have none and fall back to the hardest negative
        centres = _unit(rng.randn(3, 8))
        emb = _unit(np.repeat(centres, 3, axis=0)
                    + 0.05 * rng.randn(9, 8))
        emb[2] = -emb[0]
        labels = np.repeat(np.arange(3), 3)
    else:                                   # a P x K batch of the trainer
        emb = _unit(rng.randn(20 * 5, 32))
        labels = np.repeat(np.arange(20), 5)
    return emb, labels.astype(np.int32)


@pytest.mark.parametrize('name', ['random', 'tied negatives',
                                  'no semi-hard negative', 'P x K 20 x 5'])
@pytest.mark.parametrize('margin', [0.2, 1.0])
def test_triplet_loss_matches_jax(name, margin):
    emb, labels = _triplet_case(name)
    got = _value_and_grad_torch(
        lambda x, lab: losses.triplet_semihard_loss(x, lab, margin),
        emb, labels)
    want = _value_and_grad_jax(
        lambda x, lab: jax_losses.triplet_semihard_loss(x, lab, margin),
        emb, labels)
    assert float(want[0]) > 0
    _close(got, want)


def test_pairwise_distances_match_jax():
    emb = _unit(np.random.RandomState(3).randn(12, 10))
    emb[5] = emb[4]
    got = losses.pairwise_squared_distances(torch.from_numpy(emb)).numpy()
    want = np.asarray(jax_losses._pairwise_squared_distances(
        jnp.asarray(emb)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got.min() >= 0


SCHEDULES = {
    'piecewise': ({'learning_rate': {'schedule': [[2, 0.05], [5, 0.005],
                                                  [9, 0.0005]]}}, 37),
    'value': ({'learning_rate': {'value': 0.02, 'schedule': [[1, 0.1]]}},
              37),
    'single row': ({'learning_rate': {'schedule': [[3, 0.1]]}}, 10),
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_from_config_matches_jax(name):
    train_cfg, steps_per_epoch = SCHEDULES[name]
    port = lr_schedules.schedule_from_config(Config(train_cfg),
                                             steps_per_epoch)
    ref = jax_lr.schedule_from_config(JaxConfig(train_cfg), steps_per_epoch)
    steps = np.arange(400)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
    got = np.array([port(int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('lr0,rate,every', [(0.1, 0.96, 25), (0.05, 0.5, 7)])
def test_exponential_decay_matches_jax(lr0, rate, every):
    port = lr_schedules.exponential_decay_schedule(lr0, rate, every)
    ref = jax_lr.exponential_decay_schedule(lr0, rate, every)
    steps = np.arange(300)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
    got = np.array([port(int(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_epoch_scheduler_matches_jax():
    rows = {'schedule': [[10, 0.05], [20, 0.005], [30, 0.0005]]}
    port = lr_schedules.LearningRateScheduler(Config(rows))
    ref = jax_lr.LearningRateScheduler(JaxConfig(rows))
    assert [port(e) for e in range(40)] == [ref(e) for e in range(40)]
    fixed = {'value': 0.3, **rows}
    assert lr_schedules.LearningRateScheduler(Config(fixed))(25) == 0.3
