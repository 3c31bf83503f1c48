"""The port's trainer == the JAX package's in float64, tightly.

tests/test_torch_train.py holds the two packages' float32 train steps
within half a leaf's change: the backward through train-mode BatchNorm at
batch 8 cancels heavily, and float32 rounding alone moves a leaf's update
by up to a third of itself. Here both run the same 3 steps in float64
from the same carried variables and batches: JAX its own
`make_train_step` with `optax.adam` over float64 weights under
``jax.enable_x64(True)``, the port its `SoftmaxTrainer` with
``dtype=torch.float64`` (weights, BatchNorm statistics, Adam's moments and
the centers in float64). Bounds: per-step losses and metrics at rtol 1e-5;
each leaf's change over the 3 steps (parameters, BN statistics, centers)
within 1e-5 of the largest entry of JAX's change of that leaf, + 1e-12.
The two float64 runs lie up to 2.4e-6 of a leaf's change apart
(`tests/precision_probe.py`; both keep the same float32 casts: the
bottleneck output, the losses, the L2 sum); a step read at another rate,
or a moment, statistic or center moved wrongly, misses by a large part of
the change.

JAX's step runs op by op, not under `jax.jit`: the probe finds XLA's
jitted float64 step on the CPU 5% (softmax) and 12% (triplet) of a leaf's
first update away from the same step run op by op, while the port's
float64 step lies within 2.4e-6 of the op-by-op one and their step-0
gradients within 8.4e-7 of a leaf's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_testing import (LOSSES, _batches, _jax_run, _port_run,
                           few_threads, variables)   # noqa: F401


@pytest.fixture(scope='module', params=sorted(LOSSES))
def three_steps_float64(request, variables):      # noqa: F811
    name = request.param
    batches = _batches(3, pk=name == 'triplet', seed=len(name))
    with jax.enable_x64(True):
        jax_metrics, jax_state = _jax_run(variables, LOSSES[name], batches,
                                          jnp.float64, jit=False)
    port_metrics, state = _port_run(variables, LOSSES[name], batches,
                                    torch.float64)
    assert state.step == 3
    port_state = state.model.to_flax_variables()
    port_state['centers'] = (None if state.centers is None
                             else state.centers.numpy())
    return name, jax_metrics, jax_state, port_metrics, port_state


def test_three_steps_float64_losses_match_jax(three_steps_float64):
    name, jax_metrics, _, port_metrics, _ = three_steps_float64
    for step, (got, want) in enumerate(zip(port_metrics, jax_metrics)):
        assert sorted(got) == sorted(want), name
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=f'{name} step {step} {key}')


def test_three_steps_float64_updates_match_jax(three_steps_float64,
                                               variables):   # noqa: F811
    """max |d_port - d_jax| <= 1e-5 max |d_jax| + 1e-12 per leaf, each
    leaf float64 in both packages."""
    name, _, jax_state, _, port_state = three_steps_float64
    start = dict(variables, centers=None)
    assert (port_state['centers'] is None) == (jax_state['centers'] is None)
    for path, want in jax.tree_util.tree_leaves_with_path(jax_state):
        got, before = port_state, start
        for key in path:
            got = got[key.key]
            before = before[key.key] if before is not None else None
        assert got.dtype == want.dtype == np.float64, path
        before = 0.0 if before is None else np.asarray(before, np.float64)
        moved = want - before
        err = np.abs(got - want).max()
        bound = 1e-5 * np.abs(moved).max() + 1e-12
        assert err <= bound, (name, jax.tree_util.keystr(path), err, bound)
