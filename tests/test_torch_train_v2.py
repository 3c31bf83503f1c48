"""Inception-ResNet-v2 training in the port == the JAX package's.

The TINY IRv2 (``repeat [1, 1, 1]``, 32-d) with a 4-way head, from the same
carried variables (a numpy flax tree made by the port, BatchNorm
statistics moved off their init) and the same uint8 batches:

  * the train-mode forward against flax's ``apply(train=True)`` in
    float32 at keep 1.0: the raw bottleneck, every moved running
    statistic (flax's decay 0.995) and the gradient of a fixed projection
    of the output w.r.t. every parameter (bounds in the test);
  * 3 float64 softmax steps against JAX's own `make_train_step` run op by
    op under ``jax.enable_x64(True)`` (as tests/test_torch_train_float64.py
    does for IRv1), each from the state JAX reached before it: the
    metrics at rtol 1e-5, each leaf's change and Adam's moments within
    1e-5 of the largest entry of JAX's change of that leaf, + 1e-12; the
    port's own 3-step run at rtol 1e-5 in its metrics (the test's
    docstring says why its later states are not held leaf by leaf);
  * dropout, which cannot draw JAX's random bits: the kept share of a
    mask within a binomial bound, the 1/keep scaling of kept entries, the
    same generator seed giving the same mask, and a train step at keep 0.5
    moving the state with a finite loss;
  * the train app with ``module: inception_resnet_v2`` through both CLIs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from facenet_tpu import export as jax_export
from facenet_tpu.models.inception_resnet_v2 import \
    InceptionResnetV2 as JaxIRv2
from facenet_tpu_torch.models import inception_resnet_v1 as irv1
from facenet_tpu_torch.models import inception_resnet_v2 as irv2
from facenet_tpu_torch.train.softmax import (SoftmaxClassifier,
                                             create_backbone)
from torch_testing import C, MODEL_V2 as MODEL, TINY_V2
from torch_testing import (_adam_moments, _app_config, _batches,  # noqa: F401
                           _check_run, _grads, _jax_steps, _set_state,
                           _worst_leaf, carried_variables, few_threads,
                           identity_tree)
from torch_testing import _port_trainer_v2 as _port_trainer


@pytest.fixture(scope='module')
def variables():
    """The carried variables, BN statistics moved off their init."""
    return carried_variables(MODEL)


def test_train_forward_matches_flax(variables):
    """float32, keep 1.0, JAX jitted: the raw bottleneck at 1e-4 of its
    largest entry, the moved running statistics at 1e-5; the gradients of
    sum(out * w) w.r.t. every parameter at cosine >= 0.999 as one vector
    and each leaf within 0.25 of its largest entry, + 1e-5 (measured
    0.147 by tests/precision_probe_v2.py: float32 train-mode BatchNorm's
    backward cancels at batch 8; in float64 the step's gradients agree to
    9.1e-8, ROADMAP §C)."""
    images, _ = _batches(1, seed=5)[0]
    weight = np.random.RandomState(6).randn(8, 32).astype(np.float32)
    flax = JaxIRv2(config=TINY_V2, dtype=jnp.float32)
    bb = {'params': variables['params']['backbone'],
          'batch_stats': variables['batch_stats']['backbone']}

    def loss(params):
        out, new = flax.apply({'params': params,
                               'batch_stats': bb['batch_stats']},
                              images, train=True, mutable=['batch_stats'],
                              rngs={'dropout': jax.random.PRNGKey(0)})
        return jnp.sum(out * weight), (out, new['batch_stats'])

    (_, (want, want_stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(bb['params'])

    port = irv2.InceptionResnetV2(TINY_V2).from_flax_variables(bb)
    out = port(torch.from_numpy(images), train=True)
    (out * torch.from_numpy(weight)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(out.detach().numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    for name, module in port.named_modules():
        if isinstance(module, irv1.BatchNorm):
            assert module.momentum == 0.995, name
    got_stats = port.to_flax_variables()['batch_stats']
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, atol=1e-5),
        got_stats, jax.tree_util.tree_map(np.asarray, want_stats))

    grad_tree = _grads(port)
    pairs = []
    for path, want_g in jax.tree_util.tree_leaves_with_path(grads):
        got_g = grad_tree
        for key in path:
            got_g = got_g[key.key]
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(
            got_g, want_g, atol=0.25 * np.abs(want_g).max() + 1e-5,
            err_msg=jax.tree_util.keystr(path))
        pairs.append((got_g.ravel(), want_g.ravel()))
    a = np.concatenate([g for g, _ in pairs]).astype(np.float64)
    b = np.concatenate([w for _, w in pairs]).astype(np.float64)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.999


@pytest.mark.slow
def test_three_float64_steps_match_jax(variables):
    """Each of 3 steps from the state JAX reached before it (the weights,
    BatchNorm statistics, Adam's moments and count): every parameter's
    and statistic's change, and each of Adam's moments, within 1e-5 of
    the largest entry of JAX's change of that leaf, + 1e-12 (measured at
    most 4.0e-6, at step 1, by tests/precision_probe_v2.py), and the
    metrics at rtol 1e-5. The port's own 3-step run from the carried
    variables: the metrics at rtol 1e-5 each step. Its first step is the
    first held one; its later states are not held leaf by leaf: after step
    1 its weights differ from JAX's by 4.0e-6 of a step's change, and one
    ReLU input of step 2's forward (the output of Repeat_1.block17_1,
    image 3, channel 1027, pixel (3, 3): 4.4e-10 from the port's state,
    -1.1e-9 from JAX's) takes the other side, which moves that block's
    up-projection by 5.1e-3 of its change (the probe prints the
    element)."""
    batches = _batches(3, seed=9)
    free, free_state = _port_trainer(variables, torch.float64)
    forced, forced_state = _port_trainer(variables, torch.float64)
    start = None
    with jax.enable_x64(True):
        reference = _jax_steps(variables, batches)
        for step, (images, labels) in enumerate(batches):
            want_metrics, want = next(reference)
            free_state, metrics = free.step_fn(
                free_state, *free.placed(images, labels))
            runs, held = [metrics], free_state
            if start is None:       # the first step starts from the same state
                start = {**variables, **jax.tree_util.tree_map(
                    np.zeros_like, {'mu': want['mu'], 'nu': want['nu']})}
            else:
                _set_state(forced_state, start)
                forced_state, metrics = forced.step_fn(
                    forced_state, *forced.placed(images, labels))
                runs, held = runs + [metrics], forced_state
            for metrics in runs:
                metrics = {k: float(v) for k, v in metrics.items()}
                assert sorted(metrics) == sorted(want_metrics)
                for key in want_metrics:
                    np.testing.assert_allclose(
                        metrics[key], want_metrics[key], rtol=1e-5,
                        err_msg=f'step {step + 1} {key}')
            port = {**held.model.to_flax_variables(), **_adam_moments(held)}
            for keys in (('params', 'batch_stats'), ('mu',), ('nu',)):
                worst = _worst_leaf({k: port[k] for k in keys},
                                    {k: want[k] for k in keys},
                                    {k: start[k] for k in keys})
                assert worst <= 1e-5, (step + 1, keys, worst)
            start = want


def test_l2_regularization_covers_both_families(variables):
    """The L2 term of an IRv2 classifier is JAX's over its params tree."""
    from facenet_tpu.models.inception_resnet_v1 import \
        l2_regularization as jax_l2
    model = SoftmaxClassifier(create_backbone(MODEL), C)
    model.from_flax_variables(variables)
    np.testing.assert_allclose(float(irv1.l2_regularization(model).detach()),
                               float(jax_l2(variables['params'])), rtol=1e-6)


def test_dropout_mask_share_scaling_and_seed():
    net = irv2.InceptionResnetV2(dict(TINY_V2, keep_probability=0.5))
    assert net.keep == 0.5
    mask = net.dropout_mask(400, torch.Generator().manual_seed(7))
    assert mask.shape == (400, 1536) and mask.dtype == torch.bool
    n = mask.numel()
    # kept share within 5 standard deviations of the binomial's
    assert abs(mask.float().mean().item() - 0.5) <= 5 * np.sqrt(0.25 / n)
    again = net.dropout_mask(400, torch.Generator().manual_seed(7))
    assert torch.equal(mask, again)
    other = net.dropout_mask(400, torch.Generator().manual_seed(8))
    assert not torch.equal(mask, other)

    x = torch.randn(4, 1536)
    small = mask[:4]
    out = net._dropout(x, small)
    np.testing.assert_array_equal(out[small].numpy(), (x[small] / 0.5).numpy())
    assert (out[~small] == 0).all()
    with pytest.raises(ValueError, match='dropout'):
        net(torch.zeros(2, 160, 160, 3, dtype=torch.uint8), train=True)
    assert irv2.InceptionResnetV2(TINY_V2).dropout_mask(
        4, torch.Generator()) is None


def test_dropout_train_step_is_seeded(variables):
    """keep 0.5: a finite step from the trainer's own generator; the same
    seed moves the state the same way, another mask another way."""
    model = {'module': 'inception_resnet_v2',
             'config': dict(TINY_V2, keep_probability=0.5)}
    images, labels = _batches(1, seed=11)[0]
    outcomes = []
    for seed in (0, 0, 1):
        trainer, state = _port_trainer(variables, torch.float32, model)
        state.generator.manual_seed(seed)
        state, m = trainer.step_fn(state, *trainer.placed(images, labels))
        assert np.isfinite(float(m['loss']))
        outcomes.append(state.model.logits.weight.detach().clone())
    assert torch.equal(outcomes[0], outcomes[1])
    assert not torch.equal(outcomes[0], outcomes[2])


def test_train_softmax_app_trains_irv2_through_both_clis(identity_tree,
                                                         tmp_path):
    """The train app with ``model: {module: inception_resnet_v2}``
    through `python -m facenet_tpu.apps.train_softmax` and the port's; the
    port's bundle is an IRv2 that the JAX package loads, and its run log
    holds the run's lines."""
    from facenet_tpu.apps.train_softmax import main as jax_main
    from facenet_tpu_torch.apps.train_softmax import main as port_main

    def cfg(run):
        out = _app_config(identity_tree, run)
        out['model'] = {'path': str(run), 'module': 'inception_resnet_v2',
                        'config': dict(TINY_V2, keep_probability=0.8)}
        return out

    cfg_file = tmp_path / 'jax.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg(tmp_path / 'jax_run')))
    result = CliRunner().invoke(jax_main, ['--config', str(cfg_file)])
    assert result.exit_code == 0, result.output
    _check_run(tmp_path / 'jax_run')

    cfg_file = tmp_path / 'port.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg(tmp_path / 'port_run')))
    state = port_main(['--config', str(cfg_file), '--device', 'cpu'])
    assert state.step == 4
    run = _check_run(tmp_path / 'port_run')
    bundle = jax_export.load_model(run)
    assert type(bundle.model).__name__ == 'InceptionResnetV2'
    log = (run / 'logs' / f'{run.name}.log').read_text()
    assert 'perform validation for epoch 2' in log
