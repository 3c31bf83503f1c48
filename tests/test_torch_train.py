"""The port's trainer == the JAX package's, on the TINY Inception-ResNet-v1.

Both start from the same carried variables (a numpy flax tree made by the
port) and see the same uint8 batches; JAX runs its own functions
(`make_train_step` over `SoftmaxClassifier(backbone=InceptionResnetV1(
config=TINY, dtype=float32), dtype=float32)` with `optax.adam`), the port
its trainer on the CPU. Bounds, float32 unless said:

  * train-mode BatchNorm against flax's: output and input gradient at
    atol 1e-5 / 1e-4 (float32) or one bf16 ulp of their largest entry
    (bfloat16 compute), the bias gradient, the batch statistics and the
    running update at 1e-5;
  * 3 train steps (softmax; softmax + center; triplet-only on a P x K
    batch), a schedule that changes its rate every step: per-step losses
    and metrics at rtol 1e-2, + 3% of the metric's largest value over the
    steps (the triplet loss, near the edge of its hinge by step 2, moves
    most); each leaf's change over the 3 steps (parameters, BN statistics,
    centers) within half the largest entry of JAX's change of that leaf,
    + 1e-6 (a leaf whose exact gradient is 0, like the last block's
    up-projection bias ahead of the bottleneck's BatchNorm, moves by
    rounding alone). The backward through train-mode BatchNorm at batch 8
    cancels heavily: against JAX's own float64 step run op by op,
    `tests/precision_probe.py` finds JAX's float32 step-0 gradients up to
    8% (softmax) and 21% (triplet) of a leaf's largest entry off, the
    port's up to 7% and 8%, and after the 3 steps JAX's float32 run 32%
    and 23% of a leaf's change off, the port's 9% and 12%. These runs are
    a smoke check; tests/test_torch_train_float64.py holds the same 3
    steps in float64 within 1e-5 of a leaf's change;
  * the bf16 trainer against JAX's default bf16 trainer over 2 steps:
    losses at rtol 0.1, the whole update as one vector at cosine >= 0.9
    to JAX's (both round every layer's output to bf16, in other orders);
  * the augmentation core fed JAX's own draws: bit for bit;
  * the data pipelines from the same seed: JAX's batch order exactly,
    before and after a resume.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from flax import linen as fnn

from facenet_tpu import dataset as jax_dataset
from facenet_tpu import export as jax_export
from facenet_tpu.config import Config as JaxConfig
from facenet_tpu.models.inception_resnet_v1 import \
    InceptionResnetV1 as JaxIRv1
from facenet_tpu.models.inception_resnet_v1 import \
    l2_regularization as jax_l2
from facenet_tpu.ops.preprocessing import center_crop as jax_center_crop
from facenet_tpu.ops.preprocessing import random_augment as jax_augment
from facenet_tpu_torch import callbacks, dataset, export
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.models import inception_resnet_v1 as irv1
from facenet_tpu_torch.ops.preprocessing import (augment_with, center_crop,
                                                  random_augment)
from facenet_tpu_torch.train.checkpoint import CheckpointManager
from facenet_tpu_torch.train.softmax import (SoftmaxClassifier,
                                             create_backbone,
                                             step_on_devices)
from span_recording import spans  # noqa: F401
from torch_testing import (C, LOSSES, TINY, _app_config, _batches,  # noqa: F401
                           _check_run, _jax_run, _port_run, _port_trainer,
                           _train_cfg, few_threads, identity_tree, variables)


def _assert_trees_close(got, want, atol, path=''):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _assert_trees_close(got[key], want[key], atol, f'{path}/{key}')
        return
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=path)


@pytest.fixture(scope='module', params=sorted(LOSSES))
def three_steps(request, variables):
    name = request.param
    batches = _batches(3, pk=name == 'triplet', seed=len(name))
    jax_metrics, jax_state = _jax_run(variables, LOSSES[name], batches)
    port_metrics, state = _port_run(variables, LOSSES[name], batches)
    assert state.step == 3
    port_state = state.model.to_flax_variables()
    port_state['centers'] = (None if state.centers is None
                             else state.centers.numpy())
    return name, jax_metrics, jax_state, port_metrics, port_state


def test_three_steps_losses_match_jax(three_steps):
    name, jax_metrics, _, port_metrics, _ = three_steps
    for step, (got, want) in enumerate(zip(port_metrics, jax_metrics)):
        assert sorted(got) == sorted(want), name
        for key in want:
            scale = max(abs(m[key]) for m in jax_metrics)
            np.testing.assert_allclose(got[key], want[key], rtol=1e-2,
                                       atol=3e-2 * scale,
                                       err_msg=f'{name} step {step} {key}')
    assert all(m['loss'] > 0 for m in port_metrics)
    if name == 'triplet':
        assert port_metrics[0]['triplet_loss'] > 0


def test_three_steps_updates_match_jax(three_steps, variables):
    """Every leaf's change over the 3 steps (parameters, BN statistics,
    centers) against JAX's: max |d_port - d_jax| <= 0.5 max |d_jax| +
    1e-6 per leaf (see the module docstring for why no tighter)."""
    name, _, jax_state, _, port_state = three_steps
    start = dict(variables, centers=None)
    assert (port_state['centers'] is None) == (jax_state['centers'] is None)
    for path, want in jax.tree_util.tree_leaves_with_path(jax_state):
        got, before = port_state, start
        for key in path:
            got = got[key.key]
            before = before[key.key] if before is not None else None
        before = 0.0 if before is None else np.asarray(before, np.float64)
        moved = np.asarray(want, np.float64) - before
        err = np.abs(np.asarray(got, np.float64) - np.asarray(want)).max()
        bound = 0.5 * np.abs(moved).max() + 1e-6
        assert err <= bound, (name, jax.tree_util.keystr(path), err, bound)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_train_mode_batchnorm_matches_flax(dtype):
    """Output, gradient w.r.t. input and bias, batch statistics and the
    running update of one train-mode BatchNorm."""
    rng = np.random.RandomState(1)
    x = (rng.randn(6, 5, 7, 24) * 2 + 0.7).astype(np.float32)      # NHWC
    bias = rng.randn(24).astype(np.float32)
    mean0 = rng.randn(24).astype(np.float32)
    var0 = np.abs(rng.randn(24)).astype(np.float32) + 0.5
    weight = rng.randn(6, 5, 7, 24).astype(np.float32)
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    tdt = getattr(torch, dtype)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3, use_bias=True, use_scale=False,
                       dtype=jdt, param_dtype=jnp.float32)
    variables = {'params': {'bias': bias},
                 'batch_stats': {'mean': mean0, 'var': var0}}

    def flax_loss(xx, b):
        out, new = bn.apply({'params': {'bias': b},
                             'batch_stats': variables['batch_stats']},
                            xx.astype(jdt), mutable=['batch_stats'])
        return jnp.sum(out.astype(jnp.float32) * weight), (out, new)

    (_, (want, new)), grads = jax.value_and_grad(
        flax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                  jnp.asarray(bias))

    port = irv1.BatchNorm(24)
    port.load_flax(variables['params'], variables['batch_stats'])
    xt = torch.tensor(x).permute(0, 3, 1, 2).to(tdt).detach()
    xt.requires_grad_(True)
    out = port(xt, train=True)
    assert out.dtype == tdt
    (out.float() * torch.from_numpy(weight).permute(0, 3, 1, 2)).sum() \
        .backward()
    got = out.detach().float().permute(0, 2, 3, 1).numpy()
    ulp = 1e-5 if dtype == 'float32' else 2 ** -7 * np.abs(got).max()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=ulp)
    np.testing.assert_allclose(
        xt.grad.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(grads[0], np.float32), atol=1e-4 if dtype == 'float32'
        else 2 ** -7 * np.abs(np.asarray(grads[0], np.float32)).max())
    np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(grads[1]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(port.mean.numpy(),
                               np.asarray(new['batch_stats']['mean']),
                               atol=1e-5)
    np.testing.assert_allclose(port.var.numpy(),
                               np.asarray(new['batch_stats']['var']),
                               atol=1e-5)
    # the batch statistics themselves: flax's biased fast variance
    mean, var = irv1.batch_statistics(xt.detach())
    xf = xt.detach().float().numpy()
    np.testing.assert_allclose(mean.numpy(), xf.mean(axis=(0, 2, 3)),
                               atol=1e-5)
    np.testing.assert_allclose(var.numpy(), xf.var(axis=(0, 2, 3)),
                               rtol=1e-4, atol=1e-5)


def test_l2_regularization_matches_jax(variables):
    model = SoftmaxClassifier(create_backbone(TINY), C)
    model.from_flax_variables(variables)
    got = float(irv1.l2_regularization(model).detach())
    want = float(jax_l2(variables['params']))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # kernels only, the logits head's included: biases do not count
    with torch.no_grad():
        model.logits.bias.fill_(5.0)
        model.backbone.bottleneck_bn.bias.fill_(5.0)
        model.logits.weight.mul_(2.0)
    head = float((variables['params']['logits']['kernel'] ** 2).sum())
    np.testing.assert_allclose(float(irv1.l2_regularization(model).detach()),
                               want + 3 * 5e-4 * head, rtol=1e-5)


def test_frozen_bn_keeps_statistics_and_trains_parameters():
    """From the init's statistics (mean 0, var 1; the carried ones would
    switch most ReLUs off under a running-statistics forward)."""
    init = SoftmaxClassifier(create_backbone(TINY), C).init_variables(6)
    trainer, state = _port_trainer(init, LOSSES['softmax'])
    before = state.model.to_flax_variables()
    images, labels = _batches(1, size=4)[0]
    state, metrics = trainer.frozen_bn_step_fn(
        state, *trainer.placed(images, labels))
    after = state.model.to_flax_variables()
    assert np.isfinite(float(metrics['loss'])) and state.step == 1
    for a, b in zip(jax.tree_util.tree_leaves(before['batch_stats']),
                    jax.tree_util.tree_leaves(after['batch_stats'])):
        np.testing.assert_array_equal(a, b)
    changed = [not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(before['params']),
        jax.tree_util.tree_leaves(after['params']))]
    assert all(changed)


def test_remat_equals_no_remat(variables):
    """The recomputing backward gives the same step; the running
    statistics move once, not twice."""
    batches = _batches(1, size=4)
    plain_metrics, plain = _port_run(variables, LOSSES['softmax'], batches)
    remat_metrics, remat = _port_run(variables, LOSSES['softmax'], batches,
                                     remat=True)
    assert remat_metrics == plain_metrics
    _assert_trees_close(remat.model.to_flax_variables(),
                        plain.model.to_flax_variables(), 0)


def test_step_on_devices_of_one_device_is_exact():
    """The card-against-CPU check (chip_smoke phase 27, the cuda tests)
    run with the CPU on both sides: the same metrics, no gap in any leaf,
    the centers among the leaves."""
    images, labels = _batches(1, size=4)[0]
    (first, second), worst, largest = step_on_devices(
        _train_cfg(LOSSES['softmax + center']), C, images, labels,
        model_cfg=TINY, devices=('cpu', 'cpu'))
    assert first == second and 'center_loss' in first
    assert worst == 0.0 and largest > 0


def test_augment_core_with_jax_draws_is_bit_exact():
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (6, 182, 170, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_augment(key, jnp.asarray(images), random_crop=True,
                                  random_flip=True, crop_size=160))
    # JAX's draws, made as random_augment makes them
    _, k1, k2 = jax.random.split(key, 3)
    off_y = jax.random.randint(k1, (6,), 0, 182 - 160 + 1)
    off_x = jax.random.randint(k2, (6,), 0, 170 - 160 + 1)
    _, k = jax.random.split(jax.random.split(key, 3)[0])
    flip = jax.random.bernoulli(k, 0.5, (6,))
    assert 0 < int(np.sum(flip)) < 6
    got = augment_with(torch.from_numpy(images),
                       torch.tensor(np.asarray(off_y)),
                       torch.tensor(np.asarray(off_x)),
                       torch.tensor(np.asarray(flip)), crop_size=160)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own draw: crops inside the image, reproducible
    g = torch.Generator().manual_seed(0)
    a = random_augment(g, torch.from_numpy(images), True, True, 160)
    b = random_augment(torch.Generator().manual_seed(0),
                       torch.from_numpy(images), True, True, 160)
    assert a.shape == (6, 160, 160, 3) and torch.equal(a, b)
    np.testing.assert_array_equal(
        center_crop(torch.from_numpy(images), 160).numpy(),
        np.asarray(jax_center_crop(jnp.asarray(images), 160)))


def _flat_update(tree, start):
    return np.concatenate([
        (np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(start))])


def test_bf16_trainer_matches_jax_bf16_trainer(variables):
    """Both round every layer's output to bf16, in other orders, so the
    per-leaf update comparison of float32 does not hold; the bound: losses
    at rtol 0.1 over 2 steps, and the whole update (every parameter and
    statistic as one vector) at cosine >= 0.9 to JAX's."""
    batches = _batches(2)
    jax_metrics, jax_state = _jax_run(variables, LOSSES['softmax'], batches,
                                      dtype=jnp.bfloat16)
    port_metrics, state = _port_run(variables, LOSSES['softmax'], batches,
                                    dtype=torch.bfloat16)
    for got, want in zip(port_metrics, jax_metrics):
        for key in ('loss', 'cross_entropy', 'regularization'):
            np.testing.assert_allclose(got[key], want[key], rtol=0.1)
    port = state.model.to_flax_variables()
    jax_tree = {'params': jax_state['params'],
                'batch_stats': jax_state['batch_stats']}
    a, b = _flat_update(port, variables), _flat_update(jax_tree, variables)
    cosine = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cosine >= 0.9, cosine


def test_warm_start_from_a_jax_bundle(tmp_path, variables):
    trainer, state = _port_trainer(variables, LOSSES['softmax'])
    head = state.model.logits.weight.detach().clone()
    donor = irv1.init_variables(TINY, seed=9)
    jax_export.save_model(tmp_path / 'bundle', JaxIRv1(config=TINY), donor)
    bundle = export.load_model(tmp_path / 'bundle')
    state = trainer.warm_start(state, bundle.variables)
    _assert_trees_close(state.model.backbone.to_flax_variables(), donor, 0)
    assert torch.equal(state.model.logits.weight, head) and state.step == 0

    other = irv1.init_variables({**TINY, 'output': {'size': 16}}, seed=1)
    with pytest.raises(ValueError, match='shape mismatch'):
        trainer.warm_start(state, other)


def test_train_epoch_draws_exactly_steps_per_epoch(variables, tmp_path):
    """...and writes the profiling trace window of its config."""
    trainer, state = _port_trainer(variables, LOSSES['softmax'],
                                   epoch={'size': 1})
    trainer.cfg.profiling = Config({'trace_dir': str(tmp_path / 'trace'),
                                    'epoch': 1, 'start_step': 0,
                                    'num_steps': 1})
    drawn = []

    def counting(batches):
        for i, b in enumerate(batches):
            drawn.append(i)
            yield b

    source = counting(_batches(6, size=2))
    for epoch in range(2):
        state, m = trainer.train_epoch(state, source, epoch, log_every=1)
        assert m['steps'] == 1 and len(drawn) == epoch + 1
        assert np.isfinite(m['loss']) and m['img_per_s'] > 0
        assert (tmp_path / 'trace' / 'trace.json').is_file() == (epoch == 1)
    assert state.step == 2


def _first(pipeline, n):
    return list(itertools.islice(iter(pipeline), n))


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize('kind', ['shuffled', 'P x K'])
def test_pipelines_match_jax_order_and_resume(identity_tree, kind):
    path = identity_tree / 'train'
    port_db = dataset.Database(dataset.DefaultConfig(path))
    jax_db = jax_dataset.Database(jax_dataset.DefaultConfig(path))
    port_loader = dataset.ImageLoader(size=160)
    jax_loader = jax_dataset.ImageLoader(size=160)

    def make(db, loader, classes_cfg, start_state=None):
        if kind == 'shuffled':
            return db.batches(loader, batch_size=4, shuffle=True, repeat=True,
                              drop_remainder=True, seed=17,
                              start_state=start_state)
        mod = dataset if db is port_db else jax_dataset
        return mod.pipeline_with_equal_batches(
            loader, db.classes, classes_cfg, seed=17, start_state=start_state)

    pk = {'nrof_classes_per_batch': 3, 'nrof_examples_per_class': 2}
    port = make(port_db, port_loader, Config(pk))
    ref = make(jax_db, jax_loader, JaxConfig(pk))
    # past an epoch boundary of the shuffled stream (7 batches an epoch)
    want = _first(ref, 9)
    got = []
    it = iter(port)
    for _ in range(9):
        got.append(next(it))
    _assert_same_batches(got, want)
    cursor = port.state()
    assert cursor == ref.state()

    resumed = make(port_db, port_loader, Config(pk), start_state=cursor)
    ref_resumed = make(jax_db, jax_loader, JaxConfig(pk), start_state=cursor)
    _assert_same_batches(_first(resumed, 3), _first(ref_resumed, 3))


def test_checkpoint_round_trip_carries_the_cursor(tmp_path, variables):
    loss = LOSSES['softmax + center']
    trainer, state = _port_trainer(variables, loss, remat=False)
    trainer.cfg.image.random_flip = True          # the generator is drawn
    batches = _batches(2, size=4)
    state, _ = trainer.step_fn(state, *trainer.placed(*batches[0]))
    mgr = CheckpointManager(tmp_path / 'ckpt', max_to_keep=2)
    mgr.save(state.step, state, data_state={'seed': 17, 'epoch': 1,
                                            'pos': 3})
    assert mgr.latest_step() == state.step == 1
    kept = CheckpointManager(tmp_path / 'kept', max_to_keep=2)
    for step in (1, 5, 3):
        kept.save(step, state)
    callbacks.CheckpointCallback(kept).on_epoch_end(0, state)   # step 1
    assert kept.steps() == [3, 5]                     # the newest two

    other = SoftmaxClassifier(create_backbone(TINY), C).init_variables(5)
    fresh_trainer, fresh = _port_trainer(other, loss)
    fresh_trainer.cfg.image.random_flip = True
    restored, cursor = CheckpointManager(tmp_path / 'ckpt').restore(
        fresh, step=state.step, with_data_state=True)
    assert cursor == {'seed': 17, 'epoch': 1, 'pos': 3}
    assert restored.step == 1
    # the next step from the restored state == the uninterrupted next step
    images, labels = batches[1]
    state, m = trainer.step_fn(state, *trainer.placed(images, labels))
    restored, m2 = fresh_trainer.step_fn(
        restored, *fresh_trainer.placed(images, labels))
    assert {k: float(v) for k, v in m.items()} == \
        {k: float(v) for k, v in m2.items()}
    _assert_trees_close(restored.model.to_flax_variables(),
                        state.model.to_flax_variables(), 0)
    assert torch.equal(restored.centers, state.centers)
    assert torch.equal(restored.generator.get_state(),
                       state.generator.get_state())


def test_bundles_load_across_packages(tmp_path, variables):
    """A port-written bundle loads in facenet_tpu.export.load_model and
    gives the port's embeddings; a JAX-written bundle loads in the port
    (float32 both; atol 2e-4 / rtol 1e-3, the model tests' bound)."""
    images = np.random.RandomState(2).randint(0, 256, (3, 160, 160, 3),
                                              dtype=np.uint8)
    model = SoftmaxClassifier(create_backbone(TINY), C)
    model.from_flax_variables(variables)
    export.save_model(tmp_path / 'port', model.backbone)
    bundle = jax_export.load_model(tmp_path / 'port')
    assert bundle.meta['config'] == TINY
    flax_model = JaxIRv1(config=bundle.meta['config'], dtype=jnp.float32)
    want = np.asarray(flax_model.apply(bundle.variables, images,
                                       train=False))
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)

    jax_export.save_model(tmp_path / 'jax', flax_model, bundle.variables)
    back = export.load_model(tmp_path / 'jax')
    _assert_trees_close(back.variables,
                        model.backbone.to_flax_variables(), 0)


def test_train_softmax_app_through_both_clis(identity_tree, tmp_path):
    """2 epochs x 2 steps of TINY on a synthetic identity set through
    `python -m facenet_tpu.apps.train_softmax` and the port's app; the
    port's bundle serves in the JAX package."""
    from facenet_tpu.apps.train_softmax import main as jax_main
    from facenet_tpu_torch.apps.train_softmax import main as port_main

    cfg_file = tmp_path / 'jax.yaml'
    cfg_file.write_text(yaml.safe_dump(
        _app_config(identity_tree, tmp_path / 'jax_run')))
    result = CliRunner().invoke(jax_main, ['--config', str(cfg_file)])
    assert result.exit_code == 0, result.output
    _check_run(tmp_path / 'jax_run')

    cfg_file = tmp_path / 'port.yaml'
    cfg_file.write_text(yaml.safe_dump(
        _app_config(identity_tree, tmp_path / 'port_run')))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            port_main(['--config', str(cfg_file)])
        assert not (tmp_path / 'port_run').exists()
    state = port_main(['--config', str(cfg_file), '--device', 'cpu'])
    assert state.step == 4
    run = _check_run(tmp_path / 'port_run')
    assert jax_export.load_model(run).meta['model_class'] == \
        'InceptionResnetV1'


def test_train_epoch_spans_once_a_step(variables, spans):
    """With host recording on, every step places its batch and opens the
    step's spans once; the state is the one recording off reaches."""
    runs = []
    for on in (False, True):
        spans.record_spans(on)
        trainer, state = _port_trainer(variables, LOSSES['softmax'],
                                       epoch={'size': 2})
        state, m = trainer.train_epoch(state, _batches(2, size=2), 0,
                                       log_every=0)
        runs.append((m, state.model.to_flax_variables(), trainer.timer))
    (m_off, off, _), (m_on, on, timer) = runs
    assert m_on['loss'] == m_off['loss']
    _assert_trees_close(on, off, atol=0)
    got = spans.span_summary()
    names = ('train.place', 'train.step', 'train.forward', 'train.backward',
             'train.adam')
    assert {name: got[name]['count'] for name in names} == \
        dict.fromkeys(names, 2)
    step = got['train.step']
    assert step['total_s'] == pytest.approx(timer.total_s, abs=1e-9)
    parts = sum(got[name]['total_s']
                for name in ('train.forward', 'train.backward', 'train.adam'))
    assert step['self_s'] == pytest.approx(step['total_s'] - parts,
                                           abs=1e-9)
