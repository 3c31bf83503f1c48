"""The port's tracing and step timing (`utils.profiling`), mirroring
tests/test_profiling.py: `StepTimer` (copied from the JAX package, held
to it), `trace` writing a Chrome trace that names the `annotate` spans,
the ``debug.nans`` switch, and the trainer's throughput. `start_server`
has no torch counterpart and raises (a deliberate difference)."""

import json

import numpy as np
import pytest
import torch

from facenet_tpu.utils import profiling as jax_profiling
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.utils import profiling
from test_torch_train import few_threads  # noqa: F401


def test_step_timer_counts_and_throughput():
    t = profiling.StepTimer(items_per_step=32)
    for _ in range(5):
        with t:
            sum(range(1000))
    assert t.count == 5
    assert t.ema_s > 0
    assert t.items_per_sec > 0
    assert 'items/s' in repr(t)
    # the JAX package's report of the same state
    j = jax_profiling.StepTimer(items_per_step=32)
    j.count, j.ema_s = t.count, t.ema_s
    assert repr(t) == repr(j) and t.items_per_sec == j.items_per_sec


def test_trace_writes_a_trace_naming_the_spans(tmp_path):
    with profiling.trace(tmp_path / 'tb') as prof:
        with profiling.annotate('my-region'):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = tmp_path / 'tb' / 'trace.json'
    events = json.loads(path.read_text())['traceEvents']
    assert any(e.get('name') == 'my-region' for e in events)
    assert any('mm' in str(e.get('name')) for e in events)
    assert prof.key_averages()


def test_apply_debug_config_nans():
    old = torch.is_anomaly_enabled()
    try:
        profiling.apply_debug_config(Config({'nans': True}))
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(old)


def test_annotate_context_and_no_server():
    with profiling.annotate('my-region'):
        torch.ones(4).sum()
    with pytest.raises(NotImplementedError, match='trace'):
        profiling.start_server(9999)


def test_trainer_reports_throughput():
    from facenet_tpu_torch.train.softmax import SoftmaxTrainer

    cfg = Config({
        'image': {'size': 160, 'normalization': 0},
        'model': {'config': {'block35': {'repeat': 1},
                             'block17': {'repeat': 1},
                             'block8_1': {'repeat': 1},
                             'output': {'size': 32}}},
        'train': {'epoch': {'size': 2},
                  'learning_rate': {'schedule': [[1, 0.05]]}},
        'loss': {}, 'batch_size': 4, 'seed': 0,
    })
    trainer = SoftmaxTrainer(cfg, nrof_classes=4, device='cpu')
    state = trainer.init_state(seed=0)
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 256, (4, 160, 160, 3), np.uint8),
                rng.randint(0, 4, 4).astype(np.int32)) for _ in range(2)]
    state, metrics = trainer.train_epoch(state, iter(batches), epoch=0,
                                         log_every=0)
    assert metrics['img_per_s'] > 0
    assert metrics['steps'] == 2
    assert trainer.timer.count == 2 and trainer.timer.items_per_sec > 0
