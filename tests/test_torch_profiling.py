"""The port's tracing and step timing (`utils.profiling`), mirroring
tests/test_profiling.py: `StepTimer` (copied from the JAX package, held
to it), `trace` writing a Chrome trace that names the `annotate` spans,
the ``debug.nans`` switch, and the trainer's throughput. `start_server`
has no torch counterpart and raises (a deliberate difference). The port's
own host recording of spans: off, a shared no-op; on, counts, totals and
self times of nested spans, a span left by an exception, the step timer's
span, many threads."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from facenet_tpu.utils import profiling as jax_profiling
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.utils import profiling
from span_recording import spans  # noqa: F401
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


def test_annotate_off_is_one_shared_noop():
    """Recording off and no profiler: every span is the same no-op and
    nothing is gathered; under a profiler a span is a record_function."""
    first, second = profiling.annotate('a'), profiling.annotate('b')
    assert first is second
    with first:
        pass
    assert profiling.span_summary() == {}
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu):
        assert isinstance(profiling.annotate('a'),
                          torch.profiler.record_function)


def test_recorded_spans_nest(spans):
    with spans.annotate('outer'):
        time.sleep(0.002)
        for _ in range(2):
            with spans.annotate('inner'):
                time.sleep(0.001)
    got = spans.span_summary(reset=True)
    assert set(got) == {'outer', 'inner'}
    outer, inner = got['outer'], got['inner']
    assert (outer['count'], inner['count']) == (1, 2)
    assert inner['total_s'] >= 0.002 and inner['self_s'] == inner['total_s']
    assert outer['total_s'] >= 0.004
    assert outer['self_s'] == pytest.approx(
        outer['total_s'] - inner['total_s'], abs=1e-9)
    assert outer['self_s'] >= 0.002
    assert spans.span_summary() == {}


def test_span_left_by_an_exception_closes(spans):
    """A span whose body raises is still counted, and the span that was
    open around it goes on nesting what follows."""
    with spans.annotate('outer'):
        with pytest.raises(ValueError):
            with spans.annotate('failed'):
                raise ValueError
        with spans.annotate('after'):
            time.sleep(0.001)
    got = spans.span_summary()
    assert {name: got[name]['count'] for name in got} == {
        'outer': 1, 'failed': 1, 'after': 1}
    assert got['outer']['self_s'] == pytest.approx(
        got['outer']['total_s'] - got['failed']['total_s']
        - got['after']['total_s'], abs=1e-9)


def test_step_timer_is_the_step_span(spans):
    timer = profiling.StepTimer(items_per_step=8)
    for _ in range(3):
        with timer:
            with spans.annotate('train.forward'):
                time.sleep(0.001)
    got = spans.span_summary()
    assert got['train.step']['count'] == timer.count == 3
    # one clock: the timer's seconds are the span's
    assert got['train.step']['total_s'] == pytest.approx(timer.total_s,
                                                         abs=1e-9)
    assert got['train.step']['self_s'] == pytest.approx(
        timer.total_s - got['train.forward']['total_s'], abs=1e-9)


def test_trace_names_recorded_spans(tmp_path, spans):
    with profiling.trace(tmp_path / 'tb'):
        with spans.annotate('recorded-region'):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    events = json.loads((tmp_path / 'tb' / 'trace.json').read_text())
    assert any(e.get('name') == 'recorded-region'
               for e in events['traceEvents'])
    assert spans.span_summary()['recorded-region']['count'] == 1


def test_spans_from_many_threads(spans):
    """More threads than cores, switching often: no count is lost and each
    thread's nesting is its own."""
    threads, rounds = (os.cpu_count() or 1) + 4, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(rounds):
            with spans.annotate('t.outer'):
                with spans.annotate('t.inner'):
                    pass

    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    got = spans.span_summary()
    n = threads * rounds
    assert got['t.outer']['count'] == got['t.inner']['count'] == n
    assert got['t.outer']['self_s'] == pytest.approx(
        got['t.outer']['total_s'] - got['t.inner']['total_s'], abs=1e-6)
