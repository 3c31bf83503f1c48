"""Tracing, spans, step timing and debug switches.

  * `trace(logdir)` — a context manager that runs torch.profiler (host and
    CUDA activity) over its body and writes a Chrome trace
    (``<logdir>/trace.json``, loaded by Perfetto, chrome://tracing or
    TensorBoard's trace viewer);
  * `annotate(name)` — a named span around a call. While a profiler runs,
    the span is a ``torch.profiler.record_function`` in its trace, on the
    clock of the kernels and copies it launches. While host recording is
    on, each span also adds its host duration to an aggregate by name.
    Otherwise it is one shared no-op context: a flag and a profiler check.
  * host recording — ``record_spans(True)`` turns it on, ``record_spans(
    False)`` off; ``span_summary(reset=True)`` reads and clears what it
    gathered: ``{name: {'count', 'total_s', 'self_s'}}`` (``self_s`` is
    the time no child span of the same thread covers). Aggregates only:
    memory stays bounded over any run, and the profiler's trace has the
    single events.
  * `StepTimer` — wall-clock time a step with an EMA and items/s, logged
    every N steps; each step is the ``train.step`` span;
  * `start_server` — the JAX package's on-demand profiling server, which
    torch has no counterpart of: it raises NotImplementedError;
  * `TraceWindow` — the trainer's trace of a window of steps, written the
    same way;
  * `apply_debug_config(cfg)` — the ``debug:`` keys of the train config:
    ``nans: true`` turns on autograd's anomaly mode, which raises on the
    first backward op that makes a NaN; ``xla_dump_to`` is a key of the JAX
    package (an XLA HLO dump directory) that the port has nothing for and
    ignores with a warning.

The port's spans (each wraps calls, never a compiled or captured region):

  ``facenet.h2d``, ``facenet.forward``   `FastEmbedder` / `FastEmbedderV2`:
      the uint8 batch on its way to the device (a host batch for a CUDA
      device: the host's copy into a pinned slot and the copy's launch on
      `staging.HostStager`'s stream; a batch already on the device: none),
      then preprocessing, the network and normalization;
  ``facenet.h2d.stage``, ``facenet.h2d.slot_wait``   `HostStager`: the
      host's copy of a batch into a pinned slot, one a staged batch; the
      wait for a slot's previous copy to the device, entered only when that
      copy had not finished (its count is how often the ring was too
      shallow);
  ``embeddings.fetch``, ``embeddings.finish``   `facenet.evaluate_embeddings`:
      the wait for a batch's embeddings on the host, and the concatenation
      and float64 renormalization after the last batch;
  ``pipeline.h2d``, ``pipeline.align``, ``pipeline.embed``   `FacePipeline`:
      the scenes' copy, the alignment with its uint8 clamp, the embedding
      of the crops (``facenet.*`` nest in it);
  ``mtcnn.pnet``, ``mtcnn.rnet``, ``mtcnn.onet``   the MTCNN cascade's three
      stages (pyramid, P-Net and cross-level NMS; 24 px crops, R-Net, NMS,
      regression; 48 px crops, O-Net, landmarks and the final order);
  ``train.place``   `SoftmaxTrainer.placed`: pinning a host batch and its
      copies to the device;
  ``train.step``, and inside it ``train.forward``, ``train.backward``,
  ``train.adam``   a training step: augmentation through the loss; the
      gradients' clearing, the backward pass and their average over data
      ranks; the learning rate and Adam's update.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path

import torch

from facenet_tpu_torch.logging import logger

TRACE_FILE = 'trace.json'
STEP_SPAN = 'train.step'

_OFF = contextlib.nullcontext()
_recording = False
_lock = threading.Lock()
_local = threading.local()
_spans = {}        # name -> [count, total ns, self ns]


def _profile():
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _write(prof, trace_dir):
    """Stop `prof` after the device's work and write its Chrome trace."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    trace_dir = Path(str(trace_dir))
    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / TRACE_FILE
    prof.export_chrome_trace(str(path))
    logger.info(f'profiler trace written to {path}')
    return path


@contextlib.contextmanager
def trace(logdir):
    """Profile everything inside the context into ``<logdir>/trace.json``;
    yields the profiler (its ``key_averages()`` tables are there after the
    context)."""
    prof = _profile()
    prof.start()
    try:
        yield prof
    finally:
        _write(prof, logdir)


def start_server(port=9999):
    """The JAX package starts jax.profiler's on-demand server here; torch
    has no such server, so this raises. Trace a region with `trace`."""
    raise NotImplementedError(
        'torch has no on-demand profiling server; use '
        'facenet_tpu_torch.utils.profiling.trace(logdir) around the region')


def annotate(name):
    """A named span around a call (see the module docstring): a
    ``record_function`` while a profiler runs, timed on the host while
    recording is on, a shared no-op otherwise."""
    if _recording:
        return _Span(str(name))
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(str(name))
    return _OFF


def record_spans(on=True):
    """Turn host recording of spans on or off."""
    global _recording
    _recording = bool(on)


def span_summary(reset=False):
    """What recording gathered: ``{span: {'count', 'total_s', 'self_s'}}``;
    with `reset`, the aggregates start afresh."""
    global _spans
    with _lock:
        spans = _spans
        if reset:
            _spans = {}
        else:
            spans = {k: list(v) for k, v in spans.items()}
    return {name: {'count': n, 'total_s': total / 1e9, 'self_s': own / 1e9}
            for name, (n, total, own) in spans.items()}


class _Span:
    """A span timed on the host: `ns` is its duration once closed. It is
    added to the aggregate when recording was on at its start, and marks
    the profiler's trace while a profiler runs."""

    __slots__ = ('name', 'ns', '_start', '_inner', '_stack', '_marker')

    def __init__(self, name):
        self.name = name
        self.ns = 0

    def __enter__(self):
        self._marker = None
        if torch.autograd._profiler_enabled():
            self._marker = torch.profiler.record_function(self.name)
            self._marker.__enter__()
        self._stack = None
        if _recording:
            self._stack = getattr(_local, 'stack', None)
            if self._stack is None:
                self._stack = _local.stack = []
            self._stack.append(self)
        self._inner = 0
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ns = time.perf_counter_ns() - self._start
        stack = self._stack
        if stack is not None:
            stack.pop()
            if stack:
                stack[-1]._inner += self.ns
            with _lock:
                entry = _spans.setdefault(self.name, [0, 0, 0])
                entry[0] += 1
                entry[1] += self.ns
                entry[2] += self.ns - self._inner
        if self._marker is not None:
            self._marker.__exit__(*exc)
        return False


class StepTimer:
    """Wall-clock per-step timing with an EMA and items/s throughput;
    with `log_every`, it logs itself every that many steps. Time on the
    host: a step whose device work is still queued reads as issued. Each
    step is the ``train.step`` span, whose clock times it."""

    def __init__(self, items_per_step=0, ema=0.95, log_every=0, name='step'):
        self.items_per_step = items_per_step
        self.ema_factor = ema
        self.log_every = log_every
        self.name = name
        self.reset()

    def reset(self):
        self.count = 0
        self.ema_s = None
        self.total_s = 0.0
        self._span = None

    def __enter__(self):
        self._span = _Span(STEP_SPAN).__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        dt = self._span.ns / 1e9
        self.count += 1
        self.total_s += dt
        self.ema_s = (dt if self.ema_s is None
                      else self.ema_factor * self.ema_s +
                      (1 - self.ema_factor) * dt)
        if self.log_every and self.count % self.log_every == 0:
            logger.info(str(self))
        return False

    @property
    def items_per_sec(self):
        if not self.ema_s:
            return 0.0
        return self.items_per_step / self.ema_s

    def __repr__(self):
        msg = (f'{self.name} {self.count}: '
               f'{(self.ema_s or 0) * 1000:.1f} ms/step (ema)')
        if self.items_per_step:
            msg += f', {self.items_per_sec:.1f} items/s'
        return msg


class TraceWindow:
    """torch.profiler over steps [start, start + num_steps) of one epoch.

    Call `step(epoch, n)` before step n runs and `close()` after the
    epoch; the trace lands in ``<trace_dir>/trace.json``."""

    def __init__(self, trace_dir, epoch=0, start_step=3, num_steps=5):
        self.trace_dir = Path(str(trace_dir)) if trace_dir else None
        self.epoch = int(epoch)
        self.start = int(start_step)
        self.stop = self.start + int(num_steps)
        self._prof = None

    def step(self, epoch, n):
        if self.trace_dir is None or epoch != self.epoch:
            return
        if n == self.start and self._prof is None:
            self._prof = _profile()
            self._prof.start()
        elif n == self.stop:
            self.close()

    def close(self):
        if self._prof is None:
            return
        _write(self._prof, self.trace_dir)
        self._prof = None


def apply_debug_config(cfg):
    """Apply the ``debug:`` switches of a train config (see the module
    docstring)."""
    if not cfg:
        return
    if cfg.nans:
        torch.autograd.set_detect_anomaly(True)
        logger.info('autograd anomaly detection enabled (debug.nans)')
    if cfg.xla_dump_to:
        logger.warning('debug.xla_dump_to names an XLA dump directory; the '
                       'PyTorch port has no XLA and ignores it')
