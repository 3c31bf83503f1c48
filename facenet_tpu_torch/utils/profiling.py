"""Tracing, step timing and debug switches.

  * `trace(logdir)` — a context manager that runs torch.profiler (host and
    CUDA activity) over its body and writes a Chrome trace
    (``<logdir>/trace.json``, loaded by Perfetto, chrome://tracing or
    TensorBoard's trace viewer); `annotate(name)` marks a named span in
    it (``torch.profiler.record_function``);
  * `StepTimer` — wall-clock time a step with an EMA and items/s, logged
    every N steps;
  * `start_server` — the JAX package's on-demand profiling server, which
    torch has no counterpart of: it raises NotImplementedError;
  * `TraceWindow` — the trainer's trace of a window of steps, written the
    same way;
  * `apply_debug_config(cfg)` — the ``debug:`` keys of the train config:
    ``nans: true`` turns on autograd's anomaly mode, which raises on the
    first backward op that makes a NaN; ``xla_dump_to`` is a key of the JAX
    package (an XLA HLO dump directory) that the port has nothing for and
    ignores with a warning.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

from facenet_tpu_torch.logging import logger

TRACE_FILE = 'trace.json'


def _profile():
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _write(prof, trace_dir):
    """Stop `prof` after the device's work and write its Chrome trace."""
    import torch
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
    """A named span in the trace (``torch.profiler.record_function``)."""
    import torch
    return torch.profiler.record_function(str(name))


class StepTimer:
    """Wall-clock per-step timing with an EMA and items/s throughput;
    with `log_every`, it logs itself every that many steps. Time on the
    host: a step whose device work is still queued reads as issued."""

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
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
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
        import torch
        torch.autograd.set_detect_anomaly(True)
        logger.info('autograd anomaly detection enabled (debug.nans)')
    if cfg.xla_dump_to:
        logger.warning('debug.xla_dump_to names an XLA dump directory; the '
                       'PyTorch port has no XLA and ignores it')
