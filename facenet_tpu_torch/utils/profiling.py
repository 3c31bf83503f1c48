"""The trainer's trace window and debug switches.

  * `TraceWindow` — a torch.profiler trace (host and CUDA activity) of a
    window of steps, written as a Chrome trace (``trace.json``, readable by
    Perfetto or chrome://tracing) into a directory;
  * `apply_debug_config(cfg)` — the ``debug:`` keys of the train config:
    ``nans: true`` turns on autograd's anomaly mode, which raises on the
    first backward op that makes a NaN; ``xla_dump_to`` is a key of the JAX
    package (an XLA HLO dump directory) that the port has nothing for and
    ignores with a warning.
"""

from __future__ import annotations

from pathlib import Path

from facenet_tpu_torch.logging import logger


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
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif n == self.stop:
            self.close()

    def close(self):
        if self._prof is None:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        path = self.trace_dir / 'trace.json'
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        logger.info(f'profiler trace written to {path}')


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
