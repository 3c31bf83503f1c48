"""One run of one cell: set-up, the measured window, the traced stretch,
the metrics, the check against the plain reference, and the result line.

The driver that the cell's traffic file names does the cell's own work
through a `Session`:

- ``Session(run)`` sets up: makes the inputs and weights from the seed,
  builds the program's objects, warms every shape the window uses;
- ``window(seconds)`` drives the program for `seconds` and puts
  what it counted into ``run.counters``;
- ``stretch(units, tracer)`` drives `units` more units after the window,
  under the profiler in a traced run (`trace.Tracer`);
- ``judge()`` frees the program's state, runs the reference and returns
  ``(readings, detail)``: every number it can compare, by name, and what
  else explains them. The cell's limits file names the numbers compared
  and holds their limits; ``failed`` counts those out of their limits.

Every metric is read by ``benchmark/metrics/<name>.py``.
"""

from __future__ import annotations

import gc
import json
import sys
import time

# top-level module names the run may not hold once its window has closed
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'facenet_tpu')


class Run:
    """What a run knows: the cell, the seed, the device, the set-up time,
    the driver's counters and the trace's analysis, read by the metric
    readers."""

    def __init__(self, cell, seed, seconds, trace, device='cuda',
                 variant='program'):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.variant = variant
        self.counters = {}
        self.analysis = None
        self.setup_s = None
        self.setup_parts = []
        self._mark = time.perf_counter()

    def mark(self, part):
        """Record the host seconds of a part of set-up since the last mark
        (printed to standard error, for finding what set-up costs)."""
        now = time.perf_counter()
        self.setup_parts.append((part, now - self._mark))
        self._mark = now

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic


def forbidden_modules():
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(run, peak):
    import torch
    if run.device == 'cpu':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 0,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': run.cell.chips, 'memory_peak_bytes': int(peak)}


def pace(counters):
    """Print the units the window took up in each of its quarters (host
    clock at each unit's issue), which shows a rate that drifts."""
    times = counters.pop('unit_times', None)
    if times:
        span = counters['window_s'] / 4
        quarters = [0] * 4
        for t in times:
            quarters[min(int(t / span), 3)] += 1
        print('window pace: units a quarter ' + ' '.join(map(str, quarters)),
              file=sys.stderr)


def execute(run, t0, read_metric=None):
    """Set up, measure, read and judge `run`; returns the result dict
    (the ``checks`` key last). `t0` is the process's start on the
    performance counter, from which set-up is timed."""
    import torch

    from benchmark.core import manifest, trace

    read_metric = read_metric or manifest.reader
    run._mark = t0
    run.mark('imports')
    drv = manifest.driver(run.traffic)
    session = drv.Session(run)
    if run.device != 'cpu':
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t0
    print('set-up ' + ', '.join(f'{part} {sec:.2f} s'
                                for part, sec in run.setup_parts)
          + f'; {run.setup_s:.2f} s from the start', file=sys.stderr)

    session.window(run.seconds)
    pace(run.counters)
    if run.trace:
        tracer = trace.Tracer(**run.traffic.get('trace', {}))
        run.analysis = tracer.trace(session.stretch, run.device)
    peak = (torch.cuda.max_memory_allocated() if run.device != 'cpu'
            else 0)

    wanted = run.cell.per_layer if run.trace else run.cell.end_to_end
    metrics = {}
    for metric in wanted:
        value = read_metric(metric['name'])(run)
        if value is not None:
            metrics[metric['name']] = {'value': float(value),
                                       'unit': metric['unit']}

    run.readings, run.detail = session.judge()
    del session
    gc.collect()
    checks = [(name, run.readings[name], limit)
              for name, limit in run.cell.limits.items()]
    failed = sum(value > limit for _, value, limit in checks)
    attempted = run.counters.get('units', 0)
    correct = not failed
    result = {'correct': bool(correct), 'attempted': int(attempted),
              'failed': int(failed), 'metrics': metrics,
              'device': device_info(run, peak)}
    if run.trace and run.analysis is not None:
        result['device']['busy_s'] = run.analysis['busy_s']
        result['device']['window_s'] = run.analysis['window_s']
        result['breakdown'] = trace.breakdown(run.analysis)
    result['checks'] = {name: {'value': float(value), 'limit': float(limit)}
                        for name, value, limit in checks}
    return result


def main(args, t0):
    """The command line's run; returns the exit code."""
    import torch

    from benchmark.core import manifest

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA device(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ' present', file=sys.stderr)
        return 2
    from benchmark.core import peaks
    # the shares of a peak are stated against the card's power limit
    print(f'card: {peaks.card_line()}', file=sys.stderr)
    run = Run(cell, args.seed, args.seconds, args.trace)
    result = execute(run, t0)
    found = forbidden_modules()
    if found:
        print(f'the run loaded {", ".join(found)}', file=sys.stderr)
        return 3
    for name, check in result['checks'].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
