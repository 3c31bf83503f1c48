"""The traced run: torch.profiler over a stretch of the window, and what is
read from its trace.

The measured window runs untraced. After it has closed, the driver drives
more units of the same work (batches, steps) under the profiler
(`Tracer`), wrapping its calls into the program in `Tracer.span`; each
trace is read once its profiler has stopped, as the Chrome trace
torch.profiler writes, and device time is counted as
``chip_smoke.py::trace_busy`` and ``utils/timing.py::device_busy`` count
it: the kernels', copies' and memsets' own durations (``kernel``,
``gpu_memcpy``, ``gpu_memset``), without annotations.

Busy time is the union of those intervals, so that work on two streams at
once counts once, over a stretch that records the device's activity alone
(recording every host operation as well would slow the host, and with it
the device, by as much as the launches cost). An idle gap is a stretch
with no device operation running, found in a second, shorter profile that
records the host too; it is named by the benchmark span (``bench.*``) and
the outermost host operation running at its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


class NullTracer:
    """No profiler and no spans: the measured window."""

    def span(self, name):
        return contextlib.nullcontext()


class Tracer(NullTracer):
    """Three short profiles after the window: one unit to bring the
    profiler up (discarded); ``units`` units with the device's activity
    alone, for the busy time, the kernels and the window, at little cost
    to the host; and ``gap_units`` units with the host's operations too,
    inside one ``bench.stretch`` span, for what the host did while the
    device idled."""

    def __init__(self, units=10, gap_units=2):
        self.units = int(units)
        self.gap_units = int(gap_units)
        self.analysis = None

    def span(self, name):
        from torch.profiler import record_function
        return record_function(name)

    def trace(self, drive, device):
        """Profile `drive(units, tracer)` as above; sets and returns
        `analysis`."""
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = device != 'cpu'

        def sync():
            if cuda:
                torch.cuda.synchronize()

        host = [ProfilerActivity.CPU]
        both = host + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=both):
            drive(1, NullTracer())
            sync()
        with profile(activities=[ProfilerActivity.CUDA] if cuda
                     else host) as prof:
            t0 = time.perf_counter()
            drive(self.units, NullTracer())
            sync()
            window_s = time.perf_counter() - t0
        self.analysis = device_activity(_events(prof), window_s, self.units)
        with profile(activities=both) as prof:
            with self.span('bench.stretch'):
                drive(self.gap_units, self)
                sync()
        self.analysis['gaps'] = idle_gaps(_events(prof))
        return self.analysis


def _events(prof):
    """The complete events ('X') of a finished profile's Chrome trace."""
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return [e for e in trace.get('traceEvents', []) if e.get('ph') == 'X']


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def short_name(name, width=64):
    """A kernel's name as the ledger keeps it: word characters only,
    at most `width` of them."""
    return re.sub(r'[^A-Za-z0-9_./:]', '_', name)[:width]


def device_activity(events, window_s, units):
    """{'busy_s', 'window_s', 'units', 'kernels': {name: [seconds, count]}}
    of a profile of the device's activity over `units` units, which the
    host's clock timed at `window_s`."""
    device = [(e['ts'], e['ts'] + e['dur'], e['name']) for e in events
              if e.get('cat') in DEVICE_CATS]
    kernels = {}
    for start, end, name in device:
        row = kernels.setdefault(name, [0.0, 0])
        row[0] += (end - start) / 1e6
        row[1] += 1
    busy = _merge([(start, end) for start, end, _ in device])
    return {'busy_s': sum(e - s for s, e in busy) / 1e6,
            'window_s': float(window_s), 'units': int(units),
            'kernels': kernels}


def idle_gaps(events, count=10):
    """[(what the host was doing, seconds)] of the `count` longest
    stretches inside the ``bench.stretch`` span with no device operation
    running, longest first."""
    stretch = [e for e in events if e.get('name') == 'bench.stretch'
               and e.get('cat') == 'user_annotation']
    if not stretch:
        return []
    lo = stretch[0]['ts']
    hi = lo + stretch[0]['dur']
    busy = _merge([(max(e['ts'], lo), min(e['ts'] + e['dur'], hi))
                   for e in events if e.get('cat') in DEVICE_CATS
                   and e['ts'] < hi and e['ts'] + e['dur'] > lo])
    gaps, cursor = [], lo
    for start, end in busy:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if hi > cursor:
        gaps.append((cursor, hi))
    host = [e for e in events if e.get('cat') in ('cpu_op', 'user_annotation')
            and e.get('name') != 'bench.stretch']
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:count]
    return [(_host_at(host, (start + end) / 2), (end - start) / 1e6)
            for start, end in longest]


def _host_at(host, t):
    """'<bench span>/<outermost host op>' running at time `t`."""
    covering = [e for e in host if e['ts'] <= t <= e['ts'] + e['dur']]
    spans = [e for e in covering if str(e['name']).startswith('bench.')]
    ops = [e for e in covering if not str(e['name']).startswith('bench.')]
    parts = []
    if spans:
        parts.append(min(spans, key=lambda e: e['dur'])['name'])
    if ops:
        parts.append(max(ops, key=lambda e: e['dur'])['name'])
    return short_name('/'.join(parts) or 'host')


def kernel_seconds(analysis, pattern):
    """(seconds, launches) of the traced kernels whose names match the
    regular expression `pattern`; None when none ran."""
    if analysis is None:
        return None
    rx = re.compile(pattern)
    rows = [v for k, v in analysis['kernels'].items() if rx.search(k)]
    if not rows:
        return None
    return sum(r[0] for r in rows), sum(r[1] for r in rows)


def breakdown(analysis):
    """The result line's ``breakdown``: the ten device operations that
    took most time and the ten longest idle gaps, in seconds."""
    top = sorted(analysis['kernels'].items(), key=lambda kv: -kv[1][0])[:10]
    return {'device_ops': [[short_name(k), v[0]] for k, v in top],
            'idle_gaps': [[name, s] for name, s in analysis['gaps']]}
