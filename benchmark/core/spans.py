"""Device time by the program's own spans, read from a profile that
recorded the host's operations with the device's (the idle-gap profile of
`trace.Tracer.trace`).

The program marks its layers with ``facenet_tpu_torch.utils.profiling.
annotate`` spans, which a running profiler records as ``user_annotation``
events on the thread that opened them. A device operation (a kernel, copy
or memset) belongs to the innermost program span open at its launch: the
``cuda_runtime`` or ``cuda_driver`` event that carries the operation's
``correlation`` id, looked up on the launching thread or, where that
thread has no span open (autograd's device threads issue the backward
pass), on the thread that had the innermost one open at that moment. A
launch, not the operation's own start, decides: with two batches in
flight an operation runs after the next batch's spans have opened. The
benchmark's own spans (``bench.*``) are not the program's.
"""

from __future__ import annotations

from collections import defaultdict

from benchmark.core.trace import DEVICE_CATS

LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')


def _covering(spans, t):
    """The spans of one thread open at time `t`, outermost first."""
    return sorted((s for s in spans if s[0] <= t <= s[1]),
                  key=lambda s: s[0] - s[1])


def device_by_span(events, units):
    """Device seconds and operations by program span over `units` units
    of a profile's complete events:

    ``{'spans': {span: [s, ops]}`` (each operation under its innermost
    span), ``'under': {span: [s, ops]}`` (under the span or any span nested
    in it), ``'other': [s, ops]`` (launched under no program span),
    ``'units': units}``."""
    by_thread = defaultdict(list)
    launches = {}
    device = []
    for e in events:
        cat = e.get('cat')
        if cat == 'user_annotation':
            name = str(e.get('name'))
            if not name.startswith('bench.'):
                by_thread[e.get('tid')].append(
                    (e['ts'], e['ts'] + e['dur'], name))
        elif cat in LAUNCH_CATS:
            corr = (e.get('args') or {}).get('correlation')
            if corr is not None:
                launches[corr] = (e.get('tid'), e['ts'])
        elif cat in DEVICE_CATS:
            device.append(e)
    spans = defaultdict(lambda: [0.0, 0])
    under = defaultdict(lambda: [0.0, 0])
    other = [0.0, 0]
    for e in device:
        seconds = e['dur'] / 1e6
        launch = launches.get((e.get('args') or {}).get('correlation'))
        chain = []
        if launch is not None:
            tid, t = launch
            chain = _covering(by_thread.get(tid, ()), t)
            if not chain:
                chains = [_covering(s, t) for k, s in by_thread.items()
                          if k != tid]
                chains = [c for c in chains if c]
                if chains:
                    chain = min(chains,
                                key=lambda c: c[-1][1] - c[-1][0])
        if not chain:
            other[0] += seconds
            other[1] += 1
            continue
        row = spans[chain[-1][2]]
        row[0] += seconds
        row[1] += 1
        for name in {s[2] for s in chain}:
            row = under[name]
            row[0] += seconds
            row[1] += 1
    return {'spans': dict(spans), 'under': dict(under), 'other': other,
            'units': int(units)}
