"""Host milliseconds a batch inside the program's ``retinaface.*`` spans
(backbone, neck, heads, decode, nms), recorded by the program's own span
clock (`utils.profiling.record_spans`) over a traced run's window: the
host's cost of enqueueing the detector."""


def read(run):
    c = run.counters
    return c['detect_issue_s'] * 1e3 if 'detect_issue_s' in c else None
