"""Host milliseconds inside `FacePipeline.dispatch`, mean a batch: the
host's cost of enqueueing one batch (host clock around each call)."""


def read(run):
    c = run.counters
    return c['issue_s'] * 1e3 if c.get('scenes') else None
