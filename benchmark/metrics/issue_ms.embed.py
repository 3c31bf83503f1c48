"""Host milliseconds inside `FaceNet.dispatch`, mean a batch: the host's
cost of issuing one forward (host clock around each call)."""


def read(run):
    c = run.counters
    return c['issue_s'] * 1e3 if 'issue_s' in c and 'images' in c else None
