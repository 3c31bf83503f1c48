"""Images of the whole steps the window ran, over the window, which a
synchronize closes."""


def read(run):
    c = run.counters
    return c['images'] / c['window_s'] if c.get('images') else None
