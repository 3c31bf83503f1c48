"""Scenes whose outputs reached the host, over the whole window."""


def read(run):
    c = run.counters
    return c['scenes'] / c['window_s'] if c.get('scenes') else None
