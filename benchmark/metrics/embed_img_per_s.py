"""Images whose embeddings reached the host, over the whole window."""


def read(run):
    c = run.counters
    return c['images'] / c['window_s'] if 'images' in c else None
