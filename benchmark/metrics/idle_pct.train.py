"""Share of the traced stretch in which no kernel, copy or memset ran on
the device."""


def read(run):
    a = run.analysis
    if run.device == 'cpu' or a is None or a['window_s'] <= 0:
        return None
    return 100 * (1 - a['busy_s'] / a['window_s'])
