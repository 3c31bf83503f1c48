"""The IRv1 forward's operations (from shapes) times the images of the
window, over the window, as a share of the H100's published dense bf16
peak (989 TFLOP/s at 700 W)."""

from benchmark.core import peaks


def read(run):
    c = run.counters
    if run.device == 'cpu' or 'images' not in c:
        return None
    return 100 * c['flops_per_image'] * c['images'] / c['window_s'] \
        / peaks.BF16_FLOPS
