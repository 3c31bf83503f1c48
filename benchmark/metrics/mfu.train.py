"""Forward and backward operations of the backbone and the softmax head
(from shapes) times the window's images, over the window, as a share of
the H100's published dense bf16 peak (989 TFLOP/s at 700 W)."""

from benchmark.core import peaks


def read(run):
    c = run.counters
    if run.device == 'cpu' or not c.get('images'):
        return None
    return 100 * c['flops_per_image'] * c['images'] / c['window_s'] \
        / peaks.BF16_FLOPS
