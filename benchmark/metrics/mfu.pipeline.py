"""Operations of the window's batches (P-Net over the pyramid, R-Net and
O-Net at their capacities, IRv1 over batch x num_faces crops; from
shapes, `work.pipeline_flops`) over the window, as a share of the H100's
published dense bf16 peak (989 TFLOP/s at 700 W)."""

from benchmark.core import peaks


def read(run):
    c = run.counters
    if run.device == 'cpu' or not c.get('scenes'):
        return None
    return 100 * c['flops_per_batch'] * c['units'] / c['window_s'] \
        / peaks.BF16_FLOPS
