"""Operations of the window's batches (RetinaFace-R50 over every frame at
its shape, IRv1 over batch x num_faces crops; from shapes,
`retina_work.pipeline_flops`) over the window, as a share of the H100's
published dense bf16 peak (989 TFLOP/s at 700 W)."""

from benchmark.core import peaks


def read(run):
    c = run.counters
    if run.device == 'cpu' or not c.get('scenes') or \
            'nms_ops' not in c:
        return None
    return 100 * c['flops_per_batch'] * c['units'] / c['window_s'] \
        / peaks.BF16_FLOPS
