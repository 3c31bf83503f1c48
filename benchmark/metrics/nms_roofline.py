"""The greedy NMS kernel (``csrc/nms_greedy.cu``: ``nms_greedy_mask_kernel``
and ``nms_greedy_scan_kernel``): the least time the H100 could take for
its work, the larger of its float32 operations over the FP32 peak (67
TFLOP/s) and its bytes over HBM's 3.35 TB/s (at 700 W), counting the pair
tests that exact greedy NMS needs on the candidates that entered it
(`retina_work.nms_work`), over the two kernels' device time a batch in the
trace."""

from benchmark.core import peaks, trace


def read(run):
    c, a = run.counters, run.analysis
    if run.device == 'cpu' or 'nms_ops' not in c:
        return None
    found = trace.kernel_seconds(a, r'nms_greedy_(mask|scan)_kernel')
    if found is None:
        return None
    bound = max(c['nms_ops'] / peaks.FP32_FLOPS,
                c['nms_bytes'] / peaks.HBM_BYTES)
    return 100 * bound / (found[0] / a['units'])
