"""B3 (``pnet_pyramid_kernel``, the whole-pyramid P-Net): the least time
the H100 could take for its work, the larger of its operations over the
dense bf16 peak (989 TFLOP/s) and its bytes over HBM's 3.35 TB/s (at
700 W; `work.pnet_work`), over its device time a batch in the trace."""

from benchmark.core import peaks, trace


def read(run):
    c, a = run.counters, run.analysis
    if run.device == 'cpu' or 'b3_ops' not in c:
        return None
    found = trace.kernel_seconds(a, r'pnet_pyramid_kernel')
    if found is None:
        return None
    bound = max(c['b3_ops'] / peaks.BF16_FLOPS, c['b3_bytes'] / peaks.HBM_BYTES)
    return 100 * bound / (found[0] / a['units'])
