"""B2 (``dense_warp_kernel``, the landmark alignment's warp): its bytes
(the source pixels its taps read, the matrices, the crops written once;
`work.b2_bytes`) over HBM's 3.35 TB/s (at 700 W), over its device time a
batch in the trace."""

from benchmark.core import peaks, trace


def read(run):
    c, a = run.counters, run.analysis
    if run.device == 'cpu' or 'b2_bytes' not in c:
        return None
    found = trace.kernel_seconds(a, r'dense_warp_kernel')
    if found is None:
        return None
    return 100 * (c['b2_bytes'] / peaks.HBM_BYTES) / (found[0] / a['units'])
