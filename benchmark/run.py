"""Run one cell of the benchmark of facenet_tpu_torch on this machine's
CUDA devices and print its result as the last line of standard output.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its
per-layer metrics from a torch.profiler trace of part of the window. The
last lines of standard error are the numbers compared with the plain
reference, each beside its limit. Without the CUDA devices the cell asks
for, it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / 'benchmark' / '_cache'


def _fixed_caches():
    """Kernel and build caches at fixed paths inside the checkout, so that
    every run after a checkout's first finds them built (the port's own
    nvcc builds go to facenet_tpu_torch/_build/ already)."""
    os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(CACHE / 'triton')
    os.environ['CUDA_CACHE_PATH'] = str(CACHE / 'nv')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))
    from benchmark.core import harness
    return harness.main(args, T0)


if __name__ == '__main__':
    sys.exit(main())
