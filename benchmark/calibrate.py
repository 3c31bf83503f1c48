"""Readings behind a cell's limits: the numbers its check compares, for the
program and for a control or a planted fault, over many seeds in one
process, each with a short window at the cell's own sizes.

    python3 benchmark/calibrate.py --workload NAME --seconds S \
        --variants program,control --seeds 11,12,13 [--out FILE]

A variant is one the cell's driver knows (``VARIANTS`` in its module):
'program' is the program as the cell runs it, 'control' the lower
precision, the rest planted faults. One JSON line a run goes to standard
output and, with --out, to that file.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--variants', default='program')
    p.add_argument('--seeds', required=True)
    p.add_argument('--out')
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run as entry
    entry._fixed_caches()
    from benchmark.core import harness, manifest

    out = open(args.out, 'a') if args.out else None
    for variant in args.variants.split(','):
        for seed in [int(s) for s in args.seeds.split(',')]:
            cell = manifest.cell(args.workload)
            run = harness.Run(cell, seed, args.seconds, False,
                              variant=variant)
            result = harness.execute(run, time.perf_counter())
            line = json.dumps({'workload': args.workload, 'variant': variant,
                               'seed': seed, 'readings': run.readings,
                               'detail': run.detail,
                               'metrics': result['metrics'],
                               'attempted': result['attempted'],
                               'peak': result['device']['memory_peak_bytes']})
            print(line, flush=True)
            if out:
                out.write(line + '\n')
                out.flush()
    return 0


if __name__ == '__main__':
    sys.exit(main())
