"""Shared pieces of the benchmark's tests: cells cut to a TINY size that
the CPU runs in seconds, and the check for a card."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}}


def tiny_cell(name):
    """The cell `name` from its files, its network cut to one block of
    each kind and its traffic to a few small batches."""
    from benchmark.core import manifest
    cell = manifest.cell(name)
    cfg = cell.config
    topology = (cfg['embedding'] if 'embedding' in cfg else cfg)['topology']
    for key, value in TINY.items():
        topology[key].update(value)
    driver = cell.traffic['driver']
    if driver == 'embed':
        cell.traffic.update(batch=8, pool_batches=2, faces=4, sample=64,
                            reference_batch=8, warmup_batches=1)
    elif driver == 'train':
        cfg['training']['classes'] = 32
        cell.traffic.update(batch=8, pool_batches=4, faces=4)
    else:
        cell.traffic.update(batch=2, quadrants=6, sample_batches=1)
    cell.traffic['trace'] = {'units': 1, 'gap_units': 1}
    return cell


def run_tiny(name, variant='program', seconds=0.3, seed=2 ** 31 + 11,
             trace=False):
    """A whole run of the TINY cell `name` (or of a cell already cut) on
    the CPU, past the look for a chip: (run, result)."""
    from benchmark.core import harness
    cell = tiny_cell(name) if isinstance(name, str) else name
    run = harness.Run(cell, seed, seconds, trace, device='cpu',
                      variant=variant)
    return run, harness.execute(run, time.perf_counter())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the cell runs at its own size on '
                    'the card')
    return 'cuda'
