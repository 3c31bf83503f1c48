"""The check that decides ``correct``: each fault a cell can have, planted
under a whole run past the look for a chip, comes out not correct; on the
card, each cell's control does too."""

import time

import pytest

from benchmark.core import harness, manifest

from .conftest import run_tiny

FAULTS = [('irv1.embed-b1024', 'altered'),
          ('irv1.train-b800', 'frozen'),
          ('irv1.train-b800', 'half_batch'),
          ('mtcnn-irv1.crowd-b8', 'altered'),
          ('mtcnn-irv1.crowd-b8', 'half_batch'),
          ('mtcnn-irv1.single-b64', 'altered'),
          ('mtcnn-irv1.single-b64', 'half_batch')]


@pytest.mark.parametrize('cell,fault', FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    run, result = run_tiny(cell, variant=fault)
    assert not result['correct'], run.readings


# the training cell's limits are set at batch 800; at the TINY batch of 8
# train-mode BatchNorm's backward cancels far more, and its readings are
# held to the reference at bf16 instead (test_references.py)
@pytest.mark.parametrize('cell', [w['name'] for w in
                                  manifest.load()['workloads']
                                  if w['config'] != 'irv1'
                                  or 'train' not in w['name']])
def test_the_program_is_correct_on_the_cpu(cell):
    run, result = run_tiny(cell)
    assert result['correct'], run.readings


@pytest.mark.cuda
@pytest.mark.parametrize('cell', [w['name'] for w in
                                  manifest.load()['workloads']])
def test_the_control_at_the_cells_size_is_not_correct(card, cell):
    run = harness.Run(manifest.cell(cell), 2 ** 31 + 101, 3, False,
                      variant='control')
    result = harness.execute(run, time.perf_counter())
    assert not result['correct'], run.readings
