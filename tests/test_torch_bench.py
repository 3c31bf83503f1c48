"""The port's bench (facenet_tpu_torch/bench.py) through its protocol on
the CPU: ``BENCH_TINY=1 --device cpu`` in a subprocess that imports no JAX,
and the entry points of this slice raise without a GPU unless asked for
the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_BENCH = """
import runpy, sys
sys.argv = ['bench', '--device', 'cpu']
runpy.run_module('facenet_tpu_torch.bench', run_name='__main__')
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'flax', 'facenet_tpu'))
print('IMPORTED', bad)
"""


def test_bench_tiny_on_cpu_prints_its_lines():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['BENCH_TINY'] = '1'
    env['OMP_NUM_THREADS'] = '2'     # as `torch_testing.few_threads`
    proc = subprocess.run([sys.executable, '-c', _BENCH], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == 'IMPORTED []'
    first, busy8, int8, busy16, last = (json.loads(line)
                                        for line in lines[-6:-1])
    assert first['value'] == 0.0 and 'error' in first
    for busy, serving in ((busy8, 'int8'), (busy16, 'bf16')):
        assert busy['serving'] == serving and busy['device'] == 'cpu'
        assert busy['device_busy_ms_per_chunk'] == 'not measured'
    # int8 is measured first, and its line stands until bf16 is measured
    assert int8['serving'] == 'int8' and 'bf16_img_per_s' not in int8
    assert int8['value'] == int8['int8_img_per_s'] > 0 and 'error' not in int8
    assert last['metric'] == 'embeddings_per_sec_single_chip'
    assert last['unit'] == 'img/s' and last['value'] > 0
    assert last['int8_img_per_s'] == int8['int8_img_per_s']
    assert last['value'] == max(last['int8_img_per_s'],
                                last['bf16_img_per_s'])
    assert last['serving'] == ('int8' if last['int8_img_per_s']
                               >= last['bf16_img_per_s'] else 'bf16')
    assert last['vs_baseline'] == round(last['value'] / 297.0, 2)
    assert 'error' not in last


@pytest.mark.parametrize('module', ['facenet_tpu_torch.bench',
                                    'facenet_tpu_torch.apps.embeddings',
                                    'facenet_tpu_torch.apps.validate_on_lfw'])
def test_entry_point_without_device_raises_on_cpu_only_box(module):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    import importlib
    with pytest.raises(RuntimeError, match='CUDA'):
        importlib.import_module(module).main([])
