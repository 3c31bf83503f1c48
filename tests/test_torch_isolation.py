"""The port stands alone: no module of facenet_tpu_torch, nor chip_smoke.py,
imports JAX or anything of facenet_tpu, nor PIL when it is imported; its
entry points do not fall back to the CPU when no GPU was asked for the
CPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import facenet_tpu_torch
names = ['chip_smoke'] + [m.name for m in pkgutil.walk_packages(
    facenet_tpu_torch.__path__, 'facenet_tpu_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ('jax', 'flax') or m.startswith(('jax.', 'flax.'))
             or m == 'facenet_tpu' or m.startswith('facenet_tpu.'))
pil = sorted(m for m in sys.modules if m.split('.')[0] == 'PIL')
print(json.dumps({'count': len(names), 'bad': bad, 'pil': pil,
                  'names': names}))
"""

TOOLS = ('try_pnet_v3', 'try_pallas_pnet', 'try_stem_flat',
         'time_stem_serving', 'time_cascade_ab')

_TOOL = """
import runpy, sys
sys.argv = ['{name}', '--device', 'cpu']
runpy.run_module('facenet_tpu_torch.tools.{name}', run_name='__main__')
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'flax', 'facenet_tpu'))
assert not bad, bad
print('TOOL-OK')
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['OMP_NUM_THREADS'] = '2'     # as `torch_testing.few_threads`
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_no_facenet_tpu():
    proc = _run(['-c', _PROBE], ROOT)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['count'] >= 15
    assert result['bad'] == []
    assert result['pil'] == []      # the card's machine may have no PIL
    for name in ('ops.stem', 'ops.cuda_build', 'utils.timing',
                 'detectors.mtcnn.pnet', 'models.irv1_fast', 'tools',
                 *(f'tools.{tool}' for tool in TOOLS), 'lfw',
                 'utils.tfrecord', 'apps.embeddings', 'apps.validate_on_lfw',
                 'bench', 'models.quantize', 'ops.int8_conv',
                 'models.inception_resnet_v2', 'models.irv2_fast',
                 'tools.validate_int8', 'ops.losses', 'ops.lr_schedules',
                 'train.softmax', 'train.checkpoint', 'callbacks',
                 'apps.train_softmax', 'parallel.mesh',
                 'parallel.sharded_eval', 'parallel.launch',
                 'apps.train_softmax_distributed', 'faceclass',
                 'train.classifier', 'apps.train_classifier',
                 'detectors.frcnn', 'detectors.frcnn.network',
                 'detectors.frcnn.detector', 'train.mtcnn',
                 'apps.train_detector', 'models', 'models.import_weights',
                 'utils.profiling', 'utils.debug', 'apps.export_model',
                 'apps.model_info', 'apps.dataset', 'native',
                 'tools.probe_native'):
        assert f'facenet_tpu_torch.{name}' in result['names'], name


@pytest.mark.parametrize('tool', TOOLS)
def test_tool_runs_its_cpu_half_without_jax(tool):
    """`python -m facenet_tpu_torch.tools.<tool> --device cpu` runs the
    equivalence half on the plain versions and imports no JAX; without
    `--device cpu` and without a GPU it raises."""
    proc = _run(['-c', _TOOL.format(name=tool)], ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith('TOOL-OK')
    if torch.cuda.is_available():
        return
    import importlib
    module = importlib.import_module(f'facenet_tpu_torch.tools.{tool}')
    with pytest.raises(RuntimeError, match='CUDA'):
        module.main([])


def test_facenet_without_device_raises_on_cpu_only_box(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    import facenet_tpu_torch
    with pytest.raises(RuntimeError, match='CUDA'):
        facenet_tpu_torch.FaceNet(tmp_path)


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    proc = _run([str(ROOT / 'chip_smoke.py')], ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

    alone = tmp_path / 'chip_smoke.py'
    shutil.copy(ROOT / 'chip_smoke.py', alone)
    proc = _run([str(alone)], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
