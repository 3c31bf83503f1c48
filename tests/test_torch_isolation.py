"""The port stands alone: no module of facenet_tpu_torch, nor chip_smoke.py,
imports JAX or anything of facenet_tpu; its entry points do not fall back
to the CPU when no GPU was asked for the CPU."""

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
print(json.dumps({'count': len(names), 'bad': bad}))
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_no_facenet_tpu():
    proc = _run(['-c', _PROBE], ROOT)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['count'] >= 15
    assert result['bad'] == []


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
