"""The port's compiled serving artifact and activation dump
(`facenet_tpu_torch.export`), as tests/test_export_compiled.py holds the
JAX package's, on the TINY Inception-ResNet-v1 (and one TINY IRv2).

  * `save_compiled` writes a `torch.export` program (``model.pt2``) of the
    fused bf16 forward with a symbolic batch: batches 1, 3 and 8 of one
    artifact against `FaceNet` (``stem='cudnn'``) at cosine >= 0.9999 and
    atol 5e-3 (JAX's bounds);
  * it loads and runs in a subprocess where any import of
    ``facenet_tpu_torch`` fails;
  * the int8 artifact is FaceNet's int8 forward, and asking for int8
    without a calibration batch raises;
  * the op histogram names the convolutions and the bottleneck's linear;
  * `export_h5` writes the names JAX's `export_h5` writes from the same
    tree, and each activation lies at cosine >= 0.999 of JAX's (both
    bf16), the weights and statistics exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from facenet_tpu import export as jax_export
from facenet_tpu import h5utils as jax_h5utils
from facenet_tpu.models.inception_resnet_v1 import \
    InceptionResnetV1 as JaxIRv1
from facenet_tpu_torch import FaceNet, export, h5utils
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.models.inception_resnet_v1 import (InceptionResnetV1,
                                                           init_variables)
from facenet_tpu_torch.ops import int8_conv
from torch_testing import TINY, few_threads, randomized_variables  # noqa: F401


def _bundle(variables, model_class='InceptionResnetV1', config=TINY):
    return export.ModelBundle(variables, {
        'model_class': model_class, 'config': config, 'image_size': 160,
        'normalization': 0})


@pytest.fixture(scope='module')
def artifact(tmp_path_factory):
    variables = randomized_variables()
    path = export.save_compiled(tmp_path_factory.mktemp('art'),
                                _bundle(variables), device='cpu')
    return variables, path


def _cosines(got, want):
    return (got * want).sum(axis=1)


def test_artifact_matches_facenet_at_any_batch(artifact):
    variables, path = artifact
    assert path.name == 'model.pt2' and path.stat().st_size > 1000
    compiled = export.load_compiled(path.parent, device='cpu')
    facenet = FaceNet(Config({}), device='cpu', bundle=_bundle(variables))
    rng = np.random.RandomState(0)
    for batch in (1, 3, 8):
        images = rng.randint(0, 256, (batch, 160, 160, 3), np.uint8)
        got = compiled(images).numpy()
        want = facenet.evaluate(images)
        assert got.shape == (batch, 32)
        np.testing.assert_allclose(got, want, atol=5e-3)
        assert _cosines(got, want).min() > 0.9999


def test_artifact_runs_without_the_package(artifact, tmp_path):
    variables, path = artifact
    images = np.random.RandomState(1).randint(0, 256, (2, 160, 160, 3),
                                              np.uint8)
    np.save(tmp_path / 'in.npy', images)
    script = f'''
import sys
sys.modules['facenet_tpu_torch'] = None   # any import of the port fails
import numpy as np, torch
program = torch.export.load({str(path)!r})
out = program.module()(torch.from_numpy(np.load({str(tmp_path / 'in.npy')!r})))
np.save({str(tmp_path / 'out.npy')!r}, out.numpy())
'''
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    run = subprocess.run([sys.executable, '-c', script], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    want = FaceNet(Config({}), device='cpu',
                   bundle=_bundle(variables)).evaluate(images)
    np.testing.assert_allclose(np.load(tmp_path / 'out.npy'), want,
                               atol=5e-3)


def test_int8_artifact(artifact, tmp_path):
    variables, _ = artifact
    rng = np.random.RandomState(2)
    calib = rng.randint(0, 256, (8, 160, 160, 3), np.uint8)
    path = export.save_compiled(tmp_path / 'q', _bundle(variables),
                                quantize='int8', calib_images=calib,
                                device='cpu')
    compiled = export.load_compiled(path, device='cpu')
    assert 'int8' in compiled.graph()
    images = rng.randint(0, 256, (3, 160, 160, 3), np.uint8)
    got = compiled(images).numpy()
    want = FaceNet(Config({'quantize': 'int8', 'calib': calib}),
                   device='cpu', bundle=_bundle(variables)).evaluate(images)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert _cosines(got, want).min() > 0.9999
    with pytest.raises(ValueError, match='calib'):
        export.save_compiled(tmp_path / 'q2', _bundle(variables),
                             quantize='int8', device='cpu')


def test_int8_gemm_keeps_a_symbolic_batch():
    """Inside torch.export the GEMM's rows are padded without a branch on
    the batch, so one program serves 1 and 5 images (the card's int8
    path; its sums against the float64 plain version, exactly)."""
    rng = np.random.RandomState(3)
    kq = rng.randint(-127, 128, (24, 16, 3, 3)).astype(np.int8)
    w = int8_conv.quantized_entry(kq, np.ones(24, np.float32), 1.0,
                                  np.zeros(24, np.float32), 'cpu')

    class Sums(torch.nn.Module):
        def forward(self, xq):
            return int8_conv.int8_sums(xq, w, 1, 'SAME')

    def batch(n):
        return torch.from_numpy(rng.randint(-127, 128, (n, 3, 3, 16))
                                .astype(np.int8))

    program = torch.export.export(Sums(), (batch(2),), dynamic_shapes={
        'xq': {0: torch.export.Dim('b', min=1, max=64)}})
    for n in (1, 5):
        xq = batch(n)
        assert torch.equal(program.module()(xq),
                           int8_conv.int8_sums_plain(xq, w))


def test_op_histogram_names_convolutions(artifact):
    _, path = artifact
    hist = export.load_compiled(path, device='cpu').op_histogram()
    assert hist.get('conv2d', 0) > 10     # the IRv1 stem alone has 6
    assert 'linear' in hist
    assert list(hist.values()) == sorted(hist.values(), reverse=True)


def test_irv2_artifact_and_unsupported_class(tmp_path):
    from facenet_tpu_torch.models.inception_resnet_v2 import \
        init_variables as init_v2
    config = {'repeat': [1, 1, 1], 'embedding_size': 16}
    bundle = _bundle(init_v2(config), 'InceptionResnetV2', config)
    path = export.save_compiled(tmp_path / 'v2', bundle, device='cpu')
    images = np.random.RandomState(4).randint(0, 256, (2, 160, 160, 3),
                                              np.uint8)
    got = export.load_compiled(path, device='cpu')(images).numpy()
    want = FaceNet(Config({}), device='cpu', bundle=bundle).evaluate(images)
    assert _cosines(got, want).min() > 0.9999
    with pytest.raises(NotImplementedError, match='no fused'):
        export.save_compiled(tmp_path / 'x', _bundle({}, 'Other'),
                             device='cpu')


def test_export_h5_matches_jax(tmp_path):
    """Activations within cosine 0.999 of JAX's (both bf16; measured worst
    0.99998), every weight and statistic and the input exactly."""
    variables = randomized_variables()
    images = np.random.RandomState(5).randint(0, 256, (1, 160, 160, 3),
                                              np.uint8)
    port = export.export_h5(tmp_path / 'port.h5', InceptionResnetV1(TINY),
                            variables, images)
    jax = jax_export.export_h5(tmp_path / 'jax.h5', JaxIRv1(config=TINY),
                               variables, images)
    got = {d['name'] for d in h5utils.visititems(port)}
    want = {d['name'] for d in jax_h5utils.visititems(jax)}
    assert got == want
    acts = sorted(n for n in want if n.startswith('activations/'))
    assert len(acts) == 118
    worst = 1.0
    for name in want:
        a, b = h5utils.read(port, name), jax_h5utils.read(jax, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name.startswith('activations/'):
            a, b = a.reshape(-1).astype(np.float64), b.reshape(-1)
            cos = a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)
            worst = min(worst, cos)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert worst >= 0.999, worst
