"""The port's reference-format (folded-BN h5) weight import == the JAX
package's (`facenet_tpu.models.import_weights`).

From the same TINY tree with non-trivial BatchNorm statistics and biases
(numpy, made by the port), the port's `export_ref_h5` writes the dataset
names and values JAX's writes, exactly; the port's `import_h5_weights`
returns JAX's tree exactly from either file. As JAX's own tests do: the
imported tree serves the same embeddings (fused parameters within 1e-5,
the float32 module at cosine > 0.999), completeness is enforced both
ways, the full model's scopes are the upstream tf-slim set, and a real
export_h5 layout (checkpoint groups beside the weights) imports cleanly.
"""

from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from facenet_tpu import h5utils as jax_h5utils
from facenet_tpu.models import import_weights as jax_iw
from facenet_tpu_torch import h5utils
from facenet_tpu_torch.models import import_weights as iw
from facenet_tpu_torch.models.inception_resnet_v1 import (InceptionResnetV1,
                                                           init_variables)
from facenet_tpu_torch.models.irv1_fast import build_fast_params
from torch_testing import TINY, few_threads, randomized_variables  # noqa: F401

FIXTURE = Path(__file__).parent / 'fixtures' / 'irv1_tfslim_scopes.txt'


def _datasets(h5file):
    return {d['name']: h5utils.read(h5file, d['name'])
            for d in h5utils.visititems(h5file)}


def _assert_trees_equal(got, want, path=''):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _assert_trees_equal(got[key], want[key], f'{path}/{key}')
        return
    assert np.asarray(got).dtype == np.asarray(want).dtype, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_h5_files_and_imports_equal_jax(tmp_path):
    variables = randomized_variables()
    port_h5 = iw.export_ref_h5(variables, tmp_path / 'port.h5')
    jax_h5 = jax_iw.export_ref_h5(variables, tmp_path / 'jax.h5')
    got, want = _datasets(port_h5), _datasets(jax_h5)
    assert sorted(got) == sorted(want)
    assert len(got) == 2 * len(list(iw.iter_units(variables['params'])))
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)

    imported = iw.import_h5_weights(port_h5, config=TINY)
    _assert_trees_equal(imported, jax_iw.import_h5_weights(jax_h5,
                                                           config=TINY))
    _assert_trees_equal(iw.import_h5_weights(jax_h5, config=TINY), imported)

    # the same serving form and the same embeddings as the originals
    p0, _ = build_fast_params(variables, TINY, torch.float32, 'cpu')
    p1, _ = build_fast_params(imported, TINY, torch.float32, 'cpu')

    def compare(a, b, path=''):
        if isinstance(a, dict):
            for key in a:
                compare(a[key], b[key], f'{path}/{key}')
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=path)

    compare(p0, p1)
    images = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (4, 160, 160, 3), dtype=np.uint8))
    with torch.no_grad():
        e0 = InceptionResnetV1(TINY).from_flax_variables(variables)(images)
        e1 = InceptionResnetV1(TINY).from_flax_variables(imported)(images)
    cos = (e0 * e1).sum(dim=1)
    assert cos.min() > 0.999, cos


def test_import_is_complete_both_ways(tmp_path):
    variables = randomized_variables(seed=3)
    kinds = {k for _, k, _ in iw.iter_units(variables['params'])}
    assert kinds == {'conv_bn', 'conv', 'dense_bn'}

    h5 = iw.export_ref_h5(variables, tmp_path / 'ref.h5')
    with h5py.File(h5, 'a') as hf:
        del hf['InceptionResnetV1/Conv2d_1a_3x3/weights']
    with pytest.raises(KeyError, match='Conv2d_1a_3x3'):
        iw.import_h5_weights(h5, config=TINY)

    h5b = iw.export_ref_h5(variables, tmp_path / 'ref2.h5')
    with h5py.File(h5b, 'a') as hf:
        hf.create_dataset('InceptionResnetV1/NoSuchLayer/weights',
                          data=np.zeros((1, 1, 3, 3), np.float32))
        hf.create_dataset('InceptionResnetV1/NoSuchLayer/biases',
                          data=np.zeros((3,), np.float32))
    with pytest.raises(KeyError, match='NoSuchLayer'):
        iw.import_h5_weights(h5b, config=TINY)


def test_full_model_scope_set_matches_tfslim_fixture():
    expected = [line.strip() for line in FIXTURE.read_text().splitlines()
                if line.strip() and not line.startswith('#')]
    assert len(expected) == 133
    got = sorted(s for s, _, _ in iw.iter_units(init_variables()['params']))
    assert got == sorted(expected)


def test_import_tolerates_real_export_h5_layout(tmp_path):
    variables = randomized_variables()
    clean = iw.export_ref_h5(variables, tmp_path / 'clean.h5')
    real = iw.export_ref_h5(variables, tmp_path / 'real_layout.h5')
    h5utils.write(real, 'checkpoint/input:0',
                  np.zeros((5, 160, 160, 3), np.uint8))
    h5utils.write(real, 'checkpoint/embeddings:0', np.zeros((5, 32)))
    h5utils.write(real, 'checkpoint/image_size:0',
                  np.array([160, 160], np.uint8))
    for scope in ('InceptionResnetV1/Conv2d_1a_3x3',
                  'InceptionResnetV1/Repeat/block35_1/Branch_0/Conv2d_1x1',
                  'InceptionResnetV1/Bottleneck'):
        h5utils.write(real, f'{scope}/checkpoint/input', np.zeros((2, 3)))
        h5utils.write(real, f'{scope}/checkpoint/output', np.zeros((2, 3)))

    got = iw.import_h5_weights(real, TINY)
    _assert_trees_equal(got, iw.import_h5_weights(clean, TINY))
    _assert_trees_equal(got, jax_iw.import_h5_weights(real, TINY))


def test_units_in_memory_equal_the_file(tmp_path):
    """`reference_units` / `import_units` (the form without h5py) are the
    file's content and import."""
    variables = randomized_variables()
    units = iw.reference_units(variables)
    h5 = iw.export_ref_h5(variables, tmp_path / 'ref.h5')
    for scope, (w, b) in units.items():
        np.testing.assert_array_equal(
            w, jax_h5utils.read(h5, f'InceptionResnetV1/{scope}/weights'))
        np.testing.assert_array_equal(
            b, jax_h5utils.read(h5, f'InceptionResnetV1/{scope}/biases'))
    _assert_trees_equal(iw.import_units(units, TINY),
                        iw.import_h5_weights(h5, TINY))
