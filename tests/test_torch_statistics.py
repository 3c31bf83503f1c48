"""Port FaceToFaceValidation == facenet_tpu's on well-separated embeddings
(atol 1e-6); the port's own KFold and auc == sklearn's."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import sklearn.metrics
from sklearn.model_selection import KFold

from facenet_tpu import statistics as jax_statistics
from facenet_tpu.config import Config as JaxConfig
from facenet_tpu_torch import statistics
from facenet_tpu_torch.config import Config


@pytest.fixture(scope='module')
def separated():
    """6 classes x 16 around unit centres: an untrained net's embeddings
    would make every distance a near-tie and the threshold pick knife-edge."""
    rng = np.random.RandomState(1)
    centers = rng.randn(6, 32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    embs = np.repeat(centers, 16, axis=0) + 0.1 * rng.randn(96, 32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    return embs.astype(np.float32), np.repeat(np.arange(6), 16)


@pytest.mark.parametrize('metric', [0, 1])
def test_report_matches_jax(separated, metric):
    embs, labels = separated
    cfg = {'metric': metric, 'nrof_folds': 5, 'far_target': 0.01}
    ref = jax_statistics.FaceToFaceValidation(embs, labels,
                                              JaxConfig(cfg)).dict
    got = statistics.FaceToFaceValidation(embs, labels, Config(cfg),
                                          device='cpu').dict
    assert got.keys() == ref.keys()
    for crit in ref:
        assert got[crit].keys() == ref[crit].keys()
        for key, value in ref[crit].items():
            assert abs(got[crit][key] - value) <= 1e-6, (crit, key)


def test_report_text_and_h5(separated, tmp_path):
    h5py = pytest.importorskip('h5py')
    embs, labels = separated
    report = statistics.FaceToFaceValidation(
        embs, labels, Config({'metric': 0, 'nrof_folds': 3}), device='cpu')
    report.write_report(tmp_path / 'report.txt')
    text = (tmp_path / 'report.txt').read_text()
    assert 'MaximumAccuracy' in text and 'FalseAlarmRate' in text
    report.write_h5file(tmp_path / 'report.h5')
    with h5py.File(tmp_path / 'report.h5', 'r') as hf:
        assert hf['MaximumAccuracy/accuracy'].shape == (1,)


def test_invalid_metric_raises(separated):
    embs, labels = separated
    with pytest.raises(ValueError, match='metric'):
        statistics.FaceToFaceValidation(embs, labels, Config({'metric': 7}),
                                        device='cpu')


@pytest.mark.parametrize('n,k', [(96, 5), (1040, 10), (24, 10), (23, 7),
                                 (10, 10)])
def test_kfold_matches_sklearn(n, k):
    ref = list(KFold(n_splits=k, shuffle=True, random_state=0).split(
        np.arange(n)))
    got = list(statistics.kfold_splits(n, k))
    assert len(got) == len(ref)
    for (tr, te), (rtr, rte) in zip(got, ref):
        np.testing.assert_array_equal(tr, rtr)
        np.testing.assert_array_equal(te, rte)


@pytest.mark.parametrize('direction', [1, -1])
def test_auc_matches_sklearn(direction):
    x = np.sort(np.random.RandomState(0).rand(50))[::direction]
    y = np.sqrt(x)
    assert statistics.auc(x, y) == sklearn.metrics.auc(x, y)


def test_auc_rejects_non_monotonic_x():
    with pytest.raises(ValueError, match='increasing nor decreasing'):
        statistics.auc([0.0, 0.5, 0.2], [0.0, 1.0, 0.5])
