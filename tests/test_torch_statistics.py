"""Port FaceToFaceValidation == facenet_tpu's on well-separated embeddings
(atol 1e-6); the port's own KFold and auc == sklearn's; the reference's
public API (`pairwise_similarities`, `SimilarityCalculator`,
``ConfidenceMatrix(calculator, threshold)``) == facenet_tpu's (1e-6)."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import sklearn.metrics
import torch
from sklearn.model_selection import KFold

from facenet_tpu import statistics as jax_statistics
from facenet_tpu.config import Config as JaxConfig
from facenet_tpu_torch import statistics
from facenet_tpu_torch.config import Config
from torch_testing import few_threads  # noqa: F401


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


# The reference's public statistics API, on tests/test_statistics.py's
# clustered set (6 classes x 8, 32-d), against the JAX package: 1e-6.

@pytest.fixture(scope='module')
def clustered():
    from conftest import make_embeddings
    return make_embeddings(np.random.RandomState(0))


@pytest.mark.parametrize('metric', [0, 1])
def test_pairwise_similarities_match_jax(clustered, metric):
    embs, _ = clustered
    condensed = statistics.pairwise_similarities(embs[:10], metric=metric)
    assert condensed.shape == (45,)
    np.testing.assert_allclose(
        condensed, jax_statistics.pairwise_similarities(embs[:10],
                                                        metric=metric),
        atol=1e-6)
    cross = statistics.pairwise_similarities(embs[:5], embs[5:12],
                                             metric=metric)
    assert cross.shape == (5, 7)
    np.testing.assert_allclose(
        cross, jax_statistics.pairwise_similarities(embs[:5], embs[5:12],
                                                    metric=metric),
        atol=1e-6)
    upper = 4 if metric == 0 else np.pi
    assert np.all(condensed >= 0) and np.all(condensed <= upper)


def test_pairwise_similarities_reject_unnormalized_and_bad_metric():
    x = np.full((4, 8), 3.0, dtype=np.float32)
    with pytest.raises(ValueError, match='normalized'):
        statistics.pairwise_similarities(x)
    unit = x / np.linalg.norm(x, axis=1, keepdims=True)
    with pytest.raises(ValueError, match='metric'):
        statistics.pairwise_similarities(unit, metric=7)


def test_similarity_calculator_evaluate_matches_jax(clustered):
    embs, labels = clustered
    got = statistics.SimilarityCalculator(embs, labels, metric=0)
    want = jax_statistics.SimilarityCalculator(embs, labels, metric=0)
    assert got.nrof_classes == want.nrof_classes == 6
    assert [got.nrof_images(i) for i in range(6)] == \
        [want.nrof_images(i) for i in range(6)]
    for i, k in ((0, 0), (3, 3), (1, 0), (5, 2)):
        d_got, w_got = got.evaluate(i, k)
        d_want, w_want = want.evaluate(i, k)
        np.testing.assert_allclose(d_got, d_want, atol=1e-6)
        assert w_got == w_want
    np.testing.assert_allclose(statistics.mean(embs), jax_statistics.mean(embs))
    np.testing.assert_allclose(statistics.std(embs), jax_statistics.std(embs))
    for a, b in zip(statistics.split_embeddings(embs, labels),
                    jax_statistics.split_embeddings(embs, labels)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('metric', [0, 1])
def test_confidence_matrix_from_calculator_matches_jax(clustered, metric):
    """``ConfidenceMatrix(SimilarityCalculator(e, l, metric), thresholds)``,
    the reference's constructor, on the port (the plain B1 on the CPU) and
    on JAX; a calculator holding a tensor counts the same."""
    embs, labels = clustered
    upper = 4 if metric == 0 else np.pi
    thresholds = np.linspace(0, upper, 50)
    want = jax_statistics.ConfidenceMatrix(
        jax_statistics.SimilarityCalculator(embs, labels, metric=metric),
        thresholds)
    for raw in (embs, torch.from_numpy(embs)):
        got = statistics.ConfidenceMatrix(
            statistics.SimilarityCalculator(raw, labels, metric=metric),
            thresholds, device='cpu')
        for attr in ('tp', 'fn', 'fp', 'tn', 'accuracy', 'precision',
                     'tp_rates', 'tn_rates', 'fp_rates', 'fn_rates'):
            np.testing.assert_allclose(getattr(got, attr),
                                       getattr(want, attr), atol=1e-6,
                                       err_msg=attr)
