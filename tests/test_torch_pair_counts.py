"""Port pair counts (ops/pair_counts.py) against the Pallas kernel run in
interpret mode, the literal numpy oracle, and edge cases.

The plain version runs here on the CPU; the CUDA kernel is held against it
on the card (`cuda` marker; skipped without a GPU).
"""

import numpy as np
import pytest
import torch

from conftest import make_embeddings
from facenet_tpu.ops.pallas_stats import pair_below_counts as pallas_counts
from facenet_tpu_torch import statistics
from facenet_tpu_torch.ops import pair_counts
from oracle import oracle_confusion
from torch_testing import few_threads  # noqa: F401


@pytest.fixture(scope='module')
def clustered():
    rng = np.random.RandomState(0)
    return make_embeddings(rng, nrof_classes=7, images_per_class=23, dim=48)


def _thresholds(metric):
    hi = 4.0 if metric == 0 else np.pi
    return np.linspace(0, hi, 100)[1:99].astype(np.float32)


@pytest.mark.parametrize('metric', [0, 1])
def test_plain_matches_pallas_interpret(clustered, metric):
    embs, labels = clustered
    thr = _thresholds(metric)
    ref = pallas_counts(embs, labels, thr, metric=metric, interpret=True)
    got = pair_counts.pair_below_counts_plain(torch.from_numpy(embs), labels,
                                              thr, metric=metric)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize('metric', [0, 1])
def test_confusion_counts_match_oracle(clustered, metric):
    """Both sides accumulate the per-pair weights in float64."""
    embs, labels = clustered
    thr = _thresholds(metric)
    ref = oracle_confusion(embs, labels, thr, metric=metric)
    got = statistics.confusion_counts(embs, labels, thr, metric=metric,
                                      device='cpu')
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)


def test_unsorted_thresholds_and_sparse_labels(clustered):
    """confusion_counts sorts thresholds and densifies labels itself."""
    embs, labels = clustered
    thr = _thresholds(0)
    perm = np.random.RandomState(5).permutation(thr.size)
    ref = oracle_confusion(embs, labels, thr[perm], metric=0)
    got = statistics.confusion_counts(embs, labels * 10 + 3, thr[perm],
                                      device='cpu')
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)


def test_edge_sizes():
    """N = 15 and D = 17, neither a multiple of any tile."""
    rng = np.random.RandomState(1)
    embs, labels = make_embeddings(rng, nrof_classes=3, images_per_class=5,
                                   dim=17)
    thr = np.array([0.5, 1.0, 2.0], np.float32)
    bp, bn, tpt, tnt = pair_counts.pair_below_counts_plain(
        torch.from_numpy(embs), labels, thr)
    assert tpt == pytest.approx(3.0, rel=1e-12)    # 3 classes, weight 1 each
    assert tnt == pytest.approx(3.0, rel=1e-12)    # 3 class pairs
    ref = pallas_counts(embs, labels, thr, interpret=True)
    np.testing.assert_allclose(bp, ref[0], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(bn, ref[1], rtol=2e-4, atol=1e-5)


def test_duplicates_at_zero_threshold_need_the_clip():
    """Two copies of a unit vector whose float32 self-product exceeds 1 must
    not count as 'distance < 0' (the t = 0 cutoff is exactly 1.0)."""
    rng = np.random.RandomState(2)
    cand = rng.randn(4096, 64)
    cand = (cand / np.linalg.norm(cand, axis=1, keepdims=True)).astype(
        np.float32)
    t = torch.from_numpy(cand)
    self_dot = (t * t).sum(1)
    over = cand[(self_dot > 1.0).numpy()][:4]
    assert len(over) == 4          # such vectors exist in float32
    embs = np.repeat(over, 2, axis=0)
    labels = np.repeat(np.arange(4), 2)
    e = torch.from_numpy(embs)
    unclipped = (e @ e.T)[torch.arange(0, 8, 2), torch.arange(1, 8, 2)]
    assert bool((unclipped > 1.0).any())    # an unclipped compare would count

    bp, bn, tpt, _ = pair_counts.pair_below_counts_plain(
        e, labels, np.array([0.0, 0.5], np.float32))
    assert bp[0] == 0.0 and bn[0] == 0.0
    assert bp[1] == tpt == 4.0


def test_too_many_thresholds_raises(clustered):
    embs, labels = clustered
    with pytest.raises(ValueError, match='at most 127'):
        pair_counts.pair_below_counts_plain(torch.from_numpy(embs), labels,
                                            np.linspace(0, 4, 200))


def test_unsorted_cutoffs_raise(clustered):
    embs, labels = clustered
    with pytest.raises(ValueError, match='sorted ascending'):
        pair_counts.pair_below_counts_plain(torch.from_numpy(embs), labels,
                                            np.array([1.0, 0.5]))


def test_unnormalized_embeddings_raise(clustered):
    embs, labels = clustered
    with pytest.raises(ValueError, match='normalized'):
        statistics.confusion_counts(embs * 3.0, labels, [1.0], device='cpu')


def test_default_device_without_gpu_raises(clustered):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    embs, labels = clustered
    with pytest.raises(RuntimeError, match='CUDA'):
        statistics.confusion_counts(embs, labels, [1.0])


@pytest.mark.cuda
@pytest.mark.parametrize('metric', [0, 1])
def test_kernel_matches_plain_on_gpu(clustered, metric):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    embs, labels = clustered
    inputs = pair_counts.prepare(torch.from_numpy(embs).cuda(), labels,
                                 _thresholds(metric), metric)
    before = pair_counts.pair_histogram.launches
    kern = pair_counts.pair_histogram(inputs)
    torch.cuda.synchronize()
    assert pair_counts.pair_histogram.launches == before + 1
    plain = pair_counts.pair_histogram_plain(inputs)
    np.testing.assert_allclose(kern.cumsum(1).cpu().numpy(),
                               plain.cumsum(1).cpu().numpy(),
                               rtol=1e-6, atol=1e-12)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def test_split_tf32_parts():
    """hi has TF32's 11 significant bits (the low 13 of a float32 are 0),
    hi + lo restores x to 2^-22 |x|, and lo is no larger than half a unit
    of hi's last place."""
    x = torch.from_numpy(_unit(np.random.RandomState(7), 64, 512))
    hi, lo = pair_counts.split_tf32(x)
    assert int((hi.view(torch.int32) & 0x1fff).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1fff).abs().max()) == 0
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert float((rest / x.double().abs()).max()) <= 2.0 ** -22
    assert float((lo.double().abs() / x.double().abs()).max()) <= 2.0 ** -11
    # rounded to nearest, not truncated: the parts' signs are unrelated
    assert 0.3 < float((torch.sign(lo) == torch.sign(x)).float().mean()) < 0.7


@pytest.mark.parametrize('case', ['D=512', 'D=17', 'duplicates'])
def test_3xtf32_twin_is_float32_accurate(case):
    """The kernel's product arithmetic restated in plain PyTorch (two-part
    split, three float32 products a step) against the float64 product: max
    |s - s64| <= 5e-7, the bound the kernel is held to on the card. One TF32
    product alone misses it a hundredfold."""
    rng = np.random.RandomState(8)
    if case == 'duplicates':
        e = np.repeat(_unit(rng, 64, 512), 2, axis=0)     # s = 1 pairs
    else:
        d = int(case[2:])
        centres = _unit(rng, 8, d)                        # s ~ 0.5 pairs
        e = centres[np.repeat(np.arange(8), 16)] + _unit(rng, 128, d)
        e = (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(np.float32)
    x = torch.from_numpy(e)
    s64 = torch.clamp(x.double() @ x.double().T, -1.0, 1.0)
    before = pair_counts.pair_similarities.launches
    got = pair_counts.pair_similarities(x)          # CPU: the plain twin
    assert pair_counts.pair_similarities.launches == before
    assert got.dtype == torch.float32 and got.shape == s64.shape
    assert float((got.double() - s64).abs().max()) <= 5e-7
    assert float(got.max()) <= 1.0                        # the clip
    hi, _ = pair_counts.split_tf32(x)
    one = (hi.double() @ hi.double().T - s64).abs().max()
    assert float(one) > 5e-5


def test_pair_similarities_raises_on_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match='float32'):
        pair_counts.pair_similarities(torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match='contiguous'):
        pair_counts.pair_similarities(torch.zeros(8, 4).t())
