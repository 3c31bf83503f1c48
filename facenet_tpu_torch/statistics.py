"""Validation statistics: weighted pair confusion counts, ROC summary and
the K-fold face-to-face validation report.

Per threshold t the confusion counts weigh every class pair equally:

  tp(t) = (1/C)      * sum over positive image pairs  w * [d < t]
  fp(t) = (1/P_neg)  * sum over negative image pairs  w * [d < t]

with w = 1/#pairs in that class block, so one pass over the pair matrix
gives all thresholds (`ops.pair_counts`). On a CUDA device that pass is the
hand-written kernel; on the CPU its plain PyTorch version. On a grid (the
`mesh=` argument) whose ranks each hold the full set, every rank makes that
pass itself, with no collective; when each data rank holds only its own
stripe of the rows (``mesh.local_rows``), the rows of the pair matrix split
over the data ranks instead (`parallel.sharded_eval`).

The K-fold protocol: KFold(nrof_folds, shuffle=True, random_state=0); on
each fold's train split pick (a) the max-accuracy threshold and (b) the
threshold whose FAR equals `far_target`; score both on the test split.

The reference's public names are kept: `pairwise_similarities`, `mean`,
`std`, `split_embeddings` and `SimilarityCalculator` in numpy, and
``ConfidenceMatrix(calculator, threshold)``, which counts on the device.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch

from facenet_tpu_torch import h5utils
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.logging import logger
from facenet_tpu_torch.ops.pair_counts import pair_below_counts
from facenet_tpu_torch.parallel.mesh import allgather_host_varlen
from facenet_tpu_torch.parallel.sharded_eval import sharded_pair_histograms


def kfold_splits(n, n_splits, seed=0):
    """(train, test) index arrays of a shuffled K-fold split: the splits of
    ``sklearn.model_selection.KFold(n_splits, shuffle=True,
    random_state=seed)``, both index arrays sorted."""
    if n_splits < 2 or n_splits > n:
        raise ValueError(f'cannot split {n} samples into {n_splits} folds')
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[:n % n_splits] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, dtype=bool)
        test[order[start:start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def auc(x, y):
    """Area under the curve (x, y) by the trapezoidal rule; x must be
    monotonic (either direction), as in ``sklearn.metrics.auc``."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if x.shape[0] < 2:
        raise ValueError('at least 2 points are needed to compute the area '
                         f'under curve, but x.shape = {x.shape[0]}')
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f'x is neither increasing nor decreasing : {x}.')
        direction = -1
    return direction * float((dx * (y[1:] + y[:-1]) / 2.0).sum())


def _cos_to_distance(cos, metric):
    """Clipped cosine similarities as the metric's distance."""
    cos = np.clip(cos, -1.0, 1.0)
    if metric == 0:
        return 2.0 * (1.0 - cos)      # squared Euclidean of unit vectors
    if metric == 1:
        return np.arccos(cos)         # angular distance
    raise ValueError(f'Undefined similarity metric {metric}')


def pairwise_similarities(xa, xb=None, metric=0, atol=1.e-5):
    """Distances between L2-normalized embeddings, in numpy.

    :param xa: [Na, D] L2-normalized embeddings
    :param xb: optional [Nb, D]; omitted: the condensed upper triangle of xa
    :param metric: 0 = squared Euclidean 2(1 - cos); 1 = the angle arccos
    :raises ValueError: a cosine outside [-1 - atol, 1 + atol] (embeddings
        not normalized), or an unknown metric
    """
    xa = np.asarray(xa)
    if xb is None:
        cos = (xa @ xa.T)[np.triu_indices(len(xa), k=1)]
    else:
        cos = xa @ np.asarray(xb).T
    if cos.size and (cos.min() < -(1 + atol) or cos.max() > 1 + atol):
        raise ValueError(
            '\nembeddings must be normalized to 1, range {} {}'.format(
                cos.min(), cos.max()))
    return _cos_to_distance(cos, metric) if cos.size else cos


def mean(x):
    return np.mean(np.asarray(x))


def std(x):
    return np.std(np.asarray(x))


def split_embeddings(embeddings, labels):
    """Per-class list of embedding arrays, ordered by sorted unique label."""
    labels = np.asarray(labels)
    return [embeddings[labels == c] for c in np.unique(labels)]


class SimilarityCalculator:
    """Embeddings, labels and metric for the confusion computations.

    `ConfidenceMatrix` reads `raw`, `labels` and `metric` and counts on the
    device. ``raw`` keeps a tensor as given (so embeddings already on the
    card stay there) and makes anything else a float32 numpy array.
    `evaluate(i, k)` is the reference's per-class-pair probe: the distances
    of block (i, k) and the weight that makes each class pair, not each
    image pair, count equally.
    """

    def __init__(self, embeddings, labels, metric=0):
        self.metric = metric
        self.labels = np.asarray(labels)
        self.raw = (embeddings if isinstance(embeddings, torch.Tensor)
                    else np.ascontiguousarray(embeddings, dtype=np.float32))
        self._per_class = None

    @property
    def embeddings(self):
        """Per-class float32 numpy arrays, in sorted label order."""
        if self._per_class is None:
            raw = self.raw
            if isinstance(raw, torch.Tensor):
                raw = raw.detach().float().cpu().numpy()
            self._per_class = split_embeddings(raw, self.labels)
        return self._per_class

    @property
    def nrof_classes(self):
        return len(np.unique(self.labels))

    def nrof_images(self, i):
        return len(self.embeddings[i])

    def evaluate(self, i, k):
        """Distances and normalization weight of class block (i, k)."""
        c = self.nrof_classes
        if i == k:
            dists = pairwise_similarities(self.embeddings[i],
                                          metric=self.metric)
            nrof_class_pairs = c              # positive blocks: one a class
        else:
            dists = pairwise_similarities(self.embeddings[i],
                                          self.embeddings[k],
                                          metric=self.metric)
            nrof_class_pairs = c * (c - 1) / 2  # unordered negative blocks
        return dists, dists.size * nrof_class_pairs


def confusion_counts(embeddings, labels, thresholds, metric=0, atol=1e-5,
                     device=None, mesh=None):
    """Weighted (tp, fn, fp, tn) per threshold, float64 numpy arrays.

    :param embeddings: [N, D] L2-normalized, numpy or tensor: the rows
        ``mesh.local_rows`` says this rank holds (all of them by default)
    :param labels: [N] class labels (any ints; remapped to a dense range,
        agreed over the data ranks when each holds its own rows)
    :param thresholds: [T] distance thresholds in any order, T <= 127
    :param device: 'cuda' (default; the mesh's device with a mesh) runs
        the kernel; 'cpu' the plain version
    :param mesh: the grid, or None on one rank; with more than one data
        rank each holding its own stripe (``local_rows``) the rows split
        over them (`parallel.sharded_eval`)
    """
    sharded = mesh is not None and mesh.data > 1 and mesh.local_rows
    device = resolve_device(mesh.device if device is None and mesh
                            else device)
    emb = torch.as_tensor(embeddings, dtype=torch.float32).to(device)
    labels = np.asarray(labels)
    if sharded:
        uniq = np.unique(allgather_host_varlen(labels, mesh.data_group))
        dense = np.searchsorted(uniq, labels)
    else:
        uniq, dense = np.unique(labels, return_inverse=True)
    num_classes = len(uniq)

    norms = torch.linalg.vector_norm(emb, dim=1)
    if norms.numel():
        lo, hi = float(norms.min()), float(norms.max())
        if lo < 1 - atol or hi > 1 + atol:
            raise ValueError(
                f'\nembeddings must be normalized to 1, range {lo} {hi}')

    thresholds = np.atleast_1d(np.asarray(thresholds, dtype=np.float32))
    order = np.argsort(thresholds, kind='stable')
    sorted_t = thresholds[order]

    if sharded:
        hist_pos, hist_neg = sharded_pair_histograms(
            emb, dense.reshape(-1), sorted_t, num_classes, int(metric), mesh)
        below_pos = np.cumsum(hist_pos)[:-1]
        below_neg = np.cumsum(hist_neg)[:-1]
        total_pos, total_neg = hist_pos.sum(), hist_neg.sum()
    else:
        below_pos, below_neg, total_pos, total_neg = pair_below_counts(
            emb, dense.reshape(-1), sorted_t, metric=int(metric),
            num_classes=num_classes)

    nrof_neg_class_pairs = num_classes * (num_classes - 1) / 2
    tp_s = below_pos / num_classes
    fn_s = (total_pos - below_pos) / num_classes
    if nrof_neg_class_pairs > 0:
        fp_s = below_neg / nrof_neg_class_pairs
        tn_s = (total_neg - below_neg) / nrof_neg_class_pairs
    else:
        fp_s = np.zeros_like(below_neg)
        tn_s = np.zeros_like(below_neg)

    # undo the sort
    tp = np.empty_like(tp_s); tp[order] = tp_s
    fn = np.empty_like(fn_s); fn[order] = fn_s
    fp = np.empty_like(fp_s); fp[order] = fp_s
    tn = np.empty_like(tn_s); tn[order] = tn_s
    return tp, fn, fp, tn


class ConfidenceMatrix:
    """Confusion matrix (tp, tn, fp, fn) over thresholds.

    The reference's contract: a `SimilarityCalculator` and a threshold
    array; the counts come from `confusion_counts` on `device` (None: the
    card, where B1 counts them).
    """

    def __init__(self, calculator, threshold, device=None):
        self.threshold = np.array(threshold, ndmin=1)
        self.tp, self.fn, self.fp, self.tn = confusion_counts(
            calculator.raw, calculator.labels, self.threshold,
            metric=calculator.metric, device=device)

    def _ratio(self, num, denom):
        """num / denom per threshold; 1.0 where the denominator is empty
        (an undefined rate counts as perfect)."""
        out = np.ones(self.threshold.size)
        defined = denom > 0
        out[defined] = num[defined] / denom[defined]
        return out

    @property
    def accuracy(self):
        return (self.tp + self.tn) / (self.tp + self.fp + self.tn + self.fn)

    @property
    def precision(self):
        return self._ratio(self.tp, self.tp + self.fp)

    @property
    def tp_rates(self):
        return self._ratio(self.tp, self.tp + self.fn)

    @property
    def tn_rates(self):
        return self._ratio(self.tn, self.tn + self.fp)

    @property
    def fp_rates(self):
        return 1 - self.tn_rates

    @property
    def fn_rates(self):
        return 1 - self.tp_rates


def roc_summary(fp_rates, tp_rates):
    """AUC and EER of a ROC curve given as per-threshold rate arrays.

    Failures are logged and reported as -1: a validation report must never
    crash a training run.
    """
    from scipy import interpolate
    from scipy.optimize import brentq

    try:
        area = auc(fp_rates, tp_rates)
    except (ValueError, RuntimeError) as exc:
        logger.warning(f'AUC computation failed: {exc}')
        area = -1.0

    try:
        roc = interpolate.interp1d(fp_rates, tp_rates)
        eer = float(brentq(lambda x: 1.0 - x - roc(x), 0.0, 1.0))
    except (ValueError, RuntimeError) as exc:
        logger.warning(f'EER computation failed: {exc}')
        eer = -1.0

    return area, eer


class Report:
    """Cross-fold summary for one threshold-selection criterion.

    Collects train-fold matrices (full threshold sweep, used for the ROC
    summary) and test-fold matrices (single chosen threshold, used for the
    mean +- std rows).
    """

    # (report label, ConfidenceMatrix attribute) for the mean+-std rows
    FIELDS = (
        ('Accuracy: ', 'accuracy'),
        ('Precision:', 'precision'),
        ('Sensitivity (TPR, 1-a type 1 error):', 'tp_rates'),
        ('Specificity (TNR, 1-b type 2 error):', 'tn_rates'),
        ('Threshold:', 'threshold'),
    )

    def __init__(self, criterion=None):
        self.criterion = criterion
        self.conf_matrix_train = []
        self.conf_matrix_test = []

    def append_fold(self, name, conf_matrix):
        folds = (self.conf_matrix_train if name == 'train'
                 else self.conf_matrix_test)
        folds.append(conf_matrix)

    @property
    def dict(self):
        summary = {}

        tpr = np.mean([m.tp_rates for m in self.conf_matrix_train], axis=0)
        fpr = 1 - np.mean([m.tn_rates for m in self.conf_matrix_train],
                          axis=0)
        summary['auc'], summary['eer'] = roc_summary(fpr, tpr)

        for _, attr in self.FIELDS:
            values = [getattr(m, attr) for m in self.conf_matrix_test]
            summary[attr] = float(np.mean(values))
            summary[attr + '_std'] = float(np.std(values))

        return summary

    def __repr__(self):
        s = self.dict
        lines = [str(self.criterion),
                 'Area under curve (AUC): {:1.5f}'.format(s['auc']),
                 'Equal error rate (EER): {:1.5f}'.format(s['eer']),
                 '']
        lines += ['{} {:2.5f}+-{:2.5f}'.format(label, s[attr],
                                               s[attr + '_std'])
                  for label, attr in self.FIELDS]
        return '\n'.join(lines) + '\n\n'


class FaceToFaceValidation:
    """K-fold face-to-face validation.

    KFold(nrof_folds, shuffle=True, random_state=0); on each fold's train
    split pick (a) the max-accuracy threshold and (b) the threshold whose
    FAR equals `far_target` (linear interpolation); score both on the test
    split; report across folds. The embeddings move to `device` once.
    On a grid every rank holds the full set and validates it alone.
    """

    # threshold grid upper bound per metric: squared Euclidean of unit
    # vectors maxes at 4, angles at pi
    THRESHOLD_RANGE = {0: 4.0, 1: np.pi}
    NROF_THRESHOLDS = 100

    def __init__(self, embeddings, labels, config, device=None):
        started = time.monotonic()
        self.device = resolve_device(device)
        self.embeddings = torch.as_tensor(
            embeddings, dtype=torch.float32).to(self.device)
        self.labels = np.asarray(labels)
        if len(self.embeddings) != len(self.labels):
            raise ValueError(f'{len(self.embeddings)} embeddings but '
                             f'{len(self.labels)} labels')
        self.config = config

        self.metric = int(config.metric or 0)
        if self.metric not in self.THRESHOLD_RANGE:
            raise ValueError(f'Undefined similarity metric {config.metric}')
        self.thresholds = np.linspace(0, self.THRESHOLD_RANGE[self.metric],
                                      self.NROF_THRESHOLDS)

        far_target = float(config.far_target or 1e-3)
        self.reports = (Report(criterion='MaximumAccuracy'),
                        Report(criterion=f'FalseAlarmRate(FAR = {far_target})'))
        self._run_folds(int(config.nrof_folds or 10), far_target)

        self.elapsed_time = time.monotonic() - started
        logger.info(str(self))

    def _matrix(self, subset, thresholds):
        index = torch.from_numpy(subset).to(self.device)
        calculator = SimilarityCalculator(self.embeddings[index],
                                          self.labels[subset], self.metric)
        return ConfidenceMatrix(calculator, thresholds, device=self.device)

    def _far_threshold(self, matrix, far_target):
        """Threshold whose train-fold FAR hits far_target, 0 if unreachable
        (np.interp over the non-decreasing fp_rate curve)."""
        if np.max(matrix.fp_rates) < far_target:
            return 0.0
        return float(np.interp(far_target, matrix.fp_rates, self.thresholds))

    def _run_folds(self, nrof_folds, far_target):
        """Per fold: sweep all thresholds on the train split, pick one per
        criterion, then score exactly that threshold on the held-out split."""
        for train_set, test_set in kfold_splits(len(self.labels), nrof_folds):
            sweep = self._matrix(train_set, self.thresholds)

            chosen = (self.thresholds[np.argmax(sweep.accuracy)],
                      self._far_threshold(sweep, far_target))
            for report, threshold in zip(self.reports, chosen):
                report.append_fold('train', sweep)
                report.append_fold('test', self._matrix(test_set, threshold))

    @property
    def dict(self):
        return {r.criterion: r.dict for r in self.reports}

    def __repr__(self):
        body = ''.join(str(r) for r in self.reports)
        return (f'{type(self).__name__}\nmetric: {self.metric}\n\n'
                f'{body}elapsed_time: {self.elapsed_time}\n')

    def write_report(self, file):
        from facenet_tpu_torch import ioutils
        stamp = f'{type(self).__name__} {datetime.datetime.now()}'
        body = ''.join(str(r) for r in self.reports)
        ioutils.write_text_log(
            file, f'{stamp}\nmetric: {self.metric}\n\n{body}')

    def write_h5file(self, h5file, tag=None):
        h5utils.write_dict(h5file, self.dict, group=tag)
