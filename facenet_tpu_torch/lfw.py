"""The standard LFW fixed-pairs validation protocol ("validate on LFW").

  * ``pairs.txt`` parsing: header ``<folds> <pairs-per-fold-per-kind>``,
    then 3-field lines (same identity: name idx1 idx2) and 4-field lines
    (different: name1 idx1 name2 idx2), grouped in fold order.
  * path resolution ``<dir>/<name>/<name>_%04d.<ext>``, with pairs whose
    image is missing skipped and counted (LFW ships a few known-bad pairs).
  * 10-fold cross-validation over the CONSECUTIVE pair blocks (the pair
    file's order is the protocol): per fold, sweep thresholds on the
    train blocks, pick (a) the max-accuracy threshold and (b) the
    threshold whose FAR hits ``far_target``, then score exactly those on
    the held-out block. The report has accuracy mean+-std, VAL@FAR
    mean+-std, and the AUC and EER of the across-fold mean ROC.
  * optional per-fold train-mean subtraction (``subtract_mean``) and
    flip-concatenated embeddings (the app's ``validate.flip``).

Distances follow `statistics.py`: metric 0 = squared Euclidean (2(1-cos)
for unit vectors, range [0,4]), metric 1 = arccos angle (range [0,pi]).
Pair distances are computed from the embedding difference, so non-unit
embeddings (flip-concat, subtract_mean, raw model outputs) need no
renormalization.

It runs in float64 numpy on the host, as the JAX package's does: 6,000
pair distances over a few thousand thresholds are no device work. The
expensive stage is the embedding extraction (`apps/validate_on_lfw.py`).
"""

from __future__ import annotations

import datetime
import time
from pathlib import Path

import numpy as np

from facenet_tpu_torch import h5utils
from facenet_tpu_torch.logging import logger
from facenet_tpu_torch.statistics import roc_summary


def read_pairs(pairs_filename):
    """Parse an LFW-format pairs file into a list of 3/4-field tuples.

    Lines with three fields denote same-identity pairs
    ``(name, idx1, idx2)``; four fields denote different-identity pairs
    ``(name1, idx1, name2, idx2)``. The one-line header (fold count and
    pairs per fold per kind) is validated against the body when present.
    """
    pairs = []
    header = None
    seen_content = False
    with open(pairs_filename) as f:
        for line_no, line in enumerate(f):
            fields = line.strip().split()
            if not fields:
                continue
            if (not seen_content and len(fields) <= 2
                    and fields[0].isdigit()):
                # the header is the first NON-EMPTY line
                header = tuple(int(x) for x in fields)
                seen_content = True
                continue
            seen_content = True
            if len(fields) not in (3, 4):
                raise ValueError(
                    f'{pairs_filename}: line {line_no + 1} has '
                    f'{len(fields)} fields, expected 3 or 4: {line!r}')
            pairs.append(tuple(fields))
    if header is not None and len(header) == 2:
        expected = header[0] * header[1] * 2
        if expected != len(pairs):
            raise ValueError(
                f'{pairs_filename}: header promises {header[0]} folds x '
                f'2 x {header[1]} pairs = {expected}, found {len(pairs)}')
    return pairs


def _resolve(lfw_dir, name, index, file_ext):
    """Path of image `index` of identity `name`, trying known extensions."""
    stem = Path(lfw_dir) / name / f'{name}_{int(index):04d}'
    exts = (file_ext,) if file_ext else ('png', 'jpg', 'jpeg')
    for ext in exts:
        path = stem.with_suffix('.' + str(ext).lstrip('.'))
        if path.exists():
            return path
    return None


def get_paths(lfw_dir, pairs, file_ext=None):
    """Resolve pair tuples to image paths.

    :param lfw_dir: directory of per-identity subdirectories
    :param pairs: output of `read_pairs`
    :param file_ext: image extension; None tries png, then jpg/jpeg
    :return: (paths [2 per kept pair], issame bool array, nrof_skipped)
        — pairs with a missing image are skipped and counted, as in the
        upstream flow (LFW has known-bad entries).
    """
    paths, issame = [], []
    nrof_skipped = 0
    for pair in pairs:
        if len(pair) == 3:
            path0 = _resolve(lfw_dir, pair[0], pair[1], file_ext)
            path1 = _resolve(lfw_dir, pair[0], pair[2], file_ext)
            same = True
        else:
            path0 = _resolve(lfw_dir, pair[0], pair[1], file_ext)
            path1 = _resolve(lfw_dir, pair[2], pair[3], file_ext)
            same = False
        if path0 is None or path1 is None:
            nrof_skipped += 1
            continue
        paths += [str(path0), str(path1)]
        issame.append(same)
    if nrof_skipped:
        logger.warning(f'{nrof_skipped} image pairs skipped (missing files)')
    return paths, np.asarray(issame, dtype=bool), nrof_skipped


def generate_pairs(image_dir, nrof_folds=10, nrof_pairs=300, seed=0,
                   output=None):
    """Write an LFW-format pairs file for any class-directory dataset.

    Follows the official View-2 structure: identities are split into
    `nrof_folds` DISJOINT groups; each fold contributes `nrof_pairs`
    same-identity pairs and `nrof_pairs` different-identity pairs drawn
    only from its own identity group (so train/test folds never share an
    identity). Image indices are parsed from the actual `<name>_<idx>.*`
    filenames (LFW's are 1-based, other datasets may be 0-based or have
    gaps), so every emitted pair resolves via `get_paths`. The draws use
    one `RandomState(seed)` in the JAX package's order, so a seed gives
    the same file there and here.

    :return: the pair tuples (also written to `output` when given)
    """
    import re

    rng = np.random.RandomState(seed)
    root = Path(image_dir)
    classes = {}
    for d in sorted(p for p in root.iterdir() if p.is_dir()):
        pattern = re.compile(re.escape(d.name) + r'_(\d+)$')
        indices = sorted(int(m.group(1)) for f in d.iterdir()
                         if f.is_file() and (m := pattern.match(f.stem)))
        if indices:
            classes[d.name] = indices
    names = list(classes)
    if len(names) < 2 * nrof_folds:
        raise ValueError(
            f'{len(names)} identities cannot fill {nrof_folds} '
            f'identity-disjoint folds (need >= 2 per fold)')
    order = rng.permutation(len(names))
    groups = np.array_split(order, nrof_folds)

    pairs = []
    for group in groups:
        group_names = [names[i] for i in group]
        multi = [n for n in group_names if len(classes[n]) >= 2]
        if not multi:
            raise ValueError('a fold has no identity with >= 2 images')

        def pick(name):
            return classes[name][rng.randint(len(classes[name]))]

        # View-2 pairs are unique (duplicates skew fold statistics):
        # sample into a set and fail if the group cannot supply enough
        # DISTINCT pairs
        max_tries = 100 * nrof_pairs

        same, seen = [], set()
        tries = 0
        while len(same) < nrof_pairs:
            tries += 1
            if tries > max_tries:
                raise ValueError(
                    f'cannot draw {nrof_pairs} distinct same-identity '
                    f'pairs from a fold group of {len(multi)} multi-image '
                    'identities')
            name = multi[rng.randint(len(multi))]
            i, k = rng.choice(classes[name], size=2, replace=False)
            pair = (name, str(min(i, k)), str(max(i, k)))
            if pair not in seen:
                seen.add(pair)
                same.append(pair)
        diff, seen = [], set()
        tries = 0
        while len(diff) < nrof_pairs:
            tries += 1
            if tries > max_tries:
                raise ValueError(
                    f'cannot draw {nrof_pairs} distinct different-identity '
                    f'pairs from a fold group of {len(group_names)} '
                    'identities')
            a, b = rng.choice(len(group_names), size=2, replace=False)
            a, b = sorted((group_names[a], group_names[b]))
            pair = (a, str(pick(a)), b, str(pick(b)))
            if pair not in seen:
                seen.add(pair)
                diff.append(pair)
        pairs += same + diff

    if output is not None:
        lines = [f'{nrof_folds}\t{nrof_pairs}']
        lines += ['\t'.join(p) for p in pairs]
        Path(output).write_text('\n'.join(lines) + '\n')
    return pairs


def pair_distances(emb1, emb2, metric=0):
    """Per-pair distances between aligned embedding rows.

    metric 0: squared Euclidean (for unit vectors == the statistics
    module's 2(1-cos)); metric 1: arccos of the cosine (normalizes
    internally, so non-unit embeddings are fine).
    """
    emb1 = np.asarray(emb1, dtype=np.float64)
    emb2 = np.asarray(emb2, dtype=np.float64)
    if metric == 0:
        diff = emb1 - emb2
        return np.einsum('nd,nd->n', diff, diff)
    if metric == 1:
        dot = np.einsum('nd,nd->n', emb1, emb2)
        norm = (np.linalg.norm(emb1, axis=1) *
                np.linalg.norm(emb2, axis=1))
        return np.arccos(np.clip(dot / np.maximum(norm, 1e-30), -1.0, 1.0))
    raise ValueError(f'Undefined similarity metric {metric}')


def _fold_blocks(n, nrof_folds):
    """Consecutive index blocks — the official LFW fold structure."""
    return np.array_split(np.arange(n), nrof_folds)


class LfwValidation:
    """Fixed-pairs K-fold validation report (the validate-on-LFW protocol).

    Same construction style as `statistics.FaceToFaceValidation`: build it
    and the protocol runs; `repr` is the text report, `write_report` /
    `write_h5file` persist it.

    :param embeddings: [2N, D] — rows 2i and 2i+1 are pair i
    :param issame: [N] bool ground truth
    :param config: Config with optional `nrof_folds` (10), `metric` (0),
        `far_target` (1e-3), `subtract_mean` (False)
    """

    THRESHOLD_RANGE = {0: 4.0, 1: np.pi}
    NROF_THRESHOLDS = 400
    # The FAR-targeted threshold search uses a 10x denser grid (0.001
    # steps over [0, 4] -> 4000 points), so low-FAR targets interpolate on
    # a curve of the resolution the published protocol uses.
    NROF_FAR_THRESHOLDS = 4000

    def __init__(self, embeddings, issame, config=None):
        started = time.monotonic()
        embeddings = np.asarray(embeddings)
        self.issame = np.asarray(issame, dtype=bool)
        if len(embeddings) != 2 * len(self.issame):
            raise ValueError(
                f'{len(embeddings)} embeddings cannot form '
                f'{len(self.issame)} pairs (need exactly 2 per pair)')
        self.emb1 = embeddings[0::2]
        self.emb2 = embeddings[1::2]

        from facenet_tpu_torch.config import value_or

        def get(key, default):
            if isinstance(config, dict):
                return value_or(config.get(key), default)
            return value_or(getattr(config, key, None), default)

        self.nrof_folds = int(get('nrof_folds', 10))
        self.metric = int(get('metric', 0))
        self.far_target = float(get('far_target', 1e-3))
        self.subtract_mean = bool(get('subtract_mean', False))
        if self.metric not in self.THRESHOLD_RANGE:
            raise ValueError(f'Undefined similarity metric {self.metric}')
        # Threshold grids cover [0, range] at the protocol's step, but
        # non-unit embeddings (flip-concat doubles norm^2 to 2, so
        # metric-0 distances reach 8; `normalization: false` models are
        # unbounded) overflow the fixed range and would truncate the ROC.
        # Extend the grid at the SAME step to cover the observed
        # distances; for unit embeddings this is exactly the 0..4 grid.
        base_range = self.THRESHOLD_RANGE[self.metric]
        top = base_range
        if self.metric == 0 and len(embeddings):
            # this probe IS the uncentered metric-0 distance set — seed
            # _distances' cache so the default config never computes the
            # full pair-distance array twice
            probe = pair_distances(self.emb1, self.emb2, 0)
            if not self.subtract_mean:
                self._dist_cache = probe
            observed = float(np.max(probe))
            # unit embeddings never exceed 4 (up to float noise)
            if observed > base_range * (1 + 1e-9):
                top = observed * 1.05
        self.thresholds = self._grid(top, base_range, self.NROF_THRESHOLDS)
        self.far_thresholds = self._grid(top, base_range,
                                         self.NROF_FAR_THRESHOLDS)

        self._run_folds()
        self.elapsed_time = time.monotonic() - started
        logger.info(str(self))

    @staticmethod
    def _grid(top, base_range, n_base):
        """[0, top] at the step of an n_base-point grid over base_range —
        identical to linspace(0, base_range, n_base) when top == base_range
        (pair emb1/emb2 rows already split when this runs)."""
        step = base_range / (n_base - 1)
        n = int(np.ceil(top / step)) + 1
        return np.arange(n) * step

    # -- protocol ----------------------------------------------------------

    def _distances(self, train_idx):
        """All-pair distances, optionally centered on the train fold."""
        if not self.subtract_mean:
            if not hasattr(self, '_dist_cache'):
                self._dist_cache = pair_distances(self.emb1, self.emb2,
                                                  self.metric)
            return self._dist_cache
        mean = np.mean(np.concatenate([self.emb1[train_idx],
                                       self.emb2[train_idx]]), axis=0)
        return pair_distances(self.emb1 - mean, self.emb2 - mean,
                              self.metric)

    def _rates(self, dist, issame):
        """(tpr, fpr, accuracy) arrays over the threshold grid.

        Accuracy uses the UNCLAMPED counts — correct / total — so a fold
        of only-same or only-diff pairs scores exactly as upstream does;
        the max(..., 1) clamps guard only the tpr/fpr denominators.
        """
        below = dist[:, None] < self.thresholds[None, :]
        npos = int(np.count_nonzero(issame))
        nneg = len(dist) - npos
        tp = np.count_nonzero(below[issame], axis=0)
        fp = np.count_nonzero(below[~issame], axis=0)
        tpr = tp / max(npos, 1)
        fpr = fp / max(nneg, 1)
        accuracy = (tp + (nneg - fp)) / max(len(dist), 1)
        return tpr, fpr, accuracy

    def _far_curve(self, dist, issame):
        """FAR over the DENSE threshold grid (FAR-threshold search)."""
        neg = dist[~issame]
        nneg = max(len(neg), 1)
        below = neg[:, None] < self.far_thresholds[None, :]
        return np.count_nonzero(below, axis=0) / nneg

    def _run_folds(self):
        n = len(self.issame)
        if n < self.nrof_folds:
            raise ValueError(f'{n} pairs cannot form {self.nrof_folds} folds')
        self.fold_accuracy = np.zeros(self.nrof_folds)
        self.fold_val = np.zeros(self.nrof_folds)
        self.fold_far = np.zeros(self.nrof_folds)
        self.fold_thresholds = np.zeros(self.nrof_folds)
        tprs, fprs = [], []

        blocks = _fold_blocks(n, self.nrof_folds)
        everything = np.arange(n)
        for fold, test_idx in enumerate(blocks):
            train_idx = np.setdiff1d(everything, test_idx)
            dist = self._distances(train_idx)

            tpr_tr, fpr_tr, acc_tr = self._rates(dist[train_idx],
                                                 self.issame[train_idx])
            tpr_te, fpr_te, acc_te = self._rates(dist[test_idx],
                                                 self.issame[test_idx])
            tprs.append(tpr_te)
            fprs.append(fpr_te)

            best = int(np.argmax(acc_tr))
            self.fold_thresholds[fold] = self.thresholds[best]
            self.fold_accuracy[fold] = acc_te[best]

            # FAR-targeted threshold: interpolate the train-fold FAR curve
            # (non-decreasing in the threshold) on the DENSE grid, 0 if
            # the target is unreachable (FaceToFaceValidation's
            # convention).
            far_tr = self._far_curve(dist[train_idx], self.issame[train_idx])
            if np.max(far_tr) >= self.far_target:
                t_far = float(np.interp(self.far_target, far_tr,
                                        self.far_thresholds))
            else:
                t_far = 0.0
            test_same = self.issame[test_idx]
            below = dist[test_idx] < t_far
            npos = max(int(np.count_nonzero(test_same)), 1)
            nneg = max(int(np.count_nonzero(~test_same)), 1)
            self.fold_val[fold] = np.count_nonzero(below[test_same]) / npos
            self.fold_far[fold] = np.count_nonzero(below[~test_same]) / nneg

        # across-fold mean ROC on the held-out folds -> AUC / EER
        self.tpr = np.mean(tprs, axis=0)
        self.fpr = np.mean(fprs, axis=0)
        self.auc, self.eer = roc_summary(self.fpr, self.tpr)

    # -- reporting ----------------------------------------------------------

    @property
    def accuracy(self):
        return float(np.mean(self.fold_accuracy))

    @property
    def accuracy_std(self):
        return float(np.std(self.fold_accuracy))

    @property
    def dict(self):
        return {
            'accuracy': self.accuracy,
            'accuracy_std': self.accuracy_std,
            'val': float(np.mean(self.fold_val)),
            'val_std': float(np.std(self.fold_val)),
            'far': float(np.mean(self.fold_far)),
            'far_target': self.far_target,
            'threshold': float(np.mean(self.fold_thresholds)),
            'threshold_std': float(np.std(self.fold_thresholds)),
            'auc': self.auc,
            'eer': self.eer,
            'nrof_pairs': int(len(self.issame)),
            'nrof_folds': self.nrof_folds,
            'metric': self.metric,
            'subtract_mean': self.subtract_mean,
        }

    def __repr__(self):
        s = self.dict
        return (f'{type(self).__name__}\n'
                f'metric: {self.metric}\n'
                f'pairs: {s["nrof_pairs"]} '
                f'({int(np.count_nonzero(self.issame))} same), '
                f'folds: {self.nrof_folds}, '
                f'subtract_mean: {self.subtract_mean}\n\n'
                f'Accuracy: {s["accuracy"]:2.5f}+-{s["accuracy_std"]:2.5f}\n'
                f'Validation rate: {s["val"]:2.5f}+-{s["val_std"]:2.5f} '
                f'@ FAR={s["far"]:2.5f} (target {s["far_target"]:g})\n'
                f'Threshold: {s["threshold"]:2.5f}+-{s["threshold_std"]:2.5f}\n'
                f'Area under curve (AUC): {s["auc"]:1.5f}\n'
                f'Equal error rate (EER): {s["eer"]:1.5f}\n\n'
                f'elapsed_time: {self.elapsed_time}\n')

    def write_report(self, file):
        from facenet_tpu_torch import ioutils
        stamp = f'{type(self).__name__} {datetime.datetime.now()}'
        ioutils.write_text_log(file, f'{stamp}\n{self}')

    def write_h5file(self, h5file, tag=None):
        h5utils.write_dict(h5file, self.dict, group=tag)
