"""All-pairs evaluation with the rows of the pair matrix split over the
grid's data ranks, each rank holding its own stripe of the rows.

The JAX package's ``facenet_tpu/parallel/sharded_eval.py`` shards the rows
of the [N, N] pair matrix over the mesh's 'data' axis: each device takes its
row stripe, gathers the full column set, bins its stripe's pairs into the
two weighted below-threshold histograms and one psum adds them up. Here
each data rank does the same with torch.distributed: its stripe (padded
with label -1 to the agreed stripe size), an all_gather of every rank's
stripe and labels, the class weights from the gathered labels, the
histograms of its rows in chunks of 512 with the rows' global index
(data_index x rows_per_rank + row) keeping each unordered pair in the strict
upper triangle once across ranks, the per-chunk partials summed once, and
an all_reduce of the two histograms. (A rank that holds the full set counts
every pair itself with the kernel instead: `statistics.confusion_counts`.)

The product is float32 at full precision (TF32 off), as JAX's
``Precision.HIGHEST``; the per-pair weights are float32 as JAX's, and the
histograms add them in float64. This path runs plain torch on the card:
JAX computes it with XLA outside Pallas, so no kernel replaces it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from facenet_tpu_torch.parallel.mesh import (comm_device, gather_values,
                                             reduce_values)

_ROW_CHUNK = 512


@contextlib.contextmanager
def full_precision_matmul():
    """float32 products without TF32 on the card (no effect on the CPU)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def row_stripe_histograms(emb_rows, emb_all, labels_rows, labels_all,
                          row_offset, num_classes, thresholds, metric):
    """Weighted pair histograms [2, T + 1] (float64) of one row stripe
    against all columns.

    The rows' global indices start at `row_offset`, so the strict upper
    triangle counts each unordered pair once across ranks; padded entries
    (label < 0) are masked on both axes. Class weights come from
    `labels_all`, the full gathered set.
    """
    n_rows = emb_rows.shape[0]
    num_bins = thresholds.numel()
    device = emb_rows.device

    col_real = labels_all >= 0
    safe_cols = labels_all.clamp(min=0)
    counts = torch.zeros(num_classes, dtype=torch.float32, device=device)
    counts.index_add_(0, safe_cols, col_real.float())
    inv_n = torch.where(counts > 0, 1.0 / counts.clamp(min=1), 0.0)
    pos_pairs = counts * (counts - 1) / 2
    inv_pos = torch.where(pos_pairs > 0, 1.0 / pos_pairs.clamp(min=1), 0.0)

    chunk = max(min(_ROW_CHUNK, n_rows), 1)
    col_idx = torch.arange(emb_all.shape[0], device=device)
    parts = []
    with full_precision_matmul():
        for start in range(0, n_rows, chunk):
            rows = emb_rows[start:start + chunk]
            row_labels = labels_rows[start:start + chunk]
            row_idx = row_offset + start + torch.arange(rows.shape[0],
                                                        device=device)
            sims = torch.clamp(rows @ emb_all.T, -1.0, 1.0)
            d = 2.0 * (1.0 - sims) if metric == 0 else torch.arccos(sims)

            real = row_labels >= 0
            valid = ((row_idx[:, None] < col_idx[None, :]) & real[:, None]
                     & col_real[None, :])
            pos = row_labels[:, None] == labels_all[None, :]
            safe_rows = row_labels.clamp(min=0)
            w_pos = inv_pos[safe_rows][:, None]
            w_neg = inv_n[safe_rows][:, None] * inv_n[safe_cols][None, :]

            ids = torch.searchsorted(thresholds, d, right=True).reshape(-1)
            zero = torch.zeros((), device=device)
            wp = torch.where(valid & pos, w_pos, zero).reshape(-1)
            wn = torch.where(valid & ~pos, w_neg, zero).reshape(-1)
            parts.append(torch.stack([
                torch.bincount(ids, weights=wp.double(),
                               minlength=num_bins + 1),
                torch.bincount(ids, weights=wn.double(),
                               minlength=num_bins + 1)]))
    if not parts:
        return torch.zeros(2, num_bins + 1, dtype=torch.float64,
                           device=device)
    # the per-chunk partials summed once, as the JAX package sums them
    return torch.stack(parts).sum(dim=0)


def rows_per_rank(mesh, n_local):
    """The stripe size every data rank agrees on: the largest of the ranks'
    row counts (agreed by a gather of the counts)."""
    group = mesh.data_group
    if group is None:
        return n_local
    counts = gather_values(torch.tensor([n_local], dtype=torch.int64,
                                        device=comm_device(group)), group)
    return int(counts.max())


def sharded_pair_histograms(embeddings, labels, thresholds, num_classes,
                            metric, mesh):
    """Weighted pair histograms with the rows split over the data ranks.

    `embeddings`/`labels` are this rank's own stripe of the rows, in data
    rank order (labels densified against the global class set already;
    statistics.confusion_counts gathers the label values before
    densifying).

    :param thresholds: [T] ascending distance thresholds
    :returns: (hist_pos, hist_neg), float64 numpy [T + 1], the same on
        every rank
    """
    device = mesh.device
    emb = torch.as_tensor(embeddings, dtype=torch.float32).to(device)
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64
                             ).to(device)
    thresholds = torch.as_tensor(np.asarray(thresholds, np.float32)
                                 ).to(device)
    n, dim = emb.shape
    group = mesh.data_group

    per = rows_per_rank(mesh, n)
    stripe = torch.zeros(per, dim, dtype=torch.float32, device=device)
    stripe[:n] = emb
    stripe_labels = torch.full((per,), -1, dtype=torch.int64, device=device)
    stripe_labels[:n] = labels

    emb_all = gather_values(stripe, group)
    labels_all = gather_values(stripe_labels, group)
    hist = row_stripe_histograms(stripe, emb_all, stripe_labels, labels_all,
                                 mesh.data_index * per, int(num_classes),
                                 thresholds, int(metric))
    hist = reduce_values(hist, group).cpu().numpy()
    return hist[0], hist[1]
