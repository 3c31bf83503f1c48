"""Training losses.

  * sparse softmax cross-entropy, in float32;
  * center loss with a non-trainable centers table: returns the loss and
    the updated table, where repeated labels accumulate their updates;
  * weighted binary cross-entropy over upper-triangle pair logits of a
    P x K batch;
  * the triplet loss with online semi-hard negative mining, as a masked
    minimum over the [anchor, positive, negative] cube of the batch;
  * on a process grid: the center update made from the global batch's
    diffs, gathered over the data ranks.

Gradients follow the JAX package's: `torch.amin`/`torch.amax` and
`torch.maximum` split a gradient evenly among tied entries, as ``jnp.min``,
``jnp.max`` and ``jnp.maximum`` do (``torch.min(dim=)`` and ``clamp`` do
not).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from facenet_tpu_torch.parallel.mesh import gather_values


def softmax_cross_entropy_with_logits(logits, labels):
    """Mean sparse softmax cross-entropy."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(1, labels.long()[:, None])[:, 0]
    return nll.mean()


def center_loss(features, labels, centers, alfa, group=None):
    """Center loss: (loss, new_centers).

        diff = (1 - alfa) * (centers[label] - features)
        new_centers[label] -= sum of that label's diffs
        loss = mean((features - centers[label]) ** 2)

    The loss reads the old table; no gradient reaches the table, and the
    update is made from the features' values alone.

    :param features: [B, D] float embeddings (the unnormalized bottleneck)
    :param labels: [B] int class ids
    :param centers: [C, D] float32 table
    :param alfa: center update rate
    :param group: the data ranks holding the rest of the global batch, in
        its row order: every rank gathers the global batch's diffs and
        labels and adds them to the table as one device would, so the
        table stays the same on every rank; the loss is this rank's mean,
        whose mean over the ranks is the global one
    """
    features = features.float()
    labels = labels.long()
    centers_batch = centers[labels]
    diff = (1 - alfa) * (centers_batch - features.detach())
    new_centers = centers.index_add(0, gather_values(labels, group),
                                    -gather_values(diff, group))
    loss = (features - centers_batch).square().mean()
    return loss, new_centers


def binary_cross_entropy_pair_loss(logits, nrof_classes_per_batch,
                                   nrof_examples_per_class):
    """Weighted BCE over upper-triangle pair logits.

    The batch is P classes x K examples in class-major order; pairs (i, k)
    with i // K == k // K are positive. pos_weight rebalances the positive
    to negative skew as ``tf.nn.weighted_cross_entropy_with_logits`` does.
    The pair indices are made on the logits' device (``torch.triu_indices``,
    the order of ``np.triu_indices``), so a step makes no host sync.

    :raises ValueError: at K = 1, where the batch holds no positive pair
    """
    k = int(nrof_examples_per_class)
    batch_size = int(nrof_classes_per_batch) * k
    nrof_positive = np.float32(nrof_classes_per_batch * k * (k - 1) // 2)
    if nrof_positive == 0:
        raise ValueError(
            'no positive pairs in the batch: nrof_examples_per_class='
            f'{nrof_examples_per_class} must be >= 2')
    pos_weight = batch_size * (batch_size - 1) // 2 / nrof_positive - 1

    device = logits.device
    iu, ku = torch.triu_indices(batch_size, batch_size, 1, device=device)
    labels = (iu // k == ku // k).float()
    logits = logits[iu, ku].float()

    # (1 - z) * x + (1 + (q - 1) * z) * log(1 + exp(-x)), in its stable form
    log_weight = 1 + (pos_weight - 1) * labels
    zero = torch.zeros((), dtype=logits.dtype, device=device)
    loss = ((1 - labels) * logits +
            log_weight * (torch.logaddexp(zero, -logits.abs()) +
                          torch.maximum(-logits, zero)))
    return loss.mean()


def pairwise_squared_distances(embeddings):
    """All-pairs squared Euclidean distances of a batch, float32."""
    e = embeddings.float()
    sq = e.square().sum(dim=1)
    d = sq[:, None] - 2.0 * (e @ e.T) + sq[None, :]
    return torch.maximum(d, torch.zeros((), dtype=d.dtype, device=d.device))


def triplet_semihard_loss(embeddings, labels, margin=0.2):
    """FaceNet triplet loss with online semi-hard negative mining.

    For each anchor-positive pair (a, p) the negative is the one of least
    d(a, n) with d(a, n) > d(a, p); where none exists, the hardest (largest
    d(a, n)) negative of the anchor. loss = mean over positive pairs of
    max(d(a, p) + margin - d(a, n), 0).

    :param embeddings: [B, D] L2-normalized embeddings
    :param labels: [B] int class ids
    :param margin: alpha (0.2 in the FaceNet paper)
    """
    labels = labels.long()
    d = pairwise_squared_distances(embeddings)
    b = d.shape[0]

    same = labels[:, None] == labels[None, :]
    eye = torch.eye(b, dtype=torch.bool, device=d.device)
    pos_mask = same & ~eye
    neg_mask = ~same

    big = torch.full((), 1e9, dtype=d.dtype, device=d.device)
    d_an = d[:, None, :]                                    # [a, 1, n]
    d_ap = d[:, :, None]                                    # [a, p, 1]
    semi_mask = neg_mask[:, None, :] & (d_an > d_ap)        # [a, p, n]

    semi_min = torch.where(semi_mask, d_an, big).amin(dim=2)        # [a, p]
    has_semi = semi_mask.any(dim=2)

    hard_max = torch.where(neg_mask, d, -big).amax(dim=1)           # [a]
    neg_dist = torch.where(has_semi, semi_min, hard_max[:, None])   # [a, p]

    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    losses = torch.maximum(d + margin - neg_dist, zero)
    losses = torch.where(pos_mask, losses, zero)

    num_pos = torch.clamp(pos_mask.sum(), min=1)
    return losses.sum() / num_pos
