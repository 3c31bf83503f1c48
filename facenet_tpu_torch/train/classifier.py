"""Pair-classifier training and its class-pair confusion.

A two- or three-scalar `faceclass` classifier is trained with the weighted
pair BCE over the upper-triangle pair logits of P-classes x K-examples
batches of stored embeddings, by Adam on an exponential-decay schedule:
update k (0-based) runs at ``schedule(k)``.

`ConfusionMatrix` is the reference's class-pair confusion: each class pair
(i, k) contributes the share of its image pairs the classifier accepts.
The reference loops over the C (C - 1) / 2 class pairs with one `predict`
each (124,750 at 500 classes); here every class block's count comes from
row chunks of the one N x N acceptance matrix on the device (a cumulative
sum over each row, read at the class ends), and the host reads the C x C
counts once.
"""

from __future__ import annotations

import numpy as np
import torch

from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.faceclass import (
    FaceToFaceDistanceClassifier, FaceToFaceNormalizedEmbeddingsClassifier)
from facenet_tpu_torch.logging import logger
from facenet_tpu_torch.ops.image_ops import full_float32
from facenet_tpu_torch.ops.losses import binary_cross_entropy_pair_loss
from facenet_tpu_torch.ops.lr_schedules import exponential_decay_schedule


def class_pair_acceptance(embeddings, classifier, chunk=2048):
    """[C, C] float64: the share of the image pairs of class block (i, k)
    (rows of class i, columns of class k, the diagonal's own pairs
    included) that ``classifier.predict`` accepts, counted exactly on the
    classifier's device in full float32."""
    sizes = np.array([len(e) for e in embeddings])
    c = len(sizes)
    device = classifier.variables['threshold'].device
    x = torch.from_numpy(np.concatenate(embeddings).astype(np.float32)) \
        .to(device)
    ends = torch.from_numpy(np.cumsum(sizes) - 1).to(device)
    row_class = torch.repeat_interleave(
        torch.arange(c, device=device), torch.from_numpy(sizes).to(device))
    counts = torch.zeros(c, c, dtype=torch.int64, device=device)
    threshold = classifier.variables['threshold']
    with torch.no_grad(), full_float32():
        for start in range(0, x.shape[0], chunk):
            rows = x[start:start + chunk]
            accepted = (classifier.distance(rows, x) < threshold)
            at_ends = accepted.to(torch.int32).cumsum(1)[:, ends]
            per_block = torch.diff(at_ends, dim=1, prepend=torch.zeros_like(
                at_ends[:, :1]))
            counts.index_add_(0, row_class[start:start + chunk],
                              per_block.long())
    return counts.cpu().numpy() / np.outer(sizes, sizes).astype(np.float64)


class ConfusionMatrix:
    """Class-pair confusion of a pair classifier: every class pair counts
    once, positive pairs (i, i) and negative pairs (i, k < i) each averaged
    over their C and C (C - 1) / 2 blocks."""

    def __init__(self, embeddings, classifier):
        nrof_classes = len(embeddings)
        means = class_pair_acceptance(embeddings, classifier)
        negative = means[np.tril_indices(nrof_classes, -1)]
        positive = np.diag(means)

        tp = positive.sum() / nrof_classes
        fn = (1 - positive).sum() / nrof_classes
        nrof_negative_class_pairs = nrof_classes * (nrof_classes - 1) / 2
        fp = negative.sum() / nrof_negative_class_pairs
        tn = (1 - negative).sum() / nrof_negative_class_pairs

        self.classifier = classifier
        self.accuracy = (tp + tn) / (tp + fp + tn + fn)
        self.precision = tp / (tp + fp) if (tp + fp) > 0 else 1.0
        self.tp_rate = tp / (tp + fn) if (tp + fn) > 0 else 1.0
        self.tn_rate = tn / (tn + fp) if (tn + fp) > 0 else 1.0

    def __repr__(self):
        return (f'{self.__class__.__name__}\n' +
                f'{str(self.classifier)}\n' +
                f'accuracy  {self.accuracy}\n' +
                f'precision {self.precision}\n' +
                f'tp rate   {self.tp_rate}\n' +
                f'tn rate   {self.tn_rate}\n')


class ClassifierTrainer:
    """Train a `faceclass` pair classifier on equal embedding batches.

    :param cfg: the train_classifier config (``train.learning_rate_schedule
        .{initial_value, decay_rate, decay_steps}``, ``train.epoch.size``)
    :param normalized: the classifier of normalized embeddings
    :param device: torch device; None means cuda (raises without a GPU)
    """

    def __init__(self, cfg, normalized=False, device=None):
        self.cfg = cfg
        self.normalized = normalized
        self.device = resolve_device(device)
        model = (FaceToFaceNormalizedEmbeddingsClassifier if normalized
                 else FaceToFaceDistanceClassifier)
        self.model = model(device=self.device)

        lr_cfg = cfg.train.learning_rate_schedule
        decay_steps = lr_cfg.decay_steps or cfg.train.epoch.size
        self.schedule = exponential_decay_schedule(
            lr_cfg.initial_value or 0.01, lr_cfg.decay_rate or 0.1,
            decay_steps)
        self.losses = []

    def train(self, batch_iter, nrof_epochs, epoch_size, p, k,
              embeddings_per_class=None, logfile=None):
        """Run the training loop; returns the trained classifier. Each
        step's loss stays a tensor in `losses` (no host sync a step).

        :param batch_iter: endless iterator of [P*K, D] float32 batches
        :param embeddings_per_class: optional per-class arrays for the
            per-epoch `ConfusionMatrix`
        """
        variables = {name: v.detach().clone().requires_grad_(True)
                     for name, v in self.model.variables.items()}
        optimizer = torch.optim.Adam(list(variables.values()),
                                     lr=self.schedule(0), betas=(0.9, 0.999),
                                     eps=1e-8)
        step = 0
        loss = None
        for epoch in range(nrof_epochs):
            for _ in range(epoch_size):
                batch = torch.as_tensor(next(batch_iter)).to(
                    self.device, non_blocking=True)
                for group in optimizer.param_groups:
                    group['lr'] = self.schedule(step)
                optimizer.zero_grad(set_to_none=True)
                loss = binary_cross_entropy_pair_loss(
                    self.model(batch, variables=variables), p, k)
                loss.backward()
                optimizer.step()
                self.losses.append(loss.detach())
                step += 1

            self.model.variables = {name: v.detach().clone()
                                    for name, v in variables.items()}
            lr = self.schedule((epoch + 1) * epoch_size)
            info = (f'epoch [{epoch + 1}/{nrof_epochs}], '
                    f'loss {float(loss.detach()):.5f}, learning rate {lr:.6f}')
            logger.info(info)

            if embeddings_per_class is not None:
                conf_mat = ConfusionMatrix(embeddings_per_class, self.model)
                logger.info(str(conf_mat))
                if logfile:
                    from facenet_tpu_torch import ioutils
                    ioutils.write_text_log(logfile, info)
                    ioutils.write_text_log(logfile, conf_mat)

        self.model.variables = {name: v.detach().clone()
                                for name, v in variables.items()}
        return self.model
