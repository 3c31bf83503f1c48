"""Batch embedding evaluation over a dataset."""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from facenet_tpu_torch.logging import logger


def evaluate_embeddings(forward_fn, batches, renormalize=True):
    """Run `forward_fn` over all batches; concatenate embeddings and labels.

    :param forward_fn: images [B,H,W,3] uint8 -> [B,D] embeddings, as a
        tensor (possibly still being computed on the GPU) or an array
    :param batches: iterable of (images, labels)
    :param renormalize: re-apply exact L2 normalization in float64 on the
        host; the statistics check unit norms to 1e-5 and the forward runs
        in bf16
    :return: (embeddings [N, D] float32, labels [N])

    The loop keeps one batch in flight: batch n+1 is dispatched before
    batch n's result is fetched, so loading the next batch on the host
    overlaps the device computing this one. A CUDA result starts its copy
    to the host right after its dispatch, and the fetch waits for that copy
    alone, not for the batch queued behind it.
    """
    embeddings_ = []
    labels_ = []

    def start_fetch(out):
        if isinstance(out, torch.Tensor) and out.is_cuda:
            host = out.to('cpu', non_blocking=True)     # pinned, async
            copied = torch.cuda.Event()
            copied.record()
            return host, copied
        return out, None

    def fetch(out, copied, labels):
        if copied is not None:
            copied.synchronize()
        if isinstance(out, torch.Tensor):
            out = out.numpy()
        embeddings_.append(np.asarray(out))
        labels_.append(np.asarray(labels))

    pending = deque()
    for images, labels in batches:
        pending.append((*start_fetch(forward_fn(images)), labels))
        if len(pending) >= 2:
            fetch(*pending.popleft())
    while pending:
        fetch(*pending.popleft())

    embeddings = np.concatenate(embeddings_)
    labels = np.concatenate(labels_)

    if renormalize:
        norms = np.linalg.norm(embeddings.astype(np.float64), axis=1,
                               keepdims=True)
        embeddings = (embeddings / np.maximum(norms, 1e-10)).astype(np.float32)

    return embeddings, labels


class EvaluationOfEmbeddings:
    """Batched embedding extraction over a Database with the `FaceNet`
    runtime of ``config.model``."""

    def __init__(self, dbase, config, forward_fn=None, device=None):
        from facenet_tpu_torch.dataset import ImageLoader

        self.config = config
        self.dbase = dbase

        renormalize = True
        if forward_fn is None:
            from facenet_tpu_torch import FaceNet
            facenet = FaceNet(config.model, device=device)
            forward_fn = facenet.dispatch
            # raw (unnormalized) embeddings are not re-normalized either
            renormalize = facenet.normalize

        loader = ImageLoader(config=config.image)
        batches = dbase.batches(loader, batch_size=int(config.batch_size or 100))

        self.embeddings, self.labels = evaluate_embeddings(
            forward_fn, batches, renormalize=renormalize)
        logger.info(str(self))

    def __repr__(self):
        return ('{}\n'.format(self.__class__.__name__) +
                'model: {}\n'.format(self.config.model.path) +
                'embedding size: {}\n'.format(self.embeddings.shape))
