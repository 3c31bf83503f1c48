"""Batch embedding evaluation over a dataset (on one rank, or split over a
grid's data ranks), the stored-embeddings loader, and an example input
(`inputs`)."""

from __future__ import annotations

import random
from collections import deque
from pathlib import Path

import numpy as np
import torch

from facenet_tpu_torch import h5utils
from facenet_tpu_torch.dataset import (  # noqa: F401  (the reference's name)
    equal_batches_input_pipeline)
from facenet_tpu_torch.logging import logger
from facenet_tpu_torch.statistics import split_embeddings


def inputs(config):
    """A zeros uint8 [1, size, size, 3] example input for an image config
    (``config.size``)."""
    return np.zeros((1, int(config.size), int(config.size), 3), np.uint8)


def renormalized(embeddings):
    """Rows L2-normalized in float64, returned as float32."""
    norms = np.linalg.norm(embeddings.astype(np.float64), axis=1,
                           keepdims=True)
    return (embeddings / np.maximum(norms, 1e-10)).astype(np.float32)


def sharded_forward(forward_fn, mesh):
    """Data-parallel extraction: every data rank embeds its part of each
    batch and the parts come back to every rank in order.

    A batch is zero-padded to a multiple of the data ranks, rank d embeds
    rows [d * B / data, (d + 1) * B / data) of it, an all_gather over the
    data group puts the rows back in order, and the padding is trimmed.
    Every rank passes the same batch and gets the same [B, D] tensor on its
    device. ``.dispatch`` is the same function (the JAX package's async
    entry; the gather already waits for every rank's rows).
    """
    from facenet_tpu_torch.parallel.mesh import gather_values

    def fn(images):
        images = torch.as_tensor(images)
        n = images.shape[0]
        per = -(-n // mesh.data)
        pad = per * mesh.data - n
        if pad:
            images = torch.cat([images, images.new_zeros(
                (pad,) + tuple(images.shape[1:]))])
        rows = images[mesh.data_index * per:(mesh.data_index + 1) * per]
        out = torch.as_tensor(forward_fn(rows)).to(mesh.device)
        return gather_values(out, mesh.data_group)[:n]

    fn.dispatch = fn
    return fn


def evaluate_embeddings(forward_fn, batches, renormalize=True, mesh=None):
    """Run `forward_fn` over all batches; concatenate embeddings and labels.

    :param forward_fn: images [B,H,W,3] uint8 -> [B,D] embeddings, as a
        tensor (possibly still being computed on the GPU) or an array
    :param batches: iterable of (images, labels)
    :param renormalize: re-apply exact L2 normalization in float64 on the
        host; the statistics check unit norms to 1e-5 and the forward runs
        in bf16
    :param mesh: a grid: the batches split over its data ranks
        (`sharded_forward`); every rank passes the same batches and gets
        every row
    :return: (embeddings [N, D] float32, labels [N])

    The loop keeps one batch in flight: batch n+1 is dispatched before
    batch n's result is fetched, so loading the next batch on the host
    overlaps the device computing this one. A CUDA result starts its copy
    to the host right after its dispatch, and the fetch waits for that copy
    alone, not for the batch queued behind it.
    """
    if mesh is not None:
        forward_fn = sharded_forward(forward_fn, mesh)
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
        embeddings = renormalized(embeddings)

    return embeddings, labels


class Embeddings:
    """Stored embeddings (an h5 file of ``embeddings`` and ``labels``) as
    per-class arrays, with optional class and image subsampling drawn with
    Python's `random`, as the JAX package draws them."""

    def __init__(self, config):
        self.config = config
        self.file = Path(str(config.path)).expanduser()

        per_class = split_embeddings(h5utils.read(self.file, 'embeddings'),
                                     h5utils.read(self.file, 'labels'))

        # first a random subset of classes, then a per-class cap on the
        # image count; both draws are without replacement and leave
        # smaller-than-cap groups untouched
        class_cap = int(self.config.nrof_classes or 0)
        if class_cap and class_cap < len(per_class):
            per_class = random.sample(per_class, class_cap)

        image_cap = int(self.config.max_nrof_images or 0)
        if image_cap:
            per_class = [
                emb if emb.shape[0] <= image_cap
                else emb[random.sample(range(emb.shape[0]), image_cap)]
                for emb in per_class
            ]

        self.embeddings = per_class

    def __repr__(self):
        data = [len(e) for e in self.embeddings]
        embeddings = np.concatenate(self.embeddings, axis=0)
        norm = np.linalg.norm(embeddings, axis=1)

        return (f'{self.__class__.__name__}\n' +
                f'Input file {self.file}\n' +
                f'Number of classes {self.nrof_classes} \n' +
                f'Number of images {self.nrof_images}\n' +
                f'Minimal number of images in class {min(data)}\n' +
                f'Maximal number of images in class {max(data)}\n' +
                '\n' +
                f'Minimal embedding {np.min(norm)}\n' +
                f'Maximal embedding {np.max(norm)}\n' +
                f'Mean embedding {np.mean(norm)}\n')

    @property
    def nrof_classes(self):
        return len(self.embeddings)

    @property
    def nrof_images(self):
        return sum(len(e) for e in self.embeddings)

    @property
    def length(self):
        return self.embeddings[0].shape[1]

    def data(self, normalize=False):
        embeddings = self.embeddings
        if normalize:
            embeddings = [e / np.linalg.norm(e, axis=1, keepdims=True)
                          for e in embeddings]
        return embeddings


class EvaluationOfEmbeddings:
    """Batched embedding extraction over a Database with the `FaceNet`
    runtime of ``config.model``, split over the data ranks of the grid a
    ``mesh:`` section describes (`parallel.mesh.eval_mesh`,
    `sharded_forward`)."""

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

        from facenet_tpu_torch.parallel.mesh import eval_mesh
        self.mesh = mesh = eval_mesh(config.mesh, device)

        self.embeddings, self.labels = evaluate_embeddings(
            forward_fn, batches, renormalize=renormalize, mesh=mesh)
        logger.info(str(self))

    def __repr__(self):
        return ('{}\n'.format(self.__class__.__name__) +
                'model: {}\n'.format(self.config.model.path) +
                'embedding size: {}\n'.format(self.embeddings.shape))
