"""Softmax (+ center / triplet) embedding training of Inception-ResNet-v1.

The backbone with a Dense logits head over the identity classes, sparse
softmax cross-entropy weighted by ``loss.softmax_factor``, L2(5e-4) on
every kernel, an optional center loss and an optional triplet loss with
online semi-hard mining on the L2-normalized bottleneck; Adam with
``eps = train.adam_epsilon`` (0.1) and betas (0.9, 0.999), the learning
rate from the piecewise epoch schedule; weight decay comes only through
the L2 term.

Precision: float32 master weights, bfloat16 compute by explicit casts —
every layer casts its float32 parameters to the dtype of its input, and
the input is preprocessed into bfloat16 (the JAX modules' ``dtype=bf16,
param_dtype=f32``); BatchNorm statistics, the losses and the optimizer
run in float32. ``dtype=torch.float32`` runs the whole step in float32;
``dtype=torch.float64`` holds the weights, the BatchNorm statistics, Adam's
moments and the centers in float64 and computes in float64 (a reference
run: the losses keep their float32 casts, as JAX's float64 run does).

One step: optional random crop / flip of the uint8 batch (draws from the
state's torch.Generator), forward in train mode (BatchNorm on the batch's
statistics, running statistics moved once), the losses, backward, Adam at
``schedule(step)``, the centers table replaced by its update. With
``train.remat`` the backbone runs under torch.utils.checkpoint, so the
backward recomputes its activations instead of keeping them. `frozen_bn`
steps normalize with the running statistics and leave them untouched,
while every parameter still trains.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from collections import deque

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from facenet_tpu_torch.config import Config, value_or
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.logging import logger
from facenet_tpu_torch.models import inception_resnet_v1 as irv1
from facenet_tpu_torch.ops import losses as losses_mod
from facenet_tpu_torch.ops.lr_schedules import schedule_from_config
from facenet_tpu_torch.ops.preprocessing import random_augment
from facenet_tpu_torch.utils import profiling


def create_backbone(model_cfg=None, image_cfg=None):
    """The Inception-ResNet-v1 a train config selects.

    `model_cfg` is the ``model:`` section ({'module': ..., 'config':
    {...}}) or a bare topology dict; a module other than
    inception_resnet_v1 raises NotImplementedError (the port trains
    Inception-ResNet-v1 only)."""
    if model_cfg is not None and not isinstance(model_cfg, Config):
        model_cfg = Config(model_cfg)
    net_cfg = None
    if model_cfg:
        if model_cfg.module:
            module = str(model_cfg.module).rsplit('.', 1)[-1]
            if module != 'inception_resnet_v1':
                raise NotImplementedError(
                    f'training {model_cfg.module} is not ported; the PyTorch '
                    'port trains inception_resnet_v1 only')
            net_cfg = model_cfg.config.as_dict if model_cfg.config else None
        elif model_cfg.config:
            net_cfg = model_cfg.config.as_dict
        else:
            # a bare topology dict; run-dir keys ride along in cfg.model
            net_cfg = {k: v for k, v in model_cfg.as_dict.items()
                       if k not in ('path', 'checkpoint', 'weights')} or None
    image_cfg = image_cfg or Config({'size': 160, 'normalization': 0})
    return irv1.InceptionResnetV1(
        config=net_cfg, image_size=int(image_cfg.size or 160),
        normalization=int(value_or(image_cfg.normalization, 0)))


class SoftmaxClassifier(nn.Module):
    """Backbone + identity-logits head: the unnormalized bottleneck into a
    Dense layer with bias (glorot-uniform kernel, zero bias), computed in
    the step's dtype, logits returned in float32."""

    def __init__(self, backbone, nrof_classes):
        super().__init__()
        self.backbone = backbone
        self.logits = irv1.Dense(int(backbone.cfg.output.size),
                                 int(nrof_classes), bias=True)

    def forward(self, images, train=False, dtype=torch.bfloat16):
        """-> (logits [B, C] float32, prelogits [B, D] float32)."""
        prelogits = self.backbone(images, train=train, normalize=False,
                                  dtype=dtype)
        return self.head(prelogits, dtype), prelogits

    def head(self, prelogits, dtype=torch.bfloat16):
        return self.logits(prelogits.to(dtype)).float()

    def init_variables(self, seed=0):
        """A fresh flax-layout tree: ``{'params': {'backbone', 'logits'},
        'batch_stats': {'backbone'}}`` drawn from numpy's RandomState."""
        rng = np.random.RandomState(seed)
        params, stats = self.backbone.flax_variables(rng)
        head, _ = self.logits.flax_variables(rng)
        return {'params': {'backbone': params, 'logits': head},
                'batch_stats': {'backbone': stats}}

    def from_flax_variables(self, variables):
        self.backbone.load_flax(variables['params']['backbone'],
                                variables['batch_stats']['backbone'])
        self.logits.load_flax(variables['params']['logits'])
        return self

    def to_flax_variables(self):
        params, stats = self.backbone.dump_flax()
        head, _ = self.logits.dump_flax()
        return {'params': {'backbone': params, 'logits': head},
                'batch_stats': {'backbone': stats}}


@dataclasses.dataclass
class TrainState:
    """Everything a step reads and moves: the update count, the model
    (parameters and BatchNorm statistics), Adam, the centers table (None
    without center loss) and the augmentation draws' generator."""
    step: int
    model: SoftmaxClassifier
    optimizer: torch.optim.Optimizer
    centers: torch.Tensor | None
    generator: torch.Generator


@contextlib.contextmanager
def running_stats_frozen(module):
    """Keep every BatchNorm's running statistics under `module` as they
    are, in train mode too."""
    norms = [m for m in module.modules() if isinstance(m, irv1.BatchNorm)]
    for m in norms:
        m.update_running = False
    try:
        yield
    finally:
        for m in norms:
            m.update_running = True


def make_train_step(schedule, loss_cfg, augment_cfg=None, image_size=160,
                    remat=False, frozen_bn=False, dtype=torch.bfloat16):
    """step(state, images, labels) -> (state, metrics), moving `state`.

    :param images: [B, H, W, 3] uint8 tensor on the model's device
    :param labels: [B] int tensor on the same device
    :return: metrics, 0-d float32 tensors left on the device: loss,
        cross_entropy, regularization, accuracy, and center_loss /
        triplet_loss when those are on
    """
    center_factor = float(loss_cfg.center_factor or 0.0)
    center_alfa = float(loss_cfg.center_alfa or 0.95)
    triplet_factor = float(loss_cfg.triplet_factor or 0.0)
    triplet_margin = float(loss_cfg.triplet_margin or 0.2)
    # 0 is a valid softmax weight (pure triplet training), so no `or`
    softmax_factor = float(value_or(loss_cfg.softmax_factor, 1.0))
    random_crop = bool(augment_cfg.random_crop) if augment_cfg else False
    random_flip = bool(augment_cfg.random_flip) if augment_cfg else False
    train = not frozen_bn

    def forward(model, images):
        if not remat:
            return model(images, train=train, dtype=dtype)
        backbone = model.backbone
        # the recompute must not move the running statistics a second time
        prelogits = checkpoint(
            lambda x: backbone(x, train=train, normalize=False, dtype=dtype),
            images, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                running_stats_frozen(backbone)))
        return model.head(prelogits, dtype), prelogits

    def train_step(state, images, labels):
        if random_crop or random_flip:
            images = random_augment(state.generator, images,
                                    random_crop=random_crop,
                                    random_flip=random_flip,
                                    crop_size=image_size)
        labels = labels.long()
        model = state.model

        logits, prelogits = forward(model, images)
        ce = losses_mod.softmax_cross_entropy_with_logits(logits, labels)
        reg = irv1.l2_regularization(model)
        total = softmax_factor * ce + reg
        metrics = {'cross_entropy': ce, 'regularization': reg}

        new_centers = state.centers
        if state.centers is not None and center_factor > 0:
            c_loss, new_centers = losses_mod.center_loss(
                prelogits, labels, state.centers, center_alfa)
            total = total + center_factor * c_loss
            metrics['center_loss'] = c_loss

        if triplet_factor > 0:
            emb = prelogits.float()
            emb = emb / torch.sqrt(torch.maximum(
                emb.square().sum(dim=1, keepdim=True),
                torch.full((), 1e-10, device=emb.device)))
            t_loss = losses_mod.triplet_semihard_loss(emb, labels,
                                                      triplet_margin)
            total = total + triplet_factor * t_loss
            metrics['triplet_loss'] = t_loss

        metrics['accuracy'] = (logits.argmax(dim=1) == labels).float().mean()
        metrics['loss'] = total

        lr = schedule(state.step)
        for group in state.optimizer.param_groups:
            group['lr'] = lr
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()

        state.centers = new_centers
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


class SoftmaxTrainer:
    """Trainer: the model, the step functions, the epoch loop.

    :param cfg: the train config (``image``, ``train``, ``loss``,
        ``profiling``, ``debug`` sections)
    :param nrof_classes: width of the logits head
    :param model_cfg: the ``model:`` section or a bare topology dict
        (default ``cfg.model``)
    :param device: 'cuda' (default; raises without a GPU) or 'cpu'
    :param dtype: compute dtype, bfloat16 (default), float32 or float64
        (float64 weights too)
    """

    def __init__(self, cfg, nrof_classes, model_cfg=None, device=None,
                 dtype=torch.bfloat16):
        self.cfg = cfg
        self.nrof_classes = int(nrof_classes)
        self.device = resolve_device(device)
        self.dtype = dtype
        profiling.apply_debug_config(cfg.debug)

        self.model_cfg = model_cfg if model_cfg is not None else cfg.model
        self.image_size = int(cfg.image.size or 160)
        self.steps_per_epoch = int(cfg.train.epoch.size or 1000)
        self.schedule = schedule_from_config(cfg.train, self.steps_per_epoch)
        self.adam_epsilon = float(cfg.train.adam_epsilon or 0.1)
        self._step_fns = {}

    # ------------------------------------------------------------------
    def init_state(self, seed=0):
        """A fresh state: weights drawn with numpy's RandomState(seed),
        zero centers when ``loss.center_factor > 0``, Adam with no
        moments yet, the generator seeded with `seed`."""
        backbone = create_backbone(self.model_cfg, self.cfg.image)
        model = SoftmaxClassifier(backbone, self.nrof_classes)
        model.from_flax_variables(model.init_variables(seed))
        master = (torch.float64 if self.dtype == torch.float64
                  else torch.float32)
        model.to(self.device, master)

        center_factor = float(self.cfg.loss.center_factor or 0.0)
        centers = (torch.zeros(self.nrof_classes,
                               int(backbone.cfg.output.size),
                               device=self.device, dtype=master)
                   if center_factor > 0 else None)
        optimizer = torch.optim.Adam(model.parameters(),
                                     lr=self.schedule(0), betas=(0.9, 0.999),
                                     eps=self.adam_epsilon)
        generator = torch.Generator().manual_seed(int(seed))
        return TrainState(step=0, model=model, optimizer=optimizer,
                          centers=centers, generator=generator)

    def warm_start(self, state, variables):
        """Load a bundle's backbone variables ({'params', 'batch_stats'},
        flax layout, numpy leaves) into `state`; the head, Adam and the
        centers stay as they are.

        :raises ValueError: on any shape mismatch, naming the leaf
        """
        current = state.model.backbone.to_flax_variables()

        def check(path, old, new):
            if isinstance(old, dict):
                for key in old:
                    if key not in new:
                        raise ValueError(f'warm_start: weights lack '
                                         f'backbone/{path}{key}')
                    check(f'{path}{key}/', old[key], new[key])
                return
            if tuple(old.shape) != tuple(np.shape(new)):
                raise ValueError(
                    f'warm_start shape mismatch at backbone/{path[:-1]}: '
                    f'state {tuple(old.shape)} vs weights {np.shape(new)}')

        check('', current, variables)
        state.model.backbone.from_flax_variables(variables)
        return state

    # ------------------------------------------------------------------
    def _step_fn(self, frozen_bn):
        if frozen_bn not in self._step_fns:
            self._step_fns[frozen_bn] = make_train_step(
                self.schedule, self.cfg.loss, augment_cfg=self.cfg.image,
                image_size=self.image_size,
                remat=bool(self.cfg.train.remat), frozen_bn=frozen_bn,
                dtype=self.dtype)
        return self._step_fns[frozen_bn]

    @property
    def step_fn(self):
        return self._step_fn(False)

    @property
    def frozen_bn_step_fn(self):
        """Late-phase step: running-statistics forward, statistics kept."""
        return self._step_fn(True)

    def placed(self, images, labels):
        """A host batch as tensors on the trainer's device (pinned and
        asynchronous to a GPU)."""
        images, labels = torch.as_tensor(images), torch.as_tensor(labels)
        if self.device.type == 'cuda' and not images.is_cuda:
            images, labels = images.pin_memory(), labels.pin_memory()
        return (images.to(self.device, non_blocking=True),
                labels.to(self.device, non_blocking=True))

    def _placed_batches(self, batches, prefetch):
        """(size, images, labels) with up to `prefetch` batches' copies to
        the device in flight ahead of the consumer."""
        queue = deque()
        for images, labels in batches:
            queue.append((len(images), *self.placed(images, labels)))
            if len(queue) >= max(int(prefetch), 1):
                yield queue.popleft()
        while queue:
            yield queue.popleft()

    def train_epoch(self, state, batches, epoch, log_every=100,
                    frozen_bn=False):
        """One epoch over an iterable of (images, labels) host batches.

        Exactly ``train.epoch.size`` batches are drawn: the draw is bounded
        before the prefetch queue, so a pipeline shared across epochs (and
        its checkpointed cursor) never runs past data that was not trained.
        With ``profiling.trace_dir`` set, a torch.profiler trace covers
        steps [start_step, start_step + num_steps) of epoch
        ``profiling.epoch``.

        :param frozen_bn: run this epoch with running-statistics forwards
        :return: (state, metrics of the last step as floats, with
            epoch_time_s, steps and img_per_s)
        """
        prefetch = int(value_or(self.cfg.train.prefetch, 2))
        batches = itertools.islice(iter(batches), self.steps_per_epoch)
        prof = self.cfg.profiling
        window = profiling.TraceWindow(
            prof.trace_dir if prof else None,
            epoch=value_or(prof.epoch if prof else None, 0),
            start_step=value_or(prof.start_step if prof else None, 3),
            num_steps=value_or(prof.num_steps if prof else None, 5))
        step = self.frozen_bn_step_fn if frozen_bn else self.step_fn

        t0 = time.monotonic()
        metrics, n, seen = None, 0, 0
        for size, images, labels in self._placed_batches(batches, prefetch):
            window.step(epoch, n)
            state, metrics = step(state, images, labels)
            n += 1
            seen += size
            if log_every and n % log_every == 0:
                logger.info(
                    f'epoch {epoch} step {n}/{self.steps_per_epoch} ' +
                    ' '.join(f'{k}={float(v):.4f}'
                             for k, v in metrics.items()))
        window.close()

        # reading the last metrics waits for the epoch's device work
        m = {k: float(v) for k, v in (metrics or {}).items()}
        dt = time.monotonic() - t0
        m['epoch_time_s'] = dt
        m['steps'] = n
        m['img_per_s'] = seen / dt if dt > 0 else 0.0
        return state, m

    # ------------------------------------------------------------------
    def embedding_forward(self, state):
        """images (uint8 NHWC, numpy or tensor) -> L2-normalized float32
        embeddings, the backbone in inference mode in the trainer's
        dtype; the result stays on the device."""
        backbone = state.model.backbone

        def forward(images):
            images = torch.as_tensor(images).to(self.device)
            with torch.inference_mode():
                return backbone(images, dtype=self.dtype)

        return forward


def flat_leaves(tree):
    """The leaves of a nested dict of arrays, in sorted-key order, as
    float64 numpy arrays."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from flat_leaves(tree[key])
    else:
        yield np.asarray(tree, np.float64)


def step_on_devices(cfg, nrof_classes, images, labels, model_cfg=None,
                    dtype=torch.float32, atol=0.0, devices=('cuda', 'cpu')):
    """One train step of the same fresh state, ``init_state(seed=0)``, on
    each of two devices, with cuDNN and cuBLAS kept off TF32: the check
    that the card's step is the CPU's.

    :param atol: the part of a leaf's difference forgiven outright
    :return: ((metrics on the first device, on the second) as floats,
        worst, largest): worst is the largest over the state's leaves
        (parameters, BatchNorm statistics, centers) of (max |first -
        second| - atol) over the largest entry of that leaf's update on
        the second device; largest is the largest update of any leaf there
    """
    runs = []
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in devices:
            trainer = SoftmaxTrainer(cfg, nrof_classes, model_cfg=model_cfg,
                                     device=device, dtype=dtype)
            state = trainer.init_state(seed=0)
            trees = [state.model.to_flax_variables()]
            if state.centers is not None:
                trees[0]['centers'] = state.centers.cpu().numpy()
            state, metrics = trainer.step_fn(
                state, *trainer.placed(images, labels))
            trees.append(state.model.to_flax_variables())
            if state.centers is not None:
                trees[1]['centers'] = state.centers.cpu().numpy()
            runs.append(({k: float(v) for k, v in metrics.items()},
                         *(list(flat_leaves(t)) for t in trees)))
            del trainer, state
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    first, second = runs
    worst, largest = 0.0, 0.0
    for got, want, start in zip(first[2], second[2], second[1]):
        moved = np.abs(want - start).max()
        largest = max(largest, moved)
        worst = max(worst, (np.abs(got - want).max() - atol)
                    / max(moved, 1e-30))
    return (first[0], second[0]), worst, largest
