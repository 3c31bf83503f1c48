"""Softmax (+ center / triplet) embedding training of the model zoo's
networks (Inception-ResNet-v1 or -v2, `models.create_model_from_config`).

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
state's torch.Generator), Inception-ResNet-v2's dropout mask for the
batch (drawn next from the same generator, when its keep probability is
below 1), forward in train mode (BatchNorm on the batch's
statistics, running statistics moved once), the losses, backward, Adam at
``schedule(step)``, the centers table replaced by its update. With
``train.remat`` the backbone runs under torch.utils.checkpoint, so the
backward recomputes its activations instead of keeping them. `frozen_bn`
steps normalize with the running statistics and leave them untouched,
while every parameter still trains. A step is the ``train.step`` span
(`SoftmaxTrainer.train_epoch`'s `StepTimer`) around ``train.forward``
(augmentation through the losses), ``train.backward`` (clearing the
gradients, the backward pass, their average) and ``train.adam`` (the
learning rate, Adam); placing a batch is ``train.place``
(`utils.profiling`).

On a (data, model) process grid (`parallel.mesh`, the ``mesh:`` section or
``mesh=``) a step computes what the same step computes on one device, as
the JAX package's step under its mesh does: every rank sees the same global
batch and trains on its data rank's rows; BatchNorm's statistics, the
center update, the triplet loss's mining and every metric are the global
batch's; each model rank holds C / model columns of the logits head and of
Adam's moments for it and computes those columns' logits, the columns are
gathered into whole rows for the cross-entropy and the accuracy's argmax,
and the head's L2 term is summed over the model ranks. (A log-softmax
sharded by columns, its maxima and sums of exponentials reduced over the
model ranks, rounds its float32 sums in another order than log_softmax
does on the whole row, which put a float64 step on the (1, 2) grid 1.1e-6
to 1.4e-6 of a leaf's update away from the single device's; on the whole
rows the loss's arithmetic is the single device's. The rows cost
B x C float32 a rank, against the C x D weights and Adam's moments that
stay split.) The augmentation draws and the dropout mask are
made for the global batch from the same generator on every rank, which
crops, flips and drops on its own rows.

The gradient's scale: each rank differentiates its own share of the loss,
so that the shares of the data ranks add up to `data` times the global
loss, and the gradients are then averaged over the data ranks. A term of
this rank's rows (the cross-entropy, the center loss: local means) is its
share as it stands. A term every data rank computes in full from gathered
rows (the triplet loss) is also its share as it stands: the gather's
backward sums every rank's gradient into the rows' owner, so the data
ranks' shares add up to `data` times the term. The global BatchNorm sums
are differentiated the same way (their all_reduce's backward is an
all_reduce). Over the model ranks every rank computes the same loss and
differentiates it once: the head's input goes through f (identity, its
gradient summed over the model ranks) and its output and L2 term through
g (gathered or summed, this rank's part of the gradient passed through),
so the backbone's gradient is the
same on every model rank and the data average needs no model reduction.
The average is one all_reduce of all gradients flattened together, after
the backward: DistributedDataParallel's hooks would reduce buckets during
the backward, interleaved with the collectives the backward itself makes
(the BatchNorm sums, the gathers), and one reduction after it keeps a
single order of collectives on every rank, with or without remat.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import time
from collections import deque

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from facenet_tpu_torch import models
from facenet_tpu_torch.config import Config, value_or
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.logging import logger
from facenet_tpu_torch.models import inception_resnet_v1 as irv1
from facenet_tpu_torch.ops import losses as losses_mod
from facenet_tpu_torch.ops.lr_schedules import schedule_from_config
from facenet_tpu_torch.ops.preprocessing import augment_draws, augment_with
from facenet_tpu_torch.parallel import launch
from facenet_tpu_torch.parallel.mesh import (batch_rows, copy_to_model,
                                             create_mesh, gather_columns,
                                             gather_rows,
                                             gather_values, group_size,
                                             reduce_from_model, reduce_values,
                                             split_part)
from facenet_tpu_torch.utils import profiling


def create_backbone(model_cfg=None, image_cfg=None):
    """The zoo network a train config selects: `model_cfg` is the
    ``model:`` section ({'module': ..., 'config': {...}}), a zoo name, or
    a bare topology dict (Inception-ResNet-v1, as is no config)."""
    return models.create_model_from_config(model_cfg, image_cfg=image_cfg)


class SoftmaxClassifier(nn.Module):
    """Backbone + identity-logits head: the unnormalized bottleneck into a
    Dense layer with bias (glorot-uniform kernel, zero bias), computed in
    the step's dtype, logits returned in float32.

    On a grid with ``mesh.model > 1`` this rank's head holds the
    model_index-th of `model` equal parts of the kernel's columns and of
    the bias, and returns those columns' logits; its input goes through
    `copy_to_model`.

    :raises ValueError: when C does not split evenly over the model ranks
        (the JAX package's device_put refuses such a head; it is never
        padded)
    """

    def __init__(self, backbone, nrof_classes, mesh=None):
        super().__init__()
        self.backbone = backbone
        self.nrof_classes = int(nrof_classes)
        parts = mesh.model if mesh is not None else 1
        if self.nrof_classes % parts:
            raise ValueError(f'{self.nrof_classes} classes do not split over '
                             f'{parts} model shards')
        self.parts = parts
        self.part = mesh.model_index if parts > 1 else 0
        self.model_group = mesh.model_group if parts > 1 else None
        self.logits = irv1.Dense(backbone.embedding_size,
                                 self.nrof_classes // parts, bias=True)

    @property
    def sharded(self):
        return self.parts > 1

    def forward(self, images, train=False, dtype=torch.bfloat16,
                dropout=None):
        """-> (logits [B, C / model] float32, prelogits [B, D] float32).

        :param dropout: the backbone's dropout mask (an
            Inception-ResNet-v2 in training), None for none"""
        prelogits = self.backbone_forward(images, train, dtype, dropout)
        return self.head(prelogits, dtype), prelogits

    def backbone_forward(self, images, train=False, dtype=torch.bfloat16,
                         dropout=None):
        """The unnormalized bottleneck [B, D] float32."""
        extra = {} if dropout is None else {'dropout': dropout}
        return self.backbone(images, train=train, normalize=False,
                             dtype=dtype, **extra)

    def head(self, prelogits, dtype=torch.bfloat16):
        x = copy_to_model(prelogits.to(dtype), self.model_group)
        return self.logits(x).float()

    def init_variables(self, seed=0):
        """A fresh flax-layout tree of the whole model, the whole head
        included: ``{'params': {'backbone', 'logits'}, 'batch_stats':
        {'backbone'}}`` drawn from numpy's RandomState."""
        rng = np.random.RandomState(seed)
        params, stats = self.backbone.flax_variables(rng)
        dim = self.backbone.embedding_size
        head = {'kernel': irv1.glorot_uniform(rng, (dim, self.nrof_classes)),
                'bias': np.zeros((self.nrof_classes,), np.float32)}
        return {'params': {'backbone': params, 'logits': head},
                'batch_stats': {'backbone': stats}}

    def from_flax_variables(self, variables):
        """Load a flax tree; a whole head is cut to this rank's columns."""
        self.backbone.load_flax(variables['params']['backbone'],
                                variables['batch_stats']['backbone'])
        head = variables['params']['logits']
        if self.sharded and np.shape(head['kernel'])[1] == self.nrof_classes:
            head = {'kernel': np.split(np.asarray(head['kernel']), self.parts,
                                       axis=1)[self.part],
                    'bias': np.split(np.asarray(head['bias']),
                                     self.parts)[self.part]}
        self.logits.load_flax(head)
        return self

    def to_flax_variables(self):
        """The weights as a flax tree; the head is this rank's columns."""
        params, stats = self.backbone.dump_flax()
        head, _ = self.logits.dump_flax()
        return {'params': {'backbone': params, 'logits': head},
                'batch_stats': {'backbone': stats}}


HEAD = ('logits.weight', 'logits.bias')     # split over 'model' by row


def full_state_dict(state):
    """A copy of everything of `state` as one process holds it: the
    model's and Adam's state_dicts with the head and its moments gathered
    whole over the model ranks (a collective: every rank of the grid calls
    it), the centers, the generator's state and the step. This is a
    checkpoint's content, and what `load_full_state_dict` loads on any
    grid."""
    model = state.model
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    adam = state.optimizer.state_dict()
    adam = {'state': {i: {k: v.clone() if isinstance(v, torch.Tensor) else v
                          for k, v in moments.items()}
                      for i, moments in adam['state'].items()},
            'param_groups': copy.deepcopy(adam['param_groups'])}
    if model.sharded:
        for name, index in _head_indices(model):
            weights[name] = gather_values(weights[name].contiguous(),
                                          model.model_group)
            moments = adam['state'].get(index, {})
            for key in ('exp_avg', 'exp_avg_sq'):
                if key in moments:
                    moments[key] = gather_values(moments[key].contiguous(),
                                                 model.model_group)
    centers = None if state.centers is None else state.centers.clone()
    return {'step': int(state.step), 'model': weights, 'optimizer': adam,
            'centers': centers, 'generator': state.generator.get_state()}


def load_full_state_dict(state, saved):
    """Load `full_state_dict`'s content, written on any grid, into `state`
    of any grid, in place: the head and its moments are cut to this
    rank's columns."""
    model = state.model
    weights = dict(saved['model'])
    adam = {'state': {i: dict(v) for i, v in saved['optimizer']
                      ['state'].items()},
            'param_groups': saved['optimizer']['param_groups']}
    if model.sharded:
        def cut(x):
            return split_part(x, 0, model.part, model.parts).clone()
        for name, index in _head_indices(model):
            weights[name] = cut(weights[name])
            moments = adam['state'].get(index, {})
            for key in ('exp_avg', 'exp_avg_sq'):
                if key in moments:
                    moments[key] = cut(moments[key])
    model.load_state_dict(weights)
    state.optimizer.load_state_dict(adam)
    device = next(model.parameters()).device
    centers = saved['centers']
    state.centers = None if centers is None else centers.to(device)
    state.generator.set_state(saved['generator'].cpu())
    state.step = int(saved['step'])
    return state


def _head_indices(model):
    """(name, index among the optimizer's parameters) of the head's."""
    names = [name for name, _ in model.named_parameters()]
    return [(name, names.index(name)) for name in HEAD]


def average_gradients(parameters, group):
    """Every gradient averaged over the group's ranks, in one all_reduce of
    all of them flattened together."""
    n = group_size(group)
    grads = [p.grad for p in parameters if p.grad is not None]
    if n == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    flat /= n
    start = 0
    for g in grads:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()


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
                    remat=False, frozen_bn=False, dtype=torch.bfloat16,
                    mesh=None):
    """step(state, images, labels) -> (state, metrics), moving `state`.

    :param images: [B, H, W, 3] uint8 tensor on the model's device: this
        data rank's rows of the global batch on a grid
    :param labels: [B] int tensor on the same device
    :param mesh: the grid (see the module docstring); None is one device
    :return: metrics, 0-d float32 tensors left on the device: loss,
        cross_entropy, regularization, accuracy, and center_loss /
        triplet_loss when those are on; the global batch's, the same on
        every rank
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
    data_group = mesh.data_group if mesh is not None else None
    n_data = group_size(data_group)
    data_index = mesh.data_index if n_data > 1 else 0

    def forward(model, images, mask):
        if not remat:
            return model(images, train=train, dtype=dtype, dropout=mask)
        backbone = model.backbone
        # the recompute must not move the running statistics a second time
        prelogits = checkpoint(
            lambda x: model.backbone_forward(x, train, dtype, mask),
            images, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                running_stats_frozen(backbone)))
        return model.head(prelogits, dtype), prelogits

    def train_step(state, images, labels):
        with profiling.annotate('train.forward'):
            if random_crop or random_flip:
                # the draws of the global batch, this rank's rows of them
                b, h, w = images.shape[:3]
                draws = augment_draws(state.generator, b * n_data, h, w,
                                      random_crop=random_crop,
                                      random_flip=random_flip,
                                      crop_size=image_size)
                lo = data_index * b
                images = augment_with(
                    images, *(None if d is None else d[lo:lo + b]
                              for d in draws), crop_size=image_size)
            labels = labels.long()
            model = state.model
            mask = None
            if train and hasattr(model.backbone, 'dropout_mask'):
                # the global batch's mask, this rank's rows of it
                b = images.shape[0]
                mask = model.backbone.dropout_mask(b * n_data,
                                                   state.generator)
                if mask is not None:
                    lo = data_index * b
                    mask = mask[lo:lo + b].to(images.device,
                                              non_blocking=True)

            logits, prelogits = forward(model, images, mask)
            if model.sharded:
                # the whole rows of logits, so that the loss and the argmax
                # are log_softmax's and argmax's own arithmetic on them
                group = model.model_group
                logits = gather_columns(logits, group)
                reg = irv1.l2_regularization(model.backbone) + \
                    reduce_from_model(irv1.WEIGHT_DECAY
                                      * model.logits.weight.float().square()
                                      .sum(), group)
            else:
                reg = irv1.l2_regularization(model)
            ce = losses_mod.softmax_cross_entropy_with_logits(logits, labels)
            total = softmax_factor * ce + reg
            metrics = {'cross_entropy': ce, 'regularization': reg}

            new_centers = state.centers
            if state.centers is not None and center_factor > 0:
                c_loss, new_centers = losses_mod.center_loss(
                    prelogits, labels, state.centers, center_alfa,
                    group=data_group)
                total = total + center_factor * c_loss
                metrics['center_loss'] = c_loss

            if triplet_factor > 0:
                emb = prelogits.float()
                emb = emb / torch.sqrt(torch.maximum(
                    emb.square().sum(dim=1, keepdim=True),
                    torch.full((), 1e-10, device=emb.device)))
                t_loss = losses_mod.triplet_semihard_loss(
                    gather_rows(emb, data_group),
                    gather_values(labels, data_group), triplet_margin)
                total = total + triplet_factor * t_loss
                metrics['triplet_loss'] = t_loss

            metrics['accuracy'] = (logits.argmax(dim=1)
                                   == labels).float().mean()
            metrics['loss'] = total

        with profiling.annotate('train.backward'):
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            average_gradients(model.parameters(), data_group)
        with profiling.annotate('train.adam'):
            lr = schedule(state.step)
            for group in state.optimizer.param_groups:
                group['lr'] = lr
            state.optimizer.step()

        state.centers = new_centers
        state.step += 1
        if n_data > 1:
            keys = sorted(metrics)
            means = reduce_values(torch.stack([metrics[k] for k in keys]),
                                  data_group) / n_data
            return state, dict(zip(keys, means.unbind()))
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


class SoftmaxTrainer:
    """Trainer: the model, the step functions, the epoch loop.

    :param cfg: the train config (``image``, ``train``, ``loss``,
        ``profiling``, ``debug`` sections)
    :param nrof_classes: width of the logits head
    :param model_cfg: the ``model:`` section or a bare topology dict
        (default ``cfg.model``)
    :param device: 'cuda' (default; raises without a GPU) or 'cpu'; the
        mesh's device when a mesh is given
    :param dtype: compute dtype, bfloat16 (default), float32 or float64
        (float64 weights too)
    :param mesh: the (data, model) grid (`parallel.mesh.create_mesh`);
        default: the one ``cfg.mesh`` describes over the process group
        (data null = every rank / model), a single device without a group
    """

    def __init__(self, cfg, nrof_classes, model_cfg=None, device=None,
                 dtype=torch.bfloat16, mesh=None):
        self.cfg = cfg
        self.nrof_classes = int(nrof_classes)
        if mesh is None:
            self.device = resolve_device(device)
            mesh = create_mesh(data=cfg.mesh.data, model=cfg.mesh.model,
                               device=self.device)
        else:
            self.device = mesh.device if device is None \
                else resolve_device(device)
        self.mesh = mesh
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
        model = SoftmaxClassifier(backbone, self.nrof_classes,
                                  mesh=self.mesh)
        model.from_flax_variables(model.init_variables(seed))
        master = (torch.float64 if self.dtype == torch.float64
                  else torch.float32)
        model.to(self.device, master)
        irv1.set_batch_group(backbone, self.mesh.data_group)

        center_factor = float(self.cfg.loss.center_factor or 0.0)
        centers = (torch.zeros(self.nrof_classes, backbone.embedding_size,
                               device=self.device, dtype=master)
                   if center_factor > 0 else None)
        optimizer = torch.optim.Adam(model.parameters(),
                                     lr=self.schedule(0), betas=(0.9, 0.999),
                                     eps=self.adam_epsilon)
        generator = torch.Generator().manual_seed(int(seed))
        return TrainState(step=0, model=model, optimizer=optimizer,
                          centers=centers, generator=generator)

    def shard_state(self, source, seed=0):
        """A state of this trainer's grid from `source`: a single-process
        `TrainState` (weights, statistics, Adam, centers, generator and
        step, the head and its moments cut to this rank's columns) or a
        flax variables tree (JAX's carried parameters; Adam and the
        centers start afresh). `full_state_dict` is its inverse."""
        state = self.init_state(seed)
        if isinstance(source, TrainState):
            return load_full_state_dict(state, full_state_dict(source))
        state.model.from_flax_variables(source)
        return state

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
                dtype=self.dtype, mesh=self.mesh)
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
        asynchronous to a GPU): the ``train.place`` span."""
        with profiling.annotate('train.place'):
            images, labels = torch.as_tensor(images), torch.as_tensor(labels)
            if self.device.type == 'cuda' and not images.is_cuda:
                images, labels = images.pin_memory(), labels.pin_memory()
            return (images.to(self.device, non_blocking=True),
                    labels.to(self.device, non_blocking=True))

    def placed_rows(self, images, labels):
        """This data rank's contiguous rows of a global host batch every
        rank holds, placed (`placed`); the whole batch on one device.

        :raises ValueError: when the batch does not split evenly over the
            data ranks
        """
        return self.placed(batch_rows(self.mesh, images),
                           batch_rows(self.mesh, labels))

    def _placed_batches(self, batches, prefetch):
        """(global size, images, labels) with up to `prefetch` batches'
        copies to the device in flight ahead of the consumer; each batch
        is this data rank's rows of a global batch."""
        queue = deque()
        for images, labels in batches:
            queue.append((len(images) * self.mesh.data,
                          *self.placed(images, labels)))
            if len(queue) >= max(int(prefetch), 1):
                yield queue.popleft()
        while queue:
            yield queue.popleft()

    def train_epoch(self, state, batches, epoch, log_every=100,
                    frozen_bn=False):
        """One epoch over an iterable of (images, labels) host batches: on
        a grid, this data rank's rows of each global batch (a loader given
        ``rows=``, `parallel.mesh.batch_rows`).

        Exactly ``train.epoch.size`` batches are drawn: the draw is bounded
        before the prefetch queue, so a pipeline shared across epochs (and
        its checkpointed cursor) never runs past data that was not trained.
        With ``profiling.trace_dir`` set, a torch.profiler trace covers
        steps [start_step, start_step + num_steps) of epoch
        ``profiling.epoch``.

        :param frozen_bn: run this epoch with running-statistics forwards
        :return: (state, metrics of the last step as floats, with
            epoch_time_s, steps and img_per_s); ``self.timer`` is the
            epoch's `StepTimer` (host-issued step times)
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

        timer = profiling.StepTimer(name=f'epoch {epoch} step')
        t0 = time.monotonic()
        metrics, n, seen = None, 0, 0
        for size, images, labels in self._placed_batches(batches, prefetch):
            window.step(epoch, n)
            timer.items_per_step = size
            with timer:
                state, metrics = step(state, images, labels)
            n += 1
            seen += size
            if log_every and n % log_every == 0:
                logger.info(
                    f'epoch {epoch} step {n}/{self.steps_per_epoch} ' +
                    ' '.join(f'{k}={float(v):.4f}'
                             for k, v in metrics.items()))
        window.close()
        self.timer = timer

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


def _state_leaves(state):
    """(name, float64 array) of a state's whole weights, BatchNorm
    statistics and centers, in sorted-name order (a collective on a
    grid)."""
    saved = full_state_dict(state)
    leaves = dict(saved['model'])
    if saved['centers'] is not None:
        leaves['centers'] = saved['centers']
    return [(k, leaves[k].cpu().double().numpy()) for k in sorted(leaves)]


def grid_step_check(device, cfg, nrof_classes, images, labels, grid,
                    model_cfg=None, dtype='float64', atol=0.0):
    """`step_on_grid`'s work on one rank of a process group already formed
    (every rank of the world calls it): the grid's step, then on rank 0
    the same step alone. Returns rank 0's result, None elsewhere.

    :param cfg: the train config (a Config or its dict)
    :param dtype: the compute dtype's name
    """
    dtype = getattr(torch, str(dtype).rsplit('.', 1)[-1])
    cfg = Config(cfg) if not isinstance(cfg, Config) else cfg
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mesh = create_mesh(*grid, device=device)
        result = None
        if mesh.in_grid:
            trainer = SoftmaxTrainer(cfg, nrof_classes, model_cfg=model_cfg,
                                     dtype=dtype, mesh=mesh)
            state = trainer.init_state(seed=0)
            state, metrics = trainer.step_fn(
                state, *trainer.placed_rows(images, labels))
            got = _state_leaves(state)
            metrics = {k: float(v) for k, v in metrics.items()}
            del trainer, state
        if mesh.rank == 0:
            # the same step on one rank of the same world: a 1 x 1 grid
            single = SoftmaxTrainer(cfg, nrof_classes, model_cfg=model_cfg,
                                    dtype=dtype,
                                    mesh=create_mesh(1, 1, device=device))
            state = single.init_state(seed=0)
            start = _state_leaves(state)
            state, want_metrics = single.step_fn(
                state, *single.placed(images, labels))
            want = _state_leaves(state)
            worst, largest = 0.0, 0.0
            for (name, a), (_, b), (_, before) in zip(got, want, start):
                moved = np.abs(b - before).max()
                largest = max(largest, moved)
                worst = max(worst, (np.abs(a - b).max() - atol)
                            / max(moved, 1e-30))
            result = ((metrics, {k: float(v) for k, v in
                                 want_metrics.items()}), worst, largest)
        torch.distributed.barrier()
        return result
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def step_on_grid(cfg, nrof_classes, images, labels, grid, model_cfg=None,
                 dtype=torch.float64, atol=0.0, backend='gloo',
                 device='cuda', timeout=900, threads=None):
    """One train step of ``init_state(seed=0)`` on a (data, model) grid of
    spawned ranks (`parallel.launch.spawn`) and the same step on one rank
    of that world (rank 0 alone, a 1 x 1 grid), cuDNN and cuBLAS kept off
    TF32: the check that the grid's step is the single device's.

    :param images, labels: the global batch (numpy), every rank's
    :param grid: (data, model)
    :param backend: 'gloo' lets several ranks share one card
    :return: ((metrics on the grid, on one rank) as floats, worst,
        largest) as `step_on_devices` defines them, the grid's head
        gathered whole
    """
    data, model = grid
    model_cfg = model_cfg.as_dict if isinstance(model_cfg, Config) \
        else model_cfg
    return launch.spawn(
        grid_step_check, data * model, backend=backend, device=device,
        args=(cfg.as_dict, int(nrof_classes), np.asarray(images),
              np.asarray(labels), (data, model), model_cfg, str(dtype),
              float(atol)),
        timeout=timeout, threads=threads)[0]
