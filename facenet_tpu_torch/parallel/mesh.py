"""The (data, model) process grid and its collectives.

The JAX package's ``facenet_tpu/parallel/mesh.py`` builds a
``jax.sharding.Mesh`` with the axes 'data' (the batch is split over it) and
'model' (the identity-logits head's columns are split over it), and XLA
inserts the collectives. Here every rank is one process on one device, the
grid is a `Mesh` over the first ``data * model`` ranks of the
torch.distributed world, laid out row-major as JAX's ``devices.reshape(data,
model)``:

    rank = data_index * model + model_index

The data group of a rank is the ranks that share its model_index (they hold
the same head columns and different rows of the batch); its model group the
ranks that share its data_index (the same rows, different columns). A group
of one rank is None and every collective on it is skipped, so a 1 x 1 grid
computes exactly what the single-process code computes.

Collectives the training step differentiates through, and how their
gradient flows:

  * `sum_over` (data group): the sum forward, the sum of the gradients
    backward (the exact adjoint: a rank's input reaches every rank's sum);
  * `gather_rows` (data group): the ranks' rows concatenated forward, this
    rank's rows of the summed gradient backward (the exact adjoint);
  * `copy_to_model` / `reduce_from_model` / `gather_columns` (model
    group): the f / g pair of a column-parallel layer. f is the identity
    forward and sums the gradient backward; g sums (or concatenates the
    columns) forward and passes the gradient (or this rank's slice of it)
    through. A loss every model rank computes in full is thereby
    differentiated once, not once per model rank.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from facenet_tpu_torch.config import value_or
from facenet_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the (data, model) grid.

    `local_rows` says which rows a caller of the pair statistics passes:
    False, every rank passes the full set (an app that loads the whole
    evaluation set on every rank), and every rank counts all pairs itself
    with no collective; True, every rank passes its own stripe (a
    multi-process caller that loaded only its rows), and the pairs split
    over the data ranks (`parallel.sharded_eval`).
    """
    data: int
    model: int
    rank: int
    world_size: int
    device: torch.device
    data_group: object = None
    model_group: object = None
    local_rows: bool = False

    @property
    def data_index(self):
        return self.rank // self.model

    @property
    def model_index(self):
        return self.rank % self.model

    @property
    def in_grid(self):
        """False on a rank of the world beyond the grid's data * model."""
        return self.rank < self.data * self.model


def world():
    """(world size, rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_mesh(data=None, model=1, device=None, local_rows=False):
    """The (data, model) grid over the first data * model ranks.

    Every rank of the world calls it, in the same order as every other
    collective: the groups are made here.

    :param data: data-parallel shards (default: world size // model)
    :param model: model-parallel shards of the logits head
    :param device: this rank's device (default 'cuda', the current card)
    :raises ValueError: when data * model exceeds the world size
    """
    size, rank = world()
    model = int(model or 1)
    data = int(data) if data else size // model
    if data * model > size:
        raise ValueError(
            f'mesh {data}x{model} needs {data * model} devices, have {size}')

    def group_of(ranks):
        # every rank makes every group, members or not, in one order
        ranks = list(ranks)
        made = dist.new_group(ranks) if len(ranks) > 1 else None
        return made if rank in ranks else None

    data_group = model_group = None
    for m in range(model):
        made = group_of(d * model + m for d in range(data))
        if made is not None:
            data_group = made
    for d in range(data):
        made = group_of(d * model + m for m in range(model))
        if made is not None:
            model_group = made
    return Mesh(data=data, model=model, rank=rank, world_size=size,
                device=resolve_device(device), data_group=data_group,
                model_group=model_group, local_rows=bool(local_rows))


def eval_mesh(section, device=None):
    """The data-parallel grid of an evaluation's ``mesh:`` section (data
    null = every rank of the world, model 1), made by every rank; None
    without the section or with one data rank."""
    if not section:
        return None
    n_data = int(value_or(section.data, world()[0]))
    if n_data <= 1:
        return None
    return create_mesh(data=n_data, model=1, device=device)


def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group):
    return 0 if group is None else dist.get_rank(group)


def comm_device(group):
    """Where a group's host-side exchanges are staged: the current card for
    NCCL, which takes CUDA tensors only; the CPU otherwise."""
    if dist.get_backend(group) == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _all_gather(x, group):
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, reuse):
        ctx.group = group
        if reuse is not None:
            return reuse.clone()
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return torch.cat(_all_gather(x, group))

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        start = group_rank(ctx.group) * ctx.rows
        return grad[start:start + ctx.rows], None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.columns = group, x.shape[1]
        return torch.cat(_all_gather(x, group), dim=1)

    @staticmethod
    def backward(ctx, grad):
        start = group_rank(ctx.group) * ctx.columns
        return grad[:, start:start + ctx.columns].contiguous(), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(x, group, reuse=None):
    """The sum of `x` over the group's ranks; its gradient is summed over
    them as well (the exact adjoint). `reuse`, the sum an earlier forward
    of the same step made (a checkpointed forward's recompute), is returned
    instead of reducing again; the gradient is reduced all the same."""
    return x if group is None else _SumOver.apply(x, group, reuse)


def gather_rows(x, group):
    """Every rank's `x` (equal shapes) concatenated along dim 0 in rank
    order; the gradient of this rank's rows is their part of the gradient
    summed over the ranks."""
    return x if group is None else _GatherRows.apply(x, group)


def gather_columns(x, group):
    """Every model rank's columns of `x` (equal widths) side by side in
    rank order. A loss every model rank computes in full from them is
    differentiated once: the gradient of this rank's columns is their
    slice of its gradient, with no collective."""
    return x if group is None else _GatherColumns.apply(x, group)


def copy_to_model(x, group):
    """f of a column-parallel layer: the identity, with the gradient
    summed over the model group."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """g of a column-parallel layer: the sum over the model group, with the
    gradient passed through."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_values(x, group):
    """Every rank's `x` concatenated along dim 0, without a gradient."""
    if group is None:
        return x
    return torch.cat(_all_gather(x, group))


def reduce_values(x, group, op=dist.ReduceOp.SUM):
    """`x` reduced over the group, without a gradient (a new tensor)."""
    x = x.detach().clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def batch_rows(mesh, x):
    """This data rank's contiguous rows of `x` (an array or a tensor), a
    global batch every rank holds: rows [data_index * B / data,
    (data_index + 1) * B / data).

    :raises ValueError: when the batch does not split evenly over 'data'
    """
    size = len(x)
    if size % mesh.data:
        raise ValueError(f'global batch {size} not divisible by '
                         f'{mesh.data} data shards')
    per = size // mesh.data
    return x[mesh.data_index * per:(mesh.data_index + 1) * per]


def split_part(x, dim, index, parts):
    """Part `index` of `parts` equal parts of `x` along `dim`."""
    if x.shape[dim] % parts:
        raise ValueError(f'{x.shape[dim]} columns do not split over '
                         f'{parts} model shards')
    return x.chunk(parts, dim=dim)[index]


def allgather_host_varlen(x, group):
    """A 1-D host array of per-rank length, gathered over `group`: the
    concatenation in rank order, on every rank. Lengths are agreed first
    and the arrays padded to the longest."""
    x = np.asarray(x)
    if group is None:
        return x
    device = comm_device(group)
    lengths = gather_values(
        torch.tensor([x.shape[0]], dtype=torch.int64, device=device),
        group).cpu().numpy()
    padded = np.zeros((int(lengths.max()),), x.dtype)
    padded[:x.shape[0]] = x
    parts = gather_values(torch.from_numpy(padded).to(device)[None],
                          group).cpu().numpy()
    return np.concatenate([parts[r, :int(n)] for r, n in enumerate(lengths)])


def broadcast_object(value, src=0):
    """`value` of rank `src` on every rank (itself without a group)."""
    if world()[0] == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier():
    if world()[0] > 1:
        dist.barrier()


def free_port():
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, platform=None, backend=None,
                     device=None, timeout=None):
    """Join the process group; returns this process's device.

    With `coordinator_address` ('host:port'), `num_processes` and
    `process_id` (the JAX package's ``distributed:`` keys) the group meets
    at ``tcp://coordinator_address``; without them at the ``env://`` that
    torchrun sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); a single
    process with neither meets itself on a free local port.

    :param platform: 'cpu' runs on the CPU over gloo
    :param backend: the collectives' backend; default NCCL on a card, gloo
        on the CPU. gloo with CUDA tensors lets two ranks share one card,
        which NCCL refuses
    :param device: 'cuda' (default; the card LOCAL_RANK names, before the
        group comes up) or 'cpu'; raises without a GPU unless 'cpu'
    :param timeout: seconds a collective may wait before it raises
    """
    import datetime

    if str(platform or '') == 'cpu':
        device = 'cpu'
    device = resolve_device(device)
    backend = backend or ('gloo' if device.type == 'cpu' else 'nccl')
    env = os.environ
    if coordinator_address:
        init_method = f'tcp://{coordinator_address}'
        size, rank = int(num_processes), int(process_id)
    elif 'WORLD_SIZE' in env:
        init_method = 'env://'
        size, rank = int(env['WORLD_SIZE']), int(env['RANK'])
    else:
        size, rank = int(num_processes or 1), 0
        if size != 1:
            raise ValueError(f'{size} processes need a coordinator_address '
                             'or the environment torchrun sets')
        init_method = f'tcp://127.0.0.1:{free_port()}'
    if device.type == 'cuda':
        local = int(env.get('LOCAL_RANK', rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        device = torch.device('cuda', local)
    kwargs = {}
    if timeout:
        kwargs['timeout'] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank, **kwargs)
    return device


def join_torchrun(device=None):
    """`init_distributed` when this process was started by torchrun (the
    environment names a world) and no group exists yet; returns the
    device. An app run alone stays a single process."""
    device = resolve_device(device)
    if 'WORLD_SIZE' in os.environ and not dist.is_initialized():
        device = init_distributed(device=device)
    return device
