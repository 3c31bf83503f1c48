"""Rank-side functions of the port's grid tests (not collected by pytest:
`facenet_tpu_torch.parallel.launch.spawn` runs them in each spawned rank,
which imports this module and neither JAX nor facenet_tpu).

  parallel_modes — the grid's layout, allgather_host_varlen, the pair
                   statistics under both row conventions and sharded
                   extraction, on a 4-rank world;
  grid_modes     — one train step on the (2,1), (1,2) and (2,2) grids for
                   each loss and dtype, a checkpoint written on (2,2) and
                   the next step, shard_state's inverse.
"""

import numpy as np
import torch
import torch.distributed as dist

from facenet_tpu_torch import facenet, statistics
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.parallel import mesh as mesh_mod
from facenet_tpu_torch.parallel.sharded_eval import sharded_pair_histograms
from facenet_tpu_torch.train.checkpoint import CheckpointManager
from facenet_tpu_torch.train.softmax import (SoftmaxClassifier,
                                             SoftmaxTrainer, create_backbone,
                                             full_state_dict,
                                             load_full_state_dict)

LAYOUTS = [(2, 2), (4, 1), (1, 4), (2, 1), (1, 2), (3, 1)]


def _members(group):
    return None if group is None else dist.get_process_group_ranks(group)


def embed(images):
    """A deterministic per-row forward: 16 features of each image."""
    flat = torch.as_tensor(images).reshape(len(images), -1).double()
    out = flat[:, :48] @ torch.linspace(-1, 1, 48 * 16,
                                        dtype=torch.float64).reshape(48, 16)
    embed.rows += len(images)
    return out.float()


embed.rows = 0


def parallel_modes(device, stats_cases, local_case, batches):
    out = {'layout': {}}
    for grid in LAYOUTS:
        m = mesh_mod.create_mesh(*grid, device=device)
        out['layout'][grid] = (m.data_index, m.model_index, m.in_grid,
                               _members(m.data_group),
                               _members(m.model_group))
    four = mesh_mod.create_mesh(4, 1, device=device)
    rank = four.rank
    out['varlen'] = mesh_mod.allgather_host_varlen(
        np.arange(rank + 1) + 10 * rank, four.data_group)

    two = mesh_mod.create_mesh(2, 1, device=device)
    local = mesh_mod.create_mesh(2, 1, device=device, local_rows=True)
    if two.in_grid:
        # every rank passes the full set: each counts alone, no collective
        sharded = statistics.sharded_pair_histograms
        calls = []
        statistics.sharded_pair_histograms = \
            lambda *a: calls.append(a) or sharded(*a)
        try:
            out['counts'] = [statistics.confusion_counts(
                emb, labels, thr, metric=metric, mesh=two)
                for emb, labels, thr, metric in stats_cases]
        finally:
            statistics.sharded_pair_histograms = sharded
        out['full set collectives'] = len(calls)
        # every rank passes its own stripe: the rows split over the ranks
        out['striped'] = []
        for emb, labels, thr, metric in stats_cases:
            half = -(-len(emb) // 2)
            rows = slice(0, half) if local.rank == 0 else slice(half, None)
            out['striped'].append(statistics.confusion_counts(
                emb[rows], labels[rows], thr, metric=metric, mesh=local))
        emb, labels, _, _ = stats_cases[0]
        dense = np.unique(labels, return_inverse=True)[1]
        half = len(emb) // 2
        rows = slice(0, half) if local.rank == 0 else slice(half, None)
        out['totals'] = sharded_pair_histograms(
            emb[rows], dense[rows], [1.0, 2.0], len(np.unique(labels)), 0,
            local)
        emb, labels, thr, stripes = local_case
        lo, hi = stripes[local.rank]
        out['local'] = statistics.confusion_counts(
            emb[lo:hi], labels[lo:hi], thr, metric=0, mesh=local)
    out['forward'] = {}
    for grid in ((2, 1), (4, 1)):
        m = mesh_mod.create_mesh(*grid, device=device)
        if not m.in_grid:
            continue
        embed.rows = 0
        got = facenet.evaluate_embeddings(embed, batches, renormalize=False,
                                          mesh=m)
        out['forward'][grid] = (got[0], got[1], embed.rows)
    return out


def _trainer(cfg, nrof_classes, tiny, dtype, mesh):
    return SoftmaxTrainer(Config(cfg), nrof_classes, model_cfg=tiny,
                          dtype=getattr(torch, dtype), mesh=mesh)


def _tree(saved, tiny, nrof_classes):
    """A full state's (`full_state_dict`) weights as a flax tree of numpy
    arrays, the centers beside them."""
    model = SoftmaxClassifier(create_backbone(tiny), nrof_classes)
    model.to(next(iter(saved['model'].values())).dtype)
    model.load_state_dict(saved['model'])
    tree = model.to_flax_variables()
    tree['centers'] = (None if saved['centers'] is None
                       else saved['centers'].double().numpy())
    return tree


def grid_modes(device, cfgs, remat_cfg, variables, batch, next_batch, tiny,
               nrof_classes, checkpoint_dir, float32_grids):
    """{(grid, loss, dtype): (metrics, tree)} from the grid's rank 0, the
    float32 steps on `float32_grids` alone; the checkpoint and shard_state
    checks of the (2, 2) grid; the (2, 1) float64 softmax + center step
    under remat."""
    out = {}
    for grid in ((2, 1), (1, 2), (2, 2)):
        mesh = mesh_mod.create_mesh(*grid, device=device)
        if not mesh.in_grid:
            continue
        if grid == (2, 1):
            trainer = _trainer(remat_cfg, nrof_classes, tiny, 'float64',
                               mesh)
            state, metrics = trainer.step_fn(
                trainer.shard_state(variables),
                *trainer.placed_rows(*batch['softmax + center']))
            out['remat'] = ({k: float(v) for k, v in metrics.items()},
                            _tree(full_state_dict(state), tiny,
                                  nrof_classes))
        for (loss, dtype), cfg in cfgs.items():
            if dtype == 'float32' and grid not in float32_grids:
                continue
            trainer = _trainer(cfg, nrof_classes, tiny, dtype, mesh)
            state = trainer.shard_state(variables)
            images, labels = batch[loss]
            state, metrics = trainer.step_fn(
                state, *trainer.placed_rows(images, labels))
            saved = full_state_dict(state)
            out[grid, loss, dtype] = ({k: float(v) for k, v in
                                       metrics.items()},
                                      _tree(saved, tiny, nrof_classes))
            if grid != (2, 2) or (loss, dtype) != ('softmax + center',
                                                   'float64'):
                continue
            # a checkpoint written on (2, 2), then the next step here
            manager = CheckpointManager(checkpoint_dir)
            manager.save(state.step, state)
            state, metrics = trainer.step_fn(
                state, *trainer.placed_rows(*next_batch))
            out['next'] = ({k: float(v) for k, v in metrics.items()},
                           _tree(full_state_dict(state), tiny,
                                 nrof_classes))
            restored = manager.restore(trainer.init_state(seed=1))
            out['restored'] = _same(full_state_dict(restored), saved)
            # shard_state of a single-process state that holds the grid's
            # whole state (Adam's moments included), gathered back
            one = _trainer(cfg, nrof_classes, tiny, dtype,
                           mesh_mod.create_mesh(1, 1, device=device))
            one = load_full_state_dict(one.init_state(seed=2), saved)
            out['gathered'] = _same(
                full_state_dict(trainer.shard_state(one)), saved)
    return out if mesh_mod.world()[1] == 0 else None


def _same(a, b):
    """Whether two `full_state_dict`s hold the same values, exactly."""
    def flat(tree, path=''):
        if isinstance(tree, dict):
            for key in sorted(tree, key=str):
                yield from flat(tree[key], f'{path}/{key}')
        elif isinstance(tree, (list, tuple)):
            for i, item in enumerate(tree):
                yield from flat(item, f'{path}/{i}')
        else:
            yield path, tree

    left, right = list(flat(a)), list(flat(b))
    if [p for p, _ in left] != [p for p, _ in right]:
        return False
    for (_, x), (_, y) in zip(left, right):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x.cpu(), torch.as_tensor(y).cpu()):
                return False
        elif x != y:
            return False
    return True
