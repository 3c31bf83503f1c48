"""The port's process grid (facenet_tpu_torch/parallel) against the JAX
package's mesh code on its 8 virtual CPU devices (tests/conftest.py).

One group of 4 spawned gloo ranks on the CPU (`parallel.launch.spawn`,
tests/torch_grid_worker.py::parallel_modes) reports:

  * each rank's (data_index, model_index) and groups on six grids, against
    the device positions of JAX's ``devices.reshape(data, model)``;
  * allgather_host_varlen of 1, 2, 3 and 4 values;
  * confusion_counts on a 2-rank grid (metrics 0 and 1, 37 rows that do
    not split evenly), every rank passing the full set (each counts alone,
    no collective) and every rank passing its own stripe (the rows split
    over the ranks; also 12 + 11 rows with non-dense labels, as
    tests/distributed_worker.py); against the port's single-rank counts
    and JAX's sharded counts at atol 1e-5, as tests/test_sharded_eval.py
    holds JAX's; the histograms' totals;
  * evaluate_embeddings(mesh=) on 2 and 4 ranks: rows in order, equal to
    the unsharded rows, the padded rows embedded and trimmed.

Without a group, on one rank of a (2, 2) grid: its rows of a global batch
(`batch_rows`, and a shuffled or P x K loader given them decodes only
those), and its columns of the logits head, the leaves JAX's
`param_shardings` splits over 'model'; `eval_mesh` of a ``mesh:``
section.

The distributed train app runs one TINY epoch through its CLI in this
process (``distributed: {platform: cpu, num_processes: 1}``) and as two
processes with torchrun's environment; without a GPU and without
``--device cpu`` it raises. The embeddings and validate apps run with
``mesh: {data: null}`` as two torchrun-style processes: one file of every
row, equal to one process's.
"""

import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import yaml

from conftest import make_embeddings
from facenet_tpu import statistics as jax_statistics
from facenet_tpu.parallel import mesh as jax_mesh
from facenet_tpu_torch import facenet, statistics
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.dataset import BatchLoader, PKPipeline
from facenet_tpu_torch.parallel import launch
from facenet_tpu_torch.parallel.mesh import (Mesh, batch_rows, create_mesh,
                                             eval_mesh, free_port)
from facenet_tpu_torch.train.softmax import (HEAD, SoftmaxClassifier,
                                             create_backbone)
from facenet_tpu_torch.utils.synthetic import write_identity_dataset
from torch_grid_worker import LAYOUTS, embed, parallel_modes
from torch_testing import few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}, 'output': {'size': 32}}


def _stats_inputs():
    rng = np.random.RandomState(0)
    embs, labels = make_embeddings(rng, nrof_classes=6, images_per_class=21,
                                   dim=32)
    full = [(embs, labels, np.linspace(0, hi, 100)[1:99].astype(np.float32),
             metric) for metric, hi in ((0, 4.0), (1, np.pi))]
    rng = np.random.RandomState(3)
    e37, l37 = make_embeddings(rng, nrof_classes=4, images_per_class=10,
                               dim=16)
    full.append((e37[:37], l37[:37],
                 np.linspace(0.01, 3.9, 10).astype(np.float32), 0))
    rng = np.random.RandomState(0)
    n = 23
    emb = rng.normal(size=(n, 32))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)
           ).astype(np.float32)
    labels = rng.choice([3, 7, 9, 12], size=n)
    local = (emb, labels, np.arange(0.25, 4.0, 0.25, dtype=np.float32),
             [(0, 12), (12, n)])
    return full, local


def _batches():
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 256, (n, 4, 4, 3), dtype=np.uint8),
             rng.randint(0, 3, n).astype(np.int32)) for n in (16, 16, 5, 1)]


@pytest.fixture(scope='module')
def group():
    full, local = _stats_inputs()
    return launch.spawn(parallel_modes, 4, 'gloo', 'cpu',
                        (full, local, _batches()), timeout=200, threads=1)


def test_create_mesh_refuses_more_ranks_than_the_world():
    mesh = create_mesh(device='cpu')
    assert (mesh.data, mesh.model, mesh.data_index, mesh.model_index) == \
        (1, 1, 0, 0)
    assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match='mesh 2x1 needs 2 devices, have 1'):
        create_mesh(2, 1, device='cpu')
    with pytest.raises(ValueError, match='mesh 16x1 needs 16 devices, '
                       'have 8'):
        jax_mesh.create_mesh(16, 1)


def test_batch_and_parameter_placement_of_one_rank():
    """Rank 3 of a (2, 2) grid: rows 4..8 of a global batch of 8 (7 rows
    do not split), and a loader given them decodes only those rows of the
    batches every rank draws; the head's second half of columns, the
    leaves split over 'model' being JAX's `param_shardings`'."""
    mesh = Mesh(data=2, model=2, rank=3, world_size=4,
                device=torch.device('cpu'))
    images = np.arange(8 * 3).reshape(8, 3)
    np.testing.assert_array_equal(batch_rows(mesh, images), images[4:])
    with pytest.raises(ValueError, match='not divisible by 2'):
        batch_rows(mesh, np.zeros(7))
    files = [f'f{i}' for i in range(16)]
    decoded = []

    def load(name):
        decoded.append(name)
        return np.full((2, 2, 3), int(name[1:]), np.uint8)

    every = BatchLoader(files, np.arange(16), load, 8, shuffle=True, seed=3)
    mine = BatchLoader(files, np.arange(16), load, 8, shuffle=True, seed=3,
                       rows=functools.partial(batch_rows, mesh))
    want = [(batch_rows(mesh, x), batch_rows(mesh, y)) for x, y in every]
    decoded.clear()
    got = list(mine)
    assert len(decoded) == 8 and mine.state() == every.state()
    for (x, y), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)

    head = SoftmaxClassifier(create_backbone(TINY), 8, mesh=mesh)
    tree = head.init_variables()
    head.from_flax_variables(tree)
    np.testing.assert_array_equal(head.logits.weight.detach().numpy().T,
                                  tree['params']['logits']['kernel'][:, 4:])
    np.testing.assert_array_equal(head.logits.bias.detach().numpy(),
                                  tree['params']['logits']['bias'][4:])
    specs = jax_mesh.param_shardings(jax_mesh.create_mesh(2, 2),
                                     tree['params'])
    split = {'/'.join(str(k.key) for k in path): list(s.spec).index('model')
             for path, s in jax.tree_util.tree_leaves_with_path(specs)
             if 'model' in s.spec}
    assert split == {'logits/kernel': 1, 'logits/bias': 0}
    assert HEAD == ('logits.weight', 'logits.bias')


def test_pk_pipeline_decodes_only_its_rows():
    """A P x K pipeline given rank 1's rows of a (2, 1) grid draws the
    batches every rank draws and decodes only their second halves."""
    mesh = Mesh(data=2, model=1, rank=1, world_size=2,
                device=torch.device('cpu'))
    classes = [SimpleNamespace(files=[f'c{c}_{i}' for i in range(3)],
                               nrof_images=3) for c in range(5)]
    decoded = []

    def load(name):
        decoded.append(name)
        return np.full((2, 2, 3), len(decoded), np.uint8)

    pk = {'nrof_classes_per_batch': 3, 'nrof_examples_per_class': 2}
    every = PKPipeline(load, classes, Config(pk), seed=5, num_workers=1)
    mine = PKPipeline(load, classes, Config(pk), seed=5, num_workers=1,
                      rows=functools.partial(batch_rows, mesh))
    want = [next(every) for _ in range(3)]
    want_files = [decoded[i * 6 + 3:i * 6 + 6] for i in range(3)]
    decoded.clear()
    got = [next(mine) for _ in range(3)]
    assert decoded == [f for files in want_files for f in files]
    for (_, labels), (_, want_labels) in zip(got, want):
        np.testing.assert_array_equal(labels, want_labels[3:])
    assert mine.state() == every.state()


def test_eval_mesh_of_a_section():
    """data null is every rank of the world; one data rank is no grid."""
    assert eval_mesh(Config(), 'cpu') is None
    assert eval_mesh(Config({'data': None}), 'cpu') is None
    assert eval_mesh(Config({'data': 1}), 'cpu') is None
    with pytest.raises(ValueError, match='mesh 2x1 needs 2 devices'):
        eval_mesh(Config({'data': 2}), 'cpu')


@pytest.mark.parametrize('grid', LAYOUTS, ids=str)
def test_rank_layout_is_jax_reshape(group, grid):
    """Rank r stands where JAX's mesh puts device r; its data group is
    that device's column, its model group its row."""
    devices = np.vectorize(lambda d: d.id)(
        jax_mesh.create_mesh(*grid).devices)
    for rank, result in enumerate(group):
        d_index, m_index, in_grid, data_group, model_group = \
            result['layout'][grid]
        assert in_grid == (rank < devices.size)
        if not in_grid:
            assert data_group is None and model_group is None
            continue
        (d,), (m,) = np.nonzero(devices == rank)
        assert (d_index, m_index) == (d, m)
        column, row = list(devices[:, m]), list(devices[d, :])
        assert data_group == (column if len(column) > 1 else None)
        assert model_group == (row if len(row) > 1 else None)


def test_allgather_host_varlen_of_uneven_lengths(group):
    want = np.concatenate([np.arange(r + 1) + 10 * r for r in range(4)])
    for result in group:
        np.testing.assert_array_equal(result['varlen'], want)


@pytest.mark.parametrize('case', ['metric 0', 'metric 1', '37 rows'])
def test_sharded_counts_match_one_rank_and_jax(group, case):
    """Both row conventions: every rank passing the full set, and every
    rank passing its half of the rows (19 + 18 of 37)."""
    index = ['metric 0', 'metric 1', '37 rows'].index(case)
    emb, labels, thr, metric = _stats_inputs()[0][index]
    single = statistics.confusion_counts(emb, labels, thr, metric=metric,
                                         device='cpu')
    jax = jax_statistics.confusion_counts(
        emb, labels, thr, metric=metric,
        mesh=jax_mesh.create_mesh(data=8, model=1))
    for rank in (0, 1):
        for key in ('counts', 'striped'):
            for got, one, want in zip(group[rank][key][index], single, jax):
                np.testing.assert_allclose(got, one, atol=1e-5)
                np.testing.assert_allclose(got, want, atol=1e-5)
    assert 'counts' not in group[2]         # beyond the 2-rank grid


def test_sharded_histogram_totals(group):
    """Every class pair weighs the same: C positive, C(C-1)/2 negative
    (the per-pair weights are float32, as JAX's: rtol 1e-6)."""
    hist_pos, hist_neg = group[0]['totals']
    np.testing.assert_allclose(hist_pos.sum(), 6, rtol=1e-6)
    np.testing.assert_allclose(hist_neg.sum(), 15, rtol=1e-6)
    np.testing.assert_array_equal(hist_pos, group[1]['totals'][0])


def test_full_set_on_every_rank_counts_alone(group):
    """A grid whose ranks each pass the full set runs the one-rank counts
    on every rank, with no collective."""
    for rank in (0, 1):
        assert group[rank]['full set collectives'] == 0
        for (emb, labels, thr, metric), got in zip(_stats_inputs()[0],
                                                   group[rank]['counts']):
            single = statistics.confusion_counts(emb, labels, thr,
                                                 metric=metric, device='cpu')
            for a, b in zip(got, single):
                np.testing.assert_allclose(a, b, atol=1e-5)


def test_each_rank_passing_its_own_stripe(group):
    """12 + 11 rows with labels 3, 7, 9, 12: the label values are agreed
    over the ranks before they are densified; the counts are those of the
    whole set on one rank and on JAX's mesh."""
    emb, labels, thr, _ = _stats_inputs()[1]
    single = statistics.confusion_counts(emb, labels, thr, device='cpu')
    jax = jax_statistics.confusion_counts(
        emb, labels, thr, mesh=jax_mesh.create_mesh(data=8, model=1))
    for rank in (0, 1):
        for got, one, want in zip(group[rank]['local'], single, jax):
            np.testing.assert_allclose(got, one, atol=1e-5)
            np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('grid', [(2, 1), (4, 1)], ids=str)
def test_sharded_extraction_keeps_order_and_trims_padding(group, grid):
    """Batches of 16, 16, 5 and 1 over 2 or 4 ranks: every rank gets every
    row, in order, equal to the unsharded rows; each rank embedded
    ceil(n / data) rows of each batch, its padding included."""
    batches = _batches()
    want, want_labels = facenet.evaluate_embeddings(embed, batches,
                                                    renormalize=False)
    data = grid[0]
    per_rank = sum(-(-len(images) // data) for images, _ in batches)
    for rank in range(data):
        got, labels, rows = group[rank]['forward'][grid]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(labels, want_labels)
        assert rows == per_rank


# ---------------------------------------------------------------------------
# the distributed train app

@pytest.fixture(scope='module')
def identity_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('identities')
    write_identity_dataset(root / 'train', 4, 6, size=160, seed=0)
    write_identity_dataset(root / 'test', range(4, 8), 4, size=160, seed=1)
    return root


def _app_config(root, run_dir, **distributed):
    return {
        'dataset': {'path': str(root / 'train')},
        'model': {'path': str(run_dir), 'config': TINY},
        'batch_size': 8,
        'seed': 0,
        'train': {'adam_epsilon': 0.1,
                  'epoch': {'max_nrof_epochs': 1, 'size': 1},
                  'learning_rate': {'schedule': [[1, 0.01]]}},
        'loss': {'center_factor': 0.1, 'triplet_factor': 0.0},
        'image': {'size': 160, 'normalization': 0, 'random_flip': True},
        'checkpoint': {'max_to_keep': 1},
        'distributed': distributed,
        'validate': {'every_n_epochs': 1,
                     'dataset': {'path': str(root / 'test')},
                     'validate': {'metric': 0, 'nrof_folds': 2,
                                  'far_target': 0.1}},
    }


def _check_run(run_root):
    runs = list(run_root.glob('*'))
    assert len(runs) == 1, runs
    run = runs[0]
    report = (run / 'logs' / 'report.txt').read_text()
    assert 'epoch [1/1]' in report and 'MaximumAccuracy' in report
    assert report.count('FaceToFaceValidation') == 1
    assert (run / 'model.yaml').is_file() and (run / 'params.msgpack').is_file()
    assert [p.name for p in (run / 'checkpoints').iterdir()] == ['1']
    return run


def test_distributed_app_as_one_process(identity_tree, tmp_path):
    from facenet_tpu_torch.apps.train_softmax_distributed import main

    cfg_file = tmp_path / 'cpu.yaml'
    cfg_file.write_text(yaml.safe_dump(_app_config(
        identity_tree, tmp_path / 'run', platform='cpu', num_processes=1)))
    state = main(['--config', str(cfg_file)])
    assert state.step == 1
    _check_run(tmp_path / 'run')
    assert not torch.distributed.is_initialized()

    if not torch.cuda.is_available():
        cfg_file = tmp_path / 'card.yaml'
        cfg_file.write_text(yaml.safe_dump(_app_config(
            identity_tree, tmp_path / 'card_run')))
        with pytest.raises(RuntimeError, match='CUDA'):
            main(['--config', str(cfg_file)])
        assert not (tmp_path / 'card_run').exists()


def _torchrun(args, world_size=2):
    """`python args...` as `world_size` processes with the environment
    torchrun gives its ranks; their outputs, rank 0 first."""
    port = str(free_port())
    procs = []
    for rank in range(world_size):
        env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
        env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world_size), MASTER_ADDR='127.0.0.1',
                   MASTER_PORT=port, OMP_NUM_THREADS='1')
        procs.append(subprocess.Popen(
            [sys.executable, *args], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=240)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for proc, out in zip(procs, outputs):
        assert proc.returncode == 0, out[-3000:]
    return outputs


_EXTRACT_AND_VALIDATE = """
import sys
from facenet_tpu_torch.apps import embeddings, validate
embeddings.main(['--config', sys.argv[1], '--device', 'cpu'])
validate.main(['--config', sys.argv[1], '--device', 'cpu'])
"""


def test_embeddings_and_validate_apps_as_two_torchrun_ranks(identity_tree,
                                                            tmp_path):
    """`mesh: {data: null}` under two torchrun ranks: the extraction
    splits over both; rank 0 writes one file of every row, equal to the
    one process's, and one report."""
    from facenet_tpu_torch import export, h5utils
    from facenet_tpu_torch.apps import embeddings
    from facenet_tpu_torch.models.inception_resnet_v1 import (
        InceptionResnetV1, init_variables)

    bundle = tmp_path / 'tiny'
    export.save_model(bundle, InceptionResnetV1(config=TINY)
                      .from_flax_variables(init_variables(TINY, seed=2)))
    data = tmp_path / 'faces'
    shutil.copytree(identity_tree / 'test', data)
    cfg = {'dataset': {'path': str(data)}, 'model': {'path': str(bundle)},
           'batch_size': 5, 'mesh': {'data': None},
           'validate': {'metric': 1, 'nrof_folds': 2, 'far_target': 0.1}}
    cfg_file = tmp_path / 'apps.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg))
    _torchrun(['-c', _EXTRACT_AND_VALIDATE, str(cfg_file)])
    out = Path(f'{data}_tiny')
    grid_rows = h5utils.read(out / 'embeddings.h5', 'embeddings')
    grid_report = (out / 'validate.txt').read_text()

    shutil.rmtree(out)
    one = embeddings.main(['--config', str(cfg_file), '--device', 'cpu'])
    assert one.mesh is None
    np.testing.assert_allclose(grid_rows, one.embeddings, atol=1e-6)
    np.testing.assert_array_equal(
        h5utils.read(out / 'embeddings.h5', 'labels'), one.labels)
    assert grid_rows.shape == (16, 32)
    assert grid_report.count('FaceToFaceValidation') == 1
    assert 'Accuracy:' in grid_report


def test_distributed_app_as_two_torchrun_ranks(identity_tree, tmp_path):
    """Two processes with the environment torchrun gives its ranks: each
    loads its 4 rows of the global batch of 8, the validation's extraction
    splits over both, rank 0 writes the one run directory."""
    cfg_file = tmp_path / 'two.yaml'
    cfg_file.write_text(yaml.safe_dump(_app_config(identity_tree,
                                                   tmp_path / 'run')))
    outputs = _torchrun(['-m',
                         'facenet_tpu_torch.apps.train_softmax_distributed',
                         '--config', str(cfg_file), '--device', 'cpu'])
    assert 'devices: 2 (1 local, process 0/2) on cpu' in outputs[0]
    assert 'devices: 2 (1 local, process 1/2) on cpu' in outputs[1]
    _check_run(tmp_path / 'run')
