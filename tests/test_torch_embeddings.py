"""Embedding extraction in the port against the JAX package, on the CPU
with a TINY IRv1 bundle: `split_embeddings` and `Embeddings`, the
embeddings app (h5, npz, TFRecord, and its pipeline mode) run through
both packages' CLIs, and `BatchLoader`'s order, shuffle and resume."""

import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml
from click.testing import CliRunner
from PIL import Image

from facenet_tpu import dataset as jax_dataset
from facenet_tpu import export as jax_export
from facenet_tpu import facenet as jax_facenet
from facenet_tpu import h5utils as jax_h5utils
from facenet_tpu.apps.embeddings import main as jax_main
from facenet_tpu.config import Config as JaxConfig
from facenet_tpu.models.inception_resnet_v1 import \
    InceptionResnetV1 as JaxIRv1
from facenet_tpu.utils.synthetic import render_scene
from facenet_tpu.utils.tfrecord import TFRecord as JaxTFRecord
from facenet_tpu_torch import dataset, facenet, h5utils
from facenet_tpu_torch.apps.embeddings import main
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.models.inception_resnet_v1 import init_variables
from facenet_tpu_torch.utils.tfrecord import TFRecord
from span_recording import spans  # noqa: F401
from torch_testing import few_threads  # noqa: F401

TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}, 'output': {'size': 32}}


@pytest.fixture(scope='module')
def bundles(tmp_path_factory):
    """One TINY bundle under two names, so the two packages' apps write to
    different output directories (``<dataset>_<model stem>``)."""
    root = tmp_path_factory.mktemp('model')
    jax_export.save_model(root / 'port', JaxIRv1(config=TINY),
                          init_variables(TINY, seed=0))
    shutil.copytree(root / 'port', root / 'jax')
    return root / 'port', root / 'jax'


@pytest.fixture(scope='module')
def face_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('aligned')
    rng = np.random.RandomState(0)
    for c in range(4):
        d = root / f'id_{c:02d}'
        d.mkdir()
        base = rng.randint(0, 255, (160, 160, 3)).astype(np.float32)
        for i in range(6):
            img = np.clip(base + rng.randn(160, 160, 3) * 8, 0,
                          255).astype(np.uint8)
            Image.fromarray(img).save(d / f'{i:04d}.png')
    return root


def _run_both(tmp_path, cfg, bundles):
    """The port's app (--device cpu) and JAX's on the same config, each
    with its own bundle name; returns (port result, JAX CLI output, the
    two output directories)."""
    port_bundle, jax_bundle = bundles
    files = []
    for name, bundle in (('port', port_bundle), ('jax', jax_bundle)):
        file = tmp_path / f'{name}.yaml'
        file.write_text(yaml.safe_dump(
            {**cfg, 'model': {**cfg.get('model', {}), 'path': str(bundle)}}))
        files.append(file)
    result = main(['--config', str(files[0]), '--device', 'cpu'])
    run = CliRunner().invoke(jax_main, ['--config', str(files[1])])
    assert run.exit_code == 0, run.output
    data = cfg['dataset']['path']
    return (result, run.output, Path(f'{data}_{port_bundle.stem}'),
            Path(f'{data}_{jax_bundle.stem}'))


def _read(path):
    """(embeddings, labels, files or None) of an embeddings file, each
    container through the reader of its own package."""
    if path.suffix == '.h5':
        return (h5utils.read(path, 'embeddings'), h5utils.read(path, 'labels'),
                None)
    if path.suffix == '.npz':
        data = np.load(path)
        return data['embeddings'], data['labels'], list(data['files'])
    record = TFRecord(path)
    return record.embeddings, record.labels, record.files


def _read_jax(path):
    if path.suffix == '.h5':
        return (jax_h5utils.read(path, 'embeddings'),
                jax_h5utils.read(path, 'labels'), None)
    if path.suffix == '.npz':
        return _read(path)
    record = JaxTFRecord(path)
    return record.embeddings, record.labels, record.files


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize('suffix', ['.h5', '.npz', '.tfrecord'])
def test_embeddings_app_matches_jax(face_tree, bundles, tmp_path, suffix):
    cfg = {'dataset': {'path': str(face_tree)}, 'batch_size': 10,
           'suffix': suffix}
    _, _, port_dir, jax_dir = _run_both(tmp_path, cfg, bundles)
    got = _read(port_dir / f'embeddings{suffix}')
    want = _read_jax(jax_dir / f'embeddings{suffix}')
    assert got[0].shape == want[0].shape == (24, 32)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    if suffix != '.h5':
        assert got[2] == [str(p) for p in sorted(face_tree.glob('*/*.png'))]
    # the app default is the raw bottleneck (model.normalization: false)
    assert _cos(got[0], want[0]).min() >= 0.999
    ratio = np.linalg.norm(got[0], axis=1) / np.linalg.norm(want[0], axis=1)
    assert np.abs(ratio - 1).max() <= 0.02
    assert np.abs(np.linalg.norm(got[0], axis=1) - 1).max() > 0.02
    assert (port_dir / 'log.txt').exists()
    assert (port_dir / 'embeddings.yaml').exists()


def test_embeddings_app_pipeline_mode_matches_jax(bundles, tmp_path):
    raw = tmp_path / 'scenes'
    rng = np.random.RandomState(42)
    for c in range(2):
        d = raw / f'id_{c:02d}'
        d.mkdir(parents=True)
        for i in range(2):
            img, _, _ = render_scene(rng, shape=(256, 256), n_faces=1,
                                     min_face=90, max_face=150)
            Image.fromarray(img).save(d / f'{i}.png')
    cfg = {'dataset': {'path': str(raw)},
           'model': {'normalization': True},
           'batch_size': 4, 'suffix': '.npz',
           'pipeline': {'image_shape': [256, 256], 'align': 'crop'}}
    result, output, port_dir, jax_dir = _run_both(tmp_path, cfg, bundles)
    got = _read(port_dir / 'embeddings.npz')
    want = _read(jax_dir / 'embeddings.npz')
    assert f'scenes without a detected face: {result.dropped}' in output
    assert got[2] == want[2] == result.files
    assert len(got[2]) >= 1
    np.testing.assert_array_equal(got[1], want[1])
    # The two packages' bf16 cascades place these faces' boxes up to 2.1 px
    # apart (a float32 cascade lies 1.6 px from JAX's and 2.1 px from the
    # port's), and the TINY net maps such crops at cosine 0.991-0.999; on
    # the same boxes, crop and embedding agree at cosine >= 0.99998.
    assert _cos(got[0], want[0]).min() >= 0.99
    np.testing.assert_allclose(np.linalg.norm(got[0], axis=1), 1.0,
                               atol=1e-3)


def test_kept_rows_drops_scenes_without_a_face():
    from facenet_tpu_torch.apps.embeddings import kept_rows
    emb = np.arange(4 * 2 * 3, dtype=np.float32).reshape(4, 2, 3)
    valid = np.array([[True, False], [False, True], [True, True],
                      [False, False]])
    kept, labels, files, dropped = kept_rows(emb, valid, [5, 6, 7, 8],
                                             ['a', 'b', 'c', 'd'])
    np.testing.assert_array_equal(kept, emb[[0, 2], 0])
    np.testing.assert_array_equal(labels, [5, 7])
    assert files == ['a', 'c'] and dropped == 2


@pytest.fixture(scope='module')
def stored(tmp_path_factory):
    rng = np.random.RandomState(3)
    labels = np.repeat(np.arange(6), [3, 7, 5, 9, 2, 6])
    emb = rng.randn(labels.size, 16).astype(np.float32)
    path = tmp_path_factory.mktemp('stored') / 'embeddings.h5'
    jax_h5utils.write(path, 'embeddings', emb)
    jax_h5utils.write(path, 'labels', labels)
    return path, emb, labels


def test_split_embeddings_matches_jax(stored):
    _, emb, labels = stored
    got = facenet.split_embeddings(emb, labels)
    want = jax_facenet.split_embeddings(emb, labels)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('classes, images', [(None, None), (4, None),
                                             (None, 5), (3, 4)])
def test_stored_embeddings_match_jax(stored, classes, images):
    path = stored[0]
    settings = {'path': str(path), 'nrof_classes': classes,
                'max_nrof_images': images}
    random.seed(7)
    got = facenet.Embeddings(Config(settings))
    random.seed(7)
    want = jax_facenet.Embeddings(JaxConfig(settings))
    assert repr(got) == repr(want)
    assert (got.nrof_classes, got.nrof_images, got.length) == \
        (want.nrof_classes, want.nrof_images, want.length)
    for normalize in (False, True):
        for a, b in zip(got.data(normalize), want.data(normalize)):
            np.testing.assert_array_equal(a, b)


class _ArrayLoader:
    """path -> uint8 image from an in-memory table; no native_mode, so the
    JAX loader takes its thread pool path too."""

    def __init__(self, n):
        rng = np.random.RandomState(0)
        self.table = {f'img_{i:03d}': rng.randint(0, 256, (4, 4, 3),
                                                  dtype=np.uint8)
                      for i in range(n)}

    def __call__(self, path):
        return self.table[path]


def _loaders(n, **kwargs):
    loader = _ArrayLoader(n)
    files = sorted(loader.table)
    labels = np.arange(n) % 5
    return (dataset.BatchLoader(files, labels, loader, **kwargs),
            jax_dataset.BatchLoader(files, labels, loader, **kwargs))


def _take(loader, count):
    out = []
    for images, labels in loader:
        out.append((images, labels))
        if len(out) == count:
            break
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_batch_loader_keeps_order_without_shuffle():
    ours, _ = _loaders(23, batch_size=5, num_workers=3)
    batches = list(ours)
    assert [b[0].shape[0] for b in batches] == [5, 5, 5, 5, 3]
    images = np.concatenate([b[0] for b in batches])
    np.testing.assert_array_equal(
        images, np.stack([ours.loader(f) for f in ours.files]))
    np.testing.assert_array_equal(np.concatenate([b[1] for b in batches]),
                                  np.arange(23) % 5)
    assert ours.state() == {'seed': ours.seed, 'epoch': 1, 'pos': 0}


@pytest.mark.parametrize('drop_remainder', [False, True])
def test_batch_loader_shuffles_as_jax_over_two_epochs(drop_remainder):
    ours, theirs = _loaders(23, batch_size=5, shuffle=True, repeat=True,
                            seed=123, drop_remainder=drop_remainder)
    count = 2 * len(ours)
    got, want = _take(ours, count), _take(theirs, count)
    _assert_same(got, want)
    assert ours.state() == theirs.state()
    first = np.concatenate([b[1] for b in got[:len(ours)]])
    assert not np.array_equal(first, np.arange(first.size) % 5)


def test_batch_loader_resumes_mid_epoch_as_jax():
    ours, theirs = _loaders(23, batch_size=4, shuffle=True, repeat=True,
                            seed=9)
    _take(ours, 8)                  # one epoch of 6 batches and 2 more
    _take(theirs, 8)
    state = ours.state()
    assert state == theirs.state() == {'seed': 9, 'epoch': 1, 'pos': 2}
    loader = ours.loader
    files, labels = ours.files, np.arange(23) % 5
    resumed = dataset.BatchLoader(files, labels, loader, 4, shuffle=True,
                                  repeat=True, start_state=state)
    reference = jax_dataset.BatchLoader(files, labels, loader, 4,
                                        shuffle=True, repeat=True,
                                        start_state=state)
    got, want = _take(resumed, 7), _take(reference, 7)
    _assert_same(got, want)
    # the resumed stream is the uninterrupted stream's continuation
    full = dataset.BatchLoader(files, labels, loader, 4, shuffle=True,
                               repeat=True, seed=9)
    _assert_same(got, _take(full, 15)[8:])


def test_evaluate_embeddings_spans(bundles, spans):
    """With host recording on, `evaluate_embeddings` fetches each batch in
    one ``embeddings.fetch`` span, ends in one ``embeddings.finish``, and
    returns what it returns with recording off."""
    from facenet_tpu_torch import FaceNet

    net = FaceNet(Config({'path': str(bundles[0])}), device='cpu')
    rng = np.random.RandomState(5)
    batches = [(rng.randint(0, 256, (3, 160, 160, 3)).astype(np.uint8),
                np.arange(3 * i, 3 * i + 3)) for i in range(3)]
    spans.record_spans(False)
    want = facenet.evaluate_embeddings(net.dispatch, batches)
    spans.record_spans(True)
    got = facenet.evaluate_embeddings(net.dispatch, batches)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    summary = spans.span_summary()
    assert {name: summary[name]['count'] for name in summary} == {
        'facenet.h2d': 3, 'facenet.forward': 3, 'embeddings.fetch': 3,
        'embeddings.finish': 1}
