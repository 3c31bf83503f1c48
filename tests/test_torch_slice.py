"""The port's whole slice on a synthetic dir-per-class PNG dataset with a
TINY bundle: the validate app (device='cpu') against the JAX package."""

from pathlib import Path

import jax
import numpy as np
import pytest
import yaml
from PIL import Image

from facenet_tpu import dataset as jax_dataset
from facenet_tpu import export as jax_export
from facenet_tpu import facenet as jax_facenet
from facenet_tpu import statistics as jax_statistics
from facenet_tpu.config import Config as JaxConfig
from facenet_tpu.models.inception_resnet_v1 import \
    InceptionResnetV1 as JaxIRv1
from facenet_tpu_torch import dataset
from facenet_tpu_torch.apps.validate import main

TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}, 'output': {'size': 32}}
# A fresh init maps every image to nearly one direction: all squared
# distances fall below the first metric-0 threshold (0.04), where two
# thresholds tie at accuracy 0.5 and the pick is knife-edge. The angular
# metric spreads the same pairs over several thresholds.
VALIDATE = {'metric': 1, 'nrof_folds': 3, 'far_target': 0.1}


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


@pytest.fixture(scope='module')
def tiny_bundle(tmp_path_factory):
    path = tmp_path_factory.mktemp('model') / 'bundle'
    model = JaxIRv1(config=TINY)
    variables = model.init(jax.random.PRNGKey(0),
                           np.zeros((1, 160, 160, 3), np.uint8), train=False)
    jax_export.save_model(path, model, variables)
    return path


@pytest.fixture(scope='module')
def app_run(face_tree, tiny_bundle, tmp_path_factory):
    cfg = {'dataset': {'path': str(face_tree)},
           'model': {'path': str(tiny_bundle)},
           'batch_size': 10, 'validate': VALIDATE}
    cfg_file = tmp_path_factory.mktemp('cfg') / 'validate.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg))
    report = main(['--config', str(cfg_file), '--device', 'cpu'])
    return cfg, report


def test_validate_app_writes_report(app_run, face_tree, tiny_bundle):
    outdir = Path(str(face_tree) + '_' + tiny_bundle.stem)
    text = (outdir / 'validate.txt').read_text()
    assert 'FaceToFaceValidation' in text
    assert 'MaximumAccuracy' in text
    assert 'FalseAlarmRate(FAR = 0.1)' in text
    assert 'Number of classes 4' in text
    assert 'elapsed time' in text
    assert (outdir / 'validate.h5').exists()
    assert (outdir / 'validate.yaml').exists()
    assert (outdir / 'revision_info.txt').exists()


def test_embeddings_match_jax(app_run, face_tree, tiny_bundle):
    cfg, report = app_run
    jcfg = JaxConfig({'model': {'path': str(tiny_bundle), 'normalize': True},
                      'image': {'size': 160}, 'batch_size': 10})
    dbase = jax_dataset.DBase(jax_dataset.DefaultConfig(str(face_tree)))
    ref = jax_facenet.EvaluationOfEmbeddings(dbase, jcfg)
    got = report.embeddings.numpy()
    assert got.shape == ref.embeddings.shape == (24, 32)
    np.testing.assert_array_equal(report.labels, ref.labels)
    assert (got * ref.embeddings).sum(1).min() > 0.999
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_jax_report_on_port_embeddings_matches(app_run):
    _, report = app_run
    ref = jax_statistics.FaceToFaceValidation(
        report.embeddings.numpy(), report.labels, JaxConfig(VALIDATE)).dict
    got = report.dict
    for crit in ref:
        for key, value in ref[crit].items():
            assert abs(got[crit][key] - value) <= 1e-6, (crit, key)


def test_database_and_loader(face_tree):
    db = dataset.Database(face_tree)
    assert db.nrof_classes == 4 and db.nrof_images == 24
    batches = list(db.batches(dataset.ImageLoader(size=150), batch_size=10))
    assert [b[0].shape[0] for b in batches] == [10, 10, 4]
    assert batches[0][0].shape == (10, 150, 150, 3)
    assert batches[0][0].dtype == np.uint8
    np.testing.assert_array_equal(np.concatenate([b[1] for b in batches]),
                                  db.labels)


def test_missing_dataset_dir_raises(tmp_path):
    with pytest.raises(ValueError, match='does not exist'):
        dataset.Database(tmp_path / 'nope')
