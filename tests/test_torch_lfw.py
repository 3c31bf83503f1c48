"""The port's fixed-pairs LFW protocol (facenet_tpu_torch/lfw.py and
apps/validate_on_lfw.py) against the JAX package's on the CPU: pairs files,
path resolution, the errors, pair distances and the report to 1e-12, and
the app through both packages' CLIs with a TINY IRv1 bundle."""

import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml
from click.testing import CliRunner
from PIL import Image

from conftest import make_embeddings
from facenet_tpu import export as jax_export
from facenet_tpu import lfw as jax_lfw
from facenet_tpu.apps import validate_on_lfw as jax_app
from facenet_tpu.config import Config as JaxConfig
from facenet_tpu.models.inception_resnet_v1 import \
    InceptionResnetV1 as JaxIRv1
from facenet_tpu_torch import lfw
from facenet_tpu_torch.apps.validate_on_lfw import main
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.models.inception_resnet_v1 import init_variables
from torch_testing import few_threads  # noqa: F401

TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}, 'output': {'size': 32}}


def _placeholder_tree(root, counts, ext='png', first=1):
    """Empty files <name>/<name>_%04d.<ext>: enough for pair drawing and
    path resolution, which only look at names."""
    for c, count in enumerate(counts):
        name = f'Person_{c:02d}'
        (root / name).mkdir(parents=True)
        for i in range(first, first + count):
            (root / name / f'{name}_{i:04d}.{ext}').touch()
    return root


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    counts = [1, 5, 2, 7, 1, 3, 4, 1, 6, 2, 3, 8, 1, 4, 2, 5, 3, 1]
    return _placeholder_tree(tmp_path_factory.mktemp('lfw'), counts)


def test_generate_pairs_matches_jax(tree, tmp_path):
    ours = lfw.generate_pairs(tree, nrof_folds=3, nrof_pairs=4, seed=5,
                              output=tmp_path / 'port.txt')
    theirs = jax_lfw.generate_pairs(tree, nrof_folds=3, nrof_pairs=4,
                                    seed=5, output=tmp_path / 'jax.txt')
    assert ours == theirs
    assert len(ours) == 3 * 2 * 4
    assert ((tmp_path / 'port.txt').read_bytes()
            == (tmp_path / 'jax.txt').read_bytes())


def test_read_pairs_and_get_paths_match_jax(tree, tmp_path):
    jax_lfw.generate_pairs(tree, nrof_folds=3, nrof_pairs=4, seed=1,
                           output=tmp_path / 'pairs.txt')
    # a leading blank line, a pair whose image is missing, a jpg
    text = (tmp_path / 'pairs.txt').read_text().splitlines()
    text[0] = '\n' + text[0]
    text[1] = 'Person_01\t1\t99'
    (tree / 'Person_03' / 'Person_03_0001.png').rename(
        tree / 'Person_03' / 'Person_03_0001.jpg')
    try:
        (tmp_path / 'pairs.txt').write_text('\n'.join(text) + '\n')
        pairs = lfw.read_pairs(tmp_path / 'pairs.txt')
        assert pairs == jax_lfw.read_pairs(tmp_path / 'pairs.txt')
        for ext in (None, 'png'):
            paths, issame, skipped = lfw.get_paths(tree, pairs, ext)
            want = jax_lfw.get_paths(tree, pairs, ext)
            assert paths == want[0]
            np.testing.assert_array_equal(issame, want[1])
            assert skipped == want[2] >= 1
    finally:
        (tree / 'Person_03' / 'Person_03_0001.jpg').rename(
            tree / 'Person_03' / 'Person_03_0001.png')


def _header_mismatch(module, tmp_path):
    (tmp_path / 'pairs.txt').write_text('2 2\nA\t1\t2\nB\t1\tC\t2\n')
    module.read_pairs(tmp_path / 'pairs.txt')


def _bad_field_count(module, tmp_path):
    (tmp_path / 'pairs.txt').write_text('A\t1\t2\t3\t4\n')
    module.read_pairs(tmp_path / 'pairs.txt')


def _too_few_identities(module, tmp_path):
    root = tmp_path / module.__name__
    if not root.exists():
        _placeholder_tree(root, [3, 3, 3])
    module.generate_pairs(root, nrof_folds=2, nrof_pairs=1)


def _impossible_uniqueness(module, tmp_path):
    root = tmp_path / module.__name__
    if not root.exists():
        _placeholder_tree(root, [2, 2, 2, 2])
    module.generate_pairs(root, nrof_folds=2, nrof_pairs=3)


def _pair_count_mismatch(module, tmp_path):
    module.LfwValidation(np.ones((7, 4)), np.ones(4, bool))


def _too_few_pairs_for_folds(module, tmp_path):
    emb = np.eye(8)[np.arange(8) % 4]
    module.LfwValidation(emb, np.ones(4, bool), {'nrof_folds': 5})


def _unknown_metric(module, tmp_path):
    module.pair_distances(np.ones((2, 3)), np.ones((2, 3)), metric=7)


@pytest.mark.parametrize('case', [
    _header_mismatch, _bad_field_count, _too_few_identities,
    _impossible_uniqueness, _pair_count_mismatch, _too_few_pairs_for_folds,
    _unknown_metric])
def test_errors_are_raised_alike(case, tmp_path):
    with pytest.raises(ValueError) as ours:
        case(lfw, tmp_path)
    with pytest.raises(ValueError) as theirs:
        case(jax_lfw, tmp_path)
    assert str(ours.value) == str(theirs.value)


def _pair_embeddings(seed, flip, nrof_pairs=300):
    """Unit rows of clustered embeddings arranged as pairs (rows 2i and
    2i+1 are pair i), half of them same-class; with `flip`, each row is
    concatenated with a second unit embedding of the same class, as the
    app's flip makes them (norm sqrt(2))."""
    rng = np.random.RandomState(seed)
    emb, labels = make_embeddings(rng, nrof_classes=12, images_per_class=20,
                                  dim=32, spread=0.6)
    if flip:
        second, _ = make_embeddings(np.random.RandomState(seed + 1),
                                    nrof_classes=12, images_per_class=20,
                                    dim=32, spread=0.6)
        emb = np.concatenate([emb, second], axis=1)
    issame = rng.rand(nrof_pairs) < 0.5
    rows = []
    for same in issame:
        a = rng.randint(len(labels))
        pool = np.flatnonzero((labels == labels[a]) == same)
        pool = pool[pool != a]
        rows += [a, rng.choice(pool)]
    return emb[rows], issame


@pytest.mark.parametrize('metric', [0, 1])
def test_pair_distances_match_jax(metric):
    emb, _ = _pair_embeddings(0, flip=True)
    got = lfw.pair_distances(emb[0::2], emb[1::2], metric)
    want = jax_lfw.pair_distances(emb[0::2], emb[1::2], metric)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _without_elapsed(text):
    return re.sub(r'elapsed_time: .*', '', text)


@pytest.mark.parametrize('flip', [False, True], ids=['unit', 'flip'])
@pytest.mark.parametrize('subtract_mean', [False, True])
@pytest.mark.parametrize('metric', [0, 1])
def test_lfw_validation_matches_jax(metric, subtract_mean, flip, tmp_path):
    emb, issame = _pair_embeddings(metric + 2 * subtract_mean, flip)
    settings = {'metric': metric, 'nrof_folds': 10, 'far_target': 1e-2,
                'subtract_mean': subtract_mean}
    ours = lfw.LfwValidation(emb, issame, Config(settings))
    theirs = jax_lfw.LfwValidation(emb, issame, JaxConfig(settings))
    got, want = ours.dict, theirs.dict
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-12, (key, got[key], value)
    assert 0.5 < got['accuracy'] < 1 and got['auc'] > 0.5
    assert _without_elapsed(repr(ours)) == _without_elapsed(repr(theirs))
    ours.write_report(tmp_path / 'report.txt')
    ours.write_h5file(tmp_path / 'report.h5')
    assert 'Accuracy:' in (tmp_path / 'report.txt').read_text()


@pytest.fixture(scope='module')
def app_runs(tmp_path_factory):
    """The tree, pairs and config of tests/test_lfw.py's app test, through
    the port's CLI (--device cpu) and JAX's, each with its own bundle
    name; JAX's embeddings are taken from its `_embed`."""
    tmp = tmp_path_factory.mktemp('lfw_app')
    jax_export.save_model(tmp / 'port', JaxIRv1(config=TINY),
                          init_variables(TINY, seed=0))
    shutil.copytree(tmp / 'port', tmp / 'jax')

    root = tmp / 'lfw_aligned'
    rng = np.random.RandomState(0)
    names = [f'Person_{c}' for c in range(4)]
    for name in names:
        d = root / name
        d.mkdir(parents=True)
        base = rng.randint(0, 255, (160, 160, 3)).astype(np.float32)
        for i in range(1, 4):
            img = np.clip(base + rng.randn(160, 160, 3) * 6, 0,
                          255).astype(np.uint8)
            Image.fromarray(img).save(d / f'{name}_{i:04d}.png')
    lines = ['2 2']
    for fold in range(2):
        a, b = names[2 * fold], names[2 * fold + 1]
        lines += [f'{a}\t1\t2', f'{b}\t2\t3',
                  f'{a}\t1\t{b}\t1', f'{b}\t2\t{a}\t3']
    pairs_file = tmp / 'pairs.txt'
    pairs_file.write_text('\n'.join(lines) + '\n')

    files = {}
    for name in ('port', 'jax'):
        cfg = {'dataset': {'path': str(root), 'pairs': str(pairs_file)},
               'model': {'path': str(tmp / name)}, 'batch_size': 8,
               'validate': {'nrof_folds': 2, 'far_target': 0.5,
                            'flip': True}}
        files[name] = tmp / f'{name}.yaml'
        files[name].write_text(yaml.safe_dump(cfg))

    report, embeddings = main(['--config', str(files['port']),
                               '--device', 'cpu'])
    captured = []
    original = jax_app._embed

    def spy(paths, options):
        captured.append(original(paths, options))
        return captured[-1]

    jax_app._embed = spy
    try:
        run = CliRunner().invoke(jax_app.main,
                                 ['--config', str(files['jax'])])
    finally:
        jax_app._embed = original
    assert run.exit_code == 0, run.output
    logs = {name: Path(f'{root}_{name}') / 'validate_on_lfw.txt'
            for name in ('port', 'jax')}
    return report, embeddings, captured[0], logs


def test_validate_on_lfw_app_writes_what_jax_writes(app_runs):
    _, _, _, logs = app_runs
    for log in logs.values():
        text = log.read_text()
        assert 'LfwValidation' in text
        assert 'Validation rate:' in text
        assert 'pairs: 8 (4 same)' in text
        assert 'embeddings: (16, 64)' in text
        assert log.with_suffix('.h5').exists()
        assert (log.parent / 'revision_info.txt').exists()
        assert (log.parent / 'validate_on_lfw.yaml').exists()


def test_validate_on_lfw_app_embeddings_match_jax(app_runs):
    _, embeddings, reference, _ = app_runs
    assert embeddings.shape == reference.shape == (16, 64)
    for half in (slice(0, 32), slice(32, 64)):
        a, b = embeddings[:, half], reference[:, half]
        np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0,
                                   atol=1e-6)
        assert (a * b).sum(1).min() >= 0.999
    # the flip half is the embedding of another image
    assert np.abs(embeddings[:, :32] - embeddings[:, 32:]).max() > 1e-3


def test_validate_on_lfw_app_report_is_jaxs_on_its_embeddings(app_runs):
    report, embeddings, _, _ = app_runs
    want = jax_lfw.LfwValidation(
        embeddings, report.issame,
        JaxConfig({'nrof_folds': 2, 'far_target': 0.5})).dict
    for key, value in want.items():
        assert abs(report.dict[key] - value) <= 1e-12, key
