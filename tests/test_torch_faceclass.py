"""The port's pair classifiers and their trainer == the JAX package's.

Same numpy inputs (clustered embeddings from a seed) through
`facenet_tpu.faceclass` / `facenet_tpu.train.classifier` and the port's
counterparts on the CPU. Bounds:

  * distances and logits of both classifiers within 1e-6; `predict` equal
    except for pairs whose distance lies within 1e-6 of the threshold;
  * `equal_batches_input_pipeline`: batches bit-equal to JAX's for three
    seeds, P shrinking when classes are shorter than K;
  * `ClassifierTrainer`, 2 epochs x 5 steps for both variants: every
    step's loss at rtol 1e-5, the final variables within 1e-5 (relative)
    of JAX's own step (`_build_step`, optax Adam on the same schedule);
  * `ConfusionMatrix` (class blocks counted on the device) against JAX's
    loop over class pairs within 1e-6, on variables that put no pair
    within 1e-5 of the threshold;
  * the app through both CLIs on a small h5: the same ``classifier.yaml``
    keys, values within 1e-4; the port's app raises without a GPU unless
    ``--device cpu``.

JAX compiles two programs here, the step of each classifier, shared
through the `trained` fixture with the JAX app.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from facenet_tpu import dataset as jax_dataset
from facenet_tpu import faceclass as jax_faceclass
from facenet_tpu.config import Config as JaxConfig
from facenet_tpu.train import classifier as jax_classifier
from facenet_tpu_torch import dataset, facenet, faceclass
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.train import classifier

from conftest import make_embeddings
from torch_testing import few_threads  # noqa: F401

JAX_STEPS = {}      # normalized -> JAX's jitted step, compiled once

VARIANTS = {
    False: ('FaceToFaceDistanceClassifier', {'alpha': 7.0, 'threshold': 1.1,
                                             'theta': 0.6}),
    True: ('FaceToFaceNormalizedEmbeddingsClassifier',
           {'alpha': 9.0, 'threshold': 0.9}),
}


def _classes(normalized, seed=0, n_classes=4, per_class=12):
    """Per-class embeddings: clustered unit vectors, scaled per row for the
    distance classifier (whose input is not normalized)."""
    rng = np.random.RandomState(seed)
    embs, labels = make_embeddings(rng, nrof_classes=n_classes,
                                   images_per_class=per_class, dim=16,
                                   spread=0.3)
    if not normalized:
        embs = embs * rng.uniform(0.5, 2.0, (len(embs), 1)).astype(np.float32)
    return [embs[labels == c] for c in range(n_classes)]


def _pair(normalized):
    name, values = VARIANTS[normalized]
    return (getattr(jax_faceclass, name)(**values),
            getattr(faceclass, name)(device='cpu', **values))


@pytest.mark.parametrize('normalized', [False, True])
def test_distances_logits_and_predict_match_jax(normalized):
    jax_model, model = _pair(normalized)
    per_class = _classes(normalized)
    x, y = per_class[0], np.concatenate(per_class[1:])
    for args in ((x,), (x, y)):
        want_d = np.asarray(jax_model.distance(*args))
        got_d = model.distance(*args).numpy()
        np.testing.assert_allclose(got_d, want_d, atol=1e-6)
        np.testing.assert_allclose(model(*args).numpy(),
                                   np.asarray(jax_model(*args)), atol=1e-5,
                                   rtol=1e-6)
        near = np.abs(want_d - VARIANTS[normalized][1]['threshold']) < 1e-6
        agree = model.predict(*args) == jax_model.predict(*args)
        assert (agree | near).all()
    # the variables carried both ways
    back = type(model).from_variables(jax_model.variables, device='cpu')
    for k, v in back.variables_dict().items():
        assert v == np.float32(jax_model.variables[k])
        assert v.dtype == np.float32


@pytest.mark.parametrize('normalized', [False, True])
def test_predict_and_variable_match_jax(normalized):
    """`predict` (distance below the threshold) and `variable` (the tensor,
    or numpy with mode='numpy') against JAX's, on both classifiers."""
    jax_model, model = _pair(normalized)
    per_class = _classes(normalized, seed=3)
    x, y = per_class[0], np.concatenate(per_class[1:])
    want = jax_model.predict(x, y)
    got = model.predict(x, y)
    assert got.dtype == np.bool_ and got.shape == want.shape
    near = np.abs(np.asarray(jax_model.distance(x, y))
                  - VARIANTS[normalized][1]['threshold']) < 1e-6
    assert ((got == want) | near).all() and want.any() and not want.all()
    for name in jax_model.variables:
        value = model.variable(name, mode='numpy')
        assert isinstance(value, np.ndarray)
        assert value == np.asarray(jax_model.variable(name, mode='numpy'))
        assert isinstance(model.variable(name), torch.Tensor)


def test_distance_is_differentiable():
    _, model = _pair(False)
    variables = {k: v.clone().requires_grad_(True)
                 for k, v in model.variables.items()}
    x = torch.from_numpy(_classes(False)[0])
    model(x, variables=variables).sum().backward()
    assert all(v.grad is not None and torch.isfinite(v.grad)
               for v in variables.values())


@pytest.mark.parametrize('seed', [0, 1, 7])
def test_equal_batches_equal_jax(seed):
    """Bit-equal batches; with K = 9 two of the five classes are too short
    and P (default: all classes) shrinks to 3 on both sides."""
    rng = np.random.RandomState(seed)
    per_class = [rng.randn(n, 8).astype(np.float32)
                 for n in (12, 5, 9, 20, 8)]
    for p, k in ((None, 9), (2, 3), (None, None)):
        cfg_port = Config({'nrof_classes_per_batch': p,
                           'nrof_examples_per_class': k})
        cfg_jax = JaxConfig({'nrof_classes_per_batch': p,
                             'nrof_examples_per_class': k})
        got = dataset.equal_batches_input_pipeline(per_class, cfg_port,
                                                   seed=seed)
        want = jax_dataset.equal_batches_input_pipeline(per_class, cfg_jax,
                                                        seed=seed)
        assert cfg_port.nrof_classes_per_batch == \
            cfg_jax.nrof_classes_per_batch
        assert cfg_port.nrof_examples_per_class == \
            cfg_jax.nrof_examples_per_class
        for _ in range(4):
            a, b = next(got), next(want)
            assert a.dtype == np.float32 and np.array_equal(a, b)
    assert facenet.equal_batches_input_pipeline is \
        dataset.equal_batches_input_pipeline
    with pytest.raises(ValueError, match='no class'):
        dataset.equal_batches_input_pipeline(
            per_class, Config({'nrof_examples_per_class': 50}))


def _train_cfg(cls):
    return cls({
        'nrof_classes_per_batch': 4,
        'nrof_examples_per_class': 4,
        'train': {'epoch': {'max_nrof_epochs': 2, 'size': 5},
                  'learning_rate_schedule': {'initial_value': 0.05,
                                             'decay_rate': 0.5,
                                             'decay_steps': 3}},
    })


@pytest.fixture(scope='module', params=[False, True],
                ids=['distance', 'normalized'])
def trained(request):
    """Both trainers over the same 2 x 5 batches: (normalized, per_class,
    JAX's per-step losses and final variables, the port's trainer and
    model)."""
    normalized = request.param
    per_class = _classes(normalized, seed=3)
    pipe = jax_dataset.equal_batches_input_pipeline(
        per_class, _train_cfg(JaxConfig), seed=0)
    batches = [next(pipe) for _ in range(10)]

    jax_trainer = jax_classifier.ClassifierTrainer(_train_cfg(JaxConfig),
                                                   normalized=normalized)
    step = jax_trainer._build_step(4, 4)
    JAX_STEPS[normalized] = step
    variables = jax_trainer.model.variables
    opt_state = jax_trainer.tx.init(variables)
    jax_losses = []
    for batch in batches:
        variables, opt_state, loss = step(variables, opt_state,
                                          jnp.asarray(batch))
        jax_losses.append(float(loss))
    jax_vars = {k: float(v) for k, v in jax.device_get(variables).items()}

    trainer = classifier.ClassifierTrainer(_train_cfg(Config),
                                           normalized=normalized,
                                           device='cpu')
    model = trainer.train(iter(batches), nrof_epochs=2, epoch_size=5, p=4,
                          k=4, embeddings_per_class=per_class)
    return normalized, per_class, jax_losses, jax_vars, trainer, model


def test_trainer_matches_jax(trained):
    _, _, jax_losses, jax_vars, trainer, model = trained
    losses = [float(v) for v in trainer.losses]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    got = model.variables_dict()
    assert got.keys() == jax_vars.keys()
    for k, v in jax_vars.items():
        assert abs(float(got[k]) - v) <= 1e-5 * abs(v), (k, got[k], v)
    assert losses[-1] < losses[0]


def test_confusion_matrix_matches_jax_loop(trained):
    normalized, per_class, _, jax_vars, _, model = trained
    name = VARIANTS[normalized][0]
    jax_model = getattr(jax_faceclass, name)()
    jax_model.variables = {k: jnp.float32(v)
                           for k, v in model.variables_dict().items()}
    flat = np.concatenate(per_class)
    d = np.asarray(jax_model.distance(flat))
    margin = np.abs(d - float(jax_model.variables['threshold'])).min()
    assert margin > 1e-5, margin          # no pair on the edge
    want = jax_classifier.ConfusionMatrix(per_class, jax_model)
    got = classifier.ConfusionMatrix(per_class, model)
    for attr in ('accuracy', 'precision', 'tp_rate', 'tn_rate'):
        assert abs(getattr(got, attr) - getattr(want, attr)) <= 1e-6, attr
    assert 'accuracy' in repr(got)
    # rows split over several chunks count the same
    means = classifier.class_pair_acceptance(per_class, model, chunk=5)
    np.testing.assert_array_equal(
        means, classifier.class_pair_acceptance(per_class, model))


def _h5(path, normalized):
    """The `trained` fixture's embeddings (4 classes x 12, 16-d) as an h5."""
    import h5py
    per_class = _classes(normalized, seed=3)
    with h5py.File(path, 'w') as f:
        f['embeddings'] = np.concatenate(per_class)
        f['labels'] = np.repeat(np.arange(len(per_class)), 12)


def test_app_through_both_clis(tmp_path, trained, monkeypatch):
    """Both apps on the `trained` fixture's embeddings and schedule; the
    JAX app runs the fixture's compiled step (the same P x K and
    schedule, so the same program)."""
    from facenet_tpu.apps.train_classifier import main as jax_main
    from facenet_tpu_torch.apps import train_classifier

    normalized = trained[0]
    monkeypatch.setattr(jax_classifier.ClassifierTrainer, '_build_step',
                        lambda self, p, k: JAX_STEPS[self.normalized])
    h5 = tmp_path / 'embeddings.h5'
    _h5(h5, normalized)
    outputs = {}
    for name in ('jax', 'port'):
        cfg = {'seed': 0, 'nrof_examples_per_class': 4,
               'classifier': {'path': str(tmp_path / name)},
               'train': {'epoch': {'max_nrof_epochs': 2, 'size': 5},
                         'learning_rate_schedule': {'initial_value': 0.05,
                                                    'decay_rate': 0.5,
                                                    'decay_steps': 3}},
               'embeddings': {'path': str(h5), 'normalize': normalized}}
        cfg_file = tmp_path / f'{name}.yaml'
        cfg_file.write_text(yaml.safe_dump(cfg))
        if name == 'jax':
            result = CliRunner().invoke(jax_main, ['--config', str(cfg_file)])
            assert result.exit_code == 0, result.output
        else:
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match='CUDA'):
                    train_classifier.main(['--config', str(cfg_file)])
            train_classifier.main(['--config', str(cfg_file),
                                   '--device', 'cpu'])
        (out,) = (tmp_path / name).glob('*/classifier.yaml')
        outputs[name] = yaml.safe_load(out.read_text())
        assert (out.parent / 'log.txt').is_file()
    want, got = outputs['jax'], outputs['port']
    assert got.keys() == want.keys()
    assert got['class'] == want['class'] == VARIANTS[normalized][0]
    assert got['variables'].keys() == want['variables'].keys()
    for k, v in want['variables'].items():
        assert abs(got['variables'][k] - v) <= 1e-4, (k, got, want)
