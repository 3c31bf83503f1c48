"""The port's MTCNN training, weight import and train_detector app == the
JAX package's.

Same seeded inputs through `facenet_tpu.train.mtcnn`,
`facenet_tpu.detectors.mtcnn.weights`, `facenet_tpu.utils.synthetic` and
`facenet_tpu.apps.train_detector`, and the port's counterparts on the CPU.
Bounds:

  * `multitask_loss`: the masks and the OHEM keep set exactly (the hardest
    floor(0.7 n) eligible losses, ties at the cut kept), every metric within
    1e-6 of JAX's and of a float64 restatement;
  * `MTCNNTrainer` for P-, R- and O-Net, float32 from JAX's carried state:
    one step's metrics at rtol 1e-4 and Adam's first moment (0.1 x the
    gradient) of every leaf within 1e-3 of that leaf's largest entry; after
    3 steps each leaf within half the largest entry of JAX's change of it
    (+1e-7);
  * `generate_training_crops`: bit-equal outputs and the same
    ``RandomState`` afterwards;
  * `load_davidsandberg_weights`: trees equal to JAX's for fc_order
    nhwc / nchw x transpose False / True, on ``det1-3.npy`` files written
    from the bundled weights; `FaceDetector(weights=dir)` serves them with
    the 'caffe' base boxes;
  * `write_detection_dataset`: the same JSONL and pixels;
  * the train_detector app for 'mtcnn' through both CLIs on 6 scenes of
    128x128, 4 steps a net at batch 64: each package's
    ``detector_params.npy`` loads in the other's `FaceDetector`.

JAX compiles three programs here, the float32 step of each net at batch
64, shared through a module fixture with the JAX app.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from PIL import Image

from facenet_tpu.detectors.face_detector import FaceDetector as JaxFaceDetector
from facenet_tpu.detectors.mtcnn import weights as jax_weights
from facenet_tpu.train import mtcnn as jax_mtcnn
from facenet_tpu.utils import synthetic as jax_synthetic
from facenet_tpu_torch.detectors import pretrained
from facenet_tpu_torch.detectors.face_detector import FaceDetector
from facenet_tpu_torch.detectors.mtcnn import weights
from facenet_tpu_torch.train import mtcnn
from facenet_tpu_torch.utils import synthetic
from torch_testing import few_threads  # noqa: F401

BATCH = 64
NETS = ('pnet', 'rnet', 'onet')


def _crop_batches(net, n, seed):
    """n batches of BATCH crops (all four sample types) for one net."""
    rng = np.random.RandomState(seed)
    parts = []
    while sum(len(p[0]) for p in parts) < n * BATCH:
        img, boxes, lmks = synthetic.render_scene(
            rng, shape=(160, 160), n_faces=2, min_face=40, max_face=80)
        parts.append(mtcnn.generate_training_crops(
            img, boxes, mtcnn.INPUT_SIZE[net], rng, gt_landmarks=lmks))
    pool = [np.concatenate([p[i] for p in parts]) for i in range(5)]
    return [tuple(a[j * BATCH:(j + 1) * BATCH] for a in pool)
            for j in range(n)]


def test_multitask_loss_masks_and_ohem_keep_set():
    rng = np.random.RandomState(0)
    b = 40
    logits = rng.randn(b, 2).astype(np.float32)
    logits[5] = logits[3]                   # a tie among the losses
    labels = rng.randint(0, 2, b)
    labels[5] = labels[3]
    types = rng.randint(0, 4, b)
    types[3] = types[5] = mtcnn.POSITIVE
    box_p, box_t = rng.randn(2, b, 4).astype(np.float32)
    lmk_p, lmk_t = rng.randn(2, b, 10).astype(np.float32)
    weights_ = mtcnn.TASK_WEIGHTS['onet']

    _, got = mtcnn.multitask_loss(*(torch.from_numpy(np.asarray(a)) for a in
                                    (logits, box_p, lmk_p, labels, box_t,
                                     lmk_t, types)), weights_)
    _, want = jax_mtcnn.multitask_loss(logits, box_p, lmk_p, labels, box_t,
                                       lmk_t, types, weights_)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6,
                                   err_msg=k)

    # float64 restatement: the keep set is the hardest floor(0.7 n)
    # eligible losses, everything tied with the cut included
    x = logits.astype(np.float64)
    logp = x - np.log(np.exp(x).sum(1, keepdims=True))
    ce = -logp[np.arange(b), labels]
    eligible = (types == mtcnn.NEGATIVE) | (types == mtcnn.POSITIVE)
    n_keep = int(np.floor(eligible.sum() * mtcnn.OHEM_KEEP))
    kth = np.sort(ce[eligible])[::-1][n_keep - 1]
    keep = eligible & (ce >= kth)
    assert keep.sum() == n_keep + (ce[eligible] == kth).sum() - 1
    np.testing.assert_allclose(float(got['cls_loss']), ce[keep].mean(),
                               rtol=1e-6)
    box = (types == mtcnn.POSITIVE) | (types == mtcnn.PART)
    np.testing.assert_allclose(
        float(got['box_loss']),
        np.square(box_p - box_t).sum(1)[box].sum() / box.sum(), rtol=1e-6)
    lmk = types == mtcnn.LANDMARK
    np.testing.assert_allclose(
        float(got['lmk_loss']),
        np.square(lmk_p - lmk_t).sum(1)[lmk].sum() / lmk.sum(), rtol=1e-6)


@pytest.fixture(scope='module')
def jax_trainers():
    """JAX's float32 trainer of each net, its step compiled once at
    batch 64 (for the step test and the JAX app)."""
    return {net: jax_mtcnn.MTCNNTrainer(net, learning_rate=1e-3,
                                        dtype=jnp.float32) for net in NETS}


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize('net', NETS)
def test_trainer_steps_match_jax(jax_trainers, net):
    jax_trainer = jax_trainers[net]
    batches = _crop_batches(net, 3, seed=NETS.index(net))
    assert set(np.unique(batches[0][4])) == {0, 1, 2, 3}
    state = jax_trainer.init_state(seed=0)
    start = jax.device_get(state['params'])
    trainer = mtcnn.MTCNNTrainer(net, learning_rate=1e-3,
                                 dtype=torch.float32, device='cpu')
    port_state = trainer.init_state(params=start)
    for i, batch in enumerate(batches):
        state, want = jax_trainer.train_step(state, *batch)
        port_state, got = trainer.train_step(port_state, *batch)
        if i == 0:
            assert got.keys() == want.keys()
            for k, v in want.items():
                np.testing.assert_allclose(float(got[k]), float(v),
                                           rtol=1e-4, err_msg=k)
            mu = _leaves(jax.device_get(state['opt_state'][0].mu))
            for path, m in _leaves(trainer.first_moment(port_state)).items():
                w = np.asarray(mu[path])
                assert np.abs(m - w).max() <= 1e-3 * np.abs(w).max() + 1e-12, \
                    path
    end = _leaves(jax.device_get(state['params']))
    begin = _leaves(start)
    for path, p in _leaves(trainer.params_of(port_state)).items():
        change = np.asarray(end[path]) - np.asarray(begin[path])
        assert np.abs(p - np.asarray(end[path])).max() <= \
            0.5 * np.abs(change).max() + 1e-7, path


def test_generate_training_crops_bit_equal():
    scene_rng = np.random.RandomState(4)
    for size in (12, 24, 48):
        img, boxes, lmks = synthetic.render_scene(
            scene_rng, shape=(200, 240), n_faces=3, min_face=30,
            max_face=90)
        for landmarks in (lmks, None):
            a, b = np.random.RandomState(size), np.random.RandomState(size)
            got = mtcnn.generate_training_crops(img, boxes, size, a,
                                                gt_landmarks=landmarks)
            want = jax_mtcnn.generate_training_crops(img, boxes, size, b,
                                                     gt_landmarks=landmarks)
            assert len(got[0]) > 0
            for x, y in zip(got, want):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            sa, sb = a.get_state(), b.get_state()
            assert sa[2:] == sb[2:] and np.array_equal(sa[1], sb[1])
    empty = mtcnn.generate_training_crops(img[:3, :3], boxes[:0], 12,
                                          np.random.RandomState(0))
    assert [a.shape[0] for a in empty] == [0] * 5


def _davidsandberg_files(directory):
    """det1-3.npy in the upstream layout, made from the bundled weights."""
    params = pretrained.load_bundled('mtcnn')

    def entry(leaf):
        return {'weights': leaf['kernel'], 'biases': leaf['bias']}

    names = {
        'det1': ('pnet', {'conv1': 'conv1', 'PReLU1': 'prelu1',
                          'conv2': 'conv2', 'PReLU2': 'prelu2',
                          'conv3': 'conv3', 'PReLU3': 'prelu3',
                          'conv4-1': 'cls', 'conv4-2': 'reg'}),
        'det2': ('rnet', {'conv1': 'conv1', 'prelu1': 'prelu1',
                          'conv2': 'conv2', 'prelu2': 'prelu2',
                          'conv3': 'conv3', 'prelu3': 'prelu3',
                          'conv4': 'fc1', 'prelu4': 'prelu4',
                          'conv5-1': 'cls', 'conv5-2': 'reg'}),
        'det3': ('onet', {'conv1': 'conv1', 'prelu1': 'prelu1',
                          'conv2': 'conv2', 'prelu2': 'prelu2',
                          'conv3': 'conv3', 'prelu3': 'prelu3',
                          'conv4': 'conv4', 'prelu4': 'prelu4',
                          'conv5': 'fc1', 'prelu5': 'prelu5',
                          'conv6-1': 'cls', 'conv6-2': 'reg',
                          'conv6-3': 'landmarks'}),
    }
    directory.mkdir(exist_ok=True)
    for name, (net, layers) in names.items():
        tree = params[net]
        data = {up: ({'alpha': tree[ours]['alpha']} if 'prelu' in ours
                     else entry(tree[ours])) for up, ours in layers.items()}
        np.save(directory / f'{name}.npy', data, allow_pickle=True)
    return params


def test_davidsandberg_import_matches_jax(tmp_path):
    bundled = _davidsandberg_files(tmp_path / 'det')
    for fc_order in ('nhwc', 'nchw'):
        for transpose in (False, True):
            got = weights.load_davidsandberg_weights(
                tmp_path / 'det', fc_order=fc_order, transpose=transpose)
            want = jax_weights.load_davidsandberg_weights(
                tmp_path / 'det', fc_order=fc_order, transpose=transpose)
            assert jax.tree_util.tree_structure(got) == \
                jax.tree_util.tree_structure(want)
            assert jax.tree_util.tree_all(jax.tree_util.tree_map(
                np.array_equal, got, want)), (fc_order, transpose)
    as_is = weights.load_davidsandberg_weights(tmp_path / 'det')
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, as_is, bundled))

    fd = FaceDetector(weights=tmp_path / 'det', image_shape=(128, 128),
                      device='cpu')
    backend = fd.backend_for((128, 128))
    assert backend.pnet_box_convention == 'caffe'
    rng = np.random.RandomState(2)
    img, gt, _ = synthetic.render_scene(rng, shape=(128, 128), n_faces=1,
                                        min_face=50, max_face=70)
    assert isinstance(fd.detect(img), list)


def test_write_detection_dataset_equals_jax(tmp_path):
    got = synthetic.write_detection_dataset(tmp_path / 'port', 5,
                                            shape=(64, 80), seed=3)
    want = jax_synthetic.write_detection_dataset(tmp_path / 'jax', 5,
                                                 shape=(64, 80), seed=3)
    assert got.read_text() == want.read_text()
    for line in want.read_text().splitlines():
        name = json.loads(line)['image']
        np.testing.assert_array_equal(
            np.asarray(Image.open(got.parent / name)),
            np.asarray(Image.open(want.parent / name)))


def test_app_through_both_clis(tmp_path, jax_trainers, monkeypatch):
    """The JAX app trains this module's float32 trainers (steps compiled
    once, batch 64), the port's app its bf16 default; each output serves
    in the other package's facade."""
    from facenet_tpu.apps.train_detector import main as jax_main
    from facenet_tpu_torch.apps import train_detector

    ann = synthetic.write_detection_dataset(tmp_path / 'scenes', 6,
                                            shape=(128, 128), seed=0,
                                            min_face=30, max_face=90)
    monkeypatch.setattr(jax_mtcnn, 'MTCNNTrainer',
                        lambda net, learning_rate: jax_trainers[net])
    files = {}
    for name in ('jax', 'port'):
        cfg = {'detector': 'mtcnn', 'annotations': str(ann), 'seed': 0,
               'model': {'path': str(tmp_path / name)}, 'batch_size': BATCH,
               'train': {'learning_rate': 0.001,
                         'epoch': {'max_nrof_epochs': 1, 'size': 4}}}
        cfg_file = tmp_path / f'{name}.yaml'
        cfg_file.write_text(yaml.safe_dump(cfg))
        if name == 'jax':
            result = CliRunner().invoke(jax_main, ['--config', str(cfg_file)])
            assert result.exit_code == 0, result.output
        else:
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match='CUDA'):
                    train_detector.main(['--config', str(cfg_file)])
            train_detector.main(['--config', str(cfg_file), '--device',
                                 'cpu'])
        (files[name],) = (tmp_path / name).glob('*/detector_params.npy')

    port_params = np.load(files['port'], allow_pickle=True).item()
    jax_params = np.load(files['jax'], allow_pickle=True).item()
    assert set(port_params) == set(jax_params) == set(NETS)
    assert jax.tree_util.tree_structure(port_params) == \
        jax.tree_util.tree_structure(jax_params)
    JaxFaceDetector(detector='mtcnn', image_shape=(128, 128),
                    params=port_params)
    fd = FaceDetector(detector='mtcnn', image_shape=(128, 128),
                      params=jax_params, device='cpu')
    image = np.asarray(Image.open(ann.parent / 'scene_00000.png'))
    assert isinstance(fd.detect(image), list)
