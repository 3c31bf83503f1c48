"""The port's Faster-RCNN detector and its trainer == the JAX package's.

The same bundled weights (a byte-identical copy of JAX's
``frcnn_synthetic.npz``) and the same seeded scenes through
`facenet_tpu.detectors.frcnn` and `facenet_tpu_torch.detectors.frcnn` on
the CPU. Bounds:

  * `anchor_grid`, `encode_deltas` and `match_anchors`: exactly equal;
    `decode_deltas` within 1e-6 of the largest coordinate: XLA's CPU
    program fuses a multiply-add and rounds its exp otherwise than torch,
    in the last bit of terms that then partly cancel;
  * the forward in float32 on both sides at 128x128: RPN objectness and
    deltas within 1e-4 of their largest |value|; the same valid
    detections, boxes within 0.05 px, scores within 1e-4;
  * bf16 on both sides on the 32 held-out 256x256 scenes of JAX's gate
    (seed 555): the port's recall, precision and mean IoU pass JAX's gate
    (0.97, 0.86, 0.5) and lie within 0.02 of JAX's own;
  * one `FasterRCNNTrainer` step in float32 from JAX's carried state: the
    four losses at rtol 1e-4, Adam's first moment (0.1 x the gradient) of
    every leaf within 1e-3 of that leaf's largest entry; after 3 steps each
    leaf within half the largest entry of JAX's change of it (+1e-7). The
    head trains on the top K anchors by ``(label == 1) + 0.001 *
    sigmoid(obj)``, and its losses are sums over those K RoIs, so tied
    scores ordered otherwise would not move them; another set of RoIs would;
  * the train_detector app for 'frcnnv3' through both CLIs, 3 steps at
    batch 2 on 6 scenes: each package's ``detector_params.npy`` loads in
    the other's `FaceDetector`.

JAX compiles three programs here, shared through module fixtures: the
float32 forward at 128x128 (batch 4), the bf16 forward at 256x256 (batch
16) and the float32 train step at 128x128 (batch 2), which the JAX app
reuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from PIL import Image

from facenet_tpu.detectors import evaluation as jax_evaluation
from facenet_tpu.detectors import pretrained as jax_pretrained
from facenet_tpu.detectors.face_detector import FaceDetector as JaxFaceDetector
from facenet_tpu.detectors.frcnn import detector as jax_detector
from facenet_tpu.detectors.frcnn import network as jax_network
from facenet_tpu_torch.detectors import evaluation, pretrained
from facenet_tpu_torch.detectors.face_detector import FaceDetector
from facenet_tpu_torch.detectors.frcnn import detector, network
from facenet_tpu_torch.utils.synthetic import render_scene
from torch_testing import few_threads  # noqa: F401

SMALL = (128, 128)


@pytest.fixture(scope='module')
def bundled():
    params = pretrained.load_bundled('frcnnv3')
    want = jax_pretrained.load_bundled('frcnnv3')
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, params, want))
    return params


def _scenes(n, seed, shape, min_face=30, max_face=90):
    rng = np.random.RandomState(seed)
    return [render_scene(rng, shape=shape, n_faces=rng.randint(1, 4),
                         min_face=min_face, max_face=max_face)
            for _ in range(n)]


def test_anchors_deltas_and_matching_equal_jax():
    for shape in ((128, 128), (480, 640), (200, 97)):
        np.testing.assert_array_equal(network.anchor_grid(*shape),
                                      jax_network.anchor_grid(*shape))
    anchors = network.anchor_grid(128, 160)
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 100, (len(anchors), 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, xy.shape)],
                           1).astype(np.float32)
    enc = network.encode_deltas(anchors, boxes)
    np.testing.assert_array_equal(enc,
                                  jax_network.encode_deltas(anchors, boxes))
    deltas = rng.uniform(-5, 5, anchors.shape).astype(np.float32)
    decode = (lambda d: network.decode_deltas(
        torch.from_numpy(anchors), torch.from_numpy(d)).numpy())
    for d in (deltas, np.where(np.arange(4) < 2, deltas, 0)):
        want = np.asarray(jax_network.decode_deltas(anchors, d))
        np.testing.assert_allclose(decode(d), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    for gt in (boxes[:3], boxes[:0], np.array([[10, 10, 70, 80.5]],
                                              np.float32)):
        got, want = detector.match_anchors(anchors, gt), \
            jax_detector.match_anchors(anchors, gt)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope='module')
def jax_det(bundled):
    """JAX's float32 detector at 128x128 with the bundled weights."""
    return jax_detector.FasterRCNN(image_shape=SMALL, params=bundled,
                                   dtype=jnp.float32)


def test_forward_float32_matches_jax(bundled, jax_det):
    images = np.stack([s[0] for s in _scenes(4, 1, SMALL)])
    port = detector.FasterRCNN(image_shape=SMALL, params=bundled,
                               dtype=torch.float32, device='cpu')
    fmap = jax_det.backbone.apply({'params': bundled['backbone']},
                                  jnp.asarray(images, jnp.float32) / 255.0)
    obj, deltas = jax_det.rpn.apply({'params': bundled['rpn']}, fmap)
    with torch.no_grad():
        _, got_obj, got_deltas = port.features(torch.from_numpy(images))
    for got, want in ((got_obj, obj), (got_deltas, deltas)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            1e-4 * np.abs(want).max()

    want = jax_det.detect_batch(images)
    got = port.detect_batch(images)
    assert want['valid'].sum() >= 4
    np.testing.assert_array_equal(got['valid'], want['valid'])
    valid = want['valid']
    assert np.abs(got['boxes'][valid] - want['boxes'][valid]).max() <= 0.05
    np.testing.assert_allclose(got['scores'], want['scores'], atol=1e-4)
    # the tree carried back out
    tree = port.to_flax_params()
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, tree, bundled))


def test_bundled_quality_gate_bf16_matches_jax():
    scenes = _scenes(32, 555, (256, 256), min_face=32, max_face=160)
    images, gts = [s[0] for s in scenes], [s[1] for s in scenes]
    got = evaluation.evaluate_detector(
        FaceDetector(detector='frcnnv3', image_shape=(256, 256),
                     device='cpu'), images, gts, iou_threshold=0.5,
        batch_size=16)
    want = jax_evaluation.evaluate_detector(
        JaxFaceDetector(detector='frcnnv3', image_shape=(256, 256)), images,
        gts, iou_threshold=0.5, batch_size=16)
    assert got['recall'] >= 0.97, got
    assert got['precision'] >= 0.86, got
    assert got['mean_iou'] >= 0.5, got
    for key in ('recall', 'precision', 'mean_iou'):
        assert abs(got[key] - want[key]) <= 0.02, (key, got, want)


@pytest.fixture(scope='module')
def jax_trainer(jax_det):
    return jax_detector.FasterRCNNTrainer(jax_det, learning_rate=1e-3)


def _train_batches(n):
    out = []
    for i in range(n):
        scenes = _scenes(2, 10 + i, SMALL)
        out.append((np.stack([s[0] for s in scenes]),
                    [s[1] for s in scenes]))
    return out


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_trainer_steps_match_jax(jax_trainer):
    batches = _train_batches(3)
    state = jax_trainer.init_state(seed=0)
    start = jax.device_get(state['params'])
    port_det = detector.FasterRCNN(image_shape=SMALL, dtype=torch.float32,
                                   device='cpu')
    trainer = detector.FasterRCNNTrainer(port_det, learning_rate=1e-3)
    port_state = trainer.init_state(params=start)

    for i, (images, gts) in enumerate(batches):
        state, want = jax_trainer.train_step(state, images, gts)
        port_state, got = trainer.train_step(port_state, images, gts)
        if i == 0:
            for k, v in want.items():
                np.testing.assert_allclose(float(got[k]), float(v),
                                           rtol=1e-4, err_msg=k)
            mu = _leaves(jax.device_get(state['opt_state'][0].mu))
            for path, m in _leaves(trainer.first_moment(port_state)).items():
                w = np.asarray(mu[path])
                assert np.abs(m - w).max() <= 1e-3 * np.abs(w).max() + 1e-12, \
                    path
    end = _leaves(jax.device_get(state['params']))
    for path, p in _leaves(trainer.params_of(port_state)).items():
        change = np.asarray(end[path]) - np.asarray(_leaves(start)[path])
        assert np.abs(p - np.asarray(end[path])).max() <= \
            0.5 * np.abs(change).max() + 1e-7, path


def test_face_detector_loads_npz_and_npy_weights(bundled, tmp_path):
    np.save(tmp_path / 'p.npy', bundled, allow_pickle=True)
    for weights in (pretrained.bundled_path('frcnnv3'), tmp_path / 'p.npy'):
        fd = FaceDetector(detector='frcnnv3', image_shape=SMALL,
                          weights=weights, device='cpu')
        tree = fd.backend_for(SMALL).to_flax_params()
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            lambda a, b: np.array_equal(a, np.float32(b)), tree, bundled))


def test_app_through_both_clis(tmp_path, jax_det, jax_trainer, monkeypatch):
    """The JAX app trains JAX's float32 trainer of this module (its step
    compiled once, batch 2 at 128x128), the port's app its bf16 default;
    each output serves in the other package's facade."""
    from facenet_tpu.apps.train_detector import main as jax_main
    from facenet_tpu_torch.apps import train_detector

    from facenet_tpu_torch.utils.synthetic import write_detection_dataset
    ann = write_detection_dataset(tmp_path / 'scenes', 6, shape=SMALL,
                                  seed=0, min_face=30, max_face=90)
    monkeypatch.setattr(jax_detector, 'FasterRCNN',
                        lambda image_shape: jax_det)
    monkeypatch.setattr(jax_detector, 'FasterRCNNTrainer',
                        lambda det, learning_rate: jax_trainer)
    files = {}
    for name in ('jax', 'port'):
        cfg = {'detector': 'frcnnv3', 'annotations': str(ann), 'seed': 0,
               'model': {'path': str(tmp_path / name)}, 'batch_size': 2,
               'image': {'height': SMALL[0], 'width': SMALL[1]},
               'train': {'learning_rate': 0.001,
                         'epoch': {'max_nrof_epochs': 1, 'size': 3}}}
        cfg_file = tmp_path / f'{name}.yaml'
        cfg_file.write_text(yaml.safe_dump(cfg))
        if name == 'jax':
            result = CliRunner().invoke(jax_main, ['--config', str(cfg_file)])
            assert result.exit_code == 0, result.output
        else:
            train_detector.main(['--config', str(cfg_file), '--device',
                                 'cpu'])
        (files[name],) = (tmp_path / name).glob('*/detector_params.npy')

    image = np.asarray(Image.open(ann.parent / 'scene_00000.png'))
    port_params = np.load(files['port'], allow_pickle=True).item()
    assert set(port_params) == {'backbone', 'rpn', 'head'}
    jax_fd = JaxFaceDetector(detector='frcnnv3', image_shape=SMALL,
                             params=port_params)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, jax_fd.backend_for(SMALL).params, port_params))
    fd = FaceDetector(detector='frcnnv3', image_shape=SMALL,
                      weights=files['jax'], device='cpu')
    jax_params = np.load(files['jax'], allow_pickle=True).item()
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, fd.backend_for(SMALL).to_flax_params(), jax_params))
    assert isinstance(fd.detect(image), list)
