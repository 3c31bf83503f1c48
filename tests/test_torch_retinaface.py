"""RetinaFace-R50 in the port against the benchmark's plain reference
(``benchmark/reference/retinaface.py``), on the CPU at a small frame size
with seeded random weights at the published widths.

The float32 network is held to the reference tightly (the port folds each
BatchNorm into its convolution, in float64), the served bf16 network
within bf16's reach; priors and decode are equal bit for bit; the
selection (threshold, top-k, greedy NMS with +1 areas, keep) is equal on
identical dense inputs, ties included; the pipeline and the `FaceDetector`
facade run it end to end.
"""

import numpy as np
import pytest
import torch

from benchmark.core import weights
from benchmark.reference import retinaface as ref
from facenet_tpu_torch.detectors.retinaface import network
from facenet_tpu_torch.detectors.retinaface.detector import RetinaFace
from torch_testing import few_threads  # noqa: F401

SHAPE = (64, 96)
CFG = {'in_channel': 256, 'out_channel': 256, 'anchors': 2,
       'mean_bgr': [104, 117, 123], 'min_sizes': [[16, 32], [64, 128],
                                                  [256, 512]],
       'steps': [8, 16, 32], 'variance': [0.1, 0.2], 'clip': False,
       'image_shape': list(SHAPE), 'confidence_threshold': 0.02,
       'top_k': 120, 'nms_threshold': 0.4, 'keep_top_k': 30}
CAPS = {'top_k': CFG['top_k'], 'keep_top_k': CFG['keep_top_k']}


@pytest.fixture(scope='module')
def leaves():
    return weights.make(ref.spec(CFG), 7, 'cpu')


@pytest.fixture(scope='module')
def frames():
    rng = np.random.RandomState(3)
    return torch.from_numpy(rng.randint(0, 256, (2, *SHAPE, 3))
                            .astype(np.uint8))


@pytest.fixture(scope='module')
def reference_dense(leaves, frames):
    with torch.no_grad():
        return ref.Net(ref.Tree(leaves), CFG).forward(frames)


def _detector(leaves, dtype):
    return RetinaFace(image_shape=SHAPE, params=ref.published_state(leaves),
                      dtype=dtype, device='cpu', **CAPS)


def _gaps(got, want):
    """Per head: (largest, mean) |got - want| over want's RMS."""
    out = []
    for g, w in zip(got, want):
        rms = float(w.square().mean().sqrt())
        d = (g - w).abs()
        out.append((float(d.max()) / rms, float(d.mean()) / rms))
    return out


@pytest.mark.parametrize('dtype, largest, mean', [
    # folded in float64, rounded once to float32: float32 rounding only
    (torch.float32, 1e-4, 1e-5),
    # bf16 activations through 50 layers: ~1e-2 of the heads' RMS at the
    # mean (fp8 reads 0.1 and more, benchmark/tests)
    (torch.bfloat16, 0.25, 0.03)])
def test_network_matches_the_reference(leaves, frames, reference_dense,
                                       dtype, largest, mean):
    det = _detector(leaves, dtype)
    with torch.inference_mode():
        got = det.dense(frames)
    assert [tuple(g.shape) for g in got] == \
        [tuple(r.shape) for r in reference_dense]
    assert all(g.dtype == torch.float32 for g in got)
    for big, avg in _gaps(got, reference_dense):
        assert big < largest and avg < mean


def test_published_weights_load_by_name(leaves):
    state = ref.published_state(leaves)
    net = network.RetinaFaceNet().load_weights(
        {f'module.{k}': v for k, v in state.items()})
    assert sum(p.numel() for p in net.parameters()) == 27_293_600
    assert torch.equal(net.fpn.output1[0].weight,
                       state['fpn.output1.0.weight'])
    with pytest.raises(ValueError, match='missing'):
        network.RetinaFaceNet().load_weights(
            {k: v for k, v in state.items() if 'ssh3' not in k})
    bad = dict(state, **{'ClassHead.0.conv1x1.bias': torch.zeros(3)})
    with pytest.raises(ValueError, match='ClassHead.0.conv1x1.bias'):
        network.RetinaFaceNet().load_weights(bad)


@pytest.mark.parametrize('shape', [SHAPE, (97, 131), (1080, 1920)])
def test_priors_match(shape):
    got = network.prior_boxes(*shape)
    want = ref.priors(CFG, shape).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)
    if shape == (1080, 1920):
        assert len(got) == 2 * (135 * 240 + 68 * 120 + 34 * 60) == 85_200


def test_decode_matches():
    rng = np.random.RandomState(1)
    prior = torch.from_numpy(network.prior_boxes(*SHAPE))
    loc = torch.from_numpy(rng.normal(0, 3, (2, len(prior), 4))
                           .astype(np.float32))
    landm = torch.from_numpy(rng.normal(0, 3, (2, len(prior), 10))
                             .astype(np.float32))
    assert torch.equal(network.decode(loc, prior),
                       ref.decode(loc, prior, CFG['variance']))
    assert torch.equal(network.decode_landmarks(landm, prior),
                       ref.decode_landm(landm, prior, CFG['variance']))


def _dense(case, n, b=2, seed=5):
    rng = np.random.RandomState(seed)
    conf = rng.normal(0, 4, (b, n, 2))
    loc = rng.normal(0, 1.5, (b, n, 4))
    landm = rng.normal(0, 2, (b, n, 10))
    if case == 'tied':
        # scores on a few levels (many saturate at exactly 1), a run of
        # identical candidates, and a frame with few over the threshold
        conf = np.round(conf / 3) * 30
        loc[:, 1::5] = loc[:, 0::5][:, :loc[:, 1::5].shape[1]]
        conf[1, :, 1] = -30
        conf[1, ::40, 1] = 30
    return [torch.from_numpy(a.astype(np.float32)) for a in (conf, loc,
                                                            landm)]


@pytest.mark.parametrize('case', ['random', 'tied'])
def test_selection_matches_exactly(leaves, case):
    det = _detector(leaves, torch.float32)
    conf, loc, landm = _dense(case, len(det.priors))
    got = det.select(conf, loc, landm)
    want = ref.select(conf, loc, landm, CFG)
    for key in ('boxes', 'scores', 'landmarks', 'valid'):
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(got['overflow']['topk'].long(),
                       (want['over'] - CFG['top_k']).clamp(min=0))
    assert torch.equal(got['overflow']['keep'].long(),
                       (want['kept'] - CFG['keep_top_k']).clamp(min=0))
    assert torch.equal(got['candidates'].long(),
                       want['over'].clamp(max=CFG['top_k']))
    assert int(got['valid'].sum()) > 0


def _facenet():
    from facenet_tpu_torch import FaceNet
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.export import ModelBundle
    from facenet_tpu_torch.models.inception_resnet_v1 import init_variables
    tiny = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
            'block8_1': {'repeat': 1}, 'output': {'size': 32}}
    bundle = ModelBundle(init_variables(tiny), {
        'model_class': 'InceptionResnetV1', 'config': tiny,
        'image_size': 160, 'normalization': 0})
    return FaceNet(Config({'normalize': True}), device='cpu', bundle=bundle)


def test_pipeline_runs_retinaface(leaves, frames):
    from facenet_tpu_torch.ops.image_ops import align_by_landmarks
    from facenet_tpu_torch.pipeline import FacePipeline
    facenet = _facenet()
    with pytest.raises(ValueError, match='frcnnv3'):
        FacePipeline(facenet, image_shape=SHAPE, device='cpu',
                     detector='frcnnv3')
    pipe = FacePipeline(facenet, image_shape=SHAPE, align='landmarks',
                        num_faces=4, device='cpu', detector='retinaface',
                        params=ref.published_state(leaves), **CAPS)
    out = pipe.process_batch(frames.numpy())
    assert out['embeddings'].shape == (2, 4, 32)
    assert out['landmarks'].shape == (2, 4, 5, 2)
    assert out['valid'].all() and out['candidates'].shape == (2,)
    norms = np.linalg.norm(out['embeddings'], axis=-1)
    assert np.allclose(norms, 1, atol=1e-3)
    # the detector's own outputs, aligned and embedded apart
    det = pipe.backend.detect_batch(frames.numpy())
    assert np.array_equal(det['boxes'][:, :4], out['boxes'])
    crops = align_by_landmarks(frames.float(),
                               torch.from_numpy(det['landmarks'][:, :4]),
                               160, method='dense')
    flat = torch.clamp(crops + 0.5, 0, 255).to(torch.uint8)
    emb = pipe.facenet.evaluate(flat.reshape(8, 160, 160, 3).numpy())
    assert np.abs(emb.reshape(2, 4, -1) - out['embeddings']).max() < 1e-5


def test_face_detector_accepts_retinaface(leaves, tmp_path, caplog):
    from facenet_tpu_torch.detectors.face_detector import FaceDetector
    with caplog.at_level('WARNING', logger='facenet_tpu_torch'):
        FaceDetector('retinaface', image_shape=SHAPE, device='cpu', **CAPS)
    assert 'no bundled weights' in caplog.text
    state = {k: v.numpy() for k, v in ref.published_state(leaves).items()}
    pth = tmp_path / 'Resnet50_Final.pth'
    torch.save({f'module.{k}': torch.from_numpy(v)
                for k, v in state.items()}, pth)
    images = [np.random.RandomState(i).randint(0, 256, (50 + 7 * i, 80, 3))
              .astype(np.uint8) for i in range(3)]
    found = FaceDetector('retinaface', image_shape=SHAPE, device='cpu',
                         weights=str(pth), **CAPS).detect_images(images)
    direct = FaceDetector('retinaface', image_shape=SHAPE, device='cpu',
                          params=state, **CAPS).detect_images(images)
    assert [len(f) for f in direct] == [len(f) for f in found]
    assert sum(len(f) for f in direct) > 0
    first = direct[0][0]
    assert first.landmarks.shape == (5, 2)
    assert repr(first) == repr(found[0][0])
