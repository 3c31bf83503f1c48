"""The batched detectors' shared front end (`detectors.batched`).

`MTCNN`, `RetinaFace` and `FasterRCNN` take `to_device`,
`detect_batch_async`, `finalize_batch` and `detect_batch` from
`BatchedDetector` and redefine none of them; each refuses a batch of
another geometry with the letterbox hint; `detect_batch` is
`finalize_batch(detect_batch_async(x))`; a capacity drop is reported in
the detector's own words. On the CPU at small frames, bundled or seeded
weights, float32.
"""

import numpy as np
import pytest
import torch

from facenet_tpu_torch.detectors import pretrained
from facenet_tpu_torch.detectors.batched import BatchedDetector
from facenet_tpu_torch.detectors.frcnn.detector import FasterRCNN
from facenet_tpu_torch.detectors.mtcnn.cascade import MTCNN
from facenet_tpu_torch.detectors.retinaface.detector import RetinaFace
from facenet_tpu_torch.utils.synthetic import render_scene
from torch_testing import few_threads  # noqa: F401

SHAPE = (64, 96)
NAMES = ['mtcnn', 'retinaface', 'frcnnv3']
METHODS = ['to_device', 'detect_batch_async', 'finalize_batch',
           'detect_batch']


@pytest.fixture(scope='module')
def detectors():
    return {
        'mtcnn': MTCNN(image_shape=SHAPE, device='cpu', dtype=torch.float32,
                       params=pretrained.load_bundled('mtcnn')),
        'retinaface': RetinaFace(image_shape=SHAPE, device='cpu',
                                 dtype=torch.float32, top_k=120,
                                 keep_top_k=30),
        'frcnnv3': FasterRCNN(image_shape=SHAPE, device='cpu',
                              dtype=torch.float32,
                              params=pretrained.load_bundled('frcnnv3')),
    }


@pytest.fixture(scope='module')
def scenes():
    rng = np.random.RandomState(11)
    return np.stack([render_scene(rng, shape=SHAPE, n_faces=2, min_face=20,
                                  max_face=40)[0] for _ in range(2)])


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_same(got[key], value)
        else:
            assert got[key].dtype == value.dtype
            np.testing.assert_array_equal(got[key], value)


@pytest.mark.parametrize('name', NAMES)
def test_each_detector_takes_the_shared_front_end(detectors, name):
    det = detectors[name]
    assert isinstance(det, BatchedDetector)
    for method in METHODS:
        assert method not in vars(type(det)), method
        assert getattr(type(det), method) is getattr(BatchedDetector, method)


@pytest.mark.parametrize('name', NAMES)
def test_to_device_refuses_another_geometry(detectors, name):
    det = detectors[name]
    wrong = np.zeros((1, SHAPE[0] + 1, SHAPE[1], 3), np.uint8)
    want = (rf'expected \(64, 96\) images, got \(65, 96\) — use '
            r'letterbox\.letterbox_batch\(\)')
    with pytest.raises(ValueError, match=want):
        det.to_device(wrong)
    with pytest.raises(ValueError, match=want):
        det.detect_batch(torch.from_numpy(wrong))
    ok = det.to_device(np.zeros((1, *SHAPE, 3), np.uint8))
    assert ok.dtype == torch.uint8 and ok.shape == (1, *SHAPE, 3)


@pytest.mark.parametrize('name', NAMES)
def test_detect_batch_is_finalize_of_async(detectors, scenes, name):
    det = detectors[name]
    got = det.detect_batch(scenes)
    want = det.finalize_batch(det.detect_batch_async(scenes))
    _assert_same(got, want)
    assert got['boxes'].shape[:1] == (2,)
    assert ('overflow' in got) == (name != 'frcnnv3')


@pytest.mark.parametrize('name, words', [
    ('mtcnn', 'MTCNN capacity overflow: dropped valid proposals '
              "{'rnet': 3} (raise max_proposals/max_refined/max_outputs "
              'for dense scenes)'),
    ('retinaface', "RetinaFace capacity overflow: dropped {'rnet': 3} "
                   '(raise top_k / keep_top_k for dense scenes)'),
])
def test_capacity_drops_are_reported_in_the_detectors_words(
        detectors, monkeypatch, name, words):
    from facenet_tpu_torch.logging import logger
    warned = []
    monkeypatch.setattr(logger, 'warning',
                        lambda msg, *args: warned.append(msg % args))
    out = detectors[name].finalize_batch({
        'valid': torch.ones(2, 1, dtype=torch.bool),
        'overflow': {'pnet': torch.zeros(2, dtype=torch.int32),
                     'rnet': torch.tensor([1, 2], dtype=torch.int32)}})
    assert warned == [words]
    assert out['overflow']['rnet'].tolist() == [1, 2]
