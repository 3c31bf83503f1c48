"""The port's detector facade and extract_faces app on the CPU.

`FaceDetector(device='cpu')` with the bundled weights must clear the JAX
bundle's quality gate (tests/test_detector_quality.py: seed 555, 32
held-out 256x256 scenes, recall >= 0.97, precision >= 0.97, mean IoU
>= 0.5); the app must write real crops; entry points given no device must
raise on a machine without a GPU.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from facenet_tpu_torch.detectors import evaluation
from facenet_tpu_torch.detectors.face_detector import BoundingBox, FaceDetector
from facenet_tpu_torch.utils.synthetic import render_scene
from torch_testing import few_threads  # noqa: F401

SHAPE = (256, 256)


def _held_out_scenes(n, seed):
    rng = np.random.RandomState(seed)
    return [render_scene(rng, shape=SHAPE, n_faces=rng.randint(1, 4),
                         min_face=32, max_face=160) for _ in range(n)]


def test_bundled_mtcnn_quality_gate():
    scenes = _held_out_scenes(32, seed=555)
    fd = FaceDetector(image_shape=SHAPE, device='cpu')
    m = evaluation.evaluate_detector(fd, [s[0] for s in scenes],
                                     [s[1] for s in scenes],
                                     iou_threshold=0.5, batch_size=16)
    assert m['recall'] >= 0.97, m
    assert m['precision'] >= 0.97, m
    assert m['mean_iou'] >= 0.5, m


def test_detect_maps_letterbox_back_and_routes_buckets(tmp_path):
    rng = np.random.RandomState(8)
    img, gt, lmk = render_scene(rng, shape=(200, 300), n_faces=1,
                                min_face=80, max_face=120)
    fd = FaceDetector(image_shapes=[(128, 128), (256, 320)], device='cpu')
    assert fd.route_shape(200, 300) == (256, 320)
    assert fd.route_shape(100, 100) == (128, 128)
    boxes = fd.detect(img)
    assert len(boxes) == 1 and isinstance(boxes[0], BoundingBox)
    box = boxes[0]
    pred = [box.left, box.top, box.left + box.width, box.top + box.height]
    assert evaluation.iou_matrix(gt, pred)[0, 0] > 0.5
    assert np.abs(box.landmarks - lmk[0]).max() < 12

    Image.fromarray(img).save(tmp_path / 'a.png')
    (tmp_path / 'bad.png').write_bytes(b'not an image')
    got = fd.detect_files([tmp_path / 'a.png', tmp_path / 'bad.png'])
    assert len(got[0]) == 1 and got[1] == []
    assert got[0][0].info() == box.info()


def test_detector_routes(tmp_path):
    """'frcnnv3' serves the bundled Faster-RCNN and ``weights=<dir>`` reads
    det1-3.npy (a missing file raises FileNotFoundError, not
    NotImplementedError); an unknown detector raises ValueError."""
    from facenet_tpu_torch.detectors.frcnn import FasterRCNN
    fd = FaceDetector(detector='frcnnv3', image_shape=(128, 128),
                      device='cpu')
    assert isinstance(fd.backend_for((128, 128)), FasterRCNN)
    assert isinstance(fd.detect(np.zeros((100, 120, 3), np.uint8)), list)
    with pytest.raises(FileNotFoundError):
        FaceDetector(weights=tmp_path / 'no_det_dir', device='cpu')
    with pytest.raises(ValueError, match='Undefined'):
        FaceDetector(detector='haar', device='cpu')


def test_entry_points_without_device_raise_on_cpu_only_box(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from facenet_tpu_torch import FacePipeline
    from facenet_tpu_torch.apps import extract_faces
    from facenet_tpu_torch.detectors.mtcnn.cascade import MTCNN

    with pytest.raises(RuntimeError, match='CUDA'):
        MTCNN(image_shape=(96, 96))
    with pytest.raises(RuntimeError, match='CUDA'):
        FaceDetector()
    with pytest.raises(RuntimeError, match='CUDA'):
        FacePipeline(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA'):
        extract_faces.main(['--config', str(tmp_path / 'none.yaml')])


def test_extract_faces_app_landmarks_on_cpu(tmp_path):
    import yaml
    from facenet_tpu_torch.apps.extract_faces import main

    raw = tmp_path / 'raw'
    rng = np.random.RandomState(99)
    for c in range(2):
        d = raw / f'p{c:02d}'
        d.mkdir(parents=True)
        for i in range(2):
            img, _, _ = render_scene(rng, shape=(200, 220), n_faces=1,
                                     min_face=70, max_face=130)
            Image.fromarray(img).save(d / f'{i}.png')
    (raw / 'p00' / 'broken.png').write_bytes(b'not an image')

    cfg = {
        'dataset': {'path': str(raw)},
        'outdir': str(tmp_path / 'out'),
        'detector': 'mtcnn',
        'image': {'size': 96, 'align': 'landmarks'},
        'detect_multiple_faces': False,
    }
    cfg_file = tmp_path / 'extract.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg))
    counters = main(['--config', str(cfg_file), '--device', 'cpu'])
    assert counters['unreadable'] == 1

    crops = sorted((tmp_path / 'out').glob('p*/*.png'))
    assert len(crops) >= 3, f'only {len(crops)}/4 faces extracted'
    assert {c.parent.name for c in crops} == {'p00', 'p01'}
    arr = np.asarray(Image.open(crops[0]).convert('RGB'), np.float32)
    assert arr.shape == (96, 96, 3)
    assert arr.std() > 20, 'crop looks like background noise'
    assert (tmp_path / 'out' / 'statistics.h5').exists()
    assert 'Number of extracted faces' in (tmp_path / 'out' /
                                           'log.txt').read_text()
