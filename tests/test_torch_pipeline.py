"""The port's FacePipeline (facenet_tpu_torch/pipeline.py) against the JAX
package on the CPU, with the same TINY IRv1 bundle, the bundled MTCNN
weights and the scenes of tests/test_pipeline.py.

- crop mode against JAX's FacePipeline: the same valid slots, embeddings
  cos >= 0.999 on valid slots;
- landmarks mode against a JAX staged chain, MTCNN.detect_batch ->
  align_by_landmarks(method='dense') -> FaceNet (JAX's own FacePipeline
  takes 'gather' on the CPU): the port's pipeline (which takes 'gather' on
  the CPU too) and the port's own staged chain through the dense warp
  (B2's plain version) both reach cos >= 0.99.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from facenet_tpu.config import Config
from facenet_tpu.utils.synthetic import render_scene
from span_recording import spans  # noqa: F401

TINY_MODEL = Config({'block35': {'repeat': 1}, 'block17': {'repeat': 1},
                     'block8_1': {'repeat': 1}, 'output': {'size': 32}})
SHAPE = (256, 256)


@pytest.fixture(scope='module')
def bundle_path(tmp_path_factory):
    from facenet_tpu import export
    from facenet_tpu.models.inception_resnet_v1 import InceptionResnetV1

    path = tmp_path_factory.mktemp('model') / 'bundle'
    model = InceptionResnetV1(config=TINY_MODEL)
    variables = model.init(jax.random.PRNGKey(0),
                           np.zeros((1, 160, 160, 3), np.uint8), train=False)
    export.save_model(path, model, variables)
    return path


@pytest.fixture(scope='module')
def scenes():
    rng = np.random.RandomState(11)
    return np.stack([render_scene(rng, shape=SHAPE, n_faces=1,
                                  min_face=80, max_face=140)[0]
                     for _ in range(2)])


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope='module')
def jax_crop_pipeline(bundle_path):
    """JAX's crop-mode pipeline, compiled once for the module's tests."""
    from facenet_tpu.pipeline import FacePipeline as JaxPipeline
    return JaxPipeline(bundle_path, image_shape=SHAPE, align='crop')


def test_pipeline_crop_mode_matches_jax(bundle_path, scenes,
                                        jax_crop_pipeline):
    from facenet_tpu_torch.pipeline import FacePipeline

    want = jax_crop_pipeline.process_batch(scenes)
    got = FacePipeline(bundle_path, image_shape=SHAPE, align='crop',
                       device='cpu').process_batch(scenes)
    assert got['embeddings'].shape == (2, 1, 32)
    np.testing.assert_array_equal(got['valid'], want['valid'])
    valid = got['valid']
    assert valid.all()
    assert _cos(got['embeddings'], want['embeddings'])[valid].min() >= 0.999
    np.testing.assert_allclose(np.linalg.norm(got['embeddings'][valid], axis=-1),
                               1.0, atol=1e-3)
    assert np.abs(got['boxes'][valid] - want['boxes'][valid]).max() < 1.5


def test_pipeline_landmarks_mode_matches_jax_staged_chain(bundle_path,
                                                          scenes):
    from facenet_tpu import FaceNet as JaxFaceNet
    from facenet_tpu.detectors.mtcnn.cascade import MTCNN
    from facenet_tpu.detectors.pretrained import load_bundled
    from facenet_tpu.ops.image_ops import align_by_landmarks
    from facenet_tpu_torch.ops import image_ops
    from facenet_tpu_torch.pipeline import FacePipeline

    det = MTCNN(image_shape=SHAPE,
                params=load_bundled('mtcnn')).detect_batch(scenes)
    crops = np.asarray(align_by_landmarks(
        jnp.asarray(scenes, jnp.float32), jnp.asarray(det['landmarks'][:, 0]),
        160, method='dense'))
    crops = np.clip(crops + 0.5, 0, 255).astype(np.uint8)
    want = JaxFaceNet(Config({'path': str(bundle_path)})).evaluate(crops)

    pipe = FacePipeline(bundle_path, image_shape=SHAPE, align='landmarks',
                        num_faces=2, device='cpu')
    got = pipe.process_batch(scenes)
    assert got['embeddings'].shape == (2, 2, 32)
    np.testing.assert_array_equal(got['valid'], np.asarray(det['valid'])[:, :2])
    assert got['valid'][:, 0].all()
    assert _cos(got['embeddings'][:, 0], want).min() >= 0.99

    # the port's staged chain through the dense warp, as the card runs it
    with torch.inference_mode():
        x = torch.from_numpy(scenes)
        lmk = pipe.backend._detect(x)['landmarks'][:, 0]
        crops = image_ops.align_by_landmarks(x.float(), lmk, 160,
                                             method='dense')
        dense = pipe.facenet.dispatch(
            torch.clamp(crops + 0.5, 0, 255).to(torch.uint8)).numpy()
    assert _cos(dense, want).min() >= 0.99


def test_pipeline_process_files(bundle_path, scenes, tmp_path):
    from facenet_tpu_torch.pipeline import FacePipeline

    paths = []
    for i, img in enumerate(scenes):
        p = tmp_path / f's{i}.png'
        Image.fromarray(img).save(p)
        paths.append(p)
    bad = tmp_path / 'bad.png'
    bad.write_bytes(b'not an image')
    paths.append(bad)

    pipe = FacePipeline(bundle_path, image_shape=SHAPE, align='crop',
                        device='cpu')
    emb, boxes, valid = pipe.process_files(paths, batch_size=2)
    assert emb.shape == (3, 1, 32)
    assert valid[:2].all() and not valid[2].any()
    ref = pipe.process_batch(scenes)
    np.testing.assert_allclose(emb[:2, 0], ref['embeddings'][:, 0], atol=1e-4)
    np.testing.assert_allclose(boxes[:2], ref['boxes'], atol=1e-4)
    with pytest.raises(ValueError, match='letterbox'):
        pipe.process_batch(np.zeros((1, 128, 128, 3), np.uint8))
    with pytest.raises(ValueError, match='align'):
        FacePipeline(pipe.facenet, image_shape=SHAPE, align='rotate')
    assert isinstance(pipe.dispatch(scenes)['embeddings'], torch.Tensor)


def test_process_files_matches_jax(bundle_path, scenes, jax_crop_pipeline,
                                   tmp_path):
    """`process_files` on a JPEG, a PNG and an unreadable file, decoded by
    the port's native library (PIL where it is not built) and by JAX's:
    the same valid rows, embeddings at cosine >= 0.999, boxes within 1.5
    px in the scenes' pixels."""
    from facenet_tpu_torch import native
    from facenet_tpu_torch.pipeline import FacePipeline

    paths = [tmp_path / 's0.jpg', tmp_path / 's1.png', tmp_path / 'bad.jpg']
    Image.fromarray(scenes[0]).save(paths[0], quality=95)
    Image.fromarray(scenes[1]).save(paths[1])
    paths[2].write_bytes(b'not an image')
    native.reset_rows_decoded()
    got = FacePipeline(bundle_path, image_shape=SHAPE, align='crop',
                       device='cpu').process_files(paths, batch_size=2)
    if native.available():
        assert native.rows_decoded() == 2
    want = jax_crop_pipeline.process_files(paths, batch_size=2)
    np.testing.assert_array_equal(got[2], want[2])
    valid = got[2]
    assert valid[:2, 0].all() and not valid[2].any()
    assert _cos(got[0][valid], want[0][valid]).min() >= 0.999
    assert np.abs(got[1][valid] - want[1][valid]).max() < 1.5


def test_pipeline_spans_once_a_batch(bundle_path, scenes, spans):
    """With host recording on, each batch opens every span of the pipeline
    once, the embedder's nested in ``pipeline.embed``; the outputs are those
    of recording off."""
    from facenet_tpu_torch.pipeline import FacePipeline

    pipe = FacePipeline(bundle_path, image_shape=SHAPE, align='landmarks',
                        num_faces=2, device='cpu')
    batches = [scenes, scenes[::-1].copy(), scenes[:1]]
    spans.record_spans(False)
    off = [pipe.process_batch(b) for b in batches]
    spans.record_spans(True)
    on = [pipe.process_batch(b) for b in batches]
    for a, b in zip(on, off):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    got = spans.span_summary()
    names = ('pipeline.h2d', 'mtcnn.pnet', 'mtcnn.rnet', 'mtcnn.onet',
             'pipeline.align', 'pipeline.embed', 'facenet.h2d',
             'facenet.forward')
    assert {name: got[name]['count'] for name in names} == \
        dict.fromkeys(names, len(batches))
    embed = got['pipeline.embed']
    assert embed['self_s'] == pytest.approx(
        embed['total_s'] - got['facenet.h2d']['total_s']
        - got['facenet.forward']['total_s'], abs=1e-9)
