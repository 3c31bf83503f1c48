"""The port's letterbox (facenet_tpu_torch/detectors/mtcnn/letterbox.py)
in its numpy restatement, with PIL decoding the files, against the JAX
package's default path, the native library (``facenet_tpu.native``:
``letterbox_array`` and the ``MODE_LETTERBOX`` decode). The restatement is
what runs where the port's own native library is not built, so every test
here turns the port's library off; tests/test_torch_native.py holds the
port's library to JAX's.

Tolerance 0 everywhere: the port restates the library's integer resize,
and its source coordinate in the fused multiply-add form that the
library's ``-O3 -march=native`` build computes (`letterbox._taps`). Each
test skips only where the native library cannot be built.
"""

import numpy as np
import pytest
from PIL import Image

from facenet_tpu.detectors.mtcnn import cascade as jcascade
from facenet_tpu_torch.detectors.face_detector import FaceDetector
from facenet_tpu_torch.detectors.mtcnn import letterbox
from facenet_tpu_torch.utils.synthetic import render_scene
from torch_testing import few_threads  # noqa: F401


@pytest.fixture(scope='module')
def native():
    from facenet_tpu import native as lib
    if not lib.available():
        pytest.skip('the JAX package\'s native library is not available')
    return lib


@pytest.fixture(autouse=True)
def numpy_restatement(monkeypatch):
    from facenet_tpu_torch import native as port_native
    monkeypatch.setattr(port_native, 'available', lambda: False)


def _max_diff(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _sizes(rng, n):
    """(h, w, th, tw): random downscales and upscales, odd sizes, and
    images and targets one pixel wide or high."""
    sizes = [tuple(int(v) for v in rng.randint(1, 700, 4)) for _ in range(n)]
    sizes += [(1, int(rng.randint(1, 300)), int(rng.randint(1, 200)),
               int(rng.randint(1, 200))),
              (int(rng.randint(1, 300)), 1, int(rng.randint(1, 200)),
               int(rng.randint(1, 200))),
              (int(rng.randint(2, 300)), int(rng.randint(2, 300)), 1,
               int(rng.randint(1, 200))),
              (int(rng.randint(2, 300)), int(rng.randint(2, 300)),
               int(rng.randint(1, 200)), 1)]
    return sizes


@pytest.mark.parametrize('seed', range(5))
def test_letterbox_equals_native_on_random_sizes(native, seed):
    """5 x 16 random (image, target) sizes, down and up, 1-pixel sides."""
    rng = np.random.RandomState(seed)
    for h, w, th, tw in _sizes(rng, 12):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        got, scales, pads = letterbox.letterbox_batch([img], (th, tw))
        assert _max_diff(got[0], native.letterbox_array(img, (th, tw))) == 0, \
            (h, w, th, tw)
        assert (float(scales[0]), tuple(pads[0])) == \
            native.letterbox_geometry(h, w, (th, tw))


@pytest.mark.parametrize('shape,target', [
    ((720, 960), (480, 640)),       # the cascade's default, 2/3
    ((360, 480), (240, 320)),
    ((480, 640), (240, 320)),
    ((200, 260), (240, 320)),       # upscale
    ((480, 640), (480, 640))])      # scale 1
def test_letterbox_equals_native_on_scenes(native, shape, target):
    """Rendered scenes (smooth regions and sharp face edges), where PIL's
    antialiased filter differed by up to 53."""
    rng = np.random.RandomState(11)
    img, _, _ = render_scene(rng, shape=shape, n_faces=3, min_face=30,
                             max_face=120)
    got = letterbox.letterbox_batch([img], target)[0][0]
    assert _max_diff(got, native.letterbox_array(img, target)) == 0


def test_letterbox_channel_layouts_equal_jax(native):
    """Grayscale [H, W] and [H, W, 1], RGBA and float input through the
    port's and JAX's `letterbox_batch` (the native path)."""
    rng = np.random.RandomState(12)
    imgs = [rng.randint(0, 256, (97, 131)).astype(np.uint8),
            rng.randint(0, 256, (64, 45, 1)).astype(np.uint8),
            rng.randint(0, 256, (150, 90, 4)).astype(np.uint8),
            rng.uniform(-20, 280, (33, 70, 3)).astype(np.float32)]
    got = letterbox.letterbox_batch(imgs, (72, 96))
    want = jcascade.letterbox_batch(imgs, (72, 96))
    assert _max_diff(got[0], want[0]) == 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    with pytest.raises(ValueError, match='expected'):
        letterbox.letterbox_batch([np.zeros((4, 4, 2), np.uint8)], (8, 8))


def test_resize_coordinates_are_the_fused_form(native):
    """65 -> 313 rows: one float32 rounding of (i + 0.5) * s - 0.5 (the
    fused multiply-add of the reference build) and two roundings give
    different weights here, and the reference agrees with the fused one."""
    f32 = np.float32
    s = f32(65) / f32(313)
    centre = np.arange(313, dtype=f32) + f32(0.5)
    two = np.maximum(f32(0), (centre * s).astype(f32) - f32(0.5))
    i0, _, weight = letterbox._taps(65, 313)
    two_weight = ((two - two.astype(np.int32)).astype(np.float64) * 4096
                  + 0.5).astype(f32).astype(np.int32)
    assert (two_weight != weight).any()
    rng = np.random.RandomState(0)
    for _ in range(8):
        img = rng.randint(0, 256, (65, 64, 3)).astype(np.uint8)
        got = letterbox.letterbox_batch([img], (313, 308))[0][0]
        assert _max_diff(got, native.letterbox_array(img, (313, 308))) == 0


@pytest.mark.parametrize('shape', [(720, 960), (1080, 1440), (2000, 1001),
                                   (481, 641), (100, 130)])
def test_letterbox_file_equals_native_decode(native, tmp_path, shape):
    """JPEGs decoded at the native loader's DCT scale (1/1 to 1/8) and
    letterboxed by their native size, and a PNG, against
    ``decode_image(..., MODE_LETTERBOX)``: tolerance 0."""
    rng = np.random.RandomState(shape[0])
    img, _, _ = render_scene(rng, shape=shape, n_faces=2, min_face=40,
                             max_face=min(shape) // 2)
    for suffix in ('jpg', 'png'):
        path = tmp_path / f'scene.{suffix}'
        Image.fromarray(img).save(path)
        for target in ((480, 640), (240, 320), (96, 96)):
            want = native.decode_image(str(path), target,
                                       native.MODE_LETTERBOX)
            got, scale, pad = letterbox.letterbox_file(
                str(path), lambda h, w, target=target: target)
            assert _max_diff(got, want) == 0, (suffix, target)
            assert (scale, pad) == native.letterbox_geometry(*shape, target)


def test_jpeg_reduction_follows_libjpeg_scaling(native, tmp_path):
    """The smallest M/8 decode that covers the scaled size, also where
    PIL's own rule would pick another."""
    assert letterbox._jpeg_reduction(720, 960, (480, 640)) == 1
    assert letterbox._jpeg_reduction(1080, 1440, (480, 640)) == 2
    assert letterbox._jpeg_reduction(3000, 4000, (480, 640)) == 4
    assert letterbox._jpeg_reduction(3000, 4000, (96, 96)) == 8
    # ceil(1001 / 8) = 126 covers the scaled width 126, ceil(41 / 8) = 6
    # the scaled height 5; PIL's rule, min(1001 // 126, 41 // 5) = 7,
    # would decode at 1/4
    assert letterbox._jpeg_reduction(41, 1001, (101, 126)) == 8
    rng = np.random.RandomState(14)
    path = tmp_path / 'wide.jpg'
    Image.fromarray(rng.randint(0, 256, (41, 1001, 3)).astype(np.uint8)) \
        .save(path)
    want = native.decode_image(str(path), (101, 126), native.MODE_LETTERBOX)
    got = letterbox.letterbox_file(str(path), lambda h, w: (101, 126))[0]
    assert _max_diff(got, want) == 0


def test_detect_files_feeds_the_native_letterbox(native, tmp_path):
    """`FaceDetector.detect_files` hands the cascade the canvas that
    ``NativeBatchLoader(MODE_LETTERBOX)`` gives JAX's detector, and maps
    boxes back by the native size; an unreadable file gets []."""
    rng = np.random.RandomState(13)
    img, gt, _ = render_scene(rng, shape=(480, 640), n_faces=1,
                              min_face=120, max_face=160)
    path = tmp_path / 'a.jpg'
    Image.fromarray(img).save(path, quality=92)
    (tmp_path / 'bad.jpg').write_bytes(b'not an image')

    fd = FaceDetector(image_shape=(192, 256), device='cpu')
    backend = fd.backend_for((192, 256))
    seen = []
    detect_batch = backend.detect_batch
    backend.detect_batch = lambda batch: seen.append(batch) or \
        detect_batch(batch)
    got = fd.detect_files([path, tmp_path / 'bad.jpg'])
    assert len(seen) == 1 and seen[0].shape == (1, 192, 256, 3)
    want = native.decode_image(str(path), (192, 256), native.MODE_LETTERBOX)
    assert _max_diff(seen[0][0], want) == 0
    assert got[1] == []
    assert len(got[0]) == 1
    box = got[0][0]
    pred = [box.left, box.top, box.left + box.width, box.top + box.height]
    from facenet_tpu_torch.detectors import evaluation
    assert evaluation.iou_matrix(gt, pred)[0, 0] > 0.5


@pytest.mark.parametrize('shape', [(3, 6000), (5, 6000), (7, 6000),
                                   (2, 3000), (6000, 3), (4, 4000),
                                   (7, 2000), (1, 5000), (300, 400),
                                   (1000, 2000)])
def test_letterbox_file_decodes_thin_jpegs_at_the_native_scale(
        native, tmp_path, shape):
    """A side shorter than the DCT reduction k: PIL's ``draft`` would pick
    its scale from that side; the forced scale decodes at 1/k as libjpeg
    does in the native loader. Random JPEGs into 480x640, tolerance 0."""
    rng = np.random.RandomState(shape[0] * 7 + shape[1])
    path = tmp_path / 'thin.jpg'
    Image.fromarray(rng.randint(0, 256, shape + (3,)).astype(np.uint8)) \
        .save(path)
    want = native.decode_image(str(path), (480, 640), native.MODE_LETTERBOX)
    got, scale, pad = letterbox.letterbox_file(str(path),
                                               lambda h, w: (480, 640))
    assert _max_diff(got, want) == 0
    assert (scale, pad) == native.letterbox_geometry(*shape, (480, 640))


def test_forced_jpeg_scale_needs_the_pillow_internals(tmp_path):
    """`force_jpeg_scale` rests on ``ImageFile._Tile``, ``decoderconfig``
    and ``_size``: they are present here, the decode comes out at
    ceil(side / k), and an image already drafted raises instead of
    decoding at another scale."""
    from PIL import ImageFile
    assert hasattr(ImageFile, '_Tile')
    path = tmp_path / 'a.jpg'
    Image.fromarray(np.full((5, 6000, 3), 128, np.uint8)).save(path)
    with Image.open(path) as img:
        assert hasattr(img, 'decoderconfig') and hasattr(img, '_size')
        letterbox.force_jpeg_scale(img, 8)
        assert np.asarray(img.convert('RGB')).shape == (1, 750, 3)
    with Image.open(path) as img:
        img.draft('RGB', (750, 1))
        with pytest.raises(RuntimeError, match='DCT scale'):
            letterbox.force_jpeg_scale(img, 8)
