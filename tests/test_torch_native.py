"""The port's native image library (facenet_tpu_torch/native/) and the
paths that decode through it, against the JAX package's
(``facenet_tpu.native``) on the same seeded files.

- the library, from each of its two builds (the system's libjpeg and
  libpng, and Pillow's with the port's headers): every binding byte-equal
  to JAX's build (max |d| = 0) on JPEG and PNG, grayscale, RGBA, palette
  and 16-bit PNG, 1-pixel sides, a CMYK JPEG, a GIF, a truncated and a
  corrupt file; the batch loader's images and ok flags; the count of rows
  decoded;
- the build: its key and its lock, the Pillow build where the system's
  fails, both builds' messages where both fail; the probe tool;
- the loaders: `BatchLoader` and `PKPipeline` on the native path yield
  JAX's images, labels and order, resume from `state()`, split a batch
  over two ranks by `rows=`, load a GIF and a CMYK JPEG through the PIL
  retry and raise on an unreadable file, as JAX's do;
- detection: `detect_files` against JAX's (boxes 1.5 px, scores 0.02,
  IoU-matched as tests/test_torch_mtcnn.py), the two-deep dispatch, the
  buckets against the PIL path;
- every file path of the port decodes without PIL once the library is
  built.

Each test skips only where a native library cannot be built, as
tests/test_native.py does.
"""

import ctypes
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from facenet_tpu import dataset as jdataset
from facenet_tpu import native as jnative
from facenet_tpu_torch import dataset, native
from facenet_tpu_torch.config import Config
from facenet_tpu_torch.utils.synthetic import render_scene
from torch_testing import few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module', autouse=True)
def libraries():
    if not native.available():
        pytest.skip(f'the port\'s native library did not build: '
                    f'{native.build_error()}')
    if not jnative.available():
        pytest.skip('the JAX package\'s native library is not available')


@pytest.fixture(scope='module', params=native.VARIANTS)
def build(request):
    """The port's library from one build (`native.build`), in place of the
    one the module loaded, while the test runs; yields its source."""
    path, source = native.build(variants=(request.param,))
    lib = native._bind(ctypes.CDLL(str(path)))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(native, '_lib', lib)
        patch.setattr(native, '_source', source)
        yield source


def _smooth(rng, h, w, channels=3):
    """A smooth random image (JPEG-like content) with some noise."""
    y, x = np.mgrid[0:h, 0:w]
    phase = rng.uniform(0, 6, (channels,))
    img = 127 + 100 * np.sin(x[..., None] / (3 + w / 9) + phase) * \
        np.cos(y[..., None] / (3 + h / 7) - phase)
    img = img + rng.normal(0, 8, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """{name: path} of every kind of file the library meets."""
    root = tmp_path_factory.mktemp('native')
    rng = np.random.RandomState(0)
    out = {}

    def save(name, img, **kwargs):
        path = root / name
        img.save(path, **kwargs)
        out[name] = str(path)

    for h, w in ((250, 250), (97, 203), (1, 37), (41, 1), (1, 1),
                 (1080, 1440)):
        save(f'rgb_{h}x{w}.jpg', Image.fromarray(_smooth(rng, h, w)),
             quality=90)
    save('rgb.png', Image.fromarray(_smooth(rng, 120, 90)))
    save('rgb_1x50.png', Image.fromarray(_smooth(rng, 1, 50)))
    save('gray.jpg', Image.fromarray(_smooth(rng, 70, 60, 1)), quality=85)
    save('gray.png', Image.fromarray(_smooth(rng, 64, 80, 1)))
    save('rgba.png', Image.fromarray(
        np.dstack([_smooth(rng, 50, 70), _smooth(rng, 50, 70, 1)]), 'RGBA'))
    save('palette.png', Image.fromarray(_smooth(rng, 40, 30)).convert('P'))
    save('deep.png', Image.fromarray(
        _smooth(rng, 33, 45, 1).astype(np.uint16) * 257))
    save('cmyk.jpg', Image.fromarray(_smooth(rng, 60, 50)).convert('CMYK'))
    save('anim.gif', Image.fromarray(_smooth(rng, 44, 52)).convert('P'))
    whole = Path(out['rgb_250x250.jpg']).read_bytes()
    (root / 'truncated.jpg').write_bytes(whole[:len(whole) // 2])
    out['truncated.jpg'] = str(root / 'truncated.jpg')
    (root / 'bad.jpg').write_bytes(b'this is not an image')
    out['bad.jpg'] = str(root / 'bad.jpg')
    return out


def _same(got, want):
    if want is None:
        return got is None
    return got is not None and got.shape == want.shape and \
        int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()) == 0


@pytest.mark.parametrize('mode', [native.MODE_CROP_OR_PAD, native.MODE_RESIZE,
                                  native.MODE_LETTERBOX])
def test_decode_image_equals_jax(build, files, mode):
    """Every file at four sizes in each mode: the same bytes, or None on
    both sides (CMYK, GIF, 16-bit and corrupt files as JAX's build reads
    them)."""
    for name, path in files.items():
        for size in (160, (97, 203), (480, 640), (1, 1)):
            got = native.decode_image(path, size, mode)
            want = jnative.decode_image(path, size, mode)
            assert _same(got, want), (name, size, mode)
    assert native.decode_image(files['bad.jpg'], 64, mode) is None


def test_native_size_and_probe_equal_jax(build, files):
    for name, path in files.items():
        assert _same(native.decode_image_native_size(path),
                     jnative.decode_image_native_size(path)), name
        assert native.probe_image(path) == jnative.probe_image(path), name
    png = np.asarray(Image.open(files['rgb.png']))
    np.testing.assert_array_equal(
        native.decode_image_native_size(files['rgb.png']), png)
    assert native.probe_image(files['bad.jpg']) is None
    assert native.decode_image_native_size(files['bad.jpg']) is None


@pytest.mark.parametrize('seed', range(3))
def test_letterbox_array_and_geometry_equal_jax(build, seed):
    """Random (image, target) sizes, down and up, and 1-pixel sides."""
    rng = np.random.RandomState(seed)
    sizes = [tuple(int(v) for v in rng.randint(1, 500, 4)) for _ in range(10)]
    sizes += [(1, 1, 1, 1), (1, 300, 480, 640), (300, 1, 48, 64),
              (200, 300, 1, 120), (200, 300, 90, 1)]
    for h, w, th, tw in sizes:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        assert _same(native.letterbox_array(img, (th, tw)),
                     jnative.letterbox_array(img, (th, tw))), (h, w, th, tw)
        assert native.letterbox_geometry(h, w, (th, tw)) == \
            jnative.letterbox_geometry(h, w, (th, tw))
    with pytest.raises(ValueError, match='H, W, 3'):
        native.letterbox_array(np.zeros((4, 4), np.uint8), (8, 8))


@pytest.mark.parametrize('mode,size', [(native.MODE_CROP_OR_PAD, 64),
                                       (native.MODE_LETTERBOX, (96, 128))])
def test_batch_loader_equals_jax(build, files, mode, size):
    """Batches with repeats and unreadable rows, two in flight: the same
    images and ok flags as JAX's loader."""
    paths = list(files.values())
    order = np.random.RandomState(1).permutation(len(paths))
    batches = [order[:5], order[5:11], order[11:], [0, 0, len(paths) - 1]]
    port = native.NativeBatchLoader(paths, size, mode=mode, num_threads=3,
                                    prefetch=2)
    ref = jnative.NativeBatchLoader(paths, size, mode=mode, num_threads=3,
                                    prefetch=2)
    try:
        for (images, ok), (want, want_ok) in zip(port.iterate(batches),
                                                 ref.iterate(batches)):
            np.testing.assert_array_equal(ok, want_ok)
            np.testing.assert_array_equal(images, want)
        with pytest.raises(IndexError):
            port.submit([len(paths)])
    finally:
        port.close()
        ref.close()
    bad = paths.index(files['bad.jpg'])
    assert ok is not None and not want_ok[-1] and bad == len(paths) - 1


def test_rows_decoded_counts_native_rows_only(build, files):
    native.reset_rows_decoded()
    native.decode_image(files['rgb.png'], 32)
    native.decode_image(files['bad.jpg'], 32)
    native.decode_image_native_size(files['gray.png'])
    assert native.rows_decoded() == 2
    loader = native.NativeBatchLoader(
        [files['rgb.png'], files['bad.jpg']], 32)
    try:
        loader.submit([0, 1, 0])
        _, ok = loader.wait(3)
    finally:
        loader.close()
    assert list(ok) == [1, 0, 1]
    assert native.rows_decoded() == 4
    native.reset_rows_decoded()
    assert native.rows_decoded() == 0


_BUILD = """
import sys
from pathlib import Path
from facenet_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
native.cpu_model = lambda: sys.argv[2]
print(native.library_path().name, native.available(), native.build_error())
"""


def test_build_key_names_the_cpu_and_builds_once_under_a_lock(tmp_path):
    """A library keyed by another CPU is another file, built anew; three
    processes that start the same build at once leave one library and no
    temporary file, and each loads it."""
    here = native.library_path()
    assert here.parent == ROOT / 'facenet_tpu_torch' / '_build'
    procs = [subprocess.Popen([sys.executable, '-c', _BUILD, str(tmp_path),
                               'another cpu'], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(3)]
    outs = [proc.communicate(timeout=120) for proc in procs]
    assert all(proc.returncode == 0 for proc in procs), outs
    lines = {out.strip().splitlines()[-1] for out, _ in outs}
    assert len(lines) == 1, lines
    name, ok, error = lines.pop().split(' ', 2)
    assert ok == 'True' and error == 'None'
    assert name != here.name and name.startswith('libfacenet_native-')
    assert sorted(p.name for p in tmp_path.iterdir()
                  if not p.name.endswith('.lock')) == [name]


# the system build's arguments with an include that does not exist: g++
# fails at once
_NO_SYSTEM = ('-include', 'facenet_no_such_header.h')


@pytest.fixture
def unloaded(monkeypatch):
    """The module as before its first load, restored after the test."""
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_build_error', None)
    monkeypatch.setattr(native, '_source', None)


def test_pillow_build_is_chosen_where_the_system_build_fails(unloaded,
                                                             monkeypatch,
                                                             files):
    """Where the system build fails, the module loads the build against
    Pillow's libraries, reports it by `library_source()` and decodes as
    JAX's build does."""
    monkeypatch.setattr(native, 'build', functools.partial(
        native.build, system_args=_NO_SYSTEM))
    assert native.available() and native.build_error() is None
    directory, jpeg, png = native.pillow_libs()
    assert jpeg.name.startswith('libjpeg-') and '.so.62' in jpeg.name
    assert png.name.startswith('libpng16-') and '.so.16' in png.name
    assert native.library_source() == f'pillow:{directory}'
    for name in ('rgb_1080x1440.jpg', 'palette.png', 'cmyk.jpg'):
        assert _same(native.decode_image(files[name], (480, 640),
                                         native.MODE_LETTERBOX),
                     jnative.decode_image(files[name], (480, 640),
                                          native.MODE_LETTERBOX)), name


def test_builds_hash_to_different_libraries(tmp_path):
    """The two builds, the system build with other arguments and the
    Pillow build against a moved copy of Pillow's libraries each name
    another file."""
    _, jpeg, png = native.pillow_libs()
    moved = tmp_path / 'pillow.libs'
    moved.mkdir()
    for lib in (jpeg, png):
        shutil.copy(lib, moved / lib.name)
    names = [native.library_path('system').name,
             native.library_path('pillow').name,
             native.library_path('system', system_args=_NO_SYSTEM).name,
             native.library_path('pillow', pillow_dir=moved).name]
    assert len(set(names)) == 4, names
    assert native.library_path('pillow') == native.library_path('pillow')


@pytest.mark.parametrize('libs', [(), ('libjpeg-0a1b2c3d.so.8.3.2',
                                       'libpng16-0a1b2c3d.so.16.56.0')])
def test_build_error_holds_both_messages(unloaded, monkeypatch, tmp_path,
                                         files, libs):
    """Both builds fail (the system's include missing; Pillow's directory
    empty, or holding a libjpeg of another ABI): `build_error()` holds both
    messages in order, no source is reported, and the bindings raise."""
    fake = tmp_path / 'pillow.libs'
    fake.mkdir()
    for name in libs:
        (fake / name).write_bytes(b'')
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native, 'build', functools.partial(
        native.build, system_args=_NO_SYSTEM, pillow_dir=fake))
    assert not native.available()
    error = native.build_error()
    system, _, pillow = error.partition('\nthe pillow build: ')
    assert system.startswith('the system build: g++ failed')
    assert 'facenet_no_such_header.h' in system
    assert pillow == (f'no libjpeg-*.so.* in {fake}' if not libs else
                      f'{libs[0]} in {fake}: another ABI than the headers '
                      f'in {native.INCLUDE} (libjpeg .so.62)')
    assert native.library_source() is None
    with pytest.raises(RuntimeError, match='native library unavailable'):
        native.decode_image(files['rgb.png'], 32)
    assert not (tmp_path / 'build').exists() or not any(
        p.suffix == '.so' for p in (tmp_path / 'build').iterdir())


def test_probe_tool_names_the_build_and_decodes_as_pil(capsys):
    """`tools/probe_native`: its summary names Pillow's two libraries, and
    its run reports the loaded build and a decode equal to PIL's."""
    from facenet_tpu_torch.tools import probe_native

    _, jpeg, png = native.pillow_libs()
    assert f"Pillow's {jpeg.name} and {png.name}" in probe_native.summary()
    assert probe_native.main() == 0
    out = capsys.readouterr().out
    assert f'library_source() {native.library_source()}' in out
    assert 'SONAME ' + jpeg.name in out and 'NEEDED libz.so.1' in out
    assert out.count('.jpg 0') == 4 and out.count('.png 0') == 4


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """4 identity folders of 5 JPEG and PNG files each, of mixed sizes."""
    root = tmp_path_factory.mktemp('tree')
    rng = np.random.RandomState(2)
    for c in range(4):
        folder = root / f'id{c}'
        folder.mkdir()
        for i in range(5):
            h, w = 40 + 9 * i, 70 - 5 * c
            img = Image.fromarray(_smooth(rng, h, w))
            img.save(folder / f'{i}.{"png" if (c + i) % 2 else "jpg"}')
    return root


def _take(it, n):
    return [next(it) for _ in range(n)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (images, labels), (want_images, want_labels) in zip(got, want):
        np.testing.assert_array_equal(labels, want_labels)
        np.testing.assert_array_equal(images, want_images)


def test_batch_loader_native_equals_jax_and_resumes(build, tree):
    """Shuffled over more than two epochs: JAX's images, labels and order;
    a loader made from `state()` after 3 batches continues the run."""
    db = dataset.Database(dataset.DefaultConfig(tree))
    jdb = jdataset.Database(jdataset.DefaultConfig(tree))
    kwargs = dict(batch_size=6, shuffle=True, repeat=True, seed=3,
                  num_workers=3)
    native.reset_rows_decoded()
    port = db.batches(dataset.ImageLoader(size=48), **kwargs)
    got = _take(iter(port), 9)
    assert native.rows_decoded() >= sum(len(labels) for _, labels in got)
    want = _take(iter(jdb.batches(jdataset.ImageLoader(size=48), **kwargs)),
                 9)
    _assert_batches_equal(got, want)
    assert got[3][0].shape == (2, 48, 48, 3)       # the epoch's last batch

    first = db.batches(dataset.ImageLoader(size=48), **kwargs)
    it = iter(first)
    _take(it, 3)
    state = first.state()
    assert state == {'seed': 3, 'epoch': 0, 'pos': 3}
    resumed = db.batches(dataset.ImageLoader(size=48), start_state=state,
                         **kwargs)
    _assert_batches_equal(_take(iter(resumed), 6), got[3:9])


def test_loaders_split_rows_over_two_ranks(tree):
    """`rows=` on a 2-rank split: each rank's images are its half of the
    whole batch, and its cursor is the whole loader's."""
    db = dataset.Database(dataset.DefaultConfig(tree))
    kwargs = dict(batch_size=6, shuffle=True, repeat=True, seed=4,
                  drop_remainder=True, num_workers=2)
    whole = db.batches(dataset.ImageLoader(size=40), **kwargs)
    want = _take(iter(whole), 5)
    pk_config = {'nrof_classes_per_batch': 2, 'nrof_examples_per_class': 3}
    pk_want = _take(dataset.PKPipeline(dataset.ImageLoader(size=40),
                                       db.classes, Config(dict(pk_config)),
                                       seed=6), 3)
    for rank in range(2):
        def rows(idx, rank=rank):
            return idx[rank * 3:(rank + 1) * 3]
        part = db.batches(dataset.ImageLoader(size=40), rows=rows, **kwargs)
        got = _take(iter(part), 5)
        _assert_batches_equal(got, [(i[rank * 3:(rank + 1) * 3],
                                     lab[rank * 3:(rank + 1) * 3])
                                    for i, lab in want])
        assert part.state() == whole.state()
        pk = dataset.PKPipeline(dataset.ImageLoader(size=40), db.classes,
                                Config(dict(pk_config)), seed=6, rows=rows)
        _assert_batches_equal(_take(pk, 3),
                              [(i[rank * 3:(rank + 1) * 3],
                                lab[rank * 3:(rank + 1) * 3])
                               for i, lab in pk_want])
        assert pk.state() == {'seed': 6, 'batch': 3}


def test_pk_pipeline_native_equals_jax_and_resumes(build, tree):
    db = dataset.Database(dataset.DefaultConfig(tree))
    jdb = jdataset.Database(jdataset.DefaultConfig(tree))
    pk_config = {'nrof_classes_per_batch': 3, 'nrof_examples_per_class': 2}
    native.reset_rows_decoded()
    port = dataset.PKPipeline(dataset.ImageLoader(size=56), db.classes,
                              Config(dict(pk_config)), seed=9, num_workers=2)
    got = _take(port, 5)
    assert native.rows_decoded() >= 5 * 6
    ref = jdataset.PKPipeline(jdataset.ImageLoader(size=56), jdb.classes,
                              Config(dict(pk_config)), seed=9, num_workers=2)
    _assert_batches_equal(got, _take(ref, 5))
    state = port.state()
    assert state == {'seed': 9, 'batch': 5}
    resumed = dataset.PKPipeline(dataset.ImageLoader(size=56), db.classes,
                                 Config(dict(pk_config)), start_state=state)
    _assert_batches_equal(_take(resumed, 2), _take(ref, 2))


def test_loaders_retry_other_formats_with_pil_and_raise_on_unreadable(
        tmp_path, files):
    """A GIF and a CMYK JPEG, which the library does not read, load through
    the loader's PIL path as JAX's do; an unreadable file raises in both
    loaders."""
    good = tmp_path / 'good'
    good.mkdir()
    for name in ('anim.gif', 'cmyk.jpg', 'rgb.png', 'gray.jpg'):
        (good / name).write_bytes(Path(files[name]).read_bytes())
    paths = sorted(str(p) for p in good.iterdir())
    labels = np.arange(len(paths))
    port = dataset.BatchLoader(paths, labels, dataset.ImageLoader(size=32),
                               batch_size=4, num_workers=2)
    ref = jdataset.BatchLoader(paths, labels, jdataset.ImageLoader(size=32),
                               batch_size=4, num_workers=2)
    _assert_batches_equal(list(port), list(ref))

    bad = tmp_path / 'bad'
    bad.mkdir()
    (bad / 'a.png').write_bytes(Path(files['rgb.png']).read_bytes())
    (bad / 'b.jpg').write_bytes(b'this is not an image')
    paths = sorted(str(p) for p in bad.iterdir())
    loader = dataset.BatchLoader(paths, [0, 0], dataset.ImageLoader(size=32),
                                 batch_size=2)
    with pytest.raises(Exception, match='b.jpg|identify'):
        list(loader)
    with pytest.raises(Exception, match='b.jpg|identify'):
        list(jdataset.BatchLoader(paths, [0, 0],
                                  jdataset.ImageLoader(size=32),
                                  batch_size=2))
    classes = dataset.Database(dataset.DefaultConfig(tmp_path)).classes
    pk = dataset.PKPipeline(dataset.ImageLoader(size=32), classes[:1],
                            Config({'nrof_classes_per_batch': 1,
                                    'nrof_examples_per_class': 2}), seed=0)
    with pytest.raises(Exception, match='b.jpg|identify'):
        next(pk)


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def scene_files(tmp_path_factory):
    """Three scenes, two JPEG and one PNG, of three sizes; an unreadable
    file last."""
    root = tmp_path_factory.mktemp('scenes')
    rng = np.random.RandomState(21)
    paths = []
    for i, (shape, suffix) in enumerate((((192, 256), 'jpg'),
                                         ((300, 400), 'png'),
                                         ((384, 512), 'jpg'))):
        img, _, _ = render_scene(rng, shape=shape, n_faces=2, min_face=50,
                                 max_face=min(shape) // 2)
        path = root / f'scene{i}.{suffix}'
        Image.fromarray(img).save(path, **({'quality': 92}
                                           if suffix == 'jpg' else {}))
        paths.append(str(path))
    (root / 'bad.jpg').write_bytes(b'not an image')
    return paths + [str(root / 'bad.jpg')]


def test_detect_files_matches_jax(scene_files):
    """The port's native `detect_files` against JAX's (one batch of four
    files into 192x256): the same faces, boxes and landmarks within 1.5 px,
    scores within 0.02, matched by IoU; [] for the unreadable file."""
    from facenet_tpu.detectors.face_detector import FaceDetector as JaxDetector
    from facenet_tpu_torch.detectors import evaluation
    from facenet_tpu_torch.detectors.face_detector import FaceDetector

    native.reset_rows_decoded()
    got = FaceDetector(image_shape=(192, 256), device='cpu').detect_files(
        scene_files, batch_size=4)
    assert native.rows_decoded() == 3
    want = JaxDetector(image_shape=(192, 256)).detect_files(scene_files,
                                                            batch_size=4)
    assert got[3] == [] and want[3] == []
    found = 0
    for boxes_a, boxes_b in zip(want, got):
        assert len(boxes_a) == len(boxes_b)
        if not boxes_a:
            continue
        a = np.array([[b.left, b.top, b.right, b.bottom] for b in boxes_a],
                     np.float64)
        b = np.array([[b.left, b.top, b.right, b.bottom] for b in boxes_b],
                     np.float64)
        match = evaluation.iou_matrix(a, b).argmax(axis=1)
        assert sorted(match) == list(range(len(b)))
        # BoundingBox rounds to pixels: 1.5 px before rounding, 2 after
        assert np.abs(a - b[match]).max() <= 2
        for i, j in enumerate(match):
            assert abs(boxes_a[i].confidence - boxes_b[j].confidence) < 0.02
            assert np.abs(boxes_a[i].landmarks -
                          boxes_b[j].landmarks).max() < 1.5 * 2
        found += len(boxes_a)
    assert found >= 3


def test_detect_files_dispatches_two_deep_and_routes_buckets(scene_files,
                                                             monkeypatch):
    """Batches of one: three batches are dispatched before the first is
    fetched, then one fetched per dispatch, as JAX's loop; with two buckets
    each file goes to its bucket. The boxes equal the PIL path's (the same
    canvases through the same backend)."""
    from facenet_tpu_torch.detectors.face_detector import FaceDetector

    fd = FaceDetector(image_shapes=[(96, 128), (192, 256)], device='cpu')
    events = []
    for shape in fd.image_shapes:
        backend = fd.backend_for(shape)
        dispatch, fetch = backend.detect_batch_async, backend.finalize_batch

        def counted_dispatch(images, dispatch=dispatch, shape=shape):
            events.append(('dispatch', shape))
            return dispatch(images)

        def counted_fetch(out, fetch=fetch, shape=shape):
            events.append(('fetch', shape))
            return fetch(out)
        monkeypatch.setattr(backend, 'detect_batch_async', counted_dispatch)
        monkeypatch.setattr(backend, 'finalize_batch', counted_fetch)

    files = scene_files + scene_files[:2]
    got = fd.detect_files(files, batch_size=1)
    small = [e for e in events if e[1] == (96, 128)]
    big = [e for e in events if e[1] == (192, 256)]
    # 192x256 holds scene0 at scale 1, and the larger scenes downscale
    # less into it than into 96x128; a file whose header does not read goes
    # to the first bucket, as in JAX
    assert [kind for kind, _ in big] == (
        ['dispatch'] * 3 + ['fetch', 'dispatch'] * 2 + ['fetch'] * 3)
    assert [kind for kind, _ in small] == ['dispatch', 'fetch']
    with monkeypatch.context() as patched:
        patched.setattr(native, 'available', lambda: False)
        want = fd.detect_files(files, batch_size=1)
    assert [[b.info() for b in boxes] for boxes in got] == \
        [[b.info() for b in boxes] for boxes in want]
    assert got[3] == [] and sum(map(len, got)) >= 4

    small_file = Path(scene_files[0]).with_name('small.png')
    img = np.asarray(Image.open(scene_files[0]).convert('RGB'))[::3, ::3]
    Image.fromarray(np.ascontiguousarray(img)).save(small_file)
    events.clear()
    fd.detect_files([str(small_file), scene_files[1]], batch_size=2)
    assert ('dispatch', (96, 128)) in events
    assert ('dispatch', (192, 256)) in events


def test_file_paths_decode_without_pil(tree, scene_files, monkeypatch):
    """With the library built, no file path imports PIL to decode: the
    loaders, the letterbox, detect_files, process_files, the extract_faces
    and train_detector readers and the dataset app's check (the card's
    machine may have no PIL)."""
    from facenet_tpu_torch import FaceNet, export
    from facenet_tpu_torch.apps import dataset as dataset_app
    from facenet_tpu_torch.apps import extract_faces, train_detector
    from facenet_tpu_torch.detectors.face_detector import FaceDetector
    from facenet_tpu_torch.detectors.mtcnn import letterbox
    from facenet_tpu_torch.models.inception_resnet_v1 import init_variables
    from facenet_tpu_torch.pipeline import FacePipeline

    tiny = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
            'block8_1': {'repeat': 1}, 'output': {'size': 16}}
    facenet = FaceNet(device='cpu', bundle=export.ModelBundle(
        init_variables(tiny), {'model_class': 'InceptionResnetV1',
                               'config': tiny, 'image_size': 160,
                               'normalization': 0}))
    pipe = FacePipeline(facenet, image_shape=(192, 256), device='cpu')
    detector = FaceDetector(image_shape=(192, 256), device='cpu')
    db = dataset.Database(dataset.DefaultConfig(tree))
    for name in [m for m in sys.modules if m == 'PIL' or
                 m.startswith('PIL.')]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(ImportError):
        from PIL import Image as _  # noqa: F401

    native.reset_rows_decoded()
    images, labels = next(iter(db.batches(dataset.ImageLoader(size=32), 8)))
    assert images.shape == (8, 32, 32, 3)
    pk = dataset.PKPipeline(dataset.ImageLoader(size=32), db.classes,
                            Config({'nrof_classes_per_batch': 2,
                                    'nrof_examples_per_class': 2}), seed=1)
    assert next(pk)[0].shape == (4, 32, 32, 3)
    canvas, _, _ = letterbox.letterbox_file(scene_files[0],
                                            lambda h, w: (96, 128))
    assert canvas.shape == (96, 128, 3)
    assert letterbox.letterbox_batch([canvas], (48, 64))[0].shape == \
        (1, 48, 64, 3)
    # the unreadable file goes where no PIL retry follows (the other paths
    # retry a file the library cannot read with PIL, as JAX's do)
    boxes = detector.detect_files(scene_files, batch_size=2)
    assert len(boxes) == 4 and boxes[3] == []
    emb, _, valid = pipe.process_files(scene_files[:3], batch_size=2)
    assert emb.shape[0] == 3 and np.isfinite(emb).all()
    arrays, ok_paths, failed = extract_faces._load_chunk(scene_files[:3])
    assert len(arrays) == 3 and failed == 0
    assert train_detector._read_image(scene_files[1]).shape == (300, 400, 3)
    assert dataset_app.check_file(scene_files[0]) is None
    assert 'unreadable' in dataset_app.check_file(scene_files[3])
    assert native.rows_decoded() >= 8 + 4 + 1 + 3 + 3 + 3 + 1


def test_dataset_counts_and_reference_names_equal_jax(tree):
    """`ImageClass.nrof_pairs`, `Database.nrof_images_per_class`,
    `BatchLoader.nrof_batches` and `Database.tf_dataset_api` (in order
    without a buffer size, shuffled from numpy's global seed with one)."""
    db = dataset.Database(dataset.DefaultConfig(tree))
    jdb = jdataset.Database(jdataset.DefaultConfig(tree))
    assert [c.nrof_pairs for c in db.classes] == \
        [c.nrof_pairs for c in jdb.classes] == [10] * 4
    assert db.nrof_images_per_class == jdb.nrof_images_per_class == [5] * 4
    for buffer_size in (None, 100):
        np.random.seed(5)
        port = db.tf_dataset_api(dataset.ImageLoader(size=24), 8,
                                 buffer_size=buffer_size)
        np.random.seed(5)
        ref = jdb.tf_dataset_api(jdataset.ImageLoader(size=24), 8,
                                 buffer_size=buffer_size)
        assert port.nrof_batches == ref.nrof_batches == 3
        assert port.shuffle == ref.shuffle == (buffer_size is not None)
        _assert_batches_equal(list(port), list(ref))
