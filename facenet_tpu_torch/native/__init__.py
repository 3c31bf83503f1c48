"""The port's native (C++) host image pipeline: build, ctypes bindings and
the prefetching batch loader.

`imageio.cc` decodes JPEG and PNG to RGB uint8 and crops, pads or
letterboxes the pixels; `loader.cc` decodes whole batches on a thread pool
a few batches ahead of the consumer. Both are copies of the JAX package's
``facenet_tpu/native`` sources, built here by the port itself: at first use
g++ compiles them with the JAX package's flags into
``facenet_tpu_torch/_build/``, under a name that hashes the sources, the
build's flags and libraries and the host CPU (``-march=native`` code built
on another machine must never load).

Two builds, tried in this order (`build`):
  * 'system': the JAX package's build, against the system's libjpeg and
    libpng headers and ``-ljpeg -lpng -lz``;
  * 'pillow', only where the first fails (a machine with no libjpeg or
    libpng development files): the port's copy of the ABI headers in
    ``include/`` (libjpeg 6.2, libpng 1.6), linked against the
    libjpeg-turbo and libpng16 that the installed Pillow wheel carries in
    ``pillow.libs/``, found without importing PIL.

Public surface, with the JAX package's names:
  * available() -> bool, build_error() -> every failed build's message,
    library_source() -> 'system' or 'pillow:<dir>';
  * decode_image(path, size, mode) -> uint8 [H, W, 3] or None;
  * decode_image_native_size(path), probe_image(path);
  * letterbox_array(image, shape), letterbox_geometry(h, w, shape);
  * NativeBatchLoader: submit / wait / iterate / close;
  * rows_decoded() / reset_rows_decoded(): the rows decoded by this
    library since the last reset, so that a run can show that a path went
    through it.

Where neither build succeeds (no g++, or neither the system's libjpeg and
libpng nor Pillow's), the loaders of `dataset`, the letterbox and the
detectors use PIL, and the first failed load logs both builds' messages at
WARNING; every function here raises `RuntimeError` instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / '_build'
SOURCES = ('imageio.cc', 'loader.cc')
# the JAX package's Makefile flags: -march=native lets g++ contract the
# letterbox's (x + 0.5f) * s - 0.5f into one fused multiply-add, which
# detectors/mtcnn/letterbox.py restates
CXX_FLAGS = ('-O3', '-march=native', '-fPIC', '-std=c++17')
LIBS = ('-ljpeg', '-lpng', '-lz', '-lpthread')
VARIANTS = ('system', 'pillow')
# the port's copy of the libjpeg 6.2 and libpng 1.6 headers (include/README)
INCLUDE = _DIR / 'include'
# (file stem in pillow.libs, the soname's major version the headers are for)
PILLOW_ABI = (('libjpeg', '62'), ('libpng16', '16'))

# Geometry modes (must match imageio.cc fn_decode_image).
MODE_CROP_OR_PAD = 0
MODE_RESIZE = 1
MODE_LETTERBOX = 2

_lib = None
_lib_lock = threading.Lock()
_build_error = None
_source = None
_rows = 0
_rows_lock = threading.Lock()


def cpu_model():
    """The host CPU's model name and feature flags (what ``-march=native``
    compiles for), from /proc/cpuinfo where there is one."""
    model, flags = '', ''
    try:
        with open('/proc/cpuinfo') as info:
            for line in info:
                key, _, value = line.partition(':')
                key = key.strip()
                if key == 'model name' and not model:
                    model = value.strip()
                elif key in ('flags', 'Features') and not flags:
                    flags = value.strip()
                if model and flags:
                    break
    except OSError:
        pass
    return f'{model or platform.processor() or platform.machine()}|{flags}'


def pillow_libs(directory=None):
    """The libjpeg-turbo and libpng16 that a Pillow wheel carries.

    :param directory: a ``pillow.libs`` directory; by default the installed
        Pillow's, found through importlib without importing PIL
    :return: (the directory, libjpeg's path, libpng's path), resolved
    :raises RuntimeError: no Pillow, no such library in the directory, or
        only libraries of another major ABI than the headers in include/
        (the wheel names each library by its soname, ``.so.<major>...``)
    """
    if directory is None:
        try:
            spec = importlib.util.find_spec('PIL')
        except ValueError:      # sys.modules['PIL'] is None or has no spec
            spec = None
        if spec is None or not spec.origin:
            raise RuntimeError('no Pillow is installed')
        directory = Path(spec.origin).parent.parent / 'pillow.libs'
    directory = Path(directory).resolve()
    found = [directory]
    for stem, major in PILLOW_ABI:
        names = sorted(directory.glob(f'{stem}-*.so.*'))
        if not names:
            raise RuntimeError(f'no {stem}-*.so.* in {directory}')
        same = [p for p in names
                if p.name.partition('.so.')[2].split('.')[0] == major]
        if not same:
            raise RuntimeError(
                f'{", ".join(p.name for p in names)} in {directory}: '
                f'another ABI than the headers in {INCLUDE} ({stem} '
                f'.so.{major})')
        found.append(same[0])
    return tuple(found)


def _plan(variant, system_args, pillow_dir):
    """(g++ arguments after the sources, `library_source()`'s value, the
    library's path) of one build."""
    if variant == 'system':
        args, source, headers = tuple(system_args), 'system', ()
    elif variant == 'pillow':
        directory, jpeg, png = pillow_libs(pillow_dir)
        # the port's sources call no zlib, but Pillow's libpng needs
        # libz.so.1, and a machine without zlib's development files has no
        # libz.so link
        args = (f'-I{INCLUDE}', str(jpeg), str(png), '-l:libz.so.1',
                '-lpthread', f'-Wl,-rpath,{directory}')
        source, headers = f'pillow:{directory}', sorted(INCLUDE.glob('*.h'))
    else:
        raise ValueError(f'unknown build {variant!r}, not one of {VARIANTS}')
    key = hashlib.sha1()
    for path in [_DIR / name for name in SOURCES] + list(headers):
        key.update(path.read_bytes())
    key.update(' '.join((variant,) + CXX_FLAGS + args).encode())
    key.update(cpu_model().encode())
    name = f'libfacenet_native-{key.hexdigest()[:12]}.so'
    return args, source, BUILD_DIR / name


def library_path(variant='system', system_args=LIBS, pillow_dir=None):
    """The shared library of one build (`build`'s arguments) on this host's
    CPU, named by the hash of the sources, the headers, the flags, the
    resolved libraries and the CPU: a change to any of them, a moved
    Pillow included, builds anew, and no two builds share a file.

    :raises RuntimeError: for 'pillow', as `pillow_libs`
    """
    return _plan(variant, system_args, pillow_dir)[2]


def _compile(path, args):
    """Compile the library into `path` unless it is there.

    Safe across processes (pytest-xdist workers, training ranks): an
    exclusive flock serializes the builders, and g++ writes a temporary
    file that is renamed into place, so no process maps a partial file.

    :raises RuntimeError: g++ failed; the message holds its stderr
    """
    if path.exists():
        return
    import fcntl

    path.parent.mkdir(parents=True, exist_ok=True)
    with open(f'{path}.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():       # another process built it meanwhile
                return
            tmp = path.with_name(f'{path.name}.{os.getpid()}.tmp')
            cmd = ['g++', *CXX_FLAGS, '-shared', '-o', str(tmp),
                   *(str(_DIR / name) for name in SOURCES), *args]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f'g++ failed ({proc.returncode}) building '
                        f'{path.name}:\n{proc.stderr}')
                os.replace(tmp, path)
            finally:
                if tmp.exists():
                    tmp.unlink()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def build(variants=VARIANTS, system_args=LIBS, pillow_dir=None):
    """Build the library: each of `variants` in turn until one compiles.

    :param variants: the builds to try, in order: 'system' (the JAX
        package's build) and 'pillow' (include/ and Pillow's libraries)
    :param system_args: the system build's g++ arguments after the
        sources: the JAX package's libraries
    :param pillow_dir: the ``pillow.libs`` directory the Pillow build links
        against; by default the installed Pillow's
    :return: (the library's path, `library_source()`'s value for it)
    :raises RuntimeError: no build succeeded; the message holds each
        failed build's, in order
    """
    errors = []
    for variant in variants:
        try:
            args, source, path = _plan(variant, system_args, pillow_dir)
            _compile(path, args)
            return path, source
        except RuntimeError as exc:
            errors.append(f'the {variant} build: {exc}')
            if variant != variants[-1]:
                from facenet_tpu_torch.logging import logger
                logger.info('native image library: %s; trying the next '
                            'build', errors[-1])
    raise RuntimeError('\n'.join(errors))


def _bind(lib):
    lib.fn_decode_image.restype = ctypes.c_int
    lib.fn_decode_image.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.fn_probe_image.restype = ctypes.c_int
    lib.fn_probe_image.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.fn_decode_image_alloc.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.fn_decode_image_alloc.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.fn_free.restype = None
    lib.fn_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.fn_loader_create.restype = ctypes.c_void_p
    lib.fn_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fn_loader_destroy.restype = None
    lib.fn_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.fn_loader_submit.restype = ctypes.c_int
    lib.fn_loader_submit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.fn_loader_wait.restype = ctypes.c_int
    lib.fn_loader_wait.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32)]
    lib.fn_letterbox_array.restype = None
    lib.fn_letterbox_array.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    return lib


def _load():
    global _lib, _build_error, _source
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path, source = build()
            _lib = _bind(ctypes.CDLL(str(path)))
            _source = source
        except (OSError, RuntimeError) as exc:
            _build_error = str(exc)
            from facenet_tpu_torch.logging import logger
            logger.warning('the native image library is unavailable, image '
                           'files decode with PIL: %s', _build_error)
        return _lib


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f'native library unavailable: {_build_error}')
    return lib


def available():
    """Whether the library built and loaded (built at the first call)."""
    return _load() is not None


def build_error():
    """Every failed build's message, or the load's, or None."""
    _load()
    return _build_error


def library_source():
    """Which build loaded: 'system' (the system's libjpeg and libpng) or
    'pillow:<dir>' (Pillow's, in <dir>); None where none did."""
    _load()
    return _source


def _count(n):
    global _rows
    with _rows_lock:
        _rows += int(n)


def rows_decoded():
    """Images decoded by this library since the last reset."""
    return _rows


def reset_rows_decoded():
    global _rows
    with _rows_lock:
        _rows = 0


def _size(size):
    return ((int(size), int(size)) if np.isscalar(size)
            else (int(size[0]), int(size[1])))


def decode_image(path, size, mode=MODE_CROP_OR_PAD):
    """Decode one image to uint8 [size, size, 3] (or [h, w, 3] for a
    tuple), cropped or padded, resized, or letterboxed as `mode` says.

    :return: the array, or None for an unreadable file or a format the
        library does not read (it reads JPEG and PNG)
    """
    lib = _require()
    h, w = _size(size)
    out = np.empty((h, w, 3), dtype=np.uint8)
    ok = lib.fn_decode_image(
        os.fsencode(path), h, w, int(mode),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if not ok:
        return None
    _count(1)
    return out


def decode_image_native_size(path):
    """Decode one image at its own size -> uint8 [H, W, 3], or None.

    One decode pass (probe_image + decode_image would decode twice)."""
    lib = _require()
    h = ctypes.c_int()
    w = ctypes.c_int()
    ptr = lib.fn_decode_image_alloc(os.fsencode(path), ctypes.byref(h),
                                    ctypes.byref(w))
    if not ptr:
        return None
    try:
        n = h.value * w.value * 3
        out = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    finally:
        lib.fn_free(ptr)
    _count(1)
    return out.reshape(h.value, w.value, 3)


def letterbox_array(image, target_shape):
    """C++ letterbox of a decoded uint8 [H, W, 3] array -> [th, tw, 3].

    The geometry of MODE_LETTERBOX decode (aspect-preserving bilinear
    resize, centred zero pad); `letterbox_geometry` gives its scale and
    pads.
    """
    lib = _require()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        # the C++ reads exactly H*W*3 bytes: anything else would read out
        # of bounds or reinterpret channels
        raise ValueError(f'letterbox_array needs [H, W, 3] uint8, got '
                         f'{image.shape}')
    th, tw = int(target_shape[0]), int(target_shape[1])
    out = np.empty((th, tw, 3), dtype=np.uint8)
    lib.fn_letterbox_array(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        image.shape[0], image.shape[1], th, tw,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def letterbox_geometry(h, w, target_shape):
    """(scale, (pad_left, pad_top)) of the letterbox placement for an
    (h, w) image: original_coords = (letterboxed_coords - pad) / scale.

    imageio.cc's letterbox() computes the scale and d * s + 0.5f in
    binary32 and truncates; the same in Python doubles could flip a
    rounded size by 1 px near .5 on large images."""
    th, tw = int(target_shape[0]), int(target_shape[1])
    f32 = np.float32
    scale = min(f32(th) / f32(h), f32(tw) / f32(w))
    nh = max(1, min(int(f32(h) * scale + f32(0.5)), th))
    nw = max(1, min(int(f32(w) * scale + f32(0.5)), tw))
    return float(scale), ((tw - nw) // 2, (th - nh) // 2)


def probe_image(path):
    """Native size (h, w) of an image from its header, or None if
    unreadable."""
    lib = _require()
    h = ctypes.c_int()
    w = ctypes.c_int()
    ok = lib.fn_probe_image(os.fsencode(path), ctypes.byref(h),
                            ctypes.byref(w))
    return (h.value, w.value) if ok else None


class NativeBatchLoader:
    """Double-buffered prefetching batch loader over a fixed file list.

    Python decides the index order (shuffle, epochs, P x K sampling); the
    C++ pool decodes `prefetch` batches ahead. `wait` returns (images
    uint8 [B, H, W, 3], ok int32 [B]); a row whose file could not be
    decoded has ok 0 and zero pixels.
    """

    def __init__(self, files, size, mode=MODE_CROP_OR_PAD, num_threads=None,
                 prefetch=2):
        lib = _require()
        self._lib = lib
        self.files = [str(f) for f in files]
        self.height, self.width = _size(size)
        if num_threads is None:
            num_threads = min(32, os.cpu_count() or 4)
        paths = (ctypes.c_char_p * len(self.files))(
            *[os.fsencode(f) for f in self.files])
        self.queue_depth = max(int(prefetch), 1)
        self._handle = lib.fn_loader_create(
            paths, len(self.files), self.height, self.width, int(mode),
            int(num_threads), self.queue_depth)
        self._closed = False

    def submit(self, indices):
        """Enqueue one batch of file indices for background decode; returns
        its size (blocks while `prefetch` batches are in flight)."""
        idx = np.ascontiguousarray(indices, dtype=np.int32)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self.files)):
            raise IndexError(f'file index out of range 0..{len(self.files)}')
        accepted = self._lib.fn_loader_submit(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(idx))
        if not accepted:
            raise RuntimeError('submit() on a stopped loader')
        return len(idx)

    def wait(self, batch_size):
        """Block for the oldest submitted batch; returns (images, ok)."""
        out = np.empty((batch_size, self.height, self.width, 3),
                       dtype=np.uint8)
        ok = np.empty((batch_size,), dtype=np.int32)
        n = self._lib.fn_loader_wait(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if n < 0:
            raise RuntimeError('loader.wait() with no batch in flight')
        _count(np.count_nonzero(ok[:n]))
        return out[:n], ok[:n]

    def iterate(self, index_batches):
        """Pipelined iteration over an iterable of index lists, one per
        batch, keeping the prefetch queue full."""
        pending = []
        it = iter(index_batches)
        # prime up to the queue depth: one more submit would block in the
        # C++ until a wait()
        for batch in it:
            pending.append(self.submit(batch))
            if len(pending) >= self.queue_depth:
                break
        for batch in it:
            yield self.wait(pending.pop(0))
            pending.append(self.submit(batch))
        while pending:
            yield self.wait(pending.pop(0))

    def close(self):
        if not self._closed and self._handle:
            self._lib.fn_loader_destroy(self._handle)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
