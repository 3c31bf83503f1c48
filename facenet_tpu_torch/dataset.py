"""Dataset indexing and a batched image pipeline.

The directory-per-class `ImageClass`/`Database` index with h5 validity
filtering and class/image subsampling, an image loader with crop-or-pad to
a fixed size, `BatchLoader`, a prefetching, resumable pipeline of uint8
NHWC batches, and `PKPipeline`, the resumable P-classes x K-images batches
of metric learning. Files decode through the port's native library
(`facenet_tpu_torch.native`: JPEG and PNG, whole batches on its thread
pool), and through PIL where it cannot read a file or was not built. PIL
and h5py are imported only where files are read.
"""

from __future__ import annotations

import queue as queue_mod
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from facenet_tpu_torch import h5utils
from facenet_tpu_torch.logging import logger


class DefaultConfig:
    """Minimal dataset config for ad-hoc use."""

    def __init__(self, path, h5file=None, nrof_classes=None,
                 min_nrof_images=None, max_nrof_images=None):
        self.path = path
        self.h5file = h5file
        self.nrof_classes = nrof_classes
        self.min_nrof_images = min_nrof_images
        self.max_nrof_images = max_nrof_images


class ImageClass:
    """Paths to the images of one class."""

    def __init__(self, config):
        if not config.path:
            raise ValueError('Path to dataset is not specified.')

        self.path = Path(str(config.path)).expanduser()
        self.name = self.path.stem

        if not self.path.exists():
            raise ValueError(f'Directory {self.path} does not exist')

        files = list(self.path.glob('*'))

        if config.h5file:
            import h5py
            h5file = Path(str(config.h5file)).expanduser()
            with h5py.File(str(h5file), 'r') as hf:
                def is_valid(f, hf=hf):
                    key = h5utils.filename2key(f, 'is_valid')
                    return bool(hf[key][...]) if key in hf else True
                files = [f for f in files if is_valid(f)]

        if config.max_nrof_images:
            if len(files) > config.max_nrof_images:
                files = np.random.choice(files, size=config.max_nrof_images,
                                         replace=False)

        self.files = sorted(str(f) for f in files)

    def __repr__(self):
        return f'{self.__class__.__name__} ({self.name}/{self.nrof_images})'

    @property
    def nrof_images(self):
        return len(self.files)

    @property
    def nrof_pairs(self):
        return self.nrof_images * (self.nrof_images - 1) // 2


class Database:
    """Directory-per-class dataset index."""

    def __init__(self, config):
        if isinstance(config, (str, Path)):
            config = DefaultConfig(config)

        if not config.path:
            raise ValueError('Path to dataset is not specified.')

        self.path = Path(str(config.path)).expanduser()
        if not self.path.exists():
            raise ValueError(f'Directory {self.path} does not exist')

        self.h5file = config.h5file
        if self.h5file:
            self.h5file = Path(str(self.h5file)).expanduser()

        dirs = [p for p in self.path.glob('*') if p.is_dir()]
        if config.nrof_classes:
            if len(dirs) > config.nrof_classes:
                dirs = list(np.random.choice(dirs, size=config.nrof_classes,
                                             replace=False))
        dirs.sort()

        min_images = config.min_nrof_images or 0

        self.classes = []
        for path in dirs:
            images = ImageClass(DefaultConfig(
                path, h5file=self.h5file,
                max_nrof_images=config.max_nrof_images))
            if images.nrof_images > 0 and images.nrof_images >= min_images:
                self.classes.append(images)

        logger.info(str(self))

    def __repr__(self):
        return (f'{self.__class__.__name__}\n' +
                f'{self.path}\n' +
                f'h5 file {self.h5file}\n' +
                f'Number of classes {self.nrof_classes} \n' +
                f'Number of images {self.nrof_images}\n' +
                f'Minimal number of images in class {self.min_nrof_images}\n' +
                f'Maximal number of images in class {self.max_nrof_images}\n')

    @property
    def files(self):
        files = []
        for cls in self.classes:
            files += cls.files
        return files

    @property
    def labels(self):
        labels = []
        for idx, cls in enumerate(self.classes):
            labels += [idx] * cls.nrof_images
        return np.array(labels)

    @property
    def min_nrof_images(self):
        return min((cls.nrof_images for cls in self.classes), default=0)

    @property
    def max_nrof_images(self):
        return max((cls.nrof_images for cls in self.classes), default=0)

    @property
    def nrof_classes(self):
        return len(self.classes)

    @property
    def nrof_images(self):
        return sum(cls.nrof_images for cls in self.classes)

    @property
    def nrof_images_per_class(self):
        return [cls.nrof_images for cls in self.classes]

    def batches(self, loader, batch_size, shuffle=False, repeat=False,
                drop_remainder=False, num_workers=8, prefetch=2, seed=None,
                start_state=None, rows=None):
        """`BatchLoader` over (files, labels): in index order by default
        (the last batch may be smaller), shuffled per epoch from `seed`,
        repeated, resumed from a `start_state` cursor, with only `rows` of
        each batch decoded."""
        return BatchLoader(self.files, self.labels, loader, batch_size,
                           shuffle=shuffle, repeat=repeat,
                           drop_remainder=drop_remainder,
                           num_workers=num_workers, prefetch=prefetch,
                           seed=seed, start_state=start_state, rows=rows)

    def tf_dataset_api(self, loader, batch_size, buffer_size=None,
                       repeat=False):
        """`batches` under the reference's name: shuffled when a
        `buffer_size` is given."""
        return self.batches(loader, batch_size,
                            shuffle=buffer_size is not None, repeat=repeat)


DBase = Database


class ImageLoader:
    """Decode an image file into a fixed-shape uint8 RGB array (center
    crop-or-pad to size x size)."""

    # the native library's geometry mode for this loader (crop-or-pad):
    # `BatchLoader` and `PKPipeline` decode whole batches in it
    native_mode = 0

    def __init__(self, config=None, size=None):
        if size is None:
            size = int(config.size)
        self.height = self.width = int(size)

    def __call__(self, path):
        from facenet_tpu_torch import native
        if native.available():
            img = native.decode_image(path, (self.height, self.width),
                                      mode=self.native_mode)
            if img is not None:
                return img
            # the library reads JPEG and PNG: PIL reads the other formats
            # (GIF, BMP, TIFF, WebP, CMYK JPEG) and raises on a file that
            # neither can read
        from PIL import Image
        with Image.open(path) as img:
            arr = np.asarray(img.convert('RGB'), dtype=np.uint8)
        return crop_or_pad(arr, self.height, self.width)


def crop_or_pad(image, height, width):
    """Center crop-or-pad, semantics of tf.image.resize_with_crop_or_pad."""
    h, w = image.shape[:2]

    top = max((h - height) // 2, 0)
    left = max((w - width) // 2, 0)
    image = image[top:top + height, left:left + width]

    pad_h = height - image.shape[0]
    pad_w = width - image.shape[1]
    if pad_h > 0 or pad_w > 0:
        image = np.pad(image,
                       ((pad_h // 2, pad_h - pad_h // 2),
                        (pad_w // 2, pad_w - pad_w // 2),
                        (0, 0)))
    return image


class BatchLoader:
    """Multithreaded, prefetching pipeline yielding uint8 batches.

    Yields (images [B,H,W,3] uint8, labels [B] int32). `loader` is any
    callable ``file -> uint8 [H, W, 3]`` (an `ImageLoader`, or a lookup
    into arrays already in memory); `num_workers` of them run on a thread
    pool and `prefetch` batches are staged ahead, so the host's loading
    overlaps the device's compute. A loader with a ``native_mode`` (an
    `ImageLoader`) hands whole batches to the native library's thread pool
    instead, where the library is built; a row it cannot decode is loaded
    again through the loader itself, which tries PIL and raises on a file
    that PIL cannot read either.

    Resumable: the shuffle order of epoch e is derived from (seed, e) alone,
    exactly as the JAX package derives it, and the loader tracks an
    (epoch, pos) cursor advanced as each batch is handed to the consumer.
    `state()` captures the cursor; constructing with `start_state=`
    continues the exact sample sequence, so a mid-epoch resume neither skips
    nor repeats an image.

    `rows`, a function of a batch's index array, picks the part of each
    batch this process decodes and yields (`parallel.mesh.batch_rows` of a
    grid: every data rank draws the same global batches, the cursor
    included, and loads only its own rows of them).
    """

    def __init__(self, files, labels, loader, batch_size, shuffle=False,
                 repeat=False, drop_remainder=False, num_workers=8,
                 prefetch=2, seed=None, start_state=None, rows=None):
        self.files = list(files)
        self.labels = np.asarray(labels, dtype=np.int32)
        self.loader = loader
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.repeat = repeat
        self.drop_remainder = drop_remainder
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.rows = rows or (lambda idx: idx)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        self.seed = int(seed)
        self._epoch = 0
        self._pos = 0                      # batches delivered this epoch
        if start_state:
            self.seed = int(start_state.get('seed', self.seed))
            self._epoch = int(start_state.get('epoch', 0))
            self._pos = int(start_state.get('pos', 0))

    def __len__(self):
        n = len(self.files)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    @property
    def nrof_batches(self):
        return len(self)

    def state(self):
        """Cursor for checkpointing; feed back via `start_state=`."""
        return {'seed': self.seed, 'epoch': self._epoch, 'pos': self._pos}

    def _epoch_order(self, epoch):
        order = np.arange(len(self.files))
        if self.shuffle:
            np.random.RandomState(
                (self.seed * 1_000_003 + epoch) % (2 ** 31 - 1)).shuffle(order)
        return order

    def _index_stream(self):
        n = len(self.files)
        epoch, skip = self._epoch, self._pos
        while True:
            order = self._epoch_order(epoch)
            produced = 0
            for start in range(0, n, self.batch_size):
                idx = order[start:start + self.batch_size]
                if self.drop_remainder and len(idx) < self.batch_size:
                    continue
                produced += 1
                if produced <= skip:       # resume: skip delivered batches
                    continue
                yield idx
            epoch += 1
            skip = 0
            if not self.repeat:
                return

    def _advance(self):
        self._pos += 1
        if self._pos >= len(self):
            self._epoch += 1
            self._pos = 0

    def __iter__(self):
        mode = _native_mode(self.loader)
        if mode is None:
            inner = self._iter_threads()
        else:
            inner = _native_batches(
                self.files, self.loader, mode,
                ((idx, self.labels[idx])
                 for idx in map(self.rows, self._index_stream())),
                self.num_workers, self.prefetch)
        # the cursor advances when a batch is handed out, so a `state()`
        # taken after a step never re-delivers that batch on resume
        # (prefetched but undelivered batches do not count)
        for item in inner:
            self._advance()
            yield item

    def _iter_threads(self):
        stop = threading.Event()
        q = queue_mod.Queue(maxsize=max(self.prefetch, 1))

        def put_unless_stopped(item):
            # a bounded put that gives up when the consumer abandoned the
            # iterator (a blocking put would leak this thread)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def produce():
            # end-of-stream sentinel: None for a clean end, the exception
            # itself for a failure of the producer, so a file that cannot
            # be loaded raises in the consumer instead of ending the epoch
            # early and silently
            end = None
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idx in self._index_stream():
                        if stop.is_set():
                            return
                        idx = self.rows(idx)
                        images = list(pool.map(
                            lambda i: self.loader(self.files[i]), idx))
                        batch = np.stack(images)
                        if not put_unless_stopped((batch, self.labels[idx])):
                            return
            except BaseException as exc:
                end = exc
            put_unless_stopped(end)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()

        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            try:
                while q.get_nowait() is not None:
                    pass
            except queue_mod.Empty:
                pass


def _native_mode(loader):
    """The loader's geometry mode in the native library (an `ImageLoader`'s
    ``native_mode``) where the library is built, else None."""
    mode = getattr(loader, 'native_mode', None)
    if mode is None:
        return None
    from facenet_tpu_torch import native
    return mode if native.available() else None


def _native_batches(files, loader, mode, batches, num_workers, prefetch):
    """(images, labels) of each (file indices, labels) of `batches`,
    decoded by the native library's loader in `mode`, `prefetch` batches
    ahead; rows it could not decode go through `loader` itself."""
    from facenet_tpu_torch import native

    ldr = native.NativeBatchLoader(
        files, (loader.height, loader.width), mode=mode,
        num_threads=num_workers, prefetch=max(prefetch, 1))
    pending = []

    def stream():
        for idx, labels in batches:
            pending.append((idx, labels))
            yield idx

    try:
        for images, ok in ldr.iterate(stream()):
            idx, labels = pending.pop(0)
            # the library reads JPEG and PNG: the loader's PIL path loads
            # the other formats, and a file that no decoder reads raises
            # instead of yielding a silent zero image
            for row in np.flatnonzero(ok == 0):
                images[row] = loader(files[idx[row]])
            yield images, labels
    finally:
        ldr.close()


class PKPipeline:
    """P-classes x K-images equal batches, forever.

    Yields (images [P*K, H, W, 3] uint8, labels [P*K] int32), class-major.
    P and K come from ``config.nrof_classes_per_batch`` /
    ``nrof_examples_per_class`` (default 20 and 5, written back into the
    config); only classes with at least K images are drawn.

    Resumable: batch b is drawn with ``random.Random(f'{seed}:{b}')`` — P
    classes, then K images of each, all without replacement — so the
    stream is a pure function of the batch counter and the seed, the same
    stream the JAX package draws. `state()` is that counter; `start_state=`
    continues it. Images decode as `BatchLoader`'s do (the native library
    `prefetch` batches ahead for an `ImageLoader`, else a thread pool);
    `rows` picks the part of each batch that is loaded and yielded, as
    `BatchLoader`'s.
    """

    def __init__(self, loader, classes, config, seed=None, num_workers=8,
                 prefetch=2, start_state=None, rows=None):
        self.p = int(config.nrof_classes_per_batch or 20)
        self.k = int(config.nrof_examples_per_class or 5)
        config.nrof_classes_per_batch = self.p
        config.nrof_examples_per_class = self.k

        self.loader = loader
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.rows = rows or (lambda idx: idx)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        self.seed = int(seed)
        self._batch = 0
        if start_state:
            self.seed = int(start_state.get('seed', self.seed))
            self._batch = int(start_state.get('batch', 0))
        self._iter = None

        self.all_files = []
        self.class_slices = []
        self.usable = []
        for idx, _class in enumerate(classes):
            _class.index = idx
            self.class_slices.append((len(self.all_files),
                                      _class.nrof_images))
            self.all_files.extend(_class.files)
            if _class.nrof_images >= self.k:
                self.usable.append(idx)

    def state(self):
        """Cursor for checkpointing; feed back via `start_state=`."""
        return {'seed': self.seed, 'batch': self._batch}

    def _sample(self, b):
        """(file indices, labels) of batch b."""
        rnd = random.Random(f'{self.seed}:{b}')
        idx, labels = [], []
        for ci in rnd.sample(self.usable, self.p):
            start, n = self.class_slices[ci]
            rows = rnd.sample(range(n), self.k)
            idx.extend(start + r for r in rows)
            labels.extend([ci] * self.k)
        return idx, np.asarray(labels, dtype=np.int32)

    def _index_batches(self):
        """(this process's rows of batch b's file indices, their labels)
        for b from the cursor on."""
        b = self._batch
        while True:
            idx, labels = self._sample(b)
            yield np.asarray(self.rows(idx), np.int64), self.rows(labels)
            b += 1

    def _batches(self):
        mode = _native_mode(self.loader)
        if mode is not None:
            yield from _native_batches(
                self.all_files, self.loader, mode, self._index_batches(),
                self.num_workers, self.prefetch)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for idx, labels in self._index_batches():
                images = list(pool.map(
                    lambda i: self.loader(self.all_files[i]), idx))
                yield np.stack(images), labels

    def __iter__(self):
        return self

    def __next__(self):
        if self._iter is None:
            self._iter = self._batches()
        item = next(self._iter)
        self._batch += 1        # the cursor counts a batch once handed out
        return item


def pipeline_with_equal_batches(loader, classes, config, seed=None,
                                num_workers=8, prefetch=2, start_state=None,
                                rows=None):
    """`PKPipeline` under the reference's name."""
    return PKPipeline(loader, classes, config, seed=seed,
                      num_workers=num_workers, prefetch=prefetch,
                      start_state=start_state, rows=rows)


def equal_batches_input_pipeline(embeddings, config, seed=None):
    """Endless P x K batches over stored per-class embeddings.

    ``config.nrof_classes_per_batch`` (P) defaults to every class and
    ``config.nrof_examples_per_class`` (K) to a tenth of the mean class
    size (at least 1); classes with fewer than K embeddings are left out
    and P shrinks to the classes left. Both are written back to `config`.
    The draws are ``random.Random(seed)``'s, in the JAX package's order, so
    the batches are its batches.

    :param embeddings: list of [n_c, D] arrays, one per class
    :return: generator of [P * K, D] float32 batches
    :raises ValueError: no class holds K embeddings
    """
    if not config.nrof_classes_per_batch:
        config.nrof_classes_per_batch = len(embeddings)

    if not config.nrof_examples_per_class:
        config.nrof_examples_per_class = max(round(
            0.1 * sum(len(e) for e in embeddings) / len(embeddings)), 1)

    k = int(config.nrof_examples_per_class)
    usable = [e for e in embeddings if len(e) >= k]
    if not usable:
        raise ValueError(
            f'no class has >= {k} embeddings (largest: '
            f'{max((len(e) for e in embeddings), default=0)})')
    p = min(int(config.nrof_classes_per_batch), len(usable))
    config.nrof_classes_per_batch = p

    rnd = random.Random(seed)

    def generator():
        while True:
            batch = []
            for embs in rnd.sample(usable, p):
                rows = rnd.sample(range(len(embs)), k)
                batch.append(np.asarray(embs)[rows])
            yield np.concatenate(batch).astype(np.float32)

    return generator()
