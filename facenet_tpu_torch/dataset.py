"""Dataset indexing and a batched image pipeline.

The directory-per-class `ImageClass`/`Database` index with h5 validity
filtering and class/image subsampling, a PIL image loader with
crop-or-pad to a fixed size, and an in-order batch generator of uint8
NHWC arrays. PIL and h5py are imported only where files are read.
"""

from __future__ import annotations

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

    def batches(self, loader, batch_size):
        """(images [B,H,W,3] uint8, labels [B] int32) in index order; the
        last batch may be smaller."""
        files, labels = self.files, self.labels.astype(np.int32)
        for start in range(0, len(files), int(batch_size)):
            stop = start + int(batch_size)
            images = np.stack([loader(f) for f in files[start:stop]])
            yield images, labels[start:stop]


DBase = Database


class ImageLoader:
    """Decode an image file with PIL into a fixed-shape uint8 RGB array
    (center crop-or-pad to size x size)."""

    def __init__(self, config=None, size=None):
        if size is None:
            size = int(config.size)
        self.height = self.width = int(size)

    def __call__(self, path):
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
