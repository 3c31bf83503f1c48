"""Detection facade: a uniform `detect(image) -> [BoundingBox]` API.

`FaceDetector` / `BoundingBox` / margin-crop `image_processing`, with the
batched MTCNN cascade (detectors/mtcnn/) as the backend; 'pypimtcnn' is
accepted as an alias. Single-image `detect` is kept for API compatibility;
`detect_images` is the batched path. PIL is imported only where an image
is decoded or cropped.
"""

from __future__ import annotations

import math

import numpy as np

from facenet_tpu_torch.device import resolve_device


def image_processing(image, box, options):
    """Margin-crop + resize a detected face.

    :param image: PIL.Image
    :param box: BoundingBox
    :param options: config with `.size` and `.margin`
    """
    from PIL import Image

    if not isinstance(image, Image.Image):
        raise ValueError('Input must be PIL.Image')

    margin = float(options.margin or 0)
    size = int(options.size)

    w_margin = round(box.width * margin / 2)
    h_margin = round(box.height * margin / 2)

    cropped = image.crop((box.left - w_margin, box.top - h_margin,
                          box.right + w_margin, box.bottom + h_margin))

    width = math.ceil(size + size * margin)
    height = math.ceil(size + size * margin)

    resampling = getattr(Image, 'Resampling', Image)
    return cropped.resize((width, height), resampling.LANCZOS)


class BoundingBox:
    """Integer-rounded face box with confidence."""

    def __init__(self, left, top, width, height, confidence=None,
                 landmarks=None):
        self.left = int(np.round(left))
        self.right = int(np.round(left + width)) + 1

        self.top = int(np.round(top))
        self.bottom = int(np.round(top + height)) + 1

        self.width = self.right - self.left - 1
        self.height = self.bottom - self.top - 1
        self.confidence = confidence
        self.landmarks = landmarks      # optional [5, 2] (x, y) points

    def info(self, mode=False):
        if mode is False:
            return '{}'.format([self.left, self.top, self.width, self.height,
                                self.confidence])
        return ('left = {}, top = {}, width = {}, height = {}, '
                'confidence = {}'.format(self.left, self.top, self.width,
                                         self.height, self.confidence))

    def __repr__(self):
        return self.info(mode=True)

    @property
    def left_upper(self):
        return self.left, self.top

    @property
    def right_lower(self):
        return self.right, self.bottom

    @property
    def confidence_as_string(self):
        return str(np.round(self.confidence, 3))


class FaceDetector:
    """Facade selecting a detection backend.

    Supported: 'mtcnn' (the batched cascade; 'pypimtcnn' is an alias).
    'frcnnv3' is not ported yet.

    :param image_shape: the (single) letterbox geometry
    :param image_shapes: optional list of (H, W) letterbox buckets sharing
        one weight set; each input routes to the bucket that avoids
        downscaling where possible (`route_shape`), and each bucket's
        cascade is built at first use
    :param params: flax-layout MTCNN param tree; default the bundled
        weights (`pretrained.load_bundled`)
    :param weights: a ``.npz`` bundle in the `pretrained` format
    :param device: torch device; None means cuda (raises without a GPU)
    :param kwargs: forwarded to `MTCNN`
    """

    def __init__(self, detector='mtcnn', image_shape=(480, 640),
                 image_shapes=None, params=None, weights=None, device=None,
                 **kwargs):
        self.detector = detector
        self.device = resolve_device(device)

        if detector == 'frcnnv3':
            raise NotImplementedError(
                "the 'frcnnv3' detector is not ported yet (ROADMAP queue A, "
                'item 13)')
        if detector not in ('mtcnn', 'pypimtcnn'):
            raise ValueError(
                'Undefined face detector type {}'.format(detector))
        self.mode = 'RGB'

        from facenet_tpu_torch.detectors import pretrained
        if params is None and weights:
            if not str(weights).endswith('.npz'):
                raise NotImplementedError(
                    'importing det1/det2/det3.npy MTCNN weights is not ported '
                    'yet (ROADMAP queue A, item 13); pass a .npz bundle')
            params = pretrained.load_params(weights)
        if params is None:
            params = pretrained.load_bundled(detector)
            if params is None:
                from facenet_tpu_torch.logging import logger
                logger.warning(
                    f'no bundled weights for {detector!r}; using RANDOM '
                    'init — detections will be meaningless until trained')

        device = self.device

        def build(shape):
            from facenet_tpu_torch.detectors.mtcnn.cascade import MTCNN
            from facenet_tpu_torch.detectors.mtcnn.weights import (
                validate_params)
            backend = MTCNN(image_shape=shape, params=params, device=device,
                            **kwargs)
            if params is not None:
                validate_params(params, backend)
            return backend

        shapes = [tuple(int(v) for v in s)
                  for s in (image_shapes or [image_shape])]
        self.image_shapes = sorted(set(shapes), key=lambda s: s[0] * s[1])
        self._build_backend = build
        self._backends = {self.image_shapes[0]: build(self.image_shapes[0])}

    def backend_for(self, shape):
        """The backend for one bucket, built at first use."""
        shape = (int(shape[0]), int(shape[1]))
        if shape not in self._backends:
            self._backends[shape] = self._build_backend(shape)
        return self._backends[shape]

    def route_shape(self, h, w):
        """Pick the letterbox bucket for an (h, w) input.

        Maximizes min(letterbox_scale, 1): prefer any bucket that holds
        the image at native scale, otherwise the bucket that downscales
        least; ties go to the smallest bucket (scanned smallest-area first).
        """
        h, w = max(int(h), 1), max(int(w), 1)
        best, best_key = None, None
        for th, tw in self.image_shapes:
            key = min(th / h, tw / w, 1.0)
            if best_key is None or key > best_key + 1e-9:
                best, best_key = (th, tw), key
        return best

    def detect(self, image):
        """Single-image detect -> list of BoundingBox."""
        return self.detect_images([np.asarray(image)])[0]

    def detect_files(self, paths, batch_size=64):
        """Image files -> per-file [BoundingBox] lists, decoded with PIL in
        batches of `batch_size`; unreadable files get an empty list."""
        from PIL import Image

        paths = [str(p) for p in paths]
        results = []
        for start in range(0, len(paths), batch_size):
            chunk, readable = [], []
            for p in paths[start:start + batch_size]:
                try:
                    with Image.open(p) as img:
                        chunk.append(np.asarray(img.convert(self.mode)))
                    readable.append(True)
                except Exception:
                    # an empty list, not a dummy image: a zeros frame through
                    # the cascade can emit spurious boxes
                    readable.append(False)
            detected = iter(self.detect_images(chunk) if chunk else ())
            results.extend(next(detected) if ok else [] for ok in readable)
        return results

    def _boxes_from_output(self, out, i, scale, pad_x, pad_y):
        """Map one image's cascade output back to original-pixel boxes."""
        landmarks = out.get('landmarks')
        boxes_i = []
        for k in range(out['boxes'].shape[1]):
            if not out['valid'][i, k]:
                continue
            x1, y1, x2, y2 = out['boxes'][i, k]
            x1 = (x1 - pad_x) / scale
            x2 = (x2 - pad_x) / scale
            y1 = (y1 - pad_y) / scale
            y2 = (y2 - pad_y) / scale
            lmk = None
            if landmarks is not None:
                lmk = ((landmarks[i, k] -
                        np.array([pad_x, pad_y], np.float32)[None, :])
                       / scale)
            boxes_i.append(BoundingBox(
                left=x1, top=y1, width=x2 - x1, height=y2 - y1,
                confidence=float(out['scores'][i, k]), landmarks=lmk))
        return boxes_i

    def detect_images(self, images):
        """Batched detect over arbitrary-size uint8 images.

        Letterboxes to the cascade geometry (per-image bucket routing when
        several `image_shapes` are configured), runs the cascade per bucket
        batch, and maps boxes back to original pixels.
        """
        from facenet_tpu_torch.detectors.mtcnn.cascade import letterbox_batch

        images = [np.asarray(img) for img in images]
        by_shape = {}
        for j, img in enumerate(images):
            shape = (self.route_shape(img.shape[0], img.shape[1])
                     if len(self.image_shapes) > 1 else self.image_shapes[0])
            by_shape.setdefault(shape, []).append(j)

        results = [None] * len(images)
        for shape, idxs in by_shape.items():
            backend = self.backend_for(shape)
            batch, scales, pads = letterbox_batch(
                [images[j] for j in idxs], backend.image_shape)
            out = backend.detect_batch(batch)
            for i, j in enumerate(idxs):
                results[j] = self._boxes_from_output(
                    out, i, scales[i], pads[i, 0], pads[i, 1])
        return results

    def __repr__(self):
        return (f'class {self.__class__.__name__}\n' +
                f'detector type: {self.detector}')
