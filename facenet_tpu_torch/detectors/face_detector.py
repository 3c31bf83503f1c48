"""Detection facade: a uniform `detect(image) -> [BoundingBox]` API.

`FaceDetector` / `BoundingBox` / margin-crop `image_processing`, with the
batched MTCNN cascade (detectors/mtcnn/; 'pypimtcnn' is accepted as an
alias), the batched Faster-RCNN (detectors/frcnn/, 'frcnnv3') or the
batched RetinaFace-R50 (detectors/retinaface/, 'retinaface') as the
backend. Single-image `detect` is kept for API compatibility;
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

    Supported: 'mtcnn' (the batched cascade; 'pypimtcnn' is an alias),
    'frcnnv3' (the two-stage Faster-RCNN) and 'retinaface' (RetinaFace-R50,
    biubug6/Pytorch_Retinaface's cfg_re50).

    :param image_shape: the (single) letterbox geometry
    :param image_shapes: optional list of (H, W) letterbox buckets sharing
        one weight set; each input routes to the bucket that avoids
        downscaling where possible (`route_shape`), and each bucket's
        backend is built at first use
    :param params: the backend's flax-layout param tree (RetinaFace: a
        state dict by the published names); default the bundled weights
        (`pretrained.load_bundled`)
    :param weights: MTCNN: a ``.npz`` bundle in the `pretrained` format or
        a directory of davidsandberg ``det1/det2/det3.npy`` files (whose
        P-Net regressors assume the 'caffe' base-box convention, the
        default then); Faster-RCNN: a ``.npz`` bundle or a pickled ``.npy``
        dict (the train_detector app's ``detector_params.npy``);
        RetinaFace: biubug6's ``.pth`` state dict (``Resnet50_Final.pth``)
    :param device: torch device; None means cuda (raises without a GPU)
    :param kwargs: forwarded to `MTCNN`, `FasterRCNN` or `RetinaFace`
    """

    def __init__(self, detector='mtcnn', image_shape=(480, 640),
                 image_shapes=None, params=None, weights=None, device=None,
                 **kwargs):
        self.detector = detector
        self.device = resolve_device(device)

        from facenet_tpu_torch.detectors import pretrained
        if detector in ('mtcnn', 'pypimtcnn'):
            if params is None and weights:
                if str(weights).endswith('.npz'):
                    params = pretrained.load_params(weights)
                else:
                    from facenet_tpu_torch.detectors.mtcnn.weights import (
                        load_davidsandberg_weights)
                    params = load_davidsandberg_weights(weights)
                    kwargs.setdefault('pnet_box_convention', 'caffe')
        elif detector == 'frcnnv3':
            if params is None and weights:
                params = (pretrained.load_params(weights)
                          if str(weights).endswith('.npz')
                          else np.load(weights, allow_pickle=True).item())
        elif detector == 'retinaface':
            if params is None and weights:
                import torch
                params = torch.load(weights, map_location='cpu',
                                    weights_only=True)
        else:
            raise ValueError(
                'Undefined face detector type {}'.format(detector))
        if params is None:
            params = pretrained.load_bundled(detector)
            if params is None:
                from facenet_tpu_torch.logging import logger
                logger.warning(
                    f'no bundled weights for {detector!r}; using RANDOM '
                    'init — detections will be meaningless until trained')

        device = self.device

        def build(shape):
            if detector == 'retinaface':
                from facenet_tpu_torch.detectors.retinaface.detector import (
                    RetinaFace)
                return RetinaFace(image_shape=shape, params=params,
                                  device=device, **kwargs)
            if detector == 'frcnnv3':
                from facenet_tpu_torch.detectors.frcnn.detector import (
                    FasterRCNN)
                return FasterRCNN(image_shape=shape, params=params,
                                  device=device, **kwargs)
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
        """Image files -> per-file [BoundingBox] lists, in batches of
        `batch_size` files; unreadable files get an empty list.

        With the native library (`facenet_tpu_torch.native`), as the JAX
        package: each file routes to the bucket of its native size by a
        header-only probe, each bucket's files decode on the library's
        thread pool in MODE_LETTERBOX a batch ahead of the device, the
        backend runs two batches deep (`detect_batch_async` /
        `finalize_batch`), and a batch's letterbox geometry is read from
        the headers while the device works. Without it, PIL decodes the
        same canvases (`letterbox.letterbox_file`) one batch at a time."""
        from facenet_tpu_torch import native

        paths = [str(p) for p in paths]
        if not native.available():
            return self._detect_files_pil(paths, batch_size)
        if len(self.image_shapes) == 1:
            return self._detect_files_native(paths, batch_size,
                                             self.image_shapes[0])
        by_shape = {}
        for j, path in enumerate(paths):
            size = native.probe_image(path)
            shape = self.route_shape(*size) if size else self.image_shapes[0]
            by_shape.setdefault(shape, []).append(j)
        results = [None] * len(paths)
        for shape, idxs in by_shape.items():
            found = self._detect_files_native([paths[j] for j in idxs],
                                              batch_size, shape)
            for j, boxes in zip(idxs, found):
                results[j] = boxes
        return results

    def _detect_files_native(self, paths, batch_size, shape):
        """`detect_files` of files that all go to the bucket `shape`."""
        from collections import deque

        from facenet_tpu_torch import native

        backend = self.backend_for(shape)
        batches = [list(range(s, min(s + batch_size, len(paths))))
                   for s in range(0, len(paths), batch_size)]
        results = []

        def collect(out_device, idxs, ok, geometry):
            out = backend.finalize_batch(out_device)
            for i, (scale, (left, top)) in enumerate(geometry):
                results.append(self._boxes_from_output(
                    out, i, scale, left, top) if ok[i] else [])

        loader = native.NativeBatchLoader(paths, shape,
                                          mode=native.MODE_LETTERBOX)
        inflight = deque()
        try:
            for idxs, (images, ok) in zip(batches, loader.iterate(batches)):
                out_device = backend.detect_batch_async(images)
                # the headers are read while this batch runs on the device
                geometry = []
                for j in idxs:
                    size = native.probe_image(paths[j])
                    geometry.append(
                        native.letterbox_geometry(*size, shape) if size
                        else (1.0, (0, 0)))
                inflight.append((out_device, idxs, ok, geometry))
                if len(inflight) > 2:
                    collect(*inflight.popleft())
            while inflight:
                collect(*inflight.popleft())
        finally:
            loader.close()
        return results

    def _detect_files_pil(self, paths, batch_size):
        """`detect_files` without the native library."""
        from facenet_tpu_torch.detectors.mtcnn.letterbox import letterbox_file

        results = [[] for _ in paths]
        for start in range(0, len(paths), batch_size):
            by_shape = {}
            for j in range(start, min(start + batch_size, len(paths))):
                try:
                    canvas, scale, pad = letterbox_file(paths[j],
                                                        self.route_shape)
                except Exception:
                    # an empty list, not a dummy image: a zeros frame through
                    # the cascade can emit spurious boxes
                    continue
                by_shape.setdefault(canvas.shape[:2], []).append(
                    (j, canvas, scale, pad))
            for shape, group in by_shape.items():
                out = self.backend_for(shape).detect_batch(
                    np.stack([canvas for _, canvas, _, _ in group]))
                for i, (j, _, scale, (left, top)) in enumerate(group):
                    results[j] = self._boxes_from_output(out, i, scale,
                                                         left, top)
        return results

    def _boxes_from_output(self, out, i, scale, pad_x, pad_y):
        """Map one image's backend output back to original-pixel boxes."""
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
        from facenet_tpu_torch.detectors.mtcnn.letterbox import letterbox_batch

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
