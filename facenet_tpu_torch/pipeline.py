"""Face pipeline: scenes -> detected, aligned and embedded faces.

`FacePipeline` runs the MTCNN cascade, the alignment (margin crop or
5-point landmark warp) and the fused embedding forward on one device with
no host round trip between the stages: a batch of scenes is enqueued as a
whole and fetched once.

Alignment modes:
- 'crop': margin-expanded box crop resized straight to the model input.
- 'landmarks': 5-point similarity warp to the canonical template; on the
  card all B x num_faces crops of a batch go through one launch of the
  dense-warp kernel.

Spans (`utils.profiling`): ``pipeline.h2d`` (the scenes' copy),
``mtcnn.pnet`` / ``.rnet`` / ``.onet`` (the cascade), ``pipeline.align``,
``pipeline.embed``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from facenet_tpu_torch.config import Config
from facenet_tpu_torch.utils import profiling


class FacePipeline:
    """Detect -> align -> embed over fixed-shape uint8 scene batches.

    :param model: a `facenet_tpu_torch.FaceNet`, a model Config, or an
        exported model directory
    :param image_shape: (H, W) of the cascade; letterbox inputs to it first
        (detectors.mtcnn.letterbox.letterbox_batch)
    :param align: 'crop' | 'landmarks'
    :param margin: box-relative margin fraction for align='crop'
    :param num_faces: embedding slots per image (the first `num_faces`
        cascade outputs; `valid` marks real detections)
    :param device: torch device; None means cuda (raises without a GPU)
    :param detector_kwargs: forwarded to the MTCNN cascade (thresholds,
        capacities, weights via `params`, ...)
    """

    def __init__(self, model, image_shape=(480, 640), align='crop',
                 margin=0.2, num_faces=1, device=None, **detector_kwargs):
        from facenet_tpu_torch import FaceNet
        from facenet_tpu_torch.detectors.face_detector import FaceDetector
        from facenet_tpu_torch.device import resolve_device

        if isinstance(model, FaceNet):
            if device is None:
                device = model.device
            elif resolve_device(device) != model.device:
                raise ValueError(f'model is on {model.device}, pipeline '
                                 f'asked for {device}')
        self.device = resolve_device(device)
        if not isinstance(model, FaceNet):
            if isinstance(model, (str, Path)):
                model = Config({'path': str(model), 'normalize': True})
            model = FaceNet(model, device=self.device)
        self.facenet = model
        if align not in ('crop', 'landmarks'):
            raise ValueError(f"align must be 'crop' or 'landmarks', "
                             f'got {align!r}')
        self.align = align
        self.margin = float(margin)
        self.num_faces = int(num_faces)
        self.image_shape = (int(image_shape[0]), int(image_shape[1]))
        self.size = int(self.facenet._forward.image_size)

        detector = FaceDetector(detector='mtcnn',
                                image_shape=self.image_shape,
                                device=self.device, **detector_kwargs)
        self.backend = detector.backend_for(self.image_shape)

    @torch.inference_mode()
    def _step(self, images):
        from facenet_tpu_torch.ops.crop import crop_and_resize
        from facenet_tpu_torch.ops.image_ops import align_by_landmarks
        k, size = self.num_faces, self.size
        b = images.shape[0]
        out = self.backend._detect(images)
        with profiling.annotate('pipeline.align'):
            scenes = images.float()
            if self.align == 'landmarks':
                crops = align_by_landmarks(scenes, out['landmarks'][:, :k],
                                           size)
            else:
                boxes = out['boxes'][:, :k]
                wh = boxes[..., 2:4] - boxes[..., 0:2]
                lo = boxes[..., 0:2] - wh * (self.margin / 2)
                hi = boxes[..., 2:4] + wh * (self.margin / 2)
                crops = crop_and_resize(scenes, torch.cat([lo, hi], dim=-1),
                                        size)
            flat = torch.clamp(crops + 0.5, 0, 255).to(torch.uint8)
        with profiling.annotate('pipeline.embed'):
            emb = self.facenet.dispatch(flat.reshape(b * k, size, size, 3))
        return {
            'embeddings': emb.reshape(b, k, -1),
            'boxes': out['boxes'][:, :k],
            'scores': out['scores'][:, :k],
            'valid': out['valid'][:, :k],
            'landmarks': out['landmarks'][:, :k],
            'overflow': out['overflow'],
        }

    def dispatch(self, images):
        """Enqueue one batch and return its outputs as device tensors,
        not synchronized, so callers can overlap host work (see
        process_files)."""
        with profiling.annotate('pipeline.h2d'):
            images = self.backend.to_device(images)
        return self._step(images)

    def process_batch(self, images):
        """uint8 [B, H, W, 3] scenes -> numpy dict with 'embeddings'
        [B, num_faces, D] float32 (L2-normed where 'valid'), 'boxes',
        'scores', 'valid', 'landmarks' (scene pixel coordinates)."""
        out = self.dispatch(images)
        out.pop('overflow')
        return {key: value.cpu().numpy() for key, value in out.items()}

    def process_files(self, paths, batch_size=64):
        """Image files -> (embeddings [N, num_faces, D], boxes, valid).

        Files are decoded at their own size by the native library
        (`native.decode_image_native_size`; PIL where it was not built or
        cannot read a file) and letterboxed one batch ahead of the device;
        boxes map back to original pixels through the letterbox geometry.
        An unreadable file gives an all-invalid row.
        """
        from facenet_tpu_torch import ioutils, native
        from facenet_tpu_torch.detectors.mtcnn.letterbox import letterbox_batch

        paths = [str(p) for p in paths]
        n = len(paths)
        k, d = self.num_faces, self.facenet.embedding_size
        embeddings = np.zeros((n, k, d), np.float32)
        boxes = np.zeros((n, k, 4), np.float32)
        valid = np.zeros((n, k), bool)

        use_native = native.available()

        def load(chunk):
            arrays, idxs = [], []
            for j in chunk:
                arr = (native.decode_image_native_size(paths[j]) if use_native
                       else None)
                if arr is None:
                    try:
                        arr = ioutils.read_image(paths[j])
                    except IOError:
                        continue
                arrays.append(arr)
                idxs.append(j)
            if not arrays:
                return None
            batch, scales, pads = letterbox_batch(arrays, self.image_shape)
            pad_n = batch_size - len(arrays)
            if pad_n:
                batch = np.concatenate(
                    [batch, np.zeros((pad_n,) + batch.shape[1:], batch.dtype)])
            return batch, scales, pads, idxs

        def collect(out_d, geom):
            out = {key: out_d[key].cpu().numpy()
                   for key in ('embeddings', 'valid', 'boxes')}
            _, scales, pads, idxs = geom
            for row, j in enumerate(idxs):
                embeddings[j] = out['embeddings'][row]
                valid[j] = out['valid'][row]
                shift = np.array([pads[row][0], pads[row][1]] * 2, np.float32)
                boxes[j] = (out['boxes'][row] - shift) / scales[row]

        chunks = [list(range(s, min(s + batch_size, n)))
                  for s in range(0, n, batch_size)]
        inflight = []
        geom = load(chunks[0]) if chunks else None
        for i in range(len(chunks)):
            if geom is not None:
                inflight.append((self.dispatch(geom[0]), geom))
            geom = load(chunks[i + 1]) if i + 1 < len(chunks) else None
            if len(inflight) > 1:
                collect(*inflight.pop(0))
        for item in inflight:
            collect(*item)
        return embeddings, boxes, valid

    def __repr__(self):
        return (f'class {type(self).__name__}\n'
                f'align: {self.align}\n'
                f'image shape: {self.image_shape}\n'
                f'faces per image: {self.num_faces}')
