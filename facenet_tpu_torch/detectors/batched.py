"""The front end the batched detectors share: a host batch to the device,
the detector enqueued on it, and its outputs fetched back.

`MTCNN`, `RetinaFace` and `FasterRCNN` take it from `BatchedDetector`;
`FacePipeline`, `FaceDetector.detect_files` and the benchmark's pipeline
cells call it.
"""

from __future__ import annotations

import numpy as np
import torch


class BatchedDetector:
    """A detector over uint8 [B, H, W, 3] batches of one fixed geometry.

    A subclass sets

      * ``image_shape``: the (H, W) every batch must have;
      * ``device``: the torch device the detector runs on;

    and defines

      * ``_detect(images)``: a uint8 tensor already on ``device`` -> a dict
        of device tensors, enqueued without waiting for them; an
        ``'overflow'`` entry, where there is one, is a dict of per-image
        counts of what a fixed capacity dropped.

    It then has

      * ``to_device(images)``: an array or tensor, checked against
        ``image_shape``, on ``device``;
      * ``detect_batch_async(images)``: ``_detect`` enqueued on a host batch;
      * ``finalize_batch(out_device)``: that result as numpy arrays, with a
        warning where a capacity dropped anything;
      * ``detect_batch(images)``: both in turn.

    ``overflow_warning`` is the warning's %-format, given the dict of drops
    by capacity.
    """

    overflow_warning = 'capacity overflow: dropped %s'

    def to_device(self, images):
        """uint8 [B, H, W, 3] array or tensor -> tensor on this device,
        checked against the detector's geometry."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images,
                                                           dtype=np.uint8))
        if tuple(images.shape[1:3]) != self.image_shape:
            raise ValueError(
                f'expected {self.image_shape} images, got '
                f'{tuple(images.shape[1:3])} — use '
                'letterbox.letterbox_batch()')
        return images.to(self.device, non_blocking=True)

    def detect_batch_async(self, images):
        """Enqueue the detector on a uint8 [B, H, W, 3] batch and return the
        output dict of device tensors without waiting for it."""
        with torch.inference_mode():
            return self._detect(self.to_device(images))

    def finalize_batch(self, out_device):
        """Fetch a `detect_batch_async` result as numpy arrays and report
        capacity drops."""
        out = {k: v.cpu().numpy() for k, v in out_device.items()
               if k != 'overflow'}
        if 'overflow' not in out_device:
            return out
        out['overflow'] = {k: v.cpu().numpy()
                           for k, v in out_device['overflow'].items()}
        dropped = {stage: int(counts.sum())
                   for stage, counts in out['overflow'].items()
                   if counts.sum() > 0}
        if dropped:
            from facenet_tpu_torch.logging import logger
            logger.warning(self.overflow_warning, dropped)
        return out

    def detect_batch(self, images):
        """Detect faces in a uint8 [B, H, W, 3] batch (H, W must match
        image_shape; letterbox first with `letterbox.letterbox_batch`).
        Returns the `_detect` dict as numpy arrays."""
        return self.finalize_batch(self.detect_batch_async(images))
