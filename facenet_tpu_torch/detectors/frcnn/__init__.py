"""Faster-RCNN face detector: networks, batched inference and training."""
from facenet_tpu_torch.detectors.frcnn.detector import FasterRCNN  # noqa: F401
