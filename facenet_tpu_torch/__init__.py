"""facenet_tpu_torch — the PyTorch/CUDA port of facenet_tpu.

The `FaceNet` class here is the inference runtime: load a model bundle,
feed uint8 NHWC images, get L2-normalized float32 [B, 512] embeddings from
the fused Inception-ResNet-v1 forward (models/irv1_fast.py). It runs on the
GPU unless it is given ``device='cpu'``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

import numpy as np
import torch

__version__ = '0.1.0'


class FaceNet:
    """Serving-time embedding extractor.

        from facenet_tpu_torch import FaceNet
        facenet = FaceNet(config)            # config.path -> model bundle dir
        emb = facenet.image_to_embedding(np.zeros([160, 160, 3], np.uint8))

    `config` is a model Config (``path``, optional ``normalize`` or
    ``normalization``), a bundle directory path, or an
    `export.ModelBundle`. Outputs are L2-normalized float32 embeddings, or
    the raw bottleneck when ``config.normalize`` is false.
    """

    def __init__(self, config, device=None):
        from facenet_tpu_torch import export
        from facenet_tpu_torch.config import Config
        from facenet_tpu_torch.device import resolve_device
        from facenet_tpu_torch.models.irv1_fast import FastEmbedder

        self.device = resolve_device(device)
        if isinstance(config, export.ModelBundle):
            bundle, config = config, Config({'normalize': True})
        else:
            if isinstance(config, (str, Path)):
                config = Config({'path': str(config), 'normalize': True})
            if not config.path:
                raise ValueError(
                    'FaceNet needs config.path pointing at an exported model '
                    'directory (got an empty/missing path — pass the MODEL '
                    "config, e.g. FaceNet(cfg.model), not the app config)")
            bundle = export.load_model(Path(str(config.path)).expanduser())

        self.config = config
        # both spellings are honored: app configs say `model.normalization`,
        # the class API `normalize`
        if config.exists('normalize'):
            self.normalize = bool(config.normalize)
        elif config.exists('normalization'):
            self.normalize = bool(config.normalization)
        else:
            self.normalize = True

        if config.exists('quantize') and config.quantize:
            raise NotImplementedError(
                'int8 serving (quantize) is not ported to PyTorch yet')

        self._forward = FastEmbedder(
            bundle.variables, config=bundle.config,
            image_size=bundle.image_size,
            normalization=bundle.normalization,
            normalize=self.normalize, device=self.device)

    @property
    def embedding_size(self):
        return int(self._forward.cfg.output.size)

    def dispatch(self, images):
        """Async forward: enqueue the batch and return the embeddings as an
        un-synchronized tensor on the device. `facenet.evaluate_embeddings`
        uses this to overlap loading batch n+1 with computing batch n."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.asarray(images, dtype=np.uint8))
        return self._forward(images)

    def evaluate(self, images):
        """Embeddings of a uint8 NHWC batch as a numpy array."""
        return self.dispatch(images).cpu().numpy()

    def image_to_embedding(self, image_arrays: Iterable[np.ndarray]) -> np.ndarray:
        image_arrays = np.asarray(image_arrays)
        if image_arrays.ndim == 3:
            image_arrays = np.expand_dims(image_arrays, 0)
        return self.evaluate(image_arrays)


def __getattr__(name):
    # lazy, so `import facenet_tpu_torch` does not load the detector
    if name == 'FacePipeline':
        from facenet_tpu_torch.pipeline import FacePipeline
        return FacePipeline
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
