"""facenet_tpu_torch — the PyTorch/CUDA port of facenet_tpu.

The `FaceNet` class here is the inference runtime: load a model bundle,
feed uint8 NHWC images, get L2-normalized float32 [B, D] embeddings from the
fused forward of the bundle's family (models/irv1_fast.py for
Inception-ResNet-v1, models/irv2_fast.py for v2), in bf16 or, with
``quantize: int8``, post-training int8 (models/quantize.py). It runs on the
GPU unless it is given ``device='cpu'``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

import numpy as np
import torch

__version__ = '0.1.0'

# the reference's node-name contract of a served model
nodes = {
    'input': {'name': 'input', 'type': 'uint8'},
    'output': {'name': 'embeddings', 'type': 'float32'},
}

config_nodes = {
    'image_size': {'name': 'image_size', 'type': 'uint8'},
}


class FaceNet:
    """Serving-time embedding extractor.

        from facenet_tpu_torch import FaceNet
        facenet = FaceNet(config)            # config.path -> model bundle dir
        emb = facenet.image_to_embedding(np.zeros([160, 160, 3], np.uint8))

    `config` is a model Config or a bundle directory path. Config keys:
    ``path``; ``normalize`` (or ``normalization``); ``quantize`` ('int8',
    or null/false for off) with ``calib`` (a uint8 batch, or a directory of
    images of which up to 64 are read); ``stem`` ('cudnn' or 'fused',
    Inception-ResNet-v1 only). `bundle` is an in-memory
    `export.ModelBundle` served in place of ``config.path`` (the config
    then only sets the options). Outputs are L2-normalized float32
    embeddings, or the raw bottleneck when ``config.normalize`` is false.
    There is no generic fallback: a bundle of another class, or a fast
    path that fails, raises.
    """

    def __init__(self, config=None, device=None, bundle=None):
        from facenet_tpu_torch import export
        from facenet_tpu_torch.config import Config, value_or
        from facenet_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        if isinstance(config, (str, Path)):
            config = Config({'path': str(config), 'normalize': True})
        config = config or Config()
        if bundle is None:
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

        kwargs = {}
        # `quantize: null` / `false` in YAML mean off, not the strings
        quantize = config.quantize if config.exists('quantize') else None
        if quantize:
            kwargs = {'quantize': str(quantize),
                      'calib_images': self._calib_batch(config,
                                                        bundle.image_size)}
        stem = str(value_or(config.stem, 'cudnn'))
        if bundle.model_class == 'InceptionResnetV1':
            from facenet_tpu_torch.models.irv1_fast import \
                FastEmbedder as embedder
            kwargs['stem'] = stem
        elif bundle.model_class == 'InceptionResnetV2':
            from facenet_tpu_torch.models.irv2_fast import \
                FastEmbedderV2 as embedder
            if stem != 'cudnn':
                raise ValueError(f'stem={stem!r} is an Inception-ResNet-v1 '
                                 'option')
        else:
            raise NotImplementedError(
                f'{bundle.model_class} bundles are not supported by the '
                'PyTorch port')
        self._forward = embedder(
            bundle.variables, config=bundle.config,
            image_size=bundle.image_size,
            normalization=bundle.normalization,
            normalize=self.normalize, device=self.device, **kwargs)

    @staticmethod
    def _calib_batch(config, image_size, limit=64):
        """Representative uint8 batch for int8 calibration.

        `config.calib` may be an array-like batch (already at the model's
        input size) or a directory of images, each resized to `image_size`
        x `image_size` (PIL bilinear) on load so mixed-size photos stack;
        up to `limit` of them, spread over the sorted directory.
        """
        calib = config.calib if config.exists('calib') else None
        if calib is None:
            raise ValueError("quantize='int8' needs config.calib: a "
                             'uint8 image batch or a directory of '
                             'representative images')
        if isinstance(calib, (str, Path)):
            from PIL import Image
            paths = sorted(p for p in Path(calib).expanduser().rglob('*')
                           if p.suffix.lower() in
                           ('.png', '.jpg', '.jpeg', '.bmp'))
            if not paths:
                raise ValueError(f'no calibration images under {calib}')
            step = max(len(paths) // limit, 1)
            paths = paths[::step][:limit]
            size = (int(image_size), int(image_size))
            return np.stack([
                np.asarray(Image.open(p).convert('RGB').resize(
                    size, Image.BILINEAR))
                for p in paths])
        return np.asarray(calib, dtype=np.uint8)

    @property
    def embedding_size(self):
        return self._forward.embedding_size

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


def check_output_size(model):
    """The embedding width of an Inception-ResNet-v1 module (its config's
    ``output.size``, defaults filled in)."""
    from facenet_tpu_torch.models.inception_resnet_v1 import \
        check_input_config
    return check_input_config(model.config).output.size


def __getattr__(name):
    # lazy, so `import facenet_tpu_torch` does not load the detector
    if name == 'FacePipeline':
        from facenet_tpu_torch.pipeline import FacePipeline
        return FacePipeline
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
