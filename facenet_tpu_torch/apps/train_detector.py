"""Train a face detector (the MTCNN cascade or the Faster-RCNN).

Annotations are a JSONL file, one object per image:

    {"image": "relative/or/absolute.png",
     "boxes": [[x1, y1, x2, y2], ...],
     "landmarks": [[[x1, y1], ..., [x5, y5]], ...]}   # optional, MTCNN only

``detector: mtcnn`` trains P-, R- and O-Net in that order on crops sampled
from the annotated images (`train.mtcnn`); ``detector: frcnnv3`` trains
the two-stage net jointly on letterboxed images (`detectors.frcnn`). The
learned parameters go to ``<run>/detector_params.npy``, a pickled dict of
numpy arrays under the JAX package's flax names, so either package's
``FaceDetector(params=np.load(path, allow_pickle=True).item())`` serves
it. Images are decoded with PIL. Runs on the GPU unless ``--device cpu``.

    python -m facenet_tpu_torch.apps.train_detector --config my.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from facenet_tpu_torch import config, ioutils, logging
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.logging import logger


def load_annotations(path):
    """Read the JSONL annotation file -> list of dicts with numpy arrays;
    relative image paths resolve against the file's directory."""
    records = []
    base = Path(str(path)).expanduser().parent
    with open(Path(str(path)).expanduser()) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            image = Path(rec['image'])
            if not image.is_absolute():
                image = base / image
            boxes = np.asarray(rec.get('boxes', []),
                               np.float32).reshape(-1, 4)
            lmk = rec.get('landmarks')
            records.append({
                'image': str(image),
                'boxes': boxes,
                'landmarks': (np.asarray(lmk, np.float32).reshape(-1, 5, 2)
                              if lmk else None),
            })
    return records


def _read_image(path):
    """uint8 RGB array of an image file (the native library's decode, PIL
    for what it cannot read), or None if it cannot be read."""
    from facenet_tpu_torch import native
    if native.available():
        arr = native.decode_image_native_size(path)
        if arr is not None:
            return arr
    try:
        return ioutils.read_image(path)
    except IOError:
        return None


def train_mtcnn(records, cfg, rng, device=None):
    """Stage-wise P -> R -> O training over crops sampled from the
    annotations, every draw from `rng` (a ``np.random.RandomState``).

    :return: {'pnet', 'rnet', 'onet'} flax trees of numpy arrays
    """
    from facenet_tpu_torch.train import mtcnn as tm

    batch_size = int(config.value_or(cfg.batch_size, 256))
    steps = int(config.value_or(cfg.train.epoch.size, 200))
    epochs = int(config.value_or(cfg.train.epoch.max_nrof_epochs, 1))
    lr = float(config.value_or(cfg.train.learning_rate, 1e-3))

    params = {}
    for net in ('pnet', 'rnet', 'onet'):
        trainer = tm.MTCNNTrainer(net=net, learning_rate=lr, device=device)
        state = trainer.init_state(seed=int(cfg.seed or 0))

        def batches():
            pool = [np.zeros((0, trainer.size, trainer.size, 3), np.uint8),
                    np.zeros(0, np.int32), np.zeros((0, 4), np.float32),
                    np.zeros((0, 10), np.float32), np.zeros(0, np.int32)]
            produced = 0
            while produced < steps:
                rec = records[rng.randint(len(records))]
                image = _read_image(rec['image'])
                if image is None:
                    continue
                sample = tm.generate_training_crops(
                    image, rec['boxes'], trainer.size, rng,
                    gt_landmarks=rec['landmarks'])
                pool = [np.concatenate([a, b]) for a, b in zip(pool, sample)]
                while len(pool[0]) >= batch_size:
                    batch = [a[:batch_size] for a in pool]
                    pool = [a[batch_size:] for a in pool]
                    produced += 1
                    yield tuple(batch)

        state, metrics = trainer.train(state, batches, epochs=epochs,
                                       log_every=50)
        logger.info(f'{net} final: ' +
                    ' '.join(f'{k}={v:.4f}' for k, v in metrics.items()))
        params[net] = trainer.params_of(state)
    return params


def train_frcnn(records, cfg, rng, device=None):
    """Joint two-stage training over whole annotated images, letterboxed to
    ``image.{height, width}``, the images of a batch drawn from `rng`.

    :return: {'backbone', 'rpn', 'head'} flax trees of numpy arrays
    """
    from facenet_tpu_torch.detectors.frcnn.detector import (FasterRCNN,
                                                            FasterRCNNTrainer)
    from facenet_tpu_torch.detectors.mtcnn.letterbox import letterbox_batch

    shape = (int(config.value_or(cfg.image.height, 480)),
             int(config.value_or(cfg.image.width, 640)))
    batch_size = int(config.value_or(cfg.batch_size, 8))
    steps = int(config.value_or(cfg.train.epoch.size, 200))
    epochs = int(config.value_or(cfg.train.epoch.max_nrof_epochs, 1))
    lr = float(config.value_or(cfg.train.learning_rate, 1e-3))

    det = FasterRCNN(image_shape=shape, device=device)
    trainer = FasterRCNNTrainer(det, learning_rate=lr)
    state = trainer.init_state(seed=int(cfg.seed or 0))

    metrics = {}
    for epoch in range(epochs):
        for n in range(steps):
            chosen = [records[rng.randint(len(records))]
                      for _ in range(batch_size)]
            images = [_read_image(r['image']) for r in chosen]
            keep = [i for i, im in enumerate(images) if im is not None]
            if not keep:
                continue
            batch, scales, pads = letterbox_batch(
                [images[i] for i in keep], shape)
            gts = []
            for j, i in enumerate(keep):
                b = chosen[i]['boxes'].copy()
                b[:, [0, 2]] = b[:, [0, 2]] * scales[j] + pads[j, 0]
                b[:, [1, 3]] = b[:, [1, 3]] * scales[j] + pads[j, 1]
                gts.append(b)
            state, metrics = trainer.train_step(state, batch, gts)
            if (n + 1) % 50 == 0:
                logger.info(f'epoch {epoch} step {n + 1}: ' + ' '.join(
                    f'{k}={float(v):.4f}' for k, v in metrics.items()))
    logger.info('final: ' + ' '.join(f'{k}={float(v):.4f}'
                                     for k, v in metrics.items()))
    return trainer.params_of(state)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', dest='config_file', default=None,
                        type=Path,
                        help='User yaml config merged on top of the app '
                             'defaults.')
    parser.add_argument('--device', default=None,
                        help="torch device, 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = config.train_detector({'config': args.config_file},
                                app_file_name=__file__)

    sink = logging.configure_logging(cfg.logs)
    try:
        records = load_annotations(cfg.annotations)
        n_boxes = sum(len(r['boxes']) for r in records)
        print(f'annotations: {len(records)} images, {n_boxes} boxes')
        if not records:
            raise ValueError(f'no annotations in {cfg.annotations}')

        rng = np.random.RandomState(int(cfg.seed or 0))
        detector = str(cfg.detector or 'mtcnn')

        if detector in ('mtcnn', 'pypimtcnn'):
            params = train_mtcnn(records, cfg, rng, device)
        elif detector == 'frcnnv3':
            params = train_frcnn(records, cfg, rng, device)
        else:
            raise ValueError(f'unknown detector {detector}')

        out = Path(cfg.model.path) / 'detector_params.npy'
        np.save(out, params, allow_pickle=True)
        print(f'Trained {detector} params saved to {out}')
    finally:
        logging.remove_file_sink(sink)
    return out


if __name__ == '__main__':
    main()
