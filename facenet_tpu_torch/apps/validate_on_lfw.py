"""Validate a face recognizer on the standard LFW fixed-pairs protocol.

    pairs.txt -> resolve image paths -> batched embedding extraction
    -> 10-fold fixed-pairs accuracy / VAL@FAR / ROC (lfw.py)
    -> ``validate_on_lfw.txt`` + ``.h5`` in ``<dataset>_<model stem>/``.

Runs on the GPU unless ``--device cpu``:

    python -m facenet_tpu_torch.apps.validate_on_lfw --config lfw.yaml [--device cpu]

`validate.subtract_mean` subtracts the train folds' mean embedding before
the distances; `validate.flip` also embeds every image flipped along its
width and concatenates the two embeddings, so distances use the
2D-dimensional concatenation.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from facenet_tpu_torch import FaceNet, config, dataset, ioutils, lfw
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.facenet import evaluate_embeddings, renormalized


def embed(paths, facenet, loader, batch_size, flip=False):
    """Embeddings of `paths` in their order.

    :param facenet: a `FaceNet`; its ``normalize`` decides whether rows
        are re-normalized on the host
    :param loader: callable ``path -> uint8 [H, W, 3]``
    :param flip: concatenate each image's embedding with the embedding of
        the image flipped along W (flipped on the device), each half
        normalized on its own
    :return: float32 [len(paths), D] (2D with `flip`)
    """
    def forward(images):
        x = torch.from_numpy(np.asarray(images, np.uint8)).to(facenet.device)
        out = facenet.dispatch(x)
        if flip:
            out = torch.cat([out, facenet.dispatch(x.flip(2))], dim=1)
        return out

    batches = dataset.BatchLoader(paths, np.arange(len(paths)), loader,
                                  batch_size, shuffle=False)
    emb, order = evaluate_embeddings(forward, batches, renormalize=False)
    # BatchLoader keeps the order with shuffle=False; re-sort by the index
    # labels anyway so the pair structure can never silently skew
    emb = emb[np.argsort(order, kind='stable')]
    if facenet.normalize:
        emb = np.concatenate([renormalized(half) for half in
                              np.split(emb, 2 if flip else 1, axis=1)],
                             axis=1)
    return emb


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', dest='config_file', default=None,
                        type=Path,
                        help='User yaml config merged on top of the app '
                             'defaults.')
    parser.add_argument('--device', default=None,
                        help="torch device, 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    started = ioutils.get_time()
    device = resolve_device(args.device)
    options = config.validate_on_lfw(__file__, {'config': args.config_file})

    def stage(obj):
        ioutils.write_text_log(options.logfile, obj)
        print(obj)
        return obj

    pairs = lfw.read_pairs(options.dataset.pairs)
    paths, issame, nrof_skipped = lfw.get_paths(
        options.dataset.path, pairs, options.dataset.file_ext or None)
    if not len(issame):
        raise SystemExit(f'no resolvable pairs under {options.dataset.path} '
                         f'({nrof_skipped} skipped)')
    stage(f'pairs file: {options.dataset.pairs}\n'
          f'pairs: {len(issame)} ({int(np.count_nonzero(issame))} same), '
          f'skipped: {nrof_skipped}\n'
          f'model: {options.model.path}')

    embeddings = embed(paths, FaceNet(options.model, device=device),
                       dataset.ImageLoader(config=options.image),
                       int(config.value_or(options.batch_size, 100)),
                       flip=bool(options.validate.flip))
    stage(f'embeddings: {embeddings.shape}')

    report = stage(lfw.LfwValidation(embeddings, issame, options.validate))
    report.write_h5file(Path(options.logfile).with_suffix('.h5'))

    ioutils.write_elapsed_time(options.logfile, started)
    print(f'report written to {options.logfile}')
    return report, embeddings


if __name__ == '__main__':
    main()
