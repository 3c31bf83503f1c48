"""Quality gate for int8 serving: the full 10-fold validation, bf16 vs int8.

Counterpart of the JAX package's ``tools/validate_int8.py``: a trained
bundle embeds an evaluation dataset (directory per identity, up to 50
images each) through the bf16 fast path and through int8 serving
(``FaceNet`` with ``quantize: int8``, calibrated on up to 64 images of the
same directory), and the complete pair-validation report (metric 0, 10
folds, FAR target 1e-3) is printed for both, then whether their numbers are
identical. Runs on the GPU unless ``--device cpu``.

    python -m facenet_tpu_torch.tools.validate_int8 RUN_DIR EVAL_DIR \
        [--batch 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def evaluate(tag, model_cfg, eval_dir, batch, device):
    """The FaceToFaceValidation report of `eval_dir` through the FaceNet of
    `model_cfg` (a dict)."""
    from facenet_tpu_torch import dataset, facenet, statistics
    from facenet_tpu_torch.config import Config

    cfg = Config({'image': {'size': 160}, 'batch_size': batch,
                  'model': model_cfg})
    dbase = dataset.DBase(Config({'path': str(eval_dir),
                                  'max_nrof_images': 50}))
    t0 = time.time()
    ev = facenet.EvaluationOfEmbeddings(dbase, cfg, device=device)
    print(f'{tag}: {ev.embeddings.shape} embeddings '
          f'in {time.time() - t0:.1f}s', flush=True)
    report = statistics.FaceToFaceValidation(
        ev.embeddings, ev.labels,
        Config({'metric': 0, 'nrof_folds': 10, 'far_target': 0.001}),
        device=device)
    print(f'==== {tag} ====')
    print(report)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('run_dir', type=Path)
    parser.add_argument('eval_dir', type=Path)
    parser.add_argument('--batch', type=int, default=256)
    parser.add_argument('--device', default=None,
                        help="torch device, 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    bf16 = evaluate('bf16', {'path': str(args.run_dir)}, args.eval_dir,
                    args.batch, args.device)
    int8 = evaluate('int8', {'path': str(args.run_dir), 'quantize': 'int8',
                             'calib': str(args.eval_dir)},
                    args.eval_dir, args.batch, args.device)
    identical = bf16.dict == int8.dict
    print(f'int8 report identical to bf16: {identical}')
    return identical


if __name__ == '__main__':
    main()
