"""Validate a face recognizer: dataset -> embeddings -> K-fold pair report.

Index the dataset, run every image through the model, feed the
L2-normalized embeddings to FaceToFaceValidation, and append each stage's
repr to the run log (``<dataset>_<model>/validate.txt``); the report also
lands in ``validate.h5``. Runs on the GPU unless ``--device cpu``. Under
torchrun, with a ``mesh:`` section, the extraction splits over the ranks;
each rank loads the whole set and holds every embedding, so each computes
the pair statistics alone, and rank 0 writes.

    python -m facenet_tpu_torch.apps.validate --config my.yaml [--device cpu]
    torchrun --nproc-per-node N -m facenet_tpu_torch.apps.validate --config my.yaml
"""

from __future__ import annotations

import argparse
from pathlib import Path

from facenet_tpu_torch import config, dataset, facenet, ioutils, statistics
from facenet_tpu_torch.parallel import mesh as mesh_mod


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
    device = mesh_mod.join_torchrun(args.device)
    options = config.validate(__file__, {'config': args.config_file})
    options.model.normalize = True
    root = mesh_mod.world()[1] == 0

    def stage(obj):
        """Every pipeline stage logs its repr to the run log and stdout."""
        if root:
            ioutils.write_text_log(options.logfile, obj)
        print(obj)
        return obj

    dbase = stage(dataset.DBase(options.dataset))
    evaluation = stage(facenet.EvaluationOfEmbeddings(dbase, options,
                                                      device=device))
    report = stage(statistics.FaceToFaceValidation(
        evaluation.embeddings, evaluation.labels, options.validate,
        device=device))
    if not root:
        return report
    report.write_h5file(Path(options.logfile).with_suffix('.h5'))

    ioutils.write_elapsed_time(options.logfile, started)
    print(f'report written to {options.logfile}')
    return report


if __name__ == '__main__':
    main()
