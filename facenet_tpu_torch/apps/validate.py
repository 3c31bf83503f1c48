"""Validate a face recognizer: dataset -> embeddings -> K-fold pair report.

Index the dataset, run every image through the model, feed the
L2-normalized embeddings to FaceToFaceValidation, and append each stage's
repr to the run log (``<dataset>_<model>/validate.txt``); the report also
lands in ``validate.h5``. Runs on the GPU unless ``--device cpu``.

    python -m facenet_tpu_torch.apps.validate --config my.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from facenet_tpu_torch import config, dataset, facenet, ioutils, statistics
from facenet_tpu_torch.device import resolve_device


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
    options = config.validate(__file__, {'config': args.config_file})
    options.model.normalize = True

    def stage(obj):
        """Every pipeline stage logs its repr to the run log and stdout."""
        ioutils.write_text_log(options.logfile, obj)
        print(obj)
        return obj

    dbase = stage(dataset.DBase(options.dataset))
    evaluation = stage(facenet.EvaluationOfEmbeddings(dbase, options,
                                                      device=device))
    report = stage(statistics.FaceToFaceValidation(
        evaluation.embeddings, evaluation.labels, options.validate,
        device=device))
    report.write_h5file(Path(options.logfile).with_suffix('.h5'))

    ioutils.write_elapsed_time(options.logfile, started)
    print(f'report written to {options.logfile}')
    return report


if __name__ == '__main__':
    main()
