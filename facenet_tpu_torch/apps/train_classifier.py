"""Train a face-to-face pair classifier on stored embeddings.

Stored embeddings (an h5 file of ``embeddings`` and ``labels``) -> P x K
equal batches -> the pair classifier (`faceclass`; the normalized variant
when ``embeddings.normalize``) trained by Adam on the exponential-decay
schedule -> ``classifier.yaml`` (class name and variables) and the
class-pair confusion in the run directory. Runs on the GPU unless
``--device cpu``.

    python -m facenet_tpu_torch.apps.train_classifier --config my.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from facenet_tpu_torch import config, facenet, ioutils
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.train.classifier import (ClassifierTrainer,
                                                ConfusionMatrix)


def write_classifier(path, model):
    """``classifier.yaml``: the class name and its variables as floats, the
    JAX package's keys."""
    import yaml

    with Path(path).open('wt') as f:
        yaml.safe_dump(
            {'class': type(model).__name__,
             'variables': {k: float(v) for k, v in
                           model.variables_dict().items()}}, f)


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
    options = config.train_classifier(__file__, {'config': args.config_file})

    embeddings = facenet.Embeddings(options.embeddings)
    ioutils.write_text_log(options.logfile, embeddings)
    print(embeddings)

    embarray = embeddings.data(normalize=bool(options.embeddings.normalize))
    batch_iter = facenet.equal_batches_input_pipeline(
        embarray, options, seed=int(options.seed or 0))
    trainer = ClassifierTrainer(
        options, normalized=bool(options.embeddings.normalize), device=device)

    print('start training')
    model = trainer.train(
        batch_iter,
        nrof_epochs=int(options.train.epoch.max_nrof_epochs or 2),
        epoch_size=int(options.train.epoch.size or 250),
        p=int(options.nrof_classes_per_batch),
        k=int(options.nrof_examples_per_class),
        embeddings_per_class=embarray,
        logfile=options.logfile)

    write_classifier(options.classifier.path / 'classifier.yaml', model)

    conf_mat = ConfusionMatrix(embarray, model)
    print(conf_mat)
    ioutils.write_text_log(options.logfile, conf_mat)

    print(f'Model has been saved to the directory: {options.classifier.path}')
    return model


if __name__ == '__main__':
    main()
