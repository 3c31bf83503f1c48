"""Train the embedding network with softmax cross-entropy (+ optional
center and triplet losses).

Database -> shuffled batches (or P x K batches when the triplet loss is on
or ``sampler: pk``) -> the ``model:`` section's network from the model
zoo (Inception-ResNet-v1 or -v2) + logits head -> Adam(eps=0.1)
on the piecewise schedule -> a checkpoint with the pipeline's cursor at
every epoch's end -> validation every ``validate.every_n_epochs`` epochs
and at the last -> the backbone exported as a model bundle in the run
directory. ``model.weights`` warm-starts the backbone from a bundle;
``model.checkpoint`` resumes a run of this app, data cursor included.
Runs on the GPU unless ``--device cpu``; in a process group (the
train_softmax_distributed app) on the ``mesh:`` grid over its ranks, every
rank drawing the same global batches and decoding and training on its own
rows of them, rank 0 writing the logs, reports and the bundle.

    python -m facenet_tpu_torch.apps.train_softmax --config my.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import math
from pathlib import Path

from facenet_tpu_torch import (callbacks, config, dataset, export, ioutils,
                               logging)
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.parallel.mesh import barrier, batch_rows, world
from facenet_tpu_torch.train.checkpoint import CheckpointManager
from facenet_tpu_torch.train.softmax import SoftmaxTrainer


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
    cfg = config.train_softmax({'config': args.config_file},
                               app_file_name=__file__)
    return run(cfg, device)


def run(cfg, device=None):
    """The training flow from a prepared config, on the process group's
    ranks when there is one. The package's log lines go to the run's log
    file, ``<logs.dir>/<logs.file>``, which rank 0 writes."""
    root = world()[1] == 0
    sink = logging.configure_logging(cfg.logs) if root else None
    try:
        return _train(cfg, device, root)
    finally:
        if sink is not None:
            logging.remove_file_sink(sink)


def _train(cfg, device, root):
    report_file = cfg.logs.dir / 'report.txt'

    def log(text):
        if root:
            ioutils.write_text_log(report_file, text)

    # With random_crop the training loader reads larger images
    # (image.load_size, default size + 22) and the step crops them back to
    # image.size; evaluation always loads at image.size.
    loader = dataset.ImageLoader(config=cfg.image)
    if cfg.image.random_crop:
        load_size = int(config.value_or(cfg.image.load_size,
                                        int(cfg.image.size) + 22))
        train_loader = dataset.ImageLoader(size=load_size)
    else:
        train_loader = loader

    train_dbase = dataset.Database(cfg.dataset)
    log(train_dbase)

    use_pk_sampler = (str(cfg.sampler or '') == 'pk' or
                      float(cfg.loss.triplet_factor or 0.0) > 0)

    def train_batches(start_state, rows):
        # semi-hard triplet mining needs same-class pairs in every batch
        if use_pk_sampler:
            return dataset.pipeline_with_equal_batches(
                train_loader, train_dbase.classes, cfg, seed=int(cfg.seed),
                start_state=start_state, rows=rows)
        return train_dbase.batches(train_loader,
                                   batch_size=int(cfg.batch_size),
                                   shuffle=True, repeat=True,
                                   drop_remainder=True, seed=int(cfg.seed),
                                   start_state=start_state, rows=rows)

    test_dbase = dataset.Database(cfg.validate.dataset)

    def test_batches():
        return test_dbase.batches(loader, batch_size=int(cfg.batch_size))

    trainer = SoftmaxTrainer(cfg, nrof_classes=train_dbase.nrof_classes,
                             model_cfg=cfg.model, device=device)

    # P x K batches must split evenly over the data shards: P goes up to
    # the next value that splits, rather than failing at the first step
    if use_pk_sampler:
        n_data = trainer.mesh.data
        p = int(config.value_or(cfg.nrof_classes_per_batch, 20))
        k = int(config.value_or(cfg.nrof_examples_per_class, 5))
        if (p * k) % n_data != 0:
            step = n_data // math.gcd(k, n_data)
            new_p = -(-p // step) * step
            print(f'adjusting nrof_classes_per_batch {p} -> {new_p} so the '
                  f'P*K batch splits over {n_data} data shards')
            cfg.nrof_classes_per_batch = new_p
    state = trainer.init_state(seed=int(cfg.seed))

    ckpt = CheckpointManager(cfg.model.path / 'checkpoints',
                             max_to_keep=cfg.checkpoint.max_to_keep or 3)

    # a checkpoint restore below overrides a warm start when both are given
    if cfg.model.weights:
        bundle = export.load_model(cfg.model.weights)
        state = trainer.warm_start(state, bundle.variables)
        print(f'Warm-started backbone from {cfg.model.weights}')

    data_state = None
    if cfg.model.checkpoint:
        restore_mgr = CheckpointManager(cfg.model.checkpoint)
        restored, data_state = restore_mgr.restore(state,
                                                   with_data_state=True)
        if restored is not None:
            state = restored
            print(f'Restored checkpoint step {int(state.step)} '
                  f'from {cfg.model.checkpoint}' +
                  (f' (data cursor {data_state})' if data_state else ''))
        restore_mgr.close()

    validate_cb = callbacks.ValidateCallback(
        forward_factory=trainer.embedding_forward,
        batches_factory=test_batches,
        every_n_epochs=cfg.validate.every_n_epochs,
        max_nrof_epochs=cfg.train.epoch.max_nrof_epochs,
        config=cfg.validate,
        report_file=report_file,
        h5file=cfg.logs.dir / 'report.h5',
        device=trainer.device, mesh=trainer.mesh)

    # the pipeline's cursor rides along in every checkpoint, so a killed
    # run resumes mid-epoch on the exact next batch; on a grid every rank
    # draws the same global batches and decodes only its own rows of them
    max_epochs = int(cfg.train.epoch.max_nrof_epochs)
    pipeline = train_batches(start_state=data_state,
                             rows=functools.partial(batch_rows, trainer.mesh))
    batches_iter = iter(pipeline)

    # 0 is a valid freeze epoch, so no `or`-defaulting
    freeze_bn_epoch = config.value_or(cfg.train.freeze_bn_epoch, None)

    for epoch in range(max_epochs):
        frozen = (freeze_bn_epoch is not None
                  and epoch >= int(freeze_bn_epoch))
        state, metrics = trainer.train_epoch(state, batches_iter, epoch,
                                             frozen_bn=frozen)
        print(f'epoch [{epoch + 1}/{max_epochs}] ' +
              ' '.join(f'{k}={v:.4f}' for k, v in metrics.items()))
        log(f'epoch [{epoch + 1}/{max_epochs}] {metrics}')

        ckpt.save(int(state.step), state, data_state=pipeline.state())
        validate_cb.on_epoch_end(epoch, state)

    export.save_model(cfg.model.path, state.model.backbone)
    barrier()
    ckpt.close()

    print(f'Model and logs have been saved to the directory: {cfg.model.path}')
    return state


if __name__ == '__main__':
    main()
