"""Training callbacks: every-N-epochs validation and per-epoch
checkpoints, as plain ``on_epoch_end(epoch, state)`` callables.

Validation embeds the test set with the trainer's forward
(`facenet.evaluate_embeddings`) and runs the K-fold
`statistics.FaceToFaceValidation`, whose pair counts are the CUDA kernel
``pair_below_counts`` on the card. On a grid with more than one data rank
the extraction splits over the data ranks; every rank holds the whole test
set and its embeddings, so each counts the pairs itself with the kernel,
and rank 0 alone writes the reports.
"""

from __future__ import annotations

from facenet_tpu_torch import facenet, statistics
from facenet_tpu_torch.logging import logger


class ValidateCallback:
    """Validation at every `every_n_epochs`-th epoch and at the last.

    :param forward_factory: state -> (images -> embeddings)
    :param batches_factory: () -> iterable of (images, labels) over the
        test set
    :param config: a section whose ``validate`` holds metric, nrof_folds
        and far_target
    :param device: where the validation statistics run (default 'cuda')
    :param mesh: the trainer's grid, or None on one device
    """

    def __init__(self, forward_factory, batches_factory, every_n_epochs,
                 max_nrof_epochs, config, report_file=None, h5file=None,
                 device=None, mesh=None):
        self.forward_factory = forward_factory
        self.batches_factory = batches_factory
        self.every_n_epochs = int(every_n_epochs or 10)
        self.max_nrof_epochs = int(max_nrof_epochs or 0)
        self.config = config
        self.report_file = report_file
        self.h5file = h5file
        self.device = device
        self.mesh = mesh if mesh is not None and mesh.data > 1 else None
        self.writes = mesh is None or mesh.rank == 0
        self.last_validation = None

    def on_epoch_end(self, epoch, state):
        epoch1 = epoch + 1
        if epoch1 % self.every_n_epochs != 0 and epoch1 != self.max_nrof_epochs:
            return None

        logger.info(f'perform validation for epoch {epoch1}')

        forward = self.forward_factory(state)
        embeddings, labels = facenet.evaluate_embeddings(
            forward, self.batches_factory(), mesh=self.mesh)

        validation = statistics.FaceToFaceValidation(
            embeddings, labels, self.config.validate, device=self.device)

        if self.writes and self.report_file:
            validation.write_report(self.report_file)
        if self.writes and self.h5file:
            validation.write_h5file(self.h5file, tag=f'epoch_{epoch1}')

        self.last_validation = validation
        return validation


class CheckpointCallback:
    """A checkpoint at every epoch's end."""

    def __init__(self, manager):
        self.manager = manager

    def on_epoch_end(self, epoch, state):
        self.manager.save(int(state.step), state)
