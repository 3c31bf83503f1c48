"""Checkpoints of the train state, written with torch.save.

A checkpoint holds all of a `TrainState`: the model's parameters and
BatchNorm statistics, Adam's moments and counts, the centers table, the
step, the augmentation generator's state, and optionally the input
pipeline's cursor, so that a resumed run continues on the exact next
batch. Each lives in ``<directory>/<step>/state.pt``, written to a
temporary name and renamed, and at most ``max_to_keep`` stay.

On a process grid every rank calls `save` and `restore`: the head and its
Adam moments are gathered whole (`train.softmax.full_state_dict`), rank 0
writes, and every rank reads and keeps its own columns, with a barrier
after the write and before the read. A checkpoint written on any grid
restores on any other and on a single process.

The format is the port's own: the JAX package's Orbax checkpoint
directories are not read here, nor these by it (a model bundle,
`export.save_model`, is what the two packages share).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import torch

from facenet_tpu_torch.parallel.mesh import barrier, world
from facenet_tpu_torch.train.softmax import (full_state_dict,
                                             load_full_state_dict)

STATE_FILE = 'state.pt'


class CheckpointManager:
    """Numbered checkpoints in a directory, newest kept."""

    def __init__(self, directory, max_to_keep=3):
        self.directory = Path(str(directory)).expanduser().resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep or 3)

    def steps(self):
        """The saved steps, oldest first."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).is_file())

    def save(self, step, state, data_state=None):
        """Save `state` as step `step`, with the pipeline cursor
        `data_state` (a dict of ints: ``BatchLoader`` / ``PKPipeline``
        ``.state()``) beside it; drop the oldest past `max_to_keep`."""
        savable = full_state_dict(state)
        if data_state is not None:
            savable['data_state'] = {k: int(v) for k, v in data_state.items()}
        if world()[1] == 0:
            target = self.directory / str(int(step))
            target.mkdir(exist_ok=True)
            tmp = target / (STATE_FILE + '.tmp')
            torch.save(savable, tmp)
            os.replace(tmp, target / STATE_FILE)
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old))
        barrier()

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state, step=None, with_data_state=False):
        """Load a checkpoint (the latest by default) into `state`, a
        `TrainState` of the same model and optimizer layout, in place.

        :return: the state, or None without a checkpoint; with
            `with_data_state`, (state, cursor dict or None)
        """
        barrier()
        if step is None:
            step = self.latest_step()
        if step is None:
            return (None, None) if with_data_state else None
        device = next(state.model.parameters()).device
        saved = torch.load(self.directory / str(int(step)) / STATE_FILE,
                           map_location=device, weights_only=True)
        load_full_state_dict(state, saved)
        data_state = saved.get('data_state')
        return (state, data_state) if with_data_state else state

    def close(self):
        """Nothing is written in the background; kept for the JAX
        package's interface."""
