"""Seeds derived from a run's ``--seed``: one stream for each purpose, so
the same seed gives the same inputs and weights whatever else a cell
draws. A seed is any whole number >= 0."""

from __future__ import annotations

import numpy as np


def derive(seed, *purpose):
    """A 63-bit seed for `purpose` (strings and numbers) under `seed`."""
    words = [int(seed)] + [int.from_bytes(str(p).encode(), 'little')
                           for p in purpose]
    state = np.random.SeedSequence(words).generate_state(2, np.uint64)
    return int(state[0] >> np.uint64(1))


def host_rng(seed, *purpose):
    """numpy's RandomState for `purpose` (the traffic renderer's API)."""
    return np.random.RandomState(derive(seed, *purpose) % (2 ** 32))


def device_generator(seed, device, *purpose):
    """A torch.Generator on `device` for `purpose`."""
    import torch
    return torch.Generator(device=device).manual_seed(derive(seed, *purpose))
