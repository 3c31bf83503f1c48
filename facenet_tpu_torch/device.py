"""Device selection for the port's entry points.

Every entry point runs on the GPU unless the caller passes ``device='cpu'``.
Without a GPU and without that request it raises: a run that asked for the
card never continues on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means ``cuda``.

    :raises RuntimeError: a CUDA device was asked for and none is present
    """
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run on the CPU')
    return device
