"""Image traffic: face crops made from the seed.

A few faces are rendered on the host (`synthetic.render_face_patch`, one
identity each); every image of a batch is one of them under its own
brightness gain, offset, mirror and sensor noise, drawn on the device in
a few large calls and handed back as host uint8 arrays, as a loader
hands batches to the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.core.seeds import device_generator, host_rng
from benchmark.core.synthetic import render_face_patch


def face_batches(seed, device, n_batches, batch, faces=64, size=160,
                 purpose='faces'):
    """uint8 [n_batches, batch, size, size, 3] host array, every batch
    distinct."""
    rng = host_rng(seed, purpose)
    base = np.stack([render_face_patch(size, rng.randint(10 ** 6), rng)
                     for _ in range(faces)])
    base = torch.from_numpy(base).to(device).float()
    gen = device_generator(seed, device, purpose)
    out = np.empty((n_batches, batch, size, size, 3), np.uint8)
    for b in range(n_batches):
        pick = torch.randint(faces, (batch,), generator=gen, device=device)
        gain = 0.75 + 0.5 * torch.rand(batch, 1, 1, 1, generator=gen,
                                       device=device)
        offset = 40 * torch.rand(batch, 1, 1, 1, generator=gen,
                                 device=device) - 20
        mirror = torch.rand(batch, generator=gen, device=device) < 0.5
        noise = 6 * torch.randn(batch, size, size, 3, generator=gen,
                                device=device)
        x = base[pick]
        x = torch.where(mirror[:, None, None, None], x.flip(2), x)
        x = (x * gain + offset + noise).round().clamp(0, 255)
        out[b] = x.to(torch.uint8).cpu().numpy()
    return out


def labels(seed, device, n_batches, batch, classes, purpose='labels'):
    """int64 [n_batches, batch] host array of class ids in [0, classes)."""
    gen = device_generator(seed, device, purpose)
    return torch.randint(classes, (n_batches, batch), generator=gen,
                         device=device).cpu().numpy()
