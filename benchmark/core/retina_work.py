"""Operations and bytes of the RetinaFace cell's work, from shapes alone:
the same whatever implements the work.

The detector's convolutions and head products (2 operations a
multiply-add) are counted by torch's FlopCounterMode over the plain
reference (`reference.retinaface`) run on the 'meta' device, which
allocates and computes nothing; BatchNorm, activations, upsampling,
pooling, the decode and the selection are counted at none, as
`work.pipeline_flops` counts resampling. The NMS kernel's work is counted
apart (`nms_work`): the work exact greedy NMS needs on the candidates
that entered it, not the work of the kernel's algorithm, which tests every
pair of candidates.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.core import work
from benchmark.reference import retinaface

# float32 operations of one pair test of the greedy NMS: four max / min,
# two differences, two +1 offsets, two clamps, the intersection's product,
# the union's sum and difference, the denominator's clamp, the division
# and the comparison
PAIR_OPS = 16
# and of one candidate's area: two differences, two offsets, two clamps,
# one product
AREA_OPS = 7


@functools.lru_cache(maxsize=None)
def _detector_flops(cfg_json, height, width):
    cfg = json.loads(cfg_json)
    leaves = {k: torch.empty(shape, device='meta')
              for k, (shape, _) in retinaface.spec(cfg).items()}
    frames = torch.empty((1, height, width, 3), dtype=torch.uint8,
                         device='meta')
    with FlopCounterMode(display=False) as counter:
        retinaface.Net(retinaface.Tree(leaves), cfg).forward(frames)
    return counter.get_total_flops()


def detector_flops(detector):
    """Operations of one frame's RetinaFace forward at the configuration's
    ``image_shape``: the ResNet-50 body, FPN, SSH and heads."""
    h, w = detector['image_shape']
    return _detector_flops(json.dumps(detector, sort_keys=True), int(h),
                           int(w))


def pipeline_flops(detector, embedding, batch, num_faces):
    """Operations of one batch of the RetinaFace pipeline: the detector over
    `batch` frames and the IRv1 forward over batch x num_faces crops."""
    return batch * (detector_flops(detector) + num_faces
                    * work.irv1_forward_flops(embedding['topology'],
                                              embedding['image_size']))


def nms_work(candidates, tested, capacity):
    """(operations, bytes) of exact greedy NMS over frames that entered it
    with `candidates` [F] valid candidates each, at `capacity` candidates
    a frame: the `tested` [F] pair tests greedy NMS makes (each kept
    candidate against every later one that no kept candidate before it
    suppressed, as ``py_cpu_nms`` counts them) and each candidate's area
    once; their boxes (16 bytes) and validity read once, the keep mask
    (`capacity` bytes) and the kept count (4 bytes) written once."""
    n = np.asarray(candidates, np.int64)
    ops = int(PAIR_OPS * np.asarray(tested, np.int64).sum()
              + AREA_OPS * n.sum())
    nbytes = int(17 * n.sum() + n.size * (int(capacity) + 4))
    return ops, nbytes
