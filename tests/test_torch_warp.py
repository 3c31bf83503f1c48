"""The B2 kernel's (csrc/dense_warp.cu) tiling and its stores, restated in
numpy from the source's constants.

The kernel runs only on the card (tests/test_torch_cuda_kernels.py holds
it to its plain version there); these restatements check on the CPU the
index arithmetic it relies on: every output pixel is sampled by exactly
one (block, thread), and for three channels the block's rows leave shared
memory so that every output float is written once, the 16-byte pieces on
16-byte boundaries.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from facenet_tpu_torch.ops import warp


def _constant(name):
    text = Path(warp.KERNEL.source).read_text()
    return int(re.search(rf'constexpr int {name} = (\d+);', text).group(1))


TILE_W, TILE_H = _constant('TILE_W'), _constant('TILE_H')
THREADS = TILE_W * TILE_H
ROW_PIECES = TILE_W * 3 // 4

SHAPES = [(1, 160, 160), (3, 96, 200), (2, 13, 37), (5, 1, 70),
          (2, 240, 240), (1, 8, 4)]


def _blocks(n, oh, ow):
    """(crop, x0, y0) of each block, in launch order."""
    tiles_x = -(-ow // TILE_W)
    per_crop = tiles_x * -(-oh // TILE_H)
    for block in range(n * per_crop):
        crop, rem = divmod(block, per_crop)
        ty, tx = divmod(rem, tiles_x)
        yield crop, tx * TILE_W, ty * TILE_H


@pytest.mark.parametrize('n,oh,ow', SHAPES)
def test_every_output_pixel_is_sampled_once(n, oh, ow):
    count = np.zeros((n, oh, ow), int)
    for crop, x0, y0 in _blocks(n, oh, ow):
        for t in range(THREADS):
            x, y = x0 + t % TILE_W, y0 + t // TILE_W
            if x < ow and y < oh:
                count[crop, y, x] += 1
    assert (count == 1).all()


@pytest.mark.parametrize('n,oh,ow', SHAPES)
def test_three_channel_rows_are_written_once_in_aligned_pieces(n, oh, ow):
    """The store loop of the three-channel kernel: float4 pieces of whole
    rows that start on 16 bytes, single floats elsewhere; each output
    float once, each from the tile's slot of its pixel."""
    written = np.zeros(n * oh * ow * 3, int)
    for crop, x0, y0 in _blocks(n, oh, ow):
        pixels = min(TILE_W, ow - x0)
        for t in range(THREADS):
            for i in range(t, TILE_H * ROW_PIECES, THREADS):
                r, q = divmod(i, ROW_PIECES)
                if y0 + r >= oh:
                    break
                first = ((crop * oh + y0 + r) * ow + x0) * 3
                if pixels == TILE_W and first % 4 == 0:
                    assert (first + 4 * q) % 4 == 0
                    span = range(4 * q, 4 * q + 4)
                else:
                    span = range(4 * q, min(4 * q + 4, pixels * 3))
                for k in span:
                    # the tile slot r * TILE_W * 3 + k holds pixel
                    # (x0 + k // 3, y0 + r), channel k % 3
                    assert k // 3 < pixels
                    written[first + k] += 1
    assert (written == 1).all()
