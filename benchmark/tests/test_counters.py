"""The operation and byte counters against counts made by hand."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.core import manifest, work
from benchmark.reference import irv1


def test_pnet_work_at_one_level_is_the_hand_count():
    # level 0 of the 480x640 pyramid, one image: conv1 3x3x3 -> 10 on
    # 286 x 382, a SAME 2x2 pool to 143 x 191, conv2 3x3x10 -> 16 on
    # 141 x 189, conv3 3x3x16 -> 32 and the 32 -> 6 heads on 139 x 187
    macs = (286 * 382 * 10 * 27 + 141 * 189 * 16 * 90
            + 139 * 187 * (32 * 144 + 6 * 32))
    nbytes = 3 * 288 * 384 * 2 + 139 * 187 * 5 * 4 + 6640 * 4
    assert work.pnet_work([(1, 288, 384)]) == (2 * macs, nbytes)


def test_pnet_work_over_the_pyramid_at_16_is_chip_smokes():
    # chip_smoke.py's phase 12 prints 1.2101e10 operations and 3.7646e7
    # bytes for B3 on 16 480x640 scenes
    levels = work.pyramid_levels(16, 480, 640, 20, 0.709)
    flops, nbytes = work.pnet_work(levels)
    assert len(levels) == 10
    assert flops == pytest.approx(1.2101e10, rel=1e-4)
    assert nbytes == pytest.approx(3.7646e7, rel=1e-4)


def test_one_block35_is_the_hand_count():
    # Block35 on a 17 x 17 x 256 grid: three 1x1 256 -> 32 heads, three
    # 3x3 32 -> 32 convs, the 1x1 96 -> 256 up-projection
    macs = 17 * 17 * (3 * 256 * 32 + 3 * 9 * 32 * 32 + 96 * 256)
    net = irv1.Net(irv1.Recorder('meta'), {})
    x = torch.empty((1, 256, 17, 17), device='meta')
    with FlopCounterMode(display=False) as counter:
        net.block35(x, 'b', {'scale': 0.17, 'activation': 'relu'})
    assert counter.get_total_flops() == 2 * macs


def test_irv1_totals():
    cfg = json.load(open(manifest.BENCH / 'configs' / 'irv1.json'))
    fwd = work.irv1_forward_flops(cfg['topology'])
    train = work.irv1_train_flops(cfg['topology'], 8631)
    assert fwd == 2_803_719_872
    # forward, then the input and the weight gradients (the stem's input
    # gradient is not taken), the 8,631-way head on top
    head = 2 * 512 * 8631
    assert 2.9 * fwd < train - 3 * head < 3 * fwd


def test_b2_bytes_at_32_crops_is_the_hand_count():
    # 32 axis-aligned warps of a 240 x 240 intermediate to 160 x 160 at
    # 1.5 px a pixel: even outputs hit a source pixel, odd ones fall half
    # way, so every source pixel of the 240 x 240 is read
    mats = torch.zeros(32, 2, 3)
    mats[:, 0, 0] = mats[:, 1, 1] = 1.5
    touched = 240 * 240
    want = (32 * touched * 3 + 32 * 6 + 32 * 160 * 160 * 3) * 4
    assert work.b2_bytes(mats, 160, 240) == want


def test_b2_reads_no_more_than_its_source():
    rng = np.random.default_rng(3)
    th = rng.uniform(-0.5, 0.5, 32)
    mats = torch.zeros(32, 2, 3)
    mats[:, 0, 0] = mats[:, 1, 1] = torch.from_numpy(np.cos(th)).float()
    mats[:, 0, 1] = torch.from_numpy(-np.sin(th)).float()
    mats[:, 1, 0] = torch.from_numpy(np.sin(th)).float()
    mats[:, :, 2] = 40.0
    assert 0 < work.warp_touched_pixels(mats, (160, 160), 240, 240) \
        <= 32 * 240 * 240
