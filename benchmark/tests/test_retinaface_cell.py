"""The RetinaFace cell at a TINY size on the CPU: the program is correct,
each planted fault and the control fail the reading they are planted for,
the readers read what the driver counts (and nothing where it counts
nothing), and the work counters against hand counts."""

import json
import types

import pytest
import torch

from benchmark.core import manifest, retina_work, work
from benchmark.reference import retinaface

from .conftest import run_tiny, tiny_cell

CELL = 'retinaface-irv1.cam1080-b8'


def tiny():
    """The cell cut further: 96 x 128 frames, 300 candidates, 40 kept, 4
    slots, small faces (ResNet-50 and the heads at their widths)."""
    cell = tiny_cell(CELL)
    cell.config['detector'].update(image_shape=[96, 128], top_k=300,
                                   keep_top_k=40)
    cell.traffic.update(num_faces=4, quadrants=4, faces_per_quadrant=[1, 2],
                        faces_per_scene=[4, 8], face_px=[10, 20])
    return cell


def test_the_program_is_correct_and_counts_its_work():
    run, result = run_tiny(tiny(), trace=True)
    assert result['correct'], result['checks']
    r = run.readings
    assert r['selection_mismatch'] == 0 and r['decode_gap'] == 0
    assert 0 < r['head_gap_mean'] < r['head_gap']
    assert run.detail['compared_slots'] > 0
    c = run.counters
    assert c['units'] > 0 and c['scenes'] == 2 * c['units']
    assert c['detect_issue_s'] > 0
    assert c['nms_ops'] > 0 and c['flops_per_batch'] > 0


@pytest.mark.parametrize('fault, reading', [
    ('altered', 'selection_mismatch'), ('altered', 'embed_gap'),
    ('half_batch', 'selection_mismatch'), ('channels', 'head_gap'),
    ('channels', 'head_gap_mean'), ('variance', 'decode_gap'),
    ('control', 'head_gap_mean'), ('control', 'embed_gap_mean')])
def test_a_planted_fault_fails_its_reading(fault, reading):
    run, result = run_tiny(tiny(), variant=fault)
    assert not result['correct']
    assert run.readings[reading] > run.cell.limits[reading], run.readings


def _run(counters, analysis=None, device='cuda'):
    return types.SimpleNamespace(counters=counters, analysis=analysis,
                                 device=device)


def test_the_readers():
    analysis = {'units': 10, 'window_s': 1.0, 'busy_s': 0.9, 'kernels': {
        '(anonymous namespace)::nms_greedy_mask_kernel(float4 const*)':
            [0.002, 10],
        '(anonymous namespace)::nms_greedy_scan_kernel(unsigned long)':
            [0.003, 10],
        'other_kernel': [0.5, 10]}}
    counters = {'nms_ops': 6.7e8, 'nms_bytes': 1e3, 'scenes': 80,
                'units': 10, 'window_s': 2.0, 'flops_per_batch': 9.89e12,
                'detect_issue_s': 0.004}
    run = _run(counters, analysis)
    # 0.01 ms at the FP32 peak over 0.5 ms of the two kernels a batch
    assert manifest.reader('nms_roofline')(run) == pytest.approx(2.0)
    assert manifest.reader('mfu.retina')(run) == pytest.approx(5.0)
    assert manifest.reader('detect_issue_ms.retina')(run) == \
        pytest.approx(4.0)
    # nothing to read: the CPU, another cell's counters, no NMS kernel
    for name in ('nms_roofline', 'mfu.retina'):
        assert manifest.reader(name)(_run(counters, analysis, 'cpu')) is None
        assert manifest.reader(name)(_run({'scenes': 8, 'units': 1,
                                           'window_s': 1.0,
                                           'flops_per_batch': 1.0},
                                          analysis)) is None
    no_nms = dict(analysis, kernels={'other_kernel': [0.5, 10]})
    assert manifest.reader('nms_roofline')(_run(counters, no_nms)) is None
    assert manifest.reader('detect_issue_ms.retina')(_run({})) is None


def test_detector_flops_are_the_published_count():
    cfg = json.load(open(manifest.BENCH / 'configs' / 'retinaface-irv1.json'))
    det = cfg['detector']
    flops = retina_work.detector_flops(det)
    # ResNet-50's 4.09 GMAC at 224 x 224 scaled to 1080 x 1920 is ~169
    # GMAC; FPN, SSH and heads ~55 GMAC more
    assert 2 * 215e9 < flops < 2 * 230e9
    # one frame's first convolution alone: 7 x 7 x 3 -> 64 on 540 x 960
    small = dict(det, image_shape=[32, 32])
    assert retina_work.detector_flops(small) > 2 * 16 * 16 * 64 * 147
    per_batch = retina_work.pipeline_flops(det, cfg['embedding'], 8, 16)
    emb = work.irv1_forward_flops(cfg['embedding']['topology'])
    assert per_batch == 8 * flops + 128 * emb


def test_nms_work_is_the_hand_count():
    ops, nbytes = retina_work.nms_work([3, 0], [2, 0], 5)
    assert ops == 16 * 2 + 7 * 3
    assert nbytes == 17 * 3 + 2 * (5 + 4)


def test_the_reference_counts_the_pair_tests_greedy_nms_makes():
    # 0 is kept, tests 1, 2 and 3 and suppresses 1; 2 tests 3; 3 tests
    # nothing
    boxes = torch.tensor([[0., 0., 9., 9.], [1., 1., 10., 10.],
                          [20., 20., 29., 29.], [50., 50., 59., 59.]])
    keep, tested = retinaface.py_cpu_nms(
        boxes, torch.tensor([0.9, 0.8, 0.7, 0.6]), 0.4)
    assert keep == [0, 2, 3] and tested == 3 + 1 + 0
