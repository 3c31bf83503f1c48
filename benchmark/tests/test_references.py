"""The plain references against the program at a TINY size on the CPU.

The references import nothing of the program; here the program's own
float32 paths, where it has them, are held to them tightly, and its
served bf16 paths within bf16's reach."""

import numpy as np
import torch

from benchmark.core import images, weights
from benchmark.drivers import train
from benchmark.drivers.embed import irv1_tree
from benchmark.reference import irv1

from .conftest import run_tiny, tiny_cell


def test_irv1_embeddings_match_the_programs_float32_module():
    from facenet_tpu_torch.models.inception_resnet_v1 import \
        InceptionResnetV1

    cfg = tiny_cell('irv1.embed-b1024').config
    leaves = irv1_tree(cfg, 5, 'cpu')
    batch = images.face_batches(5, 'cpu', 1, 6, faces=3)[0]
    ref = irv1.Net(irv1.Tree(leaves), cfg['topology']).embeddings(
        torch.from_numpy(batch))
    model = InceptionResnetV1(cfg['topology']).from_flax_variables(
        weights.nested_numpy(leaves))
    with torch.no_grad():
        got = model(torch.from_numpy(batch))
    assert float((got - ref).abs().max()) < 1e-5


def test_embed_cell_on_the_cpu_reads_bf16_gaps():
    run, result = run_tiny('irv1.embed-b1024')
    assert result['correct'], result['checks']
    assert run.readings['rows_out_of_order'] == 0
    assert 0 < run.readings['embed_gap'] < 0.01


def test_train_reference_matches_the_programs_float32_step():
    cell = tiny_cell('irv1.train-b800')
    cell.config['dtype'] = 'float32'
    run, _ = run_tiny(cell)
    program, reference = run.detail['losses']
    # the first loss reads the same weights: equal to float32 rounding
    assert abs(program[0] - reference[0]) < 1e-5 * abs(reference[0])
    assert run.readings['grad_gap'] < 1e-3
    assert run.readings['grad_gap_median'] < 1e-4


def test_reference_at_bf16_reads_like_the_program(monkeypatch):
    # the reference at the configuration's bf16, in the program's place
    monkeypatch.setitem(train.STAND_INS, 'bf16_reference', irv1.BF16)
    program, _ = run_tiny('irv1.train-b800')
    witness, _ = run_tiny('irv1.train-b800', variant='bf16_reference')
    for key in ('grad_gap_median', 'step_gap_median'):
        assert witness.readings[key] < 10 * program.readings[key] + 1e-3


def test_cascade_reference_finds_the_programs_faces():
    # the program's nets run in bf16: a candidate within its rounding of a
    # threshold may go either way, at most a few of the faces
    for cell in ('mtcnn-irv1.crowd-b8', 'mtcnn-irv1.single-b64'):
        run, result = run_tiny(cell)
        r = run.readings
        assert run.detail['detections'] > 0
        assert r['detections_unmatched'] <= 0.1, (cell, r)
        assert r['box_gap'] < 0.05 and r['landmark_gap'] < 0.05, r
        assert r['score_gap'] < 0.05 and r['embed_gap'] < 0.02, r


def test_alignment_geometry_is_a_similarity():
    from benchmark.reference import mtcnn
    template = torch.from_numpy(mtcnn.TEMPLATE_112 * (160 / 112))
    th = 0.3
    rot = torch.tensor([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                       dtype=torch.float64)
    src = template.double() @ rot.T * 0.5 + torch.tensor([100.0, 50.0],
                                                         dtype=torch.float64)
    m = mtcnn.similarity(src[None], template)[0]
    back = src @ m[:, :2].T + m[:, 2]
    assert float((back - template).abs().max()) < 1e-9
