"""Port NMS and box utilities (facenet_tpu_torch/ops/nms.py) against the
JAX package's (facenet_tpu/ops/nms.py) on the same seeded boxes: masks
exact, boxes to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facenet_tpu.ops import nms as jnms
from facenet_tpu_torch.ops import nms as tnms
from torch_testing import few_threads  # noqa: F401


def _boxes(rng, b=3, k=40):
    xy = rng.uniform(0, 30, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(10, 40, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    # quantized scores give ties, which both sides must break by index
    scores = np.round(rng.uniform(0, 1, (b, k)), 1).astype(np.float32)
    valid = rng.uniform(size=(b, k)) < 0.8
    return boxes, scores, valid


@pytest.fixture
def box_set():
    return _boxes(np.random.RandomState(0))


@pytest.mark.parametrize('mode', ['union', 'min'])
def test_iou_matrix(box_set, mode):
    boxes = box_set[0]
    want = np.stack([np.asarray(jnms.iou_matrix(jnp.asarray(b), mode))
                     for b in boxes])
    got = tnms.iou_matrix(torch.from_numpy(boxes), mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize('algorithm', ['greedy', 'fast'])
@pytest.mark.parametrize('mode,threshold', [('union', 0.3), ('union', 0.7),
                                            ('min', 0.7)])
def test_nms_masks(box_set, algorithm, mode, threshold):
    boxes, scores, valid = box_set
    want = np.asarray(jnms.batched_nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
        threshold, mode=mode, algorithm=algorithm))
    got = tnms.batched_nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(valid), threshold, mode=mode,
        algorithm=algorithm).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize('k', [8, 40, 50])
def test_top_k_boxes(box_set, k):
    boxes, scores, valid = box_set
    want = jax.vmap(lambda b, s, v: jnms.top_k_boxes(b, s, v, k))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    got = tnms.top_k_boxes(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(valid), k)
    w_boxes, w_scores, w_valid = (np.asarray(a) for a in want)
    g_boxes, g_scores, g_valid = (a.numpy() for a in got)
    np.testing.assert_array_equal(g_valid, w_valid)
    # tied scores keep index order on both sides; invalid slots may differ
    np.testing.assert_allclose(g_boxes[g_valid], w_boxes[w_valid], atol=1e-6)
    np.testing.assert_allclose(g_scores, w_scores, atol=1e-6)


def test_square_and_regression(box_set):
    boxes = box_set[0]
    reg = np.random.RandomState(1).normal(0, 0.2, boxes.shape).astype(
        np.float32)
    np.testing.assert_allclose(
        tnms.square_boxes(torch.from_numpy(boxes)).numpy(),
        np.asarray(jnms.square_boxes(jnp.asarray(boxes))), atol=1e-6)
    np.testing.assert_allclose(
        tnms.apply_bbox_regression(torch.from_numpy(boxes),
                                   torch.from_numpy(reg)).numpy(),
        np.asarray(jnms.apply_bbox_regression(jnp.asarray(boxes),
                                              jnp.asarray(reg))), atol=1e-5)
