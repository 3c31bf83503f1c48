"""Port image sampling (facenet_tpu_torch/ops/image_ops.py) and the dense
warp B2 (ops/warp.py) against the JAX package on the same seeded inputs.

B2's plain version is held to JAX `dense_warp` at 1e-3 and to the Pallas
kernel in interpret mode at 2.0 (that kernel's bf16 bound, the cases of
tests/test_pallas_warp.py); the CUDA kernel itself is held to its plain
version in tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facenet_tpu.ops import image_ops as jops
from facenet_tpu.ops.pallas_warp import dense_warp_pallas
from facenet_tpu_torch.ops import image_ops as tops
from facenet_tpu_torch.ops import warp


def _rot(th, tx, ty, s=1.0):
    return np.array([[s * np.cos(th), -s * np.sin(th), tx],
                     [s * np.sin(th), s * np.cos(th), ty]], np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_crop_and_resize_matches_jax():
    rng = np.random.RandomState(0)
    imgs = rng.uniform(0, 255, (2, 40, 56, 3)).astype(np.float32)
    xy = rng.uniform(-10, 40, (2, 5, 2))
    wh = rng.uniform(5, 30, (2, 5, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    for size in (24, 48):
        want = np.asarray(jops.crop_and_resize(jnp.asarray(imgs),
                                               jnp.asarray(boxes), size))
        got = tops.crop_and_resize(_t(imgs), _t(boxes), size).numpy()
        assert got.shape == want.shape == (2, 5, size, size, 3)
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_similarity_transform_matches_jax():
    rng = np.random.RandomState(1)
    dst = jops.canonical_landmarks(160)
    for _ in range(20):
        src = (dst @ _rot(rng.uniform(-1, 1), 0, 0, rng.uniform(0.5, 2))[:, :2].T
               + rng.uniform(-50, 50, 2)
               + rng.normal(0, 3, dst.shape)).astype(np.float32)
        if rng.uniform() < 0.3:
            src[:, 0] = -src[:, 0]           # a reflected point set
        want = np.asarray(jops.similarity_transform_from_points(
            jnp.asarray(src), jnp.asarray(dst)))
        got = tops.similarity_transform_from_points(_t(src), _t(dst)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 160)
        np.testing.assert_allclose(
            tops.invert_affine(_t(got)).numpy(),
            np.asarray(jops.invert_affine(jnp.asarray(got))), atol=1e-4)


def test_dense_warp_plain_matches_jax():
    rng = np.random.RandomState(2)
    imgs = rng.uniform(0, 255, (3, 30, 26, 3)).astype(np.float32)
    mats = np.stack([_rot(0.4, 5.0, -3.0), _rot(-0.3, -8.0, 9.0, 1.3),
                     _rot(0.0, 0.0, 0.0)])
    want = np.asarray(jops.dense_warp(jnp.asarray(imgs), jnp.asarray(mats),
                                      (20, 28)))
    got = warp.dense_warp_plain(_t(imgs), _t(mats), (20, 28)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    # the wrapper runs the plain version on CPU tensors
    np.testing.assert_array_equal(
        warp.dense_warp(_t(imgs), _t(mats), (20, 28)).numpy(), got)
    gather = np.asarray(jops.affine_warp(jnp.asarray(imgs),
                                         jnp.asarray(mats), (20, 28)))
    np.testing.assert_allclose(got, gather, atol=1e-3)


def _pallas_cases():
    """The inputs of tests/test_pallas_warp.py (matches, identity, edge
    clamp)."""
    rng = np.random.RandomState(0)
    imgs = rng.uniform(0, 255, (3, 48, 48, 3)).astype(np.float32)
    mats = np.stack([_rot(0.3, 4.0, -2.0), _rot(-0.2, -3.0, 6.0),
                     _rot(0.0, 0.0, 0.0)])
    yield imgs, mats, (16, 24)
    rng = np.random.RandomState(1)
    imgs = rng.uniform(0, 255, (1, 32, 32, 3)).astype(np.float32)
    yield imgs, np.eye(2, 3, dtype=np.float32)[None], (32, 32)
    imgs = np.tile(np.arange(16, dtype=np.float32)[None, :, None, None]
                   * 10.0, (1, 1, 16, 3)).transpose(0, 2, 1, 3)
    yield imgs, np.array([[[1.0, 0.0, -8.0], [0.0, 1.0, 0.0]]],
                         np.float32), (16, 16)


@pytest.mark.parametrize('case', range(3))
def test_dense_warp_plain_matches_pallas_interpret(case):
    imgs, mats, size = list(_pallas_cases())[case]
    want = np.asarray(dense_warp_pallas(jnp.asarray(imgs), jnp.asarray(mats),
                                        size, interpret=True))
    got = warp.dense_warp(_t(imgs), _t(mats), size).numpy()
    assert np.abs(got - want).max() < 2.0


def _smooth_images(rng, b, h, w):
    """Low-frequency 0-255 content, so that float32 rounding in the warp
    geometry (~1e-4 px) moves pixels by far less than the bound."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((b, h, w, 3), np.float32)
    for i in range(b):
        for c in range(3):
            fy, fx, ph = rng.uniform(0.02, 0.12, 3)
            out[i, :, :, c] = 127.5 + 120 * np.sin(fy * yy + fx * xx + 6 * ph)
    return out


def test_align_by_landmarks_dense_matches_jax():
    rng = np.random.RandomState(3)
    imgs = _smooth_images(rng, 2, 120, 100)
    base = jops.canonical_landmarks(160) * 0.4 + np.array([30.0, 25.0])
    lmk = np.stack([base @ _rot(th, 0, 0)[:, :2].T + rng.normal(0, 1, (5, 2))
                    for th in (0.25, -0.15)]).astype(np.float32)
    want = np.asarray(jops.align_by_landmarks(jnp.asarray(imgs),
                                              jnp.asarray(lmk), 160,
                                              method='dense'))
    got = tops.align_by_landmarks(_t(imgs), _t(lmk), 160,
                                  method='dense').numpy()
    assert got.shape == (2, 160, 160, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)
    # K faces per image go through one warp and land in [B, K, S, S, C]
    both = tops.align_by_landmarks(_t(imgs), _t(np.stack([lmk, lmk], 1)),
                                   160, method='dense').numpy()
    np.testing.assert_allclose(both[:, 1], got, atol=1e-4)
    gather = tops.align_by_landmarks(_t(imgs), _t(lmk), 160).numpy()
    want_gather = np.asarray(jops.align_by_landmarks(
        jnp.asarray(imgs), jnp.asarray(lmk), 160, method='gather'))
    np.testing.assert_allclose(gather, want_gather, atol=1e-3)


def test_warp_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match='device'):
        warp.dense_warp(torch.zeros(1, 8, 8, 3, device='meta'),
                        torch.zeros(1, 2, 3), (4, 4))

