"""Port preprocessing == facenet_tpu.ops.preprocessing.image_processing on the
same seeded uint8 batches, with and without resize (float32, atol 1e-5)."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from facenet_tpu.ops.preprocessing import image_processing as jax_processing
from facenet_tpu_torch.ops.preprocessing import image_processing


@pytest.mark.parametrize('side', [160, 182, 96])
@pytest.mark.parametrize('normalization', [0, 1])
def test_image_processing_matches_jax(side, normalization):
    images = np.random.RandomState(side + normalization).randint(
        0, 256, (3, side, side, 3)).astype(np.uint8)
    ref = np.asarray(jax_processing(images, 160, normalization))
    got = image_processing(torch.from_numpy(images), 160, normalization)
    assert got.dtype == torch.float32 and got.shape == (3, 160, 160, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_invalid_normalization_raises():
    with pytest.raises(ValueError, match='normalization'):
        image_processing(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), 8, 2)
