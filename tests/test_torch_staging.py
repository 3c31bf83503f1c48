"""`utils.staging.HostStager`, the embedders' way to the device: a host
batch for a CUDA device goes through a ring of pinned slots and a copy
stream; a CPU target takes ``torch.as_tensor``; a tensor already on the
device passes through.

This file imports neither JAX nor the JAX package, so it runs on the GPU
machine too:

    python -m pytest --noconftest tests/test_torch_staging.py -m cuda

The `cuda`-marked cases hold `FastEmbedder` on staged batches to the same
forward on a synchronous ``torch.from_numpy(x).cuda()`` copy, bit for bit,
and skip without a GPU; the others run on the CPU.
"""

import numpy as np
import pytest
import torch

from facenet_tpu_torch.models.inception_resnet_v1 import init_variables
from facenet_tpu_torch.models.irv1_fast import FastEmbedder
from facenet_tpu_torch.utils.staging import SLOTS, HostStager
from span_recording import spans  # noqa: F401

TINY = {'block35': {'repeat': 1}, 'block17': {'repeat': 1},
        'block8_1': {'repeat': 1}, 'output': {'size': 32}}
SPIN = 100_000_000      # torch.cuda._sleep cycles: tens of ms on an H100


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: pinned memory and a copy stream '
                    'have no CPU mode')


@pytest.fixture(scope='module')
def tiny_variables():
    return init_variables(TINY, seed=0)


def _batch(seed, n=64):
    return np.random.RandomState(seed).randint(
        0, 256, (n, 160, 160, 3)).astype(np.uint8)


@pytest.mark.parametrize('kind', ['array', 'tensor', 'strided'])
def test_cpu_target_takes_as_tensor(kind):
    x = np.random.RandomState(0).randint(0, 256, (3, 6, 5, 3)).astype(
        np.uint8)
    images = {'array': x, 'tensor': torch.from_numpy(x),
              'strided': x[:, ::2]}[kind]
    stager = HostStager('cpu')
    out = stager(images)
    np.testing.assert_array_equal(out.numpy(), np.asarray(images))
    assert np.shares_memory(out.numpy(), x)       # a view: no copy made
    assert stager.stream is None and not out.is_pinned()
    assert all(buffer is None for buffer in stager._buffers)


@pytest.mark.parametrize('owner', ['stager', 'embedder'])
def test_tensor_on_the_device_passes_through(owner, tiny_variables):
    x = torch.from_numpy(_batch(1, 2))
    if owner == 'stager':
        stager = HostStager('cpu')
    else:
        stager = FastEmbedder(tiny_variables, config=TINY,
                              device='cpu').stager
    assert stager(x) is x


@pytest.fixture(scope='module')
def card_embedder(tiny_variables):
    if not torch.cuda.is_available():
        return None
    return FastEmbedder(tiny_variables, config=TINY, device='cuda')


def _sync_forward(embedder, x):
    out = embedder(torch.from_numpy(x).cuda()).cpu()
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['back_to_back', 'overwritten', 'growing',
                                  'slow_reader', 'shallow'])
def test_staged_forward_equals_synchronous(case, card_embedder, spans):
    """back_to_back: 2 x SLOTS + 1 distinct batches with no synchronize;
    overwritten: the caller's array filled with noise right after each
    call returns; growing: batches of 1, 16, 1,024 and 7, so a slot grows
    and is then viewed smaller; slow_reader: the compute stream held by a
    spin before each call, so a device tensor still to be read by one
    forward is live while the next batch's copy runs; shallow: the copy
    stream held by a spin, so more batches are in flight than the ring
    has slots and the host waits for a slot."""
    _gpu()
    embedder = card_embedder
    sizes = {'growing': [1, 16, 1024, 7]}.get(case, [64] * (2 * SLOTS + 1))
    batches = [_batch(10 + i, n) for i, n in enumerate(sizes)]
    want = [_sync_forward(embedder, x) for x in batches]
    spans.span_summary(reset=True)
    if case == 'shallow':
        with torch.cuda.stream(embedder.stager.stream):
            torch.cuda._sleep(SPIN)
    got = []
    for x in batches:
        caller = x.copy()
        if case == 'slow_reader':
            torch.cuda._sleep(SPIN)
        got.append(embedder(caller))
        if case == 'overwritten':
            caller[...] = np.random.RandomState(99).randint(
                0, 256, caller.shape)
        assert not torch.from_numpy(caller).is_pinned()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    counts = {name: s['count'] for name, s in spans.span_summary().items()}
    assert counts['facenet.h2d.stage'] == len(batches)
    if case == 'shallow':
        assert counts.get('facenet.h2d.slot_wait', 0) > 0


@pytest.mark.cuda
def test_device_batch_passes_through_on_the_card(card_embedder, spans):
    """A batch already on the card: no copy, allocation or stage span."""
    _gpu()
    x = torch.from_numpy(_batch(3, 16)).cuda()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    assert card_embedder.stager(x) is x
    assert torch.cuda.memory_allocated() == allocated
    assert 'facenet.h2d.stage' not in spans.span_summary()
