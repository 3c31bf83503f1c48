"""End-to-end serving A/B of the stem backends.

Counterpart of the JAX package's ``tools/time_stem_serving.py``: the whole
fused IRv1 forward (`FastEmbedder`) over K chunks of 128 images on the
device, once with ``stem='cudnn'`` and once with ``stem='fused'``, in turns
(cudnn, fused, fused, cudnn) so that both see the same card state. bf16
only: the int8 rows of the original wait for the port's int8 path.

On the CPU (``--device cpu``) nothing is timed: the two stems' embeddings of
2 images are compared (min cosine above 0.999).

    python -m facenet_tpu_torch.tools.time_stem_serving [K] [iters] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.models.inception_resnet_v1 import init_variables
from facenet_tpu_torch.models.irv1_fast import STEMS, FastEmbedder

CHUNK = 128


def measure(embedder, chunks, iters):
    """Images per second over `iters` passes through the chunks, by the
    host's clock around work that ends in a synchronize."""
    for chunk in chunks[:2]:
        embedder(chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        for chunk in chunks:
            embedder(chunk)
    torch.cuda.synchronize()
    return len(chunks) * CHUNK * iters / (time.perf_counter() - t0)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('k_chunks', nargs='?', type=int, default=16)
    parser.add_argument('iters', nargs='?', type=int, default=6)
    parser.add_argument('--device', default=None,
                        help="'cpu' compares the stems' embeddings; "
                             'default: cuda (raises without one)')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    variables = init_variables(seed=0)
    embedders = {stem: FastEmbedder(variables, device=device, stem=stem)
                 for stem in STEMS}
    rng = np.random.RandomState(0)
    if device.type != 'cuda':
        images = rng.randint(0, 256, (2, 160, 160, 3), dtype=np.uint8)
        a, b = (embedders[stem](images) for stem in STEMS)
        cos = float((a * b).sum(dim=1).min())
        print(f'min cosine {STEMS[0]} vs {STEMS[1]}: {cos:.6f}')
        if not cos > 0.999:
            raise SystemExit('the stems disagree')
        return

    from facenet_tpu_torch.utils.timing import card_line
    print(card_line())
    chunks = [torch.from_numpy(rng.randint(
        0, 256, (CHUNK, 160, 160, 3), dtype=np.uint8)).to(device)
        for _ in range(args.k_chunks)]
    results = {f'bf16_{stem}': [] for stem in STEMS}
    for stem in (*STEMS, *reversed(STEMS)):
        rate = measure(embedders[stem], chunks, args.iters)
        results[f'bf16_{stem}'].append(round(rate, 1))
        print(f'bf16_{stem:6s}: {rate:10,.0f} img/s ({1e6 / rate:6.2f} us/img)',
              flush=True)
    print(json.dumps(results))


if __name__ == '__main__':
    main()
