"""End-to-end serving A/B of the stem backends, in bf16 and in int8.

Counterpart of the JAX package's ``tools/time_stem_serving.py``: the whole
fused IRv1 forward (`FastEmbedder`) over K chunks of 128 images on the
device, for four variants:

  bf16_cudnn   bf16, the stem through F.conv2d
  bf16_fused   bf16, the stem as one kernel (B5)
  int8_cudnn   int8 post-training quantization of every conv, the stem too
  int8_fused   int8 with the stem's convs kept bf16 (STEM_SKIP) for B5

each calibrated on the first chunk's first 32 images, measured in turns
(the four, then the four reversed) so that all see the same card state.

On the CPU (``--device cpu``) nothing is timed: the variants' embeddings of
2 images are compared (the stems within bf16 and within int8: min cosine
above 0.999; int8 against bf16 above 0.95, the JAX package's bound).

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
    rng = np.random.RandomState(0)
    if device.type == 'cuda':
        chunks = [torch.from_numpy(rng.randint(
            0, 256, (CHUNK, 160, 160, 3), dtype=np.uint8)).to(device)
            for _ in range(args.k_chunks)]
        calib = chunks[0][:32]
    else:
        images = rng.randint(0, 256, (2, 160, 160, 3), dtype=np.uint8)
        calib = images
    embedders = {}
    for precision in ('bf16', 'int8'):
        kwargs = ({'quantize': 'int8', 'calib_images': calib}
                  if precision == 'int8' else {})
        for stem in STEMS:
            embedders[f'{precision}_{stem}'] = FastEmbedder(
                variables, device=device, stem=stem, **kwargs)
    if device.type != 'cuda':
        out = {name: embedder(images) for name, embedder in embedders.items()}
        pairs = {('bf16_cudnn', 'bf16_fused'): 0.999,
                 ('int8_cudnn', 'int8_fused'): 0.999,
                 ('bf16_cudnn', 'int8_cudnn'): 0.95,
                 ('bf16_fused', 'int8_fused'): 0.95}
        for (a, b), bound in pairs.items():
            cos = float((out[a] * out[b]).sum(dim=1).min())
            print(f'min cosine {a} vs {b}: {cos:.6f}')
            if not cos > bound:
                raise SystemExit(f'{a} and {b} disagree')
        return

    from facenet_tpu_torch.utils.timing import card_line
    print(card_line())
    results = {name: [] for name in embedders}
    for name in (*embedders, *reversed(embedders)):
        rate = measure(embedders[name], chunks, args.iters)
        results[name].append(round(rate, 1))
        print(f'{name:11s}: {rate:10,.0f} img/s ({1e6 / rate:6.2f} us/img)',
              flush=True)
    print(json.dumps(results))


if __name__ == '__main__':
    main()
