"""The fused stem kernel (B5, `ops.stem.stem_forward`) against the cuDNN
prefix it replaces, at the serving chunk of 128 images.

Counterpart of the JAX package's ``tools/try_stem_flat.py``. With the
full-width IRv1 of `init_variables(seed=0)`:

  * numerics on 4 images: kernel (its plain version on the CPU) against
    `irv1_fast.stem_prefix`, max |d| / max |ref| below 0.03;
  * on a CUDA device, device time per chunk of
    A. preprocessing + cuDNN prefix (conv1 s2d, conv2a, conv2b, max pool),
    B. preprocessing alone (the TPU version times its relayout to planes
       here; this kernel reads the NHWC pixels in place and has none),
    C. preprocessing + kernel.

    python -m facenet_tpu_torch.tools.try_stem_flat [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.models import irv1_fast
from facenet_tpu_torch.models.inception_resnet_v1 import init_variables
from facenet_tpu_torch.ops.preprocessing import image_processing
from facenet_tpu_torch.ops.stem import stem_forward

CHUNK = 128


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--device', default=None,
                        help="'cpu' runs the numerics check on the plain "
                             'version; default: cuda (raises without one)')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    params, _ = irv1_fast.build_fast_params(init_variables(seed=0),
                                            device=device)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(
        0, 256, (CHUNK, 160, 160, 3), dtype=np.uint8)).to(device)

    def pre(x):
        return image_processing(x, 160, 0, dtype=torch.bfloat16)

    with torch.inference_mode():
        ref = irv1_fast.stem_prefix(params, pre(images[:4])).float()
        new = stem_forward(params, pre(images[:4])).float()
    err = float((ref - new).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-6)
    print(f'stem output {tuple(ref.shape)} vs {tuple(new.shape)}; '
          f'max abs err {err:.4f} (rel {rel:.2e})')
    if ref.shape != new.shape or not rel < 0.03:
        raise SystemExit('numerics mismatch')
    if device.type != 'cuda':
        return

    from facenet_tpu_torch.utils.timing import card_line, device_ms, spread
    print(card_line())
    with torch.inference_mode():
        t_lib, lib_all, _ = device_ms(
            lambda: irv1_fast.stem_prefix(params, pre(images)), 20)
        t_pre, pre_all, _ = device_ms(lambda: pre(images), 20)
        t_k, k_all, _ = device_ms(lambda: stem_forward(params, pre(images)),
                                  20)
    print(f'A pre + cuDNN prefix : {t_lib:7.3f} ms/chunk ({spread(lib_all)})')
    print(f'B pre only           : {t_pre:7.3f} ms/chunk ({spread(pre_all)})')
    print(f'C pre + fused kernel : {t_k:7.3f} ms/chunk ({spread(k_all)})  '
          f'-> {t_lib / t_k:.2f}x')


if __name__ == '__main__':
    main()
