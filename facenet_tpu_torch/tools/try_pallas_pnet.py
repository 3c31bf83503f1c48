"""The one-level P-Net kernel with float32 weights (B6,
`pnet.pnet_forward_level`) against the `PNet` module, and its time.

Counterpart of the JAX package's ``tools/try_pallas_pnet.py``. With randomly
initialized P-Net weights (seed 0), as there:

  * equivalence: the kernel (its plain version on the CPU) against the
    `PNet` module in bf16, probs 0.02 / reg 0.05;
  * on a CUDA device, at the geometry of a 480x640 cascade and batch 16:
    level 0 (288x384) through the kernel and through the module (cuDNN),
    in device time, and all levels with their resize through the kernel.

    python -m facenet_tpu_torch.tools.try_pallas_pnet [--device cpu] [--iters N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from facenet_tpu_torch.detectors.mtcnn import pnet
from facenet_tpu_torch.detectors.mtcnn.cascade import MTCNN
from facenet_tpu_torch.detectors.mtcnn.networks import normalize_crops
from facenet_tpu_torch.device import resolve_device


def check_equivalence(det, weights, shape, batch=2):
    """Kernel against the module on random normalized input; returns the
    max differences (probs, reg) and raises SystemExit beyond 0.02 / 0.05."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (batch, 3) + shape).astype(np.float32)
    x = normalize_crops(torch.from_numpy(x).to(det.device))
    with torch.inference_mode():
        p_ref, r_ref = det.pnet.forward_nchw(x)
        p_new, r_new = pnet.pnet_forward_level(weights, x)
    dp = float((p_ref - p_new).abs().max())
    dr = float((r_ref - r_new).abs().max())
    print(f'{shape}: kernel vs PNet module, max |d| probs {dp:.3e} '
          f'reg {dr:.3e}')
    if p_ref.shape != p_new.shape or not (dp < 0.02 and dr < 0.05):
        raise SystemExit('MISMATCH')
    return dp, dr


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--device', default=None,
                        help="'cpu' runs the equivalence check on the plain "
                             'version; default: cuda (raises without one)')
    parser.add_argument('--iters', type=int, default=20)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    det = MTCNN(image_shape=(480, 640), device=device)       # random weights
    weights = pnet.pack_level_weights(det.pnet).to(device)
    if device.type != 'cuda':
        check_equivalence(det, weights, (61, 83))
        return

    from facenet_tpu_torch.utils.timing import (card_line, cuda_ms,
                                                device_ms, spread)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(
        0, 256, (16, 480, 640, 3), dtype=np.uint8)).to(device)
    with torch.inference_mode():
        base = normalize_crops(images.float()).to(torch.bfloat16)
        levels = det.pyramid_levels(base)
    print(card_line())
    print('levels:', [tuple(lv.shape[2:]) for lv in levels])
    check_equivalence(det, weights, tuple(levels[0].shape[2:]), batch=16)

    level0 = levels[0]
    with torch.inference_mode():
        t_k, k_all, k_host = device_ms(
            lambda: pnet.pnet_forward_level(weights, level0), args.iters)
        t_m, m_all, _ = device_ms(lambda: det.pnet.forward_nchw(level0),
                                  args.iters)

        def all_levels():
            for level in det.pyramid_levels(base):
                pnet.pnet_forward_level(weights, level)

        t_all, all_all = cuda_ms(all_levels, args.iters, 2)
    print(f'kernel level0 convs:      {t_k:7.3f} ms/batch16 '
          f'({spread(k_all)}; host enqueue {k_host:.3f})')
    print(f'module level0 convs:      {t_m:7.3f} ms/batch16 '
          f'({spread(m_all)})')
    print(f'kernel all levels+resize: {t_all:7.3f} ms/batch16 '
          f'({spread(all_all)}; host included)')


if __name__ == '__main__':
    main()
