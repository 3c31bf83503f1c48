"""The one-level P-Net kernel with float32 weights (B6,
`pnet.pnet_forward_level`) against the `PNet` module, and its time; with
the accuracy measurement of B6's design that `chip_smoke.py` prints
(`conv_sum_errors`).

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
from facenet_tpu_torch.ops.cuda_build import check
from facenet_tpu_torch.ops.stem import DEPTH_ORDER

TILE = 16           # head cells a tile side (csrc/pnet_tile.cuh)


def conv3_sums(weights, x, chained):
    """B6's accuracy probe: (conv3's sums before its bias [B, gh, gw, 32]
    float32, the conv2 activations they were summed from [B, 16, gh + 2,
    gw + 2] float64). `chained` runs each depth step's three mma on the
    accumulator itself; otherwise each step is summed from zero and added
    outside the tensor core, as B6 does."""
    if x.device.type != 'cuda' or weights.device != x.device:
        raise ValueError('the measurements of B6 run on the card only')
    x = x.to(torch.bfloat16).contiguous()
    b, _, sh, sw = x.shape
    vector = pnet.mma_weights(weights, 3)
    gh, gw = pnet.out_geometry(sh, sw)
    ty, tx = -(-gh // TILE), -(-gw // TILE)
    side = TILE + 2
    sums = torch.empty(b, gh, gw, 32, dtype=torch.float32, device=x.device)
    c2 = torch.empty(b * ty * tx, side * side, 16, dtype=torch.bfloat16,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = pnet.LEVEL_KERNEL.load().pnet_level_sums_launch(
            x.data_ptr(), b, sh, sw, vector.data_ptr(), pnet.MMA3_N_HALFS,
            int(chained), sums.data_ptr(), c2.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(err, 'pnet_level_sums')
    # channel c lies at the position of c in the tile's order
    c2 = c2[..., list(np.argsort(DEPTH_ORDER))].double()
    c2 = c2.reshape(b, ty, tx, side, side, 16)
    # tile (y, x) holds conv2 rows [16 y, 16 y + 18): keep the first 16 of
    # every tile but the last, which keeps all 18
    rows = torch.cat([c2[:, i, :, :TILE if i < ty - 1 else side]
                      for i in range(ty)], dim=2)
    grid = torch.cat([rows[:, j, :, :TILE if j < tx - 1 else side]
                      for j in range(tx)], dim=2)
    return sums, grid[:, :gh + 2, :gw + 2].permute(0, 3, 1, 2).contiguous()


def conv_sum_errors(weights, x):
    """conv3's sums on the card against float64 sums of the same bf16
    activations and float32 weights: {'chained', 'step sums': max |s -
    s64| of the probe in that mode, 'fma chain': the same for float32
    fused multiply-adds in the order a CUDA-core loop takes them (input
    channel, then tap; restated on the card in float64, rounded to float32
    after each step), 'scale': max |s64|}."""
    w3 = pnet._blocks(weights)('w3', 16, 3, 3, 32).double()
    oihw = w3.permute(3, 0, 1, 2).contiguous()
    out = {}
    for name, chained in (('chained', True), ('step sums', False)):
        sums, c2 = conv3_sums(weights, x, chained)
        ref = torch.nn.functional.conv2d(c2, oihw).permute(0, 2, 3, 1)
        out[name] = float((sums.double() - ref).abs().max())
        out['scale'] = float(ref.abs().max())
    gh, gw = sums.shape[1:3]
    acc = torch.zeros(c2.shape[0], 32, gh, gw, dtype=torch.float32,
                      device=c2.device)
    for c in range(16):
        for ky in range(3):
            for kx in range(3):
                term = w3[c, ky, kx][None, :, None, None] \
                    * c2[:, c:c + 1, ky:ky + gh, kx:kx + gw]
                acc = (acc.double() + term).float()
    out['fma chain'] = float((acc.permute(0, 2, 3, 1).double() - ref)
                             .abs().max())
    return out


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
