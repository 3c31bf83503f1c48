"""A/B of the cascade's P-Net backends.

Counterpart of the JAX package's ``tools/time_cascade_ab.py``: the whole
MTCNN cascade (`MTCNN._detect`, bundled weights, 480x640) on a batch of
uint8 noise that lies on the device, under each ``pnet_impl``: 'flax' (the
`PNet` module through cuDNN, level by level), 'flat' (the one-level kernel,
one launch per level) and 'pyramid' (the whole-pyramid kernel, one launch).
Times include the host: the cascade enqueues many small operations; the
device's busy time (torch.profiler, the sum of the kernels' durations) and
the P-Net kernels' share of it are printed beside.

On the CPU (``--device cpu``) nothing is timed: the backends' detections on
one synthetic 192x192 scene are compared (same faces, boxes within 1.5 px).

    python -m facenet_tpu_torch.tools.time_cascade_ab [batch] [impls] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from facenet_tpu_torch.detectors.mtcnn.cascade import MTCNN
from facenet_tpu_torch.detectors.pretrained import load_bundled
from facenet_tpu_torch.device import resolve_device

IMPLS = ('flax', 'flat', 'pyramid')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('batch', nargs='?', type=int, default=16)
    parser.add_argument('impls', nargs='?', default=','.join(IMPLS),
                        help='comma-separated pnet_impl values')
    parser.add_argument('--device', default=None,
                        help="'cpu' compares the backends' detections; "
                             'default: cuda (raises without one)')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    impls = args.impls.split(',')
    params = load_bundled('mtcnn')

    if device.type != 'cuda':
        from facenet_tpu_torch.utils.synthetic import render_scene
        img, _, _ = render_scene(np.random.RandomState(5), shape=(192, 192),
                                 n_faces=4, min_face=30, max_face=80)
        outs = [MTCNN(image_shape=(192, 192), params=params, pnet_impl=impl,
                      device=device).detect_batch(img[None])
                for impl in impls]
        for impl, out in zip(impls, outs):
            same = np.array_equal(out['valid'], outs[0]['valid'])
            d = np.abs(out['boxes'][out['valid']]
                       - outs[0]['boxes'][outs[0]['valid']]).max() \
                if same else float('nan')
            print(f'{impl}: {int(out["valid"].sum())} faces, boxes within '
                  f'{d:.3f} px of {impls[0]}')
            if not (same and d < 1.5):
                raise SystemExit('the backends disagree')
        return

    from facenet_tpu_torch.utils.timing import (card_line, cuda_ms,
                                                 device_busy, spread)
    print(card_line())
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(
        0, 256, (args.batch, 480, 640, 3), dtype=np.uint8)).to(device)
    for impl in impls:
        det = MTCNN(image_shape=(480, 640), params=params, pnet_impl=impl,
                    device=device)
        ms, windows = cuda_ms(lambda: det._detect(images), 20, 3)
        busy, _, rows = device_busy(lambda: det._detect(images), 3)
        pnet_ms = sum(e.self_device_time_total for e in rows
                      if 'pnet_' in e.key) / 3e3
        print(f'{impl}: {ms:8.2f} ms/batch{args.batch} '
              f'({args.batch * 1e3 / ms:,.0f} img/s; windows '
              f'{spread(windows)}); device busy {busy:.3f} ms, of it '
              f'{pnet_ms:.3f} ms in the P-Net kernels', flush=True)


if __name__ == '__main__':
    main()
