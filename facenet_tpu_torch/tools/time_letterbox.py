"""Host time of the letterbox resize: the native library, its numpy
restatement and PIL's bilinear resize.

`letterbox_batch` (``detectors/mtcnn/letterbox.py``) runs the port's
native library's fixed-point resize (``facenet_tpu_torch/native``) where
it is built, and its numpy restatement where it is not; before that
restatement the port resized with PIL's ``Image.BILINEAR`` (antialiased,
other pixels). They run on the host for every image that
`FaceDetector.detect_files`, `FacePipeline.process_files` and
``apps/extract_faces`` read. This times a batch of seeded uint8 images of
each source size through each (the native library only where it builds),
the same placement and zero fill around each resize, and prints
milliseconds per image (the median and the spread of the windows). Needs
PIL; no device.

    python -m facenet_tpu_torch.tools.time_letterbox [--sizes 720x960,1080x1440] [--target 480x640]
"""

from __future__ import annotations

import argparse
import os
import platform
import statistics
import time

import numpy as np

from facenet_tpu_torch.detectors.mtcnn import letterbox


def pil_letterbox_batch(images, target_shape):
    """The same placement and padding, resized by PIL's bilinear filter."""
    from PIL import Image

    th, tw = int(target_shape[0]), int(target_shape[1])
    out = np.zeros((len(images), th, tw, 3), np.uint8)
    for i, img in enumerate(images):
        _, nh, nw = letterbox._placement(*img.shape[:2], th, tw)
        left, top = (tw - nw) // 2, (th - nh) // 2
        out[i, top:top + nh, left:left + nw] = np.asarray(
            Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    return out


def numpy_letterbox_batch(images, target_shape):
    """The numpy restatement alone."""
    th, tw = int(target_shape[0]), int(target_shape[1])
    out = np.zeros((len(images), th, tw, 3), np.uint8)
    for i, img in enumerate(images):
        letterbox._letterbox_into(out[i], img, *img.shape[:2])
    return out


def native_letterbox_batch(images, target_shape):
    """The native library's letterbox alone."""
    from facenet_tpu_torch import native
    return np.stack([native.letterbox_array(img, target_shape)
                     for img in images])


def _ms_per_image(fn, images, target, windows):
    fn(images, target)
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        fn(images, target)
        times.append((time.perf_counter() - t0) / len(images) * 1e3)
    return statistics.median(times), times


def _shape(text):
    return tuple(int(v) for v in text.split('x'))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--sizes', default='720x960,1080x1440',
                        help='comma-separated HxW source sizes')
    parser.add_argument('--target', default='480x640', type=_shape)
    parser.add_argument('--batch', default=8, type=int)
    parser.add_argument('--windows', default=7, type=int)
    args = parser.parse_args(argv)
    from facenet_tpu_torch import native
    print(f'host: {platform.processor() or platform.machine()}, '
          f'{os.cpu_count()} cores, numpy {np.__version__}; native library '
          f'{"built" if native.available() else "not built"}')
    routes = [('numpy restatement', numpy_letterbox_batch),
              ('PIL bilinear', pil_letterbox_batch)]
    if native.available():
        routes.insert(0, ('native library', native_letterbox_batch))
    rng = np.random.default_rng(0)
    for size in args.sizes.split(','):
        h, w = _shape(size)
        images = list(rng.integers(0, 256, (args.batch, h, w, 3), np.uint8))
        line = []
        for name, fn in routes:
            ms, times = _ms_per_image(fn, images, args.target, args.windows)
            line.append(f'{name} {ms:.2f} ms/image '
                        f'({"/".join(f"{t:.2f}" for t in times)})')
        print(f'{h}x{w} -> {args.target[0]}x{args.target[1]}: '
              + '; '.join(line))


if __name__ == '__main__':
    main()
