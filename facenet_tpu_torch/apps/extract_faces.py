"""Detect + align faces for a whole dataset into per-class PNG thumbnails.

Every class directory is decoded in chunks, each chunk detected as one
batch through the MTCNN cascade, and each face written as a PNG under
``<outdir>/<class>/`` with its size recorded in ``statistics.h5``. Runs on
the GPU unless ``--device cpu``.

    python -m facenet_tpu_torch.apps.extract_faces --config my.yaml [--device cpu]

Alignment modes (``image.align``):
- 'crop' (default): margin-expanded box crop + resize from the
  full-resolution original with PIL.
- 'landmarks': 5-point similarity alignment to the canonical template,
  batched on the device (`ops.image_ops.align_by_landmarks`) over the
  letterboxed detector frame.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from facenet_tpu_torch import config, dataset, h5utils, ioutils
from facenet_tpu_torch.detectors.face_detector import (FaceDetector,
                                                       image_processing)

DETECT_BATCH = 32


def _load_chunk(paths):
    """Decode a chunk of files with the native library (PIL for what it
    cannot read, or where it was not built); returns (arrays, ok_paths,
    n_failed)."""
    from facenet_tpu_torch import native

    use_native = native.available()
    arrays, ok_paths = [], []
    failed = 0
    for path in paths:
        arr = native.decode_image_native_size(path) if use_native else None
        if arr is None:
            try:
                arr = ioutils.read_image(path)
            except IOError:
                failed += 1
                continue
        arrays.append(arr)
        ok_paths.append(path)
    return arrays, ok_paths, failed


def _crop_name(base, n):
    """Output path for the n-th face of one image (suffix _n past the first)."""
    if n == 0:
        return base
    return base.parent / f'{base.stem}_{n}{base.suffix}'


class _LandmarkAligner:
    """Batched device-side 5-point alignment for the 'landmarks' mode: the
    items of one chunk are letterboxed to their detector bucket (landmarks
    mapped through the same geometry) and warped in one call per bucket."""

    def __init__(self, detector, out_size):
        self.detector = detector
        self.size = int(out_size)

    def __call__(self, arrays, items):
        """items: [(img_idx, n, BoundingBox with landmarks)] ->
        {(img_idx, n): uint8 [S, S, 3] crop}."""
        from facenet_tpu_torch.detectors.mtcnn.letterbox import letterbox_batch
        from facenet_tpu_torch.ops.image_ops import align_by_landmarks

        out = {}
        by_shape = {}
        for item in items:
            h, w = arrays[item[0]].shape[:2]
            by_shape.setdefault(self.detector.route_shape(h, w),
                                []).append(item)
        device = self.detector.device
        for shape, group in by_shape.items():
            batch, scales, pads = letterbox_batch(
                [arrays[i] for i, _, _ in group], shape)
            lmk = np.stack([box.landmarks * scales[j] + pads[j][None, :]
                            for j, (_, _, box) in enumerate(group)])
            with torch.inference_mode():
                crops = align_by_landmarks(
                    torch.from_numpy(batch).to(device).float(),
                    torch.from_numpy(lmk.astype(np.float32)).to(device),
                    self.size)
                crops = torch.clamp(crops + 0.5, 0, 255).to(torch.uint8)
            crops = crops.cpu().numpy()
            for j, (i, n, _) in enumerate(group):
                out[(i, n)] = crops[j]
        return out


def _extract_class(cls, detector, options, counters, pool, aligner=None):
    """Detect every image of one class in cascade-sized batches and write
    the aligned crops and face-size records; the next chunk decodes on
    `pool` while this one is detected."""
    from PIL import Image

    class_dir = options.outdir / cls.name
    ioutils.makedirs(class_dir)
    single_face_only = not bool(options.detect_multiple_faces)

    chunks = [cls.files[s:s + DETECT_BATCH]
              for s in range(0, cls.nrof_images, DETECT_BATCH)]
    pending = pool.submit(_load_chunk, chunks[0]) if chunks else None
    for i in range(len(chunks)):
        arrays, ok_paths, failed = pending.result()
        pending = (pool.submit(_load_chunk, chunks[i + 1])
                   if i + 1 < len(chunks) else None)
        counters['unreadable'] += failed
        if not arrays:
            continue

        detections = detector.detect_images(arrays)
        aligned = {}
        if aligner is not None:
            items = [(j, n, box)
                     for j, boxes in enumerate(detections)
                     if boxes and not (single_face_only and len(boxes) > 1)
                     for n, box in enumerate(boxes)
                     if box.landmarks is not None]
            if items:
                aligned = aligner(arrays, items)

        for j, (arr, path, boxes) in enumerate(zip(arrays, ok_paths,
                                                   detections)):
            if not boxes or (single_face_only and len(boxes) > 1):
                continue
            counters['faces'] += 1
            base = class_dir / (Path(path).stem + '.png')
            for n, box in enumerate(boxes):
                if (j, n) in aligned:
                    crop = aligned[(j, n)]
                else:
                    crop = image_processing(Image.fromarray(arr), box,
                                            options.image)
                out = _crop_name(base, n)
                ioutils.write_image(crop, out)
                h5utils.write(options.h5file,
                              h5utils.filename2key(out, 'size'),
                              np.uint32((box.height, box.width)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', dest='config_file', default=None,
                        type=Path,
                        help='User yaml config merged on top of the app '
                             'defaults.')
    parser.add_argument('--device', default=None,
                        help="torch device, 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from facenet_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    options = config.extract_faces(__file__, {'config': args.config_file})

    dbase = dataset.DBase(options.dataset)
    ioutils.write_text_log(options.logfile, dbase)
    print('input dataset:', dbase)
    print('output directory', options.outdir)
    print('output h5 file  ', options.h5file)

    det_kwargs = {}
    if options.detector_shapes:
        # multi-bucket letterbox geometry: [H, W] buckets sharing one weight
        # set; inputs route per size (FaceDetector.route_shape)
        det_kwargs['image_shapes'] = [tuple(int(v) for v in s)
                                      for s in options.detector_shapes]
    detector = FaceDetector(detector=options.detector or 'mtcnn',
                            weights=options.detector_weights or None,
                            device=device, **det_kwargs)
    ioutils.write_text_log(options.logfile, detector)
    print(detector)

    aligner = None
    if str(options.image.align or 'crop') == 'landmarks':
        aligner = _LandmarkAligner(detector,
                                   config.value_or(options.image.size, 160))
        print('alignment: 5-point landmark similarity warp (device)')

    counters = {'faces': 0, 'unreadable': 0}
    with ThreadPoolExecutor(max_workers=1) as pool:
        for cls in dbase.classes:
            _extract_class(cls, detector, options, counters, pool,
                           aligner=aligner)

    out_dbase = dataset.DBase(dataset.DefaultConfig(options.outdir))
    ioutils.write_text_log(options.logfile, out_dbase)
    ioutils.write_text_log(
        options.logfile,
        f"Number of files that cannot be read {counters['unreadable']}")
    ioutils.write_text_log(
        options.logfile, f"Number of extracted faces {counters['faces']}")

    print('Number of extracted faces', counters['faces'])
    print('Logs have been written to the file', options.logfile)
    return counters


if __name__ == '__main__':
    main()
