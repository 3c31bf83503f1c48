"""Letterboxing: scale an image into the cascade's fixed (H, W) and pad.

Where the port's native library is built (`facenet_tpu_torch.native`, a
copy of the JAX package's), `letterbox_batch` and `letterbox_file` run its
C++ letterbox, as the JAX package does. Its pixels are restated here in
integer numpy, which runs where the library is not built and is what the
tests hold the library to:

- the placement (scale, scaled size, centred pads) in binary32 with
  truncation (`letterbox_geometry`);
- a two-tap bilinear resize with half-pixel centres and 12-bit fixed-point
  weights, the vertical blend rounded to uint8 before the horizontal one,
  no antialiasing (`resize_bilinear`);
- files: a JPEG is decoded at the smallest M/8 scale (M in 1, 2, 4, 8)
  that covers the scaled size, and letterboxed with the placement of its
  native size (`letterbox_file`).

PIL is imported only where a file is decoded without the library.
"""

from __future__ import annotations

import numpy as np

_BITS = 12
_ONE = 1 << _BITS


def _placement(h, w, th, tw):
    """(scale, nh, nw): the letterbox scale and the scaled image size, in
    binary32 arithmetic with truncation, as the native letterbox computes
    them."""
    f32 = np.float32
    scale = min(f32(th) / f32(h), f32(tw) / f32(w))
    nh = max(1, min(int(f32(h) * scale + f32(0.5)), th))
    nw = max(1, min(int(f32(w) * scale + f32(0.5)), tw))
    return scale, nh, nw


def letterbox_geometry(h, w, target_shape):
    """(scale, (pad_left, pad_top)) of the letterbox placement for an
    (h, w) image: original_coords = (letterboxed_coords - pad) / scale."""
    th, tw = int(target_shape[0]), int(target_shape[1])
    scale, nh, nw = _placement(h, w, th, tw)
    return float(scale), ((tw - nw) // 2, (th - nh) // 2)


def _taps(n_src, n_dst):
    """(i0, i1, weight) int32 [n_dst]: the two source taps of each output
    index along one axis and the 12-bit weight of the second.

    The source coordinate is (i + 0.5) * s - 0.5 with s = n_src / n_dst in
    binary32. The reference library is built with g++ ``-O3
    -march=native``, which contracts that into one fused multiply-add: the
    exact product, the subtraction and ONE rounding to binary32. The
    product of two binary32 values is exact in binary64 and so is the
    subtraction wherever the result is not clamped to 0, so binary64
    followed by one rounding is that fused form. (Two binary32 roundings
    give other weights on some sizes, 65 -> 313 for one.) The weight
    (f - i0) * 4096 + 0.5 is the same fused or not: the product by 4096 is
    exact.
    """
    f32 = np.float32
    s = f32(n_src) / f32(n_dst)
    centre = np.arange(n_dst, dtype=f32) + f32(0.5)
    f = (centre.astype(np.float64) * np.float64(s) - 0.5).astype(f32)
    f = np.maximum(f32(0), np.minimum(f, f32(n_src - 1)))
    i0 = f.astype(np.int32)
    i1 = np.minimum(i0 + 1, n_src - 1)
    frac = (f - i0.astype(f32)).astype(np.float64)
    weight = (frac * _ONE + 0.5).astype(f32).astype(np.int32)
    return i0, i1, weight


def _blend(a, b, weight):
    """(a * 4096 + w * (b - a) + 2048) >> 12 on uint8 taps, to uint8: as
    a * 4096 is a multiple of 4096, that is a + ((w * (b - a) + 2048) >> 12),
    computed in place on int32 copies of the taps alone."""
    low = a.astype(np.int32)
    delta = b.astype(np.int32)
    delta -= low
    delta *= weight
    delta += _ONE // 2
    delta >>= _BITS
    low += delta
    return low.astype(np.uint8)


def resize_bilinear(image, height, width):
    """uint8 [h, w, C] -> [height, width, C]: the native library's
    fixed-point bilinear resize, pixel for pixel (see `_taps`). The taps
    are gathered in uint8 and only they are widened: rows first, then
    columns of the blended rows as (pixel, channel) pieces."""
    h, w, c = image.shape
    if (h, w) == (height, width):
        return image.copy()
    y0, y1, wy = _taps(h, height)
    x0, x1, wx = _taps(w, width)
    rows = _blend(image[y0], image[y1], wy[:, None, None])
    rows = rows.reshape(height, w * c)
    channels = np.arange(c, dtype=np.int32)
    cols0 = (x0[:, None] * c + channels).ravel()
    cols1 = (x1[:, None] * c + channels).ravel()
    out = _blend(np.take(rows, cols0, axis=1), np.take(rows, cols1, axis=1),
                 np.repeat(wx, c)[None])
    return out.reshape(height, width, c)


def _as_rgb(img, index):
    """[H, W] / [H, W, 1] broadcast to RGB, [H, W, 4] without alpha, as
    uint8 [H, W, 3]."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    elif img.ndim == 3 and img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    elif img.ndim == 3 and img.shape[2] == 4:
        img = img[:, :, :3]
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'image {index}: expected [H, W, (1|3|4)] or '
                         f'[H, W], got shape {img.shape}')
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return img


def _letterbox_into(canvas, img, geom_h, geom_w):
    """Resize `img` to the placement of a (geom_h, geom_w) image and paste
    it centred into the zeroed `canvas` [th, tw, 3]; returns (scale, (left,
    top)). `img` is the image itself or a scaled decode of it."""
    th, tw = canvas.shape[:2]
    scale, nh, nw = _placement(geom_h, geom_w, th, tw)
    left, top = (tw - nw) // 2, (th - nh) // 2
    canvas[top:top + nh, left:left + nw] = resize_bilinear(img, nh, nw)
    return float(scale), (left, top)


def letterbox_batch(images, target_shape):
    """Host side: scale and pad arbitrary-size images to a fixed shape,
    with the native library's C++ letterbox where it is built, else its
    numpy restatement (the same pixels).

    Accepts grayscale [H, W] / [H, W, 1] (broadcast to RGB) and RGBA
    [H, W, 4] (alpha dropped).

    Returns (batch [B, H, W, 3] uint8, scales [B], pads [B, 2]) such that
    original_coords = (letterboxed_coords - pad) / scale.
    """
    from facenet_tpu_torch import native

    th, tw = int(target_shape[0]), int(target_shape[1])
    out = np.zeros((len(images), th, tw, 3), np.uint8)
    scales = np.zeros((len(images),), np.float32)
    pads = np.zeros((len(images), 2), np.float32)
    use_native = native.available()
    for i, img in enumerate(images):
        img = _as_rgb(img, i)
        if use_native:
            out[i] = native.letterbox_array(img, (th, tw))
            scales[i], pads[i] = letterbox_geometry(*img.shape[:2], (th, tw))
        else:
            scales[i], pads[i] = _letterbox_into(out[i], img, *img.shape[:2])
    return out, scales, pads


def _jpeg_reduction(h, w, target_shape):
    """The DCT scale 8 / M of the native JPEG decode: the smallest M in 1,
    2, 4, 8 whose output, ceil(d * M / 8) on each side, covers the scaled
    size (int(d * s + 0.5) in binary32, s the letterbox scale)."""
    f32 = np.float32
    th, tw = int(target_shape[0]), int(target_shape[1])
    s = min(f32(th) / f32(h), f32(tw) / f32(w))
    need_h, need_w = int(f32(h) * s + f32(0.5)), int(f32(w) * s + f32(0.5))
    for m in (1, 2, 4, 8):
        if -(-h * m // 8) >= need_h and -(-w * m // 8) >= need_w:
            return 8 // m
    return 1


def force_jpeg_scale(img, k):
    """Make an opened, not yet loaded PIL JPEG decode at the DCT scale 1/k.

    PIL's ``draft`` takes a size and picks its scale from
    ``min(w // size_w, h // size_h)``: where a side is shorter than k that
    minimum is the short side, not k. This sets what ``JpegImageFile.draft``
    sets once it has chosen a scale: the tile's extent, the image size
    ceil(side / k) and ``decoderconfig = (k, 0)``.

    :raises RuntimeError: this Pillow lacks one of those internals, or the
        image was already drafted or holds more than one tile
    """
    from PIL import ImageFile

    tile_type = getattr(ImageFile, '_Tile', None)
    if (tile_type is None or not hasattr(img, 'decoderconfig')
            or not hasattr(img, '_size') or len(img.tile) != 1
            or img.decoderconfig):
        raise RuntimeError(
            'cannot force the JPEG DCT scale: this Pillow lacks '
            'ImageFile._Tile, decoderconfig or _size, or the image was '
            'already drafted')
    decoder, extent, offset, args = img.tile[0]
    x0, y0, x1, y1 = extent
    img.tile = [tile_type(decoder, (x0, y0, (x1 - x0 + k - 1) // k + x0,
                                    (y1 - y0 + k - 1) // k + y0),
                          offset, args)]
    w, h = img.size
    img._size = ((w + k - 1) // k, (h + k - 1) // k)
    img.decoderconfig = (k, 0)


def letterbox_file(path, route):
    """Decode an image file and letterbox it as
    ``native.NativeBatchLoader(MODE_LETTERBOX)`` does.

    :param path: image file
    :param route: (h, w) -> (th, tw), the letterbox shape for an image of
        native size (h, w)
    :return: (canvas [th, tw, 3] uint8, scale, (pad_left, pad_top)), the
        placement that of the native size; raises on an unreadable file

    The native library decodes JPEG and PNG (`native.decode_image` in
    MODE_LETTERBOX, the loader's decode). Without it, or for another
    format, PIL decodes: a JPEG at the reduction 8 / M that libjpeg's M/8
    scaling gives (`_jpeg_reduction`, forced by `force_jpeg_scale`), and
    that smaller image is resized onto the native size's placement.
    """
    from facenet_tpu_torch import native

    if native.available():
        size = native.probe_image(path)
        if size is not None:
            target = route(*size)
            canvas = native.decode_image(path, target, native.MODE_LETTERBOX)
            if canvas is not None:
                return (canvas,) + letterbox_geometry(*size, target)

    from PIL import Image

    with Image.open(path) as img:
        w, h = img.size
        th, tw = route(h, w)
        k = _jpeg_reduction(h, w, (th, tw)) if img.format == 'JPEG' else 1
        if k > 1:
            force_jpeg_scale(img, k)
        pixels = np.asarray(img.convert('RGB'))
        if k > 1:
            want = (-(-h // k), -(-w // k))
            if pixels.shape[:2] != want:
                raise RuntimeError(
                    f'JPEG decoded at {pixels.shape[:2]}, not at the DCT '
                    f'scale 1/{k} ({want})')
    canvas = np.zeros((th, tw, 3), np.uint8)
    scale, pad = _letterbox_into(canvas, pixels, h, w)
    return canvas, scale, pad
