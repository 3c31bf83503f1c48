"""Batched image sampling: crop-and-resize and affine (similarity) warps.

Batched, fixed-shape and bilinear, with clamp-to-edge sampling. The
axis-aligned crop is separable; `crop_and_resize` here writes it as two
float32 matrix products (TF32 off), the plain version of the crop kernel
`facenet_tpu_torch.ops.crop.crop_and_resize`, which every caller goes
through. The landmark alignment composes that crop with a dense affine
warp whose CUDA kernel is `facenet_tpu_torch.ops.warp.dense_warp`.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products in full float32 (no TF32) on the card."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def _bilinear_sample(images, ys, xs):
    """Sample [B, H, W, C] images at float coords ys, xs [B, ...] ->
    [B, ..., C] float32; out-of-bounds samples clamp to the edge.

    Both taps clip from the unclipped floor, so a sample left of pixel 0
    takes pixel 0 twice instead of blending pixels 0 and 1.
    """
    b, h, w, c = images.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0f, x0f = y0.long(), x0.long()
    y0i, y1i = y0f.clamp(0, h - 1), (y0f + 1).clamp(0, h - 1)
    x0i, x1i = x0f.clamp(0, w - 1), (x0f + 1).clamp(0, w - 1)

    flat = images.float().reshape(b, h * w, c)
    shape = ys.shape

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*shape, c)

    top = tap(y0i, x0i) * (1 - wx) + tap(y0i, x1i) * wx
    bot = tap(y1i, x0i) * (1 - wx) + tap(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def _interp_matrix(lo, hi, n, s):
    """[..., s, n] two-tap bilinear interpolation matrices for box ranges
    [lo, hi) (tensors of any batch shape); pixel centres at half steps,
    both taps clamped from the unclipped floor."""
    grid = (torch.arange(s, dtype=torch.float32, device=lo.device) + 0.5) / s
    coords = lo[..., None] + grid * (hi - lo)[..., None] - 0.5
    c0 = torch.floor(coords)
    w = coords - c0
    c0f = c0.long()
    c0i = c0f.clamp(0, n - 1)
    c1i = (c0f + 1).clamp(0, n - 1)
    pos = torch.arange(n, device=lo.device)
    return ((pos == c0i[..., None]) * (1 - w)[..., None] +
            (pos == c1i[..., None]) * w[..., None])


def crop_and_resize(images, boxes, out_size):
    """Crop boxes from a batch of images and resize to out_size x out_size.

    Separable bilinear sampling as two batched float32 matrix products (Y
    then X interpolation), the K boxes of an image stacked into one tall
    operand.

    :param images: [B, H, W, C] (any dtype; sampled in float32)
    :param boxes: [B, K, 4] pixel-coordinate (x1, y1, x2, y2) boxes
    :param out_size: output side length S
    :return: [B, K, S, S, C] float32 crops
    """
    s = int(out_size)
    b, h, w, c = images.shape
    k = boxes.shape[1]
    boxes = boxes.float()
    ry = _interp_matrix(boxes[..., 1], boxes[..., 3], h, s)   # [B, K, S, H]
    rx = _interp_matrix(boxes[..., 0], boxes[..., 2], w, s)   # [B, K, S, W]
    f = images.float().reshape(b, h, w * c)
    with full_float32():
        rows = torch.bmm(ry.reshape(b, k * s, h), f)          # [B, K*S, W*C]
        rows = rows.reshape(b * k, s, w, c)
        out = torch.matmul(rx.reshape(b * k, 1, s, w), rows)  # [BK, S, S, C]
    return out.reshape(b, k, s, s, c)


def affine_warp(images, matrices, out_size):
    """Warp images by per-image 2x3 affine matrices (output -> input coords)
    with a bilinear gather.

    :param images: [B, H, W, C]
    :param matrices: [B, 2, 3] mapping output pixel (x, y, 1) to input (x, y)
    :param out_size: (height, width) of the output
    :return: [B, h, w, C] float32
    """
    oh, ow = int(out_size[0]), int(out_size[1])
    dev = images.device
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing='ij')
    m = matrices.float()[:, :, :, None, None]
    in_x = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    in_y = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    return _bilinear_sample(images, in_y, in_x)


def dense_warp(images, matrices, out_size, chunk=8):
    """Gather-free affine warp: dense two-tap bilinear weights and a matrix
    product. The plain version of the B2 kernel (`ops.warp.dense_warp`).

    The tap weight of source row h is relu(1 - |h - src_y|) with the source
    coords clamped to the image first, which is exactly the clamp-to-edge
    bilinear sample of `affine_warp` (they agree to float32 rounding). Cost
    grows with the source area: warp small crops, not whole scenes.

    :param images: [B, H, W, C] (any dtype; computed in float32)
    :param matrices: [B, 2, 3] output pixel (x, y, 1) -> input (x, y)
    :param out_size: (height, width) of the output
    :param chunk: images per step, bounding the [oh*ow, W, C] intermediate
    :return: [B, h, w, C] float32
    """
    oh, ow = int(out_size[0]), int(out_size[1])
    b, h, w, c = images.shape
    dev = images.device
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing='ij')
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    row_idx = torch.arange(h, dtype=torch.float32, device=dev)
    col_idx = torch.arange(w, dtype=torch.float32, device=dev)
    out = []
    with full_float32():
        for start in range(0, b, chunk):
            img = images[start:start + chunk].float()
            m = matrices[start:start + chunk].float()[..., None]  # [n, 2, 3, 1]
            in_x = torch.clamp(m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2],
                               0.0, w - 1.0)                      # [n, P]
            in_y = torch.clamp(m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2],
                               0.0, h - 1.0)
            wy = torch.clamp(1.0 - (row_idx - in_y[..., None]).abs(), min=0.0)
            wx = torch.clamp(1.0 - (col_idx - in_x[..., None]).abs(), min=0.0)
            rows = torch.bmm(wy, img.reshape(-1, h, w * c))       # [n, P, W*C]
            rows = rows.reshape(-1, oh * ow, w, c)
            out.append((rows * wx[..., None]).sum(dim=2).reshape(-1, oh, ow, c))
    return torch.cat(out) if out else images.new_zeros((0, oh, ow, c),
                                                       dtype=torch.float32)


# canonical 5-point template for 112x112 aligned face crops (ArcFace layout:
# left eye, right eye, nose, left mouth corner, right mouth corner)
CANONICAL_LANDMARKS_112 = np.array([
    [38.2946, 51.6963],
    [73.5318, 51.5014],
    [56.0252, 71.7366],
    [41.5493, 92.3655],
    [70.7299, 92.2041],
], dtype=np.float32)


def canonical_landmarks(out_size):
    """Scale the canonical 5-point template to an out_size x out_size crop."""
    return CANONICAL_LANDMARKS_112 * (float(out_size) / 112.0)


def similarity_transform_from_points(src, dst):
    """Least-squares similarity transform (Umeyama) mapping src -> dst.

    :param src: [..., N, 2] source points (e.g. detected landmarks)
    :param dst: [..., N, 2] or [N, 2] target points (canonical template)
    :return: [..., 2, 3] matrices M with dst ~ M @ [src, 1]

    The 2x2 SVD is in closed form. A 2x2 covariance [[a, b], [c, d]] splits
    into a similarity part p = ((a + d), (c - b)) / 2 and a reflection part
    q = ((a - d), (c + b)) / 2; its singular values are |p| + |q| and
    ||p| - |q||, det = |p|^2 - |q|^2, and Umeyama's rotation (with the
    reflection fix-up) is the rotation by atan2(p). Hence the result
    R = p / |p| and the scale (|p| + |q| + sign(det) ||p| - |q||) / var_src,
    which is 2|p| / var_src whether or not the covariance reflects.
    """
    src = src.float()
    dst = dst.float().expand_as(src)
    n = src.shape[-2]
    src_mean = src.mean(dim=-2, keepdim=True)
    dst_mean = dst.mean(dim=-2, keepdim=True)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    src_var = (src_c ** 2).sum(dim=-1).mean(dim=-1)

    cov = dst_c.transpose(-1, -2) @ src_c / n                 # [..., 2, 2]
    a, b = cov[..., 0, 0], cov[..., 0, 1]
    c, d = cov[..., 1, 0], cov[..., 1, 1]
    px, py = (a + d) * 0.5, (c - b) * 0.5
    norm_p = torch.sqrt(px * px + py * py)
    safe = torch.clamp(norm_p, min=1e-30)
    cos, sin = torch.where(norm_p > 0, px / safe, 1.0), py / safe
    scale = 2.0 * norm_p / torch.clamp(src_var, min=1e-10)

    rot = torch.stack([torch.stack([cos, -sin], -1),
                       torch.stack([sin, cos], -1)], -2)      # [..., 2, 2]
    mat = scale[..., None, None] * rot
    t = dst_mean[..., 0, :] - (mat @ src_mean[..., 0, :, None])[..., 0]
    return torch.cat([mat, t[..., None]], dim=-1)


def invert_affine(m):
    """Invert [..., 2, 3] affine matrices. A singular one gives non-finite
    entries rather than an error: checking would read the device's status
    on the host, a wait inside a pipeline's enqueue."""
    a = m[..., :2]
    t = m[..., 2:]
    inv_a = torch.linalg.inv_ex(a)[0]
    return torch.cat([inv_a, -inv_a @ t], dim=-1)


_CONSTANTS = {}


def _constants(out_size, device):
    """(the canonical template [5, 2], an output square's corners [4, 2])
    for `out_size`, float32 on `device`, copied there once: a copy from
    pageable host memory would hold the host until the device had run
    everything queued before it."""
    key = (int(out_size), str(device))
    if key not in _CONSTANTS:
        s = float(out_size)
        corners = [[0.0, 0.0], [s - 1.0, 0.0], [0.0, s - 1.0],
                   [s - 1.0, s - 1.0]]
        _CONSTANTS[key] = (
            torch.from_numpy(canonical_landmarks(out_size)).to(device),
            torch.tensor(corners, dtype=torch.float32, device=device))
    return _CONSTANTS[key]


def _output_to_input(landmarks, out_size):
    """[..., 2, 3] matrices taking an aligned output pixel to the source
    pixel: the inverse of the similarity that sends the landmarks onto the
    canonical template."""
    template, _ = _constants(out_size, landmarks.device)
    return invert_affine(similarity_transform_from_points(landmarks.float(),
                                                          template))


def dense_warp_inputs(images, landmarks, out_size):
    """What the 'dense' alignment hands to the warp: each face's
    axis-aligned crop onto a t x t intermediate (t = 240 for out_size 160:
    enough resolution for the output square at any rotation, sqrt(2)
    coverage, plus tap margin), and the matrices from output pixels to
    intermediate pixels, composed exactly through the crop's half-pixel
    convention.

    :param images: [B, H, W, C]
    :param landmarks: [B, K, 5, 2] (x, y) detected landmarks
    :param out_size: side length S of the aligned crops
    :return: (intermediates [B*K, t, t, C] float32, matrices [B*K, 2, 3]
        float32, contiguous)
    """
    s = int(out_size)
    b, k = landmarks.shape[:2]
    inv = _output_to_input(landmarks, s)
    t = int(-(-int(s * 1.4 + 16) // 8) * 8)
    _, corners = _constants(s, images.device)
    src = corners @ inv[..., :2].transpose(-1, -2) + inv[..., None, :, 2]
    lo = src.amin(dim=-2) - 4.0                                  # [B, K, 2]
    hi = src.amax(dim=-2) + 4.0
    boxes = torch.cat([lo, hi], dim=-1)                          # (x1, y1, x2, y2)
    # crop sample i reads source lo + (i + .5) / t * (hi - lo) - .5, so
    # source coord x_s lands at intermediate index
    # (x_s + .5 - lo) * t / (hi - lo) - .5
    sc = t / (hi - lo)
    a = inv[..., :2] * sc[..., None]
    off = (inv[..., 2] + 0.5 - lo) * sc - 0.5
    mats = torch.cat([a, off[..., None]], dim=-1).reshape(b * k, 2, 3)
    from facenet_tpu_torch.ops import crop
    inter = crop.crop_and_resize(images, boxes, t)
    return inter.reshape(b * k, t, t, images.shape[-1]), mats.contiguous()


def align_by_landmarks(images, landmarks, out_size, method='auto'):
    """Landmark-based face alignment: warp so the 5 landmarks land on the
    canonical template.

    Methods:

    - 'gather': one bilinear gather warp from the full source.
    - 'dense': axis-aligned `crop_and_resize` onto a small t x t
      intermediate, then a dense warp for the rotation (`dense_warp_inputs`).
      The warp is `ops.warp.dense_warp`: the B2 kernel on a CUDA tensor, its
      plain version `dense_warp` on a CPU tensor.
    - 'auto': 'dense' on CUDA, 'gather' on the CPU.

    :param images: [B, H, W, C]
    :param landmarks: [B, 5, 2] or [B, K, 5, 2] (x, y) detected landmarks;
        with K faces per image all B*K crops go through one warp
    :param out_size: side length of aligned output crops
    :param method: 'auto' | 'gather' | 'dense'
    :return: [B, S, S, C] (or [B, K, S, S, C]) float32 aligned crops
    """
    s = int(out_size)
    per_face = landmarks.dim() == 4
    if not per_face:
        landmarks = landmarks[:, None]
    b, k = landmarks.shape[:2]
    c = images.shape[-1]
    if method == 'auto':
        method = 'dense' if images.device.type == 'cuda' else 'gather'
    if method not in ('gather', 'dense'):
        raise ValueError(f'unknown alignment method {method!r}')

    if method == 'gather':
        inv = _output_to_input(landmarks, s)
        rep = images[:, None].expand(b, k, *images.shape[1:])
        out = affine_warp(rep.reshape(b * k, *images.shape[1:]),
                          inv.reshape(b * k, 2, 3), (s, s))
    else:
        from facenet_tpu_torch.ops import warp
        out = warp.dense_warp(*dense_warp_inputs(images, landmarks, s), (s, s))
    out = out.reshape(b, k, s, s, c)
    return out if per_face else out[:, 0]
