"""Dense affine warp of small crops: the B2 kernel and its wrapper.

`dense_warp` is the wrapper of the CUDA kernel ``csrc/dense_warp.cu``,
which replaces the Pallas TPU kernel
``facenet_tpu/ops/pallas_warp.py::_warp_kernel``. On a CUDA tensor it
launches the kernel, or raises; on a CPU tensor it runs `dense_warp_plain`
(`image_ops.dense_warp`), the plain PyTorch version of the same function.
The landmark alignment (`image_ops.align_by_landmarks`) sends every crop of
a batch through one call.
"""

from __future__ import annotations

import ctypes

import torch

from facenet_tpu_torch.ops.cuda_build import CudaKernel, check
from facenet_tpu_torch.ops.image_ops import dense_warp as dense_warp_plain

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel('dense_warp.cu', {
    'dense_warp_launch': [_ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _i32,
                          _ptr, _ptr]})

__all__ = ['KERNEL', 'dense_warp', 'dense_warp_plain']


def dense_warp(images, matrices, out_size):
    """Bilinear affine warp with clamp-to-edge source coords.

    :param images: [N, H, W, C] float32 source crops
    :param matrices: [N, 2, 3] float32, output pixel (x, y, 1) -> source
        (x, y)
    :param out_size: (height, width) of the output
    :return: [N, oh, ow, C] float32 on the images' device

    CUDA tensors go to the kernel (counted in ``dense_warp.launches``), CPU
    tensors to `dense_warp_plain`.
    """
    oh, ow = int(out_size[0]), int(out_size[1])
    if images.device.type == 'cpu':
        return dense_warp_plain(images, matrices, (oh, ow))
    if images.device.type != 'cuda':
        raise ValueError(f'unsupported device {images.device}')
    if (images.dtype != torch.float32 or images.dim() != 4
            or images.shape[-1] < 1 or not images.is_contiguous()):
        raise ValueError('images must be a contiguous float32 [N, H, W, C] '
                         f'tensor, got {images.dtype} {tuple(images.shape)}')
    n, h, w, c = images.shape
    if (matrices.device != images.device or matrices.dtype != torch.float32
            or tuple(matrices.shape) != (n, 2, 3)
            or not matrices.is_contiguous()):
        raise ValueError(f'matrices must be a contiguous float32 [{n}, 2, 3] '
                         f'tensor on {images.device}')
    if oh < 1 or ow < 1:
        raise ValueError(f'bad output size {(oh, ow)}')

    out = torch.empty((n, oh, ow, c), dtype=torch.float32,
                      device=images.device)
    if n == 0:
        return out
    lib = KERNEL.load()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dense_warp_launch(images.data_ptr(), matrices.data_ptr(),
                                    n, h, w, c, oh, ow, out.data_ptr(),
                                    stream)
    check(err, 'dense_warp')
    dense_warp.launches += 1
    return out


dense_warp.launches = 0
