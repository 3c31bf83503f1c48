"""Crop-and-resize of boxes: the crop kernel and its wrapper.

`crop_and_resize` is the wrapper of the CUDA kernel ``csrc/crop_resize.cu``,
which samples each output from its four taps. On a CUDA tensor it launches
the kernel, or raises; on a CPU tensor it runs `crop_and_resize_plain`
(`image_ops.crop_and_resize`, two interpolation-matrix products), the plain
PyTorch version of the same function. The cascade's R-Net and O-Net crops,
the pipeline's box crops, the landmark alignment's intermediates
(`image_ops.dense_warp_inputs`) and the Faster-RCNN's RoIAlign all go
through it.
"""

from __future__ import annotations

import ctypes

import torch

from facenet_tpu_torch.ops.cuda_build import CudaKernel, check
from facenet_tpu_torch.ops.image_ops import (
    crop_and_resize as crop_and_resize_plain)

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel('crop_resize.cu', {
    'crop_resize_launch': [_ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _i32,
                           _ptr, _ptr]})

__all__ = ['KERNEL', 'crop_and_resize', 'crop_and_resize_plain']


def crop_and_resize(images, boxes, out_size):
    """Crop boxes from a batch of images and resize to out_size x out_size
    (bilinear, pixel centres at half steps, clamp-to-edge taps).

    :param images: [B, H, W, C] of any dtype and strides (sampled in
        float32; copied only when not contiguous float32 already)
    :param boxes: [B, K, 4] pixel-coordinate (x1, y1, x2, y2) boxes
    :param out_size: output side length S
    :return: [B, K, S, S, C] float32 crops on the images' device

    CUDA tensors go to the kernel (counted in ``crop_and_resize.launches``),
    CPU tensors to `crop_and_resize_plain`. The kernel has no backward, so
    an input that requires a gradient raises under grad mode.
    """
    s = int(out_size)
    if torch.is_grad_enabled() and (images.requires_grad
                                    or boxes.requires_grad):
        raise ValueError('crop_and_resize has no backward: call it under '
                         'torch.no_grad() or on tensors without gradients')
    if images.device.type == 'cpu':
        return crop_and_resize_plain(images, boxes, s)
    if images.device.type != 'cuda':
        raise ValueError(f'unsupported device {images.device}')
    if images.dim() != 4 or images.shape[-1] < 1:
        raise ValueError('images must be [B, H, W, C], got '
                         f'{tuple(images.shape)}')
    b, h, w, c = images.shape
    if (boxes.device != images.device or boxes.dim() != 3
            or boxes.shape[0] != b or boxes.shape[2] != 4):
        raise ValueError(f'boxes must be [{b}, K, 4] on {images.device}, got '
                         f'{tuple(boxes.shape)} on {boxes.device}')
    if s < 1:
        raise ValueError(f'bad output size {s}')

    k = boxes.shape[1]
    out = torch.empty((b, k, s, s, c), dtype=torch.float32,
                      device=images.device)
    if b * k == 0:
        return out
    images = images.float().contiguous()
    boxes = boxes.float().contiguous()
    lib = KERNEL.load()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.crop_resize_launch(images.data_ptr(), boxes.data_ptr(), b,
                                     k, h, w, c, s, out.data_ptr(), stream)
    check(err, 'crop_resize')
    crop_and_resize.launches += 1
    return out


crop_and_resize.launches = 0
