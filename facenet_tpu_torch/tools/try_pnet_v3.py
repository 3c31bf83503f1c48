"""P-Net trunk on NHWC pixels (B7): kernel entry point, reference and tool.

`pnet_trunk_nhwc` is the wrapper of ``pnet_trunk_nhwc_launch`` in
``csrc/pnet_level.cu``, which replaces the prototype Pallas TPU kernel of
``tools/try_pnet_v3.py`` (``pnet_v3``): the P-Net trunk on one level given
as NHWC pixels, returning the six head outputs before any softmax. The
kernel reads the pixels through their strides, so no transpose to planes
runs before it. Its arithmetic is that of the cascade's per-level kernel
(`pnet.pnet_forward_flat`): bf16 weights and activations, float32 sums.

    python -m facenet_tpu_torch.tools.try_pnet_v3 --device cpu
        equivalence of the plain version with the float32 reference
    python -m facenet_tpu_torch.tools.try_pnet_v3
        on a CUDA device: kernel against the reference, and both timed at
        level 0 of the 480x640 pyramid (288x384, batch 16)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from facenet_tpu_torch.detectors.mtcnn import pnet
from facenet_tpu_torch.detectors.mtcnn.networks import max_pool_same
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.ops.cuda_build import check


def make_weights(rng):
    """Random trunk weights, HWIO conv kernels as numpy float32:
    (w1, b1, a1, w2, b2, a2, w3, b3, a3, wh, bh)."""
    w1 = rng.normal(0, 0.3, (3, 3, 3, 10)).astype(np.float32)
    w2 = rng.normal(0, 0.2, (3, 3, 10, 16)).astype(np.float32)
    w3 = rng.normal(0, 0.2, (3, 3, 16, 32)).astype(np.float32)
    wh = rng.normal(0, 0.3, (1, 1, 32, 6)).astype(np.float32)
    b1 = rng.normal(0, 0.1, (10,)).astype(np.float32)
    b2 = rng.normal(0, 0.1, (16,)).astype(np.float32)
    b3 = rng.normal(0, 0.1, (32,)).astype(np.float32)
    bh = rng.normal(0, 0.1, (6,)).astype(np.float32)
    a1 = rng.uniform(0.1, 0.4, (10,)).astype(np.float32)
    a2 = rng.uniform(0.1, 0.4, (16,)).astype(np.float32)
    a3 = rng.uniform(0.1, 0.4, (32,)).astype(np.float32)
    return (w1, b1, a1, w2, b2, a2, w3, b3, a3, wh, bh)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w)).permute(3, 2, 0, 1)


def pack_all(weights):
    """`make_weights` tuple -> the kernel's packed float32 vector (CPU),
    conv and head kernels rounded to bf16."""
    (w1, b1, a1, w2, b2, a2, w3, b3, a3, wh, bh) = weights
    blocks = {'w1': _oihw(w1), 'w2': _oihw(w2), 'w3': _oihw(w3),
              'wh': _oihw(wh)[:, :, 0, 0]}
    for name, value in (('b1', b1), ('a1', a1), ('b2', b2), ('a2', a2),
                        ('b3', b3), ('a3', a3), ('bh', bh)):
        blocks[name] = torch.from_numpy(value)
    return pnet.pack_arrays(blocks)


def ref_trunk(x, weights):
    """The trunk in plain PyTorch, in x's dtype throughout: NHWC
    [B, sh, sw, 3] -> [B, h3, w3, 6] head outputs (no softmax)."""
    (w1, b1, a1, w2, b2, a2, w3, b3, a3, wh, bh) = weights

    def t(a):
        return torch.from_numpy(a).to(x.device, x.dtype)

    def conv(z, w, b):
        return F.conv2d(z, _oihw(w).to(x.device, x.dtype), t(b))

    def prelu(z, a):
        a = t(a)[None, :, None, None]
        return torch.clamp(z, min=0) + a * torch.clamp(z, max=0)

    z = prelu(conv(x.permute(0, 3, 1, 2), w1, b1), a1)
    z = max_pool_same(z, 2, 2)
    z = prelu(conv(z, w2, b2), a2)
    z = prelu(conv(z, w3, b3), a3)
    return conv(z, wh, bh).permute(0, 2, 3, 1)


def pnet_trunk_nhwc(x_nhwc, packed):
    """P-Net trunk on NHWC pixels: [B, sh, sw, 3] -> [B, h3, w3, 6] float32
    head outputs (2 class logits, 4 box offsets; no softmax).

    :param x_nhwc: normalized image, any float dtype (rounded to bfloat16)
    :param packed: `pack_all` vector on x's device

    CUDA tensors go to the kernel (counted in
    ``pnet_trunk_nhwc.launches``), CPU tensors to `pnet.level_plain`.
    """
    if x_nhwc.dim() != 4 or x_nhwc.shape[3] != 3 \
            or not x_nhwc.is_floating_point():
        raise ValueError(f'expected a float [B, sh, sw, 3] tensor, got '
                         f'{x_nhwc.dtype} {tuple(x_nhwc.shape)}')
    x = x_nhwc.to(torch.bfloat16).contiguous()
    device = x.device
    if (packed.device != device or packed.dtype != torch.float32
            or tuple(packed.shape) != (pnet.N_WEIGHTS,)
            or not packed.is_contiguous()):
        raise ValueError(f'packed: expected pack_all() on {device}, got '
                         f'{packed.dtype} {tuple(packed.shape)} on '
                         f'{packed.device}')
    b, sh, sw, _ = x.shape
    gh, gw = pnet.out_geometry(sh, sw)
    if gh < 1 or gw < 1:
        raise ValueError(f'{sh}x{sw} is below the 12x12 P-Net window')
    if device.type == 'cpu':
        return pnet.level_plain(packed, x.permute(0, 3, 1, 2), raw=True)
    if device.type != 'cuda':
        raise ValueError(f'unsupported device {device}')
    heads = torch.empty(b, gh, gw, 6, dtype=torch.float32, device=device)
    lib = pnet.LEVEL_KERNEL.load()
    with torch.cuda.device(device):
        err = lib.pnet_trunk_nhwc_launch(
            x.data_ptr(), b, sh, sw, packed.data_ptr(), pnet.N_WEIGHTS,
            heads.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(err, 'pnet_trunk_nhwc')
    pnet_trunk_nhwc.launches += 1
    return heads


pnet_trunk_nhwc.launches = 0


def _rel_err(got, ref):
    return float((got - ref).abs().max() / max(float(ref.abs().max()), 1e-6))


def run_equivalence(device):
    """Kernel (plain version on the CPU) against the float32 reference at
    (40, 128), batch 2: relative error below 5e-2 (bf16 tolerance)."""
    rng = np.random.RandomState(0)
    weights = make_weights(rng)
    sh, sw = 40, 128
    x = rng.randint(0, 256, (2, sh, sw, 3)).astype(np.float32) / 128 - 1
    x = torch.from_numpy(x).to(device)
    ref = ref_trunk(x, weights)
    got = pnet_trunk_nhwc(x, pack_all(weights).to(device))
    print('ref', tuple(ref.shape), 'got', tuple(got.shape))
    err = _rel_err(got, ref)
    print(f'max rel err: {err:.2e}')
    if got.shape != ref.shape or not err < 5e-2:
        raise SystemExit('MISMATCH')
    print('EQUIVALENT (bf16 tolerance)')


def run_timing(device, batch=16, shape=(288, 384)):
    """Level-0 time of the kernel against the reference through cuDNN in
    bf16, device time."""
    from facenet_tpu_torch.utils.timing import card_line, device_ms, spread
    rng = np.random.RandomState(0)
    weights = make_weights(rng)
    x = rng.randint(0, 256, (batch,) + shape + (3,)).astype(np.float32) \
        / 128 - 1
    xb = torch.from_numpy(x).to(device, torch.bfloat16)
    packed = pack_all(weights).to(device)
    print(card_line())
    with torch.inference_mode():
        t_ref, ref_all, _ = device_ms(lambda: ref_trunk(xb, weights), 10)
        t_k, k_all, k_host = device_ms(lambda: pnet_trunk_nhwc(xb, packed),
                                       20)
        err = _rel_err(pnet_trunk_nhwc(xb, packed),
                       ref_trunk(xb.float(), weights))
    print(f'cuDNN bf16 reference: {t_ref:7.3f} ms/batch{batch} '
          f'({spread(ref_all)})')
    print(f'trunk kernel:         {t_k:7.3f} ms/batch{batch} '
          f'({spread(k_all)}; host enqueue {k_host:.3f})  '
          f'({t_ref / t_k:4.2f}x)')
    print(f'max rel err vs the float32 reference: {err:.2e}')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--device', default=None,
                        help="'cpu' runs the equivalence check on the plain "
                             'version; default: cuda (raises without one)')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    run_equivalence(device)
    if device.type == 'cuda':
        run_timing(device)


if __name__ == '__main__':
    main()
