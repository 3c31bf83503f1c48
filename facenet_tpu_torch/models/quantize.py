"""Post-training int8 quantization of the fused serving path (PyTorch).

The recipe of ``facenet_tpu.models.quantize``: a `build_fast_params` tree
(BN folded, branch heads fused) becomes a tree whose conv entries carry
int8 kernels and the scales the quantized conv needs (`ops.int8_conv`):

  - symmetric per-output-channel weights, ``ws = max|k| / 127`` over every
    axis but the output channel (floor 1e-12), ``kq = clip(round(k / ws),
    -127, 127)``, computed in numpy float32 as the JAX package does;
  - one input scale a conv, ``xs = absmax / 127``, from calibration;
  - the folded bias ``b`` in float32, added after the rescale.

Calibration is one eager forward over a representative uint8 batch through
the cuDNN stem: every conv input's absolute maximum is recorded by tagging
each conv entry of a copy of the tree and letting `irv1_fast._conv` report
into the running `_Calibration`. The maxima stay on the device until the
forward ends and are read back together. The bottleneck dense stays in the
serving dtype (``skip``), as do entries with no recorded input or an input
of all zeros.

`from_jax_quantized` carries a tree that the JAX package quantized across,
so both packages' int8 forwards can be compared on identical scales.
"""

from __future__ import annotations

import numpy as np
import torch

from facenet_tpu_torch.ops.int8_conv import quantized_entry

DEFAULT_SKIP = ('Bottleneck',)


def _walk_convs(tree, path=()):
    """Yield (path tuple, entry) for every ``{'k', 'b'}`` conv entry."""
    if isinstance(tree, dict):
        if 'k' in tree and 'b' in tree:
            yield path, tree
            return
        for name, sub in tree.items():
            yield from _walk_convs(sub, path + (name,))


def _rebuild(tree, fn, path=()):
    """A copy of `tree` with every ``{'k', 'b'}`` or ``{'kq', ...}`` entry
    replaced by fn(path, entry)."""
    if isinstance(tree, dict):
        if ('k' in tree and 'b' in tree) or 'kq' in tree:
            return fn(path, tree)
        return {n: _rebuild(s, fn, path + (n,)) for n, s in tree.items()}
    return tree


class _Calibration:
    """Collector the instrumented `_conv` reports input absmax into."""

    active = None          # the running _Calibration, if any

    def __init__(self):
        self._maxima = {}

    def record(self, tag, x):
        v = x.detach().abs().amax().float()
        prev = self._maxima.get(tag)
        self._maxima[tag] = v if prev is None else torch.maximum(prev, v)

    @property
    def absmax(self):
        """{tag: absmax as a float}, read from the device in one copy."""
        if not self._maxima:
            return {}
        values = torch.stack(list(self._maxima.values())).cpu().tolist()
        return dict(zip(self._maxima, values))

    def __enter__(self):
        _Calibration.active = self
        return self

    def __exit__(self, *exc):
        _Calibration.active = None


def calibrate(params, cfg, images, image_size=160, normalization=0,
              forward=None, dtype=torch.bfloat16):
    """Per-conv input absmax over one representative batch: {tag: float},
    the tag being the entry's path joined by '/'.

    :param forward: the family's ``fast_forward`` (IRv1's by default); it
        runs with its default (cuDNN) stem
    """
    from facenet_tpu_torch.models import irv1_fast

    forward = forward or irv1_fast.fast_forward
    tagged = _rebuild(params, lambda path, w: {**w, 'tag': '/'.join(path)})
    device = next(w['b'].device for _, w in _walk_convs(params))
    images = torch.as_tensor(images).to(device)
    with torch.inference_mode(), _Calibration() as calib:
        forward(tagged, cfg, images, image_size, normalization, dtype)
    return calib.absmax


def quantize_params(params, absmax, skip=DEFAULT_SKIP):
    """Fast params + calibrated absmax -> int8 serving params.

    :param skip: top-level entries kept in the serving dtype (the embedding
        head by default; `irv1_fast.STEM_SKIP` keeps the fused stem's)
    """
    def q(path, w):
        tag = '/'.join(path)
        if path[0] in skip or absmax.get(tag, 0.0) == 0.0:
            return dict(w)
        k = w['k'].float().cpu().numpy()                  # OIHW
        wmax = np.maximum(np.abs(k).max(axis=(1, 2, 3)), 1e-12)   # [oc]
        ws = (wmax / 127.0).astype(np.float32)
        kq = np.clip(np.round(k / ws[:, None, None, None]),
                     -127, 127).astype(np.int8)
        return quantized_entry(kq, ws, np.float32(absmax[tag] / 127.0),
                               w['b'].float().cpu().numpy(), w['b'].device)

    return _rebuild(params, q)


def quantize_fast_params(params, cfg, calib_images, image_size=160,
                         normalization=0, skip=DEFAULT_SKIP, forward=None,
                         dtype=torch.bfloat16):
    """Fast-path params -> int8-serving params (see the module docstring).

    :param calib_images: uint8 [N, H, W, 3] batch for the activation ranges
    """
    absmax = calibrate(params, cfg, calib_images, image_size, normalization,
                       forward=forward, dtype=dtype)
    return quantize_params(params, absmax, skip)


def check_mode(quantize, calib_images):
    """The JAX package's errors for a quantize request it cannot serve."""
    if not quantize:
        return
    if quantize != 'int8':
        raise ValueError(f'unknown quantize mode {quantize!r}')
    if calib_images is None:
        raise ValueError('quantize="int8" needs calib_images '
                         '(a representative uint8 batch)')


def from_jax_quantized(tree, dtype=torch.bfloat16, device=None):
    """A tree quantized by ``facenet_tpu.models.quantize`` (numpy leaves:
    HWIO ``kq``, ``ws``, ``xs``, ``b``; float entries HWIO ``k``) as the
    port's serving tree."""
    from facenet_tpu_torch.device import resolve_device
    from facenet_tpu_torch.models.irv1_fast import to_torch

    device = resolve_device(device)

    def carry(path, w):
        if 'kq' not in w:
            return to_torch(w, dtype, device)
        return quantized_entry(np.transpose(np.asarray(w['kq']), (3, 2, 0, 1)),
                               w['ws'], w['xs'], w['b'], device)

    return _rebuild(tree, carry)
