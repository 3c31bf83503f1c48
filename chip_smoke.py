#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (facenet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when its check fails:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels csrc/pair_below_counts.cu, dense_warp.cu,
     pnet_pyramid.cu, pnet_level.cu and stem_fused.cu for sm_90a (one nvcc
     each, all started together);
  3. kernel vs its plain PyTorch version at N=4096/D=512 (metrics 0 and 1),
     at the main path's fold sizes N=936 and N=104 (D=512), and at
     N=1000/D=17: cumulative counts agree to rtol 1e-6, beyond the weight
     of pairs whose float64 similarity lies within 1e-6 of a cutoff
     (float32 sums in another order may put exactly those on either side);
     then the kernel's product itself (3xTF32 on the tensor cores, through
     pair_similarities) against the float64 product at N=1024, D=512 and
     D=17, pairs at s ~ 0.5 and duplicated rows included: max |s - s64| <=
     5e-7, the float32 torch.matmul's figure beside it;
  4. full-width Inception-ResNet-v1 (default config, 512-d, random weights
     from init_variables(seed=0)) served by FaceNet in bf16 at batch 128:
     finite unit-norm embeddings, min cosine >= 0.995 against the unfused
     float32 module (no TF32), and embeddings/s;
  5. the main path: FaceNet embeddings of 1,040 synthetic images (40 classes
     x 26) -> 10-fold FaceToFaceValidation on the card, with the kernel's
     launch count reset just before and read just after (30 expected: 10
     folds x one sweep + two test calls); then the card's report on
     well-separated embeddings equals the CPU report to 1e-6;
  6. at the reference validation's sweep shape (N=23,840, D=512, T=100):
     the same kernel-vs-plain check, then the times of the kernel, the
     plain version, and the float32 torch.matmul of the full N x N product
     (twice the pairs, nothing binned: a yardstick for the product alone),
     beside both bounds (the FP32 pipes; three TF32 products on the tensor
     cores, which the kernel is held to); the kernel again at T=1 (the
     test folds' call) and at D=32 (the epilogue with almost no main loop);
     then the wall time of a whole 10-fold validation at the reference
     eval size (26,489 x 512, synthetic clustered embeddings);
  7. ptxas registers, shared memory and spills of the two detection
     kernels;
  8. the dense warp (B2) kernel vs its plain version: 32 crops 240 -> 160
     with random rotations, scales and translations that push samples off
     the edge, the identity, a non-square output, one channel; bound 1e-3
     (0-255 scale);
  9. the whole-pyramid P-Net (B3) kernel vs its plain version: the
     10-level 480x640 pyramid at batch 16 and a 3-level pyramid of odd
     sizes; bounds probs 0.02, reg 0.05;
 10. the detection main path: FacePipeline (full-width IRv1 from
     init_variables(seed=0), bundled MTCNN weights, 480x640, landmark
     alignment, 2 faces per scene) on 64 synthetic scenes in batches of 16,
     with every kernel's launch count reset just before and read just
     after (4 B3, 4 B2, 0 B1 expected); finite unit-norm embeddings; then
     4 of the scenes through the same stages on the CPU, the warp by its
     plain version (cascade -> align_by_landmarks(method='dense') ->
     FaceNet): identical valid masks, boxes and landmarks within 1.5 px,
     scores within 0.02, embedding cosine >= 0.99;
 11. the bundled detector's quality gate on the card: 32 held-out
     256x256 scenes (seed 555): recall >= 0.97, precision >= 0.97, mean
     IoU >= 0.5;
 12. times with CUDA events: B3 at batch 16 x 10 levels beside its plain
     version and the cuDNN P-Net ('flax') over the same levels; B2 on the
     main path's own inputs (the 32 240x240 intermediates and matrices that
     the landmark alignment builds for a batch of 16 scenes, checked
     against the plain version first), in copies that rotate through more
     than the card's L2, beside its plain version and F.grid_sample, its
     bound counting only the source pixels the taps read (these in device
     time, each call's host enqueue time beside: a 20 us kernel launched
     back to back from Python otherwise reads the host's launch rate); the
     pipeline per batch of 16 scenes (scenes/s, embedding slots/s and
     aligned embeddings of detected faces/s) and its stages alone, host
     included; and a torch.profiler breakdown of one pipeline batch;
 13. ptxas registers, shared memory and spills of the fused stem (B5, the
     persistent kernel) and the one-level P-Net kernels (B4, B6 with its
     three weight parts, B7, and B6's accuracy probe in both summation
     orders);
 14. the fused stem (B5) kernel vs its plain version with the full-width
     IRv1's weights: batch 8 (one image of constant 0, one of 255, six of
     noise) and batch 128 of uint8 noise through image_processing; bound
     max |d| <= 0.01 max |plain| (both round to bf16 after each conv, so one
     rounding, at most 2^-7 of a value, may differ);
 15. the one-level P-Net kernels vs the plain version: B4 on planes at a
     pitch rounded up to 128 with N(0, 3) noise past the true width, B6
     with float32 weights, B7 on NHWC pixels with raw heads out, at
     (24, 100), (61, 83), (40, 129) and at level 0 of the 480x640 pyramid
     (288x384, batch 16); bounds probs 0.02, reg and raw heads 0.05; B6
     must lie nearer (mean |d| of probs and of reg) to the plain version on
     its unrounded weights than to the one on their bf16 rounding; then,
     once, B6's conv3 sums against float64 sums of the same activations
     and weights (three mma a step chained on the accumulator, summed from
     zero as B6 runs, and float32 fused multiply-adds in a CUDA-core loop's
     order);
 16. this slice's main paths, every launch count reset just before each
     and read just after: (a) FastEmbedder(stem='fused'), full-width IRv1,
     4 batches of 128 (exactly 4 B5 launches; finite unit-norm embeddings;
     min cosine >= 0.999 against stem='cudnn'); (b) the cascade with
     pnet_impl='flat' through FaceDetector at 480x640 on phase 10's 64
     scenes in batches of 16 (exactly 40 B4 launches, no B3; the same valid
     masks as the 'pyramid' cascade, boxes and landmarks within 1.5 px,
     scores within 0.02); (c) the B6 tool and (d) the B7 tool, each
     through its main();
 17. times (device time, host enqueue beside): B5 per 128 images, rotating
     through inputs larger than the L2, beside its plain version and the
     cuDNN prefix (F.conv2d x3 + F.max_pool2d), with its schedule's shared
     loads per mma and weight bytes staged per image against the design it
     replaced; serving per 128 under each
     stem in turns (cudnn, fused, fused, cudnn), as the host issues it and
     as the device's busy time under torch.profiler; B4, B6 and B7 at level 0,
     batch 16, beside the plain version, the cuDNN P-Net on that level and
     the whole-pyramid kernel's share for that level's operations, and B6's
     bound at three bf16 mma a multiply-add; the
     cascade alone under 'flax', 'flat' and 'pyramid', host included and
     as the device's busy time.

The line before the last is the JSON list of kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import sys
import time

import numpy as np

H100_FP32_FLOPS = 67e12     # FP32 outside the tensor cores, H100 SXM
H100_BF16_FLOPS = 989e12    # dense bf16 tensor cores, H100 SXM
H100_TF32_FLOPS = 495e12    # dense TF32 tensor cores, H100 SXM
H100_HBM_BYTES = 3.35e12    # HBM3 bytes/s, H100 SXM
SCENE = (480, 640)          # the cascade's default geometry
ROTATE = 6                  # B2 input copies: 6 x 22 MB, past the 50 MB L2


class SmokeFailure(Exception):
    pass


def require(condition, message):
    if not condition:
        raise SmokeFailure(message)


def clustered(rng, n_classes, per_class, dim, spread):
    """Unit-norm float32 embeddings around random unit class centres; the
    noise has norm about `spread`."""
    centres = rng.standard_normal((n_classes, dim))
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    labels = np.repeat(np.arange(n_classes), per_class)
    noise = rng.standard_normal((labels.size, dim)) / np.sqrt(dim)
    emb = centres[labels] + spread * noise
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb.astype(np.float32), labels


def compare_kernel_plain(pair_counts, inputs, label):
    """Kernel vs plain cumulative counts on prepared inputs; returns the max
    abs difference. Rows of the float64 reference go in chunks, so the
    check runs at the full validation size too."""
    import torch
    kern = pair_counts.pair_histogram(inputs)
    torch.cuda.synchronize()
    plain = pair_counts.pair_histogram_plain(inputs)
    torch.cuda.synchronize()
    kern_cum, plain_cum = kern.cumsum(1), plain.cumsum(1)

    # weight of the pairs a float32 rounding may put on either side of c_k
    e64 = inputs.embeddings.double()
    lab = inputs.labels
    cut64 = inputs.cutoffs.double()
    t = cut64.numel()
    n = e64.shape[0]
    allowed = torch.zeros(2, t + 1, dtype=torch.float64, device='cuda')
    for start in range(0, n, 2048):
        stop = min(start + 2048, n)
        sims = torch.clamp(e64[start:stop] @ e64.T, -1.0, 1.0)
        rows = torch.arange(start, stop, device='cuda')[:, None]
        upper = rows < torch.arange(n, device='cuda')[None, :]
        pos = lab[start:stop, None] == lab[None, :]
        w_pos = torch.where(pos & upper, inputs.w_pos[start:stop, None], 0.0)
        w_neg = torch.where(~pos & upper, inputs.inv_n[start:stop, None]
                            * inputs.inv_n[None, :], 0.0)
        for k in range(t):
            near = (sims - cut64[k]).abs() <= 1e-6
            allowed[0, k] += (w_pos * near).sum()
            allowed[1, k] += (w_neg * near).sum()
    diff = (kern_cum - plain_cum).abs()
    limit = allowed + 1e-6 * plain_cum.abs() + 1e-12
    require(not bool((diff > limit).any()),
            f'kernel != plain ({label}): max excess '
            f'{float((diff - limit).max()):.3e}')
    ambiguous = int((allowed[:, :t] > 0).sum())
    err = float(diff.max())
    print(f'  N={n} D={e64.shape[1]} {label}: max |kernel-plain| {err:.3e}, total pos '
          f'{float(plain_cum[0, -1]):.6f} neg {float(plain_cum[1, -1]):.6f}, '
          f'{ambiguous} (side, cutoff) cells with pairs within 1e-6')
    return err


def prepared(pair_counts, emb, labels, metric, t=100):
    """Kernel inputs on the card for FaceToFaceValidation's threshold grid."""
    import torch
    hi = 4.0 if metric == 0 else np.pi
    return pair_counts.prepare(torch.from_numpy(emb).cuda(), labels,
                               np.linspace(0, hi, t), metric)


def pair_split_times(pair_counts, emb, labels, t=100):
    """B1's time (ms, device) on unit-norm `emb` at three shapes that split
    it between main loop and epilogue: (D, T) as given; (D, 1), the test
    folds' call, where every pair lands on one of two bins; (32, T), the
    epilogue with almost no main loop. Returns {label: (median, windows)}."""
    import torch

    from facenet_tpu_torch.utils.timing import cuda_ms
    narrow = emb[:, :32] / np.linalg.norm(emb[:, :32], axis=1, keepdims=True)
    cases = {
        f'D={emb.shape[1]} T={t}': prepared(pair_counts, emb, labels, 0, t),
        f'D={emb.shape[1]} T=1': pair_counts.prepare(
            torch.from_numpy(emb).cuda(), labels, np.array([1.0]), 0),
        f'D=32 T={t}': prepared(pair_counts, narrow.astype(np.float32),
                                labels, 0, t)}
    return {label: cuda_ms(lambda: pair_counts.pair_histogram(inputs), reps=5)
            for label, inputs in cases.items()}


def synthetic_batches(rng, n_classes, per_class, batch, size=160):
    """uint8 face-sized images, class base image + noise, in batches."""
    base = rng.integers(0, 256, (n_classes, size, size, 3)).astype(np.float32)
    labels = np.repeat(np.arange(n_classes), per_class).astype(np.int32)
    for start in range(0, labels.size, batch):
        lab = labels[start:start + batch]
        noise = rng.standard_normal((lab.size, size, size, 3), np.float32)
        yield (np.clip(base[lab] + 8.0 * noise, 0, 255).astype(np.uint8),
               lab)


def print_ptxas(lib):
    for line in lib.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'smem' in line:
            print('  ptxas:', line.strip())


def _launch_counters():
    from facenet_tpu_torch.detectors.mtcnn import pnet
    from facenet_tpu_torch.ops import pair_counts, stem, warp
    from facenet_tpu_torch.tools import try_pnet_v3
    return {'pair_below_counts': pair_counts.pair_histogram,
            'dense_warp': warp.dense_warp,
            'pnet_pyramid': pnet.pnet_forward_pyramid,
            'stem_fused': stem.stem_forward,
            'pnet_flat': pnet.pnet_forward_flat,
            'pnet_level': pnet.pnet_forward_level,
            'pnet_trunk_nhwc': try_pnet_v3.pnet_trunk_nhwc}


def reset_launches():
    for fn in _launch_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _launch_counters().items()}


def only(**launches):
    """The launch counts of a path that ran these kernels and no other."""
    return {name: launches.get(name, 0) for name in _launch_counters()}


def warp_cases(rng):
    """(label, source [N, H, W, 3], matrices [N, 2, 3], out size) on the
    card; the 32 random similarity warps push samples off every edge."""
    import torch
    n, t = 32, 240
    src = rng.uniform(0, 255, (n, t, t, 3)).astype(np.float32)
    th = rng.uniform(-0.7, 0.7, n)
    sc = rng.uniform(0.7, 2.0, n)
    m = np.zeros((n, 2, 3), np.float32)
    m[:, 0, 0] = m[:, 1, 1] = sc * np.cos(th)
    m[:, 0, 1] = -sc * np.sin(th)
    m[:, 1, 0] = sc * np.sin(th)
    m[:, :, 2] = rng.uniform(-80, 160, (n, 2))
    src_t = torch.from_numpy(src).cuda()
    mats = torch.from_numpy(m).cuda()
    eye = torch.eye(2, 3).repeat(4, 1, 1).cuda()
    return [('32 crops 240->160', src_t, mats, (160, 160)),
            ('identity 240->240', src_t[:4].contiguous(), eye, (240, 240)),
            ('non-square 240->96x200', src_t[:8].contiguous(),
             mats[:8].contiguous(), (96, 200)),
            ('1 channel 240->160', src_t[:8, ..., :1].contiguous(),
             mats[:8].contiguous(), (160, 160))]


def _warp_coords(mats, size):
    """Unclamped source coords (sx, sy) [N, oh, ow] of every output pixel,
    rounded as the B2 kernel rounds them."""
    import torch
    ys, xs = torch.meshgrid(
        torch.arange(size[0], dtype=torch.float32, device=mats.device),
        torch.arange(size[1], dtype=torch.float32, device=mats.device),
        indexing='ij')
    m = mats[:, :, :, None, None]
    return (m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2],
            m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2])


def off_edge_share(mats, size, t):
    """Share of output pixels whose source lies outside [0, t - 1]."""
    sx, sy = _warp_coords(mats, size)
    return float(((sx < 0) | (sx > t - 1) | (sy < 0) | (sy > t - 1))
                 .float().mean())


def warp_touched_pixels(mats, size, h, w):
    """Source pixels, summed over the crops, that some output pixel's
    two-tap sample reads with a nonzero weight: what the warp must read."""
    import torch
    sx, sy = _warp_coords(mats, size)
    sx, sy = sx.clamp(0, w - 1), sy.clamp(0, h - 1)
    x0, y0 = sx.floor(), sy.floor()
    wx, wy = sx - x0, sy - y0
    base = torch.arange(mats.shape[0], device=mats.device)[:, None, None] * h * w
    touched = torch.zeros(mats.shape[0] * h * w, dtype=torch.bool,
                          device=mats.device)
    for yi, ty in ((y0, None), (y0 + 1, wy)):
        for xi, tx in ((x0, None), (x0 + 1, wx)):
            keep = torch.ones_like(wx, dtype=torch.bool)
            if ty is not None:
                keep &= ty > 0
            if tx is not None:
                keep &= tx > 0
            touched[(base + yi.long() * w + xi.long())[keep]] = True
    return int(touched.sum())


def rotating(fn, args):
    """fn over the argument tuples in turn, one tuple per call."""
    cycle = itertools.cycle(args)
    return lambda: fn(*next(cycle))


def pnet_work(levels):
    """(flops, bytes) of the P-Net over these levels: multiply-adds of
    the three convs and the heads (x2), inputs read once, heads written
    once, weights read once."""
    from facenet_tpu_torch.detectors.mtcnn import pnet
    flops = nbytes = 0
    for level in levels:
        b, _, sh, sw = level.shape
        h1, w1 = sh - 2, sw - 2
        hp, wp = -(-h1 // 2), -(-w1 // 2)
        gh, gw = pnet.out_geometry(sh, sw)
        macs = (h1 * w1 * 10 * 27 + (hp - 2) * (wp - 2) * 16 * 90
                + gh * gw * (32 * 144 + 6 * 32))
        flops += 2 * b * macs
        nbytes += b * (3 * sh * sw * 2 + gh * gw * 5 * 4)
    return flops, nbytes + pnet.N_WEIGHTS * 4


def compare_pnet(pnet, net, levels, label):
    """Kernel vs plain heads on the same levels; returns the max abs
    differences (probs, reg)."""
    import torch
    kern = pnet.pnet_forward_pyramid(net, levels)
    torch.cuda.synchronize()
    plain = pnet.pnet_forward_pyramid_plain(net, levels)
    dp = max(float((a - b).abs().max()) for (a, _), (b, _) in zip(kern, plain))
    dr = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(kern, plain))
    shapes = ' '.join(f'{lv.shape[2]}x{lv.shape[3]}' for lv in levels)
    print(f'  {label} (batch {levels[0].shape[0]}; {shapes}): max |kernel - '
          f'plain| probs {dp:.3e} reg {dr:.3e}')
    require(dp < 0.02 and dr < 0.05,
            f'pnet_pyramid kernel != plain ({label}): {dp} {dr}')
    return dp, dr


def device_breakdown(fn, top=12):
    """torch.profiler over one call of fn(): kernel time by name and the
    device's busy share of the call's wall time."""
    from facenet_tpu_torch.utils.timing import device_busy
    busy_ms, wall_ms, rows = device_busy(fn)
    if busy_ms <= 0:
        print('  profiler: no device time recorded (not measured)')
        return
    print(f'  profiler: {len(rows)} kernel names, device busy '
          f'{busy_ms:.3f} ms of {wall_ms:.3f} ms wall '
          f'({busy_ms / wall_ms:.3f} busy share)')
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f'    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} '
              f'{e.key[:90]}')


def detection_phases(rng, libs, bundle):
    """Phases 7-12 (see the module docstring) with the full-width IRv1
    `bundle`; returns the kernels-line entries of B3 and B2, and what the
    later phases reuse: the 64 scenes, the 'pyramid' cascade, the pyramid
    levels of the first 16 scenes and B3's time on them."""
    import torch
    import torch.nn.functional as F

    from facenet_tpu_torch import FaceNet
    from facenet_tpu_torch.detectors import evaluation
    from facenet_tpu_torch.detectors.face_detector import FaceDetector
    from facenet_tpu_torch.detectors.mtcnn import pnet
    from facenet_tpu_torch.detectors.mtcnn.networks import normalize_crops
    from facenet_tpu_torch.ops import warp
    from facenet_tpu_torch.ops.image_ops import (align_by_landmarks,
                                                 dense_warp_inputs)
    from facenet_tpu_torch.pipeline import FacePipeline
    from facenet_tpu_torch.utils.synthetic import render_scene
    from facenet_tpu_torch.utils.timing import cuda_ms, device_ms
    from facenet_tpu_torch.utils.timing import spread as _spread

    # 7. the detection kernels' build report
    print('[7] ptxas of the detection kernels')
    for name in ('dense_warp', 'pnet_pyramid'):
        print(f'  {name}:')
        print_ptxas(libs[name])

    # 8. B2 kernel vs plain
    print('[8] dense_warp kernel vs plain')
    cases = warp_cases(rng)
    warp_errs = []
    for label, src, mats, size in cases:
        kern = warp.dense_warp(src, mats, size)
        torch.cuda.synchronize()
        plain = warp.dense_warp_plain(src, mats, size)
        err = float((kern - plain).abs().max())
        warp_errs.append(err)
        print(f'  {label}: max |kernel - plain| {err:.3e}, '
              f'{off_edge_share(mats, size, src.shape[1]):.3f} of samples '
              'off the edge')
        require(err < 1e-3, f'dense_warp kernel != plain ({label}): {err}')

    # 9. B3 kernel vs plain
    print('[9] pnet_pyramid kernel vs plain')
    scene_rng = np.random.RandomState(2)
    scenes = [render_scene(scene_rng, shape=SCENE,
                           n_faces=scene_rng.randint(1, 4), min_face=40,
                           max_face=200) for _ in range(64)]
    images = np.stack([scene[0] for scene in scenes])
    truth = [scene[1] for scene in scenes]
    facenet = FaceNet(bundle, device='cuda')
    pipe = FacePipeline(facenet, image_shape=SCENE, align='landmarks',
                        num_faces=2)
    det = pipe.backend
    batch = torch.from_numpy(images[:16]).cuda()
    with torch.inference_mode():
        levels = det.pyramid_levels(
            normalize_crops(batch.float()).to(torch.bfloat16))
    pnet_errs = list(compare_pnet(pnet, det.pnet, levels,
                                  f'{len(levels)}-level {SCENE} pyramid'))
    odd = [torch.from_numpy(rng.integers(0, 256, (3, 3, sh, sw))
                            .astype(np.float32)).cuda() for sh, sw in
           ((41, 57), (29, 39), (14, 18))]
    odd = [normalize_crops(x).to(torch.bfloat16).contiguous() for x in odd]
    pnet_errs += compare_pnet(pnet, det.pnet, odd, '3-level odd pyramid')

    # 10. the detection main path
    print('[10] main path: FacePipeline (MTCNN -> landmark warp -> IRv1), '
          '64 scenes in batches of 16 (cuda)')
    reset_launches()
    t0 = time.monotonic()
    outs = [pipe.process_batch(images[i:i + 16]) for i in range(0, 64, 16)]
    path_s = time.monotonic() - t0
    counts = read_launches()
    print(f'  {path_s:.2f} s, kernel launches {counts}')
    require(counts == only(dense_warp=4, pnet_pyramid=4),
            f'expected 4 pnet_pyramid and 4 dense_warp launches, got {counts}')
    valid = np.concatenate([o['valid'] for o in outs])
    emb = np.concatenate([o['embeddings'] for o in outs])
    boxes = np.concatenate([o['boxes'] for o in outs])
    require(emb.shape == (64, 2, 512), f'bad embeddings {emb.shape}')
    norms = np.linalg.norm(emb[valid], axis=-1)
    require(np.isfinite(emb[valid]).all() and np.abs(norms - 1).max() < 1e-5,
            'valid embeddings are not finite and unit-norm')
    matched = sum(evaluation.match_detections(gt, b[v])[0]
                  for gt, b, v in zip(truth, boxes, valid))
    findable = sum(min(len(gt), 2) for gt in truth)
    print(f'  {int(valid.sum())} valid faces in 64 scenes; {matched} of '
          f'{findable} ground-truth faces (at most 2 a scene) matched at '
          'IoU 0.5')
    require(valid[:, 0].mean() >= 0.75, 'most scenes gave no detection')

    # the same stages on the CPU, the warp through its plain version
    t0 = time.monotonic()
    cpu_det = FaceDetector(image_shape=SCENE, device='cpu').backend_for(SCENE)
    with torch.inference_mode():
        x = torch.from_numpy(images[:4])
        found = cpu_det._detect(x)
        crops = align_by_landmarks(x.float(), found['landmarks'][:, :2], 160,
                                   method='dense')
        ref_emb = FaceNet(bundle, device='cpu').dispatch(
            torch.clamp(crops + 0.5, 0, 255).to(torch.uint8)
            .reshape(8, 160, 160, 3)).reshape(4, 2, -1)
    ref = {k: found[k][:, :2].numpy()
           for k in ('valid', 'boxes', 'landmarks', 'scores')}
    ref['embeddings'] = ref_emb.numpy()
    card = {k: v[:4] for k, v in outs[0].items()}
    v = ref['valid']
    require(np.array_equal(card['valid'], v), 'valid masks differ from CPU')
    d_box = float(np.abs(card['boxes'][v] - ref['boxes'][v]).max())
    d_lmk = float(np.abs(card['landmarks'][v] - ref['landmarks'][v]).max())
    d_score = float(np.abs(card['scores'][v] - ref['scores'][v]).max())
    cos = (card['embeddings'][v] * ref['embeddings'][v]).sum(-1)
    print(f'  card vs CPU (plain versions), 4 scenes, {v.sum()} valid, '
          f'{time.monotonic() - t0:.1f} s on the CPU: boxes {d_box:.3e} px, '
          f'landmarks {d_lmk:.3e} px, scores {d_score:.3e}, min cosine '
          f'{cos.min():.6f}')
    require(d_box < 1.5 and d_lmk < 1.5 and d_score < 0.02
            and cos.min() >= 0.99, 'card pipeline != CPU pipeline')

    # 11. the detector's quality gate on the card
    print('[11] bundled MTCNN quality gate (32 held-out 256x256 scenes)')
    gate_rng = np.random.RandomState(555)
    held = [render_scene(gate_rng, shape=(256, 256),
                         n_faces=gate_rng.randint(1, 4), min_face=32,
                         max_face=160) for _ in range(32)]
    m = evaluation.evaluate_detector(
        FaceDetector(image_shape=(256, 256), device='cuda'),
        [h[0] for h in held], [h[1] for h in held], iou_threshold=0.5,
        batch_size=16)
    print('  ' + ' '.join(f'{k}={v:.4f}' if isinstance(v, float) else
                          f'{k}={v}' for k, v in m.items()))
    require(m['recall'] >= 0.97 and m['precision'] >= 0.97
            and m['mean_iou'] >= 0.5, f'quality gate failed: {m}')

    # 12. times
    print('[12] times (CUDA events; median of 3 windows; kernels and their '
          'yardsticks in device time, host enqueue per call beside)')
    with torch.inference_mode():
        b3_ms, b3_all, b3_host = device_ms(
            lambda: pnet.pnet_forward_pyramid(det.pnet, levels), 20)
        b3_plain, b3_plain_all, b3_plain_host = device_ms(
            lambda: pnet.pnet_forward_pyramid_plain(det.pnet, levels), 5)
        b3_lib, b3_lib_all, b3_lib_host = device_ms(
            lambda: [det.pnet.forward_nchw(lv) for lv in levels], 10)
    flops, nbytes = pnet_work(levels)
    b3_ops, b3_bytes = (flops / H100_BF16_FLOPS * 1e3,
                        nbytes / H100_HBM_BYTES * 1e3)
    b3_bound = max(b3_ops, b3_bytes)
    print(f'  pnet_pyramid, batch 16 x {len(levels)} levels: kernel '
          f'{b3_ms:.4f} ms ({_spread(b3_all)}; host {b3_host:.4f}), plain '
          f'{b3_plain:.4f} ms ({_spread(b3_plain_all)}; host '
          f'{b3_plain_host:.4f}), cuDNN P-Net {b3_lib:.4f} ms '
          f'({_spread(b3_lib_all)}; host {b3_lib_host:.4f}), bound '
          f'{b3_bound:.4f} ms ({flops:.4e} flop, {nbytes:.4e} bytes)')

    # B2 on the main path's own inputs: what the landmark alignment hands
    # the warp for one batch of 16 scenes
    scenes16 = torch.from_numpy(images[16:32]).cuda()
    size = (160, 160)
    with torch.inference_mode():
        lmk = det._detect(scenes16)['landmarks'][:, :2]
        src, mats = dense_warp_inputs(scenes16.float(), lmk, size[0])
    n, t, c = src.shape[0], src.shape[1], src.shape[-1]
    err = float((warp.dense_warp(src, mats, size)
                 - warp.dense_warp_plain(src, mats, size)).abs().max())
    warp_errs.append(err)
    require(err < 1e-3, f'dense_warp kernel != plain (main path): {err}')
    touched = warp_touched_pixels(mats, size, t, t)
    sx, sy = _warp_coords(mats, size)
    grid = torch.stack([2 * sx / (t - 1) - 1, 2 * sy / (t - 1) - 1], -1)
    copies = [(src.clone(), mats.clone()) for _ in range(ROTATE)]
    lib_copies = [(s.permute(0, 3, 1, 2).contiguous(), grid.clone())
                  for s, _ in copies]

    def grid_sample(src_nchw, grid):
        return F.grid_sample(src_nchw, grid, mode='bilinear',
                             padding_mode='border', align_corners=True)

    lib_err = float((grid_sample(*lib_copies[0]).permute(0, 2, 3, 1)
                     - warp.dense_warp(src, mats, size)).abs().max())
    b2_ms, b2_all, b2_host = device_ms(
        rotating(lambda s, m: warp.dense_warp(s, m, size), copies), 60, 6)
    b2_plain, b2_plain_all, b2_plain_host = device_ms(
        rotating(lambda s, m: warp.dense_warp_plain(s, m, size), copies), 6)
    b2_lib, b2_lib_all, b2_lib_host = device_ms(
        rotating(grid_sample, lib_copies), 60, 6)
    b2_bytes_n = (touched * c + mats.numel() + n * size[0] * size[1] * c) * 4
    b2_flops = n * size[0] * size[1] * (8 + 9 * c)
    b2_ops, b2_bytes = (b2_flops / H100_FP32_FLOPS * 1e3,
                        b2_bytes_n / H100_HBM_BYTES * 1e3)
    b2_bound = max(b2_ops, b2_bytes)
    print(f'  dense_warp, main-path inputs ({n} crops {t}->{size[0]}, '
          f'{off_edge_share(mats, size, t):.3f} of samples off the edge, '
          f'{touched / src[..., 0].numel():.3f} of source pixels read, max '
          f'|kernel - plain| {err:.3e}; {ROTATE} rotating copies, '
          f'{ROTATE * src.numel() * 4 / 1e6:.0f} MB of sources): kernel '
          f'{b2_ms:.4f} ms ({_spread(b2_all)}; host {b2_host:.4f}), plain '
          f'{b2_plain:.4f} ms ({_spread(b2_plain_all)}; host '
          f'{b2_plain_host:.4f}), grid_sample {b2_lib:.4f} ms '
          f'({_spread(b2_lib_all)}; host {b2_lib_host:.4f}; max |grid_sample '
          f'- kernel| {lib_err:.3e}), bound {b2_bound:.4f} ms '
          f'({b2_bytes_n:.4e} bytes)')
    del copies, lib_copies

    pipe_ms, pipe_all = cuda_ms(lambda: pipe.dispatch(scenes16), 5, 2)
    faces16 = int(pipe.dispatch(scenes16)['valid'].sum())
    t0 = time.perf_counter()
    for _ in range(5):
        pipe.dispatch(scenes16)
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.synchronize()
    cascade_ms, cascade_all = cuda_ms(lambda: det._detect(scenes16), 5, 2)
    with torch.inference_mode():
        base = normalize_crops(scenes16.float()).to(torch.bfloat16)
        pyramid_ms, _ = cuda_ms(lambda: det.pyramid_levels(base), 10, 2)
        f32 = scenes16.float()
        align_ms, _ = cuda_ms(lambda: align_by_landmarks(f32, lmk, 160), 10, 2)
        crops = torch.clamp(align_by_landmarks(f32, lmk, 160) + 0.5, 0, 255) \
            .to(torch.uint8).reshape(32, 160, 160, 3)
    embed_ms, _ = cuda_ms(lambda: facenet.dispatch(crops), 10, 2)
    print(f'  pipeline, batch of 16 {SCENE} scenes, 2 faces each: '
          f'{pipe_ms:.3f} ms ({_spread(pipe_all)}) = '
          f'{16e3 / pipe_ms:.1f} scenes/s = {32e3 / pipe_ms:.1f} embedding '
          f'slots/s; {faces16} of the 32 slots are detected faces = '
          f'{faces16 * 1e3 / pipe_ms:.1f} aligned embeddings of detected '
          f'faces/s; host enqueue {host_ms:.3f} ms per batch')
    print(f'  stages alone: cascade {cascade_ms:.3f} ms '
          f'({_spread(cascade_all)}) [pyramid resize {pyramid_ms:.3f}, '
          f'P-Net kernel {b3_ms:.3f}], landmark alignment {align_ms:.3f} ms, '
          f'IRv1 embedding of 32 crops {embed_ms:.3f} ms')
    device_breakdown(lambda: pipe.dispatch(scenes16))

    context = {'images': images, 'det': det, 'levels': levels,
               'pyramid_ms': b3_ms}
    return context, [{
        'name': 'pnet_pyramid',
        'route': 'cuda',
        'source': 'facenet_tpu_torch/csrc/pnet_pyramid.cu',
        'replaces': 'facenet_tpu/detectors/mtcnn/pallas_pnet.py:658',
        'launches': counts['pnet_pyramid'],
        'max_abs_err': max(pnet_errs),
        'ms': b3_ms,
        'plain_ms': b3_plain,
        'bound_ms': b3_bound,
        'bound_by': 'operations' if b3_ops >= b3_bytes else 'bytes',
        'library_ms': b3_lib,
    }, {
        'name': 'dense_warp',
        'route': 'cuda',
        'source': 'facenet_tpu_torch/csrc/dense_warp.cu',
        'replaces': 'facenet_tpu/ops/pallas_warp.py:45',
        'launches': counts['dense_warp'],
        'max_abs_err': max(warp_errs),
        'ms': b2_ms,
        'plain_ms': b2_plain,
        'bound_ms': b2_bound,
        'bound_by': 'operations' if b2_ops >= b2_bytes else 'bytes',
        'library_ms': b2_lib,
    }]


def stem_work(batch):
    """(flops, bytes) of the stem prefix on `batch` 160x160 images: the
    multiply-adds of the three convs (x2); images read once, pooled maps
    written once (bf16), packed weights read once."""
    from facenet_tpu_torch.ops import stem
    macs = 79 * 79 * 48 * 32 + 77 * 77 * 288 * 32 + 75 * 75 * 288 * 64
    nbytes = (batch * (160 * 160 * 3 + 37 * 37 * 64) + stem.N_HALFS) * 2
    return 2 * batch * macs, nbytes


# B5's three convs on an 8x8 pooled tile: (cells a side, depth steps of
# 16, output channels, shared loads of one cell tile's A fragment a step)
STEM_CONVS = ((21, 3, 32, 4), (19, 18, 32, 2), (17, 18, 64, 2))
# the design B5 replaced: one block per (image, tile), one 16-cell tile x
# 32 channels a warp's item
STEM_SCHEDULE_PER_TILE = ((1, 4), (1, 4), (1, 4))


def stem_fragment_loads(schedule, conv2b_tail=True):
    """(shared-memory fragment loads, mma) per 8x8 tile of a B5 schedule,
    (cell tiles MT, column tiles NT) of a warp's item per conv as
    `stem.SCHEDULE`; a weight fragment is one load a column tile and step.
    With `conv2b_tail`, conv2b's rows past its whole rounds of items on 8
    warps run as 1 x NT items, as csrc/stem_fused.cu does."""
    loads = mmas = 0
    for i, ((side, steps, channels, a_loads), (mt, nt)) in enumerate(
            zip(STEM_CONVS, schedule)):
        rows = side * side
        parts = [(rows, mt)]
        if conv2b_tail and i == len(STEM_CONVS) - 1:
            whole = rows - rows % (8 // (channels // (8 * nt)) * 16 * mt)
            parts = [(whole, mt), (rows - whole, 1)]
        for part_rows, part_mt in parts:
            items = (-(-part_rows // (16 * part_mt))
                     * (channels // (8 * nt)))
            loads += items * steps * (part_mt * a_loads + nt)
            mmas += items * steps * part_mt * nt
    return loads, mmas


def stem_schedule_line(sms):
    """B5's shared fragment loads per mma and weight bytes staged per image
    at batch 128 on `sms` SMs, beside the design it replaced."""
    from facenet_tpu_torch.ops import stem
    weight_bytes = stem.N_HALFS * 2
    ratio = ['{:.3f} ({} loads, {} mma a tile)'.format(loads / mmas, loads,
                                                       mmas)
             for loads, mmas in (stem_fragment_loads(stem.SCHEDULE),
                                 stem_fragment_loads(STEM_SCHEDULE_PER_TILE,
                                                     False))]
    return (f'  stem_fused schedule: shared fragment loads per mma '
            f'{ratio[0]} (one block per tile and one cell tile an item: '
            f'{ratio[1]}); weight bytes staged per image at batch 128 on '
            f'{sms} SMs {stem.launch_blocks(128, sms) * weight_bytes / 128:.1f}'
            f' (staged by every block of that design: '
            f'{stem.TILES ** 2 * weight_bytes})')


def flat_planes(rng, level, pitch):
    """A [B, 3, sh, sw] bf16 level as planes [B, 3, sh * pitch] with N(0, 3)
    noise in the columns past sw."""
    import torch
    b, _, sh, sw = level.shape
    pad = torch.from_numpy(rng.normal(0, 3, (b, 3, sh, pitch))
                           .astype(np.float32)).to(level.device,
                                                   torch.bfloat16)
    pad[..., :sw] = level
    return pad.reshape(b, 3, sh * pitch)


def compare_level_kernels(rng, net, level, label):
    """B4, B6 and B7 against the plain version on one level; returns the
    max abs differences {kernel name: worst of its outputs}."""
    import torch

    from facenet_tpu_torch.detectors.mtcnn import pnet
    from facenet_tpu_torch.tools import try_pnet_v3
    b, _, sh, sw = level.shape
    pitch = -(-sw // 128) * 128
    rounded = pnet.packed_weights(net, level.device)
    unrounded = pnet.pack_level_weights(net).to(level.device)
    p4, r4 = pnet.pnet_forward_flat(net, flat_planes(rng, level, pitch), sh,
                                    pitch, sw)
    p6, r6 = pnet.pnet_forward_level(unrounded, level)
    z7 = try_pnet_v3.pnet_trunk_nhwc(level.permute(0, 2, 3, 1).contiguous(),
                                     rounded)
    torch.cuda.synchronize()
    pw, rw = pnet.level_plain(rounded, level)
    pu, ru = pnet.level_plain(unrounded, level)
    zw = pnet.level_plain(rounded, level, raw=True)

    def diff(a, b, reduce=torch.amax):
        require(a.shape == b.shape, f'{label}: shapes {a.shape} {b.shape}')
        return float(reduce((a - b).abs()))

    errs = {'pnet_flat': (diff(p4, pw), diff(r4, rw)),
            'pnet_level': (diff(p6, pu), diff(r6, ru)),
            'pnet_trunk_nhwc': (0.0, diff(z7, zw))}
    # B6 against the plain version on its unrounded weights and on their
    # bf16 rounding (what the hi part alone computes): mean |d|
    means = {name: (diff(p6, p, torch.mean), diff(r6, r, torch.mean))
             for name, (p, r) in (('unrounded', (pu, ru)),
                                  ('rounded', (pw, rw)))}
    print(f'  {label} (batch {b}, {sh}x{sw}, pitch {pitch}): max |kernel - '
          'plain| ' + ', '.join(f'{k} probs {p:.3e} reg/raw {r:.3e}'
                                for k, (p, r) in errs.items())
          + '; pnet_level mean |d| probs/reg to the unrounded plain '
          '{:.3e}/{:.3e}, to the rounded one {:.3e}/{:.3e}'.format(
              *means['unrounded'], *means['rounded']))
    for name, (dp, dr) in errs.items():
        require(dp < 0.02 and dr < 0.05,
                f'{name} kernel != plain ({label}): {dp} {dr}')
    require(all(u < r for u, r in zip(means['unrounded'], means['rounded'])),
            f'pnet_level is not nearer to its unrounded weights ({label}): '
            f'{means}')
    return {name: max(pair) for name, pair in errs.items()}


def slice3_phases(rng, libs, context):
    """Phases 13-17 (see the module docstring); returns the kernels-line
    entries of B5, B4, B6 and B7."""
    import torch

    from facenet_tpu_torch.detectors.face_detector import FaceDetector
    from facenet_tpu_torch.detectors.mtcnn import pnet
    from facenet_tpu_torch.models import irv1_fast
    from facenet_tpu_torch.ops import stem
    from facenet_tpu_torch.ops.preprocessing import image_processing
    from facenet_tpu_torch.tools import try_pallas_pnet, try_pnet_v3
    from facenet_tpu_torch.utils.timing import (cuda_ms, device_busy,
                                                 device_ms)
    from facenet_tpu_torch.utils.timing import spread as _spread

    smi = context['smi']
    images, det, levels = context['images'], context['det'], context['levels']

    # 13. the new kernels' build report
    print('[13] ptxas of the fused stem and the one-level P-Net kernels')
    for name in ('stem_fused', 'pnet_level'):
        print(f'  {name}:')
        print_ptxas(libs[name])

    # 14. B5 kernel vs plain, full-width weights
    print('[14] stem_fused kernel vs plain')
    fused = irv1_fast.FastEmbedder(context['variables'], device='cuda',
                                   stem='fused')
    cudnn = irv1_fast.FastEmbedder(context['variables'], device='cuda',
                                   stem='cudnn')
    params = fused.params
    stem_errs = []
    for batch in (8, 128):
        raw = rng.integers(0, 256, (batch, 160, 160, 3), dtype=np.uint8)
        if batch == 8:
            raw[0], raw[1] = 0, 255
        with torch.inference_mode():
            x = image_processing(torch.from_numpy(raw).cuda(), 160, 0,
                                 dtype=torch.bfloat16)
            got = stem.stem_forward(params, x)
            torch.cuda.synchronize()
            want = stem.stem_forward_plain(params, x)
        require(tuple(got.shape) == (batch, 64, 37, 37)
                and got.dtype == torch.bfloat16
                and got.is_contiguous(memory_format=torch.channels_last),
                f'stem output {got.dtype} {tuple(got.shape)} '
                f'strides {got.stride()}')
        # elementwise on the NCHW views: no copy into another layout
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        stem_errs.append(err)
        print(f'  batch {batch}: max |kernel - plain| {err:.3e} = '
              f'{err / scale:.3e} of max |plain| {scale:.3f}; '
              f'{float((got != want).float().mean()):.2e} of the values '
              'differ')
        require(scale > 0 and err <= 0.01 * scale,
                f'stem_fused kernel != plain (batch {batch}): {err} of '
                f'{scale}')
    x128 = x

    # 15. B4, B6, B7 kernels vs plain
    print('[15] one-level P-Net kernels vs plain')
    level_errs = {}
    odd = [torch.from_numpy(rng.integers(0, 256, (2, 3, sh, sw))
                            .astype(np.float32)).cuda()
           for sh, sw in ((24, 100), (61, 83), (40, 129))]
    from facenet_tpu_torch.detectors.mtcnn.networks import normalize_crops
    cases = [(normalize_crops(x).to(torch.bfloat16).contiguous(), 'odd level')
             for x in odd] + [(levels[0], f'level 0 of the {SCENE} pyramid')]
    for level, label in cases:
        for name, err in compare_level_kernels(rng, det.pnet, level,
                                               label).items():
            level_errs[name] = max(level_errs.get(name, 0.0), err)
    sums = try_pallas_pnet.conv_sum_errors(
        pnet.pack_level_weights(det.pnet).to(levels[0].device), levels[0])
    print("  pnet_level conv3 sums at level 0 against float64 sums of the "
          "same bf16 activations and float32 weights, max |s - s64| (max "
          f"|s64| {sums['scale']:.4f}): three mma a step chained on the "
          f"accumulator {sums['chained']:.3e}, each step summed from zero "
          f"(B6) {sums['step sums']:.3e}, float32 fused multiply-adds in a "
          f"CUDA-core loop's order {sums['fma chain']:.3e}")

    # 16. this slice's main paths
    print("[16a] main path: FastEmbedder(stem='fused'), full-width IRv1, "
          '4 batches of 128 (cuda)')
    batches = [torch.from_numpy(rng.integers(
        0, 256, (128, 160, 160, 3), dtype=np.uint8)).cuda() for _ in range(4)]
    reset_launches()
    t0 = time.monotonic()
    emb = torch.cat([fused(batch) for batch in batches])
    torch.cuda.synchronize()
    path_s = time.monotonic() - t0
    counts_a = read_launches()
    print(f'  {path_s:.3f} s, kernel launches {counts_a}')
    require(counts_a == only(stem_fused=4),
            f'expected 4 stem_fused launches alone, got {counts_a}')
    ref = torch.cat([cudnn(batch) for batch in batches])
    norms = emb.norm(dim=1)
    cos = float((emb * ref).sum(dim=1).min())
    require(tuple(emb.shape) == (512, 512) and bool(emb.isfinite().all())
            and float((norms - 1).abs().max()) < 1e-5,
            'fused-stem embeddings are not finite and unit-norm')
    print(f"  stem='fused' vs stem='cudnn': min cosine {cos:.6f}")
    require(cos >= 0.999, f'min cosine {cos} < 0.999')

    print("[16b] main path: MTCNN(pnet_impl='flat') through FaceDetector, 64 "
          'scenes in batches of 16 (cuda)')
    flat = FaceDetector(image_shape=SCENE, device='cuda',
                        pnet_impl='flat').backend_for(SCENE)
    reset_launches()
    t0 = time.monotonic()
    outs = [flat.detect_batch(images[i:i + 16]) for i in range(0, 64, 16)]
    path_s = time.monotonic() - t0
    counts_b = read_launches()
    print(f'  {path_s:.2f} s, kernel launches {counts_b}')
    require(len(levels) == 10 and counts_b == only(pnet_flat=40),
            f'expected 40 pnet_flat launches alone, got {counts_b}')
    refs = [det.detect_batch(images[i:i + 16]) for i in range(0, 64, 16)]
    got = {k: np.concatenate([o[k] for o in outs])
           for k in ('valid', 'boxes', 'landmarks', 'scores')}
    want = {k: np.concatenate([o[k] for o in refs]) for k in got}
    v = want['valid']
    require(np.array_equal(got['valid'], v),
            "valid masks differ between 'flat' and 'pyramid'")
    d_box = float(np.abs(got['boxes'][v] - want['boxes'][v]).max())
    d_lmk = float(np.abs(got['landmarks'][v] - want['landmarks'][v]).max())
    d_score = float(np.abs(got['scores'][v] - want['scores'][v]).max())
    print(f"  'flat' vs 'pyramid' cascade: {int(v.sum())} valid faces in 64 "
          f'scenes, boxes {d_box:.3e} px, landmarks {d_lmk:.3e} px, scores '
          f'{d_score:.3e}')
    require(v.sum() >= 64 and d_box < 1.5 and d_lmk < 1.5 and d_score < 0.02,
            "'flat' cascade != 'pyramid' cascade")

    print('[16c] the B6 tool: python -m facenet_tpu_torch.tools.'
          'try_pallas_pnet --iters 3')
    reset_launches()
    try_pallas_pnet.main(['--iters', '3'])
    counts_c = read_launches()
    print(f'  kernel launches {counts_c}')
    require(counts_c['pnet_level'] > 0
            and counts_c == only(pnet_level=counts_c['pnet_level']),
            f'expected pnet_level launches alone, got {counts_c}')
    print('[16d] the B7 tool: python -m facenet_tpu_torch.tools.try_pnet_v3')
    reset_launches()
    try_pnet_v3.main([])
    counts_d = read_launches()
    print(f'  kernel launches {counts_d}')
    require(counts_d['pnet_trunk_nhwc'] > 0
            and counts_d == only(pnet_trunk_nhwc=counts_d['pnet_trunk_nhwc']),
            f'expected pnet_trunk_nhwc launches alone, got {counts_d}')

    # 17. times
    print(f'[17] times on {smi} (median of 3 windows; kernels and their '
          'yardsticks in device time, host enqueue per call beside)')
    copies = [(x128.clone(),) for _ in range(3)]   # 59 MB in, past the L2
    with torch.inference_mode():
        b5_ms, b5_all, b5_host = device_ms(
            rotating(lambda x: stem.stem_forward(params, x), copies), 20)
        b5_plain, b5_plain_all, _ = device_ms(
            rotating(lambda x: stem.stem_forward_plain(params, x), copies), 5)
        b5_lib, b5_lib_all, b5_lib_host = device_ms(
            rotating(lambda x: irv1_fast.stem_prefix(params, x), copies), 20)
        lib_err = float((irv1_fast.stem_prefix(params, x128).float()
                         - stem.stem_forward(params, x128).float())
                        .abs().max())
    del copies
    flops, nbytes = stem_work(128)
    b5_ops, b5_bytes = (flops / H100_BF16_FLOPS * 1e3,
                        nbytes / H100_HBM_BYTES * 1e3)
    b5_bound = max(b5_ops, b5_bytes)
    print(f'  stem_fused, 128 images: kernel {b5_ms:.4f} ms '
          f'({_spread(b5_all)}; host {b5_host:.4f}) = '
          f'{flops / b5_ms / 1e9:.1f} TFLOP/s, plain {b5_plain:.4f} ms '
          f'({_spread(b5_plain_all)}), cuDNN prefix {b5_lib:.4f} ms '
          f'({_spread(b5_lib_all)}; host {b5_lib_host:.4f}; max |cuDNN - '
          f'kernel| {lib_err:.3e}), bound {b5_bound:.4f} ms ({flops:.4e} '
          f'flop at the bf16 tensor-core rate, {nbytes:.4e} bytes; '
          f'{flops / H100_FP32_FLOPS * 1e3:.4f} ms at the FP32 rate)')
    print(stem_schedule_line(
        torch.cuda.get_device_properties(0).multi_processor_count))

    serving = {'cudnn': [], 'fused': []}
    busy = {'cudnn': [], 'fused': []}
    for name in ('cudnn', 'fused', 'fused', 'cudnn'):
        embedder = fused if name == 'fused' else cudnn
        ms, _ = cuda_ms(lambda: embedder(batches[0]), reps=20, warmup=5)
        serving[name].append(ms)
        busy[name].append(device_busy(lambda: embedder(batches[0]), 5)[0])
    print('  serving per batch of 128 (uint8 on the card; in turns cudnn, '
          'fused, fused, cudnn), host included: ' + '; '.join(
              f"stem='{name}' {_spread(times)} ms = "
              f'{128e3 / np.mean(times):.1f} embeddings/s'
              for name, times in serving.items())
          + '; device busy time alone (torch.profiler, the sum of the '
          "kernels' durations over 5 batches): " + '; '.join(
              f"stem='{name}' {_spread(times)} ms = "
              f'{128e3 / np.mean(times):.1f} embeddings/s'
              for name, times in busy.items()))

    level0 = levels[0]
    b, _, sh, sw = level0.shape
    planes0 = level0.view(b, 3, sh * sw)
    nhwc0 = level0.permute(0, 2, 3, 1).contiguous()
    rounded = pnet.packed_weights(det.pnet, level0.device)
    unrounded = pnet.pack_level_weights(det.pnet).to(level0.device)
    with torch.inference_mode():
        b4_ms, b4_all, b4_host = device_ms(
            lambda: pnet.pnet_forward_flat(det.pnet, planes0, sh, sw, sw), 20)
        b6_ms, b6_all, b6_host = device_ms(
            lambda: pnet.pnet_forward_level(unrounded, level0), 20)
        b7_ms, b7_all, b7_host = device_ms(
            lambda: try_pnet_v3.pnet_trunk_nhwc(nhwc0, rounded), 20)
        lv_plain, lv_plain_all, _ = device_ms(
            lambda: pnet.level_plain(rounded, level0), 5)
        b6_plain, _, _ = device_ms(
            lambda: pnet.level_plain(unrounded, level0), 5)
        raw_plain, raw_plain_all, _ = device_ms(
            lambda: pnet.level_plain(rounded, level0, raw=True), 5)
        lv_lib, lv_lib_all, lv_lib_host = device_ms(
            lambda: det.pnet.forward_nchw(level0), 10)
        b7_lib, b7_lib_all, _ = device_ms(lambda: det.pnet(nhwc0), 10)
    flops0, bytes0 = pnet_work([level0])
    flops_all, _ = pnet_work(levels)
    lv_ops, lv_bytes = (flops0 / H100_BF16_FLOPS * 1e3,
                        bytes0 / H100_HBM_BYTES * 1e3)
    lv_bound = max(lv_ops, lv_bytes)
    # float32 weights as three bf16 parts: three mma a multiply-add, exact
    b6_ops = 3 * flops0 / H100_BF16_FLOPS * 1e3
    b6_bound = max(b6_ops, lv_bytes)
    b6_fp32 = max(flops0 / H100_FP32_FLOPS * 1e3, lv_bytes)
    share = context['pyramid_ms'] * flops0 / flops_all
    print(f'  level 0 ({sh}x{sw}), batch {b}: pnet_flat {b4_ms:.4f} ms '
          f'({_spread(b4_all)}; host {b4_host:.4f}), pnet_level '
          f'{b6_ms:.4f} ms ({_spread(b6_all)}; host {b6_host:.4f}), '
          f'pnet_trunk_nhwc {b7_ms:.4f} ms ({_spread(b7_all)}; host '
          f'{b7_host:.4f}); plain {lv_plain:.4f} ms '
          f'({_spread(lv_plain_all)}), with float32 weights '
          f'{b6_plain:.4f} ms, raw heads {raw_plain:.4f} ms '
          f'({_spread(raw_plain_all)}); cuDNN P-Net {lv_lib:.4f} ms '
          f'({_spread(lv_lib_all)}; host {lv_lib_host:.4f}), from NHWC '
          f'pixels {b7_lib:.4f} ms ({_spread(b7_lib_all)}); the '
          f"whole-pyramid kernel's share for this level's operations "
          f'{share:.4f} ms ({flops0 / flops_all:.3f} of {flops_all:.4e} '
          f'flop); bound {lv_bound:.4f} ms ({flops0:.4e} flop at the bf16 '
          f'tensor-core rate, {bytes0:.4e} bytes); pnet_level (float32 '
          f'weights as three bf16 parts) bound {b6_bound:.4f} ms (3 x '
          f'{flops0:.4e} flop at the bf16 tensor-core rate; {b6_fp32:.4f} '
          f'ms at the FP32 rate)')

    scenes16 = torch.from_numpy(images[16:32]).cuda()
    cascades = {'flax': FaceDetector(image_shape=SCENE, device='cuda',
                                     pnet_impl='flax').backend_for(SCENE),
                'flat': flat, 'pyramid': det}
    cascade_ms = {}
    for name in ('flax', 'flat', 'pyramid', 'pyramid', 'flat', 'flax'):
        ms, _ = cuda_ms(lambda: cascades[name]._detect(scenes16), 5, 2)
        cascade_ms.setdefault(name, []).append(ms)
    cascade_busy = {name: device_busy(
        lambda: cascades[name]._detect(scenes16), 3)[0] for name in cascades}
    print('  cascade alone per batch of 16 scenes, host included (in turns '
          'flax, flat, pyramid, pyramid, flat, flax): ' + '; '.join(
              f"'{name}' {_spread(times)} ms"
              for name, times in cascade_ms.items())
          + '; device busy time alone (torch.profiler, the sum of the '
          "kernels' durations over 3 batches): " + '; '.join(
              f"'{name}' {ms:.3f} ms" for name, ms in cascade_busy.items()))

    source = 'facenet_tpu_torch/csrc/pnet_level.cu'
    jax_pnet = 'facenet_tpu/detectors/mtcnn/pallas_pnet.py'
    return [{
        'name': 'stem_fused',
        'route': 'cuda',
        'source': 'facenet_tpu_torch/csrc/stem_fused.cu',
        'replaces': 'facenet_tpu/ops/pallas_stem.py:115',
        'launches': counts_a['stem_fused'],
        'max_abs_err': max(stem_errs),
        'ms': b5_ms,
        'plain_ms': b5_plain,
        'bound_ms': b5_bound,
        'bound_by': 'operations' if b5_ops >= b5_bytes else 'bytes',
        'library_ms': b5_lib,
    }, {
        'name': 'pnet_flat',
        'route': 'cuda',
        'source': source,
        'replaces': f'{jax_pnet}:421',
        'launches': counts_b['pnet_flat'],
        'max_abs_err': level_errs['pnet_flat'],
        'ms': b4_ms,
        'plain_ms': lv_plain,
        'bound_ms': lv_bound,
        'bound_by': 'operations' if lv_ops >= lv_bytes else 'bytes',
        'library_ms': lv_lib,
    }, {
        'name': 'pnet_level',
        'route': 'cuda',
        'source': source,
        'replaces': f'{jax_pnet}:163',
        'launches': counts_c['pnet_level'],
        'max_abs_err': level_errs['pnet_level'],
        'ms': b6_ms,
        'plain_ms': b6_plain,
        'bound_ms': b6_bound,
        'bound_by': 'operations' if b6_ops >= lv_bytes else 'bytes',
        'library_ms': lv_lib,
    }, {
        'name': 'pnet_trunk_nhwc',
        'route': 'cuda',
        'source': source,
        'replaces': 'tools/try_pnet_v3.py:115',
        'launches': counts_d['pnet_trunk_nhwc'],
        'max_abs_err': level_errs['pnet_trunk_nhwc'],
        'ms': b7_ms,
        'plain_ms': raw_plain,
        'bound_ms': lv_bound,
        'bound_by': 'operations' if lv_ops >= lv_bytes else 'bytes',
        'library_ms': b7_lib,
    }]


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false', file=sys.stderr)
        return 1

    from facenet_tpu_torch import FaceNet, statistics
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.export import ModelBundle
    from facenet_tpu_torch.facenet import evaluate_embeddings
    from facenet_tpu_torch.models.inception_resnet_v1 import (
        InceptionResnetV1, init_variables)
    from facenet_tpu_torch.detectors.mtcnn import pnet
    from facenet_tpu_torch.ops import cuda_build, pair_counts, stem, warp
    from facenet_tpu_torch.utils.timing import card_line, cuda_ms
    from facenet_tpu_torch.utils.timing import spread as _spread

    started = time.monotonic()
    rng = np.random.default_rng(0)

    # 1. the card
    smi = card_line()
    print(smi)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')

    # 2. build every kernel, one nvcc each, all started together
    t0 = time.monotonic()
    kernels = (pair_counts.KERNEL, warp.KERNEL, pnet.KERNEL,
               pnet.LEVEL_KERNEL, stem.KERNEL)
    libs = dict(zip((k.name for k in kernels), cuda_build.build_all(kernels)))
    print(f'[2] built {", ".join(k.library_path().name for k in kernels)} '
          f'in {time.monotonic() - t0:.1f} s')
    print_ptxas(libs['pair_below_counts'])

    # 3. kernel vs plain
    print('[3] kernel vs plain')
    errs = []
    emb, labels = clustered(rng, 128, 32, 512, 1.0)
    for metric in (0, 1):
        errs.append(compare_kernel_plain(
            pair_counts, prepared(pair_counts, emb, labels, metric),
            f'metric={metric}'))
    for n in (936, 104):        # the main path's train and test folds
        emb, labels = clustered(rng, 40, 26, 512, 1.0)
        pick = np.sort(rng.choice(emb.shape[0], n, replace=False))
        errs.append(compare_kernel_plain(
            pair_counts, prepared(pair_counts, emb[pick], labels[pick], 0),
            'metric=0'))
    emb, labels = clustered(rng, 40, 25, 17, 0.5)
    errs.append(compare_kernel_plain(
        pair_counts, prepared(pair_counts, emb, labels, 0),
        'metric=0'))

    for d in (512, 17):
        emb, _ = clustered(rng, 32, 32, d, 1.0)           # pairs at s ~ 0.5
        emb[1::7] = emb[0::7][:emb[1::7].shape[0]]        # and at s = 1
        x = torch.from_numpy(emb).cuda()
        got = pair_counts.pair_similarities(x)
        torch.cuda.synchronize()
        s64 = torch.clamp(x.double() @ x.double().T, -1.0, 1.0)
        allow_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            f32 = torch.clamp(x @ x.T, -1.0, 1.0)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        err = float((got.double() - s64).abs().max())
        print(f'  N={emb.shape[0]} D={d} product: max |s - s64| kernel '
              f'(3xTF32) {err:.3e}, float32 torch.matmul '
              f'{float((f32.double() - s64).abs().max()):.3e}; max s '
              f'{float(got.max()):.7f}')
        require(err <= 5e-7 and float(got.max()) <= 1.0,
                f'3xTF32 product off float64 by {err} at D={d}')

    # 4. full-width serving
    print('[4] full-width IRv1 serving')
    variables = init_variables(seed=0)
    bundle = ModelBundle(variables, {'model_class': 'InceptionResnetV1',
                                     'config': None, 'image_size': 160,
                                     'normalization': 0})
    facenet = FaceNet(bundle, device='cuda')
    require(facenet.embedding_size == 512, 'embedding size is not 512')
    images = rng.integers(0, 256, (128, 160, 160, 3), dtype=np.uint8)
    served = facenet.evaluate(images)
    norms = np.linalg.norm(served, axis=1)
    require(served.shape == (128, 512) and np.isfinite(served).all(),
            f'bad served embeddings {served.shape}')
    require(np.abs(norms - 1).max() < 1e-5, f'norms off: {norms.min()} '
            f'{norms.max()}')
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul_precision = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    try:
        unfused = InceptionResnetV1().from_flax_variables(variables)
        unfused = unfused.cuda().eval()
        with torch.inference_mode():
            ref = unfused(torch.from_numpy(images).cuda()).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(matmul_precision)
    cos = (served * ref).sum(1) / np.linalg.norm(ref, axis=1)
    print(f'  bf16 fused vs f32 unfused: min cosine {cos.min():.6f}')
    require(cos.min() >= 0.995, f'min cosine {cos.min()} < 0.995')
    batch = torch.from_numpy(images).cuda()
    ms, times = cuda_ms(lambda: facenet.dispatch(batch), reps=20, warmup=10)
    print(f'  serving: {ms:.3f} ms per batch of 128 (uint8 on the card; '
          f'windows {_spread(times)}) = {128e3 / ms:.1f} embeddings/s')

    # 5. main path: serve -> 10-fold validation on the card
    print('[5] main path: FaceNet -> evaluate_embeddings -> '
          'FaceToFaceValidation (cuda)')
    vcfg = Config({'metric': 0, 'nrof_folds': 10, 'far_target': 1e-3})
    reset_launches()
    t0 = time.monotonic()
    embs, labs = evaluate_embeddings(
        facenet.dispatch, synthetic_batches(rng, 40, 26, 128))
    report = statistics.FaceToFaceValidation(embs, labs, vcfg, device='cuda')
    path_s = time.monotonic() - t0
    counts = read_launches()
    launches = counts['pair_below_counts']
    print(f'  {embs.shape[0]} embeddings, {path_s:.2f} s, kernel launches '
          f'{counts}')
    require(embs.shape == (1040, 512) and np.isfinite(embs).all(),
            'bad main-path embeddings')
    require(counts == only(pair_below_counts=30),
            f'expected 30 pair_below_counts launches alone, got {counts}')
    for crit, values in report.dict.items():
        require(all(np.isfinite(v) for v in values.values()),
                f'non-finite report values in {crit}')
        print(f'  {crit}: accuracy {values["accuracy"]:.5f} '
              f'threshold {values["threshold"]:.5f}')

    sep_rng = np.random.RandomState(1)
    centres = sep_rng.randn(6, 32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    sep = np.repeat(centres, 16, axis=0) + 0.1 * sep_rng.randn(96, 32)
    sep = (sep / np.linalg.norm(sep, axis=1, keepdims=True)).astype(np.float32)
    sep_labels = np.repeat(np.arange(6), 16)
    for metric in (0, 1):
        cfg = Config({'metric': metric, 'nrof_folds': 5, 'far_target': 0.01})
        on_card = statistics.FaceToFaceValidation(sep, sep_labels, cfg,
                                                  device='cuda').dict
        on_cpu = statistics.FaceToFaceValidation(sep, sep_labels, cfg,
                                                 device='cpu').dict
        worst = max(abs(on_card[c][k] - on_cpu[c][k])
                    for c in on_cpu for k in on_cpu[c])
        print(f'  separated set, metric {metric}: max |cuda - cpu| '
              f'{worst:.3e}')
        require(worst <= 1e-6, f'cuda report != cpu report ({worst})')

    # 6. timing at the main path's validation shape
    n, d, t = 23840, 512, 100
    print(f'[6] timing N={n} D={d} T={t}')
    emb, labels = clustered(rng, 917, 26, d, 1.0)
    emb, labels = emb[:n], labels[:n]
    inputs = prepared(pair_counts, emb, labels, 0, t)
    errs.append(compare_kernel_plain(pair_counts, inputs, 'metric=0'))
    kern_ms, kern_all = cuda_ms(lambda: pair_counts.pair_histogram(inputs),
                                reps=5)
    plain_ms, plain_all = cuda_ms(
        lambda: pair_counts.pair_histogram_plain(inputs), reps=3)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library_ms, library_all = cuda_ms(
            lambda: torch.matmul(inputs.embeddings, inputs.embeddings.T),
            reps=5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    flops = n * (n - 1) / 2 * 2 * d
    nbytes = n * d * 4 + n * (4 + 8 + 8) + t * 4 + 2 * (t + 1) * 8
    fp32_ms = flops / H100_FP32_FLOPS * 1e3
    ops_ms = 3 * flops / H100_TF32_FLOPS * 1e3     # what the kernel runs
    bytes_ms = nbytes / H100_HBM_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f'  kernel {kern_ms:.3f} ms ({_spread(kern_all)}), plain '
          f'{plain_ms:.3f} ms ({_spread(plain_all)}), f32 matmul of the '
          f'full N x N product {library_ms:.3f} ms ({_spread(library_all)}), '
          f'bound {bound_ms:.3f} ms (3 x {flops:.3e} flop at the TF32 '
          f'tensor-core rate; {fp32_ms:.3f} ms at the FP32 rate)')
    for label, (ms, windows) in pair_split_times(pair_counts, emb, labels,
                                                 t).items():
        print(f'  kernel at {label}: {ms:.3f} ms ({_spread(windows)})')

    # a whole 10-fold validation at the reference eval size, host included
    n = 26489
    emb, labels = clustered(rng, 1019, 26, d, 1.0)
    vcfg = Config({'metric': 0, 'nrof_folds': 10, 'far_target': 1e-3})
    torch.cuda.synchronize()
    t0 = time.monotonic()
    full = statistics.FaceToFaceValidation(emb[:n], labels[:n], vcfg,
                                           device='cuda')
    validation_s = time.monotonic() - t0
    accuracy = full.dict['MaximumAccuracy']['accuracy']
    require(np.isfinite(accuracy), 'non-finite accuracy at full size')
    print(f'  10-fold validation of {n} x {d} on the card: '
          f'{validation_s:.3f} s wall (accuracy {accuracy:.5f})')

    pair_entry = {
        'name': 'pair_below_counts',
        'route': 'cuda',
        'source': 'facenet_tpu_torch/csrc/pair_below_counts.cu',
        'replaces': 'facenet_tpu/ops/pallas_stats.py:73',
        'launches': launches,
        'max_abs_err': max(errs),
        'ms': kern_ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
        'library_ms': library_ms,
    }
    context, detection = detection_phases(rng, libs, bundle)
    context.update(smi=smi, variables=variables)
    slice3 = slice3_phases(rng, libs, context)

    print(f'total {time.monotonic() - started:.1f} s')
    print(json.dumps({'kernels': [pair_entry] + detection + slice3}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
