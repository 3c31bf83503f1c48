#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (facenet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when its check fails:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels csrc/pair_below_counts.cu, dense_warp.cu and
     pnet_pyramid.cu for sm_90a (one nvcc each, all started together);
  3. kernel vs its plain PyTorch version at N=4096/D=512 (metrics 0 and 1),
     at the main path's fold sizes N=936 and N=104 (D=512), and at
     N=1000/D=17: cumulative counts agree to rtol 1e-6, beyond the weight
     of pairs whose float64 similarity lies within 1e-6 of a cutoff
     (float32 sums in another order may put exactly those on either side);
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
     plain version, and the float32 torch.matmul of the same product (a
     yardstick for the product alone), beside the bound; then the wall
     time of a whole 10-fold validation at the reference eval size
     (26,489 x 512, synthetic clustered embeddings);
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
     included; and a torch.profiler breakdown of one pipeline batch.

The line before the last is the JSON list of kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

import numpy as np

H100_FP32_FLOPS = 67e12     # FP32 outside the tensor cores, H100 SXM
H100_BF16_FLOPS = 989e12    # dense bf16 tensor cores, H100 SXM
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


def cuda_ms(fn, reps, warmup=1, windows=3):
    """Milliseconds per call of fn() on the current stream: the mean over
    `reps` calls in each of `windows` windows, after `warmup` calls. Returns
    (median window, all windows)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return float(np.median(times)), times


def device_ms(fn, reps, warmup=2, windows=3):
    """Device milliseconds per call of fn(), without the host's launch
    rate: each window's calls are queued behind a spin kernel that lasts
    longer than the host takes to enqueue them, so the events bracket
    back-to-back device work. Returns (median window, all windows, host
    enqueue ms per call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    stop.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(stop)
    times = []
    for _ in range(windows):
        torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms * reps + 1)))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return float(np.median(times)), times, host_ms


def _spread(times):
    return '/'.join(f'{t:.3f}' for t in times)


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
    from facenet_tpu_torch.ops import pair_counts, warp
    return {'pair_below_counts': pair_counts.pair_histogram,
            'dense_warp': warp.dense_warp,
            'pnet_pyramid': pnet.pnet_forward_pyramid}


def reset_launches():
    for fn in _launch_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _launch_counters().items()}


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
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us <= 0:
        print('  profiler: no device time recorded (not measured)')
        return
    print(f'  profiler: {len(rows)} kernel names, device busy '
          f'{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall '
          f'({busy_us / wall_us:.3f} busy share)')
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f'    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} '
              f'{e.key[:90]}')


def detection_phases(rng, libs, bundle):
    """Phases 7-12 (see the module docstring) with the full-width IRv1
    `bundle`; returns the kernels-line entries of B3 and B2."""
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
    require(counts == {'pair_below_counts': 0, 'dense_warp': 4,
                       'pnet_pyramid': 4},
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

    return [{
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
    from facenet_tpu_torch.ops import cuda_build, pair_counts, warp

    started = time.monotonic()
    rng = np.random.default_rng(0)

    # 1. the card
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')

    # 2. build every kernel, one nvcc each, all started together
    t0 = time.monotonic()
    kernels = (pair_counts.KERNEL, warp.KERNEL, pnet.KERNEL)
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
    require(counts == {'pair_below_counts': 30, 'dense_warp': 0,
                       'pnet_pyramid': 0},
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
    ops_ms = flops / H100_FP32_FLOPS * 1e3
    bytes_ms = nbytes / H100_HBM_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f'  kernel {kern_ms:.3f} ms ({_spread(kern_all)}), plain '
          f'{plain_ms:.3f} ms ({_spread(plain_all)}), f32 matmul '
          f'{library_ms:.3f} ms ({_spread(library_all)}), bound '
          f'{bound_ms:.3f} ms ({flops:.3e} flop)')

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
    detection = detection_phases(rng, libs, bundle)

    print(f'total {time.monotonic() - started:.1f} s')
    print(json.dumps({'kernels': [pair_entry] + detection}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
