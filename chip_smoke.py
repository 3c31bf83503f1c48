#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (facenet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when its check fails:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernel csrc/pair_below_counts.cu for sm_90a;
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
     (26,489 x 512, synthetic clustered embeddings).

The line before the last is the JSON list of kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

H100_FP32_FLOPS = 67e12     # FP32 outside the tensor cores, H100 SXM
H100_HBM_BYTES = 3.35e12    # HBM3 bytes/s, H100 SXM


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
    from facenet_tpu_torch.ops import pair_counts

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

    # 2. build
    t0 = time.monotonic()
    lib = pair_counts.build()
    print(f'[2] built {pair_counts.library_path().name} in '
          f'{time.monotonic() - t0:.1f} s')
    for line in lib.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'smem' in line:
            print('  ptxas:', line.strip())

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
    pair_counts.pair_histogram.launches = 0
    t0 = time.monotonic()
    embs, labs = evaluate_embeddings(
        facenet.dispatch, synthetic_batches(rng, 40, 26, 128))
    report = statistics.FaceToFaceValidation(embs, labs, vcfg, device='cuda')
    path_s = time.monotonic() - t0
    launches = pair_counts.pair_histogram.launches
    print(f'  {embs.shape[0]} embeddings, {path_s:.2f} s, kernel launches '
          f'{launches}')
    require(embs.shape == (1040, 512) and np.isfinite(embs).all(),
            'bad main-path embeddings')
    require(launches == 30, f'expected 30 kernel launches, got {launches}')
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

    print(f'total {time.monotonic() - started:.1f} s')
    print(json.dumps({'kernels': [{
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
    }]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
