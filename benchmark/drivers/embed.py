"""Extraction: ``facenet.evaluate_embeddings(FaceNet(...).dispatch,
batches)``, the loop of the embeddings, validate and LFW apps, one batch in
flight, over host uint8 batches cycled from a pool made from the seed.

Traffic keys: ``batch``, ``pool_batches``, ``faces`` (rendered faces the
pool is made of), ``sample`` (rows compared with the reference),
``reference_batch``, ``warmup_batches``, ``trace`` ({skip, units}).

The window ends when the last batch's embeddings have reached the host;
its rate counts every image embedded, over its whole length.

Correctness: a sample of the window's rows, drawn from the seed, against
the plain reference's float32 forward (TF32 off) on the same images and
weights: the distance between the two unit embeddings of a row, its
largest (``embed_gap``) and its mean (``embed_gap_mean``) over the
sample, and rows out of order (``rows_out_of_order``, exact). The
control is the reference at fp8 (`irv1.FP8`) in the program's place,
over every pool row.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.core import images, seeds, weights, work
from benchmark.core.trace import NullTracer
from benchmark.reference import irv1

VARIANTS = ('program', 'control', 'altered')


def irv1_tree(config, seed, device, classes=None, trained_stats=True):
    """The cell's IRv1 weights on `device` (`weights.make`)."""
    spec = irv1.spec(config['topology'], config['image_size'], classes)
    return weights.make(spec, seed, device, trained_stats)


def reference_embeddings(config, seed, device, batch_images, chunk,
                         precision=irv1.FLOAT32):
    """Reference embeddings (TF32 off) of uint8 [N, H, W, 3], float32
    unless `precision` says otherwise."""
    leaves = irv1_tree(config, seed, device)
    net = irv1.Net(irv1.Tree(leaves), config['topology'],
                   precision=precision)
    out = []
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            for s in range(0, len(batch_images), chunk):
                x = torch.from_numpy(batch_images[s:s + chunk]).to(device)
                out.append(net.embeddings(x).float().cpu().numpy())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return np.concatenate(out)


class Session:

    def __init__(self, run):
        from facenet_tpu_torch import FaceNet
        from facenet_tpu_torch.config import Config
        from facenet_tpu_torch.export import ModelBundle

        if run.variant not in VARIANTS:
            raise ValueError(f'unknown variant {run.variant!r}')
        self.run = run
        cfg, tr = run.config, run.traffic
        self.batch = int(tr['batch'])
        self.pool = images.face_batches(
            run.seed, run.device, int(tr['pool_batches']), self.batch,
            int(tr.get('faces', 64)), cfg['image_size'])
        run.mark('inputs')
        if run.variant == 'control':
            return
        leaves = irv1_tree(cfg, run.seed, run.device)
        run.mark('weights')
        bundle = ModelBundle(weights.nested_numpy(leaves), {
            'model_class': cfg['model_class'], 'config': cfg['topology'],
            'image_size': cfg['image_size'],
            'normalization': cfg['normalization']})
        del leaves
        run.mark('weights to host')
        options = {'normalize': cfg['serving']['normalize'],
                   'stem': cfg['serving']['stem']}
        self.facenet = FaceNet(Config(options), device=run.device,
                               bundle=bundle)
        self.forward = self.facenet.dispatch
        if run.variant == 'altered':
            self.forward = self._altered
        run.mark('program')
        self._loop(int(tr.get('warmup_batches', 2)), None, NullTracer())
        run.mark('warm-up')

    def _altered(self, batch_images):
        """A fault planted where answers are produced: every 64th row of a
        batch comes back as its neighbour's embedding."""
        out = self.facenet.dispatch(batch_images).clone()
        out[::64] = out[1::64]
        return out

    def _loop(self, batches, deadline, tracer, issue=None):
        from facenet_tpu_torch.facenet import evaluate_embeddings

        b, n = self.batch, len(self.pool)

        def forward(batch_images):
            with tracer.span('bench.dispatch'):
                t = time.perf_counter()
                out = self.forward(batch_images)
                if issue is not None:
                    issue.append((t, time.perf_counter() - t))
            return out

        def feed():
            k = 0
            while (k < batches if deadline is None
                   else time.perf_counter() < deadline):
                yield self.pool[k % n], np.arange(k * b, (k + 1) * b)
                k += 1

        return evaluate_embeddings(forward, feed())

    def window(self, seconds):
        if self.run.variant == 'control':
            self.run.counters.update(units=0, window_s=seconds)
            return
        issue = []
        t0 = time.perf_counter()
        self.emb, self.labels = self._loop(None, t0 + seconds, NullTracer(),
                                           issue)
        elapsed = time.perf_counter() - t0
        cfg = self.run.config
        self.run.counters.update(
            images=len(self.emb), units=len(self.emb), window_s=elapsed,
            issue_s=float(np.mean([d for _, d in issue])),
            unit_times=[t - t0 for t, _ in issue],
            flops_per_image=work.irv1_forward_flops(cfg['topology'],
                                                    cfg['image_size']))

    def stretch(self, units, tracer):
        if self.run.variant == 'control':
            return
        with tracer.span('bench.evaluate_embeddings'):
            self._loop(units, None, tracer)

    def judge(self):
        run, tr = self.run, self.run.traffic
        self.facenet = self.forward = None
        gc.collect()
        if run.device != 'cpu':
            torch.cuda.empty_cache()
        if run.variant == 'control':
            self._control_outputs()
        n = len(self.emb)
        order = int((self.labels != np.arange(n)).sum())
        rng = seeds.host_rng(run.seed, 'sample')
        rows = np.sort(rng.choice(n, size=min(int(tr['sample']), n),
                                  replace=False))
        b = self.batch
        src = self.pool[(rows // b) % len(self.pool), rows % b]
        ref = reference_embeddings(run.config, run.seed, run.device, src,
                                   int(tr.get('reference_batch', 256)))
        gaps = np.linalg.norm(self.emb[rows] - ref, axis=1)
        readings = {'embed_gap': float(gaps.max()),
                    'embed_gap_mean': float(gaps.mean()),
                    'rows_out_of_order': float(order)}
        return readings, {'rows': len(rows)}

    def _control_outputs(self):
        """The reference at fp8 in the program's place: its embeddings of
        every pool row, as the window's rows."""
        pool = self.pool.reshape((-1,) + self.pool.shape[2:])
        self.emb = reference_embeddings(
            self.run.config, self.run.seed, self.run.device, pool,
            int(self.run.traffic.get('reference_batch', 256)), irv1.FP8)
        self.labels = np.arange(len(self.emb))
