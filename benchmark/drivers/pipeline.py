"""The detection pipeline: ``FacePipeline.dispatch`` on host uint8 scene
batches, each batch's outputs fetched to the host, two batches in flight
as ``FacePipeline.process_files`` keeps them.

Traffic keys: ``batch`` (scenes a batch), ``pool_batches``, ``quadrants``
(rendered 240 x 320 quadrant scenes the pool is made of),
``faces_per_quadrant`` [lo, hi], ``faces_per_scene`` [lo, hi],
``face_px`` [lo, hi], ``num_faces``, ``align``, ``margin``,
``sample_batches`` (window batches whose embeddings are compared),
``trace`` ({units, gap_units}).

Each scene is four quadrants drawn from the rendered ones (each maybe
mirrored), under its own gain and noise, assembled on the device.

The window ends when the last batch's outputs have reached the host; its
rate counts every scene of every batch, over its whole length.

Correctness, against the plain reference (`reference.mtcnn`, float32, TF32
off) on the same scenes and weights: every window batch's detections
against the reference cascade's, matched by IoU >= 0.5: the share of
detections without a match or missing (``detections_unmatched``, which
holds the valid masks to the reference's), and over matched pairs the
box edge and landmark offsets as a share of the box's side, largest and
mean (``box_gap``, ``landmark_gap``, ``box_gap_mean``,
``landmark_gap_mean``), and the score difference, largest and mean
(``score_gap``, ``score_gap_mean``); and for ``sample_batches`` batches
of the window, drawn from the seed, the embeddings of every valid slot
against the reference's alignment (from the program's landmarks or boxes,
the outputs that the detection check covers) and float32 IRv1: the
largest and the mean distance (``embed_gap``, ``embed_gap_mean``).
"""

from __future__ import annotations

import gc
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from benchmark.core import seeds, weights, work
from benchmark.core.seeds import device_generator, host_rng
from benchmark.core.synthetic import render_scene
from benchmark.core.trace import NullTracer
from benchmark.drivers.embed import irv1_tree
from benchmark.reference import irv1, mtcnn

KEYS = ('embeddings', 'boxes', 'scores', 'valid', 'landmarks')
# 'control' is the reference at fp8 in the program's place, 'altered' and
# 'half_batch' planted faults
VARIANTS = ('program', 'control', 'altered', 'half_batch')
ROOT = Path(__file__).resolve().parents[2]


def scene_batches(seed, device, n_batches, batch, shape, tr):
    """uint8 [n_batches, batch, H, W, 3] host array."""
    rng = host_rng(seed, 'scenes')
    qh, qw = shape[0] // 2, shape[1] // 2
    lo, hi = tr['faces_per_quadrant']
    px_lo, px_hi = tr['face_px']
    quads, counts = [], []
    for _ in range(int(tr['quadrants'])):
        img, boxes, _ = render_scene(rng, (qh, qw),
                                     n_faces=rng.randint(lo, hi + 1),
                                     min_face=px_lo, max_face=px_hi)
        quads.append(img)
        counts.append(len(boxes))
    fmin, fmax = tr['faces_per_scene']
    picks = np.zeros((n_batches, batch, 4), np.int64)
    for b in range(n_batches):
        for s in range(batch):
            while True:
                pick = rng.randint(len(quads), size=4)
                if fmin <= sum(counts[i] for i in pick) <= fmax:
                    break
            picks[b, s] = pick
    q = torch.from_numpy(np.stack(quads)).to(device)
    gen = device_generator(seed, device, 'scenes')
    out = np.empty((n_batches, batch, shape[0], shape[1], 3), np.uint8)
    for b in range(n_batches):
        tiles = q[torch.from_numpy(picks[b]).to(device)].float()
        mirror = torch.rand(batch, 4, generator=gen, device=device) < 0.5
        tiles = torch.where(mirror[..., None, None, None], tiles.flip(3),
                            tiles)
        top = torch.cat([tiles[:, 0], tiles[:, 1]], 2)
        bottom = torch.cat([tiles[:, 2], tiles[:, 3]], 2)
        x = torch.cat([top, bottom], 1)
        gain = 0.85 + 0.3 * torch.rand(batch, 1, 1, 1, generator=gen,
                                       device=device)
        noise = 3 * torch.randn(x.shape, generator=gen, device=device)
        x = (x * gain + noise).round().clamp(0, 255)
        out[b] = x.to(torch.uint8).cpu().numpy()
    return out


class Session:

    def __init__(self, run):
        if run.variant not in VARIANTS:
            raise ValueError(f'unknown variant {run.variant!r}')
        self.run = run
        cfg, tr = run.config, run.traffic
        self.det = cfg['detector']
        self.shape = tuple(self.det['image_shape'])
        self.batch = int(tr['batch'])
        self.k = int(tr['num_faces'])
        self.pool = scene_batches(run.seed, run.device,
                                  int(tr['pool_batches']), self.batch,
                                  self.shape, tr)
        run.mark('inputs')
        self.outputs = []
        if run.variant == 'control':
            return
        self._build()
        run.mark('program')
        self._loop(2 * len(self.pool), None, NullTracer())
        run.mark('warm-up')

    def _build(self):
        from facenet_tpu_torch import FaceNet
        from facenet_tpu_torch.config import Config
        from facenet_tpu_torch.export import ModelBundle
        from facenet_tpu_torch.pipeline import FacePipeline

        run, emb, det, tr = (self.run, self.run.config['embedding'],
                             self.det, self.run.traffic)
        leaves = irv1_tree(emb, run.seed, run.device)
        bundle = ModelBundle(weights.nested_numpy(leaves), {
            'model_class': emb['model_class'], 'config': emb['topology'],
            'image_size': emb['image_size'],
            'normalization': emb['normalization']})
        del leaves
        facenet = FaceNet(Config(emb['serving']), device=run.device,
                          bundle=bundle)
        self.pipe = FacePipeline(
            facenet, image_shape=self.shape, align=tr['align'],
            margin=float(tr.get('margin', 0.2)), num_faces=self.k,
            device=run.device, min_face_size=det['min_face_size'],
            factor=det['factor'], thresholds=tuple(det['thresholds']),
            max_proposals=det['max_proposals'],
            max_refined=det['max_refined'], max_outputs=det['max_outputs'],
            pnet_impl=det['pnet_impl'])
        self.dispatch = {'altered': self._altered,
                         'half_batch': self._half_batch}.get(
                             run.variant, self.pipe.dispatch)

    def _altered(self, scenes):
        """A fault planted where answers are produced: every 16th scene's
        first slot comes back as the next scene's."""
        out = dict(self.pipe.dispatch(scenes))
        for key in KEYS:
            value = out[key].clone()
            value[::16, 0] = value[1::16, 0]
            out[key] = value
        return out

    def _half_batch(self, scenes):
        """A fault: the second half of the batch left out, its scenes
        coming back with no valid slot."""
        out = dict(self.pipe.dispatch(scenes))
        valid = out['valid'].clone()
        valid[scenes.shape[0] // 2:] = False
        out['valid'] = valid
        return out

    def _loop(self, count, deadline, tracer, issue=None, keep=None):
        n = len(self.pool)
        inflight = deque()

        def fetch():
            k, out = inflight.popleft()
            with tracer.span('bench.fetch'):
                host = {key: out[key].cpu().numpy() for key in KEYS}
            if keep is not None:
                keep.append((k, host))

        k = 0
        while (time.perf_counter() < deadline if count is None
               else k < count):
            with tracer.span('bench.dispatch'):
                t = time.perf_counter()
                inflight.append((k, self.dispatch(self.pool[k % n])))
                if issue is not None:
                    issue.append((t, time.perf_counter() - t))
            if len(inflight) > 1:
                fetch()
            k += 1
        while inflight:
            fetch()

    def window(self, seconds):
        run, cfg, tr = self.run, self.run.config, self.run.traffic
        if run.variant == 'control':
            run.counters.update(units=0, window_s=seconds)
            return
        issue = []
        t0 = time.perf_counter()
        self._loop(None, t0 + seconds, NullTracer(), issue, self.outputs)
        elapsed = time.perf_counter() - t0
        levels = work.pyramid_levels(self.batch, *self.shape,
                                     self.det['min_face_size'],
                                     self.det['factor'])
        b3_ops, b3_bytes = work.pnet_work(levels)
        counters = dict(
            units=len(self.outputs), scenes=len(self.outputs) * self.batch,
            window_s=elapsed, issue_s=float(np.mean([d for _, d in issue])),
            unit_times=[t - t0 for t, _ in issue],
            flops_per_batch=work.pipeline_flops(
                self.det, cfg['embedding'], self.batch, self.k, self.shape),
            b3_ops=b3_ops, b3_bytes=b3_bytes)
        if tr['align'] == 'landmarks':
            lmk = torch.from_numpy(self.outputs[0][1]['landmarks'])
            size = cfg['embedding']['image_size']
            _, mats, t = mtcnn.warp_geometry(
                lmk.reshape(-1, 5, 2).to(run.device), size)
            counters['b2_bytes'] = work.b2_bytes(mats.float(), size, t)
        run.counters.update(counters)

    def stretch(self, units, tracer):
        if self.run.variant != 'control':
            self._loop(units, None, tracer)

    # -- the reference --------------------------------------------------------
    def _reference(self, index, precision=irv1.FLOAT32, chunk=16):
        """The reference cascade's outputs on pool batch `index`."""
        run = self.run
        nets = mtcnn.Nets(mtcnn.load_weights(ROOT / self.det['weights'],
                                             run.device), precision)
        parts = []
        with torch.no_grad():
            for s in range(0, self.batch, chunk):
                x = torch.from_numpy(self.pool[index, s:s + chunk]).to(
                    run.device)
                out = mtcnn.detect(x, nets, self.det)
                parts.append({k: v.cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def _embed(self, index, boxes, landmarks, valid,
               precision=irv1.FLOAT32, chunk=8):
        """Reference embeddings [B, k, D] of pool batch `index`'s faces,
        aligned from `landmarks` or `boxes` (zeros where not `valid`)."""
        run, cfg, tr = self.run, self.run.config, self.run.traffic
        emb = cfg['embedding']
        size = emb['image_size']
        net = irv1.Net(irv1.Tree(irv1_tree(emb, run.seed, run.device)),
                       emb['topology'], precision=precision)
        out = np.zeros(valid.shape + (emb['topology']['output']['size'],),
                       np.float32)
        placeholder = (mtcnn.TEMPLATE_112 * (size / 112.0)).astype(np.float32)
        with torch.no_grad():
            for s in range(0, self.batch, chunk):
                scenes = torch.from_numpy(self.pool[index, s:s + chunk]).to(
                    run.device)
                if tr['align'] == 'landmarks':
                    # an empty slot's landmarks may be degenerate: align
                    # the template itself there (its embedding is unused)
                    lmk = np.where(valid[s:s + chunk, ..., None, None],
                                   landmarks[s:s + chunk], placeholder)
                    lmk = torch.from_numpy(lmk).to(run.device)
                    crops = mtcnn.align_landmarks(scenes, lmk, size)
                else:
                    bx = torch.from_numpy(boxes[s:s + chunk]).to(run.device)
                    crops = mtcnn.align_boxes(scenes, bx, size,
                                              float(tr.get('margin', 0.2)))
                faces = mtcnn.to_uint8(crops).reshape(-1, size, size, 3)
                e = net.embeddings(faces).float().cpu().numpy()
                out[s:s + chunk] = e.reshape(out[s:s + chunk].shape)
        return np.where(valid[..., None], out, 0)

    def _control_outputs(self):
        """The reference at fp8 in the program's place: its outputs on
        every pool batch, as the window's batches."""
        for index in range(len(self.pool)):
            out = self._reference(index, irv1.FP8)
            out = {k: v[:, :self.k] for k, v in out.items()}
            out['embeddings'] = self._embed(index, out['boxes'],
                                            out['landmarks'], out['valid'],
                                            irv1.FP8)
            self.outputs.append((index, out))

    def judge(self):
        run = self.run
        self.pipe = self.dispatch = None
        gc.collect()
        if run.device != 'cpu':
            torch.cuda.empty_cache()
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            if run.variant == 'control':
                self._control_outputs()
            refs = [self._reference(i) for i in range(len(self.pool))]
            n = len(self.pool)
            found = [match(out, refs[k % n], self.k)
                     for k, out in self.outputs]
            rng = seeds.host_rng(run.seed, 'sample')
            picks = rng.choice(len(self.outputs),
                               size=min(int(run.traffic['sample_batches']),
                                        len(self.outputs)), replace=False)
            gaps = []
            for i in sorted(picks):
                k, out = self.outputs[i]
                ref = self._embed(k % n, out['boxes'], out['landmarks'],
                                  out['valid'])
                d = np.linalg.norm(out['embeddings'] - ref, axis=-1)
                gaps.append(d[out['valid']])
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        gaps = np.concatenate(gaps) if gaps else np.zeros(0)
        total = {key: sum(f[key] for f in found)
                 for key in ('unmatched', 'expected', 'pairs', 'box_sum',
                             'landmark_sum', 'score_sum')}
        pairs = max(total['pairs'], 1)
        readings = {
            'detections_unmatched': total['unmatched']
            / max(total['expected'], 1),
            'box_gap': max(f['box_gap'] for f in found),
            'landmark_gap': max(f['landmark_gap'] for f in found),
            'score_gap': max(f['score_gap'] for f in found),
            'box_gap_mean': total['box_sum'] / pairs,
            'landmark_gap_mean': total['landmark_sum'] / pairs,
            'score_gap_mean': total['score_sum'] / pairs,
            'embed_gap': float(gaps.max()) if gaps.size else 0.0,
            'embed_gap_mean': float(gaps.mean()) if gaps.size else 0.0,
        }
        detail = {'detections': total['expected'],
                  'unmatched': total['unmatched'],
                  'compared_faces': int(gaps.size),
                  'batches': len(self.outputs)}
        return readings, detail


def match(out, ref, k):
    """Detections of one batch's program outputs (the first k slots)
    against the reference's (all slots), matched greedily by IoU >= 0.5
    within each scene: {'unmatched': program detections without a match
    plus the difference in counts against the reference's first k,
    'expected': the reference's detections in its first k slots, and the
    largest gaps of matched pairs}."""
    result = {'unmatched': 0, 'expected': 0, 'box_gap': 0.0,
              'landmark_gap': 0.0, 'score_gap': 0.0, 'pairs': 0,
              'box_sum': 0.0, 'landmark_sum': 0.0, 'score_sum': 0.0}
    for s in range(out['valid'].shape[0]):
        p = np.flatnonzero(out['valid'][s, :k])
        r = np.flatnonzero(ref['valid'][s])
        expected = int(ref['valid'][s, :k].sum())
        result['expected'] += expected
        result['unmatched'] += abs(len(p) - expected)
        if not len(p):
            continue
        if not len(r):
            result['unmatched'] += len(p)
            continue
        ov = box_iou(out['boxes'][s, p], ref['boxes'][s, r])
        taken = set()
        for i in np.argsort(-ov.max(1), kind='stable'):
            j = next((j for j in np.argsort(-ov[i], kind='stable')
                      if ov[i, j] >= 0.5 and j not in taken), None)
            if j is None:
                result['unmatched'] += 1
                continue
            taken.add(j)
            pb, rb = out['boxes'][s, p[i]], ref['boxes'][s, r[j]]
            side = max(rb[2] - rb[0], rb[3] - rb[1], 1e-6)
            box = float(np.abs(pb - rb).max() / side)
            result['box_gap'] = max(result['box_gap'], box)
            result['box_sum'] += box
            result['pairs'] += 1
            dl = np.linalg.norm(out['landmarks'][s, p[i]]
                                - ref['landmarks'][s, r[j]], axis=-1)
            result['landmark_gap'] = max(result['landmark_gap'],
                                         float(dl.max() / side))
            result['landmark_sum'] += float(dl.max() / side)
            score = float(abs(out['scores'][s, p[i]]
                              - ref['scores'][s, r[j]]))
            result['score_gap'] = max(result['score_gap'], score)
            result['score_sum'] += score
    return result


def box_iou(a, b):
    """IoU [N, M] of boxes a [N, 4] and b [M, 4] (x1, y1, x2, y2)."""
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-10)
