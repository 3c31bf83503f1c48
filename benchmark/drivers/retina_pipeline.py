"""The RetinaFace pipeline: ``FacePipeline(..., detector='retinaface')`` on
host uint8 frame batches, each batch's outputs fetched to the host, two
batches in flight as ``FacePipeline.process_files`` keeps them, closed
loop.

Traffic keys: those of `drivers.pipeline` (``batch``, ``pool_batches``,
``quadrants``, ``faces_per_quadrant``, ``faces_per_scene``, ``face_px``,
``num_faces``, ``align``, ``sample_batches``, ``trace``); the frames are
made by its `scene_batches` at the configuration's ``image_shape``.

The window ends when the last batch's outputs have reached the host; its
rate counts every frame of every batch, over its whole length. In a traced
run the window also records the program's spans, for the host time a
batch spends inside ``retinaface.*`` (``detect_issue_s``).

Correctness, judged after the window against the plain reference
(`reference.retinaface`, float32, TF32 off) on the same frames and weights.
With random weights, scores near a tie flip under bf16 rounding, so the
kept sets of two independent runs are not compared; instead:

  * ``head_gap`` / ``head_gap_mean``: the program's dense class logits,
    box deltas and landmark deltas for every prior of every pool batch
    (the frames of every window batch), from the network module the timed
    path calls (rerun after the window), against the reference network's;
    per head the largest / the mean absolute difference over the
    reference's RMS, the largest over the heads;
  * ``selection_mismatch``: the reference's decode, threshold, top-k,
    ``py_cpu_nms`` and keep, run on the program's own dense outputs,
    against the detections the timed path produced in every window batch:
    slots (of the first ``num_faces``) whose validity, box, score or
    landmarks differ at all, plus each frame whose count of candidates,
    of priors lost to the top-k or of kept boxes lost to the keep
    capacity differs, over the reference's valid slots; the rerun
    reproduces the timed path's detections, so this holds the selection
    to exactly the reference's;
  * ``decode_gap``: the program's decode of those dense outputs against
    the reference's, every prior's box and landmarks, as a share of the
    reference box's longer side (at least 1 px);
  * ``embed_gap`` / ``embed_gap_mean``: for ``sample_batches`` window
    batches drawn from the seed, the embeddings of every valid slot
    against the reference's alignment from the program's landmarks and
    float32 IRv1, as in the pipeline cells.
"""

from __future__ import annotations

import gc
import time
from collections import deque

import numpy as np
import torch

from benchmark.core import retina_work, seeds, weights
from benchmark.core.trace import NullTracer
from benchmark.drivers.embed import irv1_tree
from benchmark.drivers.pipeline import scene_batches
from benchmark.reference import irv1, mtcnn, retinaface

KEYS = ('embeddings', 'boxes', 'scores', 'valid', 'landmarks', 'candidates')
HEADS = ('conf', 'loc', 'landm')
DETECT_SPANS = ('retinaface.backbone', 'retinaface.neck', 'retinaface.heads',
                'retinaface.decode', 'retinaface.nms')
# 'control' is the reference at fp8 in the program's place; 'altered',
# 'half_batch', 'channels' (the frames fed in BGR order) and 'variance'
# (the decode's two variances swapped) are planted faults
VARIANTS = ('program', 'control', 'altered', 'half_batch', 'channels',
            'variance')


def retina_tree(detector, seed, device):
    """The cell's RetinaFace weights on `device` (`weights.make`, from a
    stream of the seed apart from IRv1's)."""
    return weights.make(retinaface.spec(detector),
                        seeds.derive(seed, 'retinaface'), device)


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
        self.outputs = []
        if run.variant != 'control':
            self._build()
            run.mark('program')
        self.pool = scene_batches(run.seed, run.device,
                                  int(tr['pool_batches']), self.batch,
                                  self.shape, tr)
        run.mark('inputs')
        if run.variant != 'control':
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
        params = retinaface.published_state(
            retina_tree(det, run.seed, run.device))
        self.pipe = FacePipeline(
            facenet, image_shape=self.shape, align=tr['align'],
            num_faces=self.k, device=run.device, detector='retinaface',
            params=params, dtype=getattr(torch, det['dtype']),
            confidence_threshold=det['confidence_threshold'],
            top_k=det['top_k'], nms_threshold=det['nms_threshold'],
            keep_top_k=det['keep_top_k'])
        del params
        self.backend = self.pipe.backend
        if run.variant == 'variance':
            self.backend.variances = self.backend.variances[::-1]
        self.dispatch = {'altered': self._altered,
                         'half_batch': self._half_batch,
                         'channels': self._channels}.get(
                             run.variant, self.pipe.dispatch)

    def _frames(self, frames):
        """The frames as the variant feeds them to the program."""
        if self.run.variant == 'channels':
            return np.ascontiguousarray(frames[..., ::-1])
        return frames

    def _altered(self, frames):
        """A fault planted where answers are produced: every 16th frame's
        first slot comes back as the next frame's."""
        out = dict(self.pipe.dispatch(frames))
        for key in KEYS[:5]:
            value = out[key].clone()
            value[::16, 0] = value[1::16, 0]
            out[key] = value
        return out

    def _half_batch(self, frames):
        """A fault: the second half of the batch left out, its frames
        coming back with no valid slot."""
        out = dict(self.pipe.dispatch(frames))
        valid = out['valid'].clone()
        valid[frames.shape[0] // 2:] = False
        out['valid'] = valid
        return out

    def _channels(self, frames):
        """A fault in the input convention: the frames reach the program
        in BGR order, which it then swaps once more."""
        return self.pipe.dispatch(self._frames(frames))

    def _loop(self, count, deadline, tracer, issue=None, keep=None):
        n = len(self.pool)
        inflight = deque()

        def fetch():
            k, out = inflight.popleft()
            with tracer.span('bench.fetch'):
                host = {key: out[key].cpu().numpy() for key in KEYS}
                host.update({f'overflow_{key}': value.cpu().numpy()
                             for key, value in out['overflow'].items()})
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
        from facenet_tpu_torch.utils import profiling

        run, cfg = self.run, self.run.config
        if run.variant == 'control':
            run.counters.update(units=0, window_s=seconds)
            return
        issue = []
        if run.trace:
            profiling.span_summary(reset=True)
            profiling.record_spans(True)
        t0 = time.perf_counter()
        try:
            self._loop(None, t0 + seconds, NullTracer(), issue, self.outputs)
        finally:
            elapsed = time.perf_counter() - t0
            if run.trace:
                profiling.record_spans(False)
                spans = profiling.span_summary(reset=True)
        # the program's dense outputs of every pool batch, rerun, and the
        # reference's selection on them: judged in `judge`, and counting
        # here the pair tests greedy NMS needs on each batch's candidates
        self.reruns = [self._program_dense(i) for i in range(len(self.pool))]
        self.selected = [self._select(r[:3]) for r in self.reruns]
        top_k = self.det['top_k']
        work = [retina_work.nms_work(np.minimum(s['over'], top_k),
                                     s['tested'], top_k)
                for s, _, _ in self.selected]
        counters = dict(
            units=len(self.outputs), scenes=len(self.outputs) * self.batch,
            window_s=elapsed, issue_s=float(np.mean([d for _, d in issue])),
            unit_times=[t - t0 for t, _ in issue],
            flops_per_batch=retina_work.pipeline_flops(
                self.det, cfg['embedding'], self.batch, self.k),
            nms_ops=float(np.mean([ops for ops, _ in work])),
            nms_bytes=float(np.mean([nbytes for _, nbytes in work])))
        if run.trace:
            counters['detect_issue_s'] = sum(
                spans[name]['total_s'] for name in DETECT_SPANS
                if name in spans) / max(len(issue), 1)
        run.counters.update(counters)

    def stretch(self, units, tracer):
        if self.run.variant != 'control':
            self._loop(units, None, tracer)

    # -- the program's dense outputs, rerun after the window --------------
    def _program_dense(self, index, chunk=8):
        """The program's float32 (logits, box deltas, landmark deltas) and
        its decode (boxes, landmarks in pixels) of pool batch `index`, as
        host arrays."""
        parts = []
        with torch.inference_mode():
            for s in range(0, self.batch, chunk):
                frames = self.backend.to_device(
                    self._frames(self.pool[index, s:s + chunk]))
                conf, loc, landm = self.backend.dense(frames)
                boxes, landmarks = self.backend.decode(loc, landm)
                parts.append([t.cpu().numpy()
                              for t in (conf, loc, landm, boxes, landmarks)])
        return [np.concatenate(p) for p in zip(*parts)]

    # -- the reference -----------------------------------------------------
    def _reference_net(self, precision=irv1.FLOAT32):
        run = self.run
        return retinaface.Net(
            retinaface.Tree(retina_tree(self.det, run.seed, run.device)),
            self.det, precision)

    def _reference_dense(self, net, index, chunk=2):
        """The reference network's (logits, box deltas, landmark deltas) of
        pool batch `index`, float32 host arrays."""
        parts = []
        with torch.no_grad():
            for s in range(0, self.batch, chunk):
                x = torch.from_numpy(self.pool[index, s:s + chunk]).to(
                    self.run.device)
                parts.append([t.cpu().numpy() for t in net.forward(x)])
        return [np.concatenate(p) for p in zip(*parts)]

    def _select(self, dense):
        """The reference's selection on dense outputs (host arrays), and
        its decode of every prior."""
        device = self.run.device
        conf, loc, landm = (torch.from_numpy(a).to(device) for a in dense)
        sel = retinaface.select(conf, loc, landm, self.det)
        h, w = self.det['image_shape']
        prior = retinaface.priors(self.det, (h, w)).to(device)
        boxes = retinaface.decode(loc, prior, self.det['variance']) \
            * torch.tensor([w, h, w, h], dtype=torch.float32, device=device)
        landmarks = retinaface.decode_landm(
            landm, prior, self.det['variance']) \
            * torch.tensor([w, h] * 5, dtype=torch.float32, device=device)
        return ({k: v.cpu().numpy() for k, v in sel.items()},
                boxes.cpu().numpy(), landmarks.cpu().numpy())

    def _embed(self, index, landmarks, valid, precision=irv1.FLOAT32,
               chunk=4):
        """Reference embeddings [B, k, D] of pool batch `index`'s faces,
        aligned from `landmarks` (zeros where not `valid`)."""
        run, emb = self.run, self.run.config['embedding']
        size = emb['image_size']
        net = irv1.Net(irv1.Tree(irv1_tree(emb, run.seed, run.device)),
                       emb['topology'], precision=precision)
        out = np.zeros(valid.shape + (emb['topology']['output']['size'],),
                       np.float32)
        placeholder = (mtcnn.TEMPLATE_112 * (size / 112.0)).astype(np.float32)
        with torch.no_grad():
            for s in range(0, self.batch, chunk):
                frames = torch.from_numpy(self.pool[index, s:s + chunk]).to(
                    run.device)
                # an empty slot's landmarks may be degenerate: align the
                # template itself there (its embedding is unused)
                lmk = np.where(valid[s:s + chunk, ..., None, None],
                               landmarks[s:s + chunk], placeholder)
                crops = mtcnn.align_landmarks(
                    frames, torch.from_numpy(lmk).to(run.device), size)
                faces = mtcnn.to_uint8(crops).reshape(-1, size, size, 3)
                e = net.embeddings(faces).float().cpu().numpy()
                out[s:s + chunk] = e.reshape(out[s:s + chunk].shape)
        return np.where(valid[..., None], out, 0)

    def _control(self):
        """The reference at fp8 in the program's place: its dense outputs,
        decode and selection on every pool batch, and its outputs as the
        window's batches."""
        net = self._reference_net(irv1.FP8)
        dense, decoded = [], []
        for index in range(len(self.pool)):
            d = self._reference_dense(net, index)
            sel, boxes, landmarks = self._select(d)
            out = {key: sel[key][:, :self.k]
                   for key in ('boxes', 'scores', 'valid', 'landmarks')}
            out['candidates'] = np.minimum(sel['over'], self.det['top_k'])
            out['overflow_topk'] = np.maximum(
                sel['over'] - self.det['top_k'], 0)
            out['overflow_keep'] = np.maximum(
                sel['kept'] - self.det['keep_top_k'], 0)
            out['embeddings'] = self._embed(index, out['landmarks'],
                                            out['valid'], irv1.FP8)
            self.outputs.append((index, out))
            dense.append(d)
            decoded.append((boxes, landmarks))
        return dense, decoded

    def judge(self):
        run = self.run
        n = len(self.pool)
        if run.variant != 'control':
            dense = [r[:3] for r in self.reruns]
            decoded = [r[3:] for r in self.reruns]
            selected = self.selected
            self.reruns = self.selected = None
        self.pipe = self.backend = self.dispatch = None
        gc.collect()
        if run.device != 'cpu':
            torch.cuda.empty_cache()
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            if run.variant == 'control':
                dense, decoded = self._control()
                selected = [self._select(d) for d in dense]
            net = self._reference_net()
            refs = [self._reference_dense(net, i) for i in range(n)]
            del net
            rng = seeds.host_rng(run.seed, 'sample')
            picks = rng.choice(len(self.outputs),
                               size=min(int(run.traffic['sample_batches']),
                                        len(self.outputs)), replace=False)
            gaps = []
            for i in sorted(picks):
                k, out = self.outputs[i]
                ref = self._embed(k % n, out['landmarks'], out['valid'])
                d = np.linalg.norm(out['embeddings'] - ref, axis=-1)
                gaps.append(d[out['valid']])
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        heads = [head_gaps(d, r) for d, r in zip(dense, refs)]
        decode = max(decode_gap(*prog, boxes, landmarks)
                     for prog, (_, boxes, landmarks) in zip(decoded,
                                                            selected))
        found = [compare_selection(out, selected[k % n][0], self.k,
                                   self.det)
                 for k, out in self.outputs]
        mismatched = sum(f['mismatched'] for f in found)
        expected = sum(f['expected'] for f in found)
        gaps = np.concatenate(gaps) if gaps else np.zeros(0)
        readings = {
            'head_gap': max(g['largest'] for g in heads),
            'head_gap_mean': max(g['mean'] for g in heads),
            'selection_mismatch': mismatched / max(expected, 1),
            'decode_gap': decode,
            'embed_gap': float(gaps.max()) if gaps.size else 0.0,
            'embed_gap_mean': float(gaps.mean()) if gaps.size else 0.0,
        }
        detail = {'batches': len(self.outputs), 'compared_slots': expected,
                  'mismatched_slots': mismatched,
                  'compared_faces': int(gaps.size),
                  'candidates': float(np.mean([s['over'].clip(
                      max=self.det['top_k']).mean() for s, _, _ in selected])),
                  'kept': float(np.mean([s['kept'].mean()
                                         for s, _, _ in selected])),
                  'head_gaps': heads}
        return readings, detail


def head_gaps(program, reference):
    """{'largest', 'mean', by head}: per head the largest and the mean
    |program - reference| over the reference's RMS; 'largest' and 'mean'
    the largest over the heads."""
    out = {}
    for name, p, r in zip(HEADS, program, reference):
        rms = max(float(np.sqrt(np.mean(np.square(r, dtype=np.float64)))),
                  1e-12)
        d = np.abs(p.astype(np.float64) - r)
        out[name] = [float(d.max()) / rms, float(d.mean()) / rms]
    out['largest'] = max(v[0] for v in out.values())
    out['mean'] = max(v[1] for k, v in out.items() if k in HEADS)
    return out


def _difference(a, b):
    """|a - b|, 0 where both are equal (inf or NaN included)."""
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(invalid='ignore'):
        d = np.abs(a.astype(np.float64) - b)
    return np.where(same, 0.0, np.where(np.isnan(d), np.inf, d))


def decode_gap(boxes, landmarks, ref_boxes, ref_landmarks):
    """Largest box-edge or landmark-coordinate difference over every prior,
    over the reference box's longer side (at least 1 px)."""
    side = np.maximum(np.maximum(ref_boxes[..., 2] - ref_boxes[..., 0],
                                 ref_boxes[..., 3] - ref_boxes[..., 1]), 1.0)
    side = np.where(np.isfinite(side), side, 1.0)[..., None]
    return float(max((_difference(boxes, ref_boxes) / side).max(),
                     (_difference(landmarks, ref_landmarks) / side).max()))


def compare_selection(out, ref, k, detector):
    """One window batch's detections (its first k slots, its counts)
    against the reference's selection on the same dense outputs:
    {'mismatched': slots that differ at all plus frames whose counts
    differ, 'expected': the reference's valid slots among its first k}."""
    mismatched = expected = 0
    cap = detector['keep_top_k']
    counts = (
        (out['candidates'], np.minimum(ref['over'], detector['top_k'])),
        (out['overflow_topk'], np.maximum(ref['over'] - detector['top_k'],
                                          0)),
        (out['overflow_keep'], np.maximum(ref['kept'] - cap, 0)))
    for f in range(out['valid'].shape[0]):
        rv = ref['valid'][f, :k]
        expected += int(rv.sum())
        pv = out['valid'][f]
        same = pv == rv
        for key in ('boxes', 'scores', 'landmarks'):
            a = out[key][f].reshape(k, -1)
            b = ref[key][f, :k].reshape(k, -1)
            same &= (_difference(a, b) == 0).all(-1) | ~rv
        mismatched += int((~same).sum())
        mismatched += int(any(int(p[f]) != int(r[f]) for p, r in counts))
    return {'mismatched': mismatched, 'expected': expected}
