"""Batched RetinaFace-R50 detection with fixed shapes.

    det = RetinaFace(image_shape=(1080, 1920))     # device=None: cuda
    out = det.detect_batch(images_uint8)           # [B, H, W, 3] RGB
    out['boxes'], out['scores'], out['landmarks'], out['valid']

A batch runs on the device from the uint8 frames to fixed [B, keep_top_k]
outputs with no step back to the host, after biubug6's ``detect.py`` at
its ``origin_size``:

  * the frames' RGB turned to the published BGR, minus (104, 117, 123), no
    scaling; the network (`network.FoldedNet`) in ``dtype``, its heads
    float32;
  * decode of every prior; the face probability (softmax), kept when
    > ``confidence_threshold`` (0.02); the best ``top_k`` (5,000) by a
    stable descending sort, so tied scores keep index order;
  * greedy NMS at IoU ``nms_threshold`` (0.4) with py_cpu_nms's +1 pixel
    areas, through the kernel ``csrc/nms_greedy.cu`` on the card
    (`ops.nms.greedy_keep`);
  * the first ``keep_top_k`` (750) kept boxes, best first.

Spans (`utils.profiling`): ``retinaface.backbone``, ``retinaface.neck``
(FPN and SSH), ``retinaface.heads``, ``retinaface.decode`` (softmax,
decode, threshold, top-k) and ``retinaface.nms`` (the suppression and the
kept boxes' compaction).

The output's 'overflow' holds, a frame, the priors over the threshold that
the top-k capacity dropped ('topk') and the kept boxes that the keep
capacity dropped ('keep'); 'candidates' the candidates that entered the
NMS.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from facenet_tpu_torch.detectors.batched import BatchedDetector
from facenet_tpu_torch.detectors.retinaface import network
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.ops.nms import greedy_keep
from facenet_tpu_torch.utils import profiling


class RetinaFace(BatchedDetector):
    """Batched RetinaFace-R50 detector (the `BatchedDetector` front end).

    `detect_batch` returns numpy 'boxes' [B, K, 4], 'scores' [B, K],
    'landmarks' [B, K, 5, 2], 'valid' [B, K], 'candidates' [B] and the
    'overflow' counts.

    :param image_shape: (H, W) of the frames (letterbox inputs to it first,
        `detectors.mtcnn.letterbox.letterbox_batch`)
    :param params: a state dict by the published names (arrays or tensors,
        biubug6's ``Resnet50_Final.pth`` as loaded); None initialises the
        network at random from `seed`
    :param dtype: the network's activations (bfloat16; float32 for tests)
    :param device: torch device; None means cuda (raises without a GPU)
    """

    overflow_warning = ('RetinaFace capacity overflow: dropped %s (raise '
                        'top_k / keep_top_k for dense scenes)')

    def __init__(self, image_shape=(1080, 1920), params=None, seed=0,
                 dtype=torch.bfloat16, confidence_threshold=0.02, top_k=5000,
                 nms_threshold=0.4, keep_top_k=750, device=None):
        self.device = resolve_device(device)
        self.image_shape = (int(image_shape[0]), int(image_shape[1]))
        self.dtype = dtype
        self.confidence_threshold = float(confidence_threshold)
        self.nms_threshold = float(nms_threshold)
        self.keep_top_k = int(keep_top_k)
        self.variances = network.VARIANCES

        net = network.seeded_net(seed)
        if params is not None:
            net.load_weights(params)
        self.net = network.FoldedNet(net.eval(), dtype, self.device)
        h, w = self.image_shape
        self.priors = torch.from_numpy(network.prior_boxes(h, w)).to(
            self.device)
        self.top_k = min(int(top_k), self.priors.shape[0])
        self.box_scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                                      device=self.device)
        self.landmark_scale = torch.tensor([w, h] * 5, dtype=torch.float32,
                                           device=self.device)
        self.mean = torch.tensor(network.MEAN_BGR, device=self.device)

    # ------------------------------------------------------------------
    def preprocess(self, images):
        """uint8 RGB [B, H, W, 3] -> BGR minus the mean, NCHW channels-last
        in ``dtype``."""
        x = images.flip(-1).float() - self.mean
        return x.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=torch.channels_last)

    def dense(self, images):
        """The network's float32 outputs for every prior of uint8 frames on
        the device: (class logits [B, N, 2], box deltas [B, N, 4],
        landmark deltas [B, N, 10])."""
        return self.net(self.preprocess(images))

    def decode(self, loc, landm):
        """(boxes [B, N, 4], landmarks [B, N, 10]) in pixels."""
        boxes = network.decode(loc, self.priors, self.variances)
        landmarks = network.decode_landmarks(landm, self.priors,
                                             self.variances)
        return boxes * self.box_scale, landmarks * self.landmark_scale

    def select(self, conf, loc, landm):
        """Dense outputs -> the output dict (see the module docstring)."""
        b = conf.shape[0]
        k, cap = self.top_k, self.keep_top_k
        with profiling.annotate('retinaface.decode'):
            scores = F.softmax(conf, dim=-1)[..., 1]
            boxes, landmarks = self.decode(loc, landm)
            over = scores > self.confidence_threshold
            ranked, order = torch.sort(
                torch.where(over, scores, float('-inf')), dim=1,
                descending=True, stable=True)
            ranked, order = ranked[:, :k], order[:, :k]
            candidates = torch.isfinite(ranked)
            boxes = torch.gather(boxes, 1, order[..., None].expand(b, k, 4))
            landmarks = torch.gather(landmarks, 1,
                                     order[..., None].expand(b, k, 10))
        with profiling.annotate('retinaface.nms'):
            keep, kept = greedy_keep(boxes, candidates, self.nms_threshold,
                                     'union', offset=1.0, max_keep=cap)
            # the kept boxes to the front, in score order
            front = torch.argsort((~keep).to(torch.uint8), dim=1,
                                  stable=True)[:, :cap]
            valid = torch.gather(keep, 1, front)
            boxes = torch.gather(boxes, 1, front[..., None].expand(-1, -1, 4))
            landmarks = torch.gather(
                landmarks, 1, front[..., None].expand(-1, -1, 10))
            scores = torch.where(valid, torch.gather(ranked, 1, front), 0.0)
            if front.shape[1] < cap:         # fewer candidates than slots
                pad = cap - front.shape[1]
                boxes = F.pad(boxes, (0, 0, 0, pad))
                landmarks = F.pad(landmarks, (0, 0, 0, pad))
                scores = F.pad(scores, (0, pad))
                valid = F.pad(valid, (0, pad))
        return {
            'boxes': boxes,                           # [B, cap, 4]
            'scores': scores,
            'landmarks': landmarks.reshape(b, cap, 5, 2),
            'valid': valid,
            'overflow': {
                'topk': torch.clamp(over.sum(1, dtype=torch.int32) - k,
                                    min=0),
                'keep': torch.clamp(kept - cap, min=0)},
            'candidates': candidates.sum(1, dtype=torch.int32),
        }

    @torch.inference_mode()
    def _detect(self, images):
        """uint8 [B, H, W, 3] tensor on this device -> output dict of
        tensors (see the module docstring)."""
        return self.select(*self.dense(images))
