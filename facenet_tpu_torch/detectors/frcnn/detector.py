"""Two-stage Faster-RCNN face detector: batched inference and its trainer.

The JAX package's detector (facenet_tpu/detectors/frcnn/detector.py) on
torch: backbone, RPN, proposal top-k and NMS, RoIAlign on the stride-16
map, the box head, final top-k and NMS, over a batch of images with fixed
shapes (box buffers with validity masks, never ragged tensors). The convs
and dense layers are cuDNN and cuBLAS work; RoIAlign is
`ops.crop.crop_and_resize`, the crop kernel on the card (its plain version
on the CPU), the only hand-written kernel that runs here.

    det = FasterRCNN(image_shape=(480, 640))       # device=None: cuda
    out = det.detect_batch(images_uint8)
    out['boxes'], out['scores'], out['valid']      # [B, K, ...] numpy

The parameters travel as the JAX package's flax tree
({'backbone', 'rpn', 'head'} of numpy arrays): `from_flax_params` /
`to_flax_params`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from facenet_tpu_torch.detectors.batched import BatchedDetector
from facenet_tpu_torch.detectors.evaluation import iou_matrix
from facenet_tpu_torch.detectors.frcnn.network import (
    STRIDE, Backbone, RoIHead, RPN, anchor_grid, decode_deltas, encode_deltas)
from facenet_tpu_torch.detectors.mtcnn.networks import (
    flax_tree, lecun_init_, load_flax_tree, no_tf32, worst_leaf_gap)
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.ops.crop import crop_and_resize
from facenet_tpu_torch.ops.nms import batched_nms_mask, top_k_boxes


def _clip(boxes, h, w):
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
                       dim=-1)


class FasterRCNN(BatchedDetector):
    """Batched Faster-RCNN face detector (the `BatchedDetector` front end).

    `detect_batch` returns numpy 'boxes' [B, K, 4], 'scores' [B, K] and
    'valid' [B, K].

    :param image_shape: (H, W) of the letterboxed input
    :param threshold: face probability kept (the reference's 0.7)
    :param max_proposals: RPN proposals kept per image
    :param max_outputs: detections per image
    :param params: flax tree {'backbone', 'rpn', 'head'}; None initializes
        flax's way from a torch generator seeded with `seed`
    :param dtype: activation dtype (bfloat16, as JAX; float32 for tests)
    :param device: torch device; None means cuda (raises without a GPU)
    """

    def __init__(self, image_shape=(480, 640), threshold=0.7,
                 max_proposals=256, max_outputs=32, roi_size=7,
                 params=None, seed=0, dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.image_shape = (int(image_shape[0]), int(image_shape[1]))
        self.threshold = float(threshold)
        self.k_proposals = int(max_proposals)
        self.k_out = int(max_outputs)
        self.roi_size = int(roi_size)
        self.dtype = dtype

        self.backbone, self.rpn, self.head = self._networks().values()
        self.from_flax_params(params if params is not None
                              else self.init_params(seed))
        self.anchors = torch.from_numpy(
            anchor_grid(*self.image_shape)).to(self.device)

    def _networks(self):
        return {'backbone': Backbone(self.dtype), 'rpn': RPN(self.dtype),
                'head': RoIHead(self.dtype, self.roi_size)}

    def modules(self):
        """{'backbone', 'rpn', 'head'}: the detector's networks."""
        return {'backbone': self.backbone, 'rpn': self.rpn,
                'head': self.head}

    def init_params(self, seed=0):
        """A flax tree initialized as flax does (lecun normal kernels, zero
        biases), from a torch generator seeded with `seed`."""
        generator = torch.Generator().manual_seed(int(seed))
        return {name: flax_tree(lecun_init_(net, generator))
                for name, net in self._networks().items()}

    def from_flax_params(self, params):
        """Load a flax tree {'backbone', 'rpn', 'head'}; returns self."""
        for name, module in self.modules().items():
            load_flax_tree(module, params[name])
            module.to(self.device)
        return self

    def to_flax_params(self):
        """The parameters as the JAX package's flax tree of numpy arrays."""
        return {name: flax_tree(m) for name, m in self.modules().items()}

    # ------------------------------------------------------------------
    def features(self, images):
        """uint8 [B, H, W, 3] on the device -> (the NCHW stride-16 map in
        ``dtype``, RPN objectness [B, G*A], deltas [B, G*A, 4])."""
        x = images.permute(0, 3, 1, 2).float() / 255.0
        fmap = self.backbone(x)
        obj, deltas = self.rpn(fmap)
        return fmap, obj, deltas

    def _propose(self, images):
        """Stage 1: the feature map (NHWC, float32) and the RPN proposals
        in fixed [B, K] buffers."""
        h, w = self.image_shape
        fmap, obj, deltas = self.features(images)
        scores = torch.sigmoid(obj)
        boxes = _clip(decode_deltas(self.anchors[None], deltas), h, w)
        valid = ((boxes[..., 2] - boxes[..., 0] > 2) &
                 (boxes[..., 3] - boxes[..., 1] > 2))
        boxes, scores, valid = top_k_boxes(boxes, scores, valid,
                                           self.k_proposals)
        keep = batched_nms_mask(boxes, scores, valid, 0.7)
        return (fmap.permute(0, 2, 3, 1).float(), boxes, scores,
                valid & keep)

    def _detect(self, images):
        fmap, boxes, _, valid = self._propose(images)
        rois = crop_and_resize(fmap, boxes / STRIDE, self.roi_size)
        cls, reg = self.head(rois)

        probs = torch.softmax(cls, dim=-1)[..., 1]
        h, w = self.image_shape
        boxes = _clip(decode_deltas(boxes, reg), h, w)
        valid = valid & (probs >= self.threshold)
        boxes, probs, valid = top_k_boxes(boxes, probs, valid, self.k_out)
        valid = valid & batched_nms_mask(boxes, probs, valid, 0.3)
        return {'boxes': boxes, 'scores': torch.where(valid, probs, 0.0),
                'valid': valid}


# ---------------------------------------------------------------------------
# Training: RPN and head losses in one step
# ---------------------------------------------------------------------------

def match_anchors(anchors, gt_boxes, pos_iou=0.7, neg_iou=0.3):
    """Anchor-to-ground-truth matching on the host, for one image.

    :returns: (labels [N] int32: 1 positive, 0 negative, -1 ignored;
        targets [N, 4] float32 deltas of the positives)
    """
    n = len(anchors)
    labels = np.full(n, -1, np.int32)
    targets = np.zeros((n, 4), np.float32)
    gt = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    if not len(gt):
        labels[:] = 0
        return labels, targets

    iou = iou_matrix(anchors, gt)
    best_gt = iou.argmax(axis=1)
    best_iou = iou.max(axis=1)
    labels[best_iou < neg_iou] = 0
    labels[best_iou >= pos_iou] = 1
    # every gt keeps its best anchor positive
    labels[iou.argmax(axis=0)] = 1

    pos = labels == 1
    targets[pos] = encode_deltas(anchors[pos], gt[best_gt[pos]])
    return labels, targets


def _balanced(positive, negative):
    """Weights that give the positives and the negatives half each."""
    return (positive * 0.5 / torch.clamp(positive.sum(), min=1.0) +
            negative * 0.5 / torch.clamp(negative.sum(), min=1.0))


class FasterRCNNTrainer:
    """Joint RPN + head training of a `FasterRCNN`'s own modules by Adam.

    A step: the balanced RPN cross-entropy (positives and negatives half
    each, label -1 ignored), the Huber RPN box loss on the positives; the
    RoIs are the top K anchors' decoded boxes by ``(label == 1) + 0.001 *
    sigmoid(obj)``, cropped from the stride-16 map with no gradient into
    the backbone; the head's labels come from RoI-vs-ground-truth IoU
    > 0.5, with a balanced cross-entropy and a Huber box loss toward the
    best-overlapping box. Ground truth is padded to `MAX_GT` boxes with
    degenerate -1e4 boxes.

    The state is {'optimizer': torch Adam over the detector's parameters,
    'step': int}; `train_step` updates the detector in place and returns
    the state and the losses as device tensors (no host sync).
    """

    MAX_GT = 8

    def __init__(self, detector, learning_rate=1e-3):
        self.det = detector
        self.learning_rate = float(learning_rate)
        self.anchors_np = detector.anchors.cpu().numpy()

    def parameters(self):
        return [p for m in self.det.modules().values()
                for p in m.parameters()]

    def init_state(self, seed=0, params=None):
        """Load `params` (a flax tree, say JAX's carried state) or the
        detector's `init_params(seed)`, and a fresh Adam."""
        self.det.from_flax_params(params if params is not None
                                  else self.det.init_params(seed))
        for p in self.parameters():
            p.requires_grad_(True)
        return {'optimizer': torch.optim.Adam(
            self.parameters(), lr=self.learning_rate, betas=(0.9, 0.999),
            eps=1e-8), 'step': 0}

    def params_of(self, state):
        """The current parameters as a flax tree of numpy arrays."""
        return self.det.to_flax_params()

    def first_moment(self, state):
        """Adam's first moment of every parameter, as a flax tree."""
        opt = state['optimizer']
        return {name: flax_tree(m, lambda p: opt.state[p]['exp_avg'])
                for name, m in self.det.modules().items()}

    def make_targets(self, gt_boxes_per_image):
        """Host-side anchor matching for a batch -> stacked arrays."""
        labels, targets, gt_pad = [], [], []
        for gt in gt_boxes_per_image:
            lab, tgt = match_anchors(self.anchors_np, gt)
            labels.append(lab)
            targets.append(tgt)
            g = np.zeros((self.MAX_GT, 4), np.float32)
            gt = np.asarray(gt, np.float32).reshape(-1, 4)[:self.MAX_GT]
            g[:len(gt)] = gt
            g[len(gt):] = -1e4          # degenerate: IoU 0 with everything
            gt_pad.append(g)
        return np.stack(labels), np.stack(targets), np.stack(gt_pad)

    def losses(self, images, rpn_labels, rpn_targets, gt_boxes):
        """The four losses (device tensors) of one batch on the device."""
        det = self.det
        fmap, obj, deltas = det.features(images)

        lab = rpn_labels
        w = _balanced((lab == 1).float(), (lab == 0).float())
        ce = F.binary_cross_entropy_with_logits(
            obj, torch.clamp(lab, min=0).float(), reduction='none')
        rpn_cls = torch.sum(ce * w)

        pos = (lab == 1).float()[..., None]
        l1 = F.huber_loss(deltas, rpn_targets, reduction='none', delta=1.0)
        rpn_box = torch.sum(l1 * pos) / torch.clamp(pos.sum() * 4, min=1.0)

        with torch.no_grad():
            boxes = decode_deltas(det.anchors[None], deltas)
            score_for_roi = (lab == 1).float() + torch.sigmoid(obj) * 0.001
            roi_boxes, _, _ = top_k_boxes(boxes, score_for_roi,
                                          torch.ones_like(lab, dtype=bool),
                                          det.k_proposals)
            rois = crop_and_resize(fmap.permute(0, 2, 3, 1).float(),
                                   roi_boxes / STRIDE, det.roi_size)
        cls, reg = det.head(rois)

        with torch.no_grad():
            r, g = roi_boxes[..., None, :], gt_boxes[:, None, :, :]
            inter = (torch.clamp(torch.minimum(r[..., 2], g[..., 2]) -
                                 torch.maximum(r[..., 0], g[..., 0]), min=0) *
                     torch.clamp(torch.minimum(r[..., 3], g[..., 3]) -
                                 torch.maximum(r[..., 1], g[..., 1]), min=0))
            area_r = ((roi_boxes[..., 2] - roi_boxes[..., 0]) *
                      (roi_boxes[..., 3] - roi_boxes[..., 1]))[..., None]
            area_g = ((gt_boxes[..., 2] - gt_boxes[..., 0]) *
                      (gt_boxes[..., 3] - gt_boxes[..., 1]))[:, None, :]
            iou = inter / torch.clamp(area_r + area_g - inter, min=1e-10)
            head_lab = (iou.amax(dim=-1) > 0.5).long()
            hp = (head_lab == 1).float()
            hw = _balanced(hp, (head_lab == 0).float())

            best_gt = torch.gather(
                gt_boxes, 1, iou.argmax(dim=-1)[..., None].expand(-1, -1, 4))
            rw = torch.clamp(roi_boxes[..., 2] - roi_boxes[..., 0], min=1e-6)
            rh = torch.clamp(roi_boxes[..., 3] - roi_boxes[..., 1], min=1e-6)
            bw = torch.clamp(best_gt[..., 2] - best_gt[..., 0], min=1e-6)
            bh = torch.clamp(best_gt[..., 3] - best_gt[..., 1], min=1e-6)
            reg_t = torch.stack([
                (best_gt[..., 0] + bw / 2 - roi_boxes[..., 0] - rw / 2) / rw,
                (best_gt[..., 1] + bh / 2 - roi_boxes[..., 1] - rh / 2) / rh,
                torch.log(bw / rw), torch.log(bh / rh)], dim=-1)

        head_ce = -torch.gather(F.log_softmax(cls, dim=-1), -1,
                                head_lab[..., None])[..., 0]
        head_cls = torch.sum(head_ce * hw)
        l1h = F.huber_loss(reg, reg_t, reduction='none', delta=1.0)
        head_box = (torch.sum(l1h * hp[..., None]) /
                    torch.clamp(hp.sum() * 4, min=1.0))

        total = rpn_cls + rpn_box + head_cls + head_box
        return {'rpn_cls': rpn_cls, 'rpn_box': rpn_box,
                'head_cls': head_cls, 'head_box': head_box, 'loss': total}

    def train_step(self, state, images, gt_boxes_per_image):
        """One Adam step on a uint8 [B, H, W, 3] batch and its per-image
        [G, 4] ground-truth boxes (letterboxed pixels)."""
        device = self.det.device
        labels, targets, gt_pad = self.make_targets(gt_boxes_per_image)
        images = self.det.to_device(images)
        metrics = self.losses(images,
                              torch.from_numpy(labels).to(device),
                              torch.from_numpy(targets).to(device),
                              torch.from_numpy(gt_pad).to(device))
        opt = state['optimizer']
        opt.zero_grad(set_to_none=True)
        metrics['loss'].backward()
        opt.step()
        state['step'] += 1
        return state, {k: v.detach() for k, v in metrics.items()}


def step_on_devices(params, images, gt_boxes, devices=('cuda', 'cpu'),
                    learning_rate=1e-3):
    """One float32 `FasterRCNNTrainer` step from the same flax tree on each
    of two devices, cuDNN and cuBLAS kept off TF32: the check that the
    card's step is the CPU's.

    :return: ((metrics on the first device, on the second) as floats,
        worst): the largest over the leaves of Adam's first-moment
        difference over that leaf's largest entry on the second device
    """
    runs = []
    with no_tf32():
        for device in devices:
            det = FasterRCNN(image_shape=images.shape[1:3], params=params,
                             dtype=torch.float32, device=device)
            trainer = FasterRCNNTrainer(det, learning_rate)
            state = trainer.init_state(params=params)
            state, metrics = trainer.train_step(state, images, gt_boxes)
            runs.append(({k: float(v) for k, v in metrics.items()},
                         trainer.first_moment(state)))
    (first, m_first), (second, m_second) = runs
    return (first, second), worst_leaf_gap(m_first, m_second)
