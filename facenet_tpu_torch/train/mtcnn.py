"""MTCNN cascade training: the multi-task loss with online hard example
mining, a stage trainer per net, and the training-crop sampler.

Following the MTCNN paper's recipe (Zhang et al. 2016, arXiv:1604.02878,
sections II-B and III-A), as the JAX package trains the cascade
(facenet_tpu/train/mtcnn.py):

  * three sample kinds drive three losses: face classification (2-class
    softmax cross-entropy), box regression (L2 to normalized offsets) and
    5-landmark regression (L2);
  * sample-type masks pick the losses of each crop: negatives (IoU < 0.3)
    classification only; positives (IoU > 0.65) classification and box;
    part faces (0.4-0.65) box only; landmark crops landmarks only;
  * online hard example mining: only the hardest 70% of the
    classification losses in a batch count, selected by a threshold at
    the sorted losses (fixed shapes, no ragged selection);
  * task weights: P- and R-Net (cls 1.0, box 0.5, lmk 0.5), O-Net (cls
    1.0, box 0.5, lmk 1.0).

The nets are the port's `PNet`/`RNet`/`ONet` in their ``logits=True``
form; a step is torch Adam on the device. `generate_training_crops` is
host numpy and draws from a ``np.random.RandomState`` in the JAX package's
order, so its crops are bit-equal.

Sample type codes: 0 = negative, 1 = positive, 2 = part face, 3 = landmark.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from facenet_tpu_torch.detectors.mtcnn.networks import (
    ONet, PNet, RNet, flax_tree, lecun_init_, no_tf32, normalize_crops,
    worst_leaf_gap)
from facenet_tpu_torch.device import resolve_device
from facenet_tpu_torch.logging import logger

NEGATIVE, POSITIVE, PART, LANDMARK = 0, 1, 2, 3

# task weights per net (paper section III-A)
TASK_WEIGHTS = {
    'pnet': {'cls': 1.0, 'box': 0.5, 'lmk': 0.5},
    'rnet': {'cls': 1.0, 'box': 0.5, 'lmk': 0.5},
    'onet': {'cls': 1.0, 'box': 0.5, 'lmk': 1.0},
}

INPUT_SIZE = {'pnet': 12, 'rnet': 24, 'onet': 48}

OHEM_KEEP = 0.7     # hardest 70% of cls losses kept (paper section II-B)


def multitask_loss(cls_logits, box_pred, lmk_pred, labels, box_target,
                   lmk_target, sample_type, weights, ohem_keep=OHEM_KEEP):
    """Masked multi-task MTCNN loss over one batch.

    :param cls_logits: [B, 2]; box_pred [B, 4]; lmk_pred [B, 10] (or None)
    :param labels: [B] 0/1 face label (meaningful for neg/pos samples)
    :param sample_type: [B] codes (NEGATIVE/POSITIVE/PART/LANDMARK)
    :returns: (total, metrics dict of tensors)
    """
    b = cls_logits.shape[0]
    st = sample_type
    labels = labels.long()

    # classification with OHEM over the negative and positive samples
    cls_mask = ((st == NEGATIVE) | (st == POSITIVE)).float()
    logp = F.log_softmax(cls_logits, dim=-1)
    ce = -logp.gather(1, labels[:, None])[:, 0] * cls_mask

    # the hardest `ohem_keep` share of the eligible samples: a threshold
    # at the sorted masked losses
    n_eligible = torch.clamp(cls_mask.sum(), min=1.0)
    n_keep = torch.clamp(torch.floor(n_eligible * ohem_keep), min=1.0)
    sorted_ce = torch.sort(ce, descending=True).values  # zeros last
    kth = sorted_ce[torch.clamp(n_keep.long() - 1, 0, b - 1)]
    keep = (ce >= kth) & (cls_mask > 0)
    cls_loss = (torch.where(keep, ce, 0.0).sum() /
                torch.clamp(keep.float().sum(), min=1.0))

    acc = ((cls_logits.argmax(dim=1) == labels) * cls_mask).sum() / n_eligible

    # box regression over the positive and part samples
    box_mask = ((st == POSITIVE) | (st == PART)).float()
    box_se = torch.square(box_pred - box_target).sum(dim=1) * box_mask
    box_loss = box_se.sum() / torch.clamp(box_mask.sum(), min=1.0)

    total = weights['cls'] * cls_loss + weights['box'] * box_loss
    metrics = {'cls_loss': cls_loss, 'box_loss': box_loss,
               'cls_accuracy': acc}

    # landmark regression over the landmark samples
    if lmk_pred is not None:
        lmk_mask = (st == LANDMARK).float()
        lmk_se = torch.square(lmk_pred - lmk_target).sum(dim=1) * lmk_mask
        lmk_loss = lmk_se.sum() / torch.clamp(lmk_mask.sum(), min=1.0)
        total = total + weights['lmk'] * lmk_loss
        metrics['lmk_loss'] = lmk_loss

    metrics['loss'] = total
    return total, metrics


class MTCNNTrainer:
    """Stage trainer for one cascade net ('pnet' | 'rnet' | 'onet').

    The state is {'optimizer': torch Adam over the net's parameters,
    'step': int}; `train_step` updates `net` in place and returns the state
    and the metrics as device tensors (no host sync).

    :param dtype: activation dtype (bfloat16, as JAX; float32 for tests)
    :param device: torch device; None means cuda (raises without a GPU)
    """

    def __init__(self, net='pnet', learning_rate=1e-3, dtype=torch.bfloat16,
                 ohem_keep=OHEM_KEEP, device=None):
        if net not in ('pnet', 'rnet', 'onet'):
            raise ValueError(f'unknown net {net}')
        self.net_name = net
        self.size = INPUT_SIZE[net]
        self.weights = TASK_WEIGHTS[net]
        self.ohem_keep = float(ohem_keep)
        self.learning_rate = float(learning_rate)
        self.device = resolve_device(device)
        self.net = {'pnet': PNet, 'rnet': RNet,
                    'onet': ONet}[net](dtype=dtype).to(self.device)

    def init_state(self, seed=0, params=None):
        """Load `params` (a flax tree, say JAX's carried state) or flax's
        initialization from a torch generator seeded with `seed`, and a
        fresh Adam."""
        if params is not None:
            self.net.from_flax_params(params)
        else:
            lecun_init_(self.net, torch.Generator().manual_seed(int(seed)))
        self.net.to(self.device).requires_grad_(True)
        return {'optimizer': torch.optim.Adam(
            self.net.parameters(), lr=self.learning_rate, betas=(0.9, 0.999),
            eps=1e-8), 'step': 0}

    def params_of(self, state):
        """The net's parameters as a flax tree of numpy arrays."""
        return self.net.to_flax_params()

    def first_moment(self, state):
        """Adam's first moment of every parameter, as a flax tree."""
        opt = state['optimizer']
        return flax_tree(self.net, lambda p: opt.state[p]['exp_avg'])

    def forward(self, crops):
        """Float crops [B, S, S, 3] (0-255) -> (cls logits [B, 2], box
        [B, 4], landmarks [B, 10] or None), float32."""
        out = self.net(normalize_crops(crops), logits=True)
        if self.net_name == 'onet':
            return out
        cls, box = out
        if self.net_name == 'pnet':
            # fully convolutional: a 12 x 12 input gives [B, 1, 1, *]
            cls = cls.reshape(cls.shape[0], 2)
            box = box.reshape(box.shape[0], 4)
        return cls, box, None

    def losses(self, crops, labels, box_targets, lmk_targets, sample_types):
        cls, box, lmk = self.forward(crops)
        return multitask_loss(cls, box, lmk, labels, box_targets,
                              lmk_targets, sample_types, self.weights,
                              self.ohem_keep)

    def train_step(self, state, crops, labels, box_targets, lmk_targets,
                   sample_types):
        """One Adam step on a batch of crops and their targets (numpy or
        tensors)."""
        d = self.device
        batch = (torch.as_tensor(crops).to(d, torch.float32),
                 torch.as_tensor(labels).to(d, torch.int64),
                 torch.as_tensor(box_targets).to(d, torch.float32),
                 torch.as_tensor(lmk_targets).to(d, torch.float32),
                 torch.as_tensor(sample_types).to(d, torch.int64))
        _, metrics = self.losses(*batch)
        opt = state['optimizer']
        opt.zero_grad(set_to_none=True)
        metrics['loss'].backward()
        opt.step()
        state['step'] += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    def train(self, state, batches, epochs=1, log_every=100):
        """Train over `batches` for `epochs` epochs.

        `batches` may be a factory (a callable returning a fresh iterable
        per epoch) or a re-iterable sequence; a plain generator is
        materialized when epochs > 1 so later epochs still run.
        """
        if not callable(batches) and epochs > 1 and iter(batches) is batches:
            batches = list(batches)
        metrics = None
        for epoch in range(epochs):
            epoch_batches = batches() if callable(batches) else batches
            for n, batch in enumerate(epoch_batches, 1):
                state, metrics = self.train_step(state, *batch)
                if log_every and n % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    logger.info(f'{self.net_name} epoch {epoch} step {n}: ' +
                                ' '.join(f'{k}={v:.4f}'
                                         for k, v in m.items()))
        return state, {k: float(v) for k, v in (metrics or {}).items()}


def step_on_devices(net, params, batch, devices=('cuda', 'cpu'),
                    learning_rate=1e-3):
    """One float32 `MTCNNTrainer` step of `net` from the same flax tree on
    each of two devices, cuDNN and cuBLAS kept off TF32: the check that
    the card's step is the CPU's.

    :param batch: (crops, labels, box targets, landmark targets, types)
    :return: ((metrics on the first device, on the second) as floats,
        worst): the largest over the leaves of Adam's first-moment
        difference over that leaf's largest entry on the second device
    """
    runs = []
    with no_tf32():
        for device in devices:
            trainer = MTCNNTrainer(net, learning_rate, dtype=torch.float32,
                                   device=device)
            state = trainer.init_state(params=params)
            state, metrics = trainer.train_step(state, *batch)
            runs.append(({k: float(v) for k, v in metrics.items()},
                         trainer.first_moment(state)))
    (first, m_first), (second, m_second) = runs
    return (first, second), worst_leaf_gap(m_first, m_second)


# ---------------------------------------------------------------------------
# Training-crop generation (host-side, numpy): boxes + IoU -> sample crops
# ---------------------------------------------------------------------------

def _iou_one_to_many(box, boxes):
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    a = max((box[2] - box[0]) * (box[3] - box[1]), 1e-10)
    b = np.maximum((boxes[:, 2] - boxes[:, 0]) *
                   (boxes[:, 3] - boxes[:, 1]), 1e-10)
    return inter / (a + b - inter)


def generate_training_crops(image, gt_boxes, out_size, rng,
                            n_negatives=16, n_per_box=8, gt_landmarks=None):
    """Sample (crop, label, box_target[, lmk_target], sample_type) tuples
    from one annotated image — the paper's pos/neg/part sampling
    (IoU 0.65/0.3/0.4), plus LANDMARK samples when 5-point annotations are
    provided.

    Box targets are the standard MTCNN normalized offsets
    ((gt - anchor) / anchor_side) for the crop window; landmark targets are
    the 5 points normalized to the crop window ((p - origin) / side),
    flattened [x1..x5, y1..y5] to match ONet's output layout.

    :param image: [H, W, 3] uint8; gt_boxes [G, 4] pixel (x1, y1, x2, y2)
    :param gt_landmarks: optional [G, 5, 2] pixel landmark annotations
    :returns: (crops [N,S,S,3] uint8, labels [N], box_targets [N,4],
        lmk_targets [N,10], sample_types [N])
    """
    h, w = image.shape[:2]
    s = int(out_size)
    crops, labels, targets, lmk_targets, types = [], [], [], [], []
    gt = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    lmks = (np.asarray(gt_landmarks, np.float32).reshape(-1, 5, 2)
            if gt_landmarks is not None else None)

    def emit(win, label, target, typ, lmk_t=None):
        x1, y1, x2, y2 = [int(round(v)) for v in win]
        x1c, y1c = max(x1, 0), max(y1, 0)
        x2c, y2c = min(x2, w), min(y2, h)
        if x2c - x1c < 4 or y2c - y1c < 4:
            return
        patch = image[y1c:y2c, x1c:x2c]
        # cheap nearest resize to the net input (training crops only)
        yi = np.linspace(0, patch.shape[0] - 1, s).astype(np.int32)
        xi = np.linspace(0, patch.shape[1] - 1, s).astype(np.int32)
        crops.append(patch[yi][:, xi])
        labels.append(label)
        targets.append(target)
        lmk_targets.append(lmk_t if lmk_t is not None
                           else np.zeros(10, np.float32))
        types.append(typ)

    # negatives: random windows with IoU < 0.3 to every gt box
    for _ in range(n_negatives * 4):
        if len([t for t in types if t == NEGATIVE]) >= n_negatives:
            break
        side = rng.randint(s, max(min(h, w) // 2, s + 1))
        x1 = rng.randint(0, max(w - side, 1))
        y1 = rng.randint(0, max(h - side, 1))
        win = np.array([x1, y1, x1 + side, y1 + side], np.float32)
        if gt.size and _iou_one_to_many(win, gt).max() >= 0.3:
            continue
        emit(win, 0, np.zeros(4, np.float32), NEGATIVE)

    # positives / part faces: jittered windows around each gt box
    for g in gt:
        gw, gh = g[2] - g[0], g[3] - g[1]
        if gw < 8 or gh < 8:
            continue
        for _ in range(n_per_box):
            side = rng.uniform(0.8, 1.25) * max(gw, gh)
            cx = (g[0] + g[2]) / 2 + rng.uniform(-0.2, 0.2) * gw
            cy = (g[1] + g[3]) / 2 + rng.uniform(-0.2, 0.2) * gh
            win = np.array([cx - side / 2, cy - side / 2,
                            cx + side / 2, cy + side / 2], np.float32)
            # windows extending past the border would be clipped by emit()
            # while targets/IoU were computed for the unclipped window —
            # discard them, as the paper's pipeline does
            if win[0] < 0 or win[1] < 0 or win[2] > w or win[3] > h:
                continue
            iou = _iou_one_to_many(win, g[None])[0]
            target = np.array([(g[0] - win[0]) / side,
                               (g[1] - win[1]) / side,
                               (g[2] - win[2]) / side,
                               (g[3] - win[3]) / side], np.float32)
            if iou > 0.65:
                emit(win, 1, target, POSITIVE)
            elif iou > 0.4:
                emit(win, 0, target, PART)

    # landmark samples: tight windows around annotated faces with the 5
    # points normalized into the window ([x1..x5, y1..y5], ONet layout)
    if lmks is not None:
        for g, pts in zip(gt, lmks):
            gw, gh = g[2] - g[0], g[3] - g[1]
            if gw < 8 or gh < 8:
                continue
            for _ in range(max(n_per_box // 2, 1)):
                side = rng.uniform(0.9, 1.1) * max(gw, gh)
                cx = (g[0] + g[2]) / 2 + rng.uniform(-0.1, 0.1) * gw
                cy = (g[1] + g[3]) / 2 + rng.uniform(-0.1, 0.1) * gh
                win = np.array([cx - side / 2, cy - side / 2,
                                cx + side / 2, cy + side / 2], np.float32)
                if win[0] < 0 or win[1] < 0 or win[2] > w or win[3] > h:
                    continue
                norm = (pts - win[None, :2]) / side
                if norm.min() < 0 or norm.max() > 1:
                    continue
                lmk_t = np.concatenate([norm[:, 0], norm[:, 1]]
                                       ).astype(np.float32)
                emit(win, 1, np.zeros(4, np.float32), LANDMARK, lmk_t)

    if not crops:
        return (np.zeros((0, s, s, 3), np.uint8), np.zeros(0, np.int32),
                np.zeros((0, 4), np.float32), np.zeros((0, 10), np.float32),
                np.zeros(0, np.int32))
    return (np.stack(crops).astype(np.uint8),
            np.asarray(labels, np.int32),
            np.stack(targets),
            np.stack(lmk_targets),
            np.asarray(types, np.int32))
