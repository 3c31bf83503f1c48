"""Training: ``train.softmax.SoftmaxTrainer.train_epoch`` on the train_softmax
app's settings, over host (images, labels) batches cycled from a pool made
from the seed.

Traffic keys: ``batch``, ``pool_batches`` (distinct batches, at least
``compared_steps`` + 1), ``faces``, ``compared_steps``, ``trace``
({skip, units}).

Set-up builds the trainer and its state once and drives that same state
through its first ``compared_steps`` steps, each through ``train_epoch``
with one batch of the pool, all batches distinct; the window then goes on
with the same state. Its rate counts every image of every step the
window ran, over its whole length, which a synchronize closes (reading
the last step's metrics).

Correctness: the plain reference (`reference.irv1.train_steps`, float32,
TF32 off) follows the same first steps from the same weights and batches.
Compared: each step's loss (``loss_gap``, relative); the first gradient of
each leaf as the program's Adam got it, worked out from its first moment
after one step (``grad_gap``); each leaf's change over the steps, the
state as the next step finds it (``step_gap``). A leaf's gap is
|norm(program) - norm(reference)| over the larger of the reference's
norm and the median leaf's; leaves whose reference gradient is under a
thousandth of the median leaf's are left out (round-off moves them).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.core import images, seeds, weights, work
from benchmark.drivers.embed import irv1_tree
from benchmark.reference import irv1

# 'program' is the cell; 'control' the reference at fp8 in the program's
# place (a stand-in: the reference at a precision); 'frozen' and
# 'half_batch' planted faults
VARIANTS = ('program', 'control', 'frozen', 'half_batch')
STAND_INS = {'control': irv1.FP8}
BETA1 = 0.9


def piecewise_lr(schedule, steps_per_epoch):
    """The learning rate at a step of a [[epoch, lr], ...] schedule: the
    first row whose epoch lies beyond the step's."""
    def lr(step):
        epoch = step // steps_per_epoch
        return next((v for e, v in schedule if epoch < e), schedule[-1][1])
    return lr


def program_name(name):
    """A leaf of the classifier's flax tree under the reference's name."""
    if name.startswith('backbone/'):
        name = name[len('backbone/'):]
    return f'params/{name}'


def leaf_norms(tree):
    """{reference name: float64 norm} of a classifier's ``params`` tree."""
    return {program_name(k): float(np.linalg.norm(v.astype(np.float64)))
            for k, v in weights.flat(tree).items()}


def leaf_gaps(got, want, keep):
    """{leaf: |got - want| over max(want, the median leaf's want)} over the
    leaves in `keep`."""
    median = float(np.median([want[k] for k in keep]))
    return {k: abs(got[k] - want[k]) / max(want[k], median) for k in keep}


class Session:

    def __init__(self, run):
        if run.variant not in (*VARIANTS, *STAND_INS):
            raise ValueError(f'unknown variant {run.variant!r}')
        self.run = run
        cfg, tr = run.config, run.traffic
        tc = cfg['training']
        self.batch = int(tr['batch'])
        self.classes = int(tc['classes'])
        self.steps = int(tr.get('compared_steps', 3))
        n = int(tr['pool_batches'])
        if n <= self.steps:
            raise ValueError('pool_batches must exceed compared_steps')
        self.pool = images.face_batches(run.seed, run.device, n, self.batch,
                                        int(tr.get('faces', 64)),
                                        cfg['image_size'])
        self.labels = images.labels(run.seed, run.device, n, self.batch,
                                    self.classes)
        run.mark('inputs')
        self.lr = piecewise_lr(tc['train']['learning_rate']['schedule'],
                               int(tc['train']['epoch']['size']))
        self.losses, self.grad, self.change = [], None, None
        if run.variant in STAND_INS:
            # the reference in the program's place: no program, no window
            self.losses, self.grad, self.change = self._reference(
                STAND_INS[run.variant])
            return
        self._build()
        run.mark('weights loaded')
        self._first_steps()
        run.mark('first steps')

    # -- the program ----------------------------------------------------------
    def _build(self):
        from facenet_tpu_torch.config import Config
        from facenet_tpu_torch.train.softmax import SoftmaxTrainer

        run, cfg = self.run, self.run.config
        tc = cfg['training']
        train_cfg = Config({'image': tc['image'], 'train': tc['train'],
                            'loss': tc['loss'], 'mesh': tc['mesh']})
        model_cfg = Config({'module': 'inception_resnet_v1',
                            'config': cfg['topology']})
        dtype = getattr(torch, cfg['dtype'])
        if dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.trainer = SoftmaxTrainer(train_cfg, self.classes,
                                      model_cfg=model_cfg, device=run.device,
                                      dtype=dtype)
        self.state = self.trainer.init_state(
            seed=seeds.derive(run.seed, 'init') % (2 ** 32))
        run.mark('trainer')
        leaves = irv1_tree(cfg, run.seed, run.device, self.classes,
                           trained_stats=False)
        run.mark('weights')
        start = weights.nested_numpy(
            leaves, rename=lambda k: k.replace('params/', 'params/backbone/')
            .replace('batch_stats/', 'batch_stats/backbone/')
            .replace('backbone/logits/', 'logits/'))
        del leaves
        self.state.model.from_flax_variables(start)
        self.start = start['params']
        if run.variant == 'frozen':
            self._freeze()
        if run.variant == 'half_batch':
            self._half_batch()

    def _freeze(self):
        """A fault: a step that returns its state unchanged."""
        trainer = self.trainer
        step = trainer.step_fn

        def frozen(state, images, labels):
            saved = {k: v.clone() for k, v in
                     state.model.state_dict().items()}
            state, metrics = step(state, images, labels)
            state.model.load_state_dict(saved)
            return state, metrics

        trainer._step_fns[False] = frozen

    def _half_batch(self):
        """A fault: half of the batch left out, the mean over the rest."""
        trainer = self.trainer
        step = trainer.step_fn

        def half(state, images, labels):
            keep = images.shape[0] // 2
            return step(state, images[:keep], labels[:keep])

        trainer._step_fns[False] = half

    def _epoch(self, batches):
        return self.trainer.train_epoch(self.state, batches, epoch=0,
                                        log_every=0)

    def _params_tree(self, values=None):
        """The classifier's ``params`` tree as the program dumps it; with
        `values` ({parameter: tensor}), of those in the parameters' place."""
        model = self.state.model
        if values is None:
            return model.to_flax_variables()['params']
        saved = [(p, p.data) for p in model.parameters()]
        try:
            for p, _ in saved:
                p.data = values[p]
            return model.to_flax_variables()['params']
        finally:
            for p, data in saved:
                p.data = data

    def _first_steps(self):
        for i in range(self.steps):
            self.state, metrics = self._epoch(
                [(self.pool[i], self.labels[i])])
            self.losses.append(metrics['loss'])
            if i == 0:
                adam = self.state.optimizer.state
                first = {p: adam[p]['exp_avg'] / (1 - BETA1)
                         for p in self.state.model.parameters()}
                self.grad = leaf_norms(self._params_tree(first))
                del first
        after = weights.flat(self._params_tree())
        before = weights.flat(self.start)
        self.change = {program_name(k): float(np.linalg.norm(
            after[k].astype(np.float64) - before[k])) for k in after}
        del self.start

    def _feed(self, start, deadline=None, count=None, tracer=None,
              times=None):
        n = len(self.pool)
        k = start
        while (time.perf_counter() < deadline if count is None
               else k < start + count):
            if times is not None:
                times.append(time.perf_counter())
            if tracer is None:
                yield self.pool[k % n], self.labels[k % n]
            else:
                with tracer.span('bench.feed'):
                    batch = self.pool[k % n], self.labels[k % n]
                yield batch
            k += 1

    def window(self, seconds):
        if self.run.variant in STAND_INS:
            self.run.counters.update(images=0, window_s=seconds)
            return
        times = []
        t0 = time.perf_counter()
        self.state, metrics = self._epoch(
            self._feed(self.steps, deadline=t0 + seconds, times=times))
        elapsed = time.perf_counter() - t0
        timer = self.trainer.timer
        cfg = self.run.config
        self.next = self.steps + int(metrics['steps'])
        self.run.counters.update(
            images=int(metrics['steps']) * self.batch,
            units=int(metrics['steps']), window_s=elapsed,
            steps=int(metrics['steps']),
            issue_s=timer.total_s / max(timer.count, 1),
            unit_times=[t - t0 for t in times[:int(metrics['steps'])]],
            flops_per_image=work.irv1_train_flops(
                cfg['topology'], self.classes, cfg['image_size']))

    def stretch(self, units, tracer):
        if self.run.variant in STAND_INS:
            return
        with tracer.span('bench.train_epoch'):
            self.state, _ = self._epoch(
                self._feed(self.next, count=units, tracer=tracer))

    # -- the reference --------------------------------------------------------
    def _reference(self, precision=irv1.FLOAT32):
        """(losses, first-gradient norms, change norms) of the plain steps."""
        run, cfg = self.run, self.run.config
        leaves = irv1_tree(cfg, run.seed, run.device, self.classes,
                           trained_stats=False)
        leaves = {k: v for k, v in leaves.items() if k.startswith('params/')}
        losses, grad = [], {}

        def on_step(i, loss, grads):
            losses.append(loss)
            if i == 0:
                grad.update({k: float(g.double().norm())
                             for k, g in grads.items()})

        batches = [(torch.from_numpy(self.pool[i]).to(run.device),
                    torch.from_numpy(self.labels[i]).to(run.device))
                   for i in range(self.steps)]
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            after = irv1.train_steps(
                leaves, cfg['topology'], batches, self.classes, self.lr,
                cfg['training']['train']['adam_epsilon'], precision=precision,
                remat=run.device != 'cpu', on_step=on_step)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        change = {k: float((after[k] - leaves[k]).double().norm())
                  for k in after}
        return losses, grad, change

    def judge(self):
        run = self.run
        self.trainer = self.state = None
        gc.collect()
        if run.device != 'cpu':
            torch.cuda.empty_cache()
        losses, grad, change = self._reference()
        median = float(np.median(list(grad.values())))
        keep = [k for k, g in grad.items() if g >= 1e-3 * median]
        grad_rel = leaf_gaps(self.grad, grad, keep)
        step_rel = leaf_gaps(self.change, change, keep)
        readings = {
            'loss_gap': max(abs(a - b) / abs(b)
                            for a, b in zip(self.losses, losses)),
            'grad_gap': max(grad_rel.values()),
            'step_gap': max(step_rel.values()),
            'grad_gap_median': float(np.median(list(grad_rel.values()))),
            'step_gap_median': float(np.median(list(step_rel.values()))),
        }
        worst = {
            'grad': [(k, grad_rel[k], self.grad[k], grad[k]) for k in
                     sorted(grad_rel, key=grad_rel.get)[-6:]],
            'step': [(k, step_rel[k], self.change[k], change[k]) for k in
                     sorted(step_rel, key=step_rel.get)[-6:]],
            'left_out': sorted(set(grad) - set(keep)),
            'losses': [self.losses, losses]}
        return readings, worst
