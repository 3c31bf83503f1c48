"""Learning-rate schedules as plain Python functions of the step.

  * the epoch-boundary piecewise table [[epoch, lr], ...] (`LearningRateScheduler`
    per epoch, `piecewise_schedule` per step);
  * exponential decay lr0 * decay_rate ** floor(step / decay_steps);
  * a constant.

The trainer reads a schedule at the optimizer's update count before the
update, so update k (0-based) runs at ``schedule(k)``, and sets every param
group's ``lr`` to it before ``optimizer.step()``. Values are rounded to
float32, the precision the JAX package's schedules return.
"""

from __future__ import annotations

import math

import numpy as np


def _f32(value):
    return float(np.float32(value))


class LearningRateScheduler:
    """Piecewise epoch schedule.

    ``config.value`` overrides; otherwise ``config.schedule`` is a list of
    [epoch_boundary, lr] rows, and the lr of the first row whose boundary
    exceeds the current epoch is used (the last row's past the end).
    """

    def __init__(self, config):
        self.config = config
        self.default_value = config.value if config.value else None

    def __call__(self, epoch):
        if self.default_value is not None:
            return self.default_value

        learning_rate = self.config.schedule[-1][1]
        for (epoch_, learning_rate) in self.config.schedule:
            if epoch < epoch_:
                break

        return learning_rate


def piecewise_schedule(schedule, steps_per_epoch):
    """Step-wise version of `LearningRateScheduler`.

    :param schedule: [[epoch, lr], ...]
    :param steps_per_epoch: batches per epoch
    :return: fn(step) -> lr (float)
    """
    boundaries = [int(e) * int(steps_per_epoch) for e, _ in schedule]
    values = [_f32(v) for _, v in schedule]

    def fn(step):
        idx = sum(int(step) >= b for b in boundaries)       # 0..len
        return values[min(idx, len(values) - 1)]

    return fn


def constant_schedule(value):
    value = _f32(value)

    def fn(step):
        return value

    return fn


def exponential_decay_schedule(initial_value, decay_rate, decay_steps):
    """lr = lr0 * decay_rate ** floor(step / decay_steps)."""
    lr0 = float(initial_value)
    rate = float(decay_rate)
    steps = float(decay_steps)

    def fn(step):
        return _f32(lr0 * rate ** math.floor(int(step) / steps))

    return fn


def schedule_from_config(train_cfg, steps_per_epoch):
    """A step schedule from a train config (value or schedule table)."""
    lr_cfg = train_cfg.learning_rate
    if lr_cfg.value:
        return constant_schedule(lr_cfg.value)
    return piecewise_schedule([list(row) for row in lr_cfg.schedule],
                              steps_per_epoch)
