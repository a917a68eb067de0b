"""Learning-rate schedulers (port of paddle_tpu/optimizer/lr.py: the
``LRScheduler`` base, ``LinearWarmup`` and ``CosineAnnealingDecay``).

Host-side Python: each produces one float per step, which the optimizer
reads through ``get_lr()``. The other schedulers of paddle_tpu are not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "LinearWarmup", "CosineAnnealingDecay"]


class LRScheduler:
    """Base class: ``step()`` advances ``last_epoch`` and recomputes
    ``last_lr``; calling the scheduler returns ``last_lr``. Built at epoch
    0, as paddle's."""

    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = None
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: setting learning rate to "
                  f"{self.last_lr}.")

    def get_lr(self):
        raise NotImplementedError


class LinearWarmup(LRScheduler):
    """Linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a float, or a scheduler stepped at
    ``last_epoch - warmup_steps``)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * self.last_epoch / float(
                self.warmup_steps) + self.start_lr
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.step(self.last_epoch - self.warmup_steps)
            return self.lr_after()
        return float(self.lr_after)


class CosineAnnealingDecay(LRScheduler):
    """``eta_min + (base_lr - eta_min) * (1 + cos(pi * epoch / T_max)) /
    2``."""

    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = float(eta_min)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
