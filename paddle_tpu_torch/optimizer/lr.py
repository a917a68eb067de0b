"""Learning-rate schedulers (port of paddle_tpu/optimizer/lr.py: all 17
schedulers and the ``LRScheduler`` base).

Host-side Python: each produces one float per step, which the optimizer
reads through ``get_lr()`` (``jit.TrainStep`` reads it before each step
and steps the scheduler after each update). The formulas, the attribute
names and the ``state_dict`` key rule are paddle_tpu's, so a state dict
taken from a paddle_tpu scheduler loads into the port's by
``set_state_dict`` (``convert.py`` carries it) and the two give the same
sequence from there.
"""
from __future__ import annotations

import math

__all__ = [
    "LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
    "InverseTimeDecay", "PolynomialDecay", "LinearWarmup", "ExponentialDecay",
    "MultiStepDecay", "StepDecay", "LambdaDecay", "MultiplicativeDecay",
    "CosineAnnealingDecay", "CosineAnnealingWarmRestarts", "ReduceOnPlateau",
    "LinearLR", "OneCycleLR", "CyclicLR",
]


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

    def state_dict(self):
        """Every public attribute that is an int, float, bool, str or
        list (callables, ``None`` and nested schedulers are left out)."""
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")
                and isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state):
        self.__dict__.update(state)

    state_keys = state_dict
    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    """``base_lr * d_model^-0.5 * min(step^-0.5, warmup^-1.5 * step)``."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = self.warmup_steps ** -1.5 * step
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LRScheduler):
    """``values[i]`` while ``last_epoch < boundaries[i]``, then the last
    value."""

    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    """``base_lr * exp(-gamma * epoch)``."""

    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    """``base_lr / (1 + gamma * epoch)``."""

    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    """``(base_lr - end_lr) * (1 - step / decay_steps)^power + end_lr``;
    with ``cycle`` the horizon grows by whole multiples of
    ``decay_steps``, else the step stops at it."""

    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / float(decay_steps)) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * (
            (1 - float(step) / float(decay_steps)) ** self.power) + self.end_lr


class LinearWarmup(LRScheduler):
    """Linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a float, or a scheduler stepped at
    ``last_epoch - warmup_steps``). Its state dict carries the inner
    scheduler's under ``"lr_after"``."""

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

    def state_dict(self):
        d = super().state_dict()
        if isinstance(self.lr_after, LRScheduler):
            d["lr_after"] = self.lr_after.state_dict()
        return d

    def set_state_dict(self, state):
        state = dict(state)              # the caller's dict stays whole
        sub = state.pop("lr_after", None)
        super().set_state_dict(state)
        if isinstance(sub, dict) and isinstance(self.lr_after, LRScheduler):
            self.lr_after.set_state_dict(sub)

    state_keys = state_dict
    set_dict = set_state_dict


class ExponentialDecay(LRScheduler):
    """``base_lr * gamma^epoch``."""

    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    """``base_lr * gamma^(milestones passed)``."""

    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    """``base_lr * gamma^(epoch // step_size)``."""

    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    """``base_lr * lr_lambda(epoch)``."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    """The running lr times ``lr_lambda(epoch)`` at each epoch after 0;
    the running lr (``cur_lr``) is in the state dict."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self.cur_lr = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self.cur_lr = self.cur_lr * self.lr_lambda(self.last_epoch)
        return self.cur_lr


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


class CosineAnnealingWarmRestarts(LRScheduler):
    """Cosine annealing restarted every ``T_i`` epochs, ``T_i`` growing
    by ``T_mult`` after each restart."""

    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = float(eta_min)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = max(self.last_epoch, 0)
        T_i = self.T_0
        while t >= T_i:
            t -= T_i
            T_i = T_i * self.T_mult if self.T_mult > 1 else T_i
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t / T_i)) / 2


class ReduceOnPlateau(LRScheduler):
    """Multiply the lr by ``factor`` once ``metrics`` passed to
    ``step(metrics)`` has not improved for more than ``patience`` epochs
    (``threshold`` relative or absolute, then ``cooldown`` epochs of
    rest, never below ``min_lr``). ``step()`` without a metric does
    nothing, so ``jit.TrainStep``'s own stepping leaves it alone. A
    tensor metric is read on the host (``.item()``): call it outside a
    ``scan_steps`` window."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = float(learning_rate)
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        cur = float(metrics.item() if hasattr(metrics, "item") else metrics)
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        if self._is_better(cur):
            self.best = cur
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            # cooling down: bad epochs are not counted
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
                if self.verbose:
                    print(f"Epoch {self.last_epoch}: reducing learning rate "
                          f"to {new_lr}.")
            self.cooldown_counter = self.cooldown
            self.num_bad = 0

    def _is_better(self, cur):
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            eps = 1.0 - self.threshold if self.mode == "min" \
                else 1.0 + self.threshold
            return cur < self.best * eps if self.mode == "min" \
                else cur > self.best * eps
        return cur < self.best - self.threshold if self.mode == "min" \
            else cur > self.best + self.threshold


class LinearLR(LRScheduler):
    """``base_lr`` times a factor going linearly from ``start_factor`` to
    ``end_factor`` over ``total_steps``."""

    def __init__(self, learning_rate, total_steps, start_factor=1. / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = min(self.last_epoch, self.total_steps)
        frac = self.start_factor + (self.end_factor - self.start_factor) * (
            t / float(self.total_steps))
        return self.base_lr * frac


class OneCycleLR(LRScheduler):
    """Up from ``max_learning_rate / divide_factor`` to the maximum over
    the first ``phase_pct`` of ``total_steps``, then down to
    ``end_learning_rate`` (cosine or linear; ``three_phase`` goes back to
    the initial lr before the final descent)."""

    def __init__(self, max_learning_rate, total_steps, divide_factor=25.,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = float(max_learning_rate)
        self.total_steps = total_steps
        self.initial_lr = self.max_lr / divide_factor
        self.end_lr = float(end_learning_rate)
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return (end - start) * pct + start

    def get_lr(self):
        t = min(self.last_epoch, self.total_steps)
        up = int(self.phase_pct * self.total_steps) - 1
        if self.three_phase:
            down = 2 * up + 1
            if t <= up:
                return self._interp(self.initial_lr, self.max_lr, t / max(up, 1))
            if t <= down:
                return self._interp(self.max_lr, self.initial_lr,
                                    (t - up) / max(down - up, 1))
            return self._interp(self.initial_lr, self.end_lr,
                                (t - down) / max(self.total_steps - down - 1, 1))
        if t <= up:
            return self._interp(self.initial_lr, self.max_lr, t / max(up, 1))
        return self._interp(self.max_lr, self.end_lr,
                            (t - up) / max(self.total_steps - up - 1, 1))


class CyclicLR(LRScheduler):
    """Cycles between ``base_learning_rate`` and ``max_learning_rate``
    (``step_size_up`` up, ``step_size_down`` down), the amplitude scaled
    by ``mode`` ("triangular", "triangular2", "exp_range") or
    ``scale_fn``."""

    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = float(max_learning_rate)
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.step_size_up + self.step_size_down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        if x < self.step_size_up:
            pct = x / self.step_size_up
        else:
            pct = 1 - (x - self.step_size_up) / self.step_size_down
        amp = (self.max_lr - self.base_lr) * pct
        if self.scale_fn is not None:
            arg = cycle if self.scale_mode == "cycle" else self.last_epoch
            scale = self.scale_fn(arg)
        elif self.mode == "triangular":
            scale = 1.0
        elif self.mode == "triangular2":
            scale = 1 / (2. ** (cycle - 1))
        elif self.mode == "exp_range":
            scale = self.exp_gamma ** self.last_epoch
        else:
            scale = 1.0
        return self.base_lr + amp * scale
