"""Training step (port of paddle_tpu/jit/training.py:TrainStep).

paddle_tpu compiles forward, loss, backward and the optimizer update
into one donated XLA program. The port runs the same sequence eagerly:
``model(*inputs)`` in training mode, ``loss_fn(out, *labels)``,
``loss.backward()`` (the hand-written kernels' backward passes run
inside it), then ``optimizer.step`` on the parameters IN PLACE. The
semantics follow paddle_tpu's ``__call__``: the learning rate is read
from ``optimizer.get_lr()`` on each call and the scheduler steps after
each update when ``auto_lr_step``; with ``accumulate_steps = k > 1`` the
first k-1 calls of each window only accumulate grads and the k-th
applies one update with their mean. ``scan_steps``, ``warm``,
``skip_step`` and ``flush_accumulation`` are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, loss_fn, opt); loss = step(x, y)``.

    ``loss_fn(outputs, *labels) -> scalar tensor``; the first
    ``n_inputs`` arguments of a call go to the model, the rest to the
    loss. Returns the loss, detached, on the model's device (no host
    sync)."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 n_inputs: int = 1, accumulate_steps: int = 1):
        if accumulate_steps < 1:
            raise ValueError("accumulate_steps must be >= 1")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.n_inputs = n_inputs
        self.accumulate_steps = accumulate_steps
        optimizer.bind_names(model)
        self.step_count = 0
        self.update_count = 0
        # set False when something else owns stepping the scheduler
        self.auto_lr_step = True
        for p in model.parameters():
            p.grad = None

    def __call__(self, *batch) -> torch.Tensor:
        self.step_count += 1
        inputs, labels = batch[:self.n_inputs], batch[self.n_inputs:]
        self.model.train()
        loss = self.loss_fn(self.model(*inputs), *labels)
        loss.backward()
        k = self.accumulate_steps
        if k > 1 and self.step_count % k != 0:
            return loss.detach()       # micro-step: grads accumulate
        self.update_count += 1
        params = [p for p in self.model.parameters() if p.grad is not None]
        if k > 1:
            with torch.no_grad():
                torch._foreach_div_([p.grad for p in params], float(k))
        self.optimizer.step()               # at optimizer.get_lr()
        for p in params:
            p.grad = None
        if self.auto_lr_step:
            sched = getattr(self.optimizer, "_learning_rate", None)
            if hasattr(sched, "step"):
                sched.step()
        return loss.detach()

    def sync_to_model(self):
        """No-op: the port updates the module's parameters in place, so
        the model is always in sync (paddle_tpu copies its donated
        parameter buffers back here)."""
        return self.model
