"""Training step (port of paddle_tpu/jit/training.py: ``TrainStep`` with
``scan_steps``, ``warm``, ``skip_step``, ``flush_accumulation``,
``eval_fn`` and ``sync_to_model``; ``window_schedule``,
``window_rollback`` and ``make_scan_window``).

paddle_tpu compiles forward, loss, backward and the optimizer update
into one donated XLA program, and ``scan_steps`` runs K of them as one
``lax.scan`` program. PyTorch runs eagerly, so the port has nothing to
compile: a step is ``model(*inputs)`` in training mode,
``loss_fn(out, *labels)``, ``loss.backward()`` (the hand-written kernels'
backward passes run inside it) and the optimizer's update of the
parameters IN PLACE; the scan is a Python loop over the leading axis of
the stacked super-batch (``make_scan_window``). ``__call__`` is a window
of one, so a window and the same number of calls run the same code and
give the same bits.

The contract is paddle_tpu's:

- the schedule: ``window_schedule`` precomputes each step's lr (read
  before the step), its step number and its step count, and advances the
  counters and the scheduler (stepped after each update when
  ``auto_lr_step``) for the whole window before the first step runs; the
  step bodies use those values, never ``get_lr()``;
- the step number ``t`` of the bias corrections is the optimizer's step
  count, which the step advances with ``update_count`` (on a skipped and
  a flushed update too): ``t = update_count`` from a fresh optimizer, and
  it continues from a loaded state (``"@step"``);
- the randomness: step n's forward and backward run inside
  ``framework.random``'s ``folded(n)``, the counterpart of paddle_tpu's
  ``fold_in(key, n)``: every step after a ``skip_step`` draws what an
  unfaulted run draws at that step count, and ``scan_steps`` draws what
  ``__call__`` draws. Recompute saves and restores the generators of the
  scope it runs in, so it replays the step's own masks;
- gradient merge (``accumulate_steps = k > 1``): the first k - 1
  (micro-)steps of each window accumulate their grads, the k-th applies
  one update with the mean ``(acc + grads) / k`` and resets the
  accumulator, at any phase of a window. The accumulator is each
  parameter's ``.grad`` (autograd adds each backward into it).

What the port leaves out or changes:

- an eager window is not atomic as one XLA program is: a step that raises
  at position i leaves steps 1..i-1 applied to the parameters and slots,
  so ``window_rollback`` leaves the counters and the scheduler as i - 1
  sequential steps would (the state before the window when i = 1): the
  schedule is never ahead of the parameters. ``__call__`` is such a
  window, so a step that raises leaves the counters as they were before
  it, where paddle_tpu's leaves ``step_count`` one ahead;
- paddle_tpu's ``_quiet_unused_donation`` (nothing is donated) and
  ``_trace_count`` (nothing is traced) have no counterpart, nor have
  ``make_scan_window``'s ``on_trace`` and ``post_update`` (a hook for
  A12's quantized ZeRO path, which the port does not have yet);
- paddle_tpu's step goes through ``apply_gradients``, which drops
  per-parameter optimizer attributes (ROADMAP.md §C); the port's step
  updates the model's parameters and keeps applying them.
"""
from __future__ import annotations

import contextlib
import time
import types
from typing import Callable, Optional

import numpy as np
import torch

from ..framework import random as _random

__all__ = ["TrainStep", "window_schedule", "window_rollback",
           "make_scan_window"]


def window_schedule(step, k_steps: int):
    """Precompute a window's per-step lr / step number / step count
    vectors and update mask, advancing ``step``'s counters, its
    optimizer's step count and the LR scheduler in EXACTLY the order the
    sequential path would: the lr is read before each step, the scheduler
    steps after each update. ``step`` is anything with
    ``accumulate_steps``, ``optimizer``, ``step_count``, ``update_count``
    and ``auto_lr_step`` (``TrainStep``, and A12's future
    ``ParallelTrainStep``). Returns numpy arrays: lrs f32, step numbers
    f32 (a micro-step carries the next update's), counts int32, mask
    bool."""
    k = step.accumulate_steps
    opt = step.optimizer
    lr_sched = getattr(opt, "_learning_rate", None)
    lrs, step_nos, counts, upd = [], [], [], []
    for _ in range(k_steps):
        step.step_count += 1
        counts.append(step.step_count)
        lrs.append(opt.get_lr())
        is_upd = k == 1 or step.step_count % k == 0
        upd.append(is_upd)
        if is_upd:
            step.update_count += 1
            opt._step_count += 1
            step_nos.append(opt._step_count)
            if step.auto_lr_step and hasattr(lr_sched, "step"):
                lr_sched.step()
        else:
            step_nos.append(opt._step_count + 1)
    return (np.asarray(lrs, np.float32), np.asarray(step_nos, np.float32),
            np.asarray(counts, np.int32), np.asarray(upd, bool))


@contextlib.contextmanager
def window_rollback(step):
    """Keep the schedule from running ahead of the parameters when a
    window fails. Yields a progress record whose ``done`` the window
    counts up after each finished step; if the body raises, the counters,
    the optimizer's step count and the scheduler go back to their state
    before the window and then forward by ``done`` steps (as ``done``
    sequential steps would leave them), and the error propagates. The
    parameters and slots of the finished steps stay as they are."""
    opt = step.optimizer
    lr_sched = getattr(opt, "_learning_rate", None)
    sched_state = (lr_sched.state_dict()
                   if hasattr(lr_sched, "state_dict") else None)
    before = step.step_count, step.update_count, opt._step_count
    progress = types.SimpleNamespace(done=0)
    try:
        yield progress
    except BaseException:
        step.step_count, step.update_count, opt._step_count = before
        if sched_state is not None:
            lr_sched.set_state_dict(sched_state)
        window_schedule(step, progress.done)
        raise


def _merged_update(optimizer, params, divisor, lr, t):
    """Update from the grads accumulated in ``params``' ``.grad``
    divided by ``divisor`` (their mean over the micro-steps), at ``(lr,
    t)``; then reset the accumulator (every ``.grad`` to None)."""
    if divisor > 1:
        with torch.no_grad():
            torch._foreach_div_([p.grad for p in params
                                 if p.grad is not None], float(divisor))
    optimizer.update(lr, t)
    for p in params:
        p.grad = None


def make_scan_window(fwd: Callable, optimizer, k: int):
    """The K-step window shared by ``TrainStep`` and A12's future
    ``ParallelTrainStep``: the one place the window's contract lives.
    paddle_tpu's ``lax.scan`` over the stacked super-batch is a Python
    loop over its leading axis here.

    ``fwd(count, *batch) -> loss`` runs one (micro-)step's forward, loss
    and backward (leaving the grads in ``.grad``) with the randomness of
    step ``count``, and returns the loss detached; ``k`` is
    ``accumulate_steps``. Returns

        window(params, lrs, step_nos, counts, upd_mask, *superbatch,
               progress=None) -> losses [K]

    which runs step i on ``[b[i] for b in superbatch]``; where
    ``upd_mask[i]`` it divides the accumulated grads by ``k`` (the ``(acc
    + grads) / k`` mean) and updates at ``(lrs[i], step_nos[i])``
    (``optimizer.update``), then resets the accumulator (every ``.grad``
    of ``params`` to None); ``progress.done`` counts the finished steps.
    The losses stay on the card, stacked: the window reads nothing back
    to the host. With k = 1 the mask is all True."""
    def window(params, lrs, step_nos, counts, upd_mask, *superbatch,
               progress=None):
        losses = []
        for i in range(len(counts)):
            losses.append(fwd(int(counts[i]), *(b[i] for b in superbatch)))
            if upd_mask[i]:
                _merged_update(optimizer, params, k, float(lrs[i]),
                               int(step_nos[i]))
            if progress is not None:
                progress.done += 1
        return torch.stack(losses)

    return window


def _training_libraries():
    """The kernel libraries a training step can launch, with the
    signature tables they load with: B1's three builds (B5 runs on them
    too) and B2."""
    from ..kernels import flash_attention as fa
    from ..kernels import fused_ce as ce
    return (("flash_attention", fa._SIGNATURES),
            ("flash_attention_sm90", fa._TC_SIGNATURES),
            ("flash_attention_sm90_f32", fa._TF32_SIGNATURES),
            ("fused_ce", ce._SIGNATURES))


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
        self._params = list(model.parameters())
        for p in self._params:
            p.grad = None
        self._window = make_scan_window(self._fwd, optimizer,
                                        accumulate_steps)

    def _fwd(self, count, *batch):
        inputs, labels = batch[:self.n_inputs], batch[self.n_inputs:]
        self.model.train()
        with _random.default_generator().folded(count):
            loss = self.loss_fn(self.model(*inputs), *labels)
            loss.backward()
        return loss.detach()

    def _run(self, k_steps, superbatch):
        with window_rollback(self) as progress:
            lrs, step_nos, counts, upd = window_schedule(self, k_steps)
            return self._window(self._params, lrs, step_nos, counts, upd,
                                *superbatch, progress=progress)

    def __call__(self, *batch) -> torch.Tensor:
        return self._run(1, tuple([b] for b in batch))[0]

    def scan_steps(self, k_steps: int, *batch) -> torch.Tensor:
        """Run ``k_steps`` consecutive (micro-)steps. Every leaf of
        ``batch`` is stacked ``[k_steps, ...]`` (ValueError otherwise, and
        for ``k_steps < 1``). Returns the ``[k_steps]`` losses as one
        tensor on the model's device; nothing inside the window reads the
        card back. Counters, LR and random state end exactly as after
        ``k_steps`` ``__call__``s, at any gradient-accumulation phase, and
        the parameters and losses are those calls' bits. With
        ``auto_lr_step=False`` the lr is frozen across the window."""
        if k_steps < 1:
            raise ValueError("k_steps must be >= 1")
        for b in batch:
            shape = tuple(getattr(b, "shape", ()))
            if not shape or shape[0] != k_steps:
                raise ValueError(
                    f"scan_steps batch leaves must be stacked "
                    f"[{k_steps}, ...]; got shape {shape}")
        return self._run(k_steps, batch)

    def warm(self, *example_batch, scan_k: Optional[int] = None,
             store=None, static_extra: str = "") -> list:
        """Get the step ready before its first call: on the card, build
        (``nvcc``, unless already built) and load the kernel libraries a
        training step launches (B1's and B2's); create the optimizer's
        slots (zeros, and f32 masters taken from the parameters as they
        are now, as the first update would take them). Moves no
        parameter, slot value, counter, LR or random state, and runs
        nothing: ``example_batch`` and ``static_extra`` are taken for
        paddle_tpu's signature. Returns one record per site paddle_tpu
        warms (``train_step``, or ``train_step_acc`` and
        ``train_step_apply`` under gradient merge, then
        ``train_step_scan_k{scan_k}``): {"site", "device", "built" (the
        libraries this call compiled, {name: seconds}), "loaded",
        "slots" (parameters with slots), "seconds"}. ``store=``
        (paddle_tpu's executable store) raises NotImplementedError: its
        counterpart, a stored CUDA graph of the step, is ROADMAP.md A8."""
        if store is not None:
            raise NotImplementedError(
                "TrainStep.warm(store=) is not ported yet — a stored CUDA "
                "graph of the step, ROADMAP.md A8")
        t0 = time.perf_counter()
        device = self._params[0].device if self._params else None
        built, loaded = {}, []
        if device is not None and device.type == "cuda":
            from ..kernels import _build
            libs = _training_libraries()
            built = _build.build([name for name, _ in libs])
            for name, sigs in libs:
                _build.load(name, sigs)
                loaded.append(name)
        opt = self.optimizer
        for p, name in zip(opt._params, opt._names):
            if p.requires_grad:
                opt._ensure_slots(p, name)
        sites = (["train_step"] if self.accumulate_steps == 1
                 else ["train_step_acc", "train_step_apply"])
        if scan_k is not None and scan_k > 1:
            sites.append(f"train_step_scan_k{scan_k}")
        rec = {"device": str(device), "built": built, "loaded": loaded,
               "slots": len({n for d in opt._accumulators.values()
                             for n in d}),
               "seconds": round(time.perf_counter() - t0, 3)}
        return [dict(rec, site=s) for s in sites]

    def skip_step(self):
        """Advance the step count (and on an update position the update
        count, the optimizer's step number and, with ``auto_lr_step``,
        the scheduler) without running the step: the batch is consumed
        but never trained on, and every later step draws the randomness
        and schedule position an unfaulted run would have at its step
        count. Parameters, slots and the accumulated grads stay as they
        are (a skipped update leaves the accumulator for the next
        window, as paddle_tpu's does)."""
        window_schedule(self, 1)

    def flush_accumulation(self):
        """Apply a pending partial accumulation: the mean over the ``r =
        step_count % k`` micro-steps seen, at ``get_lr()`` and the next
        step number; then realign the cadence (``step_count += k - r``) so
        that the next call starts a fresh window. The scheduler does not
        step, as in paddle_tpu. No-op when the cadence is aligned."""
        k = self.accumulate_steps
        r = self.step_count % k
        if k == 1 or r == 0:
            return
        self.update_count += 1
        self.optimizer._step_count += 1
        _merged_update(self.optimizer, self._params, r,
                       self.optimizer.get_lr(), self.optimizer._step_count)
        self.step_count += k - r

    def eval_fn(self):
        """An inference function over the current parameters:
        ``run(*inputs)`` is ``model(*inputs)`` in eval mode without
        autograd; the model's training mode is restored afterwards."""
        model = self.model

        def run(*inputs):
            was_training = model.training
            model.eval()
            try:
                with torch.no_grad():
                    return model(*inputs)
            finally:
                model.train(was_training)

        return run

    def sync_to_model(self):
        """No-op: the port updates the module's parameters in place, so
        the model is always in sync (paddle_tpu copies its donated
        parameter buffers back here)."""
        return self.model
