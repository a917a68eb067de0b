"""Optimizers (port of paddle_tpu/optimizer/optimizer.py: ``Optimizer``,
``Adam``, ``AdamW``, ``L2Decay``).

The semantics are paddle_tpu's ``_fused_update``, step for step: grads
cast to f32; the global clip over the ``need_clip`` grads; each
parameter's ``lr_eff = lr * lr_scale``; AdamW's decoupled decay
``p32 *= 1 - lr_eff * wd`` applied before the rule; coupled L2 decay
``g += wd * p32`` for the others; then the Adam rule at ``lr_eff``

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    lr_t = lr sqrt(1 - b2^t) / (1 - b1^t);  p -= lr_t m / (sqrt(v) + eps)

(epsilon outside the bias correction, which is why ``torch.optim.AdamW``,
whose epsilon sits inside it, is not used). With ``multi_precision``,
bf16/fp16 parameters keep an f32 ``master`` slot: the update runs on it
and the parameter gets its cast. The scalar factors (``lr_t``, the decay
factor) are computed in f32, as paddle_tpu's traced scalars are.

The update is plain PyTorch (``torch._foreach_*`` over the parameter
list), as it is XLA code in paddle_tpu, and writes the parameters IN
PLACE. State lives in ``_accumulators[slot][param_name]``. Parameter
names come from ``parameters=model.named_parameters()``, or from
``jit.TrainStep``, which binds the model's names; otherwise they are
``param_<i>``.

Per-parameter attributes are read off the parameter as paddle_tpu's
eager ``step()`` reads them: ``p.optimize_attr["learning_rate"]`` scales
its lr, ``p.regularizer`` (an ``L2Decay``) overrides ``weight_decay``,
``p.need_clip = False`` keeps it out of the clip, and AdamW's
``lr_ratio(p)`` scales its lr further. A plain ``torch.nn.Parameter``
has none of them and takes the defaults. The other optimizers of
paddle_tpu, and ``L1Decay``, are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW", "L2Decay"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)


class L2Decay:
    """paddle's ``regularizer.L2Decay``: coupled weight decay (adds
    ``coeff * p`` to the gradient)."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _decay_coeff(weight_decay) -> float:
    """The coefficient of ``weight_decay``: a float, an ``L2Decay`` or
    None (0)."""
    if isinstance(weight_decay, L2Decay):
        return weight_decay.coeff
    if weight_decay is None or isinstance(weight_decay, (int, float)):
        return float(weight_decay or 0.0)
    raise NotImplementedError(
        f"weight_decay {type(weight_decay).__name__}: only a float or "
        "L2Decay is ported (L1Decay is listed in ROADMAP.md)")


class _Meta(NamedTuple):
    wd: float          # this parameter's weight-decay coefficient
    decay: bool        # AdamW apply_decay_param_fun verdict
    lr_scale: float    # optimize_attr learning_rate * AdamW lr_ratio
    need_clip: bool


def _groups(keys):
    """{key: [indices]} over the non-None ``keys``, in first-seen order."""
    out: Dict[object, List[int]] = {}
    for i, k in enumerate(keys):
        if k is not None:
            out.setdefault(k, []).append(i)
    return out


class Optimizer:
    """Base optimizer: an eager ``step()`` over the parameters that have
    a ``.grad``, and ``clear_grad()``."""

    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters() or "
                             "model.named_parameters())")
        self._params: List[torch.nn.Parameter] = []
        self._names: List[str] = []
        for i, item in enumerate(parameters):
            name_i, p = (item if isinstance(item, tuple)
                         else (f"param_{i}", item))
            self._names.append(name_i)
            self._params.append(p)
        self._learning_rate = learning_rate
        self._wd_coeff = _decay_coeff(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    def bind_names(self, model: torch.nn.Module):
        """Name each parameter after ``model.named_parameters()`` (the
        names paddle_tpu's functional path uses for decay masks and
        optimizer state). Raises if a parameter is not the model's."""
        by_id = {id(p): n for n, p in model.named_parameters()}
        missing = [i for i, p in enumerate(self._params)
                   if id(p) not in by_id]
        if missing:
            raise ValueError(f"parameters {missing} are not in the model")
        self._names = [by_id[id(p)] for p in self._params]

    # ---- lr ----
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    # ---- rule interface ----
    def _init_slots(self, p32) -> Dict[str, torch.Tensor]:
        return {}

    def _rule(self, p32s, grads, slots, lr, t):
        """Update the f32 params ``p32s`` in place from f32 ``grads``;
        ``slots`` {slot: [tensor per param]} updated in place too."""
        raise NotImplementedError

    def _meta(self, p, name) -> _Meta:
        reg = getattr(p, "regularizer", None)
        return _Meta(
            wd=self._wd_coeff if reg is None else _decay_coeff(reg),
            decay=True,
            lr_scale=float(getattr(p, "optimize_attr", {}).get(
                "learning_rate", 1.0)),
            need_clip=getattr(p, "need_clip", True))

    # ---- eager step ----
    def step(self):
        """One update of every parameter that has a grad, at
        ``get_lr()``."""
        live = [i for i, p in enumerate(self._params)
                if p.grad is not None and p.requires_grad]
        if not live:
            return
        self._step_count += 1
        self._update([self._params[i] for i in live],
                     [self._names[i] for i in live],
                     self.get_lr(), self._step_count)

    @torch.no_grad()
    def _update(self, params, names, lr, t):
        grads = [p.grad.float() for p in params]
        metas = [self._meta(p, n) for p, n in zip(params, names)]
        if self._grad_clip is not None:
            idx = [i for i, m in enumerate(metas) if m.need_clip]
            clipped = self._grad_clip.clip_raw([grads[i] for i in idx])
            for i, c in zip(idx, clipped):
                grads[i] = c
        slots = [self._ensure_slots(p, n) for p, n in zip(params, names)]
        # f32 params update in place; others through their master or an
        # f32 copy that is cast back at the end
        p32s = [s["master"] if "master" in s
                else (p if p.dtype == torch.float32 else p.float())
                for p, s in zip(params, slots)]
        lr_effs = [np.float32(lr) * np.float32(m.lr_scale) for m in metas]
        if self._decoupled_wd:
            factors = [float(np.float32(1.0) - e * np.float32(m.wd))
                       if m.wd and m.decay else None
                       for e, m in zip(lr_effs, metas)]
            for f, idx in _groups(factors).items():
                torch._foreach_mul_([p32s[i] for i in idx], f)
        else:
            for wd, idx in _groups([m.wd or None for m in metas]).items():
                for i, g in zip(idx, torch._foreach_add(
                        [grads[i] for i in idx], [p32s[i] for i in idx],
                        alpha=wd)):
                    grads[i] = g
        for lr_eff, idx in _groups(lr_effs).items():
            self._rule([p32s[i] for i in idx], [grads[i] for i in idx],
                       {k: [slots[i][k] for i in idx]
                        for k in slots[idx[0]] if k != "master"},
                       lr_eff, t)
        for p, p32 in zip(params, p32s):
            if p32 is not p:
                p.copy_(p32)

    def _ensure_slots(self, p, name) -> Dict[str, torch.Tensor]:
        if not any(name in d for d in self._accumulators.values()):
            init = self._init_slots(p.detach().float())
            if self._multi_precision and p.dtype in _LOW_PRECISION:
                init["master"] = p.detach().float()
            for k, arr in init.items():
                self._accumulators.setdefault(k, {})[name] = arr
        return {k: d[name] for k, d in self._accumulators.items()
                if name in d}

    def set_state(self, state, step: int):
        """Replace the optimizer state: ``state`` {param_name: {slot:
        tensor or ndarray}} (slots such as ``moment1``, ``moment2`` and
        ``master``, each of its parameter's shape) is copied in f32 to the
        parameter's device, and the step count becomes ``step``."""
        own = dict(zip(self._names, self._params))
        acc: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, slots in state.items():
            for slot, arr in slots.items():
                t = (arr if isinstance(arr, torch.Tensor)
                     else torch.from_numpy(np.array(arr, np.float32)))
                acc.setdefault(slot, {})[name] = t.to(
                    own[name].device, torch.float32, copy=True)
        self._accumulators = acc
        self._step_count = int(step)

    def clear_grad(self, set_to_zero=True):
        """``set_to_zero`` keeps zero-filled grads (paddle's default);
        False drops them (``p.grad = None``)."""
        for p in self._params:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None


class Adam(Optimizer):
    """paddle's ``Adam``; ``weight_decay`` (a float or ``L2Decay``) is
    coupled L2."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _init_slots(self, p32):
        return {"moment1": torch.zeros_like(p32),
                "moment2": torch.zeros_like(p32)}

    def _rule(self, p32s, grads, slots, lr, t):
        b1, b2 = self._beta1, self._beta2
        m, v = slots["moment1"], slots["moment2"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        t32 = np.float32(t)
        lr_t = float(lr * np.sqrt(np.float32(1) - np.float32(b2) ** t32)
                     / (np.float32(1) - np.float32(b1) ** t32))
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_mul(m, lr_t)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(p32s, upd)


class AdamW(Adam):
    """paddle's ``AdamW``: decoupled weight decay (default 0.01) on every
    parameter unless ``apply_decay_param_fun(name)`` says otherwise;
    ``lr_ratio(param) -> float`` scales each parameter's lr. The
    arguments are in paddle_tpu's order."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _meta(self, p, name):
        meta = super()._meta(p, name)
        if self._apply_decay_param_fun is not None:
            meta = meta._replace(
                decay=bool(self._apply_decay_param_fun(name)))
        if self._lr_ratio is not None:
            meta = meta._replace(
                lr_scale=meta.lr_scale * float(self._lr_ratio(p)))
        return meta
