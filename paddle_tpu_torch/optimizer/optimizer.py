"""Optimizers (port of paddle_tpu/optimizer/optimizer.py: ``Optimizer``
and its eleven subclasses, ``L1Decay`` and ``L2Decay``).

The semantics are paddle_tpu's ``_fused_update``, step for step: grads
cast to f32; the clip over the ``need_clip`` grads; each parameter's
``lr_eff = lr * lr_scale``; AdamW's decoupled decay ``p32 *= 1 - lr_eff *
wd`` applied before the rule; coupled decay ``g += wd * p32`` (L2) or
``g += wd * sign(p32)`` (L1) for the others, except Lamb and Lars, whose
rules take the decay themselves; then the optimizer's rule at ``lr_eff``.
With ``multi_precision``, bf16/fp16 parameters keep an f32 ``master``
slot: the update runs on it and the parameter gets its cast. Scalar
factors (Adam's ``lr_t``, bias corrections, the decay factor, DGC's
sparsity) are computed on the host in f32, as paddle_tpu's traced
scalars are in f32.

Each rule is plain PyTorch, as it is XLA code in paddle_tpu:
``torch._foreach_*`` over the parameters that share an lr, and a loop
over the parameters where a rule needs a per-tensor norm (Lamb, Lars) or
a top-k threshold (DGC). The update writes the parameters and the slots
IN PLACE, and reads nothing back to the host: norms, trust ratios and
thresholds stay device tensors, and the step number ``t`` and the lr are
host numbers, so an update adds no synchronisation to a step.

State lives in ``_accumulators[slot][param_name]``, all f32. Parameter
names come from ``parameters=model.named_parameters()``, or from
``jit.TrainStep``, which binds the model's names; otherwise they are
``param_<i>``. The update entries:

- ``step()`` counts ``_step_count`` and updates at ``get_lr()``, as
  paddle_tpu's eager ``step()``;
- ``update(lr, t)`` takes both from the caller (``jit.TrainStep`` passes
  each step's precomputed lr and its update count) and counts nothing;
- ``init(params)`` / ``apply_gradients(params, grads, state, lr, step)``,
  paddle_tpu's functional pair over dicts {name: tensor}: returns new
  parameters and state, leaving its inputs as they were.

Per-parameter attributes are read off the parameter as paddle_tpu's
eager ``step()`` reads them: ``p.optimize_attr["learning_rate"]`` scales
its lr, ``p.regularizer`` (an ``L2Decay`` or ``L1Decay``) overrides
``weight_decay``, ``p.need_clip = False`` keeps it out of the clip,
AdamW's ``lr_ratio(p)`` scales its lr further and Lamb's
``exclude_from_weight_decay_fn(p)`` drops its decay. A plain
``torch.nn.Parameter`` has none of them and takes the defaults. The
functional ``apply_gradients`` reads them too, off the tensors it is
given (paddle_tpu's functional path drops them: ROADMAP.md §C).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "DGCMomentum",
           "L1Decay", "L2Decay"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)
_f32 = np.float32


class L2Decay:
    """paddle's ``regularizer.L2Decay``: coupled weight decay (adds
    ``coeff * p`` to the gradient)."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    """paddle's ``regularizer.L1Decay``: adds ``coeff * sign(p)`` to the
    gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _decay(weight_decay):
    """(coefficient, is L1) of ``weight_decay``: a float, an ``L2Decay``,
    an ``L1Decay`` or None (0)."""
    if isinstance(weight_decay, (L2Decay, L1Decay)):
        return weight_decay.coeff, isinstance(weight_decay, L1Decay)
    if weight_decay is None or isinstance(weight_decay, (int, float)):
        return float(weight_decay or 0.0), False
    raise TypeError(f"weight_decay {type(weight_decay).__name__}: expected "
                    "a float, L2Decay or L1Decay")


class _Meta(NamedTuple):
    wd: float          # this parameter's weight-decay coefficient
    wd_is_l1: bool
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


def _bias_correction(beta, t) -> float:
    """``1 - beta^t`` in f32."""
    return _f32(1) - _f32(beta) ** _f32(t)


class Optimizer:
    """Base optimizer: the update entries, the paddle API surface
    (``set_lr``, ``set_lr_scheduler``, ``state_dict``, ``set_state_dict``,
    ``clear_grad`` / ``clear_gradients``, ``minimize``) and the
    functional ``init`` / ``apply_gradients``."""

    _decoupled_wd = False   # AdamW: p *= 1 - lr * coeff
    _wd_in_rule = False     # Lamb, Lars: the rule takes meta.wd itself

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
        self._wd_coeff, self._wd_is_l1 = _decay(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._name = name
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

    def set_lr(self, value):
        """A constant lr; raises RuntimeError when the lr is a
        scheduler, as paddle_tpu's."""
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is a scheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # ---- rule interface (subclasses) ----
    def _init_slots(self, p32) -> Dict[str, torch.Tensor]:
        return {}

    def _rule(self, p32s, grads, slots, lr, t, metas):
        """Update the f32 params ``p32s`` in place from the f32 ``grads``
        (read only) at the host f32 ``lr`` and step number ``t``;
        ``slots`` {slot: [tensor per param]} in place too."""
        raise NotImplementedError

    def _meta(self, p, name) -> _Meta:
        reg = getattr(p, "regularizer", None)
        wd, is_l1 = ((self._wd_coeff, self._wd_is_l1) if reg is None
                     else _decay(reg))
        return _Meta(
            wd=wd, wd_is_l1=is_l1, decay=True,
            lr_scale=float(getattr(p, "optimize_attr", {}).get(
                "learning_rate", 1.0)),
            need_clip=getattr(p, "need_clip", True))

    # ---- update entries ----
    def step(self):
        """One update of every parameter that has a grad, at
        ``get_lr()``, with the next step number."""
        live = self._live()
        if live:
            self._step_count += 1
            self._update(live, self.get_lr(), self._step_count)

    def update(self, lr, t):
        """One update of every parameter that has a grad at the caller's
        ``lr`` and step number ``t`` (host numbers); ``_step_count`` does
        not move."""
        live = self._live()
        if live:
            self._update(live, lr, t)

    def _live(self):
        return [i for i, p in enumerate(self._params)
                if p.grad is not None and p.requires_grad]

    def _update(self, live, lr, t):
        params = [self._params[i] for i in live]
        names = [self._names[i] for i in live]
        slots = [self._ensure_slots(p, n) for p, n in zip(params, names)]
        self._apply(params, [p.grad for p in params], slots,
                    [self._meta(p, n) for p, n in zip(params, names)],
                    lr, t)

    @torch.no_grad()
    def _apply(self, values, grads, slots, metas, lr, t):
        """paddle_tpu's ``_fused_update`` over ``values`` (the parameters,
        updated in place), ``grads`` (left as they are) and ``slots`` (a
        dict a parameter, updated in place)."""
        grads = [g.float() for g in grads]
        if self._grad_clip is not None:
            idx = [i for i, m in enumerate(metas) if m.need_clip]
            clipped = self._grad_clip.clip_raw([grads[i] for i in idx])
            for i, c in zip(idx, clipped):
                grads[i] = c
        # f32 params update in place; others through their master or an
        # f32 copy that is cast back at the end
        p32s = [s["master"] if "master" in s
                else (v if v.dtype == torch.float32 else v.float())
                for v, s in zip(values, slots)]
        lr_effs = [_f32(lr) * _f32(m.lr_scale) for m in metas]
        if self._decoupled_wd:
            factors = [float(_f32(1.0) - e * _f32(m.wd))
                       if m.wd and m.decay else None
                       for e, m in zip(lr_effs, metas)]
            for f, idx in _groups(factors).items():
                torch._foreach_mul_([p32s[i] for i in idx], f)
        elif not self._wd_in_rule:
            keys = [(m.wd, m.wd_is_l1) if m.wd else None for m in metas]
            for (wd, l1), idx in _groups(keys).items():
                ps = [p32s[i] for i in idx]
                for i, g in zip(idx, torch._foreach_add(
                        [grads[i] for i in idx],
                        torch._foreach_sign(ps) if l1 else ps, alpha=wd)):
                    grads[i] = g
        for lr_eff, idx in _groups(lr_effs).items():
            self._rule([p32s[i] for i in idx], [grads[i] for i in idx],
                       {k: [slots[i][k] for i in idx]
                        for k in slots[idx[0]] if k != "master"},
                       float(lr_eff), t, [metas[i] for i in idx])
        for v, p32 in zip(values, p32s):
            if p32 is not v:
                v.copy_(p32)

    def _new_slots(self, value) -> Dict[str, torch.Tensor]:
        p32 = value.detach().float()
        init = self._init_slots(p32)
        if self._multi_precision and value.dtype in _LOW_PRECISION:
            init["master"] = p32.clone()
        return init

    def _ensure_slots(self, p, name) -> Dict[str, torch.Tensor]:
        if not any(name in d for d in self._accumulators.values()):
            for k, arr in self._new_slots(p).items():
                self._accumulators.setdefault(k, {})[name] = arr
        return {k: d[name] for k, d in self._accumulators.items()
                if name in d}

    # ---- paddle API surface ----
    def clear_grad(self, set_to_zero=True):
        """``set_to_zero`` keeps zero-filled grads (paddle's default);
        False drops them (``p.grad = None``)."""
        for p in self._params:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()``; returns (None, [(param,
        grad)])."""
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._params]

    def state_dict(self):
        """{f"{param_name}_{slot}": tensor} over every slot, ``"@step"``
        and, under a scheduler, ``"LR_Scheduler"`` (its state dict). The
        tensors are the live slots, as ``torch.optim``'s state dict gives
        them: clone them to keep a snapshot across later updates."""
        state = {}
        for slot, d in self._accumulators.items():
            for pname, arr in d.items():
                state[f"{pname}_{slot}"] = arr
        state["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        return state

    def set_state_dict(self, state):
        """Load what ``state_dict`` gives (a tensor or an ndarray a key):
        each key goes to the parameter whose name is its longest prefix
        followed by "_" (so a parameter ``w`` cannot take ``w_ho``'s
        slots), copied in f32 to that parameter's device; keys that name
        no parameter are ignored, as paddle_tpu does."""
        self._step_count = int(state.get("@step", 0))
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(dict(state["LR_Scheduler"]))
        own = dict(zip(self._names, self._params))
        for key, val in state.items():
            if key in ("@step", "LR_Scheduler"):
                continue
            match = max((n for n in own if key.startswith(n + "_")),
                        key=len, default=None)
            if match is not None:
                self._accumulators.setdefault(key[len(match) + 1:], {})[
                    match] = _f32_copy(val, own[match].device)

    # ---- functional API ----
    def init(self, params):
        """{name: tensor} -> {name: {slot: tensor}}: the initial slots of
        each parameter (with an f32 ``master`` for a bf16/fp16 one under
        ``multi_precision``)."""
        return {n: self._new_slots(v) for n, v in params.items()}

    def apply_gradients(self, params, grads, state, lr=None, step=1):
        """One update over dicts {name: tensor}: ``grads`` and ``state``
        (what ``init`` gave) keyed as ``params``; ``lr`` (``get_lr()``
        when None) and ``step`` are host numbers. Returns (new params,
        new state); the inputs are left as they were. Decay masks and
        Lars's exclusions read the dict's names."""
        names = list(params)
        values = [params[n].detach().clone() for n in names]
        slots = [{k: v.clone() for k, v in state[n].items()}
                 for n in names]
        self._apply(values, [grads[n] for n in names], slots,
                    [self._meta(params[n], n) for n in names],
                    self.get_lr() if lr is None else float(lr), step)
        return dict(zip(names, values)), dict(zip(names, slots))


def _f32_copy(arr, device) -> torch.Tensor:
    """An f32 copy of a tensor or an array on ``device``."""
    t = (arr if isinstance(arr, torch.Tensor)
         else torch.from_numpy(np.array(arr, np.float32)))
    return t.to(device, torch.float32, copy=True)


def _zeros(p32):
    return torch.zeros_like(p32)


class SGD(Optimizer):
    """paddle's ``SGD``: ``p -= lr * g``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _rule(self, p32s, grads, slots, lr, t, metas):
        torch._foreach_add_(p32s, grads, alpha=-lr)


class Momentum(Optimizer):
    """paddle's ``Momentum``: ``v = mu v + g``; ``p -= lr v``, or with
    ``use_nesterov`` ``p -= lr (g + mu v)``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = float(momentum)
        self._nesterov = use_nesterov

    def _init_slots(self, p32):
        return {"velocity": _zeros(p32)}

    def _rule(self, p32s, grads, slots, lr, t, metas):
        v = slots["velocity"]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, grads)
        step = (torch._foreach_add(grads, v, alpha=self._momentum)
                if self._nesterov else v)
        torch._foreach_add_(p32s, step, alpha=-lr)


class Adam(Optimizer):
    """paddle's ``Adam``; ``weight_decay`` (a float, ``L2Decay`` or
    ``L1Decay``) is coupled. Epsilon sits outside the bias correction,
    which is why ``torch.optim.Adam``, whose epsilon sits inside it, is
    not used. Further keywords (paddle's ``use_multi_tensor``, ...) are
    accepted and ignored, as paddle_tpu ignores them:

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        lr_t = lr sqrt(1 - b2^t) / (1 - b1^t);  p -= lr_t m / (sqrt(v) + eps)
    """

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _init_slots(self, p32):
        return {"moment1": _zeros(p32), "moment2": _zeros(p32)}

    def _rule(self, p32s, grads, slots, lr, t, metas):
        b1, b2 = self._beta1, self._beta2
        m, v = slots["moment1"], slots["moment2"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        lr_t = float(_f32(lr) * np.sqrt(_bias_correction(b2, t))
                     / _bias_correction(b1, t))
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
                 lazy_mode=False, multi_precision=False, name=None, **kw):
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


class Adamax(Optimizer):
    """paddle's ``Adamax``: ``m = b1 m + (1 - b1) g``; ``u = max(b2 u,
    |g|)``; ``p -= (lr / (1 - b1^t)) m / (u + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots(self, p32):
        return {"moment": _zeros(p32), "inf_norm": _zeros(p32)}

    def _rule(self, p32s, grads, slots, lr, t, metas):
        m, u = slots["moment"], slots["inf_norm"]
        torch._foreach_mul_(m, self._beta1)
        torch._foreach_add_(m, grads, alpha=1 - self._beta1)
        torch._foreach_mul_(u, self._beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(grads))
        coef = float(_f32(lr) / _bias_correction(self._beta1, t))
        upd = torch._foreach_mul(m, coef)
        torch._foreach_div_(upd, torch._foreach_add(u, self._epsilon))
        torch._foreach_sub_(p32s, upd)


class Adagrad(Optimizer):
    """paddle's ``Adagrad``: ``acc += g^2``; ``p -= lr g / (sqrt(acc) +
    eps)``; ``acc`` starts at ``initial_accumulator_value``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots(self, p32):
        return {"moment": torch.full_like(p32, self._init_acc)}

    def _rule(self, p32s, grads, slots, lr, t, metas):
        acc = slots["moment"]
        torch._foreach_addcmul_(acc, grads, grads)
        denom = torch._foreach_sqrt(acc)
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_mul(grads, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(p32s, upd)


class Adadelta(Optimizer):
    """paddle's ``Adadelta``: ``sq = rho sq + (1 - rho) g^2``; ``upd = g
    sqrt(sq_u + eps) / sqrt(sq + eps)``; ``sq_u = rho sq_u + (1 - rho)
    upd^2``; ``p -= lr upd``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon, self._rho = epsilon, rho

    def _init_slots(self, p32):
        return {"avg_squared_grad": _zeros(p32),
                "avg_squared_update": _zeros(p32)}

    def _rule(self, p32s, grads, slots, lr, t, metas):
        rho, eps = self._rho, self._epsilon
        sq, sq_u = slots["avg_squared_grad"], slots["avg_squared_update"]
        torch._foreach_mul_(sq, rho)
        torch._foreach_addcmul_(sq, grads, grads, value=1 - rho)
        num = torch._foreach_add(sq_u, eps)
        torch._foreach_sqrt_(num)
        upd = torch._foreach_mul(grads, num)
        den = torch._foreach_add(sq, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(sq_u, rho)
        torch._foreach_addcmul_(sq_u, upd, upd, value=1 - rho)
        torch._foreach_add_(p32s, upd, alpha=-lr)


class RMSProp(Optimizer):
    """paddle's ``RMSProp``: ``ms = rho ms + (1 - rho) g^2``; with
    ``centered`` ``mg = rho mg + (1 - rho) g`` and the denominator ``ms -
    mg^2 + eps``, else ``ms + eps``; ``mom = momentum mom + lr g /
    sqrt(denominator)``; ``p -= mom``."""

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_slots(self, p32):
        s = {"mean_square": _zeros(p32), "momentum": _zeros(p32)}
        if self._centered:
            s["mean_grad"] = _zeros(p32)
        return s

    def _rule(self, p32s, grads, slots, lr, t, metas):
        rho = self._rho
        ms, mom = slots["mean_square"], slots["momentum"]
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, grads, grads, value=1 - rho)
        if self._centered:
            mg = slots["mean_grad"]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, grads, alpha=1 - rho)
            denom = torch._foreach_addcmul(ms, mg, mg, value=-1)
            torch._foreach_add_(denom, self._epsilon)
        else:
            denom = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(denom)
        upd = torch._foreach_mul(grads, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, upd)
        torch._foreach_sub_(p32s, mom)


class Lamb(Optimizer):
    """paddle's ``Lamb``: Adam's moments, ``r = m_hat / (sqrt(v_hat) +
    eps) + wd p`` and a layerwise trust ratio ``||p|| / ||r||`` (1 where
    either norm is 0): ``p -= lr trust r``. ``lamb_weight_decay`` is
    every parameter's ``wd`` unless ``exclude_from_weight_decay_fn(p)``
    says otherwise. The norms are device tensors (one multi-tensor norm
    each way); the trust ratios scale each ``r`` on the card."""

    _wd_in_rule = True

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _meta(self, p, name):
        meta = super()._meta(p, name)
        wd = self._lamb_wd
        if self._exclude_fn is not None and p is not None \
                and self._exclude_fn(p):
            wd = 0.0
        return meta._replace(wd=wd)

    def _init_slots(self, p32):
        return {"moment1": _zeros(p32), "moment2": _zeros(p32)}

    def _rule(self, p32s, grads, slots, lr, t, metas):
        b1, b2 = self._beta1, self._beta2
        m, v = slots["moment1"], slots["moment2"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        r = torch._foreach_div(m, float(_bias_correction(b1, t)))
        den = torch._foreach_div(v, float(_bias_correction(b2, t)))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_div_(r, den)
        for wd, idx in _groups([mt.wd or None for mt in metas]).items():
            torch._foreach_add_([r[i] for i in idx],
                                [p32s[i] for i in idx], alpha=wd)
        p_norms = torch._foreach_norm(p32s)
        r_norms = torch._foreach_norm(r)
        for p, ri, pn, rn in zip(p32s, r, p_norms, r_norms):
            trust = torch.where((pn > 0) & (rn > 0), pn / rn, 1.0)
            p.sub_(ri.mul_(trust * lr))


class Lars(Optimizer):
    """LARS momentum (paddle's ``lars_momentum`` formula):

        local_lr = lr * lars_coeff * ||p|| / (||g|| + wd ||p|| + eps)
        v        = momentum v + local_lr (g + wd p)
        p       -= v

    ``local_lr`` is 0 where the denominator is. Parameters whose name
    contains any string of ``exclude_from_weight_decay`` take wd = 0.
    The norms stay on the card (one multi-tensor norm each way)."""

    _wd_in_rule = True

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0.0,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._momentum = float(momentum)
        self._coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._exclude = list(exclude_from_weight_decay or [])
        self._epsilon = float(epsilon)

    def _meta(self, p, name):
        meta = super()._meta(p, name)
        wd = self._lars_wd
        if any(sub in (name or "") for sub in self._exclude):
            wd = 0.0
        return meta._replace(wd=wd)

    def _init_slots(self, p32):
        return {"velocity": _zeros(p32)}

    def _rule(self, p32s, grads, slots, lr, t, metas):
        lr_coeff = float(_f32(lr) * _f32(self._coeff))
        p_norms = torch._foreach_norm(p32s)
        g_norms = torch._foreach_norm(grads)
        for p, g, v, pn, gn, mt in zip(p32s, grads, slots["velocity"],
                                       p_norms, g_norms, metas):
            denom = gn + mt.wd * pn + self._epsilon
            local_lr = torch.where(denom > 0, lr_coeff * pn / denom, 0.0)
            d = torch.add(g, p, alpha=mt.wd) if mt.wd else g
            v.mul_(self._momentum).add_(d * local_lr)
            p.sub_(v)


class DGCMomentum(Optimizer):
    """Deep Gradient Compression momentum (paddle's ``dgc_momentum``):
    momentum correction ``u = m u + g``, residual accumulation ``e = e +
    u``, and from step ``rampup_begin_step + 1`` on, only the entries of
    ``e`` at or above the top-(1 - sparsity) magnitude threshold are
    applied (``p -= lr e * mask``), taken out of the residual and zeroed
    in the velocity (momentum factor masking); where the threshold is 0
    only the nonzero entries go. ``sparsity`` ramps over its list in
    equal segments of ``rampup_step`` steps. Before the ramp it is plain
    momentum (Nesterov with ``use_nesterov``) and the residual stays 0.

    The step number and the sparsity are host numbers; the threshold is
    ``torch.kthvalue`` of each tensor's magnitudes, a device tensor."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 rampup_begin_step=0, rampup_step=1, sparsity=(0.999,),
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, multi_precision, name)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(1, int(rampup_step))
        self._sparsity = tuple(
            float(s) for s in (sparsity if isinstance(sparsity,
                                                      (tuple, list))
                               else (sparsity,)))
        if not all(0.0 <= s < 1.0 for s in self._sparsity):
            raise ValueError("sparsity values must be in [0, 1)")

    def _init_slots(self, p32):
        return {"velocity": _zeros(p32), "residual": _zeros(p32)}

    def _sparsity_at(self, t) -> np.float32:
        """The ramp over the sparsity list in equal segments."""
        n = len(self._sparsity)
        seg = ((int(t) - self._rampup_begin - 1) * n) // self._rampup_step
        return _f32(self._sparsity[min(max(seg, 0), n - 1)])

    def _rule(self, p32s, grads, slots, lr, t, metas):
        mu = self._momentum
        u, e = slots["velocity"], slots["residual"]
        torch._foreach_mul_(u, mu)
        torch._foreach_add_(u, grads)                  # u = mu u + g
        torch._foreach_add_(e, u)                      # e = e + u
        if not t > self._rampup_begin:
            dense = (torch._foreach_add(grads, u, alpha=mu)
                     if self._nesterov else u)
            torch._foreach_add_(p32s, dense, alpha=-lr)
            torch._foreach_zero_(e)
            return
        s = self._sparsity_at(t)
        for p, ui, ei in zip(p32s, u, e):
            mag = ei.abs()
            n = mag.numel()
            idx = min(max(int(s * _f32(n)), 0), n - 1)
            kth = torch.kthvalue(mag.reshape(-1), idx + 1).values
            mask = torch.where(kth > 0, mag >= kth, mag > 0).to(ei.dtype)
            sent = ei * mask
            p.sub_(sent * lr)
            ei.sub_(sent)
            ui.mul_(1 - mask)
