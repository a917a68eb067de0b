"""Carry weights and optimizer state from paddle_tpu into the port.

The port's modules keep paddle_tpu's parameter names and layouts
(``paddle_tpu/jit/functional.py:raw_state`` names such as
``gpt.block_0.attn.qkv.weight`` ``[64, 192]``), so a copy is by name with
no transpose. This module takes numpy arrays only; converting the JAX
arrays (``np.asarray``) is the caller's side of the boundary.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_paddle_tpu_params", "load_paddle_tpu_opt_state",
           "load_paddle_tpu_optimizer_state_dict"]


def load_paddle_tpu_params(model: torch.nn.Module,
                           params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy ``params`` {name: ndarray} into ``model``'s parameters in
    place. Strict: the names must be exactly the model's parameter names
    and every shape must match; values are cast to the parameter's dtype
    on its device. Returns ``model``."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    for name, arr in params.items():
        if not isinstance(arr, np.ndarray):
            raise TypeError(f"{name}: expected a numpy array, got "
                            f"{type(arr).__name__}")
        p = own[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(p.shape)}")
    with torch.no_grad():
        for name, arr in params.items():
            p = own[name]
            p.copy_(torch.tensor(arr, dtype=p.dtype, device=p.device))
    return model


def load_paddle_tpu_opt_state(optimizer, model: torch.nn.Module,
                              opt_state: Mapping[str, Mapping[str,
                                                              np.ndarray]],
                              step: int = 0, lr_state=None):
    """Load paddle_tpu's functional optimizer state (``TrainStep.opt_state``
    as numpy arrays: ``{param_name: {slot: ndarray}}``, names as
    ``model.named_parameters()``, slots whatever the optimizer keeps:
    ``moment1`` / ``moment2`` (Adam, AdamW, Lamb), ``velocity`` (Momentum,
    Lars), ``velocity`` / ``residual`` (DGCMomentum), ``moment`` /
    ``inf_norm`` (Adamax), ``moment`` (Adagrad), ``avg_squared_grad`` /
    ``avg_squared_update`` (Adadelta), ``mean_square`` / ``momentum`` /
    ``mean_grad`` (RMSProp), and ``master``) into the port's ``optimizer``
    over ``model``'s parameters, and set its step count to ``step``
    (paddle_tpu's ``TrainStep.update_count``). ``lr_state``, a paddle_tpu
    scheduler's ``state_dict()``, goes to the optimizer's scheduler
    (ValueError when it has none). Strict: the names must be exactly the
    model's and every slot array must have its parameter's shape. The
    optimizer's own slots are replaced; ``set_state_dict`` stores the new
    ones (f32, on each parameter's device). Returns ``optimizer``."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(opt_state))
    extra = sorted(set(opt_state) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    optimizer.bind_names(model)
    for name, slots in opt_state.items():
        for slot, arr in slots.items():
            _check_slot(f"{name}.{slot}", arr, own[name])
    if lr_state is not None:
        _scheduler_of(optimizer)
    optimizer._accumulators = {}
    flat = {f"{name}_{slot}": arr for name, slots in opt_state.items()
            for slot, arr in slots.items()}
    flat["@step"] = step
    if lr_state is not None:
        flat["LR_Scheduler"] = lr_state
    optimizer.set_state_dict(flat)
    return optimizer


def load_paddle_tpu_optimizer_state_dict(optimizer, state: Mapping):
    """Load paddle_tpu's ``Optimizer.state_dict()`` with its tensors as
    numpy arrays (``{f"{param_name}_{slot}": ndarray, "@step": int,
    "LR_Scheduler": dict}``) into the port's ``optimizer`` through its
    ``set_state_dict``, whose names must be paddle_tpu's. Strict where
    paddle_tpu's ``set_state_dict`` ignores: every array key must name one
    of the optimizer's parameters (longest prefix) with an array of its
    shape, and a scheduler state needs a scheduler. Returns
    ``optimizer``."""
    own = dict(zip(optimizer._names, optimizer._params))
    for key, arr in state.items():
        if key in ("@step", "LR_Scheduler"):
            continue
        match = max((n for n in own if key.startswith(n + "_")), key=len,
                    default=None)
        if match is None:
            raise KeyError(f"{key}: names no parameter of the optimizer")
        _check_slot(key, arr, own[match])
    if "LR_Scheduler" in state:
        _scheduler_of(optimizer)
    optimizer.set_state_dict(state)
    return optimizer


def _check_slot(what, arr, param):
    if not isinstance(arr, np.ndarray):
        raise TypeError(f"{what}: expected a numpy array, got "
                        f"{type(arr).__name__}")
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{what}: shape {tuple(arr.shape)} != "
                         f"{tuple(param.shape)}")


def _scheduler_of(optimizer):
    sched = optimizer._learning_rate
    if not hasattr(sched, "set_state_dict"):
        raise ValueError("a scheduler state was given but the optimizer's "
                         "learning rate is not a scheduler")
    return sched
