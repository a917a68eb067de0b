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

__all__ = ["load_paddle_tpu_params", "load_paddle_tpu_opt_state"]


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
                              step: int = 0):
    """Load paddle_tpu's functional optimizer state (``TrainStep.opt_state``
    as numpy arrays: ``{param_name: {"moment1": ..., "moment2": ...,
    "master": ...}}``, names as ``model.named_parameters()``) into the
    port's ``optimizer`` over ``model``'s parameters, and set its step
    count to ``step`` (paddle_tpu's ``TrainStep.update_count``). Strict:
    the names must be exactly the model's and every slot array must have
    its parameter's shape; ``optimizer.set_state`` stores them. Returns
    ``optimizer``."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(opt_state))
    extra = sorted(set(opt_state) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    optimizer.bind_names(model)
    for name, slots in opt_state.items():
        p = own[name]
        for slot, arr in slots.items():
            if not isinstance(arr, np.ndarray):
                raise TypeError(f"{name}.{slot}: expected a numpy array, got "
                                f"{type(arr).__name__}")
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}.{slot}: shape {tuple(arr.shape)} "
                                 f"!= {tuple(p.shape)}")
    optimizer.set_state(opt_state, step)
    return optimizer
