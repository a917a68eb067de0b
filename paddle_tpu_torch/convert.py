"""Carry weights from paddle_tpu into a port model.

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

__all__ = ["load_paddle_tpu_params"]


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
