"""Activations (port of paddle_tpu/nn/functional/activation.py: gelu,
silu)."""
from __future__ import annotations

import torch

__all__ = ["gelu", "silu"]


def gelu(x):
    """Exact (erf) GELU, as ``jax.nn.gelu(approximate=False)``."""
    return torch.nn.functional.gelu(x, approximate="none")


def silu(x, name=None):
    """``x * sigmoid(x)``, as ``jax.nn.silu``; ``name`` is ignored."""
    return torch.nn.functional.silu(x)
