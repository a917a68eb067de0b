"""Activations (port of paddle_tpu/nn/functional/activation.py:gelu)."""
from __future__ import annotations

import torch

__all__ = ["gelu"]


def gelu(x):
    """Exact (erf) GELU, as ``jax.nn.gelu(approximate=False)``."""
    return torch.nn.functional.gelu(x, approximate="none")
