"""Activations (port of paddle_tpu/nn/functional/activation.py: relu,
tanh, gelu, silu)."""
from __future__ import annotations

import torch

__all__ = ["relu", "tanh", "gelu", "silu"]


def relu(x, name=None):
    """``max(x, 0)``, as ``jax.nn.relu``; ``name`` is ignored."""
    return torch.relu(x)


def tanh(x, name=None):
    """``tanh(x)``, as ``jnp.tanh``; ``name`` is ignored."""
    return torch.tanh(x)


def gelu(x, approximate=False, name=None):
    """GELU as ``jax.nn.gelu(x, approximate)``: the exact erf form by
    default (BERT's and GPT's), the tanh form with ``approximate=True``;
    ``name`` is ignored."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    """``x * sigmoid(x)``, as ``jax.nn.silu``; ``name`` is ignored."""
    return torch.nn.functional.silu(x)
