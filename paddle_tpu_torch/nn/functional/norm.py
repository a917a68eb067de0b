"""Normalisation (port of paddle_tpu/nn/functional/norm.py:layer_norm)."""
from __future__ import annotations

import torch

__all__ = ["layer_norm"]


def layer_norm(x, weight, bias, epsilon: float = 1e-5):
    """LayerNorm over the last axis, written as paddle_tpu writes it:
    ``(x - mean) / sqrt(var + eps) * weight + bias`` with the population
    variance."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + epsilon) * weight + bias
