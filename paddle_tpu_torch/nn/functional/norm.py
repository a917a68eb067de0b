"""Normalisation (port of paddle_tpu/nn/functional/norm.py: layer_norm,
rms_norm)."""
from __future__ import annotations

import torch

__all__ = ["layer_norm", "rms_norm"]


def layer_norm(x, weight, bias, epsilon: float = 1e-5):
    """LayerNorm over the last axis, written as paddle_tpu writes it:
    ``(x - mean) / sqrt(var + eps) * weight + bias`` with the population
    variance."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + epsilon) * weight + bias


def rms_norm(x, weight=None, epsilon: float = 1e-6, axis: int = -1,
             name=None):
    """RMSNorm in paddle_tpu's order of operations: the mean of squares
    in f32, ``x * rsqrt(ms + eps)`` in f32, cast back to x's dtype, and
    only then times ``weight`` (in bf16 a multiply fused in f32 would round
    differently). ``name`` is ignored, as paddle_tpu ignores it."""
    xf = x.float()
    ms = xf.square().mean(axis, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight
