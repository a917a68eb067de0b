"""Normalisation (port of paddle_tpu/nn/functional/norm.py: layer_norm,
rms_norm)."""
from __future__ import annotations

import torch

__all__ = ["layer_norm", "rms_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing ``len(normalized_shape)`` axes (an int
    is one axis), written as paddle_tpu writes it: ``(x - mean) / sqrt(var
    + eps)`` with the population variance, then ``* weight`` and ``+
    bias`` where given. ``name`` is ignored, as paddle_tpu ignores it."""
    n = 1 if isinstance(normalized_shape, int) else len(normalized_shape)
    axes = tuple(range(x.ndim - n, x.ndim))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, keepdim=True, unbiased=False)
    out = (x - mean) / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


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
