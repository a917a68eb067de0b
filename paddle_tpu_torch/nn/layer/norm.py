"""LayerNorm and RMSNorm (port of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .common import _draw, _param

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes: ``weight``
    ones, ``bias`` zeros; ``weight_attr=False`` / ``bias_attr=False``
    drop them."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = _param(self.normalized_shape, weight_attr,
                             "weight_attr")
        self.bias = _param(self.normalized_shape, bias_attr, "bias_attr")
        _draw(self.weight, lambda p, g: p.fill_(1.0), random=False)
        _draw(self.bias, lambda p, g: p.zero_(), random=False)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(nn.Module):
    """paddle_tpu's ``nn.RMSNorm`` (Llama's norm): ``weight`` initialised
    to ones (``weight_attr=False``: none), no bias."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param((hidden_size,), weight_attr, "weight_attr")
        _draw(self.weight, lambda p, g: p.fill_(1.0), random=False)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
