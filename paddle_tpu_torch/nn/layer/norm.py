"""LayerNorm and RMSNorm (port of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the last axis: ``weight`` ones, ``bias`` zeros."""

    def __init__(self, normalized_shape, epsilon=1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(normalized_shape))
        self.bias = nn.Parameter(torch.zeros(normalized_shape))

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self.epsilon)


class RMSNorm(nn.Module):
    """paddle_tpu's ``nn.RMSNorm`` (Llama's norm): ``weight`` initialised
    to ones, no bias."""

    def __init__(self, hidden_size, epsilon=1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
