"""Activation layers (port of paddle_tpu/nn/layer/activation.py: Tanh)."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["Tanh"]


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)
