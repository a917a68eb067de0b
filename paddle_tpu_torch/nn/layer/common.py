"""Linear, Embedding and Dropout (port of paddle_tpu/nn/layer/common.py).

paddle's layouts: a Linear weight is ``[in, out]`` and applies as ``x @ W
+ b``, so weights carry across from paddle_tpu by name with no transpose
(``convert.load_paddle_tpu_params``). The models draw the weights
(``models/``); the layers only allocate them.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(nn.Module):
    """Paddle-layout linear: weight ``[in, out]``, ``y = x @ W + b``."""

    def __init__(self, in_features, out_features, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = (nn.Parameter(torch.zeros(out_features))
                     if bias else None)

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """Rows of ``weight`` ``[num_embeddings, embedding_dim]`` by index."""

    def __init__(self, num_embeddings, embedding_dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings,
                                               embedding_dim))

    @property
    def num_embeddings(self) -> int:
        return self.weight.shape[0]

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


class Dropout(nn.Module):
    """``F.dropout`` in training mode, the identity in eval mode."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"
