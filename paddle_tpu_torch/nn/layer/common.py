"""Linear, Embedding and Dropout (port of paddle_tpu/nn/layer/common.py).

paddle's layouts: a Linear weight is ``[in, out]`` and applies as ``x @ W
+ b``, so weights carry across from paddle_tpu by name with no transpose
(``convert.load_paddle_tpu_params``).

A layer built on its own draws paddle_tpu's default initialisers at
construction (``Layer.create_parameter``, on the card unless the caller
asks otherwise): a Linear weight Xavier normal, its bias zeros, an
Embedding weight N(0, 1), from ``framework.random``'s generator of the
device the parameter is built on; ``weight_attr`` / ``bias_attr`` take a
ParamAttr, an initializer, a name or False, as in paddle_tpu. The models
draw their own weights, so they build their layers on the meta device,
where nothing is drawn: no weight is drawn twice.
"""
from __future__ import annotations

import torch

from ...framework import random as _random
from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer, _skip_random_init

__all__ = ["Linear", "Embedding", "Dropout"]


def _draw(p, fill, random=True):
    """``fill(p, generator)`` under no_grad, unless ``p`` has no memory
    (the meta device) or, for a ``random`` fill, the default draws are
    off. Constant fills (ones, zeros) always run."""
    if p is None or p.is_meta:
        return
    if random and _skip_random_init():
        return
    with torch.no_grad():
        fill(p, _random.default_generator().get(p.device) if random
             else None)


class Linear(Layer):
    """Paddle-layout linear: weight ``[in, out]``, ``y = x @ W + b``;
    ``bias_attr=False`` drops the bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    """Rows of ``weight`` ``[num_embeddings, embedding_dim]`` by index.
    With ``padding_idx`` that row starts at zero and, as in paddle_tpu,
    the lookup of that index gives zeros, so the row gets no gradient.
    ``sparse`` is accepted and ignored (gradients are dense)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            _draw(self.weight, lambda p, g: p[padding_idx].zero_())

    @property
    def num_embeddings(self) -> int:
        return self.weight.shape[0]

    def forward(self, x):
        out = torch.nn.functional.embedding(x, self.weight)
        if self.padding_idx is None:
            return out
        return torch.where((x == self.padding_idx)[..., None],
                           torch.zeros((), dtype=out.dtype,
                                       device=out.device), out)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    """``F.dropout`` in training mode, the identity in eval mode."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"
