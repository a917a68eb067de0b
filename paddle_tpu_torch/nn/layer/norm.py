"""LayerNorm and RMSNorm (port of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(Layer):
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
        self.weight = self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self.normalized_shape,
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(Layer):
    """paddle_tpu's ``nn.RMSNorm`` (Llama's norm): ``weight`` initialised
    to ones (``weight_attr=False``: none), no bias."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
