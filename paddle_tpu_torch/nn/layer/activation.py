"""Activation layers (port of paddle_tpu/nn/layer/activation.py): each
calls its functional (``nn.functional.activation``) in ``forward``."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax",
           "LogSoftmax", "LeakyReLU", "ELU", "SELU", "CELU", "Hardswish",
           "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink",
           "Tanhshrink", "Softplus", "Softsign", "Mish", "GLU", "PReLU",
           "RReLU", "ThresholdedReLU", "LogSigmoid", "Maxout", "Silu",
           "Swish", "Softmax2D"]


def _simple(fn_name, **fixed):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kwargs = {**fixed}
            # positional args map onto the functional's named params in order
            self._args = args
            self._kwargs.update(kwargs)
            self._kwargs.pop("name", None)

        def forward(self, x):
            return getattr(F, fn_name)(x, *self._args, **self._kwargs)

    _Act.__name__ = fn_name
    return _Act


ReLU = _simple("relu")
ReLU6 = _simple("relu6")
Sigmoid = _simple("sigmoid")
Tanh = _simple("tanh")
Hardswish = _simple("hardswish")
Tanhshrink = _simple("tanhshrink")
Softsign = _simple("softsign")
Mish = _simple("mish")
LogSigmoid = _simple("log_sigmoid")
Silu = _simple("silu")
Swish = _simple("swish")


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self.threshold, self.value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold, self.value)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class Softmax2D(Layer):
    """Parity: nn/layer/activation.py Softmax2D — softmax over the
    channel dim of NCHW/CHW inputs."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        assert len(x.shape) in (3, 4), (
            f"Softmax2D requires a 3D or 4D tensor, got {len(x.shape)}D")
        return F.softmax(x, axis=-3)
