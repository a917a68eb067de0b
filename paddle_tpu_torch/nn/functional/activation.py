"""Activations (port of paddle_tpu/nn/functional/activation.py): the
same formulas as its ``jax.nn`` / ``jnp`` maps, in plain PyTorch (no
kernel: XLA fuses them there). ``name`` is ignored everywhere, as
paddle_tpu ignores it."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...framework import random as _random
from ...framework.dtype import convert_dtype

__all__ = [
    "relu", "relu_", "relu6", "gelu", "silu", "swish", "sigmoid", "tanh",
    "softmax", "log_softmax", "leaky_relu", "elu", "selu", "celu",
    "hardswish", "hardsigmoid", "hardtanh", "hardshrink", "softshrink",
    "tanhshrink", "softplus", "softsign", "mish", "glu", "prelu", "rrelu",
    "thresholded_relu", "log_sigmoid", "maxout", "swiglu",
]


def relu(x, name=None):
    """``max(x, 0)``, as ``jax.nn.relu``."""
    return torch.relu(x)


def relu_(x, name=None):
    """``relu`` in place."""
    return torch.relu_(x)


def relu6(x, name=None):
    return tF.relu6(x)


def gelu(x, approximate=False, name=None):
    """GELU as ``jax.nn.gelu(x, approximate)``: the exact erf form by
    default (BERT's and GPT's), the tanh form with ``approximate=True``."""
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    """``x * sigmoid(x)``, as ``jax.nn.silu``."""
    return tF.silu(x)


def swish(x, name=None):
    return silu(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    """``tanh(x)``, as ``jnp.tanh``."""
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def leaky_relu(x, negative_slope=0.01, name=None):
    return tF.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0, name=None):
    return tF.elu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    # the untaken branch's input is clipped so that its (discarded)
    # gradient cannot overflow, as in paddle_tpu
    return scale * torch.where(x > 0, x,
                               alpha * torch.expm1(torch.clamp(x, max=0.0)))


def celu(x, alpha=1.0, name=None):
    return tF.celu(x, alpha)


def hardswish(x, name=None):
    """``x * relu6(x + 3) / 6``, as ``jax.nn.hard_swish``."""
    return tF.hardswish(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    # the exp's argument is clamped in the untaken branch, as in paddle_tpu
    return torch.where(beta * x > threshold, x,
                       torch.log1p(torch.exp(torch.clamp(
                           beta * x, max=threshold))) / beta)


def softsign(x, name=None):
    return x / (1 + x.abs())


def mish(x, name=None):
    return x * torch.tanh(tF.softplus(x))


def log_sigmoid(x, name=None):
    return tF.logsigmoid(x)


def glu(x, axis=-1, name=None):
    return tF.glu(x, dim=axis)


def swiglu(x, y=None, name=None):
    if y is None:
        a, b = torch.chunk(x, 2, dim=-1)
        return tF.silu(a) * b
    return tF.silu(x) * y


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where ``x >= 0``, else ``weight * x``: one weight for all,
    or one a channel (axis 1 for NCHW, the last axis otherwise)."""
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    shape = [1] * x.ndim
    shape[1 if data_format == "NCHW" else x.ndim - 1] = weight.numel()
    return torch.where(x >= 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """Randomised leaky relu: in training each negative entry's slope is
    drawn from U(lower, upper) (the port's generator for x's device),
    else the mean slope ``(lower + upper) / 2``."""
    if training:
        a = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        a.uniform_(lower, upper,
                   generator=_random.default_generator().get(x.device))
        return torch.where(x >= 0, x, a.to(x.dtype) * x)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


def maxout(x, groups, axis=1, name=None):
    ax = axis % x.ndim
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(ax + 1)
