"""Weight initializers (port of paddle_tpu/nn/initializer.py).

Each initializer is a callable ``(shape, dtype) -> tensor``, as in
paddle_tpu, built where ``Layer.create_parameter`` builds
(``device.param_device``: the card unless ``set_device`` or a torch
device context says otherwise; on the meta device nothing is drawn);
``Layer.create_parameter`` fills its parameter in place through
``_fill``. Random draws come from ``framework.random``'s generator for
the tensor's device, in f32, cast to the tensor's dtype after; so they
match paddle_tpu's by distribution, not bit for bit (threefry there).
The deterministic fills (``Constant``, ``Assign``, ``Dirac``,
``Bilinear``) and ``calculate_gain`` / ``_fans`` equal paddle_tpu's
exactly.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import param_device
from ..framework import random as _random
from ..framework.dtype import convert_dtype

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Orthogonal", "Dirac", "calculate_gain", "Bilinear",
           "set_global_initializer"]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels (out_c, in_c, *spatial): receptive field x channels
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 3.0 / 4.0}
    return gains.get(nonlinearity, 1.0)


class Initializer:
    """``init(shape, dtype)`` -> a new tensor; ``init._fill(t)`` fills
    ``t`` in place (nothing on the meta device). ``random`` says whether
    the fill draws: ``_no_default_init()`` skips such fills."""

    random = True

    def __call__(self, shape, dtype="float32"):
        t = torch.empty(tuple(int(s) for s in shape),
                        dtype=convert_dtype(dtype), device=param_device())
        self._fill(t)
        return t

    def _fill(self, t):
        if t.is_meta:
            return t
        with torch.no_grad():
            if not self.random:
                t.copy_(self._values(tuple(t.shape)).to(t.device, t.dtype))
                return t
            g = _random.default_generator().get(t.device)
            host = t if t.dtype == torch.float32 else torch.empty(
                t.shape, dtype=torch.float32, device=t.device)
            self._draw(host, g)
            if host is not t:
                t.copy_(host)
        return t

    def _draw(self, t, g):
        """Fill the f32 tensor ``t`` from generator ``g`` (random
        initializers)."""
        raise NotImplementedError

    def _values(self, shape):
        """The f32 (or exact) CPU tensor of ``shape`` (deterministic
        initializers)."""
        raise NotImplementedError


class Constant(Initializer):
    random = False

    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, t):
        if not t.is_meta:
            with torch.no_grad():
                t.fill_(self.value)
        return t


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _draw(self, t, g):
        t.normal_(self.mean, self.std, generator=g)


class TruncatedNormal(Initializer):
    """``mean + std * z``, z a standard normal truncated to [a, b] (a and
    b in standard units, as paddle_tpu's)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _draw(self, t, g):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, self.a, self.b,
                                    generator=g)
        t.mul_(self.std).add_(self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _draw(self, t, g):
        t.uniform_(self.low, self.high, generator=g)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, t, g):
        fi, fo = _fans(t.shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        t.normal_(0.0, std, generator=g)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, t, g):
        fi, fo = _fans(t.shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        t.uniform_(-limit, limit, generator=g)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.slope, self.nonlinearity = \
            fan_in, negative_slope, nonlinearity

    def _draw(self, t, g):
        fi = self.fan_in or _fans(t.shape)[0]
        gain = calculate_gain(self.nonlinearity, self.slope)
        t.normal_(0.0, gain / math.sqrt(fi), generator=g)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.slope, self.nonlinearity = \
            fan_in, negative_slope, nonlinearity

    def _draw(self, t, g):
        fi = self.fan_in or _fans(t.shape)[0]
        gain = calculate_gain(self.nonlinearity, self.slope)
        limit = gain * math.sqrt(3.0 / fi)
        t.uniform_(-limit, limit, generator=g)


class Assign(Initializer):
    """The given values (a tensor, an array or a list), reshaped to the
    parameter's shape."""

    random = False

    def __init__(self, value):
        self.value = value

    def _values(self, shape):
        v = self.value
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().reshape(shape)
        return torch.as_tensor(np.asarray(v)).reshape(shape)


class Orthogonal(Initializer):
    """``gain`` times a (semi-)orthogonal matrix over ``[prod(shape[:-1]),
    shape[-1]]``: the Q of a Gaussian matrix's QR with R's diagonal made
    positive (Haar-distributed; paddle_tpu takes
    ``jax.random.orthogonal`` for a square shape, the same law)."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _draw(self, t, g):
        rows = int(np.prod(t.shape[:-1]))
        cols = t.shape[-1]
        a = torch.empty(max(rows, cols), min(rows, cols), device=t.device)
        a.normal_(0.0, 1.0, generator=g)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        t.copy_(self.gain * q[:rows, :cols].reshape(t.shape))


class Dirac(Initializer):
    random = False

    def __init__(self, groups=1):
        self.groups = groups

    def _values(self, shape):
        w = np.zeros(shape, dtype=np.float32)
        oc, ic = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        for i in range(min(oc, ic * self.groups)):
            w[(i, i % ic) + tuple(centers)] = 1.0
        return torch.from_numpy(w)


class Bilinear(Initializer):
    """A (transposed) conv weight of bilinear upsampling: every (out, in)
    channel pair gets the separable triangle kernel."""

    random = False

    def _values(self, shape):
        if len(shape) < 2:
            raise ValueError("Bilinear initializer needs a conv-like "
                             f"weight rank >= 2, got {shape}")
        kh, kw = (shape[-2], shape[-1]) if len(shape) >= 4 else \
            (1, shape[-1])
        f_h, f_w = int(np.ceil(kh / 2.0)), int(np.ceil(kw / 2.0))
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        ii = np.arange(kh)[:, None]
        jj = np.arange(kw)[None, :]
        k2d = ((1 - np.abs(ii / f_h - c_h)) *
               (1 - np.abs(jj / f_w - c_w))).astype("float32")
        return torch.from_numpy(np.broadcast_to(k2d, shape).copy())


_GLOBAL_WEIGHT_INIT = None
_GLOBAL_BIAS_INIT = None


def set_global_initializer(weight_init, bias_init=None):
    """Default initializers for parameters created afterwards whose
    ParamAttr sets none (they override a layer's built-in default, as in
    paddle). ``(None, None)`` resets."""
    global _GLOBAL_WEIGHT_INIT, _GLOBAL_BIAS_INIT
    _GLOBAL_WEIGHT_INIT = weight_init
    _GLOBAL_BIAS_INIT = bias_init


def _global_initializer(is_bias: bool):
    return _GLOBAL_BIAS_INIT if is_bias else _GLOBAL_WEIGHT_INIT
