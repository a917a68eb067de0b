"""The port's activation functionals and layers against paddle_tpu's.

Every name of ``nn.functional.activation.__all__`` and every activation
layer class goes through the port and through paddle_tpu on one fixed f32
input (and a fixed output gradient): outputs and input gradients agree
within 1e-6 (abs) + 1e-6 (rel), and so do the gradients of a layer's own
parameters (``PReLU``'s weight). ``rrelu`` / ``RReLU`` are held in eval
mode, where they are deterministic.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn.functional import activation as jact
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn.functional import activation as tact

TOL = dict(atol=1e-6, rtol=1e-6)
# [N, C, H, W]: C 4 for prelu's channels and maxout's groups of 2, W 6
# for glu's and swiglu's halves; values of either sign up to about 6
_X = (np.random.RandomState(0).randn(2, 4, 3, 6) * 2.0).astype(np.float32)
_Y = np.random.RandomState(2).randn(2, 4, 3, 6).astype(np.float32)
_W4 = np.array([0.25, -0.1, 0.5, 1.5], np.float32)


@pytest.fixture(autouse=True)
def _on_cpu():
    """Layers build on the card by default; these tests build them on the
    CPU, as paddle's ``set_device("cpu")`` asks."""
    tpkg.set_device("cpu")
    yield
    tpkg.set_device(None)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


def _grad_out(shape):
    return np.random.RandomState(1).randn(*shape).astype(np.float32)


def _run_port(fn, extra=()):
    """fn(x, *extra) in the port, then backward from a fixed output
    gradient; returns (out, dx, [d extra])."""
    x = torch.from_numpy(_X.copy()).requires_grad_()
    ex = [torch.from_numpy(e.copy()).requires_grad_() for e in extra]
    out = fn(x, *ex)
    (out * torch.from_numpy(_grad_out(out.shape))).sum().backward()
    return _np(out), _np(x.grad), [_np(e.grad) for e in ex]


def _run_ref(fn, extra=()):
    x = paddle.to_tensor(_X.copy(), stop_gradient=False)
    ex = [paddle.to_tensor(e.copy(), stop_gradient=False) for e in extra]
    out = fn(x, *ex)
    (out * paddle.to_tensor(_grad_out(out.shape))).sum().backward()
    return (out.numpy(), np.asarray(x.grad),
            [np.asarray(e.grad) for e in ex])


def _hold(got, want):
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a, b, **TOL)


# (case id, functional name, extra tensor inputs, keyword arguments); every
# name of the reference's __all__ appears at least once (checked below)
_FUNCTIONAL = [
    ("relu", "relu", (), {}),
    ("relu6", "relu6", (), {}),
    ("gelu", "gelu", (), {}),
    ("gelu-tanh", "gelu", (), {"approximate": True}),
    ("silu", "silu", (), {}),
    ("swish", "swish", (), {}),
    ("sigmoid", "sigmoid", (), {}),
    ("tanh", "tanh", (), {}),
    ("softmax", "softmax", (), {}),
    ("softmax-axis1", "softmax", (), {"axis": 1}),
    ("softmax-f32", "softmax", (), {"axis": 2, "dtype": "float32"}),
    ("log_softmax", "log_softmax", (), {}),
    ("log_softmax-axis1", "log_softmax", (), {"axis": 1,
                                              "dtype": "float32"}),
    ("leaky_relu", "leaky_relu", (), {"negative_slope": 0.2}),
    ("elu", "elu", (), {"alpha": 0.7}),
    ("selu", "selu", (), {}),
    ("celu", "celu", (), {"alpha": 0.7}),
    ("hardswish", "hardswish", (), {}),
    ("hardsigmoid", "hardsigmoid", (), {}),
    ("hardsigmoid-args", "hardsigmoid", (), {"slope": 0.2, "offset": 0.4}),
    ("hardtanh", "hardtanh", (), {"min": -0.5, "max": 2.0}),
    ("hardshrink", "hardshrink", (), {"threshold": 0.7}),
    ("softshrink", "softshrink", (), {"threshold": 0.7}),
    ("tanhshrink", "tanhshrink", (), {}),
    ("softplus", "softplus", (), {}),
    ("softplus-args", "softplus", (), {"beta": 2.0, "threshold": 5.0}),
    ("softsign", "softsign", (), {}),
    ("mish", "mish", (), {}),
    ("glu", "glu", (), {}),
    ("glu-axis1", "glu", (), {"axis": 1}),
    ("prelu-1", "prelu", (np.array([0.3], np.float32),), {}),
    ("prelu-C", "prelu", (_W4,), {}),
    ("prelu-NHWC", "prelu",
     (np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6], np.float32),),
     {"data_format": "NHWC"}),
    ("rrelu-eval", "rrelu", (), {"lower": 0.1, "upper": 0.3}),
    ("thresholded_relu", "thresholded_relu", (), {"threshold": 0.5,
                                                  "value": 0.1}),
    ("log_sigmoid", "log_sigmoid", (), {}),
    ("maxout", "maxout", (), {"groups": 2}),
    ("maxout-last", "maxout", (), {"groups": 3, "axis": -1}),
    ("swiglu", "swiglu", (), {}),
    ("swiglu-xy", "swiglu", (_Y,), {}),
]


def test_every_functional_is_held():
    held = {name for _, name, _, _ in _FUNCTIONAL} | {"relu_"}
    assert held == set(jact.__all__) == set(tact.__all__)


@pytest.mark.parametrize("name,extra,kw", [c[1:] for c in _FUNCTIONAL],
                         ids=[c[0] for c in _FUNCTIONAL])
def test_functional_matches_reference(name, extra, kw):
    _hold(_run_port(lambda *a: getattr(tact, name)(*a, **kw), extra),
          _run_ref(lambda *a: getattr(jact, name)(*a, **kw), extra))


def test_relu_inplace_matches_reference():
    """``relu_`` works in place in the port (paddle_tpu's returns a new
    value): the same values, and the port's tensor is the one changed."""
    x = torch.from_numpy(_X.copy())
    out = tact.relu_(x)
    np.testing.assert_array_equal(
        _np(out), jact.relu_(paddle.to_tensor(_X.copy())).numpy())
    np.testing.assert_array_equal(_np(x), _np(out))


# (case id, class name, constructor arguments); every class of the
# reference's nn/layer/activation.py __all__ appears at least once
_LAYERS = [
    ("ReLU", "ReLU", {}), ("ReLU6", "ReLU6", {}), ("GELU", "GELU", {}),
    ("GELU-tanh", "GELU", {"approximate": True}),
    ("Sigmoid", "Sigmoid", {}), ("Tanh", "Tanh", {}),
    ("Softmax", "Softmax", {"axis": 1}), ("LogSoftmax", "LogSoftmax", {}),
    ("LeakyReLU", "LeakyReLU", {"negative_slope": 0.3}),
    ("ELU", "ELU", {"alpha": 0.5}), ("SELU", "SELU", {}),
    ("CELU", "CELU", {"alpha": 1.5}), ("Hardswish", "Hardswish", {}),
    ("Hardsigmoid", "Hardsigmoid", {}),
    ("Hardtanh", "Hardtanh", {"min": -2.0, "max": 1.0}),
    ("Hardshrink", "Hardshrink", {"threshold": 1.0}),
    ("Softshrink", "Softshrink", {"threshold": 1.0}),
    ("Tanhshrink", "Tanhshrink", {}),
    ("Softplus", "Softplus", {"beta": 0.5, "threshold": 3.0}),
    ("Softsign", "Softsign", {}), ("Mish", "Mish", {}),
    ("GLU", "GLU", {"axis": -1}), ("PReLU-1", "PReLU", {}),
    ("PReLU-C", "PReLU", {"num_parameters": 4, "init": 0.1}),
    ("RReLU-eval", "RReLU", {"lower": 0.2, "upper": 0.4}),
    ("ThresholdedReLU", "ThresholdedReLU", {"threshold": 0.8}),
    ("LogSigmoid", "LogSigmoid", {}), ("Maxout", "Maxout", {"groups": 2}),
    ("Silu", "Silu", {}), ("Swish", "Swish", {}),
    ("Softmax2D", "Softmax2D", {}),
]


def test_every_layer_is_held():
    held = {cls for _, cls, _ in _LAYERS}
    assert held == set(jnn.layer.activation.__all__)


@pytest.mark.parametrize("cls,kw", [c[1:] for c in _LAYERS],
                         ids=[c[0] for c in _LAYERS])
def test_layer_matches_reference(cls, kw):
    tm, jm = getattr(nn, cls)(**kw), getattr(jnn, cls)(**kw)
    tm.eval()
    jm.eval()
    tp, jp = list(tm.named_parameters()), list(jm.named_parameters())
    assert [n for n, _ in tp] == [n for n, _ in jp]
    for (_, a), (_, b) in zip(tp, jp):
        np.testing.assert_array_equal(_np(a), b.numpy())
    _hold(_run_port(tm), _run_ref(jm))
    for (n, a), (_, b) in zip(tp, jp):
        np.testing.assert_allclose(_np(a.grad), np.asarray(b._grad),
                                   err_msg=n, **TOL)
