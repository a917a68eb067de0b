"""paddle_tpu_torch.nn's bindings and default initialisers against
paddle_tpu.nn's.

``F.layer_norm`` normalises the trailing ``normalized_shape`` axes with
optional affine tensors, as paddle_tpu's does (atol 1e-6); ``Linear``,
``Embedding``, ``LayerNorm`` and ``RMSNorm`` take paddle_tpu's
``weight_attr`` / ``bias_attr`` (False drops the parameter, None keeps
it); ``Embedding(padding_idx=k)`` zeroes row k, its lookups and its
gradient; a layer built alone draws paddle_tpu's default initialisers
(Xavier normal, zeros, N(0, 1)) from ``framework.random``, compared by
mean and standard deviation (the generators differ by design, so not
bit for bit), while the models draw their weights once.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import device as tdev, nn, seed
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny)
from paddle_tpu_torch.nn import functional as F


@pytest.fixture(autouse=True)
def _on_cpu():
    """Layers build on the card by default; these tests build them on the
    CPU, as paddle's ``set_device("cpu")`` asks."""
    tdev.set_device("cpu")
    yield
    tdev.set_device(None)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


@pytest.mark.parametrize("shape", [8, [8], [4, 8]], ids=["int", "1", "2"])
@pytest.mark.parametrize("affine", [(True, True), (True, False),
                                    (False, True), (False, False)],
                         ids=["wb", "w", "b", "none"])
def test_layer_norm_matches_reference(shape, affine):
    rs = np.random.RandomState(0)
    x = rs.randn(3, 4, 8).astype(np.float32) * 3 + 1
    norm = [shape] if isinstance(shape, int) else shape
    w = rs.randn(*norm).astype(np.float32) if affine[0] else None
    b = rs.randn(*norm).astype(np.float32) if affine[1] else None
    got = F.layer_norm(torch.from_numpy(x), shape,
                       None if w is None else torch.from_numpy(w),
                       None if b is None else torch.from_numpy(b), 1e-5)
    want = jF.layer_norm(paddle.to_tensor(x), shape,
                         None if w is None else paddle.to_tensor(w),
                         None if b is None else paddle.to_tensor(b), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)


def test_layer_norm_layer_over_two_axes_and_attrs():
    x = np.random.RandomState(1).randn(2, 4, 8).astype(np.float32)
    ln, jln = nn.LayerNorm([4, 8]), jnn.LayerNorm([4, 8])
    assert list(ln.weight.shape) == [4, 8]
    np.testing.assert_allclose(_np(ln(torch.from_numpy(x))),
                               _np(jln(paddle.to_tensor(x))), atol=1e-6)
    no_w = nn.LayerNorm(8, weight_attr=False)
    assert no_w.weight is None and no_w.bias is not None
    assert nn.LayerNorm(8, bias_attr=False).bias is None
    assert nn.RMSNorm(8, weight_attr=False).weight is None
    assert torch.equal(nn.RMSNorm(8).weight, torch.ones(8))


def test_linear_bias_attr_binds_as_reference():
    assert nn.Linear(4, 8, None).bias is not None
    assert jnn.Linear(4, 8, None).bias is not None
    assert nn.Linear(4, 8, bias_attr=False).bias is None
    assert jnn.Linear(4, 8, bias_attr=False).bias is None
    assert nn.Linear(4, 8, weight_attr="w", bias_attr="b").bias is not None
    # an initializer object (or a ParamAttr holding one) sets the weight
    ones = nn.Linear(4, 8, weight_attr=nn.initializer.Constant(1.0))
    jones = jnn.Linear(4, 8, weight_attr=jnn.initializer.Constant(1.0))
    np.testing.assert_array_equal(_np(ones.weight), _np(jones.weight))
    jl = jnn.Linear(4, 8)
    tl = nn.Linear(4, 8)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(_np(jl.weight))))
        tl.bias.copy_(torch.from_numpy(np.array(_np(jl.bias))))
    x = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                               _np(jl(paddle.to_tensor(x))), atol=1e-6)


def test_embedding_padding_idx_zeroes_row_lookup_and_grad():
    ids = np.array([[1, 2, 2, 3], [0, 2, 4, 2]])
    je = jnn.Embedding(10, 4, padding_idx=2)
    te = nn.Embedding(10, 4, padding_idx=2)
    assert float(te.weight.detach()[2].abs().sum()) == 0.0
    with torch.no_grad():
        te.weight.copy_(torch.from_numpy(np.array(_np(je.weight))))
        te.weight[2] = 1.0            # a later update of the row: its
    je.weight.set_value(_np(te.weight))   # lookups still read zeros
    y = te(torch.from_numpy(ids))
    jy = je(paddle.to_tensor(ids))
    np.testing.assert_allclose(_np(y), _np(jy), atol=0)
    assert float(y[0, 1].abs().sum()) == 0.0
    (y * y).sum().backward()
    (jy * jy).sum().backward()
    np.testing.assert_allclose(_np(te.weight.grad), _np(je.weight.grad),
                               atol=1e-6)
    assert float(te.weight.grad[2].abs().sum()) == 0.0


def _moments(a):
    a = np.asarray(a, np.float64).ravel()
    return a.mean(), a.std(), a.size


@pytest.mark.parametrize("layer", ["linear", "embedding"])
def test_default_init_moments_match_reference(layer):
    """Mean and std of a default-initialised weight against the
    reference's and the initialiser's own: within 6 standard errors."""
    seed(0)
    paddle.seed(0)
    if layer == "linear":
        t, j = nn.Linear(256, 512), jnn.Linear(256, 512)
        std = math.sqrt(2.0 / (256 + 512))
        assert float(t.bias.abs().sum()) == 0.0
    else:
        t, j = nn.Embedding(2000, 64), jnn.Embedding(2000, 64)
        std = 1.0
    for w in (_np(t.weight), _np(j.weight)):
        mean, sd, n = _moments(w)
        assert abs(mean) < 6 * std / math.sqrt(n)
        assert abs(sd - std) < 6 * std / math.sqrt(2 * n)
    seed(0)
    again = nn.Linear(256, 512) if layer == "linear" else \
        nn.Embedding(2000, 64)
    assert torch.equal(again.weight, t.weight)      # seeded by framework


@pytest.mark.parametrize("build", [
    lambda: GPTForCausalLM(gpt_tiny(), device="cpu", seed=0),
    lambda: LlamaForCausalLM(llama_tiny(), device="cpu", seed=0)],
    ids=["gpt", "llama"])
def test_models_draw_their_weights_once(build):
    """The models' layers skip the default draws: the framework's
    generator does not move while a model is built."""
    seed(5)
    state = trandom.default_generator().get("cpu").get_state()
    build()
    assert torch.equal(trandom.default_generator().get("cpu").get_state(),
                       state)
