"""paddle_tpu_torch's dropout, its random state and the attention-dropout
branch, against paddle_tpu's.

The port's masks come from its own generators (``framework.random``),
not JAX's threefry, by design: ``dropout`` is held by its distribution
(the keep rate within 5 binomial standard deviations, the scale
``1 / (1 - p)``) and its reproducibility per seed; the attention branch is
held to paddle_tpu's own formula (``_xla_attention`` with a rate) fed the
port's keep mask, rebuilt from a reseeded generator, at atol 1e-6 (the
same f32 softmax and products; values are O(1)).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as TF

# both packages re-export a flash_attention function under the module's name
jfa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")


def test_identity_at_p0_and_in_eval():
    x = torch.randn(4, 8)
    assert TF.dropout(x, 0.0) is x
    assert TF.dropout(x, 0.5, training=False) is x
    layer = Dropout(0.3).eval()
    assert layer(x) is x
    q = torch.randn(1, 8, 2, 4)
    want = TF.flash_attention(q, q, q)[0]
    assert torch.equal(TF.flash_attention(q, q, q, dropout=0.4,
                                          training=False)[0], want)
    assert torch.equal(TF.scaled_dot_product_attention(
        q, q, q, dropout_p=0.4, training=False), want)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_and_scale(p):
    """The kept share lies within 5 binomial standard deviations of 1 - p;
    every kept element is x / (1 - p) (in x's dtype, as paddle_tpu
    divides), every other 0."""
    n = 200_000
    paddle_tpu_torch.seed(11)
    x = torch.full((n,), 3.0)
    y = TF.dropout(x, p)
    kept = y != 0
    share = kept.float().mean().item()
    sd = (p * (1 - p) / n) ** 0.5
    assert abs(share - (1 - p)) <= 5 * sd
    assert torch.equal(y[kept], x[kept] / (1 - p))


def test_downscale_mode_keeps_values():
    paddle_tpu_torch.seed(0)
    x = torch.randn(1000)
    y = TF.dropout(x, 0.3, mode="downscale_in_infer")
    kept = y != 0
    assert torch.equal(y[kept], x[kept]) and 0 < int(kept.sum()) < 1000


def test_same_seed_same_mask_and_state_round_trip():
    x = torch.ones(64, 64)
    paddle_tpu_torch.seed(5)
    a = TF.dropout(x, 0.5)
    b = TF.dropout(x, 0.5)
    paddle_tpu_torch.seed(5)
    assert torch.equal(TF.dropout(x, 0.5), a)
    assert not torch.equal(a, b)
    state = trandom.get_rng_state()
    c = TF.dropout(x, 0.5)
    trandom.set_rng_state(state)
    assert torch.equal(TF.dropout(x, 0.5), c)
    assert trandom.default_generator().initial_seed() == 5


def test_dropout_does_not_touch_torch_global_rng():
    torch.manual_seed(0)
    want = torch.rand(3)
    torch.manual_seed(0)
    TF.dropout(torch.ones(100), 0.5)
    assert torch.equal(torch.rand(3), want)


def test_axis_shares_the_mask():
    """axis=1 draws one decision per index of axis 1, shared along axis 0
    (paddle's dropout with ``axis``)."""
    paddle_tpu_torch.seed(2)
    y = TF.dropout(torch.ones(6, 50), 0.5, axis=1)
    assert bool((y == y[0:1]).all())
    assert 0 < int((y[0] == 0).sum()) < 50


def test_gradient_is_mask_over_keep():
    paddle_tpu_torch.seed(4)
    x = torch.randn(100, requires_grad=True)
    y = TF.dropout(x, 0.25)
    y.sum().backward()
    want = torch.where(y != 0, 1 / 0.75, 0.0)
    torch.testing.assert_close(x.grad, want, rtol=0, atol=1e-6)


def _qkv(Sq, Sk, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, s, 3, 8).astype(np.float32) for s in (Sq, Sk, Sk)]


@pytest.mark.parametrize("case", ["no mask", "bias", "bool mask",
                                  "causal", "causal Sq < Sk",
                                  "bias causal Sq < Sk"])
def test_attention_dropout_matches_reference_formula(case, monkeypatch):
    """``scaled_dot_product_attention(dropout_p > 0, training=True)``
    equals paddle_tpu's dropout branch (``_xla_attention`` with a rate)
    fed the port's keep mask, rebuilt from the reseeded generator: f32
    logits, the mask, the causal mask aligned bottom-right at Sq < Sk,
    ``where(keep, probs / (1 - p), 0)``, the product with v."""
    Sq, Sk = (5, 9) if "Sq < Sk" in case else (7, 7)
    q, k, v = _qkv(Sq, Sk)
    rs = np.random.RandomState(1)
    causal = "causal" in case
    mask = None
    if "bias" in case:
        mask = np.where(rs.rand(2, 1, 1, Sk) < 0.2, -1e30, 0.0).astype(
            np.float32)
    elif case == "bool mask":
        mask = rs.rand(2, 1, Sq, Sk) > 0.3
        mask[..., -1] = True
    p = 0.3
    paddle_tpu_torch.seed(9)
    got = TF.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        dropout_p=p, is_causal=causal, training=True)
    paddle_tpu_torch.seed(9)
    keep = trandom.keep_mask((2, 3, Sq, Sk), p, "cpu").numpy()
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, prob, shape: jnp.asarray(keep))
    bias = mask if mask is not None and mask.dtype != bool else None
    bmask = mask if mask is not None and mask.dtype == bool else None
    want = jfa._xla_attention(
        *map(jnp.asarray, (q, k, v)),
        None if bias is None else jnp.asarray(bias),
        None if bmask is None else jnp.asarray(bmask), causal,
        1.0 / 8 ** 0.5, p, jax.random.key(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert 0 < keep.mean() < 1


def test_causal_dropout_branch_is_bottom_right_aligned():
    """At Sq < Sk, query row i of the dropout branch sees keys j <= i +
    Sk - Sq (the branch's ``tril(.., Sk - Sq)``): changing v at a later
    key leaves row i unchanged and changes the next row that sees it."""
    q, k, v = map(torch.from_numpy, _qkv(4, 10, seed=3))
    v2 = v.clone()
    v2[:, 7] += 1.0                           # key 7: rows i >= 1 see it
    outs = []
    for vv in (v, v2):
        paddle_tpu_torch.seed(1)
        outs.append(TF.flash_attention(q, k, vv, dropout=0.1,
                                       causal=True)[0])
    assert torch.equal(outs[0][:, 0], outs[1][:, 0])
    assert not torch.equal(outs[0][:, 1:], outs[1][:, 1:])


def test_flash_attention_dropout_takes_the_branch():
    """``flash_attention(dropout > 0)`` in training equals the SDPA branch
    on the same mask, and differs from the no-dropout result."""
    q, k, v = map(torch.from_numpy, _qkv(6, 6, seed=4))
    paddle_tpu_torch.seed(3)
    a = TF.flash_attention(q, k, v, dropout=0.2, causal=True)[0]
    paddle_tpu_torch.seed(3)
    b = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.2,
                                        is_causal=True)
    assert torch.equal(a, b)
    assert not torch.allclose(a, TF.flash_attention(q, k, v,
                                                    causal=True)[0])
