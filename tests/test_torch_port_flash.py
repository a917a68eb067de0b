"""paddle_tpu_torch flash attention (B1) against paddle_tpu.

The port's kernel wrappers run their plain PyTorch versions on CPU
tensors; they are held against paddle_tpu's blockwise Pallas kernel run
as its own tests run it on the CPU (``flash_attention_lse`` /
``flash_block_attention`` with ``interpret=True``, forward and
``jax.vjp`` backward) and against ``_xla_attention``, the path paddle_tpu's
``flash_attention`` takes off the TPU. Inputs are made with numpy from a
seed and handed to both sides.

Tolerances: out, lse and the grads atol 1e-5 in f32 (the softmax
reassociation bound tests/test_kernels.py holds paddle_tpu's flash
kernels to; values here are O(1)); the f64 ``gradcheck`` of the plain
backward at torch's defaults (atol 1e-5, rtol 1e-3).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels.flash_block import (flash_attention_lse,
                                            flash_block_attention)
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.nn import functional as TF

# the package re-exports a flash_attention function under the module's name
jfa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")

ATOL = 1e-5


def _qkv(B=2, H=2, Sq=128, Sk=None, D=64, seed=0):
    rs = np.random.RandomState(seed)
    Sk = Sq if Sk is None else Sk
    return (rs.randn(B, H, Sq, D).astype(np.float32),
            rs.randn(B, H, Sk, D).astype(np.float32),
            rs.randn(B, H, Sk, D).astype(np.float32),
            rs.randn(B, H, Sq, D).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x.copy()) for x in xs]


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_fwd_bwd_match_pallas_interpret(S, causal):
    """Forward (out, lse) and backward (dq, dk, dv) of the plain versions
    against the Pallas kernel in interpret mode and its custom_vjp."""
    q, k, v, do = _qkv(Sq=S, seed=S + causal)
    scale = 1.0 / 8.0

    def f(q_, k_, v_):
        return flash_attention_lse(q_, k_, v_, causal=causal,
                                   sm_scale=scale, interpret=True)

    @jax.jit
    def fwd_bwd(q_, k_, v_, do_):
        (o, lse), vjp = jax.vjp(f, q_, k_, v_)
        return (o, lse) + vjp((do_, jnp.zeros_like(lse)))

    jo, jl, jdq, jdk, jdv = fwd_bwd(q, k, v, do)
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = tfa.flash_attn_fwd(tq, tk, tv, causal, scale)
    _close(out, jo)
    _close(lse, jl)
    dq, dk, dv = tfa.flash_attn_bwd(tq, tk, tv, out, lse, tdo, causal, scale)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(got, want)
    # and the out of paddle_tpu's CPU dispatch (XLA attention, [B,S,H,D])
    sw = lambda x: np.swapaxes(x, 1, 2)
    xo = jfa._xla_attention(jnp.asarray(sw(q)), jnp.asarray(sw(k)),
                            jnp.asarray(sw(v)), None, None, causal, scale)
    _close(out, sw(np.asarray(xo)))


def test_offsets_and_fully_masked_rows_match_flash_block():
    """q at global position 0, k at 64: with causal masking query rows
    0..63 see no key (out 0, lse -inf, zero grads), the rest see a
    prefix; Sq != Sk exercises the masked tails."""
    q, k, v, do = _qkv(Sq=128, Sk=192, seed=11)
    scale = 0.125
    q_off, k_off = 0, 64

    @jax.jit
    def fwd_bwd(q_, k_, v_, do_):
        def f(a, b, c):
            return flash_block_attention(a, b, c, q_off, k_off, True, scale,
                                         64, 64, True)
        (o, lse), vjp = jax.vjp(f, q_, k_, v_)
        return (o, lse) + vjp((do_, jnp.zeros_like(lse)))

    jo, jl, jdq, jdk, jdv = fwd_bwd(q, k, v, do)
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = tfa.flash_attn_fwd(tq, tk, tv, True, scale, q_off, k_off)
    assert torch.all(lse[:, :, :64] == float("-inf"))
    assert torch.all(out[:, :, :64] == 0)
    _close(out, jo)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()),
                                  np.isneginf(np.asarray(jl)))
    fin = np.isfinite(np.asarray(jl))
    _close(lse.numpy()[fin], np.asarray(jl)[fin])
    dq, dk, dv = tfa.flash_attn_bwd(tq, tk, tv, out, lse, tdo, True, scale,
                                    q_off, k_off)
    assert torch.all(dq[:, :, :64] == 0)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(got, want)


@pytest.mark.parametrize("causal,q_off,k_off", [(True, 0, 0), (False, 0, 0),
                                                (True, 3, 5)])
def test_plain_bwd_gradcheck_f64(causal, q_off, k_off):
    """The plain backward is the gradient of the plain forward (f64,
    torch.autograd.gradcheck), offsets and fully-masked rows included."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, n, 4, dtype=torch.float64, generator=g,
                           requires_grad=True) for n in (6, 7, 7))

    class Attn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q_, k_, v_):
            o, lse = tfa.flash_attn_fwd_plain(q_, k_, v_, causal, 0.5,
                                              q_off, k_off)
            ctx.save_for_backward(q_, k_, v_, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            return tfa.flash_attn_bwd_plain(*ctx.saved_tensors, do, causal,
                                            0.5, q_off, k_off)

    assert torch.autograd.gradcheck(Attn.apply, (q, k, v))


def _paddle_grads(fn, arrays, dout):
    """Output and input grads of a paddle_tpu functional through its eager
    tape: ``sum(fn(*tensors) * dout)``.backward()."""
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts)
    (out * paddle.to_tensor(dout)).sum().backward()
    return np.asarray(out.numpy()), [np.asarray(t.grad.numpy()) for t in ts]


@pytest.mark.parametrize("api", ["flash_attention", "sdpa"])
@pytest.mark.parametrize("causal", [True, False])
def test_functionals_match_paddle_tpu(api, causal):
    """``F.flash_attention`` / ``F.scaled_dot_product_attention`` on
    paddle's [B, S, H, D] layout, forward and grads, against paddle_tpu's
    functionals; the port's CPU path launches no kernel."""
    rs = np.random.RandomState(3)
    q, k, v, do = (rs.randn(2, 128, 2, 64).astype(np.float32)
                   for _ in range(4))
    if api == "flash_attention":
        jfn = lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal)[0]
        tfn = lambda a, b, c: TF.flash_attention(a, b, c, causal=causal)[0]
    else:
        jfn = lambda a, b, c: jfa.scaled_dot_product_attention(
            a, b, c, is_causal=causal)
        tfn = lambda a, b, c: TF.scaled_dot_product_attention(
            a, b, c, is_causal=causal)
    want, wgrads = _paddle_grads(jfn, (q, k, v), do)
    tfa.flash_attn_fwd.launches = tfa.flash_attn_bwd.launches = 0
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = tfn(*ts)
    (out * torch.from_numpy(do)).sum().backward()
    _close(out, want)
    for t, w in zip(ts, wgrads):
        _close(t.grad, w)
    assert tfa.flash_attn_fwd.launches == tfa.flash_attn_bwd.launches == 0


@pytest.mark.parametrize("case", ["bool", "bool causal", "bias",
                                  "bias causal", "fully masked row",
                                  "Sq < Sk"])
def test_sdpa_with_mask_matches_paddle_tpu(case):
    """An explicit bool keep-mask or additive f32 bias, with and without
    is_causal (plain tensor code on both sides). A fully masked row
    attends evenly over every key in both packages; Sq < Sk takes the
    causal mask from the top-left corner in both."""
    rs = np.random.RandomState(4)
    Sq, Sk = (8, 16) if case == "Sq < Sk" else (16, 16)
    q = rs.randn(2, Sq, 2, 8).astype(np.float32)
    k, v = (rs.randn(2, Sk, 2, 8).astype(np.float32) for _ in range(2))
    if case.startswith("bias"):
        mask = rs.randn(2, 2, Sq, Sk).astype(np.float32)
    else:
        mask = rs.rand(2, 1, Sq, Sk) > 0.3
        mask[..., 0] = True                      # every row keeps a key
        if case == "fully masked row":
            mask[1, 0, 5] = False
    causal = case.endswith("causal") or case == "Sq < Sk"
    want = jfa.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=paddle.to_tensor(mask), is_causal=causal)
    got = TF.scaled_dot_product_attention(*_t(q, k, v),
                                          attn_mask=torch.from_numpy(mask),
                                          is_causal=causal)
    _close(got, np.asarray(want.numpy()))


# ---------------------------------------------------------------- precision
# Both kernel paths take every product as an f32 product of the inputs; the
# plain versions are the f32 formula on the widened inputs, the result cast
# to the inputs' dtype, for f32 and bf16 alike.

def _formula_fwd(q, k, v, causal, scale, q_off, k_off):
    """The rounding-free forward, written out: f32 scores, softmax, p V."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(q.shape[2])[:, None] + q_off
        ki = torch.arange(k.shape[2])[None, :] + k_off
        s = torch.where(qi >= ki, s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == float("-inf"), 0.0, m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p, v) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l == 0, float("-inf"), m + torch.log(l))[..., 0]
    return out, lse, s


def _formula_bwd(q, k, v, out, lse, do, s, scale):
    lse = torch.where(lse == float("-inf"), 0.0, lse)
    p = torch.exp(s - lse[..., None])
    delta = (do * out).sum(-1)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv)


@pytest.mark.parametrize("causal,q_off,k_off", [(True, 0, 0), (False, 0, 0),
                                                (True, 128, 0), (True, 0, 64)])
def test_f32_plain_versions_round_nothing(causal, q_off, k_off):
    """f32 inputs: the plain forward and backward equal the rounding-free
    formula bit for bit."""
    q, k, v, do = _t(*_qkv(B=1, H=2, Sq=256, seed=21))
    scale = 0.125
    out, lse = tfa.flash_attn_fwd_plain(q, k, v, causal, scale, q_off, k_off)
    f_out, f_lse, s = _formula_fwd(q, k, v, causal, scale, q_off, k_off)
    assert torch.equal(out, f_out) and torch.equal(lse, f_lse)
    got = tfa.flash_attn_bwd_plain(q, k, v, out, lse, do, causal, scale,
                                   q_off, k_off)
    for g, w in zip(got, _formula_bwd(q, k, v, out, lse, do, s, scale)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("causal,q_off,k_off", [(True, 0, 0), (False, 0, 0),
                                                (True, 128, 0), (True, 0, 64)])
def test_bf16_plain_versions_are_the_f32_products_cast(causal, q_off, k_off):
    """bf16 inputs (B 1, H 2, S 256, D 64): the plain forward and backward
    equal the rounding-free formula on the widened inputs, cast to bf16,
    bit for bit (the backward from the bf16 out, as the kernel's)."""
    q, k, v, do = (t.to(torch.bfloat16)
                   for t in _t(*_qkv(B=1, H=2, Sq=256, seed=41 + q_off)))
    scale = 0.125
    out, lse = tfa.flash_attn_fwd_plain(q, k, v, causal, scale, q_off, k_off)
    wide = [t.float() for t in (q, k, v)]
    f_out, f_lse, s = _formula_fwd(*wide, causal, scale, q_off, k_off)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, f_out.bfloat16()) and torch.equal(lse, f_lse)
    got = tfa.flash_attn_bwd_plain(q, k, v, out, lse, do, causal, scale,
                                   q_off, k_off)
    want = _formula_bwd(*wide, out.float(), lse, do.float(), s, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w.bfloat16())


def _close_bf16(got, want):
    """One bf16 step of each entry (2^-7 of its size), and of a typical
    entry (the median |want|) for entries whose f32 sums cancel to near 0:
    each side rounds its own f32 result to bf16."""
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    atol = 2.0 ** -7 * float(np.median(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=atol)


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_plain_matches_pallas_interpret(S, causal):
    """bf16 inputs: the wrappers on CPU tensors (the plain versions, f32
    products) against paddle_tpu's blockwise Pallas kernel in interpret
    mode, which widens q, k and v to f32, forward and backward."""
    q, k, v, do = (x.astype(jnp.bfloat16)
                   for x in map(jnp.asarray, _qkv(B=1, Sq=S, seed=7 + S)))
    scale = 1.0 / 8.0

    def f(q_, k_, v_):
        return flash_attention_lse(q_, k_, v_, causal=causal,
                                   sm_scale=scale, interpret=True)

    @jax.jit
    def fwd_bwd(q_, k_, v_, do_):
        (o, lse), vjp = jax.vjp(f, q_, k_, v_)
        return (o, lse) + vjp((do_, jnp.zeros_like(lse)))

    jo, jl, *jgrads = fwd_bwd(q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(np.asarray(x, np.float32))
                       .to(torch.bfloat16) for x in (q, k, v, do))
    out, lse = tfa.flash_attn_fwd(tq, tk, tv, causal, scale)
    assert jo.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    _close_bf16(out, jo)
    _close(lse, jl)
    grads = tfa.flash_attn_bwd(tq, tk, tv, out, lse, tdo, causal, scale)
    for got, want in zip(grads, jgrads):
        assert got.dtype == torch.bfloat16
        _close_bf16(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_tc_path_rule(dtype, D):
    """The wrappers' path table: bf16 at D 64 or 128 (wgmma) and f32 at D
    64 (3xTF32) on the tensor-core kernels, everything else on the SIMT
    ones; on CPU tensors neither counts a launch."""
    assert tfa._tc_path(dtype, D) == (
        (dtype == torch.bfloat16 and D in (64, 128))
        or (dtype == torch.float32 and D == 64))
    q, k, v, do = (t.to(dtype) for t in _t(*_qkv(B=1, H=1, Sq=16, D=D)))
    for w in (tfa.flash_attn_fwd, tfa.flash_attn_bwd):
        w.launches = w.tc_launches = w.simt_launches = 0
    out, lse = tfa.flash_attn_fwd(q, k, v, True, 0.125)
    tfa.flash_attn_bwd(q, k, v, out, lse, do, True, 0.125)
    assert all((w.launches, w.tc_launches, w.simt_launches) == (0, 0, 0)
               for w in (tfa.flash_attn_fwd, tfa.flash_attn_bwd))
