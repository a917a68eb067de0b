"""paddle_tpu_torch blockwise flash attention (B5, kernels/flash_block.py)
against paddle_tpu/kernels/flash_block.py.

The port's wrappers run their plain PyTorch versions on CPU tensors; they
are held against paddle_tpu's Pallas kernels run as its own tests run them
on the CPU (``interpret=True``), forward and ``jax.vjp`` backward. Inputs
are made with numpy from a seed and handed to both sides.

Tolerances: out, lse and the grads atol 1e-5 in f32 (the softmax
reassociation bound paddle_tpu's flash-kernel tests hold; values here are
O(1) and sums run over at most 256 keys); ``merge_lse_blocks`` and
``compute_delta`` atol 1e-6 (the same elementwise f32 operations and one
row sum of 64 terms); the f64 ``gradcheck`` at torch's defaults (atol
1e-5, rtol 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_block as jfb
from paddle_tpu_torch.kernels import flash_block as tfb

ATOL = 1e-5
B, H, SL, D = 1, 2, 128, 64
SCALE = 1.0 / 8.0

# (q_off, k_off, causal): chip_smoke.py's ring-step cases at SL = 128
CASES = {"diagonal": (128, 128, True), "past": (384, 0, True),
         "future": (0, 384, True), "non-causal": (128, 0, False)}


def _arrays(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.from_numpy(x.copy()) for x in xs]


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def _close_lse(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


@pytest.fixture(autouse=True)
def zero_counters():
    wrappers = (tfb.flash_block_fwd, tfb.flash_block_bwd)
    for w in wrappers:
        w.launches = w.tc_launches = w.simt_launches = 0
    yield
    # CPU tensors run the plain versions: no kernel launch is counted, on
    # either path
    assert all((w.launches, w.tc_launches, w.simt_launches) == (0, 0, 0)
               for w in wrappers)


@pytest.mark.parametrize("case", list(CASES))
def test_block_fwd_bwd_match_pallas_interpret(case):
    """(out, lse) and the grads under a loss that reads both outputs
    (nonzero lse cotangent) against ``flash_block_attention`` in interpret
    mode and its custom_vjp; the per-block backward with the folded
    ``delta`` gives the same grads."""
    q_off, k_off, causal = CASES[case]
    q, k, v, do = _arrays(list(CASES).index(case), *[(B, H, SL, D)] * 4)
    (dlse,) = _arrays(7, (B, H, SL))

    @jax.jit
    def fwd_bwd(q_, k_, v_, do_, dlse_):
        def f(a, b, c):
            return jfb.flash_block_attention(a, b, c, q_off, k_off, causal,
                                             SCALE, 64, 64, True)
        (o, lse), vjp = jax.vjp(f, q_, k_, v_)
        return (o, lse) + vjp((do_, dlse_))

    jo, jl, *jgrads = fwd_bwd(q, k, v, do, dlse)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    tdo, tdlse = _t(do, dlse)
    out, lse = tfb.flash_block_attention(tq, tk, tv, q_off, k_off, causal,
                                         SCALE)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    _close(out, jo)
    _close_lse(lse, jl)
    grads = torch.autograd.grad((out * tdo).sum() + torch.where(
        lse.isfinite(), lse * tdlse, 0.0).sum(), (tq, tk, tv))
    for got, want in zip(grads, jgrads):
        _close(got, want)
    delta = tfb.compute_delta(out, tdo, tdlse)
    for got, want in zip(tfb.flash_block_attention_bwd(
            tq, tk, tv, q_off, k_off, out, lse, tdo, causal, SCALE,
            delta=delta), jgrads):
        _close(got, want)
    if case == "future":
        assert torch.all(out == 0) and torch.all(lse == float("-inf"))
        assert all(torch.all(g == 0) for g in grads)


def test_block_bwd_against_global_residuals_matches_pallas():
    """The ring's use: one q shard (global rows 128..255 of S = 256)
    against each k/v block, backward against the GLOBAL (out, lse) of the
    full attention and one hoisted ``delta``, held against paddle_tpu's
    ``flash_block_attention_bwd``; summed over blocks, dq is the full
    attention's."""
    S = 2 * SL
    q, k, v, do = _arrays(21, *[(B, H, S, D)] * 4)
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = tfb.flash_attention_lse(tq, tk, tv, causal=True,
                                       sm_scale=SCALE)
    full = tfb.flash_block_attention_bwd(tq, tk, tv, 0, 0, out, lse, tdo,
                                         True, SCALE)
    rows = slice(SL, S)
    qs, os_, dos, ls = (x[:, :, rows].contiguous()
                        for x in (tq, out, tdo, lse))
    delta = tfb.compute_delta(os_, dos)

    @jax.jit
    def jbwd(q_, k_, v_, o_, l_, do_, dl_, k_off):
        return jfb.flash_block_attention_bwd(
            q_, k_, v_, SL, k_off, o_, l_, do_, True, SCALE, 64, 64, True,
            delta=dl_)

    dq = torch.zeros_like(qs)
    for j in range(S // SL):
        kj, vj = (x[:, :, j * SL:(j + 1) * SL].contiguous() for x in (tk, tv))
        got = tfb.flash_block_attention_bwd(qs, kj, vj, SL, j * SL, None, ls,
                                            dos, True, SCALE, delta=delta)
        want = jbwd(*(x.numpy() for x in (qs, kj, vj, os_, ls, dos, delta)),
                    j * SL)
        for g, w in zip(got, want):
            _close(g, w)
        dq += got[0]
    _close(dq, full[0][:, :, rows].numpy())


def test_merge_and_delta_match_paddle_tpu():
    """``merge_lse_blocks`` (with rows where one side is the (0, -inf)
    identity or both are) and ``compute_delta`` with and without a lse
    cotangent."""
    oa, ob, do = _arrays(3, *[(B, H, 16, 8)] * 3)
    la, lb, dlse = _arrays(4, *[(B, H, 16)] * 3)
    la[..., :3] = -np.inf
    oa[..., :3, :] = 0.0
    lb[..., 2:5] = -np.inf
    ob[..., 2:5, :] = 0.0
    got_o, got_l = tfb.merge_lse_blocks(*_t(oa, la, ob, lb))
    want_o, want_l = jfb.merge_lse_blocks(oa, la, ob, lb)
    _close(got_o, want_o, 1e-6)
    _close_lse(got_l, want_l)
    assert torch.all(got_l[..., 2] == float("-inf"))
    assert torch.all(got_o[..., 2, :] == 0)
    np.testing.assert_array_equal(got_o[..., :2, :].numpy(), ob[..., :2, :])
    # the identity on the left leaves the right side as it is
    zero, ninf = np.zeros_like(oa), np.full_like(la, -np.inf)
    o_id, l_id = tfb.merge_lse_blocks(*_t(zero, ninf, ob, lb))
    np.testing.assert_array_equal(o_id.numpy(), ob)
    np.testing.assert_array_equal(l_id.numpy(), lb)
    for extra in ((), (dlse,)):
        _close(tfb.compute_delta(*_t(oa, do, *extra)),
               jfb.compute_delta(oa, do, *extra), 1e-6)


@pytest.mark.parametrize("q_off,k_off,causal", [(3, 0, True), (0, 5, True),
                                                (2, 2, False)])
def test_block_attention_gradcheck_f64(q_off, k_off, causal):
    """The autograd Function's backward (B5's plain backward with the lse
    cotangent folded into delta) is the gradient of its forward through
    both outputs, fully masked rows included (f64 gradcheck)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, n, 4, dtype=torch.float64, generator=g,
                           requires_grad=True) for n in (6, 7, 7))
    w = torch.randn(1, 2, 6, dtype=torch.float64, generator=g)

    def f(q_, k_, v_):
        out, lse = tfb.flash_block_attention(q_, k_, v_, q_off, k_off,
                                             causal, 0.5)
        return out, torch.where(lse.isfinite(), lse * w, 0.0)

    assert torch.autograd.gradcheck(f, (q, k, v))


def test_bf16_block_keeps_dtypes():
    """bf16 in: out and the grads at bf16, lse f32 (as the kernel)."""
    q, k, v = (t.to(torch.bfloat16).requires_grad_()
               for t in _t(*_arrays(5, *[(1, 2, 32, 16)] * 3)))
    out, lse = tfb.flash_block_attention(q, k, v, 32, 0, True, 0.25)
    assert (out.dtype, lse.dtype) == (torch.bfloat16, torch.float32)
    dq, dk, dv = torch.autograd.grad(out.float().sum() + lse.sum(),
                                     (q, k, v))
    assert {dq.dtype, dk.dtype, dv.dtype} == {torch.bfloat16}
    want, _ = tfb.flash_block_fwd_plain(q.float(), k.float(), v.float(), 32,
                                        0, True, 0.25)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               want.detach().numpy(), rtol=2.0 ** -8,
                               atol=2.0 ** -8)


@pytest.mark.parametrize("D", [64, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_block_plain_is_b1s_at_its_offsets(case, D):
    """B5's bf16 plain versions are B1's at the block's offsets, bit for
    bit, on the tensor-core path (D 64) and the SIMT one (D 32) alike: the
    f32-product results (inputs widened) cast to bf16."""
    q_off, k_off, causal = CASES[case]
    q, k, v, do = (t.to(torch.bfloat16) for t in _t(*_arrays(
        11 + D, *[(B, H, SL, D)] * 4)))
    out, lse = tfb.flash_block_fwd_plain(q, k, v, q_off, k_off, causal,
                                         SCALE)
    want, want_lse = tfb._fa.flash_attn_fwd_plain(q, k, v, causal, SCALE,
                                                  q_off, k_off)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    wide, wide_lse = tfb.flash_block_fwd_plain(q.float(), k.float(),
                                               v.float(), q_off, k_off,
                                               causal, SCALE)
    assert torch.equal(out, wide.bfloat16()) and torch.equal(lse, wide_lse)
    delta = tfb.compute_delta(out, do)
    grads = tfb.flash_block_bwd_plain(q, k, v, q_off, k_off, lse, do, delta,
                                      causal, SCALE)
    wide_g = tfb.flash_block_bwd_plain(q.float(), k.float(), v.float(),
                                       q_off, k_off, lse, do.float(), delta,
                                       causal, SCALE)
    for g, w in zip(grads, wide_g):
        assert torch.equal(g, w.bfloat16())


def _close_bf16(got, want):
    """One bf16 step of each entry (2^-7 of its size), and of a typical
    entry (the median |want|) for entries whose f32 sums cancel to near 0:
    each side rounds its own f32 result to bf16."""
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    atol = 2.0 ** -7 * float(np.median(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=atol)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_block_matches_pallas_interpret(case):
    """bf16 inputs: ``flash_block_attention`` on CPU tensors (B5's plain
    versions) against paddle_tpu's ``flash_block_attention`` in interpret
    mode, whose kernels widen q, k and v to f32: (out, lse) and the grads
    under a loss that reads both outputs."""
    q_off, k_off, causal = CASES[case]
    q, k, v, do = (jnp.asarray(x).astype(jnp.bfloat16) for x in _arrays(
        31 + list(CASES).index(case), *[(B, H, SL, D)] * 4))
    (dlse,) = _arrays(8, (B, H, SL))

    @jax.jit
    def fwd_bwd(q_, k_, v_, do_, dlse_):
        def f(a, b, c):
            return jfb.flash_block_attention(a, b, c, q_off, k_off, causal,
                                             SCALE, 64, 64, True)
        (o, lse), vjp = jax.vjp(f, q_, k_, v_)
        return (o, lse) + vjp((do_, dlse_))

    jo, jl, *jgrads = fwd_bwd(q, k, v, do, dlse)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32))
                  .to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    tdo = torch.from_numpy(np.asarray(do, np.float32)).to(torch.bfloat16)
    (tdlse,) = _t(dlse)
    out, lse = tfb.flash_block_attention(tq, tk, tv, q_off, k_off, causal,
                                         SCALE)
    assert jo.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    _close_bf16(out, jo)
    _close_lse(lse, jl)
    grads = torch.autograd.grad((out.float() * tdo.float()).sum() +
                                torch.where(lse.isfinite(), lse * tdlse,
                                            0.0).sum(), (tq, tk, tv))
    for got, want in zip(grads, jgrads):
        assert got.dtype == torch.bfloat16
        _close_bf16(got, want)
