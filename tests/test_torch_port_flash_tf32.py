"""The precision design of the f32 tensor-core flash kernels (3xTF32),
emulated on the CPU.

``paddle_tpu_torch/kernels/csrc/flash_attention_sm90_f32.cu`` takes every
product of f32 inputs as three TF32 products on the tensor cores: each
operand x is split into ``big = cvt.rna.tf32.f32(x)`` and ``small =
cvt.rna.tf32.f32(x - big)`` (0 where big is not finite), and a product is
``small.big + big.small + big.big``. This file emulates that arithmetic
with numpy on int32 bit patterns (TF32 rounding: to nearest, ties away
from zero, at bit 13) and shows:

(a) big + small reconstructs x within 2^-22 |x| for |x| >= 2^-114, up to
    the largest x that does not round to inf; +-0 exactly; below 2^-114
    (normal or subnormal), within half a TF32 subnormal step (2^-137: TF32
    keeps f32's exponent range, so its subnormals step by 2^-136, and the
    small part of such an x is one); and small is 0 where x is inf or NaN;
(b) attention forward and backward with every product so taken holds
    chip_smoke.py's limits (LIM_F32, LIM_LSE, by the same element-by-element
    rule) against paddle_tpu's blockwise Pallas kernel in interpret mode,
    causal and full, with offsets;
(c) one TF32 product (big.big alone) does not hold LIM_F32: the reason for
    three;
(d) the kernels' fragment layouts: P and dS become mma.sync m16n8k8 A
    operands straight from the accumulator (``acc_a``) against B rows read
    in the matching order (``load_b_perm``), and Q K^T takes ``load_a`` and
    ``load_b_rows``; the emulated products equal the matrix products, and
    B rows in plain order do not.

The emulation sums products in f64: what it tests is the representation,
not the tensor cores' own rounding of sums (chip_smoke.py holds the kernels
themselves to the same limits on the card). The plain versions stay the
f32 formula.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_block import flash_block_attention
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as tfa

# chip_smoke.py's limits (rtol, atol as a fraction of a typical |entry|)
LIM_LSE = (1e-6, 1e-6)
LIM_F32 = (1e-5, 5e-5)
B, H, S, D = 1, 2, 128, 64
SCALE = 1.0 / 8.0


# ------------------------------------------------------- TF32 emulation

def tf32_rna(x):
    """cvt.rna.tf32.f32 on f32 values: round the 13 low mantissa bits to
    nearest, ties away from zero (on the magnitude), on the bit pattern;
    inf and NaN pass unchanged, a carry past the largest TF32 gives inf."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32)
    mag = bits & np.uint32(0x7FFFFFFF)
    sign = bits & np.uint32(0x80000000)
    rounded = (mag + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    finite = mag < np.uint32(0x7F800000)
    out = np.where(finite, sign | rounded, bits).astype(np.uint32)
    return out.view(np.float32)


def split(x):
    """(big, small) as the kernels split an operand."""
    x = np.asarray(x, np.float32)
    big = tf32_rna(x)
    with np.errstate(invalid="ignore"):
        r = (x - big).astype(np.float32)          # exact where big is finite
    small = np.where(np.abs(r) < np.inf, tf32_rna(r), np.float32(0.0))
    return big, small.astype(np.float32)


def mm(a, b, terms=3):
    """a @ b with every product taken as the kernels take it: three TF32
    products (terms=3), or big.big alone (terms=1); summed in f64,
    rounded to f32."""
    ab, as_ = (t.astype(np.float64) for t in split(a))
    bb, bs = (t.astype(np.float64) for t in split(b))
    out = ab @ bb
    if terms == 3:
        out = out + as_ @ bb + ab @ bs
    return out.astype(np.float32)


def emulated_attention(q, k, v, do, causal, q_off, k_off, terms=3):
    """The kernels' forward (out, lse) and backward at the forward's own
    residuals (dq, dk, dv), every product through ``mm``, the rest in f32
    (delta in f64, as the dQ pass sums it)."""
    kt = np.swapaxes(k, -1, -2)
    s = mm(q, kt, terms) * np.float32(SCALE)
    if causal:
        qi = np.arange(q.shape[-2])[:, None] + q_off
        ki = np.arange(k.shape[-2])[None, :] + k_off
        s = np.where(qi >= ki, s, -np.inf).astype(np.float32)
    m = s.max(-1, keepdims=True)
    m_safe = np.where(m == -np.inf, 0, m).astype(np.float32)
    p = np.exp(s - m_safe).astype(np.float32)
    l = p.sum(-1, keepdims=True, dtype=np.float32)
    out = (mm(p, v, terms) / np.where(l == 0, 1, l)).astype(np.float32)
    lse = np.where(l == 0, -np.inf,
                   m_safe + np.log(np.where(l == 0, 1, l)))[..., 0]
    lse = lse.astype(np.float32)
    delta = (do.astype(np.float64) * out).sum(-1).astype(np.float32)
    lse_safe = np.where(lse == -np.inf, np.inf, lse)[..., None]
    p = np.exp(s - lse_safe).astype(np.float32)
    dv = mm(np.swapaxes(p, -1, -2), do, terms)
    dp = mm(do, np.swapaxes(v, -1, -2), terms)
    ds = (p * (dp - delta[..., None]) * np.float32(SCALE)).astype(np.float32)
    dq = mm(ds, k, terms)
    dk = mm(np.swapaxes(ds, -1, -2), q, terms)
    return out, lse, dq, dk, dv


def worst_over_limit(got, want, rtol, atol_frac):
    """chip_smoke.py's close(): the worst |got - want| / (rtol |want| +
    atol_frac * typical), typical the median nonzero |want|, over the
    entries where want is finite (the others must be equal)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[~fin], want[~fin])
    a = np.abs(np.where(fin, want, 0))
    nz = a[a > 0]
    typical = np.median(nz) if nz.size else 0.0
    with np.errstate(invalid="ignore"):             # -inf - -inf, masked
        err = np.abs(np.where(fin, got - want, 0))
    return float((err / (rtol * a + atol_frac * typical)).max())


# ----------------------------------------------------------- (a) the split

def test_split_reconstructs_x_within_2_pow_minus_22():
    rs = np.random.RandomState(0)
    mant = rs.uniform(1.0, 2.0, 20000)
    expo = rs.randint(-126, 128, 20000)
    x = (np.sign(rs.randn(20000)) * np.ldexp(mant, expo)).astype(np.float32)
    # the largest f32 that stays finite after TF32 rounding, and its
    # neighbours below; and the mantissa patterns at the rounding tie
    edge = np.float32(np.ldexp(2.0 - 2.0 ** -11, 127))
    x = np.concatenate([x, [np.nextafter(edge, np.float32(0)),
                            np.float32(3e38), np.float32(1.0 + 2 ** -11),
                            np.float32(1.0 + 3 * 2 ** -12), np.float32(-1.5)]
                        ]).astype(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) >= 2.0 ** -114)]
    big, small = split(x)
    assert np.all(np.isfinite(big)) and np.all(np.isfinite(small))
    # both parts are TF32 values: the 13 low bits are zero
    assert not np.any(big.view(np.uint32) & 0x1FFF)
    assert not np.any(small.view(np.uint32) & 0x1FFF)
    err = np.abs(x.astype(np.float64) - big - small)
    assert np.all(err <= 2.0 ** -22 * np.abs(x.astype(np.float64)))
    # big alone is only within 2^-11: the small part carries the rest
    assert np.max(np.abs(x.astype(np.float64) - big) /
                  np.abs(x.astype(np.float64))) > 2.0 ** -13


def test_split_zeros_subnormals_inf_nan():
    z = np.array([0.0, -0.0], np.float32)
    big, small = split(z)
    assert np.array_equal(big.view(np.uint32), z.view(np.uint32))
    assert not np.any(small)
    rs = np.random.RandomState(4)
    tiny = (np.sign(rs.randn(5000)) * np.ldexp(rs.uniform(1, 2, 5000),
                                               rs.randint(-149, -114, 5000)))
    sub = np.concatenate([[2.0 ** -149, -3 * 2.0 ** -149, 2.0 ** -130,
                           2.0 ** -127, -1.17e-38], tiny]).astype(np.float32)
    big, small = split(sub)
    err = np.abs(sub.astype(np.float64) - big - small)
    assert np.all(err <= 2.0 ** -137)
    special = np.array([np.inf, -np.inf, np.nan], np.float32)
    big, small = split(special)
    assert not np.any(small)
    assert big[0] == np.inf and big[1] == -np.inf and np.isnan(big[2])
    # a finite x that rounds past the largest TF32 also gets small 0
    big, small = split(np.array([np.finfo(np.float32).max], np.float32))
    assert big[0] == np.inf and small[0] == 0


def test_three_term_product_is_within_2_pow_minus_21():
    rs = np.random.RandomState(1)
    a = rs.randn(64, 64).astype(np.float32)
    b = rs.randn(64, 64).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    bound = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))
    err3 = np.abs(mm(a, b) - exact)
    err1 = np.abs(mm(a, b, terms=1) - exact)
    # the f32 rounding of the result, plus 2^-21 of the sum of |terms|
    assert np.all(err3 <= 2.0 ** -24 * np.abs(exact) + 2.0 ** -21 * bound)
    assert err1.max() > 100 * err3.max()


# ------------------------------------------- (b), (c) attention vs Pallas

def _inputs(seed, Sq=S, Sk=S):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, Sq, D).astype(np.float32),
            rs.randn(B, H, Sk, D).astype(np.float32),
            rs.randn(B, H, Sk, D).astype(np.float32),
            rs.randn(B, H, Sq, D).astype(np.float32))


def _pallas(q, k, v, do, causal, q_off, k_off):
    @jax.jit
    def fwd_bwd(q_, k_, v_, do_):
        def f(a, b, c):
            return flash_block_attention(a, b, c, q_off, k_off, causal,
                                         SCALE, 64, 64, True)
        (o, lse), vjp = jax.vjp(f, q_, k_, v_)
        return (o, lse) + vjp((do_, jnp.zeros_like(lse)))
    return [np.asarray(x) for x in fwd_bwd(q, k, v, do)]


# (causal, q_off, k_off): full, causal, and causal with the keys at global
# position 64 (query rows 0..63 see no key: out 0, lse -inf, zero grads)
CASES = [(True, 0, 0), (False, 0, 0), (True, 0, 64)]


@pytest.mark.parametrize("causal,q_off,k_off", CASES)
def test_three_tf32_products_hold_lim_f32_against_pallas(causal, q_off,
                                                         k_off):
    q, k, v, do = _inputs(10 + k_off + causal, Sk=S + k_off)
    want = _pallas(q, k, v, do, causal, q_off, k_off)
    got = emulated_attention(q, k, v, do, causal, q_off, k_off)
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        lim = LIM_LSE if name == "lse" else LIM_F32
        assert worst_over_limit(g, w, *lim) <= 1.0, name
    if k_off:
        assert np.all(got[1][..., :k_off] == -np.inf)
        assert not np.any(got[0][..., :k_off, :])
        assert not np.any(got[2][..., :k_off, :])


def test_one_tf32_product_misses_lim_f32():
    q, k, v, do = _inputs(11)
    want = _pallas(q, k, v, do, True, 0, 0)
    got = emulated_attention(q, k, v, do, True, 0, 0, terms=1)
    worst = {name: worst_over_limit(g, w, *LIM_F32)
             for name, g, w in zip(("out", "dq", "dk", "dv"),
                                   (got[0],) + got[2:],
                                   (want[0],) + tuple(want[2:]))}
    assert min(worst.values()) > 1.0, worst


# -------------------------------------------- (d) the fragment layouts

def _mma_m16n8k8(a_frags, b_frags):
    """mma.sync.m16n8k8 .tf32 on per-lane fragments: lane (g = lane / 4,
    t = lane % 4) holds A at (g, t), (g + 8, t), (g, t + 4), (g + 8,
    t + 4) and B at (k = t, n = g), (k = t + 4, n = g); returns C per lane
    at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)."""
    A = np.zeros((16, 8))
    Bm = np.zeros((8, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_frags[lane]
        Bm[t, g], Bm[t + 4, g] = b_frags[lane]
    C = A @ Bm
    return [(C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
             C[g + 8, 2 * t + 1])
            for g, t in ((lane // 4, lane % 4) for lane in range(32))]


def _gather(c):
    out = np.zeros((16, 8))
    for lane, (c0, c1, c2, c3) in enumerate(c):
        g, t = lane // 4, lane % 4
        out[g, 2 * t], out[g, 2 * t + 1] = c0, c1
        out[g + 8, 2 * t], out[g + 8, 2 * t + 1] = c2, c3
    return out


def test_accumulator_as_a_operand_with_permuted_b_rows():
    rs = np.random.RandomState(2)
    P = rs.rand(16, 8)                 # 16 rows x 8 keys, as a C block
    V = rs.randn(8, 8)                 # 8 keys x 8 columns of D
    c = [(P[lane // 4, 2 * (lane % 4)], P[lane // 4, 2 * (lane % 4) + 1],
          P[lane // 4 + 8, 2 * (lane % 4)],
          P[lane // 4 + 8, 2 * (lane % 4) + 1]) for lane in range(32)]
    a = [(c0, c2, c1, c3) for c0, c1, c2, c3 in c]             # acc_a
    perm = [(V[2 * (lane % 4), lane // 4], V[2 * (lane % 4) + 1, lane // 4])
            for lane in range(32)]                             # load_b_perm
    np.testing.assert_allclose(_gather(_mma_m16n8k8(a, perm)), P @ V,
                               rtol=1e-12, atol=1e-12)
    plain = [(V[lane % 4, lane // 4], V[lane % 4 + 4, lane // 4])
             for lane in range(32)]
    wrong = _gather(_mma_m16n8k8(a, plain))
    assert np.abs(wrong - P @ V).max() > 0.1 * np.abs(P @ V).max()


def test_rows_as_a_and_b_operands():
    rs = np.random.RandomState(3)
    X = rs.randn(16, 8)                # 16 query rows x 8 columns of D
    Y = rs.randn(8, 8)                 # 8 key rows x the same 8 columns
    a = [(X[lane // 4, lane % 4], X[lane // 4 + 8, lane % 4],
          X[lane // 4, lane % 4 + 4], X[lane // 4 + 8, lane % 4 + 4])
         for lane in range(32)]                                # load_a
    b = [(Y[lane // 4, lane % 4], Y[lane // 4, lane % 4 + 4])
         for lane in range(32)]                                # load_b_rows
    np.testing.assert_allclose(_gather(_mma_m16n8k8(a, b)), X @ Y.T,
                               rtol=1e-12, atol=1e-12)


# ----------------------------------------------- routing and C entries

@pytest.mark.parametrize("dtype,D_,lib,suffix", [
    (torch.bfloat16, 64, "flash_attention_sm90", "_tc_launch"),
    (torch.bfloat16, 128, "flash_attention_sm90", "_tc_launch"),
    (torch.float32, 64, "flash_attention_sm90_f32", "_tf32_launch"),
    (torch.float32, 128, "flash_attention", "_launch"),
    (torch.bfloat16, 96, "flash_attention", "_launch")])
def test_entry_takes_the_library_of_the_path(monkeypatch, dtype, D_, lib,
                                             suffix):
    loaded = []

    class Lib:
        def __getattr__(self, name):
            return name

    def fake_load(name, signatures):
        loaded.append((name, signatures))
        return Lib()
    monkeypatch.setattr(_build, "load", fake_load)
    tc = tfa._tc_path(dtype, D_)
    for name in ("flash_fwd", "flash_bwd", "flash_block_bwd"):
        assert tfa._entry(tc, dtype, name) == name + suffix
        assert name + suffix in loaded[-1][1]
    assert {n for n, _ in loaded} == {lib}


def _c_entries(source):
    """{name: parameter count} of the extern "C" functions of a source."""
    text = (Path(_build.__file__).parent / "csrc" / f"{source}.cu"
            ).read_text()
    return {m.group(1): m.group(2).count(",") + 1 for m in re.finditer(
        r'extern "C" int (\w+)\(([^)]*)\)', text)}


@pytest.mark.parametrize("source,table", [
    ("flash_attention_sm90_f32", "_TF32_SIGNATURES"),
    ("flash_attention_sm90", "_TC_SIGNATURES"),
    ("flash_attention", "_SIGNATURES")])
def test_signature_tables_match_the_sources(source, table):
    entries = _c_entries(source)
    sigs = getattr(tfa, table)
    assert set(sigs) == set(entries)
    for name, (restype, argtypes) in sigs.items():
        assert len(argtypes) == entries[name], name
    assert source in _build.SOURCES
