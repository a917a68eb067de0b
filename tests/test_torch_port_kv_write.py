"""The fused KV-cache writes of paddle_tpu_torch against paddle_tpu, on the
CPU.

- ``kv_paged_write`` (both halves of a paged layer in one launch on the
  card): its plain version, through the wrapper on CPU tensors, against
  paddle_tpu's ``_paged_cache_write`` applied to each half with
  PADDLE_TPU_FUSED_CACHE_WRITE on (its write then runs the Pallas kernel,
  interpreted), op by op: under ``jax.jit`` XLA rewrites ``amax / 127``
  as ``amax * (1 / 127)``, one ulp off the written formula for about one
  amax in twenty, and the port keeps the formula (IEEE division, as numpy
  and JAX op by op). Bit-exact pools and scale planes, for f32, bf16 and int8
  pools, f32 and bf16 rows, over an admission with ``wlen``, a decode with
  ``live``, a verify block, writes past the table, negative positions, the
  page edges 15, 16 and 17, and rows that are strided views of a qkv
  output as the port's GPT cuts them.
- ``kv_slot_write`` (the int8 slot decode's four planes in one launch):
  its plain version against paddle_tpu's ``fused_slot_write`` called on
  each plane (interpret mode). Bit-exact.
- ``quant_rows``: IEEE division by 127 (paddle_tpu's formula), pinned at
  values where multiplying by the f32 reciprocal of 127 gives another
  scale.
- ``lane_plan``: the lane layout the CUDA wrapper picks from the head size,
  the element sizes and the alignment of the rows.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.cache_write import fused_slot_write as jax_slot_write
from paddle_tpu_torch.kernels import cache_write as cw
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

jfa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")

KNOB = "PADDLE_TPU_FUSED_CACHE_WRITE"
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "int8": torch.int8}
NKV, HD = 2, 8

# (NP, PS, PM, B, S, pos, live, wlen). Block tables are distinct pages drawn
# from the pool, so valid rows never collide: a padded admission at a
# scalar position crossing pages, an S=1 decode at per-row positions with a
# dead row, a k+1 = 3 verify block, writes running past the table (t >= PM
# * PS), negative positions (page slot 0, offset t mod PS), and the page
# edges 15, 16 and 17 of the engine's 16-row pages.
_WRITES = {
    "admission": (8, 4, 4, 1, 8, 4, None, 5),
    "decode": (12, 4, 4, 3, 1, [0, 9, 15], [True, False, True], None),
    "verify": (12, 4, 4, 3, 3, [2, 13, 6], [True, True, False], None),
    "past_table": (8, 4, 4, 2, 4, [14, 3], None, None),
    "negative_rows": (12, 4, 4, 3, 1, [-1, -3, -6], None, None),
    "negative_block": (8, 4, 4, 2, 2, -2, None, None),
    "page_edges": (8, 16, 2, 3, 1, [15, 16, 17], None, None),
    "page_edges_verify": (8, 16, 2, 3, 3, [14, 15, 16], [True, True, True],
                          None),
}


def _np32(x):
    """numpy of a jax or torch array, floats as f32 (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def _pool(rs, NP, PS, dtype):
    shape = (NP, PS, NKV, HD)
    if dtype == "int8":
        return {"pages": rs.randint(-127, 128, shape).astype(np.int8),
                "scale": (np.abs(rs.randn(*shape[:3])) * 0.02).astype(
                    np.float32)}
    return {"pages": rs.randn(*shape).astype(np.float32)}


def _jax_half(pool, dtype):
    return {n: jnp.asarray(a).astype(_JDT["float32" if n == "scale"
                                          else dtype])
            for n, a in pool.items()}


def _torch_half(pool, dtype):
    return {n: torch.from_numpy(a.copy()).to(_TDT["float32" if n == "scale"
                                                  else dtype])
            for n, a in pool.items()}


@pytest.mark.parametrize("rows_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(_WRITES))
def test_kv_paged_write_matches_paddle_tpu(monkeypatch, case, dtype,
                                           rows_dtype):
    """Both halves, bit-exact against paddle_tpu's one-half write run on
    each; the rows are strided views of a [B, S, 3 nkv hd] qkv array, and
    the CPU wrapper launches nothing."""
    monkeypatch.setenv(KNOB, "1")
    NP, PS, PM, B, S, pos, live, wlen = _WRITES[case]
    rs = np.random.RandomState(21)
    qkv = rs.randn(B, S, 3 * NKV * HD).astype(np.float32)
    H = NKV * HD
    tqkv = torch.from_numpy(qkv).to(_TDT[rows_dtype])
    tk = tqkv[..., H:2 * H].reshape(B, S, NKV, HD)
    tv = tqkv[..., 2 * H:].reshape(B, S, NKV, HD)
    assert not tk.is_contiguous() and tk.stride(-1) == 1
    pools = [_pool(rs, NP, PS, dtype) for _ in range(2)]
    bt = rs.permutation(NP)[:B * PM].reshape(B, PM).astype(np.int64)
    meta_j, meta_t = {"bt": jnp.asarray(bt, jnp.int32)}, {}
    if live is not None:
        meta_j["live"], meta_t["live"] = jnp.asarray(live), torch.tensor(live)
    if wlen is not None:
        meta_j["wlen"], meta_t["wlen"] = jnp.int32(wlen), wlen
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = (torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list)
            else pos)

    jq = jnp.asarray(qkv).astype(_JDT[rows_dtype])
    want = [jfa._paged_cache_write({**_jax_half(p, dtype), **meta_j},
                                   jq[..., lo:lo + H].reshape(B, S, NKV, HD),
                                   jpos) for p, lo in zip(pools, (H, 2 * H))]
    tk_pool, tv_pool = (_torch_half(p, dtype) for p in pools)
    cw.kv_paged_write.launches = 0
    out = cw.kv_paged_write(tk, tv, tk_pool, tv_pool, torch.from_numpy(bt),
                            tpos, meta_t.get("live"), meta_t.get("wlen"))
    assert out[0] is tk_pool and out[1] is tv_pool
    assert cw.kv_paged_write.launches == 0
    for got, w, p in zip((tk_pool, tv_pool), want, pools):
        for n in p:
            np.testing.assert_array_equal(_np32(got[n]), _np32(w[n]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_kv_paged_write_of_gpt_qkv_views(monkeypatch, dtype):
    """Rows cut by the port's GPT attention from its real [B, S, 3H] qkv
    projection (gpt_tiny: 4 heads of 16) into both halves at a scalar
    admission position, against paddle_tpu on contiguous copies."""
    monkeypatch.setenv(KNOB, "1")
    m = GPTForCausalLM(gpt_tiny(), device="cpu", seed=0)
    attn = m.gpt.blocks[0].attn
    nh, hd = attn.num_heads, attn.head_dim
    B, S, NP, PS, PM = 2, 5, 8, 4, 3
    rs = np.random.RandomState(22)
    x = torch.from_numpy(rs.randn(B, S, nh * hd).astype(np.float32))
    with torch.no_grad():
        _, k, v = attn._qkv(x)
    assert not k.is_contiguous()
    shape = (NP, PS, nh, hd)
    pools = []
    for _ in range(2):
        if dtype == "int8":
            pools.append({"pages": np.zeros(shape, np.int8),
                          "scale": np.zeros(shape[:3], np.float32)})
        else:
            pools.append({"pages": rs.randn(*shape).astype(np.float32)})
    bt = rs.permutation(NP)[:B * PM].reshape(B, PM).astype(np.int64)
    want = [jfa._paged_cache_write(
        {**_jax_half(p, dtype), "bt": jnp.asarray(bt, jnp.int32)},
        jnp.asarray(r.numpy()), 3) for p, r in zip(pools, (k, v))]
    halves = [_torch_half(p, dtype) for p in pools]
    cw.kv_paged_write(k, v, *halves, torch.from_numpy(bt), 3)
    for got, w, p in zip(halves, want, pools):
        for n in p:
            np.testing.assert_array_equal(_np32(got[n]), _np32(w[n]))


def test_cached_attention_paged_writes_both_halves_in_one_call(monkeypatch):
    """``cached_attention`` on paged caches goes through one
    ``kv_paged_write`` call a layer (both halves), and ``_paged_cache_write``
    through one with one half."""
    calls = []
    real = cw.kv_paged_write_plain

    def spy(k, v, *a, **kw):
        calls.append(v is not None)
        return real(k, v, *a, **kw)
    monkeypatch.setattr(cw, "kv_paged_write_plain", spy)
    rs = np.random.RandomState(23)
    B, S = 2, 3
    caches = [tfa.paged_kv_cache(8, 4, NKV, HD, torch.float32, "cpu")
              for _ in range(2)]
    bt = torch.from_numpy(rs.permutation(8)[:B * 4].reshape(B, 4))
    for c in caches:
        c["bt"] = bt
    q, k, v = (torch.from_numpy(rs.randn(B, S, NKV, HD).astype(np.float32))
               for _ in range(3))
    tfa.cached_attention(q, k, v, caches[0], caches[1], 2)
    tfa._paged_cache_write(caches[0], k, 5)
    assert calls == [True, False]


@pytest.mark.parametrize("pos", [[-1, 16, 23], [0, 15, 5], [-1, 0, 16]])
def test_kv_slot_write_matches_paddle_tpu(pos):
    """The int8 slot decode's four planes (k data, k scale, v data, v
    scale) in one call, bit-exact against paddle_tpu's fused_slot_write on
    each plane in interpret mode; rows at -1, L and L + 7 write nothing."""
    B, L = len(pos), 16
    rs = np.random.RandomState(24)
    planes = []
    for _ in range(2):
        planes.append((rs.randint(-127, 128, (B, L, NKV, HD)).astype(np.int8),
                       rs.randint(-127, 128, (B, 1, NKV, HD)).astype(np.int8)))
        planes.append((rs.rand(B, L, NKV).astype(np.float32),
                       rs.rand(B, 1, NKV).astype(np.float32)))
    pos = np.asarray(pos, np.int32)
    want = [jax_slot_write(jnp.asarray(c), jnp.asarray(r), jnp.asarray(pos),
                           interpret=True) for c, r in planes]
    caches = [torch.from_numpy(c.copy()) for c, _ in planes]
    cw.kv_slot_write.launches = 0
    out = cw.kv_slot_write(caches, [torch.from_numpy(r) for _, r in planes],
                           torch.from_numpy(pos))
    assert out is caches and cw.kv_slot_write.launches == 0
    for got, w in zip(caches, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def test_int8_slot_decode_writes_through_kv_slot_write(monkeypatch):
    """The int8 slot decode step makes one ``kv_slot_write`` call with the
    four planes."""
    calls = []
    real = cw.kv_slot_write_plain

    def spy(caches, rows, pos):
        calls.append(len(caches))
        return real(caches, rows, pos)
    monkeypatch.setattr(cw, "kv_slot_write_plain", spy)
    rs = np.random.RandomState(25)
    B, L = 3, 16
    kc, vc = (tfa.quantized_kv_cache(B, L, NKV, HD, "cpu") for _ in range(2))
    q, k, v = (torch.from_numpy(rs.randn(B, 1, NKV, HD).astype(np.float32))
               for _ in range(3))
    tfa.cached_attention(q, k, v, kc, vc,
                         torch.tensor([0, 4, L], dtype=torch.int32))
    assert calls == [4]


def test_quant_rows_divides_by_127():
    """scale = fl(amax / 127), not amax times fl(1 / 127): rows whose amax
    makes the two differ, against numpy's f32 division and paddle_tpu."""
    rs = np.random.RandomState(26)
    amax = (np.abs(rs.randn(4096)) * 3).astype(np.float32)
    recip = amax * (np.float32(1) / np.float32(127))
    amax = amax[amax / np.float32(127) != recip][:16]
    assert amax.shape == (16,)
    x = rs.uniform(-1, 1, (16, 1, 8)).astype(np.float32) * amax[:, None,
                                                                None]
    x[:, 0, 3] = amax                      # the row's largest |x|
    q, scale = cw.quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(scale.numpy()[:, 0],
                                  amax / np.float32(127))
    jq, js = jfa._quant_rows(jnp.asarray(x))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("hd,el_src,el_dst,src_off,want", [
    (64, 4, 2, 768 * 4, (8, 8)),      # f32 qkv rows into a bf16 pool
    (64, 2, 2, 768 * 2, (8, 8)),      # bf16 rows, bf16 pool
    (64, 4, 1, 768 * 4, (16, 4)),     # int8 pool: 16 elements a lane
    (64, 4, 4, 768 * 4, (4, 16)),     # f32 pool
    (256, 2, 2, 0, (8, 32)),          # 32 chunks: one warp a row
    (512, 2, 2, 0, (8, 32)),          # 64 chunks: two a lane
    (36, 2, 2, 0, (4, 16)),           # 36 = 9 x 4: 9 chunks, 16 lanes
    (33, 2, 1, 0, (1, 32)),           # odd head size: single elements
    (64, 2, 2, 2, (1, 32)),           # a row start 2 bytes off
])
def test_lane_plan(hd, el_src, el_dst, src_off, want):
    base = 1 << 20
    strides = [1024 * 3 * hd, 3 * hd, hd] * 2
    got = cw.lane_plan(hd, el_src, el_dst, [base + src_off] * 2, strides,
                       [base, base + 4096])
    assert got == want


def test_new_wrappers_on_cpu_launch_nothing():
    cw.kv_paged_write.launches = cw.kv_slot_write.launches = 0
    pool = tfa.paged_kv_cache(4, 4, NKV, HD, "int8", "cpu")
    rows = torch.ones(1, 2, NKV, HD)
    cw.kv_paged_write(rows, None, pool, None,
                      torch.zeros(1, 2, dtype=torch.int64), 0)
    cache = torch.zeros(1, 4, NKV)
    cw.kv_slot_write([cache], [torch.ones(1, 1, NKV)],
                     torch.zeros(1, dtype=torch.int32))
    assert cw.kv_paged_write.launches == cw.kv_slot_write.launches == 0
    assert pool["pages"][0, :2].eq(127).all() and cache[0, 0].eq(1).all()
