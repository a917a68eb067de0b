"""Attention functionals: the training half (``flash_attention``,
``scaled_dot_product_attention``, the no-cache ``causal_attention``) and
the cache half (slot KV caches and ``cached_attention``).

Port of paddle_tpu/nn/functional/flash_attention.py. Layout as there:
activations ``[B, S, H, D]``, caches ``[B, L, nkv, hd]`` tensors (f32/bf16)
or the int8 dict form ``{"data": int8 [B, L, nkv, hd], "scale": f32 [B,
L, nkv]}`` from ``quantized_kv_cache``.

Training half: ``flash_attention`` and an unmasked
``scaled_dot_product_attention`` without dropout run the hand-written
flash-attention kernels (B1, ``kernels/flash_attention.py``) forward and
backward through the ``flash_attn`` operator, as paddle_tpu runs
``_pallas_flash`` on the TPU; causal masking is top-left aligned (query i
sees keys j <= i). An explicit ``attn_mask`` runs plain tensor code, and
so does attention dropout in training (with or without a mask, its causal
mask aligned bottom-right), as both run XLA code in paddle_tpu
(``_pallas_geometry_ok`` refuses any rate).

Cache half: unlike the JAX functions, which return new caches, every
function here writes the caches IN PLACE and returns the same objects.
Paged caches are dicts ``{"pages": [NP, PS, nkv, hd] (bf16/f32, or int8
with "scale": f32 [NP, PS, nkv]), "bt": [B, PM] int block table}`` plus
the optional write gates ``"live"`` ([B] bool: rows allowed to write) and
``"wlen"`` (only the first wlen of the S incoming rows write), which the
engine attaches per call (``paged_kv_cache`` allocates the pool).
The S=1 per-row slot-decode step (the engine's decode tick) goes through
the hand-written kernels: ``mega_decode_step`` for tensor caches, one
``kv_slot_write`` launch a layer (all four int8 planes) inside
``_fused_decode_attention`` for int8 caches. These are the paths paddle_tpu
takes with ``PADDLE_TPU_MEGA_DECODE`` and ``PADDLE_TPU_FUSED_CACHE_WRITE``
on; the port has no unfused decode chain to fall back on. Prefill (scalar
position) and multi-token per-row writes into slot caches run as plain
tensor code, as they run as XLA code in paddle_tpu. Every write into a
paged pool goes through the ``kv_paged_write`` kernel, one launch a layer
for both halves with the block-table arithmetic, the write gates and the
int8 quantisation inside it (paddle_tpu with
``PADDLE_TPU_FUSED_CACHE_WRITE`` runs that arithmetic as XLA code around
two ``fused_paged_write`` calls); the paged read gathers pages through the
block table and the attention is the general plain body, as both are XLA
code there (the mega step is gated off for paged dicts in both packages).
"""
from __future__ import annotations

import math

import torch

from ...device import resolve_device
from ...framework.dtype import convert_dtype
from ...kernels.cache_write import kv_paged_write, kv_slot_write
from ...kernels.cache_write import quant_rows as _quant_rows
from ...framework.random import keep_mask
from ...kernels.flash_attention import flash_attn
from ...kernels.mega_decode import mega_decode_step

__all__ = ["flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention", "sdp_kernel", "causal_attention",
           "quantized_kv_cache", "paged_kv_cache", "cached_attention"]

_NEG_INF = -1e30


def _flash(q, k, v, causal, scale):
    """``[B, S, H, D]`` attention on the B1 kernels: transposes to
    ``(B, H, S, D)`` contiguous for the kernel (which also meets its
    16-byte alignment rule on views sliced out of a fused qkv) and back,
    as ``_pallas_flash`` does, through the ``flash_attn`` operator, whose
    backward is the kernel's FA2 backward against the saved (out,
    lse)."""
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out, _ = flash_attn(qh, kh, vh, bool(causal), float(scale))
    return out.transpose(1, 2)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """q/k/v ``[B, S, H, D]`` -> ``(out [B, S, H, D], None)``, paddle's
    (result, softmax) pair; softmax scale ``1 / sqrt(D)``. Without
    dropout it runs the B1 kernels forward and backward on the card, their
    plain versions on the CPU; with ``dropout > 0`` in training it takes
    the plain dropout branch (``_dropout_attention``). ``fixed_seed_offset``
    and ``rng_name`` are accepted and ignored, and so is ``name``, as
    paddle_tpu ignores them: the mask comes from the port's generator."""
    scale = 1.0 / query.shape[-1] ** 0.5
    drop = dropout if training else 0.0
    if drop > 0.0:
        return _dropout_attention(query, key, value, None, causal, scale,
                                  drop), None
    return _flash(query, key, value, causal, scale), None


def _segments(cu, total, device):
    """(segment id, position within the segment) of each of ``total``
    packed rows, from the cumulative lengths ``cu`` ``[n + 1]``."""
    cu = torch.as_tensor(cu, device=device).to(torch.int64)
    starts = cu[1:-1]
    starts = starts[starts < total]
    seg = torch.zeros(total, dtype=torch.int64, device=device)
    seg.index_add_(0, starts, torch.ones_like(starts))
    seg = seg.cumsum(0)
    return seg, torch.arange(total, device=device) - cu[seg]


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False, name=None):
    """Varlen attention over packed rows: q ``[total_q, H, D]`` and k / v
    ``[total_k, H, D]`` hold sequence i at rows ``cu_seqlens_*[i] :
    cu_seqlens_*[i + 1]``; a query sees the keys of its own sequence
    (``causal``: those at or before its position within it), logits
    ``q k^T * scale`` filled with -1e30 elsewhere, softmax over the keys.
    Returns ``(out [total_q, H, D], None)``. paddle_tpu computes it as
    segment-mask attention in XLA, with no kernel, and so does the port,
    in plain tensor code, all in f32 (paddle_tpu at the inputs' dtype),
    the result cast to q's dtype. ``max_seqlen_*``, ``dropout``, ``return_softmax`` and
    ``name`` are accepted and ignored, as paddle_tpu ignores them."""
    seg_q, pos_q = _segments(cu_seqlens_q, query.shape[0], query.device)
    seg_k, pos_k = _segments(cu_seqlens_k, key.shape[0], query.device)
    logits = torch.einsum("qhd,khd->hqk", query.float(),
                          key.float()) * scale
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        mask = mask & (pos_q[:, None] >= pos_k[None, :])
    logits = torch.where(mask[None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("hqk,khd->qhd", probs, value.float())
    return out.to(query.dtype), None


def _masked_logits(q, k, attn_mask, causal, scale, causal_offset):
    """``[B, H, Sq, Sk]`` f32 logits with an explicit mask (bool: keep
    where True) or an additive bias, broadcast, and the causal mask
    (``tril(.., causal_offset)``) applied."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, _NEG_INF)
        else:
            logits = logits + attn_mask.float()
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        keep = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril(causal_offset)
        logits = torch.where(keep, logits, _NEG_INF)
    return logits


def _masked_attention(q, k, v, attn_mask, causal, scale):
    """Plain attention with an explicit mask (bool: keep where True) or an
    additive bias, broadcast to ``[B, H, Sq, Sk]``; softmax in f32; the
    causal mask top-left aligned."""
    probs = torch.softmax(_masked_logits(q, k, attn_mask, causal, scale, 0),
                          dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def _dropout_attention(q, k, v, attn_mask, causal, scale, p):
    """paddle_tpu's attention-dropout branch (``_xla_attention`` with a
    rate): f32 logits, the bias or bool mask, the causal mask aligned
    bottom-right (``tril(.., Sk - Sq)``, as that branch aligns it), the f32
    softmax, ``where(keep, probs / (1 - p), 0)`` with ``keep`` drawn from
    the port's generator for q's device (``framework.random.keep_mask``),
    cast back to q's dtype for the product with v. Plain tensor code, as it
    is XLA code in paddle_tpu: no kernel runs here."""
    logits = _masked_logits(q, k, attn_mask, causal, scale,
                            k.shape[1] - q.shape[1])
    probs = torch.softmax(logits, dim=-1)
    keep = keep_mask(probs.shape, p, q.device)
    probs = torch.where(keep, probs / (1.0 - p), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """paddle's ``scaled_dot_product_attention`` on ``[B, S, H, D]``.
    Without a mask and without dropout it is ``flash_attention`` (the B1
    kernels); with ``attn_mask`` (bool keep-mask or additive bias) it is
    plain tensor code; with ``dropout_p > 0`` in training, mask or not, it
    is the plain dropout branch (``_dropout_attention``). ``name`` is
    ignored, as paddle_tpu ignores it."""
    scale = 1.0 / query.shape[-1] ** 0.5
    drop = dropout_p if training else 0.0
    if drop > 0.0:
        return _dropout_attention(query, key, value, attn_mask, is_causal,
                                  scale, drop)
    if attn_mask is None:
        return _flash(query, key, value, is_causal, scale)
    return _masked_attention(query, key, value, attn_mask, is_causal, scale)


class sdp_kernel:
    """paddle's kernel-selection context manager: accepted and a no-op,
    as in paddle_tpu (``scaled_dot_product_attention`` picks B1 or the
    plain branch from its arguments)."""

    def __init__(self, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def causal_attention(q, k, v):
    """Causal ``softmax(q k^T / sqrt(d)) v`` on ``[B, S, H, D]``: the
    no-cache forward, on the B1 kernels."""
    return flash_attention(q, k, v, causal=True)[0]


def quantized_kv_cache(batch, max_len, kv_heads, head_dim, device=None):
    """An int8 KV-cache half: int8 values with one f32 scale per
    (batch, position, head) row, on ``device`` (the card when omitted;
    raises without one)."""
    dev = resolve_device(device)
    return {"data": torch.zeros((batch, max_len, kv_heads, head_dim),
                                dtype=torch.int8, device=dev),
            "scale": torch.zeros((batch, max_len, kv_heads),
                                 dtype=torch.float32, device=dev)}


def paged_kv_cache(num_pages, page_size, kv_heads, head_dim,
                   dtype="bfloat16", device=None):
    """One paged KV-cache half: the page pool only (block tables are
    per-request engine state, attached per call), on ``device`` (the card
    when omitted; raises without one). ``dtype`` "int8" gives int8 pages
    with an f32 scale per (page, offset, head); else a float dtype, by
    name or as a torch dtype. Zero-filled: unallocated table entries read
    page 0, and the causal mask turns its finite contents into exact
    zeros, which it could not do for NaN from uninitialised memory."""
    dev = resolve_device(device)
    shape = (num_pages, page_size, kv_heads, head_dim)
    if dtype == "int8" or dtype == torch.int8:
        return {"pages": torch.zeros(shape, dtype=torch.int8, device=dev),
                "scale": torch.zeros(shape[:3], dtype=torch.float32,
                                     device=dev)}
    return {"pages": torch.zeros(shape, dtype=convert_dtype(dtype),
                                 device=dev)}


def _is_paged(cache) -> bool:
    return isinstance(cache, dict) and "bt" in cache


def _paged_cache_write(cache, rows, pos):
    """Write [B, S, nkv, hd] rows into one paged cache half in place at
    global positions [pos, pos+S) (scalar pos) or [pos[b], pos[b]+S) per
    row: each lands at (page bt[b, t // PS], offset t % PS), gated by ``t <
    PM * PS`` (never past the table), ``live`` and ``wlen``, the page slot
    clipped into the table, as paddle_tpu's ``_paged_cache_write``. One
    ``kv_paged_write`` launch with one half."""
    kv_paged_write(rows, None, cache, None, cache["bt"], pos,
                   cache.get("live"), cache.get("wlen"))
    return cache


def _paged_cache_read(cache):
    """Gather a paged cache into the [B, PM * PS, nkv, hd] view through
    its block table. Unallocated entries gather page 0, finite garbage the
    causal mask zeroes exactly. int8 pools dequantise after the gather."""
    bt = cache["bt"].long()
    B, PM = bt.shape
    g = cache["pages"][bt]                           # [B, PM, PS, nkv, hd]
    g = g.reshape((B, PM * g.shape[2]) + tuple(g.shape[3:]))
    if "scale" in cache:
        sc = cache["scale"][bt]                      # [B, PM, PS, nkv]
        sc = sc.reshape((B, PM * sc.shape[2]) + tuple(sc.shape[3:]))
        return g.float() * sc[..., None]
    return g


def _write_rows(arr, vals, pos):
    """Write [B, S, ...] ``vals`` into ``arr`` [B, L, ...] at [pos, pos+S)
    (scalar pos: every row at one offset) or [pos[b], pos[b]+S) per row."""
    B, S, L = vals.shape[0], vals.shape[1], arr.shape[1]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        t = pos.to(torch.int64)[:, None] + torch.arange(S, device=arr.device)
        ok = (t >= 0) & (t < L)
        b_idx = torch.arange(B, device=arr.device)[:, None].expand(B, S)
        arr[b_idx[ok], t[ok]] = vals.to(arr.dtype)[ok]
        return
    # scalar offset: lax.dynamic_update_slice semantics (start clamped so
    # the S rows fit)
    start = min(max(int(pos), 0), L - S)
    arr[:, start:start + S] = vals.to(arr.dtype)


def _cache_write(cache, rows, pos):
    """Write [B, S, nkv, hd] rows into a slot cache in place (int8 rows
    quantised first): plain tensor code."""
    if isinstance(cache, dict):
        qrows, scale = _quant_rows(rows)
        _write_rows(cache["data"], qrows, pos)
        _write_rows(cache["scale"], scale, pos)
        return cache
    _write_rows(cache, rows, pos)
    return cache


def _cache_read(cache):
    """[B, L, nkv, hd] view: paged caches gather through their block
    table, int8 dicts dequantise to f32, tensor caches are returned
    unchanged (their dtype drives the PV product)."""
    if _is_paged(cache):
        return _paged_cache_read(cache)
    if isinstance(cache, dict):
        return cache["data"].float() * cache["scale"][..., None]
    return cache


def _fused_decode_attention(q, k, v, kc, vc, pos):
    """S=1 slot-decode step on int8 dict caches (paddle_tpu's
    ``_fused_decode_attention`` with ``PADDLE_TPU_FUSED_CACHE_WRITE``).

    Attends the OLD cache under a strict ``< pos`` mask and merges the new
    row through its quantise -> dequantise round trip, then writes the
    quantised rows and scales of both halves with one ``kv_slot_write``
    launch. The write is issued after every read of the old cache on the
    same stream, so it cannot overtake them."""
    ko, vo = _cache_read(kc), _cache_read(vc)
    B, L, nkv, hd = ko.shape
    nh = q.shape[2]
    g = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, nkv, g, hd)
    logits = (ko[:, :, :, None, :] * qf[:, None]).sum(-1) * scale
    strict = torch.arange(L, device=q.device)[None, :] < pos[:, None]
    logits = torch.where(strict[:, :, None, None], logits,
                         torch.full_like(logits, _NEG_INF))
    kq, ks = _quant_rows(k)
    vq, vs = _quant_rows(v)
    k_at = (kq.float() * ks[..., None]).reshape(B, nkv, 1, hd)
    v_at = (vq.float() * vs[..., None]).reshape(B, nkv, 1, hd)
    logit_new = (k_at * qf).sum(-1) * scale                # [B,kv,g]
    m = torch.maximum(logits.amax(1), logit_new)
    p = torch.exp(logits - m[:, None])
    p_new = torch.exp(logit_new - m)
    den = p.sum(1) + p_new
    ctx = (p[..., None] * vo[:, :, :, None, :]).sum(1)
    ctx = ctx + p_new[..., None] * v_at
    ctx = (ctx / den[..., None]).reshape(B, 1, nh, hd).to(q.dtype)
    kv_slot_write([kc["data"], kc["scale"], vc["data"], vc["scale"]],
                  [kq, ks, vq, vs], pos)
    return ctx, kc, vc


def _cached_attention_plain(q, k, v, kc, vc, pos):
    """Write, read, attend: the general form (scalar pos, or per-row pos
    with S > 1). Logits in f32; PV at the cache dtype, as paddle_tpu."""
    if _is_paged(kc):
        # both halves in one launch; the engine attaches one block table
        # and one set of write gates to both
        kv_paged_write(k, v, kc, vc, kc["bt"], pos, kc.get("live"),
                       kc.get("wlen"))
    else:
        _cache_write(kc, k, pos)
        _cache_write(vc, v, pos)
    ka, va = _cache_read(kc), _cache_read(vc)
    nh, nkv = q.shape[2], ka.shape[2]
    if nkv != nh:
        ka = ka.repeat_interleave(nh // nkv, dim=2)
        va = va.repeat_interleave(nh // nkv, dim=2)
    L, S, hd = ka.shape[1], q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          ka.float()) / math.sqrt(hd)
    l_ids = torch.arange(L, device=q.device)
    s_ids = torch.arange(S, device=q.device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        mask = (l_ids[None, None, :]
                <= pos.to(torch.int64)[:, None, None] + s_ids[None, :, None])
        mask = mask[:, None]                               # [B,1,S,L]
    else:
        mask = l_ids[None, :] <= int(pos) + s_ids[:, None]  # [S, L]
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(va.dtype), va)
    return ctx.to(q.dtype), kc, vc


def cached_attention(q, k, v, k_cache, v_cache, pos):
    """Incremental attention for autoregressive decode (serving path).

    Writes the S new k/v rows into the caches at [pos, pos+S) IN PLACE and
    attends q (query positions pos..pos+S-1) over every cache position
    <= its own. q/k/v: [B, S, nh|nkv, hd]; caches: [B, L, nkv, hd] tensors,
    int8 dicts or paged dicts (module docstring); pos: an int (every row
    at one offset) or a [B] int32 tensor of per-row offsets (continuous
    batching). Paged caches always take the general write-read-attend
    body, the write first, so nothing reads a stale row. Returns
    (ctx [B, S, nh, hd], k_cache, v_cache) — the same cache objects.
    """
    slot_decode = (isinstance(pos, torch.Tensor) and pos.ndim == 1
                   and q.shape[1] == 1 and not _is_paged(k_cache))
    if not slot_decode:
        return _cached_attention_plain(q, k, v, k_cache, v_cache, pos)
    if isinstance(k_cache, dict):
        return _fused_decode_attention(q, k, v, k_cache, v_cache, pos)
    return mega_decode_step(q.contiguous(), k.contiguous(), v.contiguous(),
                            k_cache, v_cache, pos)
