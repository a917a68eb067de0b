"""Autoregressive generation with static-shape KV caches, greedy or
sampled (port of paddle_tpu/models/generation.py).

paddle_tpu compiles one prefill program and one ``lax.scan`` decode
program; here the token loop is a Python loop that keeps the tokens on the
device and copies them to the host once, at the end. Decode runs at a
scalar position (every row at one offset), so it takes the plain cached
attention path — the sequential oracle the serving engine is held to.

Sampling (``_select_token``) keeps paddle_tpu's filter exactly
(temperature, then top-k, then top-p, filtered logits -1e30) and draws by
Gumbel-max, as ``jax.random.categorical`` does. Its random bits are not
JAX's threefry: they come from a counter-based hash of (key, token
index), computed with integer tensor ops wherever the logits lie, with
no generator state, so a draw depends on its key alone and the CPU and
the card draw the same bits. Keys follow JAX's structure: a request's key
is ``prng_key(seed)``; its first token (the prefill's) is drawn with that
key, and the token after position p with ``fold_in(key, p)``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["generate", "new_kv_caches", "new_paged_kv_caches", "prng_key",
           "fold_in"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cache_leaves(tree):
    """The tensors of a cache tree (lists / tuples / dicts of tensors, in
    either layout), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in cache_leaves(v)]
    return [t for v in tree for t in cache_leaves(v)]


def _stack(trees):
    """One tree of stacked leaves from per-layer trees (tensors or dicts
    of tensors): the layout of a ``scan_layers`` model's caches."""
    if isinstance(trees[0], dict):
        return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def new_kv_caches(num_layers, batch, max_len, kv_heads, head_dim, dtype,
                  scan_layers=False, device=None):
    """Per-layer [(k, v), ...] caches [batch, max_len, kv_heads, head_dim]
    of zeros on ``device``, or, ``scan_layers``, one stacked (k_stack,
    v_stack) pair whose leaves carry a leading layer axis; dtype "int8"
    gives the quantised dict form (``quantized_kv_cache``)."""
    from ..nn.functional.flash_attention import quantized_kv_cache
    if dtype == "int8":
        def one():
            return quantized_kv_cache(batch, max_len, kv_heads, head_dim,
                                      device)
    else:
        if str(dtype) not in _DTYPES:
            raise ValueError(f"cache dtype {dtype!r}: one of "
                             f"{sorted(_DTYPES) + ['int8']}")

        def one():
            return torch.zeros((batch, max_len, kv_heads, head_dim),
                               dtype=_DTYPES[str(dtype)], device=device)
    if scan_layers:
        return (_stack([one() for _ in range(num_layers)]),
                _stack([one() for _ in range(num_layers)]))
    return [(one(), one()) for _ in range(num_layers)]


def new_paged_kv_caches(num_layers, num_pages, page_size, kv_heads,
                        head_dim, dtype, scan_layers=False, device=None):
    """Per-layer [(k_pool, v_pool), ...] page pools for the paged serving
    engine (``paged_kv_cache`` dicts [num_pages, page_size, kv_heads,
    head_dim] of zeros on ``device``; dtype "int8" gives the quantised
    pool), or, ``scan_layers``, one stacked (k_stack, v_stack) pair of
    pool dicts [num_layers, num_pages, ...]. A physical page id names that
    page in every layer's pool, so one block table, attached per call by
    the engine, indexes them all."""
    from ..nn.functional.flash_attention import paged_kv_cache
    if dtype != "int8" and str(dtype) not in _DTYPES:
        raise ValueError(f"cache dtype {dtype!r}: one of "
                         f"{sorted(_DTYPES) + ['int8']}")
    dt = "int8" if dtype == "int8" else _DTYPES[str(dtype)]
    if scan_layers:
        return tuple(_stack([paged_kv_cache(num_pages, page_size, kv_heads,
                                            head_dim, dt, device)
                             for _ in range(num_layers)])
                     for _ in range(2))
    return [(paged_kv_cache(num_pages, page_size, kv_heads, head_dim, dt,
                            device),
             paged_kv_cache(num_pages, page_size, kv_heads, head_dim, dt,
                            device))
            for _ in range(num_layers)]


_M32 = 0xFFFFFFFF
_FILTERED = -1e30


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) without int64
    overflow: c is split into 16-bit halves, so no product passes 2**48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """murmur3's 32-bit finaliser (a bijection of [0, 2**32)) on int64
    tensors holding 32-bit words; right shifts of non-negative values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """A sampling key: int64 ``[2]``, the seed's high and low 32-bit words
    (the layout of ``jax.random.PRNGKey``)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """A new key ``[..., 2]`` from ``key`` ``[..., 2]`` and the integers
    ``data`` (broadcast against ``key[..., 0]``; their low 32 bits), as
    ``jax.random.fold_in``: keys folded with different data draw
    independent bits."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    k0, k1 = key[..., 0], key[..., 1]
    n0 = _mix32(k0 ^ _mix32(d ^ k1))
    n1 = _mix32(k1 ^ _mix32(n0 ^ 0x9E3779B9))
    return torch.stack([n0, n1], dim=-1)


def _gumbel(key: torch.Tensor, V: int) -> torch.Tensor:
    """Gumbel noise ``[B, V]`` f32 from keys ``[B, 2]``: two hash rounds of
    (token index, key), 23 bits to a uniform ``(k + 0.5) / 2**23``, never
    0 or 1 (exact in f32), then ``-log(-log u)``."""
    v = torch.arange(V, device=key.device, dtype=torch.int64)[None, :]
    h = _mix32(_mix32(v ^ key[:, :1]) ^ key[:, 1:])
    u = ((h >> 9).to(torch.float32) + 0.5) * 2.0 ** -23
    return -torch.log(-torch.log(u))


def _filter_logits(logits, temperature: float, top_k: int, top_p: float):
    """paddle_tpu's sampling filter on ``[B, V]`` logits, in f32: divide
    by ``max(temperature, 1e-6)``; top-k cuts below the k-th largest
    logit (ties kept); top-p keeps the sorted logits with ``cum - probs <
    top_p`` and cuts below the smallest kept one. Cut logits are -1e30."""
    logits = logits.float() / max(float(temperature), 1e-6)
    if top_k:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, _FILTERED, logits)
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep, srt, torch.inf).amin(-1, keepdim=True)
        logits = torch.where(logits < cutoff, _FILTERED, logits)
    return logits


def _select_token(logits, key, do_sample: bool, temperature: float,
                  top_k: int, top_p: float):
    """logits ``[B, V]`` -> tokens ``[B]`` int64: the argmax (first index
    on ties, as ``jnp.argmax``) when not ``do_sample``; else the Gumbel-max
    draw from the filtered logits with ``key`` (``[B, 2]``, one a row, or
    ``[2]``, the same bits for every row)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    lg = _filter_logits(logits, temperature, top_k, top_p)
    key = key.to(lg.device).expand(lg.shape[0], 2)
    return torch.argmax(lg + _gumbel(key, lg.shape[-1]), dim=-1)


def generate(model, input_ids, max_new_tokens: int = 32,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None, seed: int = 0,
             cache_dtype: str = "bfloat16") -> np.ndarray:
    """Decode ``max_new_tokens`` continuations of ``input_ids`` ([P] or
    [B, P] ints) on the model's device, greedy or (``do_sample``) sampled
    with ``temperature``, ``top_k`` and ``top_p``. Returns an int64 numpy
    array [B, P + max_new_tokens]; after a row emits ``eos_token_id`` it is
    padded with eos. Row b samples as the serving engine samples a request
    with seed ``seed + b``: its key is ``prng_key(seed + b)``, so a row's
    tokens depend on its own seed and positions only (unlike paddle_tpu,
    whose rows share one threefry stream)."""
    ids = np.asarray(input_ids).astype(np.int64)
    if ids.ndim == 1:
        ids = ids[None]
    B, P = ids.shape
    if max_new_tokens <= 0:
        return ids
    total = P + max_new_tokens
    max_len = model.cfg.max_seq_len
    if total > max_len:
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds the model's max_seq_len {max_len}")
    dev = model.device
    knobs = (do_sample, temperature, top_k, top_p)
    keys = (torch.stack([prng_key(seed + b, dev) for b in range(B)])
            if do_sample else None)
    with torch.no_grad():
        caches = model.new_cache(B, total, cache_dtype)
        x = torch.from_numpy(ids).to(dev)
        logits, caches = model(x, caches, 0)
        tok = _select_token(logits[:, -1, :], keys, *knobs)
        fin = (tok == eos_token_id if eos_token_id is not None
               else torch.zeros_like(tok, dtype=torch.bool))
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, caches = model(tok[:, None], caches, P + i)
            nxt = _select_token(logits[:, -1, :],
                                fold_in(keys, P + i) if do_sample else None,
                                *knobs)
            if eos_token_id is not None:
                nxt = torch.where(fin, torch.full_like(nxt, eos_token_id),
                                  nxt)
                fin = fin | (nxt == eos_token_id)
            out.append(nxt)
            tok = nxt
        new = torch.stack(out, dim=1).cpu().numpy()
    return np.concatenate([ids, new.astype(np.int64)], axis=1)
