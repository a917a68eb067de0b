"""Greedy autoregressive generation with static-shape KV caches (port of
paddle_tpu/models/generation.py).

paddle_tpu compiles one prefill program and one ``lax.scan`` decode
program; here the token loop is a Python loop that keeps the tokens on the
device and copies them to the host once, at the end. Decode runs at a
scalar position (every row at one offset), so it takes the plain cached
attention path — the sequential oracle the serving engine is held to.
Sampling (``do_sample=True``) is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["generate", "new_kv_caches", "new_paged_kv_caches"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def new_kv_caches(num_layers, batch, max_len, kv_heads, head_dim, dtype,
                  device):
    """Per-layer [(k, v), ...] caches [batch, max_len, kv_heads, head_dim]
    of zeros on ``device``; dtype "int8" gives the quantised dict form
    (``quantized_kv_cache``)."""
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
    return [(one(), one()) for _ in range(num_layers)]


def new_paged_kv_caches(num_layers, num_pages, page_size, kv_heads,
                        head_dim, dtype, device):
    """Per-layer [(k_pool, v_pool), ...] page pools for the paged serving
    engine (``paged_kv_cache`` dicts [num_pages, page_size, kv_heads,
    head_dim] of zeros on ``device``; dtype "int8" gives the quantised
    pool). A physical page id names that page in every layer's pool, so
    one block table, attached per call by the engine, indexes them all."""
    from ..nn.functional.flash_attention import paged_kv_cache
    if dtype != "int8" and str(dtype) not in _DTYPES:
        raise ValueError(f"cache dtype {dtype!r}: one of "
                         f"{sorted(_DTYPES) + ['int8']}")
    dt = "int8" if dtype == "int8" else _DTYPES[str(dtype)]
    return [(paged_kv_cache(num_pages, page_size, kv_heads, head_dim, dt,
                            device),
             paged_kv_cache(num_pages, page_size, kv_heads, head_dim, dt,
                            device))
            for _ in range(num_layers)]


def _select_token(logits):
    """logits [B, V] -> token [B] (greedy; first index on ties, as
    jnp.argmax)."""
    return torch.argmax(logits, dim=-1)


def generate(model, input_ids, max_new_tokens: int = 32,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None, seed: int = 0,
             cache_dtype: str = "bfloat16") -> np.ndarray:
    """Greedy-decode ``max_new_tokens`` continuations of ``input_ids``
    ([P] or [B, P] ints) on the model's device. Returns an int64 numpy
    array [B, P + max_new_tokens]; after a row emits ``eos_token_id`` it is
    padded with eos. Sampling (``do_sample`` and its knobs
    ``temperature``, ``top_k``, ``top_p``, ``seed``) is not ported: any
    of them off its default raises."""
    if (do_sample or temperature != 1.0 or top_k != 0 or top_p != 1.0
            or seed != 0):
        raise NotImplementedError(
            "sampling (do_sample, temperature, top_k, top_p, seed) is not "
            "ported yet — see ROADMAP.md")
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
    with torch.no_grad():
        caches = model.new_cache(B, total, cache_dtype)
        x = torch.from_numpy(ids).to(dev)
        logits, caches = model(x, caches, 0)
        tok = _select_token(logits[:, -1, :])
        fin = (tok == eos_token_id if eos_token_id is not None
               else torch.zeros_like(tok, dtype=torch.bool))
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, caches = model(tok[:, None], caches, P + i)
            nxt = _select_token(logits[:, -1, :])
            if eos_token_id is not None:
                nxt = torch.where(fin, torch.full_like(nxt, eos_token_id),
                                  nxt)
                fin = fin | (nxt == eos_token_id)
            out.append(nxt)
            tok = nxt
        new = torch.stack(out, dim=1).cpu().numpy()
    return np.concatenate([ids, new.astype(np.int64)], axis=1)
