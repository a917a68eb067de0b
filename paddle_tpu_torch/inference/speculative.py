"""Speculative decoding for the serving engine: n-gram drafting and the
batched verify step (port of paddle_tpu/inference/speculative.py, n-gram
half).

A plain decode tick pays one model forward per emitted token. With
``speculative="ngram"`` the engine swaps the tick for a DRAFT -> VERIFY
pair: :class:`NGramProposer` drafts up to k candidate tokens per slot on
the host ("prompt lookup": the continuation of the most recent earlier
occurrence of the context's longest matching suffix n-gram), and ONE
batched forward, :func:`verify_step`, scores all k+1 positions
``[tok, d1..dk]`` for every slot at its own position. The emitted block
is the target's own argmax at every position (an accepted draft token
equals the target token by definition), so greedy speculative output is
token-identical to plain decode whatever the drafter proposed; acceptance
only decides how many tokens a tick consumes (``n_acc + 1``).

Rejected positions need no KV rollback: their rows sit above the row's
true length behind the causal mask (paged: in the slot's private pages,
behind the live write gate) until the true token overwrites them.

Greedy only. The draft-model proposer (``DraftModelProposer``) is not
ported yet (ROADMAP.md): ``speculative="draft"`` raises.

Env knobs as paddle_tpu's: PADDLE_TPU_SERVE_SPEC ("ngram" or unset),
PADDLE_TPU_SERVE_SPEC_K (draft length k, default 4),
PADDLE_TPU_SERVE_SPEC_NGRAM (max n-gram match length, default 3).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..framework.env import int_env

__all__ = ["SpeculativeConfig", "resolve_speculative", "NGramProposer",
           "verify_step"]


@dataclass(frozen=True)
class SpeculativeConfig:
    """Resolved speculative-decoding configuration for one engine."""
    kind: str                    # "ngram"
    k: int                       # draft tokens proposed per tick
    ngram_max: int = 3           # longest suffix n-gram to match
    ngram_min: int = 1           # shortest n-gram worth matching


def resolve_speculative(speculative, spec_k=None, spec_ngram=None):
    """Normalise the engine's ``speculative=`` knob (None reads
    PADDLE_TPU_SERVE_SPEC, False forces off, True means "ngram") into a
    SpeculativeConfig or None."""
    if speculative is None:
        speculative = os.environ.get("PADDLE_TPU_SERVE_SPEC", "").strip()
    if speculative in (False, None, "", "0", "off", "none"):
        return None
    if speculative is True:
        speculative = "ngram"
    kind = str(speculative).lower()
    if kind == "draft":
        raise NotImplementedError(
            "speculative='draft' (the draft-model proposer) is not ported "
            "yet — see ROADMAP.md")
    if kind != "ngram":
        raise ValueError(f"unknown speculative mode {speculative!r} "
                         "(valid: 'ngram', None)")
    k = int(spec_k if spec_k is not None
            else int_env("PADDLE_TPU_SERVE_SPEC_K", 4))
    if k < 1:
        raise ValueError("spec_k must be >= 1")
    ngram_max = int(spec_ngram if spec_ngram is not None
                    else int_env("PADDLE_TPU_SERVE_SPEC_NGRAM", 3))
    if ngram_max < 1:
        raise ValueError("spec_ngram must be >= 1")
    return SpeculativeConfig(kind, k, ngram_max, 1)


class NGramProposer:
    """Propose the continuation of the most recent earlier occurrence of
    the context's longest matching suffix n-gram. Pure numpy over each
    slot's token history; wrong proposals cost only rejected verify
    positions, never correctness."""

    kind = "ngram"

    def __init__(self, k: int, ngram_max: int = 3, ngram_min: int = 1):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError("need 1 <= ngram_min <= ngram_max")
        self.k = int(k)
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)

    def propose(self, context: np.ndarray):
        """(props[k] int32, draft_len) for one slot's full token context.
        The longest suffix n-gram wins; among equal-length matches the
        most recent one with a FULL k-token continuation wins, else the
        EARLIEST hit (whose continuation to the context end is the longest
        available): in periodic context the most recent match's
        continuation truncates after one period, and inside a growing
        repeated run the latest match's continuation is a single token."""
        ctx = np.asarray(context).reshape(-1)
        L = ctx.shape[0]
        props = np.zeros(self.k, np.int32)
        for g in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            pat = ctx[L - g:]
            # candidate matches end strictly before the suffix itself and
            # leave >= 1 continuation token
            hay = ctx[:L - 1]
            if hay.shape[0] < g:
                continue
            win = np.lib.stride_tricks.sliding_window_view(hay, g)
            hits = np.nonzero((win == pat).all(axis=1))[0]
            if hits.shape[0] == 0:
                continue
            full = hits[hits + g + self.k <= L]
            j = int(full[-1] if full.shape[0] else hits[0]) + g
            cont = ctx[j:j + self.k]
            props[:cont.shape[0]] = cont.astype(np.int32)
            return props, int(cont.shape[0])
        return props, 0


def verify_step(model, caches, tok, pos, props, dlen):
    """One batched verify forward (paddle_tpu's ``make_verify_program``
    body): feed every slot's ``[tok, d1..dk]`` block at its own position
    ``pos`` through ``model`` (writing the block's k+1 cache rows in
    place), take the target argmax at every position, and count the
    accepted draft prefix by a cumulative product of matches.

    tok [N], pos [N] int32, props [N, k] int32, dlen [N] int32, all on the
    model's device; ``caches`` are slot caches or paged pools with the
    block table and live gate attached. Returns ``(toks [N, k+1] int32,
    n_acc [N] int32)`` on the device: ``toks[i, j]`` is the target's token
    for position ``pos[i] + j + 1``, and the host consumes ``n_acc[i] +
    1`` of them."""
    K = props.shape[1]
    ids = torch.cat([tok[:, None], props], dim=1).to(torch.int64)
    logits, _ = model(ids, caches, pos)
    tgt = torch.argmax(logits, dim=-1).to(torch.int32)          # [N, K+1]
    j = torch.arange(K, device=props.device)[None, :]
    match = ((props == tgt[:, :K]) & (j < dlen[:, None])).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    return tgt, n_acc
