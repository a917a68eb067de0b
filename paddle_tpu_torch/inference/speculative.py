"""Speculative decoding for the serving engine: n-gram drafting,
draft-model drafting and the batched verify step (port of
paddle_tpu/inference/speculative.py).

A plain decode tick pays one model forward per emitted token. With
``speculative=`` the engine swaps the tick for a DRAFT -> VERIFY pair: a
proposer drafts up to k candidate tokens per slot, and ONE batched
forward, :func:`verify_step`, scores all k+1 positions
``[tok, d1..dk]`` for every slot at its own position. The emitted block
is the target's own argmax at every position (an accepted draft token
equals the target token by definition), so greedy speculative output is
token-identical to plain decode whatever the drafter proposed; acceptance
only decides how many tokens a tick consumes (``n_acc + 1``).

Two proposers:

- :class:`NGramProposer` (``"ngram"``) drafts on the host ("prompt
  lookup": the continuation of the most recent earlier occurrence of the
  context's longest matching suffix n-gram).
- :class:`DraftModelProposer` (``"draft"``) runs a small draft model over
  its own f32 slot cache: per tick one S = 2 forward of the sync block
  ``[prev, tok]`` at per-row positions ``pos - 1`` (the general cached
  path: plain row writes and attention), then k - 1 greedy single-token
  steps (the B4 ``mega_decode_step`` kernel a layer), and one host read
  of the ``[N, k]`` proposals. Its launches of B4: draft ticks x (k - 1)
  x draft layers.

Rejected positions need no KV rollback: their rows sit above the row's
true length behind the causal mask (paged: in the slot's private pages,
behind the live write gate) until the true token overwrites them.

Draft-cache sync invariant (paddle_tpu's): before each tick the draft
cache holds true rows through position pos - 1 and has never seen
``tok`` (the token at pos). The sync block writes pos - 1 (again: rows
are functions of the true prefix, so a rewrite is harmless, and after
full acceptance pos - 1 was never written) and pos, then drafts. After
verify accepts n, positions pos..pos+n hold true draft rows, so the
invariant holds at pos' = pos + n + 1 with no rollback either; rejected
drafts' rows sit above pos' until the sync block or a draft step
rewrites them. A free slot drafts with pos = 0, its sync block at -1:
the plain row write drops negative positions and GPT's position lookup
clamps; what it writes at rows 0..k-1 of the free slot is reset by the
next admission, which copies a whole fresh row in.

Greedy only. Every emitted token is the target's argmax, so the draft's
numerics never reach the output.

Env knobs as paddle_tpu's: PADDLE_TPU_SERVE_SPEC ("ngram" or unset),
PADDLE_TPU_SERVE_SPEC_K (draft length k, default 4),
PADDLE_TPU_SERVE_SPEC_NGRAM (max n-gram match length, default 3).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..framework.env import int_env
from ..models.generation import cache_leaves

__all__ = ["SpeculativeConfig", "resolve_speculative", "NGramProposer",
           "DraftModelProposer", "verify_step"]


@dataclass(frozen=True)
class SpeculativeConfig:
    """Resolved speculative-decoding configuration for one engine."""
    kind: str                    # "ngram" | "draft"
    k: int                       # draft tokens proposed per tick
    ngram_max: int = 3           # longest suffix n-gram to match
    ngram_min: int = 1           # shortest n-gram worth matching
    draft_model: Optional[object] = None   # kind == "draft" only


def resolve_speculative(speculative, spec_k=None, spec_ngram=None,
                        draft_model=None):
    """Normalise the engine's ``speculative=`` knob (None reads
    PADDLE_TPU_SERVE_SPEC, False forces off, True means "ngram") into a
    SpeculativeConfig or None. ``"draft"`` needs ``draft_model``."""
    if speculative is None:
        speculative = os.environ.get("PADDLE_TPU_SERVE_SPEC", "").strip()
    if speculative in (False, None, "", "0", "off", "none"):
        return None
    if speculative is True:
        speculative = "ngram"
    kind = str(speculative).lower()
    if kind not in ("ngram", "draft"):
        raise ValueError(f"unknown speculative mode {speculative!r} "
                         "(valid: 'ngram', 'draft', None)")
    if kind == "draft" and draft_model is None:
        raise ValueError("speculative='draft' needs draft_model= (a "
                         "small cache-threaded causal LM)")
    k = int(spec_k if spec_k is not None
            else int_env("PADDLE_TPU_SERVE_SPEC_K", 4))
    if k < 1:
        raise ValueError("spec_k must be >= 1")
    ngram_max = int(spec_ngram if spec_ngram is not None
                    else int_env("PADDLE_TPU_SERVE_SPEC_NGRAM", 3))
    if ngram_max < 1:
        raise ValueError("spec_ngram must be >= 1")
    return SpeculativeConfig(kind, k, ngram_max, 1,
                             draft_model if kind == "draft" else None)


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


def insert_row(caches, row, slot: int):
    """Copy the batch-1 cache tree ``row`` into slot ``slot`` of the
    N-slot tree ``caches`` of the same layout, in place. The slot axis of
    each leaf is the one where the two leaves disagree (axis 0 for
    per-layer leaves, 1 for scan-stacked ones), as paddle_tpu's
    ``insert``."""
    for dst, src in zip(cache_leaves(caches), cache_leaves(row)):
        ax = next(i for i, (a, b) in enumerate(zip(dst.shape, src.shape))
                  if a != b)
        dst.narrow(ax, slot, 1).copy_(src)


class DraftModelProposer:
    """A small draft model with its own slot cache (``model.new_cache
    (slots, max_len, cache_dtype)``) that proposes k greedy tokens for
    every slot a tick (the module docstring's sync invariant).

    ``admit`` prefills a fresh batch-1 cache row with the prompt and
    copies the whole row into the slot, which also resets a retired
    slot's stale rows. ``propose`` runs the sync block and k - 1 single
    token steps and reads the ``[N, k]`` proposals to the host once. The
    model runs in eval mode under ``torch.no_grad()``."""

    kind = "draft"

    def __init__(self, model, slots: int, max_len: int, k: int,
                 cache_dtype: str = "float32"):
        self.model = model
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.k = int(k)
        self.cache_dtype = cache_dtype
        model.eval()
        with torch.no_grad():
            self._caches = model.new_cache(self.slots, self.max_len,
                                           cache_dtype)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @torch.no_grad()
    def admit(self, slot: int, prompt: np.ndarray, bucket: int) -> None:
        """Prefill slot ``slot``'s draft rows with the whole ``prompt``,
        right-padded to ``bucket`` (the padding's rows lie above the
        prompt and are rewritten before any query attends them)."""
        P = prompt.shape[0]
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :P] = prompt
        row = self.model.new_cache(1, self.max_len, self.cache_dtype)
        self.model(torch.from_numpy(ids).to(self.device), row, 0)
        insert_row(self._caches, row, slot)

    @torch.no_grad()
    def propose(self, prev: np.ndarray, tok: np.ndarray,
                pos: np.ndarray) -> np.ndarray:
        """[N, k] int32 proposals for every slot: the sync block ``[prev,
        tok]`` at per-row positions ``pos - 1``, then k - 1 greedy single
        token steps; one host read."""
        dev = self.device
        pos_d = torch.from_numpy(np.asarray(pos, np.int32)).to(dev)
        ids = torch.from_numpy(np.stack([prev, tok], axis=1).astype(
            np.int64)).to(dev)                                  # [N, 2]
        logits, _ = self.model(ids, self._caches, pos_d - 1)
        d = torch.argmax(logits[:, -1, :], dim=-1)
        out = [d]
        for j in range(1, self.k):
            logits, _ = self.model(d[:, None], self._caches, pos_d + j)
            d = torch.argmax(logits[:, -1, :], dim=-1)
            out.append(d)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def warmup(self, buckets) -> None:
        """One admission a bucket and one proposal on slot 0, then the
        draft cache zeroed: builds the kernels the draft runs before the
        first request."""
        for b in buckets:
            self.admit(0, np.zeros(1, np.int64), int(b))
        N = self.slots
        self.propose(np.zeros(N, np.int32), np.zeros(N, np.int32),
                     np.ones(N, np.int32))
        for t in cache_leaves(self._caches):
            t.zero_()


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
