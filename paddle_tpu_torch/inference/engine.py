"""Continuous-batching serving engine over a slot or a paged KV cache
(port of paddle_tpu/inference/engine.py: slot mode, paged mode with
prefix sharing and copy-on-write, n-gram speculative decoding).

Slot mode: a fixed pool of N decode slots shares one pre-allocated KV
cache (``model.new_cache(N, max_len, dtype)``: per-layer [N, max_len, nkv,
hd] tensors, bf16/f32, or the int8 dict form) that every step updates in
place. One engine thread runs the loop:

- admission, at tick boundaries: a queued request takes a free slot; the
  slot's cache rows (int8 scales included) are zeroed in place and its
  prompt, right-padded to the nearest prefill bucket, is prefilled into
  them at position 0 — so a retired request's rows never leak into the
  next one. Its first token is selected from the logits at ``P - 1``.
- decode ticks: ``tick_tokens`` micro-steps for ALL slots; free and
  finished slots ride along with ``live`` False (their token held, their
  position not advancing), so every step has the same shapes. Tokens stay
  on the device across the micro-steps and come to the host once per
  tick, as the JAX engine's one host sync per tick. Each micro-step's
  attention is the S=1 slot-decode path of ``cached_attention``: the
  ``mega_decode_step`` kernel per layer for bf16/f32 caches, one
  ``kv_slot_write`` launch per layer (all four int8 planes) for int8
  caches.
- retirement: a request ends on eos or its token budget; its future
  resolves to the int64 [P + max_new_tokens] array, eos-padded.

Right-padded bucketed prefill is exact: the padding rows a prompt writes
at [P, bucket) are never attended by positions < P, and decode overwrites
position p before the mask reaches it.

Sampling (``do_sample`` with ``temperature``, ``top_k``, ``top_p``, as
paddle_tpu's engine takes them): every token is selected by
``generation._select_token``, the argmax or a Gumbel-max draw from the
filtered logits. A request's draws are keyed by its ``seed`` and the
position alone, as paddle_tpu keys them (``fold_in(PRNGKey(seed), pos)``):
the first token, at admission, with ``prng_key(seed)``, the token after
position p with ``fold_in(prng_key(seed), p)``. So its tokens do not
depend on its slot, the tick it lands in or the other requests, and equal
``generate(..., seed=seed)`` for the same prompt. The keys are folded and
the bits hashed on the device inside the micro-steps: the tick keeps its
one host sync.

Paged mode (``paged=True``): the cache is carved into ``page_size``-token
pages shared by all slots (per-layer pools [num_pages, page_size, nkv,
hd] from ``model.new_paged_cache``); each slot holds a BLOCK TABLE row of
physical page ids (host numpy, uploaded per call). Every micro-step
attaches the table and the live mask to the per-layer pool dicts; the
write goes through the ``kv_paged_write`` kernel (one launch a layer for
both halves, the page arithmetic inside it) gated on ``live``, so a dead
slot, whose zeroed table row points at page 0, never writes into a page
another request may own; the read gathers the slot's pages into the
contiguous view. Admission (``_admit_paged``) matches the
prompt's complete pages in the prefix trie (``paging.py``), increfs the
matches, allocates the rest all-or-nothing (evicting trie-only pages
under pressure), copies the tail page on write when the whole prompt
matched, and prefills only the un-cached suffix at ``m_pos = M`` with
``wlen`` gating the bucket padding out of the pool. The gathered view
has the length the slot row had and masked garbage contributes exact
zeros, so greedy paged output is token-identical to the slot engine.

Speculative mode (``speculative="ngram"``, ``speculative.py``): each tick
drafts up to k tokens per slot on the host and, when any slot has a
draft, runs ONE verify forward of ``[tok, d1..dk]`` for every slot
instead of the plain tick; the emitted tokens are the target's own
argmax, so output is token-identical to plain decode. Slot verify writes
its k+1 rows per slot as plain tensor code; paged verify through
``kv_paged_write`` (N·(k+1) rows a half per launch).

Not ported yet (ROADMAP.md): the draft-model proposer, tensor
parallelism, observability metrics, AOT warmup.

Env knobs as paddle_tpu's: PADDLE_TPU_SERVE_SLOTS (default 8),
PADDLE_TPU_SERVE_PREFILL_BUCKETS (comma list, default powers of two),
PADDLE_TPU_SERVE_TICK_TOKENS (default 8), PADDLE_TPU_SERVE_MAX_QUEUE
(default 32), PADDLE_TPU_SERVE_PAGED (default 0), PADDLE_TPU_KV_PAGE
(page size, default 16), PADDLE_TPU_SERVE_NUM_PAGES (default slots *
ceil(max_len / page_size)), PADDLE_TPU_SERVE_SPEC ("ngram", default off),
PADDLE_TPU_SERVE_SPEC_K (default 4), PADDLE_TPU_SERVE_SPEC_NGRAM (default
3).
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..framework.env import int_env
from ..kernels.cache_write import kv_paged_write, kv_slot_write
from ..kernels.mega_decode import mega_decode_step
from ..models.generation import _select_token, fold_in, prng_key
from .paging import PageAllocator, PrefixTrie, pages_needed
from .speculative import NGramProposer, resolve_speculative, verify_step

__all__ = ["ContinuousBatchingEngine", "EngineOverloaded",
           "CacheExhausted", "RequestCancelled"]


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the request queue is at capacity — the
    serving layer maps it to the 503 ``overloaded`` record."""

    reason = "overloaded"

    def __init__(self, queue_depth: int, max_queue: int):
        super().__init__(
            f"engine queue saturated ({queue_depth}/{max_queue})")
        self.queue_depth = queue_depth
        self.max_queue = max_queue


class CacheExhausted(EngineOverloaded):
    """Queue saturated while the KV page pool — not slot count or request
    rate — is the binding constraint (paged engines only). The serving
    layer maps it to 503 ``cache_exhausted``; retries clear when a request
    retires and frees pages."""

    reason = "cache_exhausted"

    def __init__(self, queue_depth: int, max_queue: int, free_pages: int,
                 num_pages: int):
        super().__init__(queue_depth, max_queue)
        self.free_pages = free_pages
        self.num_pages = num_pages


class RequestCancelled(RuntimeError):
    """The request was cancelled (``engine.cancel``). Raised out of its
    future; the tokens generated before the cancel ride the future's
    ``_ptpu_gen_info`` (``tokens_generated`` + ``partial_tokens``)."""

    def __init__(self, request_id: str, tokens_generated: int):
        super().__init__(
            f"request {request_id or '<anonymous>'} cancelled after "
            f"{tokens_generated} generated token(s)")
        self.request_id = request_id
        self.tokens_generated = tokens_generated


def _default_buckets(max_len: int) -> tuple:
    """Powers of two from 8 up to AND INCLUDING max_len."""
    out, b = [], 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(sorted(set(out)))


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet — see ROADMAP.md")


def _attach_page_meta(caches, **meta):
    """Attach block-table / write-gate tensors (``bt``, ``live``,
    ``wlen``) to every per-layer pool dict, in place; returns ``caches``.
    Pair every call with ``_strip_page_meta``."""
    for kc, vc in caches:
        kc.update(meta)
        vc.update(meta)
    return caches


def _strip_page_meta(caches):
    """Inverse of ``_attach_page_meta``: drop everything but the pool
    leaves (``pages``, ``scale``) from every per-layer dict, in place."""
    for kc, vc in caches:
        for d in (kc, vc):
            for key in [k for k in d if k not in ("pages", "scale")]:
                del d[key]
    return caches


@dataclass
class _Request:
    prompt: np.ndarray           # [P] int64
    max_new_tokens: int
    eos_token_id: Optional[int]
    seed: int = 0                # sampling key: prng_key(seed)
    future: Future = field(default_factory=Future)
    rid: str = ""
    cancelled: bool = False      # cancel() flagged; retired at the next
    #                              tick boundary
    drafted: int = 0             # speculative: tokens proposed for me
    accepted: int = 0            # speculative: proposals accepted


class _Slot:
    """Host-side mirror of one decode slot."""

    __slots__ = ("req", "pos", "tok", "alive", "remaining", "emitted",
                 "pages")

    def __init__(self):
        self.req: Optional[_Request] = None
        self.pos = 0
        self.tok = 0
        self.alive = False
        self.remaining = 0
        self.emitted: List[int] = []
        self.pages: List[int] = []   # paged mode: owned page refs

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousBatchingEngine:
    """Serve concurrent mixed-length generate requests, greedy or
    sampled, through one slot cache or paged pool (see the module
    docstring). Outputs are token-identical to sequential ``generate()``
    per request (with the request's seed when sampling), in every mode.
    Speculative decoding is greedy-only: with ``do_sample`` it raises
    ``ValueError``, as paddle_tpu's engine does.

    ``model`` must already live on ``device`` — the card when ``device``
    is omitted (raises without one); ``device="cpu"`` for the CPU, where
    the kernels run their plain versions.
    """

    def __init__(self, model, slots: Optional[int] = None,
                 max_len: Optional[int] = None,
                 cache_dtype: str = "bfloat16",
                 prefill_buckets: Optional[tuple] = None,
                 tick_tokens: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 paged: Optional[bool] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = True, speculative=None,
                 spec_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None, draft_model=None,
                 tp: Optional[int] = None, mesh=None,
                 comm_precision: Optional[str] = None, device=None):
        if draft_model is not None:
            _not_ported("draft-model speculation (draft_model=)")
        if ((tp is not None and tp != 1) or mesh is not None
                or comm_precision is not None):
            _not_ported("tensor parallelism (tp=/mesh=/comm_precision=)")
        self._spec = resolve_speculative(speculative, spec_k, spec_ngram)
        if self._spec is not None and do_sample:
            raise ValueError(
                "speculative decoding is greedy-only (acceptance is exact "
                "token equality against the target argmax); do_sample "
                "engines must run plain decode")
        self._sampling = (bool(do_sample), float(temperature), int(top_k),
                          float(top_p))
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine device "
                             f"is {self.device}")
        self.model = model
        self.slots = int(slots if slots is not None
                         else int_env("PADDLE_TPU_SERVE_SLOTS", 8))
        if self.slots < 2:
            raise ValueError("engine needs >= 2 slots")
        model_max = model.cfg.max_seq_len
        self.max_len = int(max_len if max_len is not None else model_max)
        if self.max_len > model_max:
            raise ValueError(f"max_len {self.max_len} exceeds the model's "
                             f"max_seq_len {model_max}")
        if prefill_buckets is None:
            spec = os.environ.get("PADDLE_TPU_SERVE_PREFILL_BUCKETS", "")
            prefill_buckets = (tuple(int(x) for x in spec.split(",")
                                     if x.strip())
                               if spec else _default_buckets(self.max_len))
        self.prefill_buckets = tuple(sorted(
            b for b in prefill_buckets if b <= self.max_len))
        if not self.prefill_buckets:
            raise ValueError("no prefill bucket fits max_len")
        self.tick_tokens = int(
            tick_tokens if tick_tokens is not None
            else int_env("PADDLE_TPU_SERVE_TICK_TOKENS", 8))
        if self.tick_tokens < 1:
            raise ValueError("tick_tokens must be >= 1")
        self.max_queue = int(max_queue if max_queue is not None
                             else int_env("PADDLE_TPU_SERVE_MAX_QUEUE", 32))
        self.cache_dtype = cache_dtype
        # worst-case tokens a slot runs past its budget in one tick:
        # tick_tokens plain, k + 1 per verify — which also bounds the
        # cache positions a verify block writes
        self._overshoot = (max(self.tick_tokens, self._spec.k + 1)
                           if self._spec is not None else self.tick_tokens)
        self._proposer = (NGramProposer(self._spec.k, self._spec.ngram_max,
                                        self._spec.ngram_min)
                          if self._spec is not None else None)
        self.spec_ticks = 0           # verify forwards
        self.tokens_drafted = 0
        self.tokens_accepted = 0      # drafted tokens that matched
        self.tokens_rejected = 0
        self.spec_tokens_emitted = 0  # tokens consumed off verify ticks
        self.spec_slot_ticks = 0      # live (slot, verify tick) pairs

        self.paged = bool(int_env("PADDLE_TPU_SERVE_PAGED", 0)
                          if paged is None else paged)
        self.page_size = int(page_size if page_size is not None
                             else int_env("PADDLE_TPU_KV_PAGE", 16))
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        # block-table width: enough pages for one max_len request
        self.pages_per_slot = pages_needed(self.max_len, self.page_size)
        if num_pages is None:
            num_pages = (int_env("PADDLE_TPU_SERVE_NUM_PAGES", 0)
                         or self.slots * self.pages_per_slot)
        self.num_pages = int(num_pages)
        self.prefix_cache = bool(prefix_cache)
        self._pool_blocked = False    # last admission failed on pages
        self.prefix_hits = 0          # admissions with >= 1 trie page
        self.prefix_misses = 0
        self.prefix_tokens_saved = 0  # prompt tokens NOT re-prefilled
        self.prefill_tokens = 0       # prompt tokens actually prefilled
        model.eval()
        with torch.no_grad():
            if self.paged:
                if self.num_pages < self.pages_per_slot:
                    raise ValueError(
                        f"num_pages {self.num_pages} cannot hold even one "
                        f"max_len request ({self.pages_per_slot} pages)")
                self._allocator = PageAllocator(self.num_pages)
                self._trie = PrefixTrie(self._allocator)
                self._caches = model.new_paged_cache(
                    self.num_pages, self.page_size, cache_dtype)
                self._block_tables = np.zeros(
                    (self.slots, self.pages_per_slot), np.int64)
            else:
                self._allocator = self._trie = self._block_tables = None
                self._caches = model.new_cache(self.slots, self.max_len,
                                               cache_dtype)
        self._slots = [_Slot() for _ in range(self.slots)]
        self._queue: List[_Request] = []
        self._cv = threading.Condition()
        self._stop_flag = False
        self._broken: Optional[BaseException] = None
        self.ticks = 0
        self.admitted = 0
        self.completed = 0
        self.cancelled = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cb-engine")
        self._thread.start()

    # -- public API ------------------------------------------------------
    def submit(self, input_ids, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, seed: int = 0,
               request_id: Optional[str] = None) -> Future:
        """Queue one request; returns a Future resolving to an int64
        [prompt_len + max_new_tokens] array, eos-padded after finish —
        one row of ``generate()``. ``seed`` keys a sampling engine's draws
        for this request (ignored when greedy). ``request_id`` is the
        handle ``cancel`` takes."""
        prompt = np.asarray(input_ids).astype(np.int64).reshape(-1)
        P = prompt.shape[0]
        if P < 1:
            raise ValueError("empty prompt")
        if P > self.prefill_buckets[-1]:
            raise ValueError(
                f"prompt length {P} exceeds the largest prefill bucket "
                f"{self.prefill_buckets[-1]}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        vocab = self.model.cfg.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"token ids must lie in [0, {vocab})")
        # a row retires only at a tick boundary, so it may run one tick
        # past its budget (a verify tick also writes k rows past pos). In
        # paged mode this bounds a request at pages_per_slot pages, which
        # the pool always holds: a request that passes can wait for pages
        worst = P + max_new_tokens + self._overshoot
        if worst > self.max_len:
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({max_new_tokens}) + "
                f"tick overshoot ({self._overshoot}) exceeds the "
                f"engine cache length {self.max_len}")
        req = _Request(prompt, int(max_new_tokens),
                       None if eos_token_id is None else int(eos_token_id),
                       int(seed), rid=str(request_id) if request_id else "")
        with self._cv:
            if self._broken is not None:
                raise RuntimeError("engine is broken") from self._broken
            if self._stop_flag:
                raise RuntimeError("engine stopped")
            if len(self._queue) >= self.max_queue:
                if self.paged and self._pool_is_binding_locked():
                    # admission waits on PAGES, not slots: shed with the
                    # reason that tells operators to size the pool
                    raise CacheExhausted(
                        len(self._queue), self.max_queue,
                        self._allocator.free_pages, self.num_pages)
                raise EngineOverloaded(len(self._queue), self.max_queue)
            self._queue.append(req)
            self._cv.notify()
        return req.future

    def _pool_is_binding_locked(self) -> bool:
        """Is the page pool (not slots or request rate) what blocks the
        queue? True once an admission failed on pages, or when a slot is
        free but the head request needs more pages than the free list
        plus every trie-only page could give. Callers hold ``_cv``."""
        if self._pool_blocked:
            return True
        if not self._queue or not any(s.free for s in self._slots):
            return False
        head = self._queue[0]
        need = pages_needed(head.prompt.shape[0] + head.max_new_tokens
                            + self._overshoot, self.page_size)
        return need > self._allocator.free_pages + self._trie.reclaimable()

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience wrapper over submit()."""
        return self.submit(input_ids, max_new_tokens, eos_token_id,
                           seed).result(timeout)

    def cancel(self, request_id: Optional[str]) -> bool:
        """Cancel the request carrying ``request_id``. A queued request
        resolves now (its future raises RequestCancelled, zero tokens);
        an admitted one is retired at the next tick boundary with its
        partial result attached. Returns True when a request matched."""
        if not request_id:
            return False
        rid = str(request_id)
        victim = None
        with self._cv:
            for i, req in enumerate(self._queue):
                if req.rid == rid:
                    victim = self._queue.pop(i)
                    break
            if victim is None:
                for s in self._slots:
                    if (s.req is not None and s.req.rid == rid
                            and not s.req.cancelled):
                        s.req.cancelled = True
                        self._cv.notify()
                        return True
                return False
            self.cancelled += 1
        victim.future._ptpu_gen_info = {"tokens_generated": 0,
                                        "partial_tokens": []}
        if not victim.future.done():
            victim.future.set_exception(RequestCancelled(rid, 0))
        return True

    def stats(self) -> dict:
        """Slot occupancy, queue, lifetime counters, the paged pool and
        prefix-cache fields (paged mode), the speculative counters
        (speculative mode) and the launch counts of the kernels on this
        engine's cache path (process-wide counters)."""
        with self._cv:
            active = sum(1 for s in self._slots if not s.free)
            queued = len(self._queue)
            cancelled = self.cancelled
        out = {"slots": self.slots, "active": active,
               "free": self.slots - active, "queued": queued,
               "max_queue": self.max_queue, "ticks": self.ticks,
               "admitted": self.admitted, "completed": self.completed,
               "cancelled": cancelled, "tick_tokens": self.tick_tokens,
               "prefill_buckets": list(self.prefill_buckets),
               "max_len": self.max_len, "cache_dtype": self.cache_dtype,
               "paged": self.paged,
               "speculative": self._spec.kind if self._spec else None,
               "device": str(self.device)}
        if self.paged:
            out["kernel_launches"] = {
                "kv_paged_write": kv_paged_write.launches}
        else:
            out["kernel_launches"] = {
                "mega_decode_step": mega_decode_step.launches,
                "kv_slot_write": kv_slot_write.launches}
        if self._spec is not None:
            drafted = self.tokens_drafted
            out.update({
                "spec_k": self._spec.k,
                "spec_ticks": self.spec_ticks,
                "tokens_drafted": drafted,
                "tokens_accepted": self.tokens_accepted,
                "tokens_rejected": self.tokens_rejected,
                "acceptance_rate": round(self.tokens_accepted / drafted, 4)
                if drafted else 0.0,
                # tokens emitted per slot per verify forward (1.0 = no
                # better than one token per forward)
                "accepted_tokens_per_tick": round(
                    self.spec_tokens_emitted / self.spec_slot_ticks, 4)
                if self.spec_slot_ticks else 0.0})
        if self.paged:
            free_p = self._allocator.free_pages
            used_p = self._allocator.used_pages
            lookups = self.prefix_hits + self.prefix_misses
            out.update({
                "page_size": self.page_size,
                "pages_total": self.num_pages,
                "pages_free": free_p,
                "pages_used": used_p,
                "pages_cached_prefix": self._trie.pages_cached,
                "page_utilization": round(used_p / self.num_pages, 4),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_rate": round(self.prefix_hits / lookups, 4)
                if lookups else 0.0,
                "prefix_tokens_saved": self.prefix_tokens_saved,
                "prefill_tokens": self.prefill_tokens})
            # chained crc32 per cached trie node, for a router's prefix
            # affinity; the walk races the engine loop's inserts, and a
            # torn read costs one poll's freshness only
            try:
                out["prefix_fingerprints"] = self._trie.fingerprints()
            except RuntimeError:
                out["prefix_fingerprints"] = []
        return out

    @property
    def broken(self) -> Optional[BaseException]:
        return self._broken

    def stop(self):
        with self._cv:
            self._stop_flag = True
            self._cv.notify()
        self._thread.join(timeout=30)
        self._fail_all(RuntimeError("engine stopped"))

    # -- engine loop -----------------------------------------------------
    def _loop(self):
        with torch.no_grad():
            while True:
                with self._cv:
                    while (not self._stop_flag and not self._queue
                           and all(s.free for s in self._slots)):
                        self._cv.wait(timeout=1.0)
                    if self._stop_flag:
                        return
                try:
                    self._sweep_cancelled()
                    self._admit_ready()
                    if any(not s.free for s in self._slots):
                        self._tick()
                    else:
                        with self._cv:
                            if self._queue and self._pool_blocked:
                                # nothing to tick (so nothing retires to
                                # free pages) while the head request waits
                                # on the pool: yield instead of spinning
                                self._cv.wait(timeout=0.05)
                except BaseException as e:   # noqa: BLE001 — fail loudly:
                    # every waiter gets the error, submit() refuses after
                    with self._cv:
                        self._broken = e
                    self._fail_all(e)
                    return

    def _sweep_cancelled(self):
        with self._cv:
            idxs = [i for i, s in enumerate(self._slots)
                    if s.req is not None and s.req.cancelled]
        for i in idxs:
            self._retire(i)

    def _fail_all(self, exc: BaseException):
        with self._cv:
            pending = [(req, []) for req in self._queue]
            self._queue.clear()
            for s in self._slots:
                if not s.free:
                    req, s.req = s.req, None
                    s.alive = False
                    pending.append((req, list(s.emitted)))
        for req, emitted in pending:
            if req.future.done():
                continue
            req.future._ptpu_gen_info = {
                "tokens_generated": len(emitted),
                "partial_tokens": [int(t) for t in emitted]}
            req.future.set_exception(exc)

    def _admit_ready(self):
        while True:
            with self._cv:
                slot_idx = next((i for i, s in enumerate(self._slots)
                                 if s.free), None)
                if slot_idx is None or not self._queue:
                    return
                req = self._queue.pop(0)
            if not self._admit(req, slot_idx):
                # the pool cannot cover the head request yet: put it back
                # at the front (FIFO; admitting around it would starve
                # large requests) until a retire or eviction frees pages
                with self._cv:
                    self._queue.insert(0, req)
                return

    def _bucket_for(self, P: int) -> int:
        for b in self.prefill_buckets:
            if P <= b:
                return b
        raise ValueError(f"prompt length {P} exceeds largest bucket")

    def _slot_view(self, b: int):
        """Per-layer batch-1 views of slot ``b``'s cache rows."""
        def row(leaf):
            if isinstance(leaf, dict):
                return {k: t[b:b + 1] for k, t in leaf.items()}
            return leaf[b:b + 1]
        return [(row(kc), row(vc)) for kc, vc in self._caches]

    def _padded_ids(self, tokens):
        """[1, bucket] int64 ids on the device: ``tokens`` right-padded
        with zeros to the nearest prefill bucket."""
        ids = np.zeros((1, self._bucket_for(tokens.shape[0])), np.int64)
        ids[0, :tokens.shape[0]] = tokens
        return torch.from_numpy(ids).to(self.device)

    def _admit(self, req: _Request, b: int) -> bool:
        """Admit ``req`` into slot ``b`` and take its first token; False
        when the paged pool cannot cover it yet (nothing changed)."""
        P = req.prompt.shape[0]
        if self.paged:
            tok0 = self._admit_paged(req, b)
            if tok0 is None:
                return False
        else:
            # reset slot b's rows, prefill the bucketed prompt into them
            view = self._slot_view(b)
            for kc, vc in view:
                for leaf in (kc, vc):
                    for t in (leaf.values() if isinstance(leaf, dict)
                              else (leaf,)):
                        t.zero_()
            logits, _ = self.model(self._padded_ids(req.prompt), view, 0)
            tok0 = self._first_token(logits[:, P - 1], req)
        slot = self._slots[b]
        slot.req = req
        slot.pos = P
        slot.tok = tok0
        slot.emitted = [tok0]
        slot.remaining = req.max_new_tokens - 1
        slot.alive = req.eos_token_id is None or tok0 != req.eos_token_id
        self.admitted += 1
        if slot.remaining <= 0 or not slot.alive:
            self._retire(b)
        return True

    def _first_token(self, last, req: _Request) -> int:
        """The admission's token from its last prompt position's logits
        ``[1, V]``, drawn with the request's own key ``prng_key(seed)``
        (decode draws fold the position in); one host sync."""
        key = prng_key(req.seed, self.device) if self._sampling[0] else None
        return int(_select_token(last, key, *self._sampling)[0])

    def _copy_page(self, src: int, dst: int):
        """Copy-on-write: duplicate physical page ``src`` into ``dst`` in
        every layer's pool leaves (int8 scale planes included)."""
        for kc, vc in self._caches:
            for leaf in (*kc.values(), *vc.values()):
                leaf[dst].copy_(leaf[src])

    def _admit_paged(self, req: _Request, b: int) -> Optional[int]:
        """Paged admission: prefix-trie match, page allocation (evicting
        trie-only pages under pressure), tail-page copy-on-write when the
        whole prompt matched, then one prefill of the un-cached suffix
        straight into the slot's pages. Returns the first token, or None
        when the pool cannot cover the request yet (pool state rolled back
        exactly)."""
        prompt, ps = req.prompt, self.page_size
        P = prompt.shape[0]
        n_complete = P // ps          # prompt pages shareable read-only
        page_keys = [tuple(int(t) for t in prompt[j * ps:(j + 1) * ps])
                     for j in range(n_complete)]
        matched = self._trie.match(page_keys) if self.prefix_cache else []
        m = len(matched)
        cow_src = None
        if n_complete and m == n_complete and P % ps == 0:
            # every prompt page is cached: prefill only the LAST token (its
            # logits seed decode), into a private copy of the tail page
            cow_src = matched[-1]
            shared = matched[:-1]
            M = P - 1
        else:
            shared = matched
            M = m * ps
        total = pages_needed(P + req.max_new_tokens + self._overshoot, ps)
        # pin the matched pages before any eviction below
        self._allocator.incref(shared)
        need_priv = total - len(shared)
        priv = self._allocator.alloc(need_priv)
        if priv is None:
            self._trie.evict(need_priv - self._allocator.free_pages)
            priv = self._allocator.alloc(need_priv)
        if priv is None:
            self._allocator.decref(shared)      # exact rollback
            self._pool_blocked = True
            return None
        self._pool_blocked = False
        pages = list(shared) + priv           # logical page j = pages[j]
        self._block_tables[b] = 0
        self._block_tables[b, :len(pages)] = pages
        if cow_src is not None:
            self._copy_page(cow_src, pages[n_complete - 1])
        suffix = prompt[M:]
        S = suffix.shape[0]
        bt = torch.from_numpy(self._block_tables[b:b + 1]).to(self.device)
        caches = _attach_page_meta(self._caches, bt=bt, wlen=S)
        try:
            logits, _ = self.model(self._padded_ids(suffix), caches, M)
        finally:
            _strip_page_meta(self._caches)
        tok0 = self._first_token(logits[:, S - 1], req)
        self._slots[b].pages = pages
        if self.prefix_cache:
            # freshly computed complete pages become shareable; cached
            # keys are left as they are (the COW copy never enters)
            self._trie.insert(page_keys, pages[:n_complete])
        if m:
            self.prefix_hits += 1
            self.prefix_tokens_saved += M
        else:
            self.prefix_misses += 1
        self.prefill_tokens += S
        return tok0

    def _tick(self):
        """One tick: plain decode, or — speculative — draft then verify.
        A speculative engine whose slots have nothing to draft runs the
        plain tick (tick_tokens per forward) instead of a verify forward
        that can emit only one token per slot."""
        if self._spec is None:
            self._tick_decode()
            return
        props, dlen = self._propose_all()
        if dlen.any():
            self._tick_verify(props, dlen)
        else:
            self._tick_decode()

    def _propose_all(self):
        """(props [N, k] int32, dlen [N] int32): host n-gram drafts for
        every busy slot."""
        N, K = self.slots, self._spec.k
        props = np.zeros((N, K), np.int32)
        dlen = np.zeros(N, np.int32)
        for i, s in enumerate(self._slots):
            if s.free:
                continue
            ctx = np.concatenate([s.req.prompt,
                                  np.asarray(s.emitted, np.int64)])
            props[i], dlen[i] = self._proposer.propose(ctx)
        return props, dlen

    def _tick_inputs(self):
        """Host arrays of the busy slots' state: (tok, pos, live, eos)."""
        N = self.slots
        tok = np.zeros(N, np.int32)
        pos = np.zeros(N, np.int32)
        live = np.zeros(N, bool)
        eos = np.full(N, -1, np.int32)
        for i, s in enumerate(self._slots):
            if s.free:
                continue
            tok[i] = s.tok
            pos[i] = s.pos
            live[i] = s.alive and s.remaining > 0
            if s.req.eos_token_id is not None:
                eos[i] = s.req.eos_token_id
        return tok, pos, live, eos

    def _consume(self, i: int, toks) -> int:
        """Append slot ``i``'s new tokens from ``toks`` (in order) until
        its budget or eos ends it; advance its position. Returns how many
        it took."""
        s = self._slots[i]
        n = 0
        for token in toks:
            if s.remaining <= 0 or not s.alive:
                break
            token = int(token)
            s.emitted.append(token)
            s.remaining -= 1
            n += 1
            if s.req.eos_token_id is not None and token == s.req.eos_token_id:
                s.alive = False
        s.pos += n
        s.tok = s.emitted[-1]
        return n

    def _tick_verify(self, props, dlen):
        """One draft -> verify tick: ONE forward scores all k+1 positions
        for every slot; each live slot consumes its accepted prefix plus
        the correction token (1..k+1 tokens), all target argmaxes."""
        tok, pos, live, _ = self._tick_inputs()
        dev = self.device
        args = [torch.from_numpy(a).to(dev) for a in (tok, pos, props,
                                                      dlen)]
        if self.paged:
            caches = _attach_page_meta(
                self._caches,
                bt=torch.from_numpy(self._block_tables).to(dev),
                live=torch.from_numpy(live).to(dev))
        else:
            caches = self._caches
        try:
            toks_d, acc_d = verify_step(self.model, caches, *args)
        finally:
            if self.paged:
                _strip_page_meta(self._caches)
        toks = toks_d.cpu().numpy()               # one host sync per tick
        n_acc = acc_d.cpu().numpy()
        self.ticks += 1
        self.spec_ticks += 1
        for i, s in enumerate(self._slots):
            if s.free or not live[i]:
                continue
            drafted, accepted = int(dlen[i]), int(n_acc[i])
            self.tokens_drafted += drafted
            self.tokens_accepted += accepted
            self.tokens_rejected += drafted - accepted
            s.req.drafted += drafted
            s.req.accepted += accepted
            # rejected positions' rows sit above the new pos and are
            # overwritten before any query attends them: no rollback
            self.spec_tokens_emitted += self._consume(
                i, toks[i, :accepted + 1])
            self.spec_slot_ticks += 1
            if s.remaining <= 0 or not s.alive:
                self._retire(i)

    def _tick_decode(self):
        tok, pos, live, eos = self._tick_inputs()
        dev = self.device
        tok_d = torch.from_numpy(tok).to(dev)
        pos_d = torch.from_numpy(pos).to(dev)
        live_d = torch.from_numpy(live).to(dev)
        eos_d = torch.from_numpy(eos).to(dev)
        bt_d = (torch.from_numpy(self._block_tables).to(dev) if self.paged
                else None)
        do_sample = self._sampling[0]
        if do_sample:
            # each busy slot's request key; the position is folded in on
            # the device, micro-step by micro-step
            keys = np.zeros((self.slots, 2), np.int64)
            for i, s in enumerate(self._slots):
                if not s.free:
                    keys[i] = prng_key(s.req.seed).numpy()
            keys_d = torch.from_numpy(keys).to(dev)
        zero = torch.zeros_like(tok_d)
        emitted = []
        for _ in range(self.tick_tokens):
            if self.paged:
                # a dead slot's table may point at pages now owned by
                # another request: the live gate keeps its writes out
                caches = _attach_page_meta(self._caches, bt=bt_d,
                                           live=live_d)
            else:
                caches = self._caches
            try:
                logits, _ = self.model(tok_d[:, None].to(torch.int64),
                                       caches, pos_d)
            finally:
                if self.paged:
                    _strip_page_meta(self._caches)
            sub = fold_in(keys_d, pos_d) if do_sample else None
            nxt = _select_token(logits[:, -1, :], sub,
                                *self._sampling).to(torch.int32)
            nxt = torch.where(live_d, nxt, zero)
            emitted.append(nxt)
            pos_d = pos_d + live_d.to(torch.int32)
            tok_d = torch.where(live_d, nxt, tok_d)
            live_d = live_d & (nxt != eos_d)
        toks = torch.stack(emitted, dim=1).cpu().numpy()   # one sync/tick
        self.ticks += 1
        for i, s in enumerate(self._slots):
            if s.free or not live[i]:
                continue
            self._consume(i, toks[i])
            if s.remaining <= 0 or not s.alive:
                self._retire(i)

    def _retire(self, b: int):
        slot = self._slots[b]
        with self._cv:
            req, slot.req = slot.req, None
            slot.alive = False
            if self.paged and slot.pages:
                # drop this request's references: pages another slot or
                # the trie still holds survive, the rest free. The zeroed
                # table row reads page 0 — harmless, since a dead slot is
                # write-gated and its reads are masked
                self._allocator.decref(slot.pages)
                slot.pages = []
                self._block_tables[b] = 0
                self._pool_blocked = False    # freed pages: retry the head
        out = list(slot.emitted)
        info = {"tokens_generated": len(out)}
        if self._spec is not None:
            info["tokens_drafted"] = req.drafted
            info["tokens_accepted"] = req.accepted
        if req.cancelled:
            info["partial_tokens"] = [int(t) for t in out]
            req.future._ptpu_gen_info = info
            with self._cv:
                self.cancelled += 1
            if not req.future.done():
                req.future.set_exception(RequestCancelled(req.rid, len(out)))
            return
        req.future._ptpu_gen_info = info
        if len(out) < req.max_new_tokens:
            out += [req.eos_token_id] * (req.max_new_tokens - len(out))
        result = np.concatenate([req.prompt, np.asarray(out, np.int64)])
        self.completed += 1
        if not req.future.done():
            req.future.set_result(result)
