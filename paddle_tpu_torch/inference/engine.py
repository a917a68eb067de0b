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

Speculative mode (``speculative.py``): each tick drafts up to k tokens
per slot and, when any slot has a draft, runs ONE verify forward of
``[tok, d1..dk]`` for every slot instead of the plain tick; the emitted
tokens are the target's own argmax, so output is token-identical to plain
decode. ``"ngram"`` drafts on the host. ``"draft"`` drafts with
``draft_model`` (``DraftModelProposer``, its own f32 slot cache on the
engine's device): every admission, slot or paged, also prefills the
whole prompt into the draft's row for the slot (with a prefix hit the
target prefills only the suffix), and every busy slot drafts k each tick,
so every tick of a draft engine is a verify tick. Slot verify writes
its k+1 rows per slot as plain tensor code; paged verify through
``kv_paged_write`` (N·(k+1) rows a half per launch).

Scan-stacked models (``scan_layers``) keep one stacked (k_stack,
v_stack) pair (``[L, N, max_len, ...]`` slots, ``[L, NP, PS, ...]``
pools): a slot's rows and a page lie on axis 1 there, axis 0 for the
per-layer caches, and the block table and write gates attached to a
stacked pool are shared by its layers.

Streaming: ``submit(..., progress_cb=cb)`` calls ``cb(tokens)`` from the
engine thread with each new block of a request's tokens — its first token
at admission, then what each tick (or verify tick) emitted for it; a
raising callback is dropped, never the loop. ``cancel(request_id)``
retires a request at the next tick boundary with its partial result.

Observability (``paddle_tpu_torch.obs``, on unless ``PADDLE_TPU_OBS=0``;
the flag is read once, at construction): paddle_tpu's ``ptpu_engine_*``
series (ticks, admits, retires, cancels, batch occupancy, the queue-wait,
prefill, decode, TTFT and end-to-end histograms in ms; the page-pool and
prefix series on a paged engine, the speculative ones on a speculative
engine; ``ptpu_engine_tick_model_eff``, also ``stats()["tick_model_eff"]``)
and the spans ``engine.queue_wait``, ``engine.prefill``, ``engine.decode``
(carrying the request id, minted when the caller gave none) and
``engine.tick``. Off, the engine allocates and records nothing for them.

Warmup: nothing is compiled ahead of time here, so ``warmup()`` runs one
admission per prefill bucket and one tick (and one verify tick on a
speculative engine) on a scratch slot, which builds the kernels and
initialises cuBLAS before the first request, then leaves the caches and
the counters as a fresh engine's. ``compiled_program_count`` counts the
distinct (program kind, bucket) pairs the engine has run: constant once
warm, whatever prompt lengths arrive.

Not ported yet (ROADMAP.md): tensor parallelism, warmup through an
executable store (``store=``).

Env knobs as paddle_tpu's: PADDLE_TPU_SERVE_SLOTS (default 8),
PADDLE_TPU_SERVE_PREFILL_BUCKETS (comma list, default powers of two),
PADDLE_TPU_SERVE_TICK_TOKENS (default 8), PADDLE_TPU_SERVE_MAX_QUEUE
(default 32), PADDLE_TPU_SERVE_PAGED (default 0), PADDLE_TPU_KV_PAGE
(page size, default 16), PADDLE_TPU_SERVE_NUM_PAGES (default slots *
ceil(max_len / page_size)), PADDLE_TPU_SERVE_SPEC ("ngram" or "draft",
default off),
PADDLE_TPU_SERVE_SPEC_K (default 4), PADDLE_TPU_SERVE_SPEC_NGRAM (default
3).
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .. import obs as _obs
from ..device import resolve_device
from ..distributed import resilience as _resil
from ..framework.env import int_env
from ..kernels.cache_write import kv_paged_write, kv_slot_write
from ..kernels.mega_decode import mega_decode_step
from ..models.generation import (_select_token, cache_leaves, fold_in,
                                 prng_key)
from ..obs import efficiency as _eff
from .paging import PageAllocator, PrefixTrie, pages_needed
from .speculative import (DraftModelProposer, NGramProposer,
                          resolve_speculative, verify_step)

__all__ = ["ContinuousBatchingEngine", "EngineOverloaded",
           "CacheExhausted", "RequestCancelled", "GenerationPredictor",
           "create_engine_predictor"]


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


def _stacked(caches) -> bool:
    """A scan-stacked (k_stack, v_stack) pair, not per-layer pairs."""
    return isinstance(caches, tuple)


def _halves(caches):
    """The cache halves: every layer's k and v, or the two stacked
    ones."""
    return list(caches) if _stacked(caches) else [
        half for pair in caches for half in pair]


def _attach_page_meta(caches, **meta):
    """Attach block-table / write-gate tensors (``bt``, ``live``,
    ``wlen``) to every pool dict, in place (a stacked pool's layers share
    them); returns ``caches``. Pair every call with
    ``_strip_page_meta``."""
    for d in _halves(caches):
        d.update(meta)
    return caches


def _strip_page_meta(caches):
    """Inverse of ``_attach_page_meta``: drop everything but the pool
    leaves (``pages``, ``scale``) from every pool dict, in place."""
    for d in _halves(caches):
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
    rid: str = ""                # request id (cancel handle, obs spans)
    t_submit: float = 0.0        # perf_counter at submit (obs only)
    progress_cb: Optional[object] = None   # per-block streaming hook
    cancelled: bool = False      # cancel() flagged; retired at the next
    #                              tick boundary
    drafted: int = 0             # speculative: tokens proposed for me
    accepted: int = 0            # speculative: proposals accepted


class _Slot:
    """Host-side mirror of one decode slot."""

    __slots__ = ("req", "pos", "tok", "alive", "remaining", "emitted",
                 "pages", "t_dec0")

    def __init__(self):
        self.req: Optional[_Request] = None
        self.pos = 0
        self.tok = 0
        self.alive = False
        self.remaining = 0
        self.emitted: List[int] = []
        self.pages: List[int] = []   # paged mode: owned page refs
        self.t_dec0 = 0.0            # decode-phase start (obs only)

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
        if ((tp is not None and tp != 1) or mesh is not None
                or comm_precision is not None):
            _not_ported("tensor parallelism (tp=/mesh=/comm_precision=)")
        self._spec = resolve_speculative(speculative, spec_k, spec_ngram,
                                         draft_model)
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
        self._proposer = None
        if self._spec is not None and self._spec.kind == "draft":
            draft = self._spec.draft_model
            if draft.device != self.device:
                raise ValueError(f"draft model lives on {draft.device}, "
                                 f"engine device is {self.device}")
            # an f32 draft cache whatever the target's, as paddle_tpu's
            self._proposer = DraftModelProposer(
                draft, self.slots, self.max_len, self._spec.k,
                cache_dtype="float32")
        elif self._spec is not None:
            self._proposer = NGramProposer(self._spec.k,
                                           self._spec.ngram_max,
                                           self._spec.ngram_min)
        self._draft = isinstance(self._proposer, DraftModelProposer)
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
        self._cv = _obs.make_condition("engine.cv")
        self._stop_flag = False
        self._broken: Optional[BaseException] = None
        self.ticks = 0
        self.admitted = 0
        self.completed = 0
        self.cancelled = 0
        # (program kind, bucket) pairs run so far: compiled_program_count
        self._programs = set()
        self._warmed = False
        self._warmup_lock = _obs.make_lock("engine.warmup")
        self._warm_job = None         # a warmup() waiting for the loop
        # last tick's modeled bytes/s as a fraction of the card's HBM
        # bandwidth (0.0 before a tick, or with obs off)
        self.last_tick_model_eff = 0.0
        self._obs = _obs.enabled()
        if self._obs:
            self._init_obs()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cb-engine")
        self._thread.start()

    def _init_obs(self):
        """Register paddle_tpu's engine series (names, help strings,
        buckets and the paged / speculative conditions as its engine's)
        and price one tick's modeled bytes."""
        reg = _obs.metrics.registry
        self._g_mesh_devices = reg.gauge(
            "ptpu_engine_mesh_devices",
            "devices in this engine's mesh slice (1 = single-chip; "
            "the tier sum over replicas is total serving chips)")
        self._g_mesh_devices.set(1)
        self._m_ticks = reg.counter(
            "ptpu_engine_ticks_total", "batched decode ticks")
        self._m_admits = reg.counter(
            "ptpu_engine_admits_total", "requests admitted to slots")
        self._m_retires = reg.counter(
            "ptpu_engine_retires_total", "requests retired")
        self._m_cancels = reg.counter(
            "ptpu_engine_cancels_total",
            "requests cancelled (queued or mid-decode; slot and "
            "pages reclaimed)")
        self._m_occupancy = reg.histogram(
            "ptpu_engine_batch_occupancy", "live slots per decode tick",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128))
        self._m_queue_wait = reg.histogram(
            "ptpu_engine_queue_wait_ms", "submit -> admission start")
        self._m_prefill = reg.histogram(
            "ptpu_engine_prefill_ms",
            "admission program incl. first-token sync")
        self._m_decode = reg.histogram(
            "ptpu_engine_decode_ms", "first token -> retirement")
        self._m_ttft = reg.histogram(
            "ptpu_engine_ttft_ms", "submit -> first token")
        self._m_e2e = reg.histogram(
            "ptpu_engine_e2e_ms", "submit -> retirement")
        if self.paged:
            self._g_pages_free = reg.gauge(
                "ptpu_engine_pages_free", "KV pool pages free")
            self._g_pages_used = reg.gauge(
                "ptpu_engine_pages_used", "KV pool pages in use")
            self._set_page_gauges()
            self._m_prefix_hits = reg.counter(
                "ptpu_engine_prefix_hits_total",
                "admissions reusing >=1 cached prefix page")
            self._m_prefix_misses = reg.counter(
                "ptpu_engine_prefix_misses_total",
                "admissions with no cached prefix page")
        if self._spec is not None:
            self._m_spec_ticks = reg.counter(
                "ptpu_engine_spec_ticks_total",
                "draft->verify tick dispatches")
            self._m_spec_drafted = reg.counter(
                "ptpu_engine_spec_drafted_total",
                "draft tokens proposed to verify")
            self._m_spec_accepted = reg.counter(
                "ptpu_engine_spec_accepted_total",
                "draft tokens accepted by the target")
            self._m_spec_rejected = reg.counter(
                "ptpu_engine_spec_rejected_total",
                "draft tokens rejected by the target")
            self._m_spec_per_tick = reg.histogram(
                "ptpu_engine_spec_accepted_per_tick",
                "tokens emitted per slot per verify tick "
                "(accepted prefix + correction)",
                buckets=tuple(range(0, self._spec.k + 2)))
        # one tick's modeled bytes (obs.efficiency), priced once: the
        # per-tick cost is a division and a gauge set
        geom = {"tick_tokens": self.tick_tokens,
                "param_bytes": _eff.tree_nbytes(
                    [*self.model.parameters(), *self.model.buffers()]),
                "kv_cache_bytes": _eff.tree_nbytes(self._caches)}
        if self.paged:
            # per page of each pool leaf (a stacked leaf holds its
            # layers' pages on axis 1), times the pages the view gathers
            stk = _stacked(self._caches)
            geom["kv_view_bytes"] = sum(
                leaf.nbytes // leaf.shape[int(stk)] * self.pages_per_slot
                * self.slots for leaf in cache_leaves(self._caches))
        self._tick_model_bytes = _eff.modeled_tick_bytes(
            "decode_paged" if self.paged else "decode", geom)
        self._verify_model_bytes = (_eff.modeled_tick_bytes("verify", geom)
                                    if self._spec is not None else 0)
        self._eff_chip = _eff.chip_spec()
        self._g_tick_eff = reg.gauge(
            _eff.TICK_EFF_GAUGE,
            "decode tick modeled-bytes/s over measured wall time, "
            "as a fraction of the efficiency chip's HBM bandwidth")

    def _set_page_gauges(self):
        self._g_pages_free.set(self._allocator.free_pages)
        self._g_pages_used.set(self._allocator.used_pages)

    # -- public API ------------------------------------------------------
    def submit(self, input_ids, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, seed: int = 0,
               request_id: Optional[str] = None,
               progress_cb=None) -> Future:
        """Queue one request; returns a Future resolving to an int64
        [prompt_len + max_new_tokens] array, eos-padded after finish —
        one row of ``generate()``. ``seed`` keys a sampling engine's draws
        for this request (ignored when greedy). ``request_id`` is the
        handle ``cancel`` takes and the id of the request's spans (minted
        when absent and obs is on). ``progress_cb(tokens)`` is called from
        the engine thread with each new block of tokens (the first at
        admission, then per tick); it must be fast, and one that raises is
        dropped, never the engine loop."""
        _resil.maybe_inject("serve_backend")   # dead-backend fault site
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
                       int(seed), rid=str(request_id) if request_id else "",
                       progress_cb=progress_cb)
        if self._obs:
            if not req.rid:
                req.rid = uuid.uuid4().hex[:16]
            req.t_submit = time.perf_counter()
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
        # resolve outside the lock: future callbacks never run under it
        victim.future._ptpu_gen_info = {"tokens_generated": 0,
                                        "partial_tokens": []}
        if self._obs:
            self._m_cancels.inc()
        if not victim.future.done():
            victim.future.set_exception(RequestCancelled(rid, 0))
        return True

    def _notify_progress(self, req: _Request, toks) -> None:
        """Hand newly emitted tokens to the request's progress callback
        (on the engine thread). A raising callback is dropped so that it
        cannot take the loop, and every other slot, down."""
        cb = req.progress_cb
        if cb is None:
            return
        try:
            cb([int(t) for t in toks])
        except Exception:   # noqa: BLE001 — a broken stream is the
            req.progress_cb = None   # caller's problem, not the loop's

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
               "cancelled": cancelled,
               "compiled_programs": self.compiled_program_count,
               "tick_tokens": self.tick_tokens,
               "prefill_buckets": list(self.prefill_buckets),
               "max_len": self.max_len, "cache_dtype": self.cache_dtype,
               "paged": self.paged,
               "speculative": self._spec.kind if self._spec else None,
               "tp": 1, "mesh_devices": 1,
               # last tick's modeled bytes/s over the card's bandwidth
               # (0.0 before the first tick, or with obs off)
               "tick_model_eff": round(self.last_tick_model_eff, 6),
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

    @property
    def compiled_program_count(self) -> int:
        """Distinct (program kind, bucket) pairs this engine has run —
        admission per prefill bucket, the decode tick, the verify tick,
        the copy-on-write page copy. paddle_tpu counts XLA traces here;
        the port compiles nothing per shape, and this count plays the same
        part: constant once warm, whatever prompt lengths arrive."""
        return len(self._programs)

    @property
    def warm(self) -> bool:
        """True once ``warmup()`` finished or the first tick ran."""
        return self._warmed or self.ticks > 0

    def warmup(self, buckets: Optional[tuple] = None, store=None) -> list:
        """Run one admission per prefill bucket (``buckets``: the
        engine's when None), one decode tick and, on a speculative engine,
        one verify tick on a scratch slot, so that the kernels are built
        and cuBLAS initialised before the first request. Runs on the
        engine thread once every slot is free (admissions wait for it),
        then leaves the caches, the page pool and every counter as a fresh
        engine's. Returns the buckets it ran. ``store`` (paddle_tpu's
        executable store) is not ported: with CUDA graphs of the tick,
        ROADMAP.md A8."""
        if store is not None:
            _not_ported("warmup through an executable store (store=)")
        bs = sorted({self._bucket_for(int(b)) for b in (
            buckets if buckets is not None else self.prefill_buckets)})
        job = {"buckets": bs, "done": threading.Event(), "error": None}
        with self._warmup_lock:           # one warmup at a time
            with self._cv:
                if self._broken is not None:
                    raise RuntimeError("engine is broken") from self._broken
                if self._stop_flag:
                    raise RuntimeError("engine stopped")
                self._warm_job = job
                self._cv.notify()
            job["done"].wait()
        if job["error"] is not None:
            raise RuntimeError("warmup failed") from job["error"]
        self._warmed = True
        return bs

    def stop(self):
        with self._cv:
            self._stop_flag = True
            self._cv.notify()
        self._thread.join(timeout=30)
        self._fail_all(RuntimeError("engine stopped"))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.stop()
        return False

    # -- engine loop -----------------------------------------------------
    def _loop(self):
        with torch.no_grad():
            while True:
                with self._cv:
                    while (not self._stop_flag and not self._queue
                           and self._warm_job is None
                           and all(s.free for s in self._slots)):
                        self._cv.wait(timeout=1.0)
                    if self._stop_flag:
                        return
                try:
                    self._sweep_cancelled()
                    if (self._warm_job is not None
                            and all(s.free for s in self._slots)):
                        self._run_warmup()
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
            job, self._warm_job = self._warm_job, None
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
        if job is not None:
            job["error"] = exc
            job["done"].set()

    def _run_warmup(self):
        """The pending ``warmup()``, on the engine thread with every slot
        free: slot 0 (paged: pages taken from the pool, evicting cached
        prefixes if it must) is the scratch slot; each bucket's prefill of
        zeros at position 0, then one tick from position 0 with slot 0
        live alone. Afterwards the scratch rows or pages are zeroed and
        the pages returned."""
        job = self._warm_job
        dev = self.device
        scratch = _Request(np.zeros(1, np.int64), 1, None)
        pages = None
        if self.paged:
            need = self.pages_per_slot
            pages = self._allocator.alloc(need)
            if pages is None:
                # no slot holds pages, so only the trie's can be in use
                self._trie.evict(need - self._allocator.free_pages)
                pages = self._allocator.alloc(need)
            self._block_tables[0, :] = pages
        try:
            for b in job["buckets"]:
                ids = torch.zeros((1, b), dtype=torch.int64, device=dev)
                if self.paged:
                    bt = torch.from_numpy(self._block_tables[:1]).to(dev)
                    caches = _attach_page_meta(self._caches, bt=bt, wlen=b)
                    try:
                        logits, _ = self.model(ids, caches, 0)
                    finally:
                        _strip_page_meta(self._caches)
                else:
                    logits, _ = self.model(ids, self._slot_view(0), 0)
                self._first_token(logits[:, b - 1], scratch)
                self._programs.add(("admit", b))
            if self.paged and len(pages) > 1:
                self._copy_page(pages[0], pages[1])
                self._programs.add(("copy_page", 0))
            N = self.slots
            zeros = np.zeros(N, np.int32)
            live = np.zeros(N, bool)
            live[0] = True
            keys = (np.zeros((N, 2), np.int64) if self._sampling[0]
                    else None)
            self._decode_forward(zeros, zeros, live, np.full(N, -1, np.int32),
                                 keys)
            if self._spec is not None:
                dlen = zeros.copy()
                dlen[0] = 1
                self._verify_forward(zeros, zeros, live,
                                     np.zeros((N, self._spec.k), np.int32),
                                     dlen)
            if self._draft:
                # the draft's admissions and one proposal, its cache
                # zeroed after
                self._proposer.warmup(job["buckets"])
                self._programs.update(("draft_admit", b)
                                      for b in job["buckets"])
                self._programs.add(("draft", 0))
        finally:
            leaves = cache_leaves(self._caches)
            if self.paged:
                idx = torch.tensor(pages, dtype=torch.int64, device=dev)
                ax = int(_stacked(self._caches))
                for leaf in leaves:
                    leaf.index_fill_(ax, idx, 0)
                self._block_tables[0] = 0
                self._allocator.decref(pages)
                if self._obs:
                    self._set_page_gauges()
            else:
                for t in leaves:
                    t.zero_()
        with self._cv:
            self._warm_job = None
        job["done"].set()

    def _admit_ready(self):
        while True:
            with self._cv:
                slot_idx = next((i for i, s in enumerate(self._slots)
                                 if s.free), None)
                if (slot_idx is None or not self._queue
                        or self._warm_job is not None):
                    # a pending warmup holds admissions until the slots
                    # drain and it has run
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
        """Batch-1 views of slot ``b``'s cache rows, in the caches' own
        layout (the slot axis is 1 in a stacked leaf)."""
        ax = int(_stacked(self._caches))

        def row(leaf):
            if isinstance(leaf, dict):
                return {k: t.narrow(ax, b, 1) for k, t in leaf.items()}
            return leaf.narrow(ax, b, 1)
        if ax:
            return tuple(row(h) for h in self._caches)
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
        t_adm = time.perf_counter() if self._obs else 0.0
        if self.paged:
            res = self._admit_paged(req, b)
            if res is None:
                return False
            tok0, bucket = res
        else:
            # reset slot b's rows, prefill the bucketed prompt into them
            view = self._slot_view(b)
            for t in cache_leaves(view):
                t.zero_()
            bucket = self._bucket_for(P)
            logits, _ = self.model(self._padded_ids(req.prompt), view, 0)
            tok0 = self._first_token(logits[:, P - 1], req)
            self._programs.add(("admit", bucket))
        if self._draft:
            # the draft's row for this slot gets the WHOLE prompt (with a
            # prefix hit the target prefilled only the suffix)
            self._proposer.admit(b, req.prompt, self._bucket_for(P))
            self._programs.add(("draft_admit", self._bucket_for(P)))
        slot = self._slots[b]
        slot.req = req
        slot.pos = P
        slot.tok = tok0
        slot.emitted = [tok0]
        slot.remaining = req.max_new_tokens - 1
        slot.alive = req.eos_token_id is None or tok0 != req.eos_token_id
        self.admitted += 1
        self._notify_progress(req, [tok0])
        if self._obs:
            # the request's contiguous phases: queue wait (submit ->
            # admission), prefill (admission + the first-token sync), then
            # decode (-> retirement); their sum is the engine's end-to-end
            now = time.perf_counter()
            slot.t_dec0 = now
            self._m_admits.inc()
            self._m_queue_wait.observe((t_adm - req.t_submit) * 1e3)
            self._m_prefill.observe((now - t_adm) * 1e3)
            self._m_ttft.observe((now - req.t_submit) * 1e3)
            _obs.record_span("engine.queue_wait", req.t_submit, t_adm,
                             cat="engine", request_id=req.rid)
            _obs.record_span("engine.prefill", t_adm, now, cat="engine",
                             request_id=req.rid, bucket=bucket,
                             prompt_len=P,
                             ttft_ms=round((now - req.t_submit) * 1e3, 3))
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
        every layer's pool leaves (int8 scale planes included; axis 1 of a
        stacked leaf)."""
        ax = int(_stacked(self._caches))
        for leaf in cache_leaves(self._caches):
            leaf.select(ax, dst).copy_(leaf.select(ax, src))

    def _admit_paged(self, req: _Request, b: int) -> Optional[int]:
        """Paged admission: prefix-trie match, page allocation (evicting
        trie-only pages under pressure), tail-page copy-on-write when the
        whole prompt matched, then one prefill of the un-cached suffix
        straight into the slot's pages. Returns (first token, prefill
        bucket), or None when the pool cannot cover the request yet (pool
        state rolled back exactly)."""
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
            self._programs.add(("copy_page", 0))
        suffix = prompt[M:]
        S = suffix.shape[0]
        bucket = self._bucket_for(S)
        bt = torch.from_numpy(self._block_tables[b:b + 1]).to(self.device)
        caches = _attach_page_meta(self._caches, bt=bt, wlen=S)
        try:
            logits, _ = self.model(self._padded_ids(suffix), caches, M)
        finally:
            _strip_page_meta(self._caches)
        tok0 = self._first_token(logits[:, S - 1], req)
        self._programs.add(("admit", bucket))
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
        if self._obs:
            (self._m_prefix_hits if m else self._m_prefix_misses).inc()
            self._set_page_gauges()
        return tok0, bucket

    def _tick(self):
        """One tick: plain decode, or — speculative — draft then verify.
        A speculative engine whose slots have nothing to draft runs the
        plain tick (tick_tokens per forward) instead of a verify forward
        that can emit only one token per slot."""
        # straggler fault site: wedges this loop (the process stays alive,
        # /healthz answers, only token progress stops)
        _resil.maybe_inject("replica_stall")
        if self._spec is None:
            self._tick_decode()
            return
        props, dlen = self._propose_all()
        if dlen.any():
            self._tick_verify(props, dlen)
        else:
            self._tick_decode()

    def _prev_token(self, s: _Slot) -> int:
        """The true token at ``s.pos - 1`` (the draft sync block's first
        element); ``pos >= prompt length >= 1``, so it exists."""
        P = s.req.prompt.shape[0]
        j = s.pos - 1
        return int(s.req.prompt[j]) if j < P else s.emitted[j - P]

    def _propose_all(self):
        """(props [N, k] int32, dlen [N] int32) for every busy slot: one
        draft-model proposal for all slots (each busy slot drafts k), or
        host n-gram drafts."""
        N, K = self.slots, self._spec.k
        props = np.zeros((N, K), np.int32)
        dlen = np.zeros(N, np.int32)
        if self._draft:
            prev = np.zeros(N, np.int32)
            tok = np.zeros(N, np.int32)
            pos = np.zeros(N, np.int32)
            for i, s in enumerate(self._slots):
                if s.free:
                    continue
                prev[i] = self._prev_token(s)
                tok[i] = s.tok
                pos[i] = s.pos
                dlen[i] = K
            if dlen.any():
                props = self._proposer.propose(prev, tok, pos)
                self._programs.add(("draft", 0))
            return props, dlen
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

    def _verify_forward(self, tok, pos, live, props, dlen):
        """ONE verify forward of every slot's ``[tok, d1..dk]`` block from
        host arrays; returns (toks [N, k+1], n_acc [N]) numpy (one host
        sync)."""
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
        self._programs.add(("verify", 0))
        return toks_d.cpu().numpy(), acc_d.cpu().numpy()

    def _tick_verify(self, props, dlen):
        """One draft -> verify tick: ONE forward scores all k+1 positions
        for every slot; each live slot consumes its accepted prefix plus
        the correction token (1..k+1 tokens), all target argmaxes."""
        tok, pos, live, _ = self._tick_inputs()
        t_tick = time.perf_counter() if self._obs else 0.0
        toks, n_acc = self._verify_forward(tok, pos, live, props, dlen)
        self.ticks += 1
        self.spec_ticks += 1
        if self._obs:
            self._m_spec_ticks.inc()
            # the verify dispatch moves the single-pass bound's bytes
            self._observe_tick(t_tick, int(live.sum()),
                               self._verify_model_bytes, spec=True)
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
            n = self._consume(i, toks[i, :accepted + 1])
            if n:
                self._notify_progress(s.req, s.emitted[-n:])
            self.spec_tokens_emitted += n
            self.spec_slot_ticks += 1
            if self._obs:
                self._m_spec_drafted.inc(drafted)
                self._m_spec_accepted.inc(accepted)
                self._m_spec_rejected.inc(drafted - accepted)
                self._m_spec_per_tick.observe(n)
            if s.remaining <= 0 or not s.alive:
                self._retire(i)

    def _observe_tick(self, t_tick: float, n_live: int, model_bytes: int,
                      spec: bool = False):
        """A tick's series, its model efficiency and its span (obs on)."""
        now = time.perf_counter()
        self._m_ticks.inc()
        self._m_occupancy.observe(n_live)
        if now > t_tick:
            self.last_tick_model_eff = _eff.model_bandwidth_eff(
                model_bytes, now - t_tick, self._eff_chip)
            self._g_tick_eff.set(self.last_tick_model_eff)
        if spec:
            _obs.record_span("engine.tick", t_tick, now, cat="engine",
                             active=n_live, tick=self.ticks, spec=True)
        else:
            _obs.record_span("engine.tick", t_tick, now, cat="engine",
                             active=n_live, tick=self.ticks)

    def _decode_forward(self, tok, pos, live, eos, keys):
        """``tick_tokens`` micro-steps for every slot from host arrays
        (``keys``: the slots' sampling keys, None when greedy); returns
        the emitted tokens [N, tick_tokens] numpy (one host sync)."""
        dev = self.device
        tok_d = torch.from_numpy(tok).to(dev)
        pos_d = torch.from_numpy(pos).to(dev)
        live_d = torch.from_numpy(live).to(dev)
        eos_d = torch.from_numpy(eos).to(dev)
        bt_d = (torch.from_numpy(self._block_tables).to(dev) if self.paged
                else None)
        do_sample = self._sampling[0]
        # the position is folded into each slot's key on the device,
        # micro-step by micro-step
        keys_d = torch.from_numpy(keys).to(dev) if do_sample else None
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
        self._programs.add(("decode", 0))
        return torch.stack(emitted, dim=1).cpu().numpy()   # one sync/tick

    def _tick_decode(self):
        tok, pos, live, eos = self._tick_inputs()
        keys = None
        if self._sampling[0]:
            keys = np.zeros((self.slots, 2), np.int64)
            for i, s in enumerate(self._slots):
                if not s.free:
                    keys[i] = prng_key(s.req.seed).numpy()
        t_tick = time.perf_counter() if self._obs else 0.0
        toks = self._decode_forward(tok, pos, live, eos, keys)
        self.ticks += 1
        if self._obs:
            self._observe_tick(t_tick, int(live.sum()),
                               self._tick_model_bytes)
        for i, s in enumerate(self._slots):
            if s.free or not live[i]:
                continue
            n = self._consume(i, toks[i])
            if n:
                self._notify_progress(s.req, s.emitted[-n:])
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
                if self._obs:
                    self._set_page_gauges()
        if self._obs:
            now = time.perf_counter()
            self._m_retires.inc()
            self._m_decode.observe((now - slot.t_dec0) * 1e3)
            self._m_e2e.observe((now - req.t_submit) * 1e3)
            _obs.record_span("engine.decode", slot.t_dec0, now,
                             cat="engine", request_id=req.rid,
                             tokens=len(slot.emitted))
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
            if self._obs:
                self._m_cancels.inc()
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


# ---------------------------------------------------------------------------
# Config -> create_predictor (inference/predictor.py delegates here when
# Config.enable_continuous_batching was called)
# ---------------------------------------------------------------------------

class GenerationPredictor:
    """Predictor-shaped facade over a ContinuousBatchingEngine, so serving
    code written against Config -> create_predictor drives the engine: one
    named int64 input, one named tokens output."""

    def __init__(self, engine: ContinuousBatchingEngine):
        self.engine = engine

    def generate(self, input_ids, max_new_tokens: int = 32, **kw):
        return self.engine.generate(input_ids, max_new_tokens, **kw)

    def get_input_names(self):
        return ["input_ids"]

    def get_output_names(self):
        return ["tokens"]

    def close(self):
        self.engine.stop()


def create_engine_predictor(config) -> GenerationPredictor:
    """The engine behind ``Config.enable_continuous_batching``'s options,
    on the live model's device."""
    opts = dict(config._engine_opts)
    model = opts.pop("model", None)
    if model is None:
        raise ValueError(
            "Config.enable_continuous_batching needs a live model: the "
            "generation loop (cache-threaded forward + new_cache) cannot "
            "be rebuilt from a saved program — pass "
            "enable_continuous_batching(model=the_causal_lm)")
    return GenerationPredictor(ContinuousBatchingEngine(
        model, device=model.device, **opts))
