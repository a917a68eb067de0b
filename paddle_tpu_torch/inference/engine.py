"""Continuous-batching serving engine with a slot-based KV cache (port of
paddle_tpu/inference/engine.py, slot mode).

A fixed pool of N decode slots shares one pre-allocated KV cache
(``model.new_cache(N, max_len, dtype)``: per-layer [N, max_len, nkv, hd]
tensors, bf16/f32, or the int8 dict form) that every step updates in
place. One engine thread runs the loop:

- admission, at tick boundaries: a queued request takes a free slot; the
  slot's cache rows (int8 scales included) are zeroed in place and its
  prompt, right-padded to the nearest prefill bucket, is prefilled into
  them at position 0 — so a retired request's rows never leak into the
  next one. Its first token is the argmax at ``P - 1``.
- decode ticks: ``tick_tokens`` micro-steps for ALL slots; free and
  finished slots ride along with ``live`` False (their token held, their
  position not advancing), so every step has the same shapes. Tokens stay
  on the device across the micro-steps and come to the host once per
  tick, as the JAX engine's one host sync per tick. Each micro-step's
  attention is the S=1 slot-decode path of ``cached_attention``: the
  ``mega_decode_step`` kernel per layer for bf16/f32 caches, four
  ``fused_slot_write`` launches per layer for int8 caches.
- retirement: a request ends on eos or its token budget; its future
  resolves to the int64 [P + max_new_tokens] array, eos-padded.

Right-padded bucketed prefill is exact for greedy decoding: the padding
rows a prompt writes at [P, bucket) are never attended by positions < P,
and decode overwrites position p before the mask reaches it.

Not ported yet (ROADMAP.md): paged caches, speculative decoding, tensor
parallelism, sampling, observability metrics, AOT warmup.

Env knobs as paddle_tpu's: PADDLE_TPU_SERVE_SLOTS (default 8),
PADDLE_TPU_SERVE_PREFILL_BUCKETS (comma list, default powers of two),
PADDLE_TPU_SERVE_TICK_TOKENS (default 8), PADDLE_TPU_SERVE_MAX_QUEUE
(default 32).
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
from ..kernels.cache_write import fused_slot_write
from ..kernels.mega_decode import mega_decode_step

__all__ = ["ContinuousBatchingEngine", "EngineOverloaded",
           "RequestCancelled"]


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the request queue is at capacity — the
    serving layer maps it to the 503 ``overloaded`` record."""

    reason = "overloaded"

    def __init__(self, queue_depth: int, max_queue: int):
        super().__init__(
            f"engine queue saturated ({queue_depth}/{max_queue})")
        self.queue_depth = queue_depth
        self.max_queue = max_queue


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


@dataclass
class _Request:
    prompt: np.ndarray           # [P] int64
    max_new_tokens: int
    eos_token_id: Optional[int]
    future: Future = field(default_factory=Future)
    rid: str = ""
    cancelled: bool = False      # cancel() flagged; retired at the next
    #                              tick boundary


class _Slot:
    """Host-side mirror of one decode slot."""

    __slots__ = ("req", "pos", "tok", "alive", "remaining", "emitted")

    def __init__(self):
        self.req: Optional[_Request] = None
        self.pos = 0
        self.tok = 0
        self.alive = False
        self.remaining = 0
        self.emitted: List[int] = []

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousBatchingEngine:
    """Serve concurrent mixed-length greedy generate requests through one
    slot cache (see the module docstring). Greedy outputs are
    token-identical to sequential ``generate()`` per request.

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
                 do_sample: bool = False, paged: Optional[bool] = None,
                 speculative=None, tp: Optional[int] = None, mesh=None,
                 device=None):
        if do_sample:
            _not_ported("sampling (do_sample=True)")
        if paged:
            _not_ported("the paged KV cache (paged=True)")
        if speculative is not None:
            _not_ported("speculative decoding")
        if (tp is not None and tp != 1) or mesh is not None:
            _not_ported("tensor parallelism (tp=/mesh=)")
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
        model.eval()
        with torch.no_grad():
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
               eos_token_id: Optional[int] = None,
               request_id: Optional[str] = None) -> Future:
        """Queue one request; returns a Future resolving to an int64
        [prompt_len + max_new_tokens] array, eos-padded after finish —
        one row of ``generate()``. ``request_id`` is the handle
        ``cancel`` takes."""
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
        # past its budget
        worst = P + max_new_tokens + self.tick_tokens
        if worst > self.max_len:
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({max_new_tokens}) + "
                f"tick overshoot ({self.tick_tokens}) exceeds the "
                f"engine cache length {self.max_len}")
        req = _Request(prompt, int(max_new_tokens),
                       None if eos_token_id is None else int(eos_token_id),
                       rid=str(request_id) if request_id else "")
        with self._cv:
            if self._broken is not None:
                raise RuntimeError("engine is broken") from self._broken
            if self._stop_flag:
                raise RuntimeError("engine stopped")
            if len(self._queue) >= self.max_queue:
                raise EngineOverloaded(len(self._queue), self.max_queue)
            self._queue.append(req)
            self._cv.notify()
        return req.future

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience wrapper over submit()."""
        return self.submit(input_ids, max_new_tokens,
                           eos_token_id).result(timeout)

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
        """Slot occupancy, queue, lifetime counters and the launch counts
        of the kernels on this engine's decode path (process-wide
        counters)."""
        with self._cv:
            active = sum(1 for s in self._slots if not s.free)
            queued = len(self._queue)
            cancelled = self.cancelled
        return {"slots": self.slots, "active": active,
                "free": self.slots - active, "queued": queued,
                "max_queue": self.max_queue, "ticks": self.ticks,
                "admitted": self.admitted, "completed": self.completed,
                "cancelled": cancelled, "tick_tokens": self.tick_tokens,
                "prefill_buckets": list(self.prefill_buckets),
                "max_len": self.max_len, "cache_dtype": self.cache_dtype,
                "device": str(self.device),
                "kernel_launches": {
                    "mega_decode_step": mega_decode_step.launches,
                    "fused_slot_write": fused_slot_write.launches}}

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
                        self._tick_decode()
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
            self._admit(req, slot_idx)

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

    def _admit(self, req: _Request, b: int):
        """Reset slot ``b``'s rows, prefill the bucketed prompt into them,
        take the first token at P - 1."""
        P = req.prompt.shape[0]
        bucket = self._bucket_for(P)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :P] = req.prompt
        view = self._slot_view(b)
        for kc, vc in view:
            for leaf in (kc, vc):
                for t in (leaf.values() if isinstance(leaf, dict)
                          else (leaf,)):
                    t.zero_()
        logits, _ = self.model(torch.from_numpy(ids).to(self.device), view, 0)
        tok0 = int(torch.argmax(logits[0, P - 1]))   # first-token host sync
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

    def _tick_decode(self):
        N, dev = self.slots, self.device
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
        tok_d = torch.from_numpy(tok).to(dev)
        pos_d = torch.from_numpy(pos).to(dev)
        live_d = torch.from_numpy(live).to(dev)
        eos_d = torch.from_numpy(eos).to(dev)
        zero = torch.zeros_like(tok_d)
        emitted = []
        for _ in range(self.tick_tokens):
            logits, _ = self.model(tok_d[:, None].to(torch.int64),
                                   self._caches, pos_d)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
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
            n = 0
            for t in range(self.tick_tokens):
                if s.remaining <= 0 or not s.alive:
                    break
                token = int(toks[i, t])
                s.emitted.append(token)
                s.remaining -= 1
                n += 1
                if (s.req.eos_token_id is not None
                        and token == s.req.eos_token_id):
                    s.alive = False
            s.pos += n
            s.tok = s.emitted[-1]
            if s.remaining <= 0 or not s.alive:
                self._retire(i)

    def _retire(self, b: int):
        slot = self._slots[b]
        with self._cv:
            req, slot.req = slot.req, None
            slot.alive = False
        out = list(slot.emitted)
        info = {"tokens_generated": len(out)}
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
