"""Multi-replica serving tier: a health-aware router over N replica
processes (port of paddle_tpu/inference/router.py).

One ``PredictorServer`` is one process; a fleet of them behind one front
door stays up, sheds truthfully and rides through a replica's death:

* **Replicas are subprocesses** the router spawns and supervises: each
  runs ``python -m paddle_tpu_torch.inference.router --replica-child`` —
  a model built from a JSON :class:`ReplicaSpec` on the spec's device, a
  ``ContinuousBatchingEngine`` and a ``PredictorServer`` (``warmup=``).
  The router builds the CUDA kernels (``kernels._build.build``) before it
  spawns a card replica, so every replica, first or successor, loads the
  libraries already built and runs no ``nvcc``. Several replicas may
  share one card: they time-slice it (for failover and routing, not for
  speed).
* **Health-aware admission**: a control loop polls every replica's
  ``/healthz`` (slot occupancy, queue depth, warming/draining state).
  ``/generate`` routes to the least-loaded READY replica — never to a
  warming, draining, ejected, unreachable, or dead one.
* **Failure handling**: each forward carries a deadline; connect
  failures / 5xx / injected ``router_forward`` faults retry on a
  DIFFERENT replica under ``resilience.RetryPolicy`` (full-jitter, the
  request's remaining budget as the retry-time budget). A replica with
  a failure streak is circuit-breaker-ejected for a cooldown. When no
  replica can admit, the tier answers a truthful 503 with
  ``Retry-After`` — zero hangs, zero connection resets, zero silent
  drops.
* **Self-healing + rolling restarts**: a replica that dies (kill -9, a
  wedged backend) is detected by the control loop and respawned, on an
  escalating backoff when it keeps dying young (``RespawnGovernor``).
  ``rolling_restart()`` replaces replicas one at a time: the successor
  warms and joins the rotation BEFORE the predecessor drains (``POST
  /drain`` + ``stop(drain_s)``) and exits.
* **Queue-driven autoscaling**: when aggregate queue depth stays above
  the scale-up watermark the tier grows toward ``max_replicas``; when
  it sits idle it shrinks (drain-then-retire) toward ``min_replicas``,
  with a cooldown between actions. Both directions reuse the one spawn
  / retire path the rolling restart uses.
* **Work-conserving request recovery**: every journaled ``/generate``
  forwards in the replica's streamed (NDJSON) mode — the router
  journals ``prompt + tokens_so_far`` per in-flight request as token
  events stream back. A replica dying MID-DECODE (kill -9, broken
  forward) does not cost the client its generated tokens or an error:
  the router re-admits ``prompt + journal`` on a healthy replica and
  greedy determinism makes the continuation equal the undisturbed run's
  (the paged prefix trie turns the re-prefill into page hits). A request
  whose token progress stalls past the hedge budget (derived live from
  the inter-progress histogram p99, or ``PADDLE_TPU_TIER_HEDGE_S``)
  launches a BACKUP decode on a second replica; first to advance wins
  and the loser is cancelled (``POST /cancel`` -> engine slot retire ->
  pages freed). Recoveries/hedges/cancels are counted
  (``ptpu_router_{recoveries,hedges,hedge_wins,cancels}_total``) and
  each recovery burst dumps a flight-recorder artifact naming the
  migrated request ids.
* **Streaming QoS front**: ``"stream": true`` on a journaled
  ``/generate`` relays NDJSON token blocks to the CLIENT straight from
  the journal — the journal IS the stream, so a replica kill, a hedge
  win or a rolling restart is an invisible mid-stream failover (zero
  lost and zero duplicated tokens); a client that disconnects
  mid-stream cancels the request on whichever replica owns it.
  Admission stalls (no FIRST token past the live TTFT-derived budget)
  hedge under the same tier-wide hedge budget, and ``_pick`` blends load
  with prefix-trie affinity (replicas export chained-crc32 trie
  fingerprints via /healthz). Requests carry a tenant id + priority
  class (``X-PTPU-Tenant`` / ``X-PTPU-Class`` headers or ``tenant`` /
  ``qos_class`` body fields); admission runs through a weighted-fair
  scheduler — strict priority across classes, weighted by
  journal-accounted token charge inside one, starvation-aged — and
  overload sheds low classes first with per-class 429s whose
  Retry-After derives from the observed drain rate.

Greedy tokens through the tier equal a direct engine call's: the router
never touches payloads, and a retried request re-runs the same greedy
decode on another replica over identical weights (every replica builds
its model from the same ``ReplicaSpec.seed``).

The module itself exposes only the ``--replica-child`` entry point the
spawner uses; the operator CLI (paddle_tpu's tools/serve_tier.py) is not
ported yet (ROADMAP.md A14). Not ported, and raising
``NotImplementedError``: tensor-parallel replicas (``ReplicaSpec(tp>1)``,
ROADMAP.md A11) and the executable store (``Router(exec_store_dir=)`` or
an inherited ``PADDLE_TPU_EXEC_STORE_DIR``, ROADMAP.md A8);
``jax_cache_dir`` is accepted and ignored.

Env knobs:
  PADDLE_TPU_TIER_DEADLINE     per-request forward deadline (60 s)
  PADDLE_TPU_TIER_RETRIES      retry budget per request (2 retries)
  PADDLE_TPU_TIER_POLL_S       health-poll interval (0.5 s)
  PADDLE_TPU_TIER_EJECT_S      circuit-breaker ejection cooldown (5 s)
  PADDLE_TPU_TIER_CRASH_BUDGET fast deaths before a respawn is abandoned (5)
  PADDLE_TPU_TIER_CRASH_WINDOW_S a death inside this lifetime is fast (10 s)
  PADDLE_TPU_TIER_HEDGE_S      hedge budget: seconds of token-progress
                               silence before a backup decode launches
                               (0 disables; unset = derived live from
                               the inter-progress histogram p99)
  PADDLE_TPU_TIER_HEDGE_MULT   multiplier on the derived p99 (20)
  PADDLE_TPU_TIER_HEDGE_FRAC   tier-wide hedge budget: backups may
                               occupy at most this fraction of the
                               live journaled requests (0.25, floor 1)
  PADDLE_TPU_TIER_JOURNAL_REQS max concurrently journaled requests (128;
                               overflow falls back to the single-shot
                               forward path, 0 disables recovery)
  PADDLE_TPU_TIER_TTFT_HEDGE_S first-token hedge budget (0 disables;
                               unset = derived live from the TTFT
                               histogram p99)
  PADDLE_TPU_TIER_TTFT_MULT    multiplier on the derived TTFT p99 (3)
  PADDLE_TPU_TIER_AFFINITY_W   prefix-affinity weight in replica scoring
                               (0.5 load-equivalent a cached page; 0 =
                               load-only)
  PADDLE_TPU_TIER_PREWARM      standby prefix pre-warming (1; 0 disables)
  PADDLE_TPU_TIER_QOS_CONCURRENCY admission capacity of the weighted-
                               fair scheduler (unset = engine slots x
                               max_replicas; 0 disables the gate)
  PADDLE_TPU_TIER_QOS_QUEUE    per-class wait-queue base depth (8; cap =
                               base x class weight)
  PADDLE_TPU_TIER_QOS_STARVATION_S age at which a waiter is served
                               regardless of class (5 s)
"""
from __future__ import annotations

import http.client
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from .. import obs as _obs
from ..distributed import resilience as _resil
from ..framework.env import float_env as _env_float
from ..kernels import _build
from .paging import chain_hashes
from .serve import (REQUEST_ID_HEADER, RETRY_AFTER_S, handle_admin_trace,
                    send_json, send_text)

__all__ = ["ReplicaSpec", "Replica", "Router", "RespawnGovernor",
           "main", "single_device_child_env", "QOS_CLASSES"]

# tier-level 503 reasons extend the per-replica contract
TIER_RETRY_AFTER_S = dict(RETRY_AFTER_S)
TIER_RETRY_AFTER_S["no_replica_ready"] = 1.0

# per-tenant QoS: class -> (strict priority, fair-share
# weight). Priority orders classes absolutely (an interactive waiter
# always beats a batch waiter, starvation aging aside); the weight
# sets both the fair token share INSIDE a priority tier and the
# class's wait-queue depth (base x weight) — so under overload the
# batch queue fills and sheds first, interactive last.
QOS_CLASSES = {"interactive": (0, 4.0),
               "standard": (1, 2.0),
               "batch": (2, 1.0)}
QOS_DEFAULT = "standard"
TENANT_HEADER = "X-PTPU-Tenant"
CLASS_HEADER = "X-PTPU-Class"

# what a dying replica can throw at a reader besides the URLError
# family: a SIGKILL mid-response-write surfaces as IncompleteRead /
# BadStatusLine (http.client.HTTPException), and a truncated JSON body
# as ValueError — all must read as "that replica failed", never as an
# unhandled handler crash
_REPLICA_IO_ERRORS = (urllib.error.URLError, ConnectionError, OSError,
                      socket.timeout, http.client.HTTPException,
                      ValueError)


def single_device_child_env(platform: str = "cpu",
                            tp: int = 1) -> Dict[str, str]:
    """Env overrides that pin a replica child to one device of
    ``platform``: ``"cpu"`` hides every card (``CUDA_VISIBLE_DEVICES=""``),
    ``"gpu"`` keeps one card visible (the first this process sees). Replica
    children of one tier may share that card. ``tp>1`` (a tensor-parallel
    replica slice) is not ported (ROADMAP.md A11)."""
    if int(tp) > 1:
        raise NotImplementedError(
            "tensor-parallel replicas (tp > 1) are not ported yet "
            "(ROADMAP.md A11)")
    if platform == "cpu":
        return {"CUDA_VISIBLE_DEVICES": ""}
    if platform == "gpu":
        seen = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        return {"CUDA_VISIBLE_DEVICES": seen.strip() or "0"}
    raise ValueError(f"unsupported platform {platform!r}: cpu or gpu")


# ---------------------------------------------------------------------------
# ReplicaSpec — everything a replica child needs, JSON-serializable
# ---------------------------------------------------------------------------

class ReplicaSpec:
    """Recipe for one replica process.

    ``model`` is a dict: ``{"kind": "gpt", **GPTConfig kwargs}``,
    ``{"kind": "llama", **LlamaConfig kwargs}`` or ``{"kind":
    "factory", "path": "pkg.mod:callable", "kwargs": {...}}`` (the
    callable returns a built causal-LM). A gpt or llama dict may carry
    ``"device"`` (the model's and engine's device: the card when absent,
    ``"cpu"`` for a CPU tier). ``engine`` holds
    ``ContinuousBatchingEngine`` kwargs (slots, max_len, cache_dtype,
    prefill_buckets, tick_tokens, paged, ...). Every replica builds its
    model with ``seed`` (the framework generator seeded with it too), so
    the whole tier holds identical weights — the token-identity oracle
    depends on it.

    ``env`` overrides the child environment on top of the router's own
    (``single_device_child_env`` pins the device). ``tp>1`` raises
    ``NotImplementedError`` (ROADMAP.md A11).
    """

    def __init__(self, model: dict, engine: Optional[dict] = None,
                 warmup: bool = True, drain_s: float = 5.0,
                 seed: int = 0, host: str = "127.0.0.1",
                 env: Optional[Dict[str, str]] = None, tp: int = 1):
        self.model = dict(model)
        self.engine = dict(engine or {})
        self.warmup = bool(warmup)
        self.drain_s = float(drain_s)
        self.seed = int(seed)
        self.host = host
        self.env = dict(env or {})
        if int(tp) > 1:
            raise NotImplementedError(
                "tensor-parallel replicas (tp > 1) are not ported yet "
                "(ROADMAP.md A11)")
        self.tp = int(tp)

    def to_json(self) -> str:
        return json.dumps({
            "model": self.model, "engine": self.engine,
            "warmup": self.warmup, "drain_s": self.drain_s,
            "seed": self.seed, "host": self.host, "tp": self.tp})

    @property
    def on_card(self) -> bool:
        """Does a replica of this spec run on a CUDA card? (The device in
        the model dict, or a factory's ``device`` kwarg; absent means the
        card, as every entry point of the port.)"""
        dev = self.model.get("device",
                             (self.model.get("kwargs") or {}).get("device"))
        return dev is None or str(dev).startswith("cuda")

    def argv(self, port_file: str) -> List[str]:
        return [sys.executable, "-m", "paddle_tpu_torch.inference.router",
                "--replica-child", "--spec", self.to_json(),
                "--port-file", port_file]


def _build_model(model_spec: dict, seed: int = 0):
    spec = dict(model_spec)
    kind = spec.pop("kind", "gpt")
    device = spec.pop("device", None)
    if kind == "gpt":
        from ..models.gpt import GPTConfig, GPTForCausalLM
        return GPTForCausalLM(GPTConfig(**spec), device=device, seed=seed)
    if kind == "llama":
        from ..models.llama import LlamaConfig, LlamaForCausalLM
        return LlamaForCausalLM(LlamaConfig(**spec), device=device,
                                seed=seed)
    if kind == "factory":
        import importlib
        mod, _, attr = spec["path"].partition(":")
        fn = getattr(importlib.import_module(mod), attr)
        return fn(**spec.get("kwargs", {}))
    raise ValueError(f"unknown model kind {kind!r}")


def _replica_child_main(args) -> int:
    """Entry point of one replica process: build, serve, drain on
    SIGTERM, die with the parent (orphan watchdog). A spec whose device
    is the card raises (exit code 1) on a machine without one: a replica
    never serves on the CPU unless its spec says so."""
    # time.monotonic() at each start-up stage: the clock is system-wide,
    # so the router's spawn time lines up with these
    stages = {"main": time.monotonic()}
    spec = json.loads(args.spec)
    from ..framework import random as _rng
    seed = int(spec.get("seed", 0))
    _rng.seed(seed)                          # identical weights tier-wide
    model = _build_model(spec["model"], seed=seed)
    stages["model"] = time.monotonic()
    from .engine import ContinuousBatchingEngine
    from .serve import PredictorServer
    eng_kw = dict(spec.get("engine", {}))
    eng_kw.setdefault("device", model.device)
    engine = ContinuousBatchingEngine(model, **eng_kw)
    stages["engine"] = time.monotonic()
    srv = PredictorServer(engine=engine, host=spec.get("host", "127.0.0.1"),
                          port=0, warmup=spec.get("warmup", True)).start()
    stages["server"] = time.monotonic()
    # publish the kernel-assigned port atomically — the router polls for
    # this file; a half-written port number must be unobservable
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(srv.port))
    os.replace(tmp, args.port_file)

    stop_evt = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *a: stop_evt.set())
    ppid = os.getppid()
    logged = False
    while not stop_evt.wait(0.25):
        if os.getppid() != ppid:
            break                      # router died: don't leak orphans
        if not logged and srv._warm_state == "ready":
            # one line in the replica's log once it can serve: the kernel
            # libraries it compiled (none when the router built them
            # first) and loaded, and when each start-up stage ended
            stages["ready"] = time.monotonic()
            print(f"replica ready: pid {os.getpid()} port {srv.port} "
                  f"device {engine.device} compilation "
                  f"{json.dumps(_build.summary())} stages "
                  f"{json.dumps(stages)}", flush=True)
            logged = True
    # graceful exit: bounded drain of in-flight requests, then down
    srv.stop(drain_s=float(spec.get("drain_s", 5.0)))
    engine.stop()
    return 0


# ---------------------------------------------------------------------------
# Replica — the router's handle on one subprocess
# ---------------------------------------------------------------------------

class Replica:
    """Router-side state for one replica process. All mutation happens
    under the router's lock or on the control-loop thread."""

    def __init__(self, name: str, proc: subprocess.Popen,
                 port_file: str, log_path: str, host: str):
        self.name = name
        self.proc = proc
        self.port_file = port_file
        self.log_path = log_path
        self.host = host
        self.port: Optional[int] = None
        self.state = "starting"     # starting|warming|ready|unready|
        #                             draining|unreachable|dead
        self.draining = False
        self.inflight = 0           # router-side forwards in flight
        self.failure_streak = 0     # forward failures (circuit breaker)
        self.health_fail_streak = 0  # consecutive failed health polls
        self.ejected_until = 0.0
        self.health: dict = {}
        # chained-crc32 trie fingerprints from the last health poll —
        # the prefix-affinity signal (empty = unknown / not paged)
        self.prefix_fps: frozenset = frozenset()
        self.spawned_at = time.monotonic()
        self.last_health_at: Optional[float] = None  # last ANSWERED poll
        self.was_ready = False       # ever reached READY (not warming
        #                              503s — crash-loop governance key)

    @property
    def base_url(self) -> Optional[str]:
        if self.port is None:
            return None
        return f"http://{self.host}:{self.port}"

    def alive(self) -> bool:
        return self.proc.poll() is None

    def routable(self, now: float) -> bool:
        return (self.state == "ready" and not self.draining
                and self.port is not None and now >= self.ejected_until
                and self.alive())

    def load_score(self) -> tuple:
        """Least-loaded ordering: router-side in-flight first (freshest
        signal), then the replica's own reported queue + occupancy from
        the last health poll; name breaks ties deterministically."""
        eng = self.health.get("engine", {}) if self.health else {}
        return (self.inflight,
                int(eng.get("queued", 0)) + int(eng.get("active", 0)),
                self.name)

    def snapshot(self) -> dict:
        eng = self.health.get("engine", {}) if self.health else {}
        now = time.monotonic()
        return {"name": self.name, "state": self.state,
                "pid": self.proc.pid, "port": self.port,
                "draining": self.draining, "inflight": self.inflight,
                "failure_streak": self.failure_streak,
                "queued": int(eng.get("queued", 0)),
                "active": int(eng.get("active", 0)),
                # mesh geometry: how many devices this replica's
                # slice occupies (1: tensor-parallel replicas are not
                # ported)
                "tp": int(eng.get("tp", 1)),
                "mesh_devices": int(eng.get("mesh_devices", 1)),
                **({"mesh": eng["mesh"]} if "mesh" in eng else {}),
                "ejected": now < self.ejected_until,
                # how old the queued/active numbers above are: None =
                # never answered a poll; a large age means the stats
                # are STALE (wedged/unreachable replica), not live
                "last_scrape_age_s": (
                    None if self.last_health_at is None
                    else round(now - self.last_health_at, 2)),
                "metrics_seq": int(self.health.get("metrics_seq", 0))
                if self.health else 0}


class RespawnGovernor:
    """Escalating respawn backoff + give-up for crash-looping replicas.

    A replica that dies at startup used to be respawned immediately and
    forever — a broken spec (bad model kwargs, poisoned store entry)
    hot-looped process churn. The governor watches each death: a
    replica that never became ready, or died within ``window_s`` of its
    spawn, extends a crash streak; each streak death pushes the next
    respawn out on the shared ``RetryPolicy`` schedule (exponential,
    capped), and past ``budget`` consecutive fast deaths the respawn is
    ABANDONED (``note_death`` returns None — the give-up the router
    counts as ``crash_loops`` and surfaces in stats//healthz). Any
    replica surviving past the window resets the streak.
    """

    def __init__(self, budget: int = 5, window_s: float = 10.0,
                 policy: Optional[_resil.RetryPolicy] = None,
                 clock=time.monotonic):
        self.budget = int(budget)
        self.window_s = float(window_s)
        self.policy = policy if policy is not None else _resil.RetryPolicy(
            max_attempts=max(2, self.budget + 1), base_delay=0.5,
            max_delay=30.0, jitter=0.0)
        self._clock = clock
        self.streak = 0

    def note_death(self, lifetime_s: float,
                   became_ready: bool) -> Optional[float]:
        """One replica died. Returns the earliest monotonic time its
        replacement may spawn, or None when the crash loop has burned
        the budget and this respawn is abandoned."""
        fast = (not became_ready) or lifetime_s < self.window_s
        if not fast:
            self.streak = 0
            return self._clock()
        self.streak += 1
        if self.streak > self.budget:
            return None
        return self._clock() + self.policy.delay(
            min(self.streak, self.policy.max_attempts - 1))

    def note_stable(self) -> None:
        """A replica proved healthy past the window: clear the streak."""
        self.streak = 0


# internal retryable forward outcomes -------------------------------------

class _RetryableForward(Exception):
    pass


class _ForwardFailed(_RetryableForward):
    """Connect failure / 5xx / injected fault against one replica —
    retry on a different one."""

    def __init__(self, replica: Replica, why: str):
        super().__init__(why)
        self.replica = replica


def _retry_after_hint(body: dict) -> Optional[float]:
    """The shed body's ``retry_after_s`` as a float, or None when it
    is absent or unparseable — a malformed hint from a replica (or
    from anything else answering on its port) must degrade to the
    tier's own default, never crash the forward path (RetryPolicy
    and send_json both arithmetic on the value)."""
    try:
        return (None if "retry_after_s" not in body
                else float(body["retry_after_s"]))
    except (TypeError, ValueError):
        return None


class _ShedByReplica(_RetryableForward):
    """A truthful 503 shed (overloaded/warming/draining) — the replica
    is healthy, just not admitting; retry elsewhere, no breaker hit.
    Carries the shed body's ``retry_after_s`` so the RetryPolicy
    honors the replica's own Retry-After hint instead of guessing
    with full-jitter."""

    def __init__(self, replica: Replica, body: dict):
        super().__init__(str(body.get("error", "shed")))
        self.replica = replica
        self.body = body
        self.retry_after_s = _retry_after_hint(body)


class _NoReplica(Exception):
    pass


class _DeadlineExceeded(Exception):
    pass


# ---------------------------------------------------------------------------
# Work-conserving request recovery: journal + stream attempt
# ---------------------------------------------------------------------------

def _flatten_ids(v) -> Optional[List[int]]:
    """Flatten a JSON ``input_ids`` value (flat or nested int lists)
    into one token list; None when it isn't token-shaped (the opaque
    payload then takes the single-shot forward path and the replica
    judges it)."""
    out: List[int] = []

    def walk(x):
        if isinstance(x, bool):
            raise TypeError(x)
        if isinstance(x, int):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        else:
            raise TypeError(x)
    try:
        walk(v)
    except TypeError:
        return None
    return out or None


class _ReqJournal:
    """Router-side token journal of ONE in-flight /generate — the
    original request plus every token any replica has streamed back.

    The journal IS the failover state: ``prompt + tokens`` re-admits
    on any healthy replica, and greedy determinism guarantees the
    continuation is bitwise identical to the undisturbed run. Extends
    are reconciled first-writer-wins: positions already journaled are
    VERIFIED against (a hedged duplicate must produce the same greedy
    tokens), never overwritten — a conflict fails the offending
    attempt, not the journal."""

    def __init__(self, prompt: List[int], max_new: int, eos, seed: int,
                 rid: Optional[str], hist=None, ttft_cb=None,
                 itl_cb=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos = None if eos is None else int(eos)
        self.seed = int(seed)
        self.rid = rid
        self.tokens: List[int] = []
        self.cond = _obs.make_condition("journal.cond")
        self.t0 = time.monotonic()          # submission (TTFT anchor)
        self.last_progress = self.t0
        self.mismatched = False
        self.source: Optional[str] = None   # last replica to advance us
        self._hist = hist                   # inter-progress-gap histogram
        self._ttft_cb = ttft_cb             # ms from submission to tok0
        self._itl_cb = itl_cb               # per-class inter-token ms

    def extend(self, base: int, toks, source: str) -> bool:
        """Merge a token block whose first element is journal position
        ``base``; False on a greedy-determinism conflict or a gap."""
        with self.cond:
            n0 = len(self.tokens)
            for i, t in enumerate(toks):
                t = int(t)
                j = base + i
                if j < n0:
                    if self.tokens[j] != t:
                        self.mismatched = True
                        self.cond.notify_all()
                        return False
                elif j == len(self.tokens):
                    self.tokens.append(t)
                else:            # a gap means events were lost: refuse
                    self.mismatched = True
                    self.cond.notify_all()
                    return False
            if len(self.tokens) > n0:
                now = time.monotonic()
                gap_ms = (now - self.last_progress) * 1e3
                if self._hist is not None:
                    self._hist.observe(gap_ms)
                if n0 == 0:
                    # first token EVER for this request — TTFT, whoever
                    # produced it (primary, TTFT hedge, or a recovery)
                    if self._ttft_cb is not None:
                        self._ttft_cb((now - self.t0) * 1e3)
                elif self._itl_cb is not None:
                    self._itl_cb(gap_ms)
                self.last_progress = now
                self.source = source
            self.cond.notify_all()
            return True

    def size(self) -> int:
        with self.cond:
            return len(self.tokens)

    def complete(self) -> bool:
        """Does the journal alone already hold the full output (token
        budget exhausted, or the eos landed)?"""
        with self.cond:
            return (len(self.tokens) >= self.max_new
                    or (self.eos is not None and bool(self.tokens)
                        and self.tokens[-1] == self.eos))

    def synthesize_body(self) -> dict:
        """The full client body from journal state alone — used when
        the journal completed but the terminal record died with its
        replica. Mirrors the engine's contract exactly: int64 row of
        prompt + generated, eos-padded to max_new on early finish."""
        with self.cond:
            toks = list(self.tokens)
            source = self.source
        out = list(toks)
        if len(out) < self.max_new:
            out += [self.eos] * (self.max_new - len(out))
        body = {"tokens": self.prompt + out,
                "prompt_len": len(self.prompt),
                "new_tokens": self.max_new,
                "tokens_generated": len(toks)}
        if self.rid:
            body["request_id"] = self.rid
        if source:
            body["served_by"] = source
        return body


class _StreamAttempt(threading.Thread):
    """One streaming forward of a journaled request's RESIDUAL
    (prompt + journaled prefix, remaining token budget) to one
    replica. Token events extend the shared journal as they arrive;
    terminal state lands in ``status`` ("done" | "failed") with the
    failure classified for the coordinator (io / shed / client_error /
    cancelled). Cancellable from the coordinator: close the response
    stream, then tell the replica to retire the engine request so its
    slot and KV pages reclaim."""

    def __init__(self, router: "Router", rep: Replica, j: _ReqJournal,
                 base: int, deadline_at: float, is_hedge: bool,
                 seq: int):
        name = f"tier-attempt-{j.rid or 'anon'}.{seq}"
        super().__init__(daemon=True, name=name)
        self.router = router
        self.rep = rep
        self.j = j
        self.base = int(base)
        self.deadline_at = float(deadline_at)
        self.is_hedge = bool(is_hedge)
        # each attempt gets a DISTINCT request id derived from the
        # client's: /cancel targets exactly one engine request, and
        # the obs spans of a hedge pair stay tellable apart
        self.rid = (f"{j.rid}.{seq}" if j.rid
                    else uuid.uuid4().hex[:16])
        self.status = "running"
        self.reaped = False          # coordinator bookkeeping
        self.kind: Optional[str] = None
        self.reason = ""
        self.code = 0
        self.body: Optional[dict] = None
        self.retry_after = None
        self.done_body: Optional[dict] = None
        self.streamed = False        # got a 200 head (mid-stream death
        #                              => work-conserving recovery)
        self.got = 0                 # tokens THIS attempt produced
        self._resp = None
        self._cancelled = threading.Event()

    def run(self):
        j, rep = self.j, self.rep
        with j.cond:
            # snapshot under the journal lock: the coordinator extends
            # j.tokens concurrently, and a torn read here would splice
            # a half-written prefix into the residual prompt
            residual = j.prompt + j.tokens[:self.base]
        payload: dict = {"input_ids": residual,
                         "max_new_tokens": j.max_new - self.base,
                         "seed": j.seed, "stream": True}
        if j.eos is not None:
            payload["eos_token_id"] = j.eos
        data = json.dumps(payload).encode()
        with self.router._lock:
            rep.inflight += 1
        span = (_obs.trace.begin_span(
            "router.forward", cat="router", replica=rep.name,
            request_id=self.rid, resumed_tokens=self.base,
            hedge=self.is_hedge) if self.router._obs else None)
        t0 = time.perf_counter()
        try:
            _resil.maybe_inject("router_forward")
            remaining = self.deadline_at - time.monotonic()
            if remaining <= 0:
                self._fail("io", "deadline exhausted before forward")
                return
            req = urllib.request.Request(
                rep.base_url + "/generate", data,
                {"Content-Type": "application/json",
                 REQUEST_ID_HEADER: self.rid})
            resp = urllib.request.urlopen(req, timeout=remaining)
            self._resp = resp
            self.streamed = True
            with resp:
                for raw in resp:
                    if self._cancelled.is_set():
                        self._fail("cancelled", "cancelled by "
                                                "coordinator")
                        return
                    raw = raw.strip()
                    if not raw:
                        continue
                    ev = json.loads(raw)
                    if "t" in ev:
                        if not j.extend(self.base + self.got, ev["t"],
                                        rep.name):
                            # greedy determinism violated — defensive:
                            # fail THIS attempt, keep the journal
                            self.router.stats_counters[
                                "recovery_mismatches"] += 1
                            self._fail("mismatch", "token mismatch "
                                                   "vs journal")
                            return
                        self.got += len(ev["t"])
                    elif "done" in ev:
                        body = ev["done"]
                        toks = body.get("tokens") or []
                        gen = int(body.get("tokens_generated", 0))
                        # reconcile the terminal truth (authoritative)
                        # into the journal before declaring victory —
                        # a terminal body CONFLICTING with journaled
                        # tokens is the same determinism violation as
                        # a conflicting token event: fail the attempt,
                        # never hand the client a divergent body
                        if not j.extend(
                                self.base,
                                toks[len(residual):len(residual) + gen],
                                rep.name):
                            self.router.stats_counters[
                                "recovery_mismatches"] += 1
                            self._fail("mismatch", "terminal body "
                                       "mismatches journal")
                            return
                        self.done_body = body
                        rep.failure_streak = 0
                        if self.router._obs:
                            self.router._m_forward.observe(
                                (time.perf_counter() - t0) * 1e3,
                                replica=rep.name)
                        self.status = "done"
                        self._notify()
                        return
                    elif "err" in ev:
                        rec = ev["err"]
                        # engine-truth partial reconciliation: the
                        # failure path surfaces tokens the stream may
                        # not have delivered yet
                        part = rec.get("partial_tokens")
                        if part:
                            j.extend(self.base, part, rep.name)
                        self.router._note_failure(rep)
                        self._fail("io", str(rec.get("error", "err")))
                        return
            # EOF without a terminal record: the replica died mid-write
            self.router._note_failure(rep)
            self._fail("io", "stream truncated (replica died "
                             "mid-decode)")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read())
            except (ValueError, OSError, http.client.HTTPException):
                body = {"error": f"http_{e.code}"}
            if e.code == 503:
                # truthful shed from a live server: retry elsewhere,
                # honoring ITS Retry-After hint — no breaker hit
                self.retry_after = _retry_after_hint(body)
                self.body = body
                self._fail("shed", str(body.get("error", "shed")))
            elif e.code >= 500:
                self.router._note_failure(rep)
                self._fail("io", str(body.get("error", f"http {e.code}")))
            else:
                self.code, self.body = e.code, body
                self._fail("client_error",
                           str(body.get("error", e.code)))
        except _resil.FaultInjected as e:
            self.router._note_failure(rep)
            self._fail("io", str(e))
        except _REPLICA_IO_ERRORS as e:
            if self._cancelled.is_set():
                self._fail("cancelled", "cancelled by coordinator")
            else:
                self.router._note_failure(rep)
                self._fail("io", str(e))
        except Exception as e:   # noqa: BLE001 — an attempt thread
            # must never die silently: every outcome is classified
            self._fail("io", f"{type(e).__name__}: {e}")
        finally:
            if span is not None:
                _obs.trace.end_span(span)
            with self.router._lock:
                rep.inflight -= 1
            if self.is_hedge:
                # pairs with the coordinator's _reserve_hedge: the
                # budget slot frees when the backup terminates (win,
                # loss, or cancellation)
                self.router._release_hedge()

    def _fail(self, kind: str, reason: str):
        self.kind = kind
        self.reason = str(reason)
        self.status = "failed"
        self._notify()

    def _notify(self):
        with self.j.cond:
            self.j.cond.notify_all()

    def cancel(self):
        """Best-effort loser-side cancellation: stop reading, then
        tell the replica to retire the engine request NOW (future
        cancel -> slot retire -> pages freed) instead of letting the
        duplicate decode to completion."""
        self._cancelled.set()
        resp = self._resp
        if resp is not None:
            # shut the raw SOCKET down, never resp.close(): the reader
            # thread blocked in readline() holds the BufferedReader's
            # internal lock, so close() from here would block until
            # the (possibly wedged) replica sends bytes again —
            # shutdown() needs no buffer lock and pops the blocked
            # recv with EOF instead
            try:
                sock = getattr(getattr(resp, "fp", None), "raw", None)
                sock = getattr(sock, "_sock", None)
                if sock is not None:
                    sock.shutdown(socket.SHUT_RDWR)
            except (OSError, AttributeError, ValueError):
                pass
        if self.rep.base_url and self.streamed:
            try:
                req = urllib.request.Request(
                    self.rep.base_url + "/cancel",
                    json.dumps({"request_id": self.rid}).encode(),
                    {"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=2.0):
                    pass
                self.router.stats_counters["cancels_sent"] += 1
                if self.router._obs:
                    self.router._m_cancels.inc()
            except _REPLICA_IO_ERRORS:
                pass             # dead replica: nothing left to cancel


# ---------------------------------------------------------------------------
# Per-tenant QoS admission: weighted-fair scheduler
# ---------------------------------------------------------------------------

class _QosWaiter:
    __slots__ = ("tenant", "qcls", "prio", "enq_at", "admitted")

    def __init__(self, tenant: str, qcls: str, prio: int, enq_at: float):
        self.tenant = tenant
        self.qcls = qcls
        self.prio = prio
        self.enq_at = enq_at
        self.admitted = False


class _QosScheduler:
    """Weighted-fair admission over the tier's serving capacity.

    ``capacity`` requests run concurrently; everyone else waits in a
    single ordered list and is dispatched strict-priority-first
    (:data:`QOS_CLASSES`), weighted-fair inside one priority tier —
    the tenant with the smallest weight-normalized token charge goes
    next, FIFO within a tenant. Charges accrue at release from the
    journal's own accounting (tokens actually generated), so a tenant
    burning long generations yields to one sipping short ones even at
    equal request rates. Starvation-freedom is explicit: any waiter
    older than ``starvation_s`` is served next regardless of class.

    Overload degrades truthfully per class: each class's wait queue is
    bounded at ``queue_limit x weight`` (batch fills and sheds first),
    and a shed's Retry-After derives from the OBSERVED drain rate —
    requests ahead at this priority divided by the EWMA of recent
    completions/second — never a made-up constant.

    Standalone (no router reference, injectable clock) so fairness is
    unit-testable without processes.
    """

    def __init__(self, capacity: int, queue_limit: int = 8,
                 starvation_s: float = 5.0, clock=time.monotonic):
        self.capacity = int(capacity)
        self.queue_limit = int(queue_limit)
        self.starvation_s = float(starvation_s)
        self._clock = clock
        self._cv = _obs.make_condition("qos.cv")
        self._inflight = 0
        self._waiting: List[_QosWaiter] = []     # enqueue order
        self._charge: Dict[str, float] = {}      # weight-normalized
        self._drain_ewma = 0.0                   # completions / second
        self._last_done: Optional[float] = None
        self.admitted_total = 0
        self.shed_total = 0

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    @staticmethod
    def class_of(qcls) -> str:
        q = str(qcls or QOS_DEFAULT)
        return q if q in QOS_CLASSES else QOS_DEFAULT

    def try_acquire(self, tenant: str, qcls: str, timeout: float):
        """Block until admitted or refused. Returns ``("admitted",
        None)``, ``("shed", retry_after_s)`` (class queue full) or
        ``("timeout", retry_after_s)`` (budget burned waiting)."""
        if not self.enabled:
            return "admitted", None
        prio, weight = QOS_CLASSES[self.class_of(qcls)]
        deadline = self._clock() + max(0.0, float(timeout))
        with self._cv:
            if self._inflight < self.capacity and not self._waiting:
                self._admit_locked(tenant)
                return "admitted", None
            cap = max(1, int(self.queue_limit * weight))
            if sum(1 for w in self._waiting if w.qcls == qcls) >= cap:
                self.shed_total += 1
                return "shed", self._retry_after_locked(prio)
            w = _QosWaiter(tenant, self.class_of(qcls), prio,
                           self._clock())
            self._waiting.append(w)
            while True:
                if w.admitted:
                    return "admitted", None
                left = deadline - self._clock()
                if left <= 0:
                    self._waiting.remove(w)
                    self.shed_total += 1
                    return "timeout", self._retry_after_locked(prio)
                self._cv.wait(timeout=min(left, 0.25))

    def release(self, tenant: str, qcls: str, tokens: int = 0):
        """One admitted request finished: charge its tenant the tokens
        it actually generated (journal-accounted), fold the completion
        into the drain-rate EWMA, dispatch the next waiter(s)."""
        _, weight = QOS_CLASSES[self.class_of(qcls)]
        with self._cv:
            self._inflight = max(0, self._inflight - 1)
            base = min(self._charge.values()) if self._charge else 0.0
            cur = self._charge.get(tenant, base)
            self._charge[tenant] = cur + max(0, int(tokens)) / weight
            if len(self._charge) > 1024:
                # bound the ledger: keep the busiest tenants, the rest
                # re-enter at the floor (no fairness cliff)
                top = sorted(self._charge.items(), key=lambda kv: -kv[1])
                self._charge = dict(top[:512])
            now = self._clock()
            if self._last_done is not None:
                inst = 1.0 / max(1e-3, now - self._last_done)
                self._drain_ewma = (inst if self._drain_ewma <= 0
                                    else 0.8 * self._drain_ewma
                                    + 0.2 * inst)
            self._last_done = now
            self._dispatch_locked()

    def _admit_locked(self, tenant: str):
        self._inflight += 1
        self.admitted_total += 1
        # a tenant first seen now starts at the CURRENT floor, not 0 —
        # otherwise arriving late would outrank every incumbent forever
        if tenant not in self._charge and self._charge:
            self._charge[tenant] = min(self._charge.values())

    def _dispatch_locked(self):
        while self._waiting and self._inflight < self.capacity:
            w = self._pick_locked()
            self._waiting.remove(w)
            w.admitted = True
            self._admit_locked(w.tenant)
        self._cv.notify_all()

    def _pick_locked(self) -> _QosWaiter:
        now = self._clock()
        aged = [w for w in self._waiting
                if now - w.enq_at >= self.starvation_s]
        if aged:
            # starvation-freedom beats class policy: the oldest waiter
            # goes, whatever its class
            return min(aged, key=lambda w: w.enq_at)
        top = min(w.prio for w in self._waiting)
        return min((w for w in self._waiting if w.prio == top),
                   key=lambda w: (self._charge.get(w.tenant, 0.0),
                                  w.enq_at))

    def _retry_after_locked(self, prio: int) -> float:
        """Honest Retry-After: work that drains before a retry at this
        priority could land (in-flight + same-or-higher-priority
        waiters) over the observed drain rate. Cold start (no
        completion observed yet) answers a conservative 1 s."""
        ahead = self._inflight + sum(1 for w in self._waiting
                                     if w.prio <= prio)
        if self._drain_ewma <= 0:
            return 1.0
        return round(min(60.0, max(0.05, (ahead + 1)
                                   / self._drain_ewma)), 3)

    def snapshot(self) -> dict:
        with self._cv:
            by_cls: Dict[str, int] = {}
            for w in self._waiting:
                by_cls[w.qcls] = by_cls.get(w.qcls, 0) + 1
            return {"capacity": self.capacity,
                    "inflight": self._inflight,
                    "waiting": len(self._waiting),
                    "waiting_by_class": by_cls,
                    "admitted_total": self.admitted_total,
                    "shed_total": self.shed_total,
                    "drain_per_s": round(self._drain_ewma, 3),
                    "tenants_charged": len(self._charge)}


# ---------------------------------------------------------------------------
# Client-facing stream relay: the journal IS the stream
# ---------------------------------------------------------------------------

class _ClientRelay(threading.Thread):
    """Streams one journaled request to the CLIENT as NDJSON — the
    replica stream contract verbatim ({"t": [...]} blocks, one
    terminal {"done": body} / {"err": record}, read-until-close), so
    a tier client and a single-replica client parse identically.

    The shared :class:`_ReqJournal` is the ONE token source. The relay
    tails it from its own read frontier (``sent``) under the journal
    condition, which is exactly what makes mid-stream failover
    invisible: a replica kill, hedge win, or rolling restart swaps the
    PRODUCER under the journal while position-verified extends refuse
    conflicts and gaps — the relay can neither re-emit a position nor
    skip one, so the client stream is zero-loss, zero-duplicate and
    bitwise-identical to the undisturbed run by greedy determinism.

    A write failing mid-stream means the client went away: ``dead``
    flips, the journal cond wakes the coordinator, and the coordinator
    cancels every live attempt — engine slot retired, KV pages freed
    on whichever replica currently owns the request. The terminal line
    is handed over by the coordinator via :meth:`finish` so error
    bodies (deadline, backend-gone) reach a mid-stream client as a
    truthful ``err`` record instead of a bare EOF."""

    def __init__(self, handler, rid: Optional[str]):
        super().__init__(daemon=True,
                         name=f"tier-relay-{rid or 'anon'}")
        self.handler = handler
        self.rid = rid
        self.started_http = False     # 200 + NDJSON head on the wire
        self.dead = False             # client disconnected
        self.sent = 0                 # relay frontier (tokens emitted)
        self._st: Optional[_ReqJournal] = None
        self._terminal = None         # ("done"|"err", body)
        self._done = threading.Event()

    def begin(self, st: _ReqJournal):
        """Arm on the journal and start streaming. Called by the
        coordinator once the request is committed to the journaled
        path (first attempt launched) — every earlier failure stays a
        plain JSON response."""
        self._st = st
        self.start()

    def finish(self, kind: str, body: dict):
        """Coordinator hands over the terminal line; blocks (bounded)
        until the relay has flushed trailing tokens + terminal."""
        st = self._st
        if st is None:
            return
        with st.cond:
            self._terminal = (kind, dict(body))
            st.cond.notify_all()
        self._done.wait(timeout=10.0)

    def run(self):
        st, h = self._st, self.handler
        t0 = time.perf_counter()
        try:
            h.send_response(200)
            h.send_header("Content-Type", "application/x-ndjson")
            h.send_header("Connection", "close")
            h.end_headers()
            h.close_connection = True
            self.started_http = True
            while True:
                with st.cond:
                    while (len(st.tokens) <= self.sent
                           and self._terminal is None):
                        st.cond.wait(timeout=0.25)
                    toks = list(st.tokens[self.sent:])
                    term = self._terminal
                if toks:
                    self._write({"t": toks})
                    self.sent += len(toks)
                    continue      # terminal never jumps the token queue
                if term is not None:
                    kind, body = term
                    self._write({kind: body})
                    return
        except (BrokenPipeError, ConnectionError, OSError):
            self.dead = True
            if st is not None:
                with st.cond:
                    st.cond.notify_all()   # wake the coordinator NOW
        finally:
            if _obs.enabled():
                now = time.perf_counter()
                _obs.record_span("router.stream_relay", t0, now,
                                 cat="router", request_id=self.rid,
                                 tokens=self.sent,
                                 disconnected=self.dead)
            self._done.set()

    def _write(self, obj):
        self.handler.wfile.write((json.dumps(obj) + "\n").encode())
        self.handler.wfile.flush()


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

class Router:
    """Health-aware load balancer + supervisor over N replica
    subprocesses (module docstring has the full story).

    ``replicas`` is the starting count; ``min_replicas``/
    ``max_replicas`` bound the autoscaler (equal min/max = autoscaling
    off). ``exec_store_dir`` (or an inherited
    ``PADDLE_TPU_EXEC_STORE_DIR``) raises ``NotImplementedError``: the
    executable store is not ported (ROADMAP.md A8); ``jax_cache_dir`` is
    accepted and ignored.
    """

    def __init__(self, spec: ReplicaSpec, replicas: int = 2,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 deadline_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 poll_s: Optional[float] = None,
                 eject_s: Optional[float] = None,
                 breaker_threshold: int = 3,
                 unreachable_after: int = 3,
                 restart_unreachable_after: int = 10,
                 respawn: bool = True,
                 scale_up_queued: Optional[int] = None,
                 scale_cycles: int = 3,
                 scale_cooldown_s: float = 30.0,
                 crash_loop_budget: Optional[int] = None,
                 crash_loop_window_s: Optional[float] = None,
                 respawn_policy: Optional[_resil.RetryPolicy] = None,
                 exec_store_dir: Optional[str] = None,
                 jax_cache_dir: Optional[str] = None,
                 workdir: Optional[str] = None,
                 recovery: bool = True,
                 hedge_s: Optional[float] = None,
                 hedge_mult: Optional[float] = None,
                 hedge_frac: Optional[float] = None,
                 journal_max: Optional[int] = None,
                 ttft_hedge_s: Optional[float] = None,
                 ttft_hedge_mult: Optional[float] = None,
                 affinity_w: Optional[float] = None,
                 prewarm: Optional[bool] = None,
                 qos_concurrency: Optional[int] = None,
                 qos_queue_limit: Optional[int] = None,
                 qos_starvation_s: Optional[float] = None):
        if replicas < 1:
            raise ValueError("need at least one replica")
        if exec_store_dir or os.environ.get("PADDLE_TPU_EXEC_STORE_DIR"):
            raise NotImplementedError(
                "the executable store (exec_store_dir, "
                "PADDLE_TPU_EXEC_STORE_DIR) is not ported yet (ROADMAP.md "
                "A8): replicas load the kernels the router built")
        self.spec = spec
        self.min_replicas = int(min_replicas if min_replicas is not None
                                else replicas)
        self.max_replicas = int(max_replicas if max_replicas is not None
                                else replicas)
        if not (1 <= self.min_replicas <= replicas <= self.max_replicas):
            raise ValueError("need 1 <= min <= replicas <= max")
        self._initial = int(replicas)
        self.deadline_s = (deadline_s if deadline_s is not None
                           else _env_float("PADDLE_TPU_TIER_DEADLINE",
                                           60.0))
        retries = int(retries if retries is not None
                      else _env_float("PADDLE_TPU_TIER_RETRIES", 2))
        # the ONE retry schedule (resilience.RetryPolicy): full-jitter
        # backoff decorrelates concurrent retriers; each run() gets the
        # request's remaining budget as its retry-time deadline
        self.retry_policy = _resil.RetryPolicy(
            max_attempts=max(1, retries + 1), base_delay=0.05,
            max_delay=0.5, full_jitter=True,
            retry_on=(_RetryableForward,))
        self.poll_s = (poll_s if poll_s is not None
                       else _env_float("PADDLE_TPU_TIER_POLL_S", 0.5))
        self.eject_s = (eject_s if eject_s is not None
                        else _env_float("PADDLE_TPU_TIER_EJECT_S", 5.0))
        self.breaker_threshold = int(breaker_threshold)
        self.unreachable_after = int(unreachable_after)
        self.restart_unreachable_after = int(restart_unreachable_after)
        self.respawn = bool(respawn)
        # crash-loop governance: a replica dying at startup no longer
        # respawns immediately and forever — escalating backoff, then
        # give-up (counted as crash_loops in stats and /healthz)
        self.respawn_governor = RespawnGovernor(
            budget=int(crash_loop_budget if crash_loop_budget is not None
                       else _env_float("PADDLE_TPU_TIER_CRASH_BUDGET", 5)),
            window_s=(crash_loop_window_s
                      if crash_loop_window_s is not None
                      else _env_float("PADDLE_TPU_TIER_CRASH_WINDOW_S",
                                      10.0)),
            policy=respawn_policy)
        self._pending_respawns = 0
        self._respawn_at = 0.0
        self._last_fast_death = 0.0
        # autoscaler watermarks: scale up when aggregate queued tokens
        # requests exceed this for scale_cycles consecutive polls
        slots = int(self.spec.engine.get("slots", 8))
        self.scale_up_queued = (int(scale_up_queued)
                                if scale_up_queued is not None
                                else max(1, slots // 2))
        self.scale_cycles = int(scale_cycles)
        self.scale_cooldown_s = float(scale_cooldown_s)
        # work-conserving recovery + hedged decode
        self.recovery = bool(recovery)
        self.hedge_s = (float(hedge_s) if hedge_s is not None
                        else _env_float("PADDLE_TPU_TIER_HEDGE_S",
                                        -1.0))
        self.hedge_mult = (float(hedge_mult) if hedge_mult is not None
                           else _env_float("PADDLE_TPU_TIER_HEDGE_MULT",
                                           20.0))
        # tier-wide hedge budget (Tail-at-Scale style): backups may
        # occupy at most this fraction of the live journaled requests
        # (floor 1, so a lone straggler always gets its backup). The
        # per-request stall clock starts at submission, which under
        # saturation makes EVERY queued request look silent — without
        # this cap a loaded tier would hedge itself into double load
        # exactly when it has no headroom.
        self.hedge_frac = (float(hedge_frac) if hedge_frac is not None
                           else _env_float("PADDLE_TPU_TIER_HEDGE_FRAC",
                                           0.25))
        self._hedges_live = 0        # concurrent backups, tier-wide
        self.journal_max = int(
            journal_max if journal_max is not None
            else _env_float("PADDLE_TPU_TIER_JOURNAL_REQS", 128))
        self._journaled = 0          # live journals (bounded)
        self._recovered_rids: List[dict] = []   # since last flight dump
        self._last_recovery_dump = 0.0
        # streaming-first QoS front
        self.ttft_hedge_s = (
            float(ttft_hedge_s) if ttft_hedge_s is not None
            else _env_float("PADDLE_TPU_TIER_TTFT_HEDGE_S", -1.0))
        self.ttft_hedge_mult = (
            float(ttft_hedge_mult) if ttft_hedge_mult is not None
            else _env_float("PADDLE_TPU_TIER_TTFT_MULT", 3.0))
        self.affinity_w = (
            float(affinity_w) if affinity_w is not None
            else _env_float("PADDLE_TPU_TIER_AFFINITY_W", 0.5))
        # standby prefix pre-warming: while a journaled
        # stream runs, the router feeds the prompt+journal prefix to a
        # standby replica's paged KV trie ahead of any failover, so a
        # cutover's resumed prefill lands on trie hits instead of
        # recomputing the prefix. PADDLE_TPU_TIER_PREWARM=0 disables.
        self.prewarm = (bool(prewarm) if prewarm is not None
                        else _env_float("PADDLE_TPU_TIER_PREWARM",
                                        1.0) > 0)
        qos_cap = (int(qos_concurrency) if qos_concurrency is not None
                   else int(_env_float(
                       "PADDLE_TPU_TIER_QOS_CONCURRENCY", -1)))
        if qos_cap < 0:
            # derived default: what the tier can actually decode at
            # once — engine slots per replica times the replica ceiling
            qos_cap = max(4, int(self.spec.engine.get("slots", 8))
                          * self.max_replicas)
        self.qos = _QosScheduler(
            capacity=qos_cap,
            queue_limit=(int(qos_queue_limit)
                         if qos_queue_limit is not None
                         else int(_env_float("PADDLE_TPU_TIER_QOS_QUEUE",
                                             8))),
            starvation_s=(float(qos_starvation_s)
                          if qos_starvation_s is not None
                          else _env_float(
                              "PADDLE_TPU_TIER_QOS_STARVATION_S", 5.0)))
        # jax_cache_dir is accepted and ignored: there is no compiler
        # cache to share (the replicas load the kernel libraries the
        # router built before spawning them)

        self._owns_workdir = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(
            prefix="paddle_tpu_torch_tier_")
        os.makedirs(self.workdir, exist_ok=True)

        self._lock = _obs.make_rlock("router.lock")
        self._replicas: List[Replica] = []
        self._seq = 0
        self._stopping = False
        self._started = time.monotonic()
        self._rolling_lock = _obs.make_lock("router.rolling")
        self._rolling = False
        self._control_thread: Optional[threading.Thread] = None
        self._up_streak = 0          # autoscaler pressure counters
        self._idle_streak = 0
        self._last_scale = 0.0
        self.stats_counters = {
            "forwards": 0, "retries": 0, "tier_unavailable_503": 0,
            "deadline_503": 0, "relayed_503": 0, "backend_503": 0,
            "respawns": 0, "ejections": 0, "rolling_restarts": 0,
            "scale_ups": 0, "scale_downs": 0, "spawn_failures": 0,
            "crash_loops": 0,
            # work-conserving recovery + hedging
            "recoveries": 0, "hedges": 0, "hedge_wins": 0,
            "cancels_sent": 0, "resume_fallbacks": 0,
            "recovery_mismatches": 0,
            # streaming-first QoS front
            "streams": 0, "client_disconnects": 0,
            "ttft_hedges": 0, "qos_admitted": 0, "qos_shed": 0,
            # standby prefix pre-warming
            "prewarms": 0, "prewarmed_resumes": 0,
        }
        # observability (obs): the stats above keep their
        # dict face (/healthz, tests); the registry carries the
        # exported view — per-replica forward latency (BOUNDED label
        # set: replica names grow r1..rN over months of restarts, the
        # histogram folds overflow into one _other series), retry and
        # ejection counters, breaker state. /metrics additionally
        # scrapes every replica and aggregates ptpu_tier_* series.
        self._obs = _obs.enabled()
        if self._obs:
            reg = _obs.metrics.registry
            self._m_forward = reg.histogram(
                "ptpu_router_forward_ms",
                "router->replica forward latency (successes)",
                labels=("replica",), max_series=32)
            self._m_forwards = reg.counter(
                "ptpu_router_forwards_total", "forwarded requests")
            self._m_retries = reg.counter(
                "ptpu_router_retries_total",
                "forward attempts retried on another replica")
            self._m_ejections = reg.counter(
                "ptpu_router_ejections_total",
                "circuit-breaker ejections")
            self._m_breaker = reg.gauge(
                "ptpu_router_breaker_open",
                "1 while the replica is breaker-ejected",
                labels=("replica",), max_series=32)
            self._m_ready = reg.gauge(
                "ptpu_router_ready_replicas", "routable replicas")
            self._m_recoveries = reg.counter(
                "ptpu_router_recoveries_total",
                "journaled requests resumed on another replica after "
                "a mid-decode failure (work-conserving failover)")
            self._m_hedges = reg.counter(
                "ptpu_router_hedges_total",
                "backup decodes launched for stalled requests")
            self._m_hedge_wins = reg.counter(
                "ptpu_router_hedge_wins_total",
                "hedged backups that beat the stalled primary")
            self._m_cancels = reg.counter(
                "ptpu_router_cancels_total",
                "loser-side /cancel requests sent to replicas")
            # inter-progress gaps of streamed forwards: the LIVE
            # decode-latency signal the hedge budget derives from
            self._m_progress = reg.histogram(
                "ptpu_router_token_progress_ms",
                "gap between successive token-progress events across "
                "journaled requests",
                buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000,
                         2500, 5000, 10000))
            # streaming-first QoS front. The unlabeled TTFT
            # histogram feeds the TTFT hedge budget (snap() on a
            # labeled family needs exact labels — budget derivation
            # must stay label-free); the ptpu_tier_* families are the
            # per-class client-facing view, named in tier space
            # directly since render_tier passes router-own series
            # through verbatim (replica aggregates land under
            # different names).
            _lat_buckets = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000,
                            2500, 5000, 10000, 30000)
            self._m_ttft = reg.histogram(
                "ptpu_router_ttft_ms",
                "submission-to-first-token latency of journaled "
                "requests (the TTFT hedge budget derives from its "
                "p99)", buckets=_lat_buckets)
            self._m_ttft_class = reg.histogram(
                "ptpu_tier_ttft_ms",
                "per-QoS-class submission-to-first-token latency",
                labels=("qos_class",), max_series=8,
                buckets=_lat_buckets)
            self._m_itl_class = reg.histogram(
                "ptpu_tier_itl_ms",
                "per-QoS-class inter-token latency (journal progress "
                "gaps past the first token)",
                labels=("qos_class",), max_series=8,
                buckets=_lat_buckets)
            self._m_qos_admitted = reg.counter(
                "ptpu_tier_qos_admitted_total",
                "requests admitted by the weighted-fair scheduler",
                labels=("qos_class",), max_series=8)
            self._m_qos_shed = reg.counter(
                "ptpu_tier_qos_shed_total",
                "requests shed (429) or queue-timed-out by the "
                "weighted-fair scheduler",
                labels=("qos_class",), max_series=8)
            self._m_streams = reg.counter(
                "ptpu_router_streams_total",
                "client-facing NDJSON stream relays started")
            self._m_disconnects = reg.counter(
                "ptpu_router_client_disconnects_total",
                "mid-stream client disconnects propagated to "
                "cancellation")
            self._m_ttft_hedges = reg.counter(
                "ptpu_router_ttft_hedges_total",
                "backups launched for admission (first-token) stalls")
            # standby prefix pre-warming
            self._m_prewarms = reg.counter(
                "ptpu_router_prewarms_total",
                "journaled prefixes pre-warmed on standby replicas")
            self._m_prewarmed_resumes = reg.counter(
                "ptpu_router_prewarmed_resumes_total",
                "resumes/hedges that landed on a replica whose trie "
                "the router had pre-warmed for that request")

        self.httpd = ThreadingHTTPServer((host, port),
                                         self._make_handler())
        self.host, self.port = self.httpd.server_address[:2]
        self._http_thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------
    def start(self):
        """Spawn the initial replicas (in parallel; they become
        routable as their health flips), start the control loop and the
        HTTP front. Non-blocking — use wait_ready() to gate traffic.
        For a card spec, the kernel libraries are built here first (one
        ``nvcc`` per missing library, all at once), so that no replica,
        first or successor, compiles; a failed build raises."""
        if self.spec.on_card:
            _build.build()
        for _ in range(self._initial):
            try:
                self._spawn_replica()
            except Exception:
                self.stats_counters["spawn_failures"] += 1
                # the control loop keeps trying to reach min_replicas
        self._control_thread = threading.Thread(
            target=self._control_loop, daemon=True, name="tier-control")
        self._control_thread.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="tier-http")
        self._http_thread.start()
        return self

    def wait_ready(self, count: Optional[int] = None,
                   timeout: float = 300.0) -> bool:
        """Block until ``count`` (default min_replicas) replicas are
        routable, or the timeout passes (False)."""
        want = self.min_replicas if count is None else int(count)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.ready_count() >= want:
                return True
            time.sleep(0.05)
        return False

    def ready_count(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(1 for r in self._replicas if r.routable(now))

    def replicas(self) -> List[dict]:
        with self._lock:
            return [r.snapshot() for r in self._replicas]

    def stop(self, drain_s: float = 0.0):
        """Tear the tier down: stop routing, retire every replica
        (graceful when ``drain_s`` > 0), stop the HTTP front."""
        with self._lock:
            self._stopping = True
            reps = list(self._replicas)
        for r in reps:
            self._terminate(r, drain_timeout=drain_s)
        with self._lock:
            self._replicas.clear()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=5)
        if self._control_thread is not None:
            self._control_thread.join(timeout=self.poll_s * 4 + 1)
        if self._owns_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.stop()
        return False

    def _stopping_flag(self) -> bool:
        with self._lock:
            return self._stopping

    def _rolling_flag(self) -> bool:
        with self._lock:
            return self._rolling

    # -- spawn / retire (the ONE path restarts + autoscaling share) ------
    def _spawn_replica(self) -> Replica:
        _resil.maybe_inject("replica_spawn")
        with self._lock:
            self._seq += 1
            name = f"r{self._seq}"
        port_file = os.path.join(self.workdir, f"{name}.port")
        log_path = os.path.join(self.workdir, f"{name}.log")
        env = dict(os.environ)
        # children must resolve `-m paddle_tpu_torch.inference.router`
        # wherever the router process happens to run from
        pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_parent + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_parent)
        env.update(self.spec.env)
        log_f = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                self.spec.argv(port_file), env=env,
                stdout=log_f, stderr=subprocess.STDOUT,
                cwd=os.getcwd())
        finally:
            log_f.close()        # child holds its own fd now
        rep = Replica(name, proc, port_file, log_path, self.spec.host)
        with self._lock:
            self._replicas.append(rep)
        return rep

    @staticmethod
    def _read_port(rep: Replica) -> bool:
        """Pick up the port the child published (atomic file); True
        once known."""
        if rep.port is not None:
            return True
        try:
            with open(rep.port_file) as f:
                rep.port = int(f.read().strip())
            return True
        except (OSError, ValueError):
            return False

    def _wait_replica_ready(self, rep: Replica, timeout: float) -> bool:
        """Poll the port file, then /healthz, until the replica reports
        ready. Runs health updates inline so a caller (rolling restart)
        does not depend on control-loop timing."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not rep.alive():
                return False
            if not self._read_port(rep):
                time.sleep(0.05)
                continue
            self._poll_health(rep)
            if rep.state == "ready":
                return True
            time.sleep(0.1)
        return False

    def _terminate(self, rep: Replica, drain_timeout: float = 0.0):
        """Retire one replica: pull it from rotation, ask it to drain,
        wait (bounded) for in-flight work, then SIGTERM -> SIGKILL."""
        rep.draining = True                 # out of rotation NOW
        if drain_timeout and drain_timeout > 0 and rep.base_url \
                and rep.alive():
            try:
                req = urllib.request.Request(rep.base_url + "/drain",
                                             b"{}")
                with urllib.request.urlopen(req, timeout=2.0):
                    pass
            except (urllib.error.URLError, OSError, ValueError):
                pass                        # dead/wedged: just kill it
            deadline = time.monotonic() + drain_timeout
            while time.monotonic() < deadline and rep.alive():
                if rep.inflight <= 0 and self._polled_inflight(rep) == 0:
                    break
                time.sleep(0.05)
        if rep.alive():
            # SIGTERM runs the child's stop(drain_s) path — a second,
            # in-process bounded drain — then a clean exit
            try:
                rep.proc.terminate()
                rep.proc.wait(timeout=max(5.0, drain_timeout + 5.0))
            except (subprocess.TimeoutExpired, OSError):
                try:
                    rep.proc.kill()
                    rep.proc.wait(timeout=5.0)
                except OSError:
                    pass
        rep.state = "dead"
        with self._lock:
            if rep in self._replicas:
                self._replicas.remove(rep)
        self._drop_replica_series(rep)
        for p in (rep.port_file,):
            try:
                os.unlink(p)
            except OSError:
                pass

    def _drop_replica_series(self, rep: Replica):
        """A retired/dead replica's breaker gauge must not export 1
        forever (its name never comes back — respawns mint fresh ones)
        nor hold a slot against the family's series cap."""
        if self._obs:
            self._m_breaker.remove(replica=rep.name)

    def _polled_inflight(self, rep: Replica) -> int:
        """One direct /healthz read of the replica's in-flight count
        (drain progress); unreachable reads as drained."""
        if rep.base_url is None:
            return 0
        try:
            with urllib.request.urlopen(rep.base_url + "/healthz",
                                        timeout=1.0) as r:
                return int(json.loads(r.read()).get("inflight", 0))
        except urllib.error.HTTPError as e:
            try:
                return int(json.loads(e.read()).get("inflight", 0))
            except (ValueError, OSError, http.client.HTTPException):
                return 0
        except _REPLICA_IO_ERRORS:
            return 0

    # -- health polling / supervision ------------------------------------
    def _poll_health(self, rep: Replica):
        if rep.base_url is None:
            return
        try:
            _resil.maybe_inject("replica_health")
            with urllib.request.urlopen(rep.base_url + "/healthz",
                                        timeout=max(1.0, self.poll_s * 2)
                                        ) as r:
                body = json.loads(r.read())
            rep.health = body
            try:
                fps = (body.get("engine") or {}).get(
                    "prefix_fingerprints")
                rep.prefix_fps = (frozenset(int(h) for h in fps)
                                  if fps else frozenset())
            except (TypeError, ValueError):
                rep.prefix_fps = frozenset()
            rep.health_fail_streak = 0
            rep.last_health_at = time.monotonic()
            rep.state = "ready"
            rep.was_ready = True
            if self._obs:
                self._m_breaker.set(
                    1.0 if time.monotonic() < rep.ejected_until else 0.0,
                    replica=rep.name)
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read())
            except (ValueError, OSError, http.client.HTTPException):
                body = {}
            rep.health = body
            rep.health_fail_streak = 0
            rep.last_health_at = time.monotonic()  # answered, just 503
            status = body.get("status", "unready")
            rep.state = status if status in ("warming", "draining") \
                else "unready"
        except (_resil.FaultInjected,) + _REPLICA_IO_ERRORS:
            rep.health_fail_streak += 1
            if rep.health_fail_streak >= self.unreachable_after:
                # a wedged replica answers nothing but its process
                # lives: it must leave the rotation just like a dead one
                rep.state = "unreachable"

    def _control_loop(self):
        while True:
            time.sleep(self.poll_s)
            with self._lock:
                if self._stopping:
                    return
                reps = list(self._replicas)
            dead = []
            for rep in reps:
                if rep.draining:
                    continue
                if not rep.alive():
                    rep.state = "dead"
                    dead.append(rep)
                    continue
                if not self._read_port(rep):
                    continue            # still binding its listener
                self._poll_health(rep)
                if (rep.state == "unreachable"
                        and rep.health_fail_streak
                        >= self.restart_unreachable_after):
                    # wedged beyond hope: treat as dead (kill + respawn)
                    try:
                        rep.proc.kill()
                    except OSError:
                        pass
                    dead.append(rep)
            if dead and not self._stopping_flag():
                # postmortem: dump the flight recorder BEFORE the
                # respawn path erases the scene — the artifact carries
                # the ring (recent forwards, health polls) plus every
                # span still open, i.e. the request ids in flight when
                # the replica died. Best-effort: forensics must never
                # take the tier down with it.
                try:
                    _obs.dump_flight(
                        "replica_death",
                        extra={"replicas": [r.name for r in dead],
                               "pids": [r.proc.pid for r in dead]})
                except Exception:   # noqa: BLE001
                    pass
            now = time.monotonic()
            for rep in dead:
                with self._lock:
                    if rep in self._replicas:
                        self._replicas.remove(rep)
                    stopping = self._stopping
                self._drop_replica_series(rep)
                if stopping or not self.respawn:
                    continue
                # crash-loop governance: a fast death (never became
                # ready, or died inside the window) escalates the next
                # respawn on the backoff schedule; past the budget the
                # respawn is abandoned and counted — no more hot-loop
                prev_streak = self.respawn_governor.streak
                spawn_at = self.respawn_governor.note_death(
                    now - rep.spawned_at,
                    became_ready=rep.was_ready)
                if self.respawn_governor.streak > prev_streak:
                    self._last_fast_death = now
                if spawn_at is None:
                    self.stats_counters["crash_loops"] += 1
                    continue
                self._pending_respawns += 1
                self._respawn_at = max(self._respawn_at, spawn_at)
            # a replica spawned after the latest fast death that
            # reached READY and survived past the window proves the
            # spec healthy again
            if self.respawn_governor.streak:
                for rep in reps:
                    if (rep not in dead and rep.alive() and rep.was_ready
                            and rep.spawned_at >= self._last_fast_death
                            and now - rep.spawned_at
                            > self.respawn_governor.window_s):
                        self.respawn_governor.note_stable()
                        break
            while (self._pending_respawns > 0
                   and not self._stopping_flag()
                   and time.monotonic() >= self._respawn_at):
                self._pending_respawns -= 1
                try:
                    self._spawn_replica()
                    self.stats_counters["respawns"] += 1
                except Exception:
                    self.stats_counters["spawn_failures"] += 1
                    # the slot is still owed a replica: keep the
                    # pending respawn, retry on a later pass instead
                    # of (a) hot-spinning now or (b) dropping it
                    self._pending_respawns += 1
                    self._respawn_at = time.monotonic() + \
                        max(self.poll_s, 0.5)
                    break
            if not self._stopping_flag():
                if self._obs:
                    self._m_ready.set(self.ready_count())
                self._autoscale()
                self._trim_surplus()

    def _trim_surplus(self):
        """Keep the replica count <= max_replicas. A rare race (a
        replica dying exactly as a rolling restart snapshots it) can
        leave one extra; retire the newest, drained, on the next
        pass."""
        with self._lock:
            if self._rolling or self._stopping:
                return
            reps = [r for r in self._replicas if not r.draining]
            if len(reps) <= self.max_replicas:
                return
            victim = max(reps, key=lambda r: r.spawned_at)
        threading.Thread(
            target=self._terminate, args=(victim,),
            kwargs={"drain_timeout": self.spec.drain_s},
            daemon=True, name="tier-trim").start()

    def _autoscale(self):
        if self.max_replicas <= self.min_replicas:
            return
        now = time.monotonic()
        with self._lock:
            if self._rolling:            # restarts own the spawn path
                return
            # draining replicas are leaving: they neither count toward
            # capacity (a drainer must not block a needed scale-up) nor
            # qualify as a scale-down victim (no double-terminate)
            reps = [r for r in self._replicas if not r.draining]
        n = len(reps)
        queued = inflight = active = 0
        for r in reps:
            eng = r.health.get("engine", {}) if r.health else {}
            queued += int(eng.get("queued", 0))
            active += int(eng.get("active", 0))
            inflight += r.inflight
        if queued >= self.scale_up_queued:
            self._up_streak += 1
            self._idle_streak = 0
        elif queued == 0 and active == 0 and inflight == 0:
            self._idle_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._idle_streak = 0
        if now - self._last_scale < self.scale_cooldown_s:
            return
        if self._up_streak >= self.scale_cycles and n < self.max_replicas:
            try:
                self._spawn_replica()
                self.stats_counters["scale_ups"] += 1
            except Exception:
                self.stats_counters["spawn_failures"] += 1
            self._last_scale = now
            self._up_streak = 0
        elif (self._idle_streak >= self.scale_cycles
              and n > self.min_replicas):
            # retire the newest replica (oldest have the warmest OS
            # caches); drain first — scale-down must never drop work
            victim = max(reps, key=lambda r: r.spawned_at)
            self.stats_counters["scale_downs"] += 1
            self._last_scale = now
            self._idle_streak = 0
            threading.Thread(
                target=self._terminate, args=(victim,),
                kwargs={"drain_timeout": self.spec.drain_s},
                daemon=True, name="tier-scale-down").start()

    # -- rolling restart -------------------------------------------------
    def rolling_restart(self, ready_timeout: float = 300.0,
                        drain_timeout: Optional[float] = None) -> dict:
        """Replace every replica, one at a time: spawn the successor
        (it loads the kernel libraries the router built: no ``nvcc``),
        wait until it is routable, then drain and
        retire the predecessor. The tier keeps serving throughout —
        capacity never drops below the pre-restart count."""
        if drain_timeout is None:
            drain_timeout = self.spec.drain_s
        if not self._rolling_lock.acquire(blocking=False):
            raise RuntimeError("rolling restart already in progress")
        replaced, failed = [], []
        try:
            with self._lock:
                self._rolling = True
                olds = list(self._replicas)
            for old in olds:
                with self._lock:
                    if self._stopping:
                        break
                    if old not in self._replicas or not old.alive():
                        # died (and the control loop owns its respawn):
                        # replacing it HERE too would double the slot
                        continue
                try:
                    new = self._spawn_replica()
                except Exception as e:
                    self.stats_counters["spawn_failures"] += 1
                    failed.append(f"spawn: {e}")
                    break
                if not self._wait_replica_ready(new, ready_timeout):
                    # successor never came up: keep the predecessor —
                    # a rolling restart must not shrink the tier
                    failed.append(f"{new.name} not ready in "
                                  f"{ready_timeout}s")
                    self._terminate(new, drain_timeout=0.0)
                    break
                self._terminate(old, drain_timeout=drain_timeout)
                replaced.append((old.name, new.name))
            self.stats_counters["rolling_restarts"] += 1
        finally:
            with self._lock:
                self._rolling = False
            self._rolling_lock.release()
        return {"replaced": replaced, "failed": failed,
                "ok": not failed}

    # -- forwarding ------------------------------------------------------
    def _tier_page_size(self) -> int:
        """The paged engines' page size, read from live health (0 when
        the tier is not paged / not yet polled) — what the router
        hashes incoming prompts with for affinity scoring."""
        with self._lock:
            for r in self._replicas:
                eng = r.health.get("engine", {}) if r.health else {}
                if eng.get("paged") and eng.get("page_size"):
                    try:
                        return int(eng["page_size"])
                    except (TypeError, ValueError):
                        return 0
        return 0

    def _pick(self, exclude: set,
              prompt_hashes: Optional[List[int]] = None
              ) -> Optional[Replica]:
        now = time.monotonic()
        with self._lock:
            cands = [r for r in self._replicas
                     if r.name not in exclude and r.routable(now)]
            if not cands:
                return None
            if not prompt_hashes or self.affinity_w <= 0:
                return min(cands, key=Replica.load_score)

            # prefix-affinity blend: score = load minus
            # affinity_w per page of cached prefix overlap — a replica
            # already holding the prompt's KV wins ties (and modest
            # load gaps) because routing there turns the prefill into
            # trie hits; load still dominates when the gap is real, so
            # affinity can never pile every shared-prefix client onto
            # one drowning replica. Overlap is the longest chain-hash
            # prefix present in the replica's fingerprint set (chains
            # fold parents in, so membership of hash j implies the
            # whole j-page prefix is cached).
            def score(r: Replica):
                overlap = 0
                if r.prefix_fps:
                    for h in prompt_hashes:
                        if h not in r.prefix_fps:
                            break
                        overlap += 1
                eng = r.health.get("engine", {}) if r.health else {}
                load = r.inflight + 0.5 * (int(eng.get("queued", 0))
                                           + int(eng.get("active", 0)))
                return (load - self.affinity_w * overlap, r.name)
            return min(cands, key=score)

    def _note_failure(self, rep: Replica):
        rep.failure_streak += 1
        if rep.failure_streak >= self.breaker_threshold:
            # circuit breaker: eject for a cooldown; health polls keep
            # running, so a recovered replica rejoins after the window
            rep.ejected_until = time.monotonic() + self.eject_s
            rep.failure_streak = 0
            self.stats_counters["ejections"] += 1
            if self._obs:
                self._m_ejections.inc()
                self._m_breaker.set(1.0, replica=rep.name)

    def forward_generate(self, payload: bytes,
                         deadline_s: Optional[float] = None,
                         request_id: Optional[str] = None,
                         tenant: Optional[str] = None,
                         qos_class: Optional[str] = None,
                         relay: Optional[_ClientRelay] = None):
        """Forward one /generate body. Returns ``(code, body_dict,
        retry_after_or_None)`` — every outcome is a clean JSON
        response, never an exception to the HTTP handler.
        ``request_id`` rides the X-PTPU-Request-Id header on every
        attempt, so the tier's spans (router forward) and the serving
        replica's (engine queue-wait/prefill/decode) correlate under
        one id.

        Token-shaped payloads take the JOURNALED path (streamed
        forward + work-conserving failover + hedged decode, module
        docstring); opaque ones — and overflow past the journal bound
        — fall back to the single-shot forward.

        Every request passes the weighted-fair QoS gate first (tenant
        + class from the caller or the body; queue wait burns the
        request's own deadline, so admission latency is never hidden).
        With ``relay`` set ("stream": true clients) the journaled path
        streams the journal feed to the client as NDJSON; when the
        payload cannot be journaled the stream request is REFUSED
        up-front (400 / 503) rather than breaking the protocol with a
        single-shot JSON body."""
        deadline_s = (self.deadline_s if deadline_s is None
                      else float(deadline_s))
        t0 = time.monotonic()
        self.stats_counters["forwards"] += 1
        if self._obs:
            self._m_forwards.inc()
        parsed = None
        try:
            parsed = json.loads(payload or b"{}")
        except ValueError:
            parsed = None
        if isinstance(parsed, dict):
            tenant = parsed.get("tenant") or tenant
            qos_class = parsed.get("qos_class") or qos_class
        tenant = str(tenant or "anon")
        qcls = _QosScheduler.class_of(qos_class)

        # -- weighted-fair admission ------------------------
        in_qos = False
        if self.qos.enabled:
            state, ra = self.qos.try_acquire(tenant, qcls,
                                             timeout=deadline_s)
            if state != "admitted":
                self.stats_counters["qos_shed"] += 1
                if self._obs:
                    self._m_qos_shed.inc(**{"qos_class": qcls})
                if state == "timeout":
                    # the whole deadline burned waiting in queue: the
                    # 503 face the deadline contract already promises,
                    # with the drain-truthful hint attached
                    self.stats_counters["deadline_503"] += 1
                    return (503, {"error": "deadline_exceeded",
                                  "deadline_s": deadline_s,
                                  "qos_class": qcls,
                                  "tenant": tenant}, ra)
                return (429, {"error": "qos_shed",
                              "qos_class": qcls, "tenant": tenant}, ra)
            in_qos = True
            self.stats_counters["qos_admitted"] += 1
            if self._obs:
                self._m_qos_admitted.inc(**{"qos_class": qcls})

        result = None
        try:
            result = self._dispatch_generate(
                payload, parsed, deadline_s, request_id, t0, qcls,
                relay)
            return result
        finally:
            if in_qos:
                toks = 0
                if result is not None and isinstance(result[1], dict):
                    try:
                        toks = int(result[1].get("tokens_generated", 0))
                    except (TypeError, ValueError):
                        toks = 0
                self.qos.release(tenant, qcls, toks)

    def _dispatch_generate(self, payload: bytes, parsed, deadline_s,
                           request_id, t0, qcls: str,
                           relay: Optional[_ClientRelay]):
        """Route one admitted request: journaled (streaming/recovering)
        path when the payload is token-shaped and the journal has
        room, single-shot otherwise."""
        journal_on = self.recovery and self.journal_max > 0
        if (journal_on and isinstance(parsed, dict)
                and "input_ids" in parsed):
            prompt = _flatten_ids(parsed.get("input_ids"))
            ok = prompt is not None
            if ok:
                try:
                    max_new = int(parsed.get("max_new_tokens", 32))
                    eos = parsed.get("eos_token_id")
                    eos = None if eos is None else int(eos)
                    seed = int(parsed.get("seed", 0))
                except (TypeError, ValueError):
                    ok = False
            if ok and max_new >= 1:
                with self._lock:
                    admit = self._journaled < self.journal_max
                    if admit:
                        self._journaled += 1
                if admit:
                    try:
                        return self._forward_recovering(
                            prompt, max_new, eos, seed, deadline_s,
                            request_id, t0, qcls=qcls, relay=relay)
                    finally:
                        with self._lock:
                            self._journaled -= 1
                if relay is not None:
                    # the journal IS the client stream — at capacity
                    # the stream request sheds truthfully instead of
                    # degrading to a protocol-breaking JSON body
                    self.stats_counters["relayed_503"] += 1
                    return (503, {"error": "overloaded",
                                  "reason": "journal at capacity"},
                            TIER_RETRY_AFTER_S["overloaded"])
        if relay is not None:
            # stream requested but unservable: not token-shaped, or
            # journaling is off — refuse up-front, before any NDJSON
            # head could be written
            if not journal_on:
                return (503, {"error": "stream_unavailable",
                              "reason": "journaling disabled on this "
                                        "tier"},
                        TIER_RETRY_AFTER_S["overloaded"])
            return (400, {"error": "stream_requires_token_ids"}, None)
        if isinstance(parsed, dict) and parsed.get("stream"):
            # the single-shot fallback is non-streaming to replicas;
            # never let a leaked stream flag make a replica answer the
            # single-shot path with NDJSON it cannot parse
            parsed = {k: v for k, v in parsed.items() if k != "stream"}
            payload = json.dumps(parsed).encode()
        return self._forward_plain(payload, deadline_s, request_id, t0)

    def _forward_plain(self, payload: bytes, deadline_s: float,
                       request_id: Optional[str], t0: float):
        """The single-shot (pre-recovery) forward path: one whole
        response per attempt, retry-on-a-different-replica under the
        shared RetryPolicy (which honors each shed's Retry-After
        hint). Kept for opaque payloads and journal-bound overflow."""
        tried: set = set()
        first_attempt = True

        def attempt():
            nonlocal first_attempt
            if not first_attempt:
                self.stats_counters["retries"] += 1
                if self._obs:
                    self._m_retries.inc()
            first_attempt = False
            remaining = deadline_s - (time.monotonic() - t0)
            if remaining <= 0:
                raise _DeadlineExceeded()
            rep = self._pick(tried)
            if rep is None and tried:
                # every replica tried once: a retry may still land (a
                # shed clears, an ejection lapses) — reopen the field
                # rather than fail inside the remaining budget
                tried.clear()
                rep = self._pick(tried)
            if rep is None:
                raise _NoReplica()
            tried.add(rep.name)
            with self._lock:
                rep.inflight += 1
            fwd_token = (_obs.trace.begin_span(
                "router.forward", cat="router", replica=rep.name,
                request_id=request_id) if self._obs else None)
            t_fwd = time.perf_counter()
            try:
                _resil.maybe_inject("router_forward")
                headers = {"Content-Type": "application/json"}
                if request_id:
                    headers[REQUEST_ID_HEADER] = request_id
                req = urllib.request.Request(
                    rep.base_url + "/generate", payload, headers)
                with urllib.request.urlopen(req,
                                            timeout=remaining) as r:
                    body = json.loads(r.read())
                rep.failure_streak = 0
                if self._obs:
                    self._m_forward.observe(
                        (time.perf_counter() - t_fwd) * 1e3,
                        replica=rep.name)
                body["served_by"] = rep.name
                return 200, body, None
            except urllib.error.HTTPError as e:
                try:
                    body = json.loads(e.read())
                except (ValueError, OSError):
                    body = {"error": f"http_{e.code}"}
                if e.code == 503:
                    # truthful shed from a live server — not a breaker
                    # hit; retry on a different replica
                    exc = _ShedByReplica(rep, body)
                    if self._pick(tried) is not None:
                        # an UNTRIED replica is routable: the hint
                        # describes THIS replica's capacity, not the
                        # tier's — retry elsewhere on the fast
                        # jittered schedule instead of serving one
                        # replica's Retry-After against another. The
                        # hint still reaches the client on the relay
                        # path (re-derived from the body).
                        exc.retry_after_s = None
                    raise exc
                if e.code >= 500:
                    self._note_failure(rep)
                    raise _ForwardFailed(
                        rep, body.get("error", f"http {e.code}"))
                body["served_by"] = rep.name
                return e.code, body, None    # 4xx: the client's problem
            except _resil.FaultInjected as e:
                self._note_failure(rep)
                raise _ForwardFailed(rep, str(e))
            except _REPLICA_IO_ERRORS as e:
                reason = getattr(e, "reason", e)
                if isinstance(reason, (socket.timeout, TimeoutError)) \
                        or "timed out" in str(e).lower():
                    # the forward burned the request's whole remaining
                    # budget inside one replica: no budget left to retry
                    self._note_failure(rep)
                    raise _DeadlineExceeded()
                self._note_failure(rep)
                raise _ForwardFailed(rep, str(e))
            finally:
                if fwd_token is not None:
                    _obs.trace.end_span(fwd_token)
                with self._lock:
                    rep.inflight -= 1

        try:
            remaining = deadline_s - (time.monotonic() - t0)
            return self.retry_policy.run(attempt, deadline=remaining)
        except _NoReplica:
            self.stats_counters["tier_unavailable_503"] += 1
            with self._lock:
                n = len(self._replicas)
            return (503,
                    {"error": "no_replica_ready", "replicas": n,
                     "ready": self.ready_count()},
                    TIER_RETRY_AFTER_S["no_replica_ready"]
                    + self.poll_s)
        except _DeadlineExceeded:
            self.stats_counters["deadline_503"] += 1
            return (503, {"error": "deadline_exceeded",
                          "deadline_s": deadline_s},
                    TIER_RETRY_AFTER_S["deadline_exceeded"])
        except _ShedByReplica as e:
            # retries exhausted and the last word was a truthful shed:
            # relay it (it already carries the replica's retry hint)
            self.stats_counters["relayed_503"] += 1
            body = dict(e.body)
            body["served_by"] = e.replica.name
            # re-derive from the body: retry_after_s may have been
            # nulled for SLEEP purposes (untried replica available),
            # but the relay owes the client the replica's truth
            ra = _retry_after_hint(e.body)
            return (503, body,
                    ra if ra is not None
                    else TIER_RETRY_AFTER_S["overloaded"])
        except _ForwardFailed as e:
            self.stats_counters["backend_503"] += 1
            return (503, {"error": f"backend_unavailable: {e}"},
                    TIER_RETRY_AFTER_S["backend_unavailable"])

    # -- work-conserving recovery + hedged decode -------------
    def _hedge_budget(self) -> Optional[float]:
        """Seconds of token-progress silence before a backup decode
        launches. An explicit PADDLE_TPU_TIER_HEDGE_S wins (0 turns
        hedging off); otherwise the budget derives from the LIVE
        inter-progress histogram — hedge_mult x p99, clamped to
        [0.25s, deadline/4] — so it tracks whatever the tier's real
        decode cadence is. A cold tier (sparse histogram) uses a
        conservative 2s default."""
        if self.hedge_s == 0:
            return None
        if self.hedge_s > 0:
            return float(self.hedge_s)
        hi = max(0.5, self.deadline_s / 4.0)
        if self._obs:
            snap = self._m_progress.snap()
            if snap.count >= 32:
                b = snap.percentile(0.99) / 1e3 * self.hedge_mult
                return min(max(b, 0.25), hi)
        return min(2.0, hi)

    def _ttft_budget(self) -> Optional[float]:
        """Seconds of FIRST-token silence before an admission-stall
        backup launches — the decode-stall twin above only
        watches requests that already produced a token, so a replica
        wedging in prefill/queue used to stall the client until the
        deadline. Same shape as the decode budget: an explicit
        PADDLE_TPU_TIER_TTFT_HEDGE_S wins (0 disables), else
        ttft_hedge_mult x the live TTFT histogram p99, clamped to
        [0.25s, deadline/4]; a cold tier (sparse histogram) uses a
        conservative 2s default."""
        if self.ttft_hedge_s == 0:
            return None
        if self.ttft_hedge_s > 0:
            return float(self.ttft_hedge_s)
        hi = max(0.5, self.deadline_s / 4.0)
        if self._obs:
            snap = self._m_ttft.snap()
            if snap.count >= 32:
                b = snap.percentile(0.99) / 1e3 * self.ttft_hedge_mult
                return min(max(b, 0.25), hi)
        return min(2.0, hi)

    def _reserve_hedge(self) -> bool:
        """Atomically claim one slot of the tier-wide hedge budget:
        at most ``hedge_frac`` of the live journaled requests (floor
        1) may be running a backup at once. The stall clock starts at
        submission, so on a saturated tier EVERY queued request looks
        silent past the budget — uncapped, hedging would double the
        tier's own load exactly when it has no headroom, amplifying
        the overload it was meant to absorb. A lone straggler always
        clears the floor."""
        with self._lock:
            cap = max(1, int(self._journaled * self.hedge_frac))
            if self._hedges_live >= cap:
                return False
            self._hedges_live += 1
            return True

    def _release_hedge(self):
        with self._lock:
            self._hedges_live -= 1

    def _note_recovery(self, rid, resumed_tokens: int, to_name: str):
        """Book one work-conserving failover: counters, a recovery
        span, and a flight-recorder artifact naming the migrated
        request ids (throttled: bursts fold into one dump)."""
        self.stats_counters["recoveries"] += 1
        if self._obs:
            self._m_recoveries.inc()
            now = time.perf_counter()
            _obs.record_span("router.recover", now, now, cat="router",
                             request_id=rid,
                             resumed_tokens=resumed_tokens,
                             to_replica=to_name)
        batch = None
        with self._lock:
            self._recovered_rids.append(
                {"request_id": rid, "resumed_tokens": resumed_tokens,
                 "to_replica": to_name})
            if time.monotonic() - self._last_recovery_dump >= 2.0:
                batch, self._recovered_rids = self._recovered_rids, []
                self._last_recovery_dump = time.monotonic()
        if batch:
            try:
                _obs.dump_flight("request_recovery",
                                 extra={"migrated": batch})
            except Exception:   # noqa: BLE001 — forensics best-effort
                pass

    def _prewarm_standby(self, rid, toks: List[int], exclude: set,
                         page_size: int) -> Optional[str]:
        """Push ``toks`` (prompt + journaled prefix) through a STANDBY
        replica's /prewarm so its paged trie already holds the pages a
        failover's resumed prefill would otherwise recompute.
        Best-effort and off the request's critical path (the
        coordinator fires it on a daemon thread): a shed, a dead
        standby, or no standby at all costs the stream nothing but the
        head start. Returns the warmed replica's name, or None."""
        rep = self._pick(exclude)
        if rep is None:
            return None
        hdrs = {"Content-Type": "application/json"}
        if rid:
            hdrs[REQUEST_ID_HEADER] = f"{rid}.prewarm"
        try:
            req = urllib.request.Request(
                rep.base_url + "/prewarm",
                json.dumps({"input_ids": list(toks)}).encode(), hdrs)
            with urllib.request.urlopen(req, timeout=30.0) as resp:
                body = json.loads(resp.read() or b"{}")
        except _REPLICA_IO_ERRORS:
            return None
        if not body.get("prewarmed"):
            return None
        self.stats_counters["prewarms"] += 1
        if self._obs:
            self._m_prewarms.inc()
        # fold the warm pages into the standby's fingerprint view NOW:
        # a cutover can beat the next health poll, and affinity scoring
        # must already see the pre-warmed prefix for the resume to land
        # there (the poll later replaces this with the replica's own
        # healthz truth)
        if page_size:
            fps = frozenset(chain_hashes(list(toks), page_size))
            with self._lock:
                rep.prefix_fps = rep.prefix_fps | fps
        return rep.name

    def _forward_recovering(self, prompt: List[int], max_new: int,
                            eos, seed: int, deadline_s: float,
                            rid: Optional[str], t0: float,
                            qcls: str = QOS_DEFAULT,
                            relay: Optional[_ClientRelay] = None):
        """The per-request recovery state machine (module docstring).

        One primary :class:`_StreamAttempt` streams the request; the
        coordinator below watches the shared journal and reacts:

        * attempt DONE -> compose the client body (rewriting
          prompt_len / tokens_generated back to the client's original
          frame — a resumed attempt's response is already the full
          token sequence, only its accounting is shifted);
        * journal COMPLETE but no terminal record (the replica died
          after the last token, before ``done``) -> synthesize the
          body from the journal alone;
        * attempt FAILED mid-stream -> relaunch on another replica
          from ``prompt + journal`` (a recovery — exact by greedy
          determinism, prefix-trie-cheap, no new kernel builds);
          consecutive no-progress launches are budgeted by the retry
          policy (sheds honor the replica's Retry-After hint), but a
          launch that ADVANCED the journal resets the budget — forward
          progress is never punished as a retry storm;
        * token progress STALLED past the hedge budget -> launch a
          backup on a second replica; first to advance wins, the loser
          is cancelled (engine slot + pages reclaimed) and a winning
          hedge books a breaker strike against the straggler. Before
          the FIRST token the stall clock runs against the TTFT budget
          instead (``_ttft_budget``) — admission stalls hedge too;
        * with a client ``relay`` armed, every terminal outcome is
          handed to the relay as the stream's terminal line, and a
          relay reporting the client gone cancels all live attempts.
        """
        ttft_cb = itl_cb = None
        if self._obs:
            def ttft_cb(ms, _c=qcls):
                self._m_ttft.observe(ms)
                self._m_ttft_class.observe(ms, **{"qos_class": _c})

            def itl_cb(ms, _c=qcls):
                self._m_itl_class.observe(ms, **{"qos_class": _c})
        st = _ReqJournal(prompt, max_new, eos, seed, rid,
                         hist=(self._m_progress if self._obs else None),
                         ttft_cb=ttft_cb, itl_cb=itl_cb)
        # prefix-affinity: the prompt's chain hashes, computed once —
        # launch() re-hashes prompt+journal on a resume so cutover
        # lands on the replica whose trie the resumed prefill will
        # warm/hit
        _ps = self._tier_page_size() if self.affinity_w > 0 else 0
        prompt_hashes = chain_hashes(prompt, _ps) if _ps else None

        def respond(code, body, ra=None):
            """Every terminal outcome funnels here: with a client
            relay armed, the body becomes the stream's terminal line
            (200 -> done, anything else -> a truthful err record with
            the code + retry hint inlined, since a mid-stream client
            can no longer see HTTP status)."""
            if relay is not None and relay.started_http:
                if code == 200:
                    relay.finish("done", body)
                else:
                    err = dict(body)
                    err["code"] = code
                    if ra is not None:
                        err.setdefault("retry_after_s", ra)
                    relay.finish("err", err)
            return code, body, ra
        deadline_at = t0 + deadline_s
        attempts: List[_StreamAttempt] = []
        tried: set = set()
        seq = 0
        nprog = 0                # consecutive launches without progress
        len_at_launch = -1
        recovered = 0
        hedges_launched = 0
        need_launch = False      # a failed attempt awaits relaunch —
        #                          persists across poll iterations so a
        #                          momentarily replica-less tier (the
        #                          survivor ejected, the respawn still
        #                          warming) keeps retrying launch()
        #                          instead of idling to the deadline
        # Seeding a resume with journaled tokens is only deterministic
        # for greedy decode: a sampling engine rolls tok0 from the raw
        # key at admit but fold_in(key, pos) in the decode loop, so a
        # resumed base would re-roll DIFFERENT tokens and mismatch the
        # journal on its first block. A sampling tier still journals,
        # recovers, and hedges — every relaunch just re-runs from
        # scratch (same seed => same tokens) and the journal VERIFIES
        # the regenerated prefix instead of seeding it: token-exact,
        # not work-saving. Also set later on resume-reject / mismatch.
        force_full = bool(self.spec.engine.get("do_sample", False))
        pending_hint = None
        last_shed: Optional[_StreamAttempt] = None
        last_fail = "no attempt"

        complete_since = None    # journal complete, waiting (briefly)
        #                          for the live attempt's terminal line

        # standby prefix pre-warming: as the journal crosses
        # page boundaries, a daemon thread pushes prompt+journal through
        # a standby's /prewarm — the failover target's trie then already
        # holds the resumed prefill's pages when a cutover happens
        prewarmed: set = set()   # replicas warmed for THIS request
        pw_busy = [False]        # one in-flight prewarm at a time
        pw_pages = [0]           # page count already pushed

        def maybe_prewarm(live_names: set):
            if (not self.prewarm or not _ps or pw_busy[0]
                    or st.complete()):
                return
            with st.cond:
                cur = list(st.tokens)
            pages = (len(prompt) + len(cur)) // _ps
            if pages <= pw_pages[0]:
                return
            pw_pages[0] = pages
            pw_busy[0] = True
            toks = prompt + cur

            # NOT excluding already-warmed standbys: re-picking the
            # same one extends its trie with the grown prefix, which is
            # exactly what keeps the failover target current
            def _pw(toks=toks, ex=set(tried) | set(live_names)):
                try:
                    name = self._prewarm_standby(rid, toks, ex, _ps)
                    if name:
                        prewarmed.add(name)
                finally:
                    pw_busy[0] = False
            threading.Thread(target=_pw, daemon=True,
                             name=f"tier-prewarm-{rid or 'anon'}"
                             ).start()

        def cancel_all(exclude=None, wait=True):
            losers = [a for a in attempts
                      if a is not exclude and a.status == "running"]
            if not losers:
                return
            if wait:
                for a in losers:
                    a.cancel()
                return
            # winner path: don't make the winning client's response
            # wait on loser-side /cancel round trips
            threading.Thread(
                target=lambda: [a.cancel() for a in losers],
                daemon=True, name="tier-cancel-losers").start()

        def launch(is_hedge=False):
            nonlocal seq, nprog, len_at_launch, recovered, \
                hedges_launched
            live_names = {a.rep.name for a in attempts
                          if a.status == "running"}
            keys = prompt_hashes
            if _ps and st.size() > 0:
                # resuming mid-flight: score by prompt + journaled
                # prefix — the residual prefill warms (or already
                # hits) exactly those pages on the target, so the
                # cutover lands where the work is cheapest
                with st.cond:
                    cur = list(st.tokens)
                keys = chain_hashes(prompt + cur, _ps)
            # keys=None keeps the legacy one-arg call shape (tests
            # stub _pick with single-parameter callables)
            rep = (self._pick(tried | live_names, keys) if keys
                   else self._pick(tried | live_names))
            if rep is None and tried:
                # every replica was tried once: a retry may still land
                # (a shed clears, an ejection lapses) — reopen the
                # field, same policy as the single-shot path
                tried.clear()
                rep = (self._pick(set(live_names), keys) if keys
                       else self._pick(set(live_names)))
            if rep is None:
                return None
            if seq > 0 and rep.name in prewarmed:
                # the cutover landed where the router pre-warmed: the
                # resumed prefill (or hedge re-run) starts on trie hits
                self.stats_counters["prewarmed_resumes"] += 1
                if self._obs:
                    self._m_prewarmed_resumes.inc()
            base = 0 if force_full else st.size()
            if not is_hedge:
                if seq > 0:
                    self.stats_counters["retries"] += 1
                    if self._obs:
                        self._m_retries.inc()
                    if st.size() > 0:
                        recovered += 1
                        self._note_recovery(rid, base, rep.name)
                nprog = 1 if st.size() > len_at_launch else nprog + 1
                len_at_launch = st.size()
            else:
                hedges_launched += 1
                self.stats_counters["hedges"] += 1
                if self._obs:
                    self._m_hedges.inc()
                    now = time.perf_counter()
                    _obs.record_span("router.hedge", now, now,
                                     cat="router", request_id=rid,
                                     replica=rep.name,
                                     journal_tokens=base)
            a = _StreamAttempt(self, rep, st, base, deadline_at,
                               is_hedge, seq)
            seq += 1
            attempts.append(a)
            with st.cond:
                # the stall clock measures token SILENCE, not failover
                # latency: a fresh launch re-arms it, so the reap ->
                # backoff -> relaunch window of a recovery doesn't
                # read as a stall and hedge a healthy resumed attempt
                # (a winning hedge would then strike the innocent
                # primary's breaker)
                st.last_progress = time.monotonic()
            a.start()
            return a

        if launch() is None:
            # pre-stream failure: the relay never began, so the client
            # gets a plain JSON 503 (no NDJSON head on the wire yet)
            self.stats_counters["tier_unavailable_503"] += 1
            with self._lock:
                n = len(self._replicas)
            return (503,
                    {"error": "no_replica_ready", "replicas": n,
                     "ready": self.ready_count()},
                    TIER_RETRY_AFTER_S["no_replica_ready"]
                    + self.poll_s)
        if relay is not None:
            # committed to the journaled path: from here on the
            # journal feed IS the client's response stream
            self.stats_counters["streams"] += 1
            if self._obs:
                self._m_streams.inc()
            relay.begin(st)

        while True:
            now = time.monotonic()
            if relay is not None and relay.dead:
                # the client hung up mid-stream: cancel EVERY live
                # attempt on whichever replica owns the request now —
                # slot retired, pages freed — and account the tokens
                # the journal actually produced
                cancel_all(wait=False)
                self.stats_counters["client_disconnects"] += 1
                if self._obs:
                    self._m_disconnects.inc()
                return 499, {"error": "client_disconnected",
                             "tokens_generated": st.size()}, None
            if now >= deadline_at:
                # wait=False on every response-returning path: a
                # half-dead loser's /cancel round trip (2s timeout
                # each) must never delay the client's answer
                cancel_all(wait=False)
                self.stats_counters["deadline_503"] += 1
                return respond(
                    503, {"error": "deadline_exceeded",
                          "deadline_s": deadline_s},
                    TIER_RETRY_AFTER_S["deadline_exceeded"])
            winner = next((a for a in attempts if a.status == "done"),
                          None)
            if winner is not None:
                if winner.is_hedge:
                    self.stats_counters["hedge_wins"] += 1
                    if self._obs:
                        self._m_hedge_wins.inc()
                    # the straggler earned a breaker strike: a replica
                    # that keeps losing its own requests to hedges
                    # must leave the rotation for a cooldown
                    for a in attempts:
                        if (a is not winner and not a.is_hedge
                                and a.status == "running"):
                            self._note_failure(a.rep)
                cancel_all(exclude=winner, wait=False)
                body = dict(winner.done_body or {})
                toks = body.get("tokens") or []
                body["served_by"] = winner.rep.name
                # rewrite accounting into the CLIENT's frame: the
                # resumed attempt saw prompt+journal as its prompt
                body["prompt_len"] = len(prompt)
                body["new_tokens"] = max(0, len(toks) - len(prompt))
                body["tokens_generated"] = winner.base + int(
                    body.get("tokens_generated", 0))
                # ... and the request id: the replica echoed the
                # ATTEMPT's derived id ("<rid>.<seq>") — correlation
                # belongs to the client's original
                if rid:
                    body["request_id"] = rid
                else:
                    body.pop("request_id", None)
                if recovered:
                    body["recovered"] = recovered
                if winner.is_hedge:
                    body["hedged"] = True
                return respond(200, body)
            live = [a for a in attempts if a.status == "running"]
            maybe_prewarm({a.rep.name for a in live})
            if st.complete():
                # the journal alone already holds the full output.
                # Normally the live attempt's terminal record is
                # microseconds behind its last token event — give it a
                # short grace so the replica's own body wins; past the
                # grace (or with no attempt left: the replica died
                # between its last token and `done`) synthesize from
                # the journal — greedy determinism + the engine's
                # eos-padding contract make it exact.
                if live and complete_since is None:
                    complete_since = now
                if not live or now - complete_since >= 1.0:
                    cancel_all(wait=False)
                    body = st.synthesize_body()
                    if recovered:
                        body["recovered"] = recovered
                    return respond(200, body)
            else:
                complete_since = None
            relaunch = False
            for a in attempts:
                if a.status != "failed" or a.reaped:
                    continue
                a.reaped = True
                if a.kind == "cancelled":
                    continue
                if a.kind == "client_error":
                    if a.base > 0:
                        # the replica 400'd a RESUMED prompt (outgrew
                        # its prefill buckets): fall back to a
                        # from-scratch re-run — the journal then
                        # VERIFIES the regenerated prefix instead of
                        # seeding it (token-exact, just not
                        # work-saving)
                        force_full = True
                        self.stats_counters["resume_fallbacks"] += 1
                        relaunch = not live
                        continue
                    cancel_all(wait=False)
                    body = dict(a.body or {"error": "client error"})
                    body["served_by"] = a.rep.name
                    return respond(a.code, body)
                if a.kind == "mismatch":
                    # determinism violated against the journal (e.g. a
                    # hedge pair diverging, or a resumed base on an
                    # engine whose key path is position-dependent):
                    # same verdict as the resume-reject path above —
                    # fall back to a from-scratch re-run, which the
                    # journal VERIFIES instead of seeds. Retrying the
                    # resume at the same base would mismatch forever.
                    force_full = True
                    self.stats_counters["resume_fallbacks"] += 1
                    last_fail = a.reason
                    relaunch = not live
                    continue
                if a.kind == "shed":
                    last_shed = a
                    pending_hint = a.retry_after
                    tried.add(a.rep.name)
                    relaunch = not live
                    continue
                tried.add(a.rep.name)       # io-class failure
                last_fail = a.reason
                relaunch = not live
            need_launch = need_launch or relaunch
            if need_launch and not live:
                if nprog >= self.retry_policy.max_attempts:
                    # no forward progress across the whole budget:
                    # same verdicts as the single-shot path
                    if last_shed is not None:
                        self.stats_counters["relayed_503"] += 1
                        body = dict(last_shed.body or {})
                        body["served_by"] = last_shed.rep.name
                        return respond(
                            503, body,
                            last_shed.retry_after
                            if last_shed.retry_after is not None
                            else TIER_RETRY_AFTER_S["overloaded"])
                    self.stats_counters["backend_503"] += 1
                    return respond(
                        503,
                        {"error":
                         f"backend_unavailable: {last_fail}"},
                        TIER_RETRY_AFTER_S["backend_unavailable"])
                if relaunch and st.size() <= len_at_launch:
                    # no progress since the last launch: back off on
                    # the shared schedule — honoring the replica's own
                    # Retry-After hint when the failure was a shed. A
                    # mid-stream death WITH progress relaunches
                    # immediately: failover must be work-conserving in
                    # time too. (Gated on `relaunch` — the freshly
                    # reaped failure — so the waiting-for-a-respawn
                    # path below doesn't re-pay the backoff on every
                    # poll.)
                    hint, pending_hint = pending_hint, None
                    if hint is not None and self._pick(tried) is not None:
                        # an untried replica is routable: the shed
                        # hint is the SHED replica's capacity story —
                        # relaunch elsewhere on the fast schedule
                        hint = None
                    budget = deadline_at - time.monotonic()
                    if budget > 0:
                        self.retry_policy.sleep(
                            min(max(nprog, 1),
                                max(1, self.retry_policy.max_attempts
                                    - 1)),
                            budget=budget, hint=hint)
                if launch() is not None:
                    need_launch = False
                elif st.size() == 0:
                    self.stats_counters["tier_unavailable_503"] += 1
                    with self._lock:
                        n = len(self._replicas)
                    return respond(
                        503,
                        {"error": "no_replica_ready",
                         "replicas": n,
                         "ready": self.ready_count()},
                        TIER_RETRY_AFTER_S["no_replica_ready"]
                        + self.poll_s)
                else:
                    # journaled work exists: WAIT for a replica (a
                    # respawn is usually poll_s away) instead of
                    # throwing the tokens away — `need_launch` keeps
                    # launch() retried on every pass until one lands,
                    # bounded by the request deadline above
                    time.sleep(min(self.poll_s,
                                   max(0.05,
                                       deadline_at - time.monotonic())))
                continue
            # live attempts exist: watch for stalls, then wait for
            # journal/attempt events. Before the FIRST token the
            # silence clock runs against the TTFT budget (admission
            # stalls — wedged prefill, stuck queue); after it, the
            # decode-progress budget. Both draw on the ONE tier-wide
            # hedge reservation.
            first_token_pending = st.size() == 0
            hb = (self._ttft_budget() if first_token_pending
                  else self._hedge_budget())
            with st.cond:
                silent = now - st.last_progress
            if (hb is not None and len(live) == 1
                    and silent >= hb and hedges_launched < 2
                    and not st.complete()
                    and self._reserve_hedge()):
                if launch(is_hedge=True) is None:
                    # no second replica yet: hand the budget slot back
                    # and re-check on the next wake
                    self._release_hedge()
                elif first_token_pending:
                    self.stats_counters["ttft_hedges"] += 1
                    if self._obs:
                        self._m_ttft_hedges.inc()
            with st.cond:
                timeout = 0.25
                if hb is not None and len(live) == 1:
                    # wake exactly when the hedge budget expires — but
                    # only while it HASN'T yet: once stalled with no
                    # launchable backup (budget-blocked, or no second
                    # replica), stay on the 0.25s cadence instead of
                    # spinning at the 0.01s floor
                    left = hb - (time.monotonic() - st.last_progress)
                    if left > 0:
                        timeout = min(timeout, max(0.01, left))
                timeout = min(timeout,
                              max(0.01, deadline_at - time.monotonic()))
                st.cond.wait(timeout=timeout)

    # -- introspection ---------------------------------------------------
    def _readiness(self):
        reps = self.replicas()
        ready = sum(1 for r in reps
                    if r["state"] == "ready" and not r["draining"]
                    and not r["ejected"])
        body = {"status": "ready" if ready else "unready",
                "tier": True,
                "uptime_s": round(time.monotonic() - self._started, 1),
                "metrics_seq": _obs.metrics.registry.seq(),
                "replicas_total": len(reps), "ready_replicas": ready,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "rolling_restart_in_progress": self._rolling_flag(),
                "queued_total": sum(r["queued"] for r in reps),
                "active_total": sum(r["active"] for r in reps),
                "inflight_total": sum(r["inflight"] for r in reps),
                "replicas": reps,
                "qos": self.qos.snapshot(),
                "stats": dict(self.stats_counters)}
        if not ready:
            body["reason"] = "no replica ready"
        return ready > 0, body

    def stats(self) -> dict:
        _, body = self._readiness()
        return body

    def render_metrics(self) -> str:
        """The tier /metrics body: the router's own registry, every
        reachable replica's scrape re-labeled ``replica="rN"``, and
        ``ptpu_tier_*`` aggregates summed across replicas (counters
        and cumulative histogram buckets sum exactly — tier-level
        phase percentiles come straight out of the summed buckets)."""
        with self._lock:
            reps = [(r.name, r.base_url) for r in self._replicas
                    if r.base_url is not None and not r.draining]
        # scrape CONCURRENTLY with one bounded join: tier scrape
        # latency must not grow linearly with replica count, and one
        # wedged replica (socket accepts, never answers) must cost the
        # scrape its own 2s budget at most, not 2s x N serialized
        scraped: Dict[str, str] = {}

        def pull(name, base):
            try:
                with urllib.request.urlopen(base + "/metrics",
                                            timeout=2.0) as r:
                    scraped[name] = r.read().decode()
            except _REPLICA_IO_ERRORS:
                pass            # a dead replica just drops out
        threads = [threading.Thread(target=pull, args=rb, daemon=True)
                   for rb in reps]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 2.5
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return _obs.metrics.render_tier(
            _obs.metrics.registry.render(), dict(scraped))

    # -- HTTP front ------------------------------------------------------
    def _make_handler(self):
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, obj, retry_after=None):
                # serve.send_json is the ONE Retry-After writer; the
                # tier only widens the reason table (no_replica_ready)
                send_json(self, code, obj, retry_after=retry_after,
                          retry_after_table=TIER_RETRY_AFTER_S)

            def _drain_body(self):
                try:
                    self.rfile.read(
                        int(self.headers.get("Content-Length", "0")))
                except (ValueError, OSError):
                    pass

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "ok"})
                elif self.path == "/healthz":
                    ready, body = router._readiness()
                    self._send(200 if ready else 503, body)
                elif self.path == "/metrics":
                    send_text(self, 200, router.render_metrics())
                elif self.path == "/metadata":
                    self._send(200, {"inputs": ["input_ids"],
                                     "outputs": ["tokens"]})
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path.startswith("/admin/trace"):
                    handle_admin_trace(self, self._drain_body)
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = self.rfile.read(n)
                except (ValueError, OSError):
                    payload = b""
                if self.path == "/generate":
                    # the tier is where a request id is BORN (unless
                    # the client brought one): it rides the header to
                    # the replica and comes back in the body, so a
                    # client can resolve its own phase spans later
                    rid = self.headers.get(REQUEST_ID_HEADER) or (
                        uuid.uuid4().hex[:16] if router._obs else None)
                    relay = None
                    if b'"stream"' in payload:
                        try:
                            want = bool(json.loads(
                                payload or b"{}").get("stream"))
                        except (ValueError, AttributeError):
                            want = False
                        if want:
                            relay = _ClientRelay(self, rid)
                    code, body, ra = router.forward_generate(
                        payload, request_id=rid,
                        tenant=self.headers.get(TENANT_HEADER),
                        qos_class=self.headers.get(CLASS_HEADER),
                        relay=relay)
                    if relay is not None and relay.started_http:
                        return    # the relay already answered NDJSON
                    if rid and isinstance(body, dict):
                        body.setdefault("request_id", rid)
                    try:
                        self._send(code, body, retry_after=ra)
                    except (BrokenPipeError, ConnectionError, OSError):
                        pass      # client gone before the JSON answer
                elif self.path == "/admin/rolling_restart":
                    # answer 409 from the HANDLER: Thread.start() never
                    # raises the in-progress error, the restart itself
                    # does (inside the daemon thread). The pre-check
                    # races a concurrent POST by a hair, so the thread
                    # target still swallows a lost race instead of
                    # dumping an uncaught exception to stderr
                    if router._rolling_lock.locked():
                        self._send(409, {"error": "rolling restart "
                                                  "already in progress"})
                        return

                    def _roll():
                        try:
                            router.rolling_restart()
                        except RuntimeError:
                            pass          # lost the race: one restart
                            #               is already running
                    threading.Thread(target=_roll, daemon=True,
                                     name="tier-rolling").start()
                    self._send(202, {"status": "rolling"})
                else:
                    self._send(404, {"error": f"no route {self.path}"})

        return Handler


# ---------------------------------------------------------------------------
# module entry: the replica-child hook the spawner uses
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="serving-tier internals (the replica child's entry "
                    "point; the operator CLI is not ported yet, ROADMAP.md "
                    "A14)")
    ap.add_argument("--replica-child", action="store_true")
    ap.add_argument("--spec", help="ReplicaSpec JSON")
    ap.add_argument("--port-file", help="where the child publishes its "
                                        "bound port")
    args = ap.parse_args(argv)
    if not args.replica_child:
        ap.error("this entry point only serves --replica-child; build a "
                 "tier with Router(ReplicaSpec(...)).start()")
    if not args.spec or not args.port_file:
        ap.error("--replica-child needs --spec and --port-file")
    return _replica_child_main(args)


if __name__ == "__main__":
    sys.exit(main())
