"""Fault tolerance: the retry schedule and fault injection (port of
paddle_tpu/distributed/resilience.py:61-475).

``RetryPolicy`` / ``with_retries``: the one backoff schedule (exponential,
jittered or full-jitter, an attempt cap and a total deadline, a server's
Retry-After hint used verbatim, an injectable clock); the serving tier's
router retries forwards and paces respawns on it.

``FaultInjector`` / ``maybe_inject`` / ``arm_fault``: env-var,
context-manager and programmatic fault simulation at named sites, so that
every recovery path can be driven on purpose. The serving tier's sites:
``serve_backend`` (the engine's ``submit`` and the server's ``/predict``
raise), ``serve_hang`` (``/predict`` wedges), ``replica_stall`` (the
engine's tick wedges), ``router_forward`` (a router-to-replica forward
fails), ``replica_spawn`` and ``replica_health`` (the router's spawn and
health poll fail); ``POST /admin/inject`` arms them in a live server when
``PADDLE_TPU_CHAOS_ADMIN=1``.

Not ported yet (ROADMAP.md): ``StepWatchdog``, ``LossSpikeDetector``, the
train-state save/restore and ``RngState`` (A5, A12); the sites they
instrument (``step_hang``, ``ckpt_shard``, ...) are known names here so
that a spec written for paddle_tpu parses, and nothing in the port fires
them.

This module imports only the standard library.

Env knobs:
  PADDLE_TPU_FAULT_INJECT     "site[:count],site..." fault spec
  PADDLE_TPU_FAULT_WEDGE_S    wedge-style fault duration (3600)
  PADDLE_TPU_RETRY_*          MAX_ATTEMPTS / BASE_DELAY / MAX_DELAY /
                              DEADLINE (``RetryPolicy.from_env``)
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "RetryPolicy", "with_retries", "ResilienceError", "FaultInjected", "FaultInjector", "maybe_inject",
    "should_fire", "wedge_seconds", "arm_fault",
]


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

class ResilienceError(RuntimeError):
    """Base class for failures the resilience layer detects/raises."""


class FaultInjected(ResilienceError):
    """Raised at an injection site when the configured fault fires."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site {site!r} "
                         "(PADDLE_TPU_FAULT_INJECT)")
        self.site = site


# ---------------------------------------------------------------------------
# RetryPolicy — the one backoff schedule
# ---------------------------------------------------------------------------

class RetryPolicy:
    """Exponential backoff with jitter, attempt caps, and a deadline.

    ``delay(attempt)`` is the DETERMINISTIC schedule (attempt is
    1-based; the delay is what to sleep *after* that attempt fails):
    ``min(base_delay * multiplier**(attempt-1), max_delay)``. Jitter is
    applied only in ``sleep(attempt)`` so callers that need the exact
    schedule (tests, the shell watcher mirroring these semantics) can
    read it.

    ``deadline`` is the TOTAL retry-time budget across attempts and
    sleeps: sleeps are capped to the remaining budget and once it is
    exhausted ``run`` re-raises instead of sleeping again — an attempt
    cap bounds tries, the deadline bounds wall-clock. A retry storm
    against a dead tier therefore gives up within the caller's
    deadline, never after attempts x max_delay. ``run(...,
    deadline=...)`` overrides per call so one shared policy can honor
    each request's own remaining budget.

    ``full_jitter=True`` switches the jittered sleep to the AWS
    full-jitter scheme — ``uniform(0, delay(attempt))`` — which
    decorrelates a thundering herd of retriers far better than the
    default +/-``jitter`` band around the deterministic schedule.
    ``delay``/``schedule`` stay deterministic either way.

    **Retry-After hints**: when a failed attempt's exception carries a
    ``retry_after_s`` attribute (the serving layer attaches the 503
    body's advisory backoff to every shed it relays), ``run`` sleeps
    exactly that hint — capped by the remaining deadline — instead of
    the policy schedule. The server's own word about when capacity
    clears beats any client-side guess; the hint is used verbatim (no
    jitter) so tests and the shell watcher can rely on it.

    ``clock``/``sleep_fn`` are injectable for tests (fake clock): they
    default to ``time.monotonic``/``time.sleep`` and are the ONLY
    time sources ``run`` consults.
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.5,
                 max_delay: float = 60.0, multiplier: float = 2.0,
                 jitter: float = 0.1, deadline: Optional[float] = None,
                 retry_on: Tuple[type, ...] = (Exception,),
                 full_jitter: bool = False,
                 clock: Optional[Callable[[], float]] = None,
                 sleep_fn: Optional[Callable[[float], None]] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.retry_on = retry_on
        self.full_jitter = bool(full_jitter)
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep_fn if sleep_fn is not None else time.sleep

    @classmethod
    def from_env(cls, prefix: str = "PADDLE_TPU_RETRY", **defaults):
        """Build a policy from ``<prefix>_MAX_ATTEMPTS / _BASE_DELAY /
        _MAX_DELAY / _DEADLINE`` env vars; malformed values fall back to
        the given defaults (a typo'd knob must never crash rendezvous)."""
        def num(name, cast, dflt):
            raw = os.environ.get(f"{prefix}_{name}")
            if raw is None:
                return dflt
            try:
                return cast(raw)
            except ValueError:
                return dflt
        kw = dict(defaults)
        kw["max_attempts"] = num("MAX_ATTEMPTS", int,
                                 defaults.get("max_attempts", 3))
        kw["base_delay"] = num("BASE_DELAY", float,
                               defaults.get("base_delay", 0.5))
        kw["max_delay"] = num("MAX_DELAY", float,
                              defaults.get("max_delay", 60.0))
        kw["deadline"] = num("DEADLINE", float, defaults.get("deadline"))
        return cls(**kw)

    # -- schedule --------------------------------------------------------
    def delay(self, attempt: int) -> float:
        """Deterministic post-attempt delay (attempt is 1-based)."""
        if attempt < 1:
            raise ValueError("attempt is 1-based")
        return min(self.base_delay * self.multiplier ** (attempt - 1),
                   self.max_delay)

    def schedule(self) -> Tuple[float, ...]:
        """The full inter-attempt delay schedule (len max_attempts-1)."""
        return tuple(self.delay(a) for a in range(1, self.max_attempts))

    def sleep(self, attempt: int, budget: Optional[float] = None,
              hint: Optional[float] = None) -> float:
        """Sleep the (jittered) post-attempt delay; returns the time
        slept. ``budget`` caps the sleep (remaining deadline). With
        ``full_jitter`` the sleep is drawn uniform from
        [0, delay(attempt)] instead of a +/-jitter band. A ``hint``
        (the server's Retry-After, in seconds) REPLACES the schedule
        verbatim — still capped by ``budget``."""
        if hint is not None:
            d = max(0.0, float(hint))
        else:
            d = self.delay(attempt)
            if self.full_jitter:
                d = random.uniform(0.0, d)
            elif self.jitter:
                d *= 1.0 + random.uniform(-self.jitter, self.jitter)
        if budget is not None:
            d = max(0.0, min(d, budget))
        if d > 0:
            self._sleep(d)
        return d

    # -- execution -------------------------------------------------------
    def run(self, fn: Callable, *args,
            on_retry: Optional[Callable[[int, BaseException], None]] = None,
            deadline: Optional[float] = None,
            **kwargs):
        """Call ``fn`` under this policy. ``on_retry(attempt, exc)`` is
        invoked before each backoff sleep (logging hook). ``deadline``
        overrides the policy's total retry-time budget for THIS call
        (a router passes each request's remaining forward budget)."""
        total = self.deadline if deadline is None else deadline
        start = self._clock()
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                if attempt >= self.max_attempts:
                    raise
                if total is not None:
                    remaining = total - (self._clock() - start)
                    if remaining <= 0:
                        # budget exhausted: give up NOW — within the
                        # caller's deadline, not attempts x max_delay
                        raise
                else:
                    remaining = None
                if on_retry is not None:
                    on_retry(attempt, e)
                hint = getattr(e, "retry_after_s", None)
                try:
                    hint = None if hint is None else float(hint)
                except (TypeError, ValueError):
                    hint = None
                self.sleep(attempt, budget=remaining, hint=hint)
        raise AssertionError("unreachable")


def with_retries(fn: Callable, *args,
                 policy: Optional[RetryPolicy] = None,
                 on_retry: Optional[Callable] = None, **kwargs):
    """Functional spelling: ``with_retries(fn, a, b, policy=p)``."""
    return (policy or RetryPolicy()).run(fn, *args, on_retry=on_retry,
                                         **kwargs)


# ---------------------------------------------------------------------------
# FaultInjector — env-var and context-manager driven fault simulation
# ---------------------------------------------------------------------------

# Known sites, each instrumented at exactly one layer of paddle_tpu (the
# port instruments the serving tier's: serve_backend, serve_hang,
# replica_stall, router_forward, replica_spawn and replica_health):
#   collective          wedge inside an eager collective (sleeps)
#   host_drop           TCPStore get/wait raises TimeoutError
#   ckpt_shard          corrupt a just-written checkpoint (marker+shard)
#   ckpt_crash          die mid-save, AFTER shard bytes, BEFORE publish
#   dataloader_worker   hard-kill a forked DataLoader worker (os._exit)
#   step_hang           a train step wedges (sleeps)
#   step_nan            a train step's loss comes back NaN
#   train_crash         the training process dies mid-epoch (raises)
#   serve_backend       predictor backend unavailable (raises)
#   serve_hang          predictor wedges (sleeps)
#   router_forward      a router->replica forward attempt fails (raises;
#                       the router treats it like a connection failure
#                       and retries on a DIFFERENT replica)
#   replica_spawn       spawning a serving-tier replica fails (raises;
#                       the tier control loop retries on its next pass)
#   replica_health      a replica health poll fails (raises; counts
#                       toward the router's unhealthy streak)
#   replica_stall       a replica's engine decode loop WEDGES (sleeps —
#                       latency injection, not death: the process stays
#                       alive, /healthz keeps answering ready, only
#                       token progress stops; the straggler scenario
#                       the router's hedged decode exists for)
#   train_step_nan      hapi Model.train_batch reports a NaN loss for
#                       one step (the real program still ran — a
#                       transient divergence the supervisor's rollback
#                       must survive; N firings under nan_limit=N make
#                       a full storm)
#   preempt_signal      the TrainSupervisor observes a synthetic
#                       SIGTERM at the next step boundary (preemption
#                       grace path without a real signal — drivable
#                       from env in subprocess children)
#   ckpt_gc             checkpoint retention GC fails before deleting
#                       anything (distributed/checkpoint.gc_checkpoints
#                       — GC failure must never take training down)
#   lock_hold           an InstrumentedLock (obs/locks.py, the tpurace
#                       sanitizer) holds its lock for wedge_seconds()
#                       INSIDE release() — an artificial hold-time
#                       spike that lights up ptpu_lock_wait_ms and the
#                       deadlock watchdog without a real wedge
#   ckpt_reshard        a topology-elastic restore dies MID-reshard
#                       (checkpoint.reshard_state_dict, after >= 1 leaf
#                       landed) — restore is read-only, so the
#                       checkpoint must survive untouched and the next
#                       attempt must succeed; the supervisor books the
#                       failure as one restart-budget strike
_KNOWN_SITES = frozenset([
    "collective", "host_drop", "ckpt_shard", "ckpt_crash",
    "dataloader_worker", "step_hang", "step_nan", "train_crash",
    "serve_backend", "serve_hang",
    "router_forward", "replica_spawn", "replica_health",
    "replica_stall",
    "train_step_nan", "preempt_signal", "ckpt_gc", "ckpt_reshard",
    "lock_hold",
])

_inject_lock = threading.Lock()
_active: Dict[str, int] = {}       # site -> remaining fire count
_env_parsed = False
_wedge_s: Optional[float] = None


def _parse_spec(spec: str) -> Dict[str, int]:
    """``"site[:count],site2"`` -> {site: count}. Unknown sites raise —
    a typo'd site name silently never firing is the worst failure mode
    a fault-injection harness can have."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, cnt = part.partition(":")
        name = name.strip()
        if name not in _KNOWN_SITES:
            raise ValueError(
                f"unknown fault-injection site {name!r}; known: "
                f"{sorted(_KNOWN_SITES)}")
        out[name] = int(cnt) if cnt else 1
    return out


def _ensure_env_loaded():
    global _env_parsed
    with _inject_lock:
        if _env_parsed:
            return
        _env_parsed = True
        spec = os.environ.get("PADDLE_TPU_FAULT_INJECT", "")
        if spec:
            for site, cnt in _parse_spec(spec).items():
                _active[site] = _active.get(site, 0) + cnt


def should_fire(site: str) -> bool:
    """Consume one firing of ``site`` if armed. Thread-safe; each
    configured count fires exactly once per process (forked DataLoader
    workers inherit a copy of the counters, so a per-worker site fires
    up to count times in EACH worker — tests account for this)."""
    _ensure_env_loaded()
    with _inject_lock:
        n = _active.get(site, 0)
        if n <= 0:
            return False
        _active[site] = n - 1
        return True


def wedge_seconds(default: float = 3600.0) -> float:
    """How long a wedge-style fault blocks. Production default is an
    hour (indistinguishable from a real wedged tunnel); tests set
    PADDLE_TPU_FAULT_WEDGE_S (or FaultInjector(wedge_s=...)) small."""
    if _wedge_s is not None:
        return _wedge_s
    try:
        return float(os.environ.get("PADDLE_TPU_FAULT_WEDGE_S", default))
    except ValueError:
        return default


def maybe_inject(site: str) -> None:
    """The one hook instrumented code calls. Raises ``FaultInjected``
    for crash-type sites; SLEEPS for wedge-type sites (a wedge hangs,
    it does not error — that is the whole point)."""
    if not should_fire(site):
        return
    if site in ("collective", "step_hang", "serve_hang",
                "replica_stall", "lock_hold"):
        time.sleep(wedge_seconds())
        return
    if site == "host_drop":
        raise TimeoutError(
            "injected: peer host dropped out of rendezvous "
            "(PADDLE_TPU_FAULT_INJECT=host_drop)")
    raise FaultInjected(site)


def arm_fault(site: str, count: int = 1,
              wedge_s: Optional[float] = None) -> None:
    """Programmatic (non-context) arming of an injection site — the
    serving tier's chaos admin endpoint (``POST /admin/inject``, gated
    on PADDLE_TPU_CHAOS_ADMIN) uses it to wedge/fail a LIVE replica
    from outside the process. Counts add like nested FaultInjectors;
    there is no paired disarm — an armed-but-unfired count stays armed
    for the life of the process (chaos tooling arms exactly what it
    intends to fire)."""
    global _wedge_s
    if site not in _KNOWN_SITES:
        raise ValueError(
            f"unknown fault-injection site {site!r}; known: "
            f"{sorted(_KNOWN_SITES)}")
    _ensure_env_loaded()
    with _inject_lock:
        _active[site] = _active.get(site, 0) + int(count)
        if wedge_s is not None:
            _wedge_s = float(wedge_s)


class FaultInjector:
    """Context-manager arming of injection sites::

        with FaultInjector({"step_hang": 1}, wedge_s=2.0):
            ...   # the next step through an instrumented site wedges 2s

    Spec values are fire counts. Nests; counts add. Fork-aware the
    cheap way: children inherit the armed counters by COW, each with an
    independent copy.
    """

    def __init__(self, spec: Dict[str, int] | str,
                 wedge_s: Optional[float] = None):
        self.spec = _parse_spec(spec) if isinstance(spec, str) else {
            s: int(c) for s, c in spec.items()}
        for s in self.spec:
            if s not in _KNOWN_SITES:
                raise ValueError(f"unknown fault-injection site {s!r}")
        self.wedge_s = wedge_s

    def __enter__(self):
        global _wedge_s
        _ensure_env_loaded()
        with _inject_lock:
            for site, cnt in self.spec.items():
                _active[site] = _active.get(site, 0) + cnt
            if self.wedge_s is not None:
                self._prev_wedge = _wedge_s
                _wedge_s = float(self.wedge_s)
            else:
                self._prev_wedge = None
        return self

    def __exit__(self, *exc):
        global _wedge_s
        with _inject_lock:
            # disarm whatever this context armed and did not fire
            for site, cnt in self.spec.items():
                _active[site] = max(0, _active.get(site, 0) - cnt)
            if self.wedge_s is not None:
                _wedge_s = self._prev_wedge
        return False
