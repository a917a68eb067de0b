"""Span tracer + ring-buffer flight recorder (port of
paddle_tpu/obs/trace.py; the obs timeline half).

Every instrumented phase — a request's queue-wait/prefill/decode in the
engine, the HTTP handler's generate and detokenize — lands as ONE event
format: a Chrome-trace complete event (``ph: "X"``, ts/dur in
microseconds on the ``time.perf_counter`` clock) carrying its
``request_id`` and category in ``args``. They all buffer in one
fixed-size ring (`FlightRecorder`): always on, bounded memory, no
per-event I/O.

* `export_chrome` writes Chrome/Perfetto JSON;
* `dump_flight` writes the ring + still-open spans to a timestamped
  artifact;
* `capture` is the ``POST /admin/trace`` body: the spans of a window,
  and with ``profile=True`` a ``torch.profiler`` trace of the same window
  (CPU and CUDA activities) written beside them.

Layering: the primitives here (``record_span``/``begin``/``end``)
ALWAYS record — an explicit call is its own opt-in. The ``span()``
helper is the gated face for ambient instrumentation: with
``PADDLE_TPU_OBS=0`` it returns one shared no-op singleton — zero
allocations on the disabled hot path. Heavier sites (the engine tick)
gate themselves once at construction instead of per call.

Env knobs:
  PADDLE_TPU_OBS        ambient instrumentation on/off (default on)
  PADDLE_TPU_OBS_RING   ring capacity in events (default 4096)
  PADDLE_TPU_OBS_DIR    artifact/trace directory (default obs_artifacts)
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["FlightRecorder", "recorder", "span", "record_span",
           "begin_span", "end_span", "export_chrome", "dump_flight",
           "capture", "artifact_dir", "prime_profiler"]

_PID = os.getpid()


def _enabled() -> bool:
    from . import enabled
    return enabled()


def artifact_dir() -> str:
    """Where flight-recorder dumps and trace captures land."""
    return os.environ.get("PADDLE_TPU_OBS_DIR") or "obs_artifacts"


class FlightRecorder:
    """Fixed-size ring of completed span events + the set of spans
    currently open. Appends are O(1) under one lock; the ring never
    grows (old events fall off the back) so it is safe to leave on in
    production forever."""

    def __init__(self, size: int):
        self._ring: deque = deque(maxlen=max(16, int(size)))
        self._lock = threading.Lock()
        self._open: Dict[int, dict] = {}
        self._tokens = itertools.count(1)
        self.appended = 0          # monotonic; tests assert deltas

    @property
    def size(self) -> int:
        # maxlen is immutable — no lock needed for this read
        return self._ring.maxlen

    # -- writing ---------------------------------------------------------
    def record(self, name: str, t0_s: float, t1_s: float,
               cat: str = "app", tid: Optional[int] = None,
               args: Optional[dict] = None) -> None:
        """One complete span; ``t0_s``/``t1_s`` are
        ``time.perf_counter()`` readings."""
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": t0_s * 1e6, "dur": max(0.0, (t1_s - t0_s) * 1e6),
              "pid": _PID,
              "tid": tid if tid is not None else threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._ring.append(ev)
            self.appended += 1

    def begin(self, name: str, cat: str = "app",
              args: Optional[dict] = None) -> int:
        token = next(self._tokens)
        ev = {"name": name, "cat": cat, "t0": time.perf_counter(),
              "tid": threading.get_ident(),
              "args": dict(args) if args else None}
        with self._lock:
            self._open[token] = ev
        return token

    def end(self, token: int) -> None:
        with self._lock:
            ev = self._open.pop(token, None)
        if ev is not None:
            self.record(ev["name"], ev["t0"], time.perf_counter(),
                        cat=ev["cat"], tid=ev["tid"], args=ev["args"])

    # -- reading ---------------------------------------------------------
    def events(self, since_s: Optional[float] = None) -> List[dict]:
        """Completed events (oldest first); ``since_s`` filters to
        spans that STARTED at or after that perf_counter reading."""
        with self._lock:
            evs = list(self._ring)
        if since_s is not None:
            cutoff = since_s * 1e6
            evs = [e for e in evs if e["ts"] >= cutoff]
        return evs

    def open_events(self) -> List[dict]:
        """Spans in flight right now, synthesized as complete events
        with duration-so-far and ``args.open = true`` — what a crash
        dump needs most (the request that was mid-forward when the
        replica died)."""
        now = time.perf_counter()
        with self._lock:
            opens = list(self._open.values())
        out = []
        for ev in opens:
            args = dict(ev["args"] or {})
            args["open"] = True
            out.append({"name": ev["name"], "cat": ev["cat"], "ph": "X",
                        "ts": ev["t0"] * 1e6,
                        "dur": max(0.0, (now - ev["t0"]) * 1e6),
                        "pid": _PID, "tid": ev["tid"], "args": args})
        return out

    def request_ids(self, events: Optional[List[dict]] = None
                    ) -> List[str]:
        evs = self.open_events() if events is None else events
        return sorted({str(e["args"]["request_id"]) for e in evs
                       if e.get("args", {}).get("request_id")})

    def clear(self) -> None:                     # tests only
        with self._lock:
            self._ring.clear()
            self._open.clear()


def _unique_dir(parent: str, base: str) -> str:
    """Create and return a fresh directory ``parent/base`` — with a
    ``.N`` suffix when the name is taken. The profile capture dir is
    stamped at SECOND granularity (time.strftime); two captures in the
    same second (a test loop, several servers in one process) must not
    write into one directory."""
    os.makedirs(parent, exist_ok=True)
    path = os.path.join(parent, base)
    for i in range(10000):
        try:
            os.makedirs(path if i == 0 else f"{path}.{i}",
                        exist_ok=False)
            return path if i == 0 else f"{path}.{i}"
        except FileExistsError:
            continue
    raise OSError(f"could not create a unique capture dir under "
                  f"{parent!r} (base {base!r})")


def _ring_size() -> int:
    try:
        return int(os.environ.get("PADDLE_TPU_OBS_RING", 4096))
    except ValueError:
        return 4096


#: the ONE process-wide flight recorder
recorder = FlightRecorder(_ring_size())


# ---------------------------------------------------------------------------
# span API
# ---------------------------------------------------------------------------

class _Span:
    __slots__ = ("_name", "_cat", "_args", "_token")

    def __init__(self, name, cat, args):
        self._name = name
        self._cat = cat
        self._args = args or None
        self._token = None

    def __enter__(self):
        self._token = recorder.begin(self._name, self._cat, self._args)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            recorder.end(self._token)
            self._token = None
        return False


class _NoopSpan:
    """The disabled fast path: one shared instance, no state, no
    allocations per use."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def span(name: str, cat: str = "app", **args):
    """Context-manager span, gated on ``PADDLE_TPU_OBS``. Disabled ->
    the shared no-op singleton (identity-testable)."""
    if not _enabled():
        return _NOOP
    return _Span(name, cat, args)


def record_span(name: str, t0_s: float, t1_s: float, cat: str = "app",
                tid: Optional[int] = None, **args) -> None:
    """Record a completed span from explicit perf_counter timestamps.
    Ungated — callers that need the ambient on/off gate check
    ``obs.enabled()`` themselves (the engine does, once, at init)."""
    recorder.record(name, t0_s, t1_s, cat=cat, tid=tid,
                    args=args or None)


def begin_span(name: str, cat: str = "app", **args) -> int:
    return recorder.begin(name, cat, args or None)


def end_span(token: int) -> None:
    recorder.end(token)


# ---------------------------------------------------------------------------
# export / dump / capture
# ---------------------------------------------------------------------------

def export_chrome(path: str, since_s: Optional[float] = None,
                  metadata: Optional[dict] = None,
                  include_open: bool = False,
                  events: Optional[List[dict]] = None) -> str:
    """THE Chrome/Perfetto trace writer: ``{"traceEvents": [...]}``
    JSON, atomically published. ``events`` overrides the ring read
    (a fetched capture re-exported through the same path)."""
    if events is None:
        events = recorder.events(since_s)
        if include_open:
            events = events + recorder.open_events()
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "metadata": dict(metadata or {})}
    doc["metadata"].setdefault("clock", "perf_counter_us")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def dump_flight(reason: str, extra: Optional[dict] = None,
                dir_path: Optional[str] = None) -> str:
    """Crash/postmortem dump: ring + open spans to a timestamped
    artifact. Returns the path. Callers on failure paths wrap this in
    try/except — forensics must never mask the original error."""
    d = dir_path or artifact_dir()
    os.makedirs(d, exist_ok=True)
    stamp = (time.strftime("%Y%m%d_%H%M%S")
             + f"_{int(time.time_ns() % 1_000_000):06d}")
    path = os.path.join(d, f"flight_{reason}_{stamp}.trace.json")
    opens = recorder.open_events()
    ring = recorder.events()
    meta = {"reason": reason, "pid": _PID,
            "dumped_at_unix": time.time(),
            "ring_events": len(ring), "open_spans": len(opens),
            "request_ids_in_flight": recorder.request_ids(opens),
            "request_ids_recent": recorder.request_ids(ring)}
    if extra:
        meta.update(extra)
    return export_chrome(path, metadata=meta, events=ring + opens)


_profiler_primed = False


def prime_profiler() -> None:
    """Initialise ``torch.profiler`` in the calling thread, once a process,
    where a card is present. Kineto initialises its client only from the
    thread that imported torch: a first profile started in another thread
    (an HTTP handler's ``/admin/trace``) records no device kernels.
    ``PredictorServer`` calls this from the thread that builds it."""
    global _profiler_primed
    if _profiler_primed:
        return
    _profiler_primed = True
    import torch
    if not torch.cuda.is_available():
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass


def _torch_profile(window):
    """Run ``window()`` under ``torch.profiler`` (CPU activity, and CUDA
    where a card is present) and write its Chrome trace into a fresh
    directory under the artifact dir; returns that directory. Raises
    what the profiler raises (one already running, no CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof_dir = _unique_dir(artifact_dir(), "torch_profile_"
                           + time.strftime("%Y%m%d_%H%M%S"))
    with profile(activities=acts) as prof:
        window()
    prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
    return prof_dir


def capture(duration_s: float = 0.0, jax_profile: bool = False) -> dict:
    """The ``POST /admin/trace?duration_s=`` body: record for
    ``duration_s`` (0 -> snapshot the whole ring now) and return the
    Chrome-trace dict. ``jax_profile=True`` (paddle_tpu's name for its
    device-profiler flag, where it runs ``jax.profiler``) runs
    ``torch.profiler`` over the window; its directory,
    holding ``trace.json``, rides in ``metadata["torch_profile_dir"]``.
    A profiler that cannot run degrades to the host-span capture with
    its error in ``metadata["torch_profile_error"]`` — a trace endpoint
    must not 500 because the device profiler is busy."""
    meta: dict = {"duration_s": float(duration_s)}
    since = time.perf_counter() if duration_s and duration_s > 0 else None

    def window():
        if since is not None:
            time.sleep(float(duration_s))
    if jax_profile:
        try:
            meta["torch_profile_dir"] = _torch_profile(window)
        except Exception as e:   # noqa: BLE001 — degrade, don't 500
            meta["torch_profile_error"] = f"{type(e).__name__}: {e}"
            if since is not None:
                # the window still covers the request's duration
                time.sleep(max(0.0, since + duration_s
                               - time.perf_counter()))
    else:
        window()
    events = recorder.events(since) + recorder.open_events()
    meta["request_ids"] = recorder.request_ids(events)
    meta.setdefault("clock", "perf_counter_us")
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": meta}
