"""HTTP front end over the inference predictor and the continuous-batching
engine (port of paddle_tpu/inference/serve.py: ``PredictorServer``, its
endpoints and wire formats, and the CLI).

A server has a predictor (``model_path_or_config``: a ``jit.save`` path or
a ``Config``; the predict path), an engine (``engine=``, or a ``Config``
with ``enable_continuous_batching``; the generate path), or both.
Endpoints:
  GET  /health    -> {"status": "ok"} (liveness)
  GET  /healthz   -> readiness: 200 while the server can take work, 503
                     with a reason while warming up, draining, after 3
                     failures in a row, when the predict queue or the
                     engine's queue is saturated, or when the engine
                     broke; always carries uptime_s and metrics_seq (the
                     obs registry's mutation sequence, which moves while
                     the process is live) and compilation (the kernel
                     libraries this process compiled with nvcc and
                     loaded); with an engine, slot occupancy,
                     queue depth, ticks, admissions, compiled programs,
                     tick_model_eff, warm and the launch counts of the
                     engine's cache-path kernels (``kernel_launches``),
                     the page-pool and prefix-cache fields (paged
                     engines) and the speculative counters
  GET  /metrics   -> the obs registry as Prometheus-style text (the
                     engine's ptpu_engine_* series among it)
  GET  /metadata  -> {"inputs": [names], "outputs": [names]}
  POST /predict   -> {"inputs": {name: nested list | {"data": ...,
                      "dtype": "int64"}}} -> {"outputs": {name: {"data",
                      "dtype", "shape"}}}: JSON numbers are coerced to the
                     input's declared dtype; one predict worker thread runs
                     the predictor (its handles are shared state)
  POST /generate  -> {"input_ids": [...], "max_new_tokens": n,
                      "eos_token_id": opt, "seed": opt} -> {"tokens":
                      [...], "prompt_len": P, "new_tokens": n,
                      "tokens_generated": k, "request_id": rid}. The
                     ``X-PTPU-Request-Id`` header names the request (one is
                     minted otherwise) for /cancel and for the engine's
                     spans. With "stream": true the reply is NDJSON
                     (``application/x-ndjson``, read until close): one
                     {"t": [tokens]} line per block the engine emits (the
                     first token at admission, then per tick), then one
                     {"done": body} line with the single-shot body, or
                     {"err": {"error", "tokens_generated",
                     "partial_tokens", ...}} when the request is cancelled
                     or fails. A client that disconnects mid-stream cancels
                     its request (slot and pages freed).
  POST /cancel    -> {"request_id": rid} -> {"cancelled": bool,
                      "request_id": rid}: a queued request resolves now, an
                     admitted one retires at the next tick boundary; its
                     waiter gets 409 "cancelled" (or the stream's err line)
                     with the partial result
  POST /prewarm   -> {"input_ids": [...]} -> {"prewarmed": paged,
                      "prompt_len": P, "paged": paged}: a one-token
                      generate through normal admission, result dropped,
                      so a paged engine's prefix cache holds the prompt
  POST /drain     -> {"status": "draining", "inflight": n}: stop admitting
                     (/healthz 503 "draining", new /predict and /generate
                     shed 503 "draining"), let in-flight requests finish
  POST /admin/trace?duration_s=S[&profile=1]
                  -> the flight recorder's spans over the next S seconds
                     (0: the whole ring now) as Chrome/Perfetto JSON;
                     profile=1 also runs torch.profiler over the window
                     (its directory in metadata.torch_profile_dir)
  POST /admin/inject -> {"site": s, "count": n, "wedge_s": opt}: arm a
                     resilience fault site in this live process; 403
                     unless PADDLE_TPU_CHAOS_ADMIN=1

Errors keep paddle_tpu's contract: 400 for a malformed request, 404 for a
path the server has no backend for, 503 with ``overloaded``,
``cache_exhausted`` (queue full while the KV page pool binds),
``warming_up``, ``draining``, ``deadline_exceeded`` (a generate request is
cancelled, a predict call abandoned to the worker) or
``backend_unavailable``, every 503 with a ``Retry-After`` header and a
``retry_after_s`` body field; 409 ``cancelled`` with the partial result.

``warmup`` (default ``PADDLE_TPU_SERVE_WARMUP``, off) runs the engine's
``warmup()`` on a side thread while the listener already answers:
/healthz says 503 "warming" and /generate sheds 503 "warming_up" until it
ends. ``stop(drain_s=K)`` drains for up to K seconds before it shuts the
listener; ``drain_s=0`` stops at once.

CLI: python -m paddle_tpu_torch.inference.serve --model m.pdmodel
[--port 8866] [--warmup] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import queue as _queue
import threading
import time
import urllib.parse
import uuid
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import obs as _obs
from ..distributed import resilience as _resil
from ..framework.env import bool_env, float_env
from ..kernels import _build
from .engine import (CacheExhausted, EngineOverloaded, GenerationPredictor,
                     RequestCancelled)
from .predictor import Config, create_predictor

__all__ = ["PredictorServer", "main", "RETRY_AFTER_S", "REQUEST_ID_HEADER"]

#: request-id header (client or router -> server -> engine): one request's
#: spans correlate under this id
REQUEST_ID_HEADER = "X-PTPU-Request-Id"

# advisory client backoff per 503 reason (seconds)
RETRY_AFTER_S = {
    "overloaded": 1.0,
    # the paged pool binds: clears when a request retires and frees pages
    "cache_exhausted": 2.0,
    "warming_up": 5.0,
    "deadline_exceeded": 2.0,
    "backend_unavailable": 2.0,
    "draining": 2.0,
    "unready": 1.0,
}


def send_json(handler, code, obj, retry_after=None, retry_after_table=None):
    """Write one JSON response; a 503 always carries Retry-After (from
    the body's ``error`` reason via ``retry_after_table`` when not
    given)."""
    table = RETRY_AFTER_S if retry_after_table is None else retry_after_table
    if code == 503 and retry_after is None:
        reason = str(obj.get("error", "")).split(":")[0]
        retry_after = table.get(reason, table["unready"])
    if retry_after is not None:
        obj.setdefault("retry_after_s", float(retry_after))
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    if retry_after is not None:
        handler.send_header("Retry-After",
                            str(max(1, int(-(-retry_after // 1)))))
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def send_text(handler, code, text,
              content_type="text/plain; version=0.0.4; charset=utf-8"):
    """Plain-text response (the /metrics exposition body)."""
    body = text.encode()
    handler.send_response(code)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def handle_admin_trace(handler, drain_body_fn):
    """POST /admin/trace?duration_s=S[&profile=1]: capture the flight
    recorder over the window (at most 60 s) and answer Chrome-trace
    JSON."""
    drain_body_fn()
    q = urllib.parse.parse_qs(urllib.parse.urlsplit(handler.path).query)
    try:
        duration = float(q.get("duration_s", ["0"])[0])
    except ValueError:
        send_json(handler, 400, {"error": "bad duration_s"})
        return
    profile = q.get("profile", ["0"])[0] not in ("0", "", "false")
    doc = _obs.trace.capture(min(max(duration, 0.0), 60.0),
                                jax_profile=profile)
    send_json(handler, 200, doc)


def shed_body(e):
    """The 503 body of a shed submit: the engine's reason and queue depth,
    and the pool's free and total pages when the pool binds."""
    body = {"error": e.reason, "queue_depth": e.queue_depth}
    if isinstance(e, CacheExhausted):
        body.update(free_pages=e.free_pages, num_pages=e.num_pages)
    return body


class PredictorServer:
    """A threaded stdlib HTTP server bound to host:port in front of a
    predictor, a ``ContinuousBatchingEngine``, or both.

    The predictor is the server's own (built from ``model_path_or_config``)
    and not thread-safe, so predict calls serialise on one worker thread;
    at most ``max_queue`` of them wait. An engine passed as ``engine=``
    stays the caller's: ``stop()`` leaves it running. An engine the server
    built from a ``Config`` (``enable_continuous_batching``) is stopped
    with it."""

    def __init__(self, model_path_or_config=None, host: str = "127.0.0.1",
                 port: int = 8866, deadline_s: float = None,
                 max_queue: int = None, engine=None, warmup: bool = None):
        if model_path_or_config is None and engine is None:
            raise ValueError(
                "need a model path/Config (predict path), an engine "
                "(generate path), or both")
        self.engine = engine
        self.predictor = None
        self._owned_predictor = None     # an engine whose lifetime is ours
        if model_path_or_config is not None:
            cfg = (model_path_or_config
                   if isinstance(model_path_or_config, Config)
                   else Config(model_path_or_config))
            self.predictor = create_predictor(cfg)
            if isinstance(self.predictor, GenerationPredictor):
                # a Config with enable_continuous_batching serves the
                # generate path; there is no tensor predictor behind
                # /predict
                if self.engine is None:
                    self.engine = self.predictor.engine
                    self._owned_predictor = self.predictor
                self.predictor = None
        self._lock = threading.Lock()
        self.deadline_s = (deadline_s if deadline_s is not None
                           else float_env("PADDLE_TPU_SERVE_DEADLINE", 30.0))
        self.max_queue = int(max_queue if max_queue is not None
                             else float_env("PADDLE_TPU_SERVE_MAX_QUEUE", 8))
        # one predict worker: a handler can abandon a wedged call at its
        # deadline, since it never runs the call itself
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="predict")
        self._depth = 0                 # predict requests submitted, not done
        self._depth_lock = threading.Lock()
        # admitted requests whose response is not written yet (both
        # paths): what a drain waits on
        self._resp_inflight = 0
        self._draining = False
        self._failure_streak = 0        # failures in a row
        if warmup is None:
            warmup = bool_env("PADDLE_TPU_SERVE_WARMUP", False)
        self._warm_state = ("warming" if warmup and self.engine is not None
                            else "ready")
        self._warm_error = None
        self._warmup_thread = None
        self._started = time.monotonic()
        # /admin/trace's profiler runs in a handler thread: initialise it
        # here, in the thread that builds the server
        _obs.trace.prime_profiler()
        self.httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = None
        if self._warm_state == "warming":
            # the listener answers (/health, a truthful /healthz) while the
            # engine warms on a side thread
            self._warmup_thread = threading.Thread(
                target=self._run_warmup, daemon=True, name="serve-warmup")
            self._warmup_thread.start()

    def _run_warmup(self):
        try:
            self.engine.warmup()
        except Exception as e:   # noqa: BLE001 — a failed warmup must not
            # brick the server: /healthz reports it, traffic pays the
            # first-use cost it would have paid anyway
            self._warm_error = f"{type(e).__name__}: {e}"
        finally:
            self._warm_state = "ready"

    def inflight(self) -> int:
        """Requests admitted and not yet answered (both paths): what a
        drain waits on."""
        with self._depth_lock:
            return self._resp_inflight + self._depth

    def begin_drain(self) -> int:
        """Stop admitting; in-flight requests run to completion and
        /healthz answers 503 "draining". Returns the in-flight count at the
        flip. Idempotent. The flip is atomic against the admission paths'
        own locked check-and-increment, so a drain never misses an admitted
        request."""
        with self._depth_lock:
            self._draining = True
            return self._resp_inflight + self._depth

    def _metadata(self):
        if self.predictor is not None:
            return {"inputs": self.predictor.get_input_names(),
                    "outputs": self.predictor.get_output_names()}
        return {"inputs": ["input_ids"], "outputs": ["tokens"]}

    def _readiness(self):
        """(ready, body) for /healthz."""
        with self._depth_lock:
            draining = self._draining
        body = {"status": "ready",
                "uptime_s": round(time.monotonic() - self._started, 1),
                "metrics_seq": _obs.metrics.registry.seq(),
                "queue_depth": self._depth, "inflight": self.inflight(),
                "draining": draining, "max_queue": self.max_queue,
                "failure_streak": self._failure_streak,
                # the kernels this process compiled (nvcc) and loaded: a
                # replica started after the build compiles none
                "compilation": _build.summary()}
        st = None
        if self.engine is not None:
            st = self.engine.stats()
            body["engine"] = {k: st[k] for k in (
                "slots", "active", "free", "queued", "max_queue", "ticks",
                "compiled_programs", "tick_model_eff", "tp",
                "mesh_devices", "admitted", "kernel_launches")}
            body["engine"]["warm"] = self.engine.warm
            if st.get("paged"):
                body["engine"].update({k: st[k] for k in (
                    "paged", "page_size", "pages_total", "pages_free",
                    "pages_used", "page_utilization", "prefix_hits",
                    "prefix_misses", "prefix_hit_rate",
                    "prefix_fingerprints")})
            if st.get("speculative"):
                body["engine"].update({k: st[k] for k in (
                    "speculative", "spec_k", "spec_ticks", "tokens_drafted",
                    "tokens_accepted", "tokens_rejected", "acceptance_rate",
                    "accepted_tokens_per_tick")})
        if draining:
            body.update(status="draining", reason="draining for restart")
            return False, body
        if self._warm_state == "warming":
            body.update(status="warming", reason="warmup in progress")
            return False, body
        if self._warm_error is not None:
            body["warmup_error"] = self._warm_error
        if self.engine is not None:
            if self.engine.broken is not None:
                body.update(status="unready", reason="engine broken")
                return False, body
            if st["queued"] >= st["max_queue"]:
                body.update(status="unready",
                            reason="engine request queue saturated")
                return False, body
        if self._failure_streak >= 3:
            body.update(status="unready",
                        reason=f"{self._failure_streak} consecutive "
                               "failures (backend unavailable?)")
            return False, body
        if self.predictor is not None and self._depth >= self.max_queue:
            body.update(status="unready", reason="request queue saturated")
            return False, body
        return True, body

    def _note_failure(self, reset=False):
        """Count a failed call (or, ``reset``, a good one)."""
        with self._depth_lock:
            self._failure_streak = 0 if reset else self._failure_streak + 1

    def _predict(self, payload):
        """One /predict body through the predictor (on the worker):
        ``{"outputs": {name: {"data", "dtype", "shape"}}}``. Raises
        ValueError or KeyError on a malformed body (a 400)."""
        # fault sites: a wedged backend (hangs past the deadline) and an
        # unavailable one (raises; a 503)
        _resil.maybe_inject("serve_hang")
        _resil.maybe_inject("serve_backend")
        inputs = payload.get("inputs")
        if not isinstance(inputs, dict):
            raise ValueError('body must be {"inputs": {name: tensor}}')
        names = self.predictor.get_input_names()
        unknown = set(inputs) - set(names)
        if unknown:
            raise ValueError(f"unknown input(s) {sorted(unknown)}; "
                             f"expected {names}")
        missing = set(names) - set(inputs)
        if missing:
            raise ValueError(f"missing input(s) {sorted(missing)}")
        with self._lock:
            for name in names:
                v = inputs[name]
                dtype = v.get("dtype") if isinstance(v, dict) else None
                data = v["data"] if isinstance(v, dict) else v
                if dtype is None:
                    # JSON numbers arrive as int64/float64: coerce to the
                    # input's declared dtype
                    dtype = self.predictor.get_input_dtype(name)
                arr = np.asarray(data, dtype=dtype)
                self.predictor.get_input_handle(name).copy_from_cpu(arr)
            self.predictor.run()
            outs = {}
            for name in self.predictor.get_output_names():
                a = self.predictor.get_output_handle(name).copy_to_cpu()
                outs[name] = {"data": a.tolist(), "dtype": str(a.dtype),
                              "shape": list(a.shape)}
        return {"outputs": outs}

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # quiet by default
                pass

            def _send(self, code, obj, retry_after=None):
                send_json(self, code, obj, retry_after=retry_after)

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "ok"})
                elif self.path == "/healthz":
                    ready, body = server._readiness()
                    ra = None
                    if not ready:
                        ra = RETRY_AFTER_S.get(
                            {"warming": "warming_up",
                             "draining": "draining"}.get(body["status"],
                                                         "unready"))
                    self._send(200 if ready else 503, body, retry_after=ra)
                elif self.path == "/metrics":
                    send_text(self, 200, _obs.metrics.registry.render())
                elif self.path == "/metadata":
                    self._send(200, server._metadata())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def _drain_body(self):
                """Read and drop an unread request body: a reply sent on
                unread POST bytes resets the connection."""
                try:
                    self.rfile.read(
                        int(self.headers.get("Content-Length", "0")))
                except (ValueError, OSError):
                    pass

            def _read_json_body(self):
                """The parsed JSON body, or None when it is unreadable or
                not a JSON object."""
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, OSError):
                    return None
                return payload if isinstance(payload, dict) else None

            def do_POST(self):
                route = self.path.split("?")[0]
                if route == "/drain":
                    self._drain_body()
                    self._send(200, {"status": "draining",
                                     "inflight": server.begin_drain()})
                elif route == "/admin/trace":
                    handle_admin_trace(self, self._drain_body)
                elif route == "/admin/inject":
                    self._admin_inject()
                elif route == "/predict":
                    if server.predictor is None:
                        self._drain_body()
                        self._send(404, {"error": "no predictor loaded "
                                         "(engine-only server: POST "
                                         "/generate)"})
                        return
                    self._predict()
                elif route in ("/generate", "/cancel", "/prewarm"):
                    if server.engine is None:
                        self._drain_body()
                        self._send(404, {"error": "no generation engine "
                                         "attached to this server"})
                        return
                    {"/generate": self._generate, "/cancel": self._cancel,
                     "/prewarm": self._prewarm}[route]()
                else:
                    self._drain_body()
                    self._send(404, {"error": f"no route {self.path}"})

            def _admit(self):
                """The draining check and the in-flight count of one
                request, as one step against ``begin_drain``'s flip; after
                False the 503 is sent."""
                with server._depth_lock:
                    draining = server._draining
                    if not draining:
                        server._resp_inflight += 1
                if draining:
                    self._drain_body()
                    self._send(503, {"error": "draining"})
                return not draining

            def _release(self):
                with server._depth_lock:
                    server._resp_inflight -= 1

            def _admin_inject(self):
                """Arm a fault site in this live process (chaos tooling);
                refused unless PADDLE_TPU_CHAOS_ADMIN=1."""
                payload = self._read_json_body()
                if payload is None:
                    self._send(400, {"error": "bad body"})
                    return
                if not bool_env("PADDLE_TPU_CHAOS_ADMIN", False):
                    self._send(403, {"error": "chaos admin disabled "
                                              "(PADDLE_TPU_CHAOS_ADMIN)"})
                    return
                site = payload.get("site")
                count = payload.get("count", 1)
                wedge_s = payload.get("wedge_s")
                try:
                    _resil.arm_fault(str(site), int(count),
                                     None if wedge_s is None
                                     else float(wedge_s))
                except (ValueError, TypeError) as e:
                    self._send(400, {"error": str(e)})
                    return
                self._send(200, {"armed": str(site), "count": int(count),
                                 "wedge_s": wedge_s})

            def _cancel(self):
                """Cancel a request by id (body ``request_id`` or the
                header); says whether a live request matched."""
                payload = self._read_json_body() or {}
                rid = (payload.get("request_id")
                       or self.headers.get(REQUEST_ID_HEADER))
                if not rid:
                    self._send(400, {"error": "request_id required"})
                    return
                ok = server.engine.cancel(str(rid))
                self._send(200, {"cancelled": bool(ok),
                                 "request_id": str(rid)})

            def _prewarm(self):
                if server._warm_state == "warming" or server._draining:
                    self._drain_body()
                    self._send(503, {"error": "warming_up"
                                     if server._warm_state == "warming"
                                     else "draining"})
                    return
                payload = self._read_json_body()
                if payload is None or "input_ids" not in payload:
                    self._send(400, {"error": "input_ids required"})
                    return
                paged = bool(server.engine.paged)
                fut = self._submit(payload, max_new_tokens=1)
                if fut is None:
                    return
                try:
                    fut.result(timeout=server.deadline_s)
                except Exception as e:   # noqa: BLE001 — best effort
                    self._send(503, {"error": f"prewarm_failed: {e}"})
                    return
                n = len(np.asarray(payload["input_ids"]).reshape(-1))
                self._send(200, {"prewarmed": paged, "prompt_len": n,
                                 "paged": paged})

            def _predict(self):
                """POST /predict on the predict worker, shed with 503
                ``draining`` or ``overloaded`` (``max_queue`` requests
                already waiting)."""
                with server._depth_lock:
                    depth = server._depth
                    shed = ("draining" if server._draining else
                            "overloaded" if depth >= server.max_queue
                            else None)
                    if shed is None:
                        server._depth += 1
                        server._resp_inflight += 1
                if shed is not None:
                    self._drain_body()
                    self._send(503, {"error": shed, "queue_depth": depth})
                    return

                def release():
                    with server._depth_lock:
                        server._depth -= 1

                # the worker releases its depth once the call ends (an
                # abandoned wedged call keeps holding it, so followers
                # shed at once); this handler releases what never ran
                def run_and_release(payload):
                    try:
                        return server._predict(payload)
                    finally:
                        release()

                submitted = False
                try:
                    payload = self._read_json_body()
                    if payload is None:
                        self._send(400, {"error": "bad body"})
                        return
                    fut = server._pool.submit(run_and_release, payload)
                    submitted = True
                    try:
                        out = fut.result(timeout=server.deadline_s)
                    except FutureTimeout:
                        if fut.cancel():
                            release()
                        server._note_failure()
                        self._send(503, {"error": "deadline_exceeded",
                                         "deadline_s": server.deadline_s})
                        return
                    server._note_failure(reset=True)
                    self._send(200, out)
                except (_resil.FaultInjected, ConnectionError) as e:
                    server._note_failure()
                    self._send(503, {"error": f"backend_unavailable: {e}"})
                except (ValueError, KeyError, TypeError) as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:   # noqa: BLE001 — report, go on
                    server._note_failure()
                    code = 503 if "unavailable" in str(e).lower() else 500
                    self._send(code, {"error": f"{type(e).__name__}: {e}"})
                finally:
                    self._release()
                    if not submitted:
                        release()

            def _submit(self, payload, max_new_tokens=None, rid=None,
                        progress_cb=None):
                """``engine.submit`` of the body's request, or None after
                the error reply: 400 for a bad request, 503 for a shed or
                a broken engine."""
                try:
                    n = (int(payload.get("max_new_tokens", 32))
                         if max_new_tokens is None else max_new_tokens)
                    return server.engine.submit(
                        payload["input_ids"], n,
                        payload.get("eos_token_id"),
                        int(payload.get("seed", 0)), request_id=rid,
                        progress_cb=progress_cb)
                except EngineOverloaded as e:
                    self._send(503, shed_body(e))
                except (ValueError, KeyError, TypeError) as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:   # noqa: BLE001 — a broken or
                    # stopped engine, an injected dead backend: the client
                    # gets its 503, not a dropped socket
                    server._note_failure()
                    self._send(503, {"error": f"backend_unavailable: {e}"})
                return None

            def _generate(self):
                if server._warm_state == "warming":
                    # shed instead of queueing behind the warmup
                    self._drain_body()
                    self._send(503, {"error": "warming_up",
                                     "queue_depth": 0})
                    return
                if not self._admit():
                    return
                try:
                    # the id /cancel takes, and a stream's reader needs
                    # for its disconnect to cancel: minted when absent
                    rid = (self.headers.get(REQUEST_ID_HEADER)
                           or uuid.uuid4().hex[:16])
                    # the handler's wall: what the engine's phases do not
                    # cover (parse, wake-up, reply) is this span minus
                    # their sum
                    with _obs.span("serve.generate", cat="serve",
                                   request_id=rid):
                        self._generate_traced(rid)
                finally:
                    self._release()

            def _generate_traced(self, rid):
                payload = self._read_json_body()
                if payload is None:
                    self._send(400, {"error": "bad body"})
                    return
                stream = bool(payload.get("stream"))
                evq = _queue.Queue() if stream else None
                fut = self._submit(
                    payload, rid=rid,
                    progress_cb=(lambda toks, q=evq: q.put(("t", toks)))
                    if stream else None)
                if fut is None:
                    return
                prompt_len = len(np.asarray(payload["input_ids"]).reshape(-1))
                if stream:
                    self._stream(fut, evq, rid, prompt_len)
                    return
                try:
                    out = fut.result(timeout=server.deadline_s)
                except FutureTimeout:
                    server._note_failure()
                    if rid:
                        server.engine.cancel(rid)
                    self._send(503, {"error": "deadline_exceeded",
                                     "deadline_s": server.deadline_s})
                    return
                except RequestCancelled:
                    self._send(409, self._failed_body(fut, rid,
                                                      "cancelled"))
                    return
                except Exception as e:   # noqa: BLE001 — engine fault:
                    # the client gets its 503 with the partial result
                    server._note_failure()
                    self._send(503, self._failed_body(
                        fut, None, f"backend_unavailable: {e}"))
                    return
                server._note_failure(reset=True)
                self._send(200, self._done_body(fut, out, rid, prompt_len))

            def _failed_body(self, fut, rid, error):
                body = {"error": error}
                body.update(getattr(fut, "_ptpu_gen_info", None) or {})
                if rid:
                    body["request_id"] = rid
                return body

            def _done_body(self, fut, out, rid, prompt_len):
                with _obs.span("serve.detokenize", cat="serve",
                               request_id=rid):
                    body = {"tokens": out.tolist(), "prompt_len": prompt_len,
                            "new_tokens": len(out) - prompt_len}
                    body.update(getattr(fut, "_ptpu_gen_info", None) or {})
                    if rid:
                        body["request_id"] = rid
                return body

            def _write_event(self, obj):
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()

            def _stream(self, fut, evq, rid, prompt_len):
                """The NDJSON reply of one admitted request: {"t": [...]}
                per block, then one {"done": body} or {"err": record}, then
                close (a reader that sees EOF without a final line knows
                the server died). A reader that goes away cancels the
                request."""
                fut.add_done_callback(lambda f: evq.put(("fin", None)))
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Connection", "close")
                self.end_headers()
                self.close_connection = True
                deadline = time.monotonic() + server.deadline_s
                sent = 0
                try:
                    while True:
                        timeout = deadline - time.monotonic()
                        if timeout <= 0:
                            server._note_failure()
                            if rid:
                                server.engine.cancel(rid)
                            self._write_event({"err": {
                                "error": "deadline_exceeded",
                                "deadline_s": server.deadline_s,
                                "tokens_generated": sent}})
                            return
                        try:
                            kind, toks = evq.get(timeout=min(timeout, 0.5))
                        except _queue.Empty:
                            continue
                        if kind == "fin":
                            break
                        self._write_event({"t": toks})
                        sent += len(toks)
                    try:
                        out = fut.result(timeout=0)
                    except RequestCancelled:
                        self._write_event({"err": self._failed_body(
                            fut, rid, "cancelled")})
                        return
                    except Exception as e:   # noqa: BLE001 — engine fault
                        server._note_failure()
                        self._write_event({"err": self._failed_body(
                            fut, None, f"backend_unavailable: {e}")})
                        return
                    server._note_failure(reset=True)
                    self._write_event({"done": self._done_body(
                        fut, out, rid, prompt_len)})
                except OSError:
                    # the reader went away mid-stream (BrokenPipeError,
                    # ConnectionResetError): stop generating for nobody,
                    # which frees the slot and its pages
                    if rid:
                        server.engine.cancel(rid)

        return Handler

    def start(self, background: bool = True):
        """Serve on a background thread (returns self), or, with
        ``background=False``, in the calling thread until ``stop()``."""
        if background:
            self._thread = threading.Thread(
                target=self.httpd.serve_forever, daemon=True,
                name="serve-http")
            self._thread.start()
        else:
            self.httpd.serve_forever()
        return self

    def stop(self, drain_s: float = 0.0):
        """Shut the server down. ``drain_s > 0``: flip into draining
        (new admissions shed 503 "draining" while the listener still
        answers), wait up to ``drain_s`` seconds for every admitted request
        to be answered, then shut the listener. ``drain_s = 0`` stops now
        and abandons what is in flight (a wedged predict call cannot hold
        the shutdown)."""
        if drain_s and drain_s > 0:
            self.begin_drain()
            deadline = time.monotonic() + float(drain_s)
            while self.inflight() > 0 and time.monotonic() < deadline:
                time.sleep(0.02)
        if self._thread is not None:      # shutdown() waits on serve_forever
            self.httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self.httpd.server_close()
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout=1)
            self._warmup_thread = None
        if self._owned_predictor is not None:
            # the engine built from our Config stops with us
            self._owned_predictor.close()
            self._owned_predictor = None
            self.engine = None


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a saved paddle_tpu_torch model over HTTP")
    ap.add_argument("--model", required=True,
                    help="path to the saved .pdmodel")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8866)
    ap.add_argument("--warmup", action="store_true",
                    help="warm the engine before answering /generate "
                         "(/healthz says warming until done); default from "
                         "PADDLE_TPU_SERVE_WARMUP")
    ap.add_argument("--cpu", action="store_true",
                    help="run the predictor on the CPU (default: the card)")
    args = ap.parse_args(argv)
    cfg = Config(args.model)
    if args.cpu:
        cfg.disable_gpu()
    srv = PredictorServer(cfg, args.host, args.port,
                          warmup=args.warmup or None)
    print(f"serving {args.model} on http://{srv.host}:{srv.port}",
          flush=True)
    srv.start(background=False)


if __name__ == "__main__":
    main()
