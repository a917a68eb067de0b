"""HTTP front end over the inference predictor and the continuous-batching
engine (port of paddle_tpu/inference/serve.py:PredictorServer).

A server has a predictor (``model_path_or_config``: a ``jit.save`` path or
a ``Config``; the predict path), an engine (``engine=``; the generate
path), or both. Endpoints:
  GET  /health    -> {"status": "ok"} (liveness)
  GET  /healthz   -> readiness: 200 while the server can take work, 503
                     with a reason after 3 predict failures in a row, when
                     the predict queue or the engine's queue is saturated,
                     or when the engine broke; with an engine the body
                     carries slot occupancy and queue depth, and the
                     page-pool and prefix-cache fields (paged engines)
                     and the speculative counters (speculative engines)
  GET  /metadata  -> {"inputs": [names], "outputs": [names]}
  POST /predict   -> {"inputs": {name: nested list | {"data": ...,
                      "dtype": "int64"}}} -> {"outputs": {name: {"data",
                      "dtype", "shape"}}}: JSON numbers are coerced to the
                     input's declared dtype; one predict worker thread runs
                     the predictor (its handles are shared state)
  POST /generate  -> {"input_ids": [...], "max_new_tokens": n,
                      "eos_token_id": opt, "seed": opt (a sampling
                      engine's key for the request, default 0)} ->
                     {"tokens": [...],
                      "prompt_len": P, "new_tokens": n,
                      "tokens_generated": k}
  POST /prewarm   -> {"input_ids": [...]} -> {"prewarmed": paged,
                      "prompt_len": P, "paged": paged}: a one-token
                      generate through normal admission, result dropped,
                      so a paged engine's prefix cache holds the prompt

Errors keep paddle_tpu's contract: 400 for a malformed request (an
unknown or a missing input included), 404 for a path the server has no
backend for, 503 with ``overloaded`` (``max_queue`` predict requests
already waiting, or the engine's queue full), ``cache_exhausted`` (queue
full while the KV page pool binds), ``deadline_exceeded`` (the request
outlived ``deadline_s``; a generate request is cancelled, a predict call
abandoned to the worker) or ``backend_unavailable`` (engine broken or
stopped), every 503 with a ``Retry-After`` header and a ``retry_after_s``
body field; 409 ``cancelled`` with the partial result.

Not ported yet (ROADMAP.md): streaming, /cancel, /drain, admin and
metrics endpoints, ``warmup`` (accepted and ignored: there is no compile
to warm).
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..framework.env import float_env
from .engine import CacheExhausted, EngineOverloaded, RequestCancelled
from .predictor import Config, create_predictor

__all__ = ["PredictorServer", "RETRY_AFTER_S"]

# advisory client backoff per 503 reason (seconds)
RETRY_AFTER_S = {
    "overloaded": 1.0,
    # the paged pool binds: clears when a request retires and frees pages
    "cache_exhausted": 2.0,
    "deadline_exceeded": 2.0,
    "backend_unavailable": 2.0,
    "unready": 1.0,
}


def send_json(handler, code, obj, retry_after=None):
    """Write one JSON response; a 503 always carries Retry-After (from
    the body's ``error`` reason when not given)."""
    if code == 503 and retry_after is None:
        reason = str(obj.get("error", "")).split(":")[0]
        retry_after = RETRY_AFTER_S.get(reason, RETRY_AFTER_S["unready"])
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
    at most ``max_queue`` of them wait. The engine stays the caller's:
    ``stop()`` shuts the listener and the predict worker down and leaves
    the engine running. ``warmup`` is accepted and ignored: the port has
    no compile to warm."""

    def __init__(self, model_path_or_config=None, host: str = "127.0.0.1",
                 port: int = 8866, deadline_s: float = None,
                 max_queue: int = None, engine=None, warmup: bool = None):
        if model_path_or_config is None and engine is None:
            raise ValueError(
                "need a model path/Config (predict path), an engine "
                "(generate path), or both")
        self.engine = engine
        self.predictor = None
        if model_path_or_config is not None:
            cfg = (model_path_or_config
                   if isinstance(model_path_or_config, Config)
                   else Config(model_path_or_config))
            self.predictor = create_predictor(cfg)
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
        self._failure_streak = 0        # predict failures in a row
        self._started = time.monotonic()
        self.httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = None

    def _metadata(self):
        if self.predictor is not None:
            return {"inputs": self.predictor.get_input_names(),
                    "outputs": self.predictor.get_output_names()}
        return {"inputs": ["input_ids"], "outputs": ["tokens"]}

    def _readiness(self):
        body = {"status": "ready",
                "uptime_s": round(time.monotonic() - self._started, 1),
                "queue_depth": self._depth, "max_queue": self.max_queue,
                "failure_streak": self._failure_streak}
        st = None
        if self.engine is not None:
            st = self.engine.stats()
            body["engine"] = {k: st[k] for k in ("slots", "active", "free",
                                                 "queued", "max_queue",
                                                 "ticks")}
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
                               "predict failures (backend unavailable?)")
            return False, body
        if self.predictor is not None and self._depth >= self.max_queue:
            body.update(status="unready", reason="request queue saturated")
            return False, body
        return True, body

    def _predict(self, payload):
        """One /predict body through the predictor (on the worker):
        ``{"outputs": {name: {"data", "dtype", "shape"}}}``. Raises
        ValueError or KeyError on a malformed body (a 400)."""
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
                    self._send(200 if ready else 503, body)
                elif self.path == "/metadata":
                    self._send(200, server._metadata())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def _read_json_body(self):
                """The parsed JSON body, or None when it is unreadable or
                not a JSON object."""
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, OSError):
                    return None
                return payload if isinstance(payload, dict) else None

            def _submit(self, payload, max_new_tokens=None, rid=None):
                """``engine.submit`` of the body's request, or None after
                the error reply: 400 for a bad request, 503 for a shed or
                a broken engine."""
                try:
                    n = (int(payload.get("max_new_tokens", 32))
                         if max_new_tokens is None else max_new_tokens)
                    return server.engine.submit(
                        payload["input_ids"], n,
                        payload.get("eos_token_id"),
                        int(payload.get("seed", 0)), request_id=rid)
                except EngineOverloaded as e:
                    self._send(503, shed_body(e))
                except (ValueError, KeyError, TypeError) as e:
                    self._send(400, {"error": str(e)})
                except RuntimeError as e:     # broken or stopped engine
                    self._send(503, {"error": f"backend_unavailable: {e}"})
                return None

            def _prewarm(self):
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
                ``overloaded`` when ``max_queue`` requests already wait."""
                with server._depth_lock:
                    depth = server._depth
                    if depth < server.max_queue:
                        server._depth += 1
                if depth >= server.max_queue:
                    self._read_json_body()       # a 503 on unread bytes
                    self._send(503, {"error": "overloaded",   # resets
                                     "queue_depth": depth})
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
                except (ValueError, KeyError, TypeError) as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:   # noqa: BLE001 — report, go on
                    server._note_failure()
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                finally:
                    if not submitted:
                        release()

            def do_POST(self):
                if self.path == "/predict":
                    if server.predictor is None:
                        self._read_json_body()
                        self._send(404, {"error": "no predictor loaded "
                                         "(engine-only server: POST "
                                         "/generate)"})
                        return
                    self._predict()
                    return
                if self.path in ("/generate", "/prewarm") and \
                        server.engine is None:
                    self._read_json_body()
                    self._send(404, {"error": "no generation engine "
                                     "attached to this server"})
                    return
                if self.path == "/prewarm":
                    self._prewarm()
                    return
                if self.path != "/generate":
                    self._read_json_body()
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                rid = uuid.uuid4().hex[:16]
                payload = self._read_json_body()
                if payload is None:
                    self._send(400, {"error": "bad body"})
                    return
                fut = self._submit(payload, rid=rid)
                if fut is None:
                    return
                prompt_len = len(np.asarray(payload["input_ids"]).reshape(-1))
                try:
                    out = fut.result(timeout=server.deadline_s)
                except FutureTimeout:
                    server.engine.cancel(rid)
                    self._send(503, {"error": "deadline_exceeded",
                                     "deadline_s": server.deadline_s})
                    return
                except RequestCancelled:
                    body = {"error": "cancelled", "request_id": rid}
                    body.update(getattr(fut, "_ptpu_gen_info", None) or {})
                    self._send(409, body)
                    return
                except Exception as e:   # noqa: BLE001 — engine fault:
                    # the client gets its 503 with the partial result
                    body = {"error": f"backend_unavailable: {e}"}
                    body.update(getattr(fut, "_ptpu_gen_info", None) or {})
                    self._send(503, body)
                    return
                body = {"tokens": out.tolist(), "prompt_len": prompt_len,
                        "new_tokens": len(out) - prompt_len}
                body.update(getattr(fut, "_ptpu_gen_info", None) or {})
                self._send(200, body)

        return Handler

    def start(self):
        """Serve on a background thread; returns self."""
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="serve-http")
        self._thread.start()
        return self

    def _note_failure(self, reset=False):
        """Count a failed predict call (or, ``reset``, a good one)."""
        with self._depth_lock:
            self._failure_streak = 0 if reset else self._failure_streak + 1

    def stop(self):
        if self._thread is not None:      # shutdown() waits on serve_forever
            self.httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self.httpd.server_close()
        self._pool.shutdown(wait=False, cancel_futures=True)
