"""HTTP front end over the continuous-batching engine (port of
paddle_tpu/inference/serve.py:PredictorServer, ``engine=`` only).

Endpoints:
  GET  /health    -> {"status": "ok"} (liveness)
  GET  /healthz   -> readiness: 200 while the engine can take work, 503
                     with a reason when its queue is saturated or it broke;
                     the body carries slot occupancy and queue depth, and
                     the page-pool and prefix-cache fields (paged engines)
                     and the speculative counters (speculative engines)
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

Errors keep paddle_tpu's contract: 400 for a malformed request, 503 with
``overloaded`` (engine queue full), ``cache_exhausted`` (queue full while
the KV page pool binds), ``deadline_exceeded`` (the request
outlived ``deadline_s``; it is cancelled) or ``backend_unavailable``
(engine broken or stopped), every 503 with a ``Retry-After`` header and a
``retry_after_s`` body field; 409 ``cancelled`` with the partial result.

Not ported yet (ROADMAP.md): /predict, streaming, /cancel, /drain, admin
and metrics endpoints.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..framework.env import float_env
from .engine import CacheExhausted, EngineOverloaded, RequestCancelled

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
    """A threaded stdlib HTTP server bound to host:port in front of one
    ``ContinuousBatchingEngine``. The engine stays the caller's: stop()
    shuts the listener down and leaves the engine running."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8866,
                 deadline_s: float = None):
        if engine is None:
            raise ValueError("PredictorServer needs an engine")
        self.engine = engine
        self.deadline_s = (deadline_s if deadline_s is not None
                           else float_env("PADDLE_TPU_SERVE_DEADLINE", 30.0))
        self._started = time.monotonic()
        self.httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = None

    def _readiness(self):
        st = self.engine.stats()
        body = {"status": "ready",
                "uptime_s": round(time.monotonic() - self._started, 1),
                "engine": {k: st[k] for k in ("slots", "active", "free",
                                              "queued", "max_queue",
                                              "ticks")}}
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
        return True, body

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

            def do_POST(self):
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

    def stop(self):
        if self._thread is not None:      # shutdown() waits on serve_forever
            self.httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self.httpd.server_close()
