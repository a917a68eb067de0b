"""The serving tier's engine surface in paddle_tpu_torch against
paddle_tpu's (gpt_tiny, slots 2, tick_tokens 2, on the CPU).

A streamed /generate equals the port's single-shot body and the tokens of
paddle_tpu's server on the same weights (copied by name, convert.py); the
engine's /metrics families (names, help strings, kinds, buckets) and a
fresh engine's rendered text equal paddle_tpu's for slot, paged and
speculative engines; and paddle_tpu's serving contracts hold
(tests/test_serve.py:161-357, tests/test_engine.py:160-263, :387):
cancellation queued and mid-decode with the partial result, progress_cb
(a raising one dropped), drain and the fast stop, a stream disconnect
that frees the slot and its pages, 503 warming_up, the /admin/inject
gate, the engine's warmup, and Config.enable_continuous_batching.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.engine import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.serve import PredictorServer as JaxServer
from paddle_tpu.jit.functional import raw_state
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu_torch import obs
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch.distributed import resilience
from paddle_tpu_torch.inference import (Config, ContinuousBatchingEngine,
                                        GenerationPredictor,
                                        PredictorServer, RequestCancelled,
                                        create_predictor)
from paddle_tpu_torch.models import GPTForCausalLM, generate, gpt_tiny
from paddle_tpu_torch.obs import metrics

ENGINE_KW = dict(max_len=96, prefill_buckets=(8, 16), tick_tokens=2)
PAGED = dict(paged=True, page_size=8)
SPEC = dict(paged=True, page_size=8, speculative="ngram", spec_k=3)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    load_paddle_tpu_params(tm, {n: np.asarray(v)
                                for n, v in raw_state(jm)[0].items()})
    return jm, tm


def _engine(tm, **kw):
    return ContinuousBatchingEngine(tm, slots=2, cache_dtype="float32",
                                    device="cpu", **ENGINE_KW, **kw)


@pytest.fixture(scope="module")
def server(models):
    eng = _engine(models[1], **PAGED)
    srv = PredictorServer(engine=eng, port=0).start()
    yield srv
    srv.stop()
    eng.stop()


def _url(srv):
    return f"http://{srv.host}:{srv.port}"


def _req(srv, path, payload=None, headers=None, timeout=60):
    """(status, parsed JSON body, headers)."""
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        _url(srv) + path, data=data,
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _stream(srv, payload, headers=None):
    """Every NDJSON line of a streamed /generate."""
    req = urllib.request.Request(
        _url(srv) + "/generate", json.dumps(dict(payload, stream=True))
        .encode(), dict({"Content-Type": "application/json"},
                        **(headers or {})))
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(raw) for raw in r if raw.strip()]


def _retry_after(code, body, hdr, reason):
    assert code == 503, body
    assert body["error"].split(":")[0] == reason, body
    assert float(body["retry_after_s"]) > 0 and int(hdr["Retry-After"]) >= 1


def _prompt(i, n):
    return np.random.RandomState(i).randint(0, 256, (n,)).astype(np.int64)


def _wait(cond, timeout=30):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.01)


def test_stream_equals_single_shot_and_reference_server(models, server):
    """{"t"} lines concatenated are the generated suffix; the "done" body
    equals the single-shot body token for token and paddle_tpu's server's
    greedy tokens on the same weights."""
    jm, _ = models
    payload = {"input_ids": _prompt(0, 11).tolist(), "max_new_tokens": 9}
    jeng = JaxEngine(jm, slots=2, cache_dtype="float32", max_len=96,
                     prefill_buckets=(16,), tick_tokens=2)
    jsrv = JaxServer(engine=jeng, port=0).start()
    try:
        code, ref, _ = _req(jsrv, "/generate", payload, timeout=120)
    finally:
        jsrv.stop()
        jeng.stop()
    assert code == 200
    code, one, _ = _req(server, "/generate", payload)
    assert code == 200
    events = _stream(server, payload, {"X-PTPU-Request-Id": "s-1"})
    body = events[-1]["done"]
    assert body["request_id"] == "s-1"
    assert len(events[0]["t"]) == 1        # the first token, at admission
    streamed = [t for ev in events[:-1] for t in ev["t"]]
    assert streamed == body["tokens"][11:11 + body["tokens_generated"]]
    for k in ("tokens", "prompt_len", "new_tokens", "tokens_generated"):
        assert body[k] == one[k] == ref[k]


def _families(reg):
    return {n: (f.kind, f.help, getattr(f, "buckets", None))
            for n, f in reg._families.items() if n.startswith("ptpu_engine")}


@pytest.mark.parametrize("kind", ["slot", "paged", "speculative"])
def test_metrics_families_equal_reference(models, monkeypatch, kind):
    """A fresh engine registers paddle_tpu's series (names, help, kinds,
    buckets), and the rendered text of both registries is the same."""
    jm, tm = models
    kw = {"slot": {}, "paged": PAGED, "speculative": SPEC}[kind]
    mine, ref = metrics.Registry(), jmetrics.Registry()
    monkeypatch.setattr(metrics, "registry", mine)
    monkeypatch.setattr(jmetrics, "registry", ref)
    eng = _engine(tm, **kw)
    jeng = JaxEngine(jm, slots=2, cache_dtype="float32", **ENGINE_KW, **kw)
    try:
        assert _families(mine) == _families(ref)
        assert mine.render() == ref.render()
        names = set(_families(mine))
        assert ("ptpu_engine_pages_free" in names) == (kind != "slot")
        assert ("ptpu_engine_spec_ticks_total" in names) == \
            (kind == "speculative")
    finally:
        eng.stop()
        jeng.stop()


def test_metrics_endpoint_monotone_and_healthz_fresh(server):
    def scrape():
        with urllib.request.urlopen(_url(server) + "/metrics",
                                    timeout=10) as r:
            assert "text/plain" in r.headers["Content-Type"]
            return {n: v for n, l, v in metrics.parse_text(r.read().decode())
                    if not l}

    _req(server, "/generate", {"input_ids": [5, 6], "max_new_tokens": 4})
    s1 = scrape()
    _req(server, "/generate", {"input_ids": [7, 8], "max_new_tokens": 4})
    s2 = scrape()
    for name in ("ptpu_engine_ticks_total", "ptpu_engine_admits_total",
                 "ptpu_engine_retires_total", "ptpu_engine_ttft_ms_count",
                 "ptpu_engine_queue_wait_ms_count",
                 "ptpu_engine_batch_occupancy_count"):
        assert s2[name] > s1[name] > 0, name
    code, hz, _ = _req(server, "/healthz")
    assert code == 200 and hz["metrics_seq"] > 0 and hz["uptime_s"] >= 0
    assert hz["engine"]["tick_model_eff"] > 0 and hz["engine"]["warm"]


def test_cancel_queued_and_mid_decode_with_partial(models):
    """A queued request resolves at once with zero tokens; an admitted one
    retires at the next tick with a partial result that is a prefix of
    its greedy tokens; cancel is idempotent; the slot frees."""
    tm = models[1]
    eng = _engine(tm)
    gate = threading.Event()
    tick = eng._tick

    def held_tick():
        gate.wait(30)
        tick()
    eng._tick = held_tick
    try:
        seen = []
        hogs = [eng.submit(_prompt(i, 6), 40, request_id=f"hog{i}",
                           progress_cb=seen.extend if i == 0 else None)
                for i in range(2)]
        victim = eng.submit(_prompt(9, 6), 4, request_id="victim")
        _wait(lambda: eng.stats()["active"] == 2)
        assert eng.cancel("victim") is True
        with pytest.raises(RequestCancelled) as ei:
            victim.result(timeout=10)
        assert ei.value.tokens_generated == 0
        assert victim._ptpu_gen_info == {"tokens_generated": 0,
                                         "partial_tokens": []}
        assert eng.cancel("victim") is False and eng.cancel(None) is False
        assert eng.cancel("hog0") is True
        gate.set()
        with pytest.raises(RequestCancelled):
            hogs[0].result(timeout=30)
        info = hogs[0]._ptpu_gen_info
        want = generate(tm, _prompt(0, 6), 40, cache_dtype="float32")[0]
        assert info["partial_tokens"] == want[6:6 + info["tokens_generated"]
                                              ].tolist() == seen
        assert hogs[1].result(timeout=30).shape[0] == 46
        _wait(lambda: eng.stats()["active"] == 0)
        assert eng.stats()["cancelled"] == 2
    finally:
        gate.set()
        eng.stop()


def test_progress_cb_blocks_and_raising_cb_dropped(models):
    tm = models[1]
    eng = _engine(tm)
    try:
        blocks = []
        out = eng.submit(_prompt(3, 7), 7, progress_cb=blocks.append).result(
            timeout=30)
        assert [len(b) for b in blocks] == [1, 2, 2, 2]
        assert sum(blocks, []) == out[7:].tolist()
        calls = []

        def bad(toks):
            calls.append(list(toks))
            raise RuntimeError("broken stream")
        out = eng.submit(_prompt(4, 6), 8, progress_cb=bad).result(timeout=30)
        np.testing.assert_array_equal(
            out, generate(tm, _prompt(4, 6), 8, cache_dtype="float32")[0])
        assert len(calls) == 1
    finally:
        eng.stop()


def test_cancel_endpoint_mid_decode_409_with_partial(server):
    """/cancel on a request wedged mid-decode (replica_stall): its waiter
    gets 409 "cancelled" with the partial result; a second cancel is a
    no-op; no id is a 400."""
    rid, result = "cancel-me-http", {}

    def waiter():
        result["resp"] = _req(server, "/generate",
                              {"input_ids": [2, 7, 1, 8],
                               "max_new_tokens": 60},
                              {"X-PTPU-Request-Id": rid})
    resilience.arm_fault("replica_stall", 1, wedge_s=0.5)
    t = threading.Thread(target=waiter)
    t.start()
    _wait(lambda: server.engine.stats()["active"] >= 1)
    code, body, _ = _req(server, "/cancel", {"request_id": rid})
    assert code == 200 and body["cancelled"] is True
    t.join(timeout=30)
    assert not t.is_alive()
    code, body, _ = result["resp"]
    assert code == 409 and body["error"] == "cancelled"
    assert body["request_id"] == rid
    assert body["tokens_generated"] == len(body["partial_tokens"]) >= 1
    assert _req(server, "/cancel", {"request_id": rid})[1]["cancelled"] \
        is False
    assert _req(server, "/cancel", {})[0] == 400


def test_stream_disconnect_frees_slot_and_pages(server):
    eng = server.engine
    cancelled0 = eng.stats()["cancelled"]
    resilience.arm_fault("replica_stall", 1, wedge_s=0.3)
    req = urllib.request.Request(
        _url(server) + "/generate",
        json.dumps({"input_ids": [3, 1, 4, 1, 5, 9, 2, 6],
                    "max_new_tokens": 80, "stream": True}).encode(),
        {"Content-Type": "application/json"})
    r = urllib.request.urlopen(req, timeout=30)
    assert json.loads(r.readline())["t"]
    r.close()                                   # the client vanishes
    _wait(lambda: eng.stats()["cancelled"] > cancelled0
          and eng.stats()["active"] == 0)
    st = eng.stats()
    assert st["cancelled"] == cancelled0 + 1
    assert st["pages_used"] == st["pages_cached_prefix"]
    eng._allocator.check()


def test_drain_finishes_inflight_and_sheds_new(models):
    tm = models[1]
    eng = _engine(tm)
    srv = PredictorServer(engine=eng, port=0).start()
    gate = threading.Event()
    tick = eng._tick

    def held_tick():
        gate.wait(30)
        tick()
    eng._tick = held_tick
    results = {}
    t = threading.Thread(target=lambda: results.update(long=_req(
        srv, "/generate", {"input_ids": [3, 1, 4], "max_new_tokens": 20})))
    t.start()
    _wait(lambda: srv.inflight() >= 1 and eng.stats()["active"] == 1)
    stopper = threading.Thread(target=srv.stop, kwargs={"drain_s": 30.0})
    stopper.start()
    _wait(lambda: srv._draining)
    try:
        _retry_after(*_req(srv, "/generate", {"input_ids": [1],
                                              "max_new_tokens": 2}),
                     "draining")
        code, body, _ = _req(srv, "/healthz")
        assert code == 503 and body["status"] == "draining"
    finally:
        gate.set()
    t.join(timeout=30)
    stopper.join(timeout=30)
    assert not t.is_alive() and not stopper.is_alive()
    code, body, _ = results["long"]
    assert code == 200 and len(body["tokens"]) == 3 + 20
    eng.stop()


def test_fast_stop_and_start_in_caller_thread(server):
    srv = PredictorServer(engine=server.engine, port=0)
    t = threading.Thread(target=srv.start, kwargs={"background": False})
    t.start()
    _wait(lambda: srv.httpd.socket is not None)
    assert _req(srv, "/health")[1] == {"status": "ok"}
    t0 = time.monotonic()
    srv.httpd.shutdown()
    t.join(timeout=10)
    srv.stop()
    assert not t.is_alive() and time.monotonic() - t0 < 10


def test_warming_503_then_ready(models):
    """warmup=True: /healthz 503 "warming" and /generate 503 warming_up
    until the engine's warmup ran; then the caches, the pool and the
    counters are a fresh engine's and the program count is final."""
    tm = models[1]
    eng = _engine(tm, **SPEC)
    gate = threading.Event()
    warmup = eng.warmup

    def held_warmup():
        gate.wait(30)
        return warmup()
    eng.warmup = held_warmup
    srv = PredictorServer(engine=eng, port=0, warmup=True).start()
    try:
        _retry_after(*_req(srv, "/generate", {"input_ids": [1],
                                              "max_new_tokens": 2}),
                     "warming_up")
        code, body, hdr = _req(srv, "/healthz")
        assert code == 503 and body["status"] == "warming"
        assert int(hdr["Retry-After"]) >= 1
        gate.set()
        _wait(lambda: _req(srv, "/healthz")[0] == 200)
        st = eng.stats()
        assert (st["ticks"], st["admitted"], st["prefill_tokens"],
                st["spec_ticks"], st["pages_used"]) == (0, 0, 0, 0, 0)
        eng._allocator.check()
        assert all(float(leaf.abs().sum()) == 0 for kc, vc in eng._caches
                   for leaf in (*kc.values(), *vc.values()))
        # 2 admissions, decode, verify, the page copy
        assert eng.compiled_program_count == 5 and eng.warm
        ids = _prompt(5, 16)
        code, body, _ = _req(srv, "/generate", {"input_ids": ids.tolist(),
                                                "max_new_tokens": 6})
        assert body["tokens"] == generate(tm, ids, 6,
                                          cache_dtype="float32")[0].tolist()
        assert eng.compiled_program_count == 5
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            warmup(store="unused")
    finally:
        gate.set()
        srv.stop()
        eng.stop()


def test_admin_inject_gated_and_validated(server, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_CHAOS_ADMIN", raising=False)
    code, body, _ = _req(server, "/admin/inject",
                         {"site": "replica_stall", "count": 1})
    assert code == 403 and "chaos admin" in body["error"]
    monkeypatch.setenv("PADDLE_TPU_CHAOS_ADMIN", "1")
    code, body, _ = _req(server, "/admin/inject",
                         {"site": "replica_stal", "count": 1})
    assert code == 400 and "unknown fault-injection" in body["error"]
    code, body, _ = _req(server, "/admin/inject",
                         {"site": "replica_stall", "count": 1,
                          "wedge_s": 0.3})
    assert code == 200 and body["armed"] == "replica_stall"
    t0 = time.monotonic()
    assert _req(server, "/generate", {"input_ids": [5, 3],
                                      "max_new_tokens": 4})[0] == 200
    assert time.monotonic() - t0 >= 0.3
    with resilience.FaultInjector({"serve_backend": 1}):
        _retry_after(*_req(server, "/generate", {"input_ids": [5],
                                                 "max_new_tokens": 2}),
                     "backend_unavailable")


def test_admin_trace_holds_request_spans(server):
    rid = "trace-rid-7"
    assert _req(server, "/generate", {"input_ids": [1, 2, 3],
                                      "max_new_tokens": 6},
                {"X-PTPU-Request-Id": rid})[0] == 200
    code, doc, _ = _req(server, "/admin/trace?duration_s=0", {})
    assert code == 200 and rid in doc["metadata"]["request_ids"]
    names = {e["name"] for e in doc["traceEvents"]
             if e.get("args", {}).get("request_id") == rid}
    assert {"serve.generate", "serve.detokenize", "engine.queue_wait",
            "engine.prefill", "engine.decode"} <= names
    assert any(e["name"] == "engine.tick" for e in doc["traceEvents"])
    assert _req(server, "/admin/trace?duration_s=x", {})[0] == 400


def test_config_enable_continuous_batching(models):
    tm = models[1]
    cfg = Config()
    cfg.enable_continuous_batching(model=tm, slots=2, max_len=64,
                                   cache_dtype="float32",
                                   prefill_buckets=(8,), tick_tokens=4)
    pred = create_predictor(cfg)
    assert isinstance(pred, GenerationPredictor)
    try:
        assert pred.get_input_names() == ["input_ids"]
        assert pred.get_output_names() == ["tokens"]
        ids = _prompt(8, 6)
        np.testing.assert_array_equal(
            pred.generate(ids, max_new_tokens=4, timeout=30),
            generate(tm, ids, 4, cache_dtype="float32")[0])
    finally:
        pred.close()
    srv = PredictorServer(cfg, port=0).start()     # the engine is its own
    try:
        assert srv.predictor is None and srv.engine is not None
        assert _req(srv, "/generate", {"input_ids": [1, 2],
                                       "max_new_tokens": 2})[0] == 200
    finally:
        srv.stop()
    assert srv.engine is None
    cfg2 = Config()
    cfg2.enable_continuous_batching(model=None)
    with pytest.raises(ValueError):
        create_predictor(cfg2)


def test_obs_disabled_server_still_streams(models):
    """With obs off the engine records nothing, and a stream still works
    (its request id is minted by the server)."""
    obs.set_enabled(False)
    try:
        eng = _engine(models[1])
    finally:
        obs.set_enabled(None)
    srv = PredictorServer(engine=eng, port=0).start()
    try:
        events = _stream(srv, {"input_ids": [4, 4, 2], "max_new_tokens": 5})
        body = events[-1]["done"]
        assert body["request_id"]
        assert [t for ev in events[:-1] for t in ev["t"]] == \
            body["tokens"][3:]
    finally:
        srv.stop()
        eng.stop()
