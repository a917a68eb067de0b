"""paddle_tpu_torch continuous-batching engine and HTTP server.

The port's engine (CPU, slots 3, max_len 64, buckets (8, 16), tick_tokens
2) serves staggered mixed-length greedy requests; its tokens must be
identical to paddle_tpu's engine on the same copied weights with the
fused-kernel knobs on (PADDLE_TPU_MEGA_DECODE for the f32 cache,
PADDLE_TPU_FUSED_CACHE_WRITE for the int8 cache) and to the port's own
sequential ``generate``.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.jit.functional import raw_state
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        EngineOverloaded, PredictorServer,
                                        RequestCancelled)
from paddle_tpu_torch.models import GPTForCausalLM, generate, gpt_tiny

ENGINE_KW = dict(max_len=64, prefill_buckets=(8, 16), tick_tokens=2)
# (prompt length, max_new_tokens): both buckets, budgets that end
# mid-tick and on a tick boundary, more requests than slots
SHAPES = [(5, 6), (12, 9), (3, 12), (16, 4), (9, 7)]


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    load_paddle_tpu_params(tm, {n: np.asarray(v)
                                for n, v in raw_state(jm)[0].items()})
    return jm, tm


@pytest.fixture(scope="module")
def engine(models):
    eng = ContinuousBatchingEngine(models[1], slots=3, cache_dtype="float32",
                                   device="cpu", **ENGINE_KW)
    yield eng
    eng.stop()


def _prompts():
    return [np.random.RandomState(i).randint(0, 256, (p,)).astype(np.int64)
            for i, (p, _) in enumerate(SHAPES)]


def _serve_staggered(eng, prompts):
    futs = []
    for ids, (_, n) in zip(prompts, SHAPES):
        futs.append(eng.submit(ids, max_new_tokens=n))
        time.sleep(0.01)          # arrivals land across tick boundaries
    return [f.result(timeout=300) for f in futs]


@pytest.mark.parametrize("cache_dtype,knob", [
    ("float32", "PADDLE_TPU_MEGA_DECODE"),
    ("int8", "PADDLE_TPU_FUSED_CACHE_WRITE")])
def test_engine_tokens_match_jax_engine_and_generate(models, monkeypatch,
                                                     cache_dtype, knob):
    monkeypatch.setenv(knob, "1")
    jm, tm = models
    prompts = _prompts()
    jeng = JaxEngine(jm, slots=3, cache_dtype=cache_dtype, **ENGINE_KW)
    try:
        want = _serve_staggered(jeng, prompts)
    finally:
        jeng.stop()
    teng = ContinuousBatchingEngine(tm, slots=3, cache_dtype=cache_dtype,
                                    device="cpu", **ENGINE_KW)
    try:
        got = _serve_staggered(teng, prompts)
        stats = teng.stats()
    finally:
        teng.stop()
    for ids, (p, n), g, w in zip(prompts, SHAPES, got, want):
        assert g.dtype == np.int64 and g.shape == (p + n,)
        np.testing.assert_array_equal(g, w)
        seq = generate(tm, ids, n, cache_dtype=cache_dtype)[0]
        np.testing.assert_array_equal(g, seq)
    assert stats["admitted"] == stats["completed"] == len(SHAPES)
    assert stats["active"] == 0 and stats["queued"] == 0
    assert set(stats["kernel_launches"]) == {"mega_decode_step",
                                             "kv_slot_write"}


def test_eos_retires_and_pads(models, engine):
    _, tm = models
    ids = _prompts()[0]
    eos = int(generate(tm, ids, 3, cache_dtype="float32")[0, -1])
    out = engine.generate(ids, max_new_tokens=10, eos_token_id=eos,
                          timeout=60)
    want = generate(tm, ids, 10, cache_dtype="float32",
                    eos_token_id=eos)[0]
    np.testing.assert_array_equal(out, want)
    assert out[-1] == eos


def test_slot_reuse_resets_rows(models, engine):
    """A request admitted into a slot a longer request used before sees
    none of its rows: same tokens as on a fresh engine."""
    _, tm = models
    long_ids = np.arange(16, dtype=np.int64) + 40
    short = np.asarray([7, 8, 9], np.int64)
    for _ in range(2):
        engine.generate(long_ids, max_new_tokens=20, timeout=60)
        out = engine.generate(short, max_new_tokens=5, timeout=60)
        np.testing.assert_array_equal(
            out, generate(tm, short, 5, cache_dtype="float32")[0])


def test_submit_validates(engine):
    with pytest.raises(ValueError, match="overshoot"):
        engine.submit(np.zeros(16, np.int64), max_new_tokens=47)
    with pytest.raises(ValueError, match="bucket"):
        engine.submit(np.zeros(17, np.int64), max_new_tokens=1)
    with pytest.raises(ValueError, match="token ids"):
        engine.submit(np.asarray([3, 256]), max_new_tokens=1)
    with pytest.raises(ValueError, match="empty"):
        engine.submit(np.zeros(0, np.int64))


def test_overload_and_cancel(models):
    eng = ContinuousBatchingEngine(models[1], slots=2, max_queue=0,
                                   cache_dtype="float32", device="cpu",
                                   **ENGINE_KW)
    try:
        with pytest.raises(EngineOverloaded):
            eng.submit(np.asarray([1, 2, 3]), max_new_tokens=2)
    finally:
        eng.stop()
    eng = ContinuousBatchingEngine(models[1], slots=2, cache_dtype="float32",
                                   device="cpu", **ENGINE_KW)
    try:
        with eng._cv:                   # hold the loop: the request queues
            fut = eng.submit(np.asarray([1, 2, 3]), max_new_tokens=2,
                             request_id="r1")
            assert eng.cancel("r1")
        with pytest.raises(RequestCancelled):
            fut.result(timeout=10)
        assert not eng.cancel("r1")
        assert eng.stats()["cancelled"] == 1
    finally:
        eng.stop()


@pytest.mark.parametrize("kw,what", [
    ({"speculative": "draft"}, "draft"), ({"draft_model": object()}, "draft"),
    ({"tp": 2}, "tensor parallelism"),
    ({"comm_precision": "int8"}, "tensor parallelism")])
def test_unported_options_raise(models, kw, what):
    """Tensor parallelism is not ported and raises naming it. Draft-model
    speculation is ported and follows paddle_tpu's engine:
    ``speculative="draft"`` without ``draft_model`` raises ValueError, and
    a ``draft_model`` without ``speculative="draft"`` is ignored (a plain
    engine)."""
    if what != "draft":
        with pytest.raises(NotImplementedError, match=what):
            ContinuousBatchingEngine(models[1], device="cpu", **kw)
        return
    if "speculative" in kw:
        for build in (lambda: JaxEngine(models[0], **kw),
                      lambda: ContinuousBatchingEngine(models[1],
                                                       device="cpu", **kw)):
            with pytest.raises(ValueError, match="draft_model"):
                build()
        return
    for eng in (JaxEngine(models[0], slots=2, **ENGINE_KW, **kw),
                ContinuousBatchingEngine(models[1], slots=2, device="cpu",
                                         **ENGINE_KW, **kw)):
        try:
            assert eng.stats()["speculative"] is None
        finally:
            eng.stop()


def test_default_device_is_the_card(models):
    """No device argument means the CUDA card; without one the engine
    raises instead of serving from the CPU."""
    if torch.cuda.is_available():
        eng = ContinuousBatchingEngine(GPTForCausalLM(gpt_tiny()), slots=2,
                                       **ENGINE_KW)
        eng.stop()
        assert eng.device.type == "cuda"
        with pytest.raises(ValueError, match="model lives on"):
            ContinuousBatchingEngine(models[1], slots=2)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ContinuousBatchingEngine(models[1], slots=2)


def _post(url, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url + "/generate", data=data,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_server_round_trip_and_errors(models, engine):
    srv = PredictorServer(engine=engine, host="127.0.0.1", port=0).start()
    url = f"http://{srv.host}:{srv.port}"
    try:
        prompts = _prompts()[:3]
        results = [None] * 3

        def one(i):
            results[i] = _post(url, {"input_ids": prompts[i].tolist(),
                                     "max_new_tokens": SHAPES[i][1]})
        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for (code, _, body), ids, (p, n) in zip(results, prompts, SHAPES):
            assert code == 200, body
            direct = engine.generate(ids, max_new_tokens=n, timeout=60)
            assert body["tokens"] == direct.tolist()
            assert (body["prompt_len"], body["new_tokens"],
                    body["tokens_generated"]) == (p, n, n)
        code, _, body = _post(url, None, raw=b"{not json")
        assert code == 400 and body["error"] == "bad body"
        code, _, body = _post(url, {"max_new_tokens": 2})
        assert code == 400
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            hz = json.loads(r.read())
        assert hz["status"] == "ready" and hz["engine"]["slots"] == 3
    finally:
        srv.stop()
    full = ContinuousBatchingEngine(models[1], slots=2, max_queue=0,
                                    cache_dtype="float32", device="cpu",
                                    **ENGINE_KW)
    srv = PredictorServer(engine=full, host="127.0.0.1", port=0).start()
    try:
        code, headers, body = _post(f"http://{srv.host}:{srv.port}",
                                    {"input_ids": [1, 2, 3]})
        assert code == 503 and body["error"] == "overloaded"
        assert headers["Retry-After"] == "1" and body["retry_after_s"] == 1.0
    finally:
        srv.stop()
        full.stop()
