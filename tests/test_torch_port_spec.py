"""paddle_tpu_torch n-gram speculative decoding against paddle_tpu's.

- ``NGramProposer``: the same (props, n) as paddle_tpu's on random and
  periodic contexts.
- The speculative engine on f32 slot, int8 slot and f32 paged caches:
  greedy tokens equal to plain decode (``generate()``) and to paddle_tpu's
  speculative engine (PADDLE_TPU_FUSED_CACHE_WRITE on for the paged
  pools), with the same ``tokens_drafted`` / ``tokens_accepted`` after
  every request (requests are served one at a time, so both engines see
  the same tick composition).
- Greedy only: ``do_sample`` with ``speculative=`` raises ValueError, as
  paddle_tpu's engine does; so does ``speculative="draft"`` without a
  ``draft_model`` (the draft-model proposer's tests:
  tests/test_torch_port_draft.py).
"""
import json
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.engine import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.speculative import NGramProposer as JaxProposer
from paddle_tpu.jit.functional import raw_state
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        PredictorServer)
from paddle_tpu_torch.inference.speculative import (NGramProposer,
                                                    resolve_speculative)
from paddle_tpu_torch.models import GPTForCausalLM, generate, gpt_tiny

ENGINE_KW = dict(max_len=64, prefill_buckets=(8, 16), tick_tokens=2,
                 speculative="ngram", spec_k=4)
_SPEC = ("spec_ticks", "tokens_drafted", "tokens_accepted",
         "tokens_rejected", "acceptance_rate", "accepted_tokens_per_tick")


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n,)).astype(
        np.int64)


def _rep_prompt(seed, period, reps):
    return np.concatenate([_prompt(seed, period)] * reps)


@pytest.mark.parametrize("k,ngram", [(4, 3), (2, 2), (8, 1)])
def test_ngram_proposer_matches_jax(k, ngram):
    ours, theirs = NGramProposer(k, ngram), JaxProposer(k, ngram)
    rs = np.random.RandomState(k)
    contexts = [np.array([9, 7, 8, 9, 1, 2, 7, 8]),
                np.array([5, 6, 1, 1, 5, 6, 3, 3, 5, 6]),
                np.array([1, 2, 8, 1, 2]), np.array([1, 2, 3, 4, 5]),
                np.array([4]), np.array([3, 3, 3, 3, 3, 3])]
    contexts += [rs.randint(0, 6, rs.randint(2, 40)) for _ in range(40)]
    contexts += [_rep_prompt(i, p, r)[:rs.randint(p, p * r + 1)]
                 for i, (p, r) in enumerate([(2, 6), (3, 5), (4, 4),
                                             (7, 3), (32, 3)])]
    hits = 0
    for ctx in contexts:
        got, want = ours.propose(ctx), theirs.propose(ctx)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
        hits += got[1] > 0
    assert hits > len(contexts) // 2


def test_resolve_speculative_knobs(monkeypatch):
    assert resolve_speculative(False) is None
    assert resolve_speculative(None) is None          # env unset
    cfg = resolve_speculative(True, spec_k=6, spec_ngram=2)
    assert (cfg.kind, cfg.k, cfg.ngram_max) == ("ngram", 6, 2)
    monkeypatch.setenv("PADDLE_TPU_SERVE_SPEC", "ngram")
    monkeypatch.setenv("PADDLE_TPU_SERVE_SPEC_K", "3")
    assert resolve_speculative(None).k == 3
    with pytest.raises(ValueError, match="draft_model"):
        resolve_speculative("draft")
    with pytest.raises(ValueError):
        resolve_speculative("beam")
    with pytest.raises(ValueError):
        resolve_speculative(True, spec_k=0)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    load_paddle_tpu_params(tm, {n: np.asarray(v)
                                for n, v in raw_state(jm)[0].items()})
    return jm, tm


# repetitive and random prompts; a 16-token prompt twice (a prefix hit,
# and on paged pools the copy-on-write admission)
_REQS = [(_rep_prompt(0, 4, 3), 12), (_prompt(1, 9), 8),
         (_rep_prompt(2, 3, 5), 10), (_rep_prompt(3, 8, 2), 9),
         (_rep_prompt(3, 8, 2), 6), (_prompt(4, 5), 7)]


def _sequential(eng, reqs):
    outs, stats = [], []
    for ids, n in reqs:
        outs.append(eng.generate(ids, max_new_tokens=n, timeout=300))
        stats.append(eng.stats())
    return outs, stats


@pytest.mark.parametrize("cache_dtype,paged", [
    ("float32", False), ("int8", False), ("float32", True)])
def test_spec_engine_matches_plain_decode_and_jax(models, monkeypatch,
                                                  cache_dtype, paged):
    monkeypatch.setenv("PADDLE_TPU_FUSED_CACHE_WRITE", "1")
    jm, tm = models
    kw = dict(slots=2, cache_dtype=cache_dtype, **ENGINE_KW)
    if paged:
        kw.update(paged=True, page_size=8)
    jeng = JaxEngine(jm, **kw)
    try:
        want, jstats = _sequential(jeng, _REQS)
    finally:
        jeng.stop()
    teng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    try:
        got, tstats = _sequential(teng, _REQS)
    finally:
        teng.stop()
    for (ids, n), g, w in zip(_REQS, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, generate(tm, ids, n, cache_dtype=cache_dtype)[0])
    for ts, js in zip(tstats, jstats):
        assert {k: ts[k] for k in _SPEC} == {k: js[k] for k in _SPEC}
    st = tstats[-1]
    assert st["speculative"] == "ngram" and st["spec_k"] == 4
    assert st["spec_ticks"] > 0 and st["acceptance_rate"] > 0
    assert st["accepted_tokens_per_tick"] > 1
    assert st["tokens_accepted"] + st["tokens_rejected"] == \
        st["tokens_drafted"]
    if paged:
        assert st["prefix_hits"] == tstats[3]["prefix_hits"] + 1


def test_spec_staggered_traffic_and_eos_mid_block(models):
    """Staggered arrivals on paged pools (tick composition changes with
    timing; tokens must not), and an eos that lands inside a verify
    block truncates and pads as plain decode does."""
    _, tm = models
    eng = ContinuousBatchingEngine(tm, slots=3, cache_dtype="float32",
                                   device="cpu", paged=True, page_size=8,
                                   **ENGINE_KW)
    try:
        reqs = [(_rep_prompt(10 + i, 2 + i % 4, 3), 8) for i in range(5)]
        reqs += [(_prompt(20, 11), 6), (_prompt(21, 3), 9)]
        futs = []
        for ids, n in reqs:
            futs.append(eng.submit(ids, max_new_tokens=n))
            time.sleep(0.01)
        for (ids, n), f in zip(reqs, futs):
            np.testing.assert_array_equal(
                f.result(timeout=300),
                generate(tm, ids, n, cache_dtype="float32")[0])
        ids = _rep_prompt(6, 3, 3)
        eos = int(generate(tm, ids, 8, cache_dtype="float32")[0, 11])
        want = generate(tm, ids, 12, cache_dtype="float32",
                        eos_token_id=eos)[0]
        got = eng.generate(ids, max_new_tokens=12, eos_token_id=eos,
                           timeout=300)
        np.testing.assert_array_equal(got, want)
        assert eng.stats()["spec_ticks"] > 0
    finally:
        eng.stop()


def test_spec_healthz_and_generate_fields(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, slots=2, cache_dtype="float32",
                                   device="cpu", **ENGINE_KW)
    srv = PredictorServer(engine=eng, host="127.0.0.1", port=0).start()
    url = f"http://{srv.host}:{srv.port}"
    try:
        ids = _rep_prompt(60, 4, 3)
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(
                {"input_ids": ids.tolist(), "max_new_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["tokens"] == generate(tm, ids, 8,
                                          cache_dtype="float32")[0].tolist()
        assert body["tokens_generated"] == 8
        assert body["tokens_drafted"] >= body["tokens_accepted"] > 0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            e = json.loads(r.read())["engine"]
        assert e["speculative"] == "ngram" and e["spec_k"] == 4
        assert e["tokens_drafted"] >= e["tokens_accepted"] > 0
        assert 0.0 < e["acceptance_rate"] <= 1.0
        st = eng.stats()
        assert {k: e[k] for k in _SPEC} == {k: st[k] for k in _SPEC}
        assert e["accepted_tokens_per_tick"] >= 1.0
        assert "paged" not in e
    finally:
        srv.stop()
        eng.stop()


@pytest.mark.parametrize("kw,exc,match", [
    ({"do_sample": True}, ValueError, "greedy-only"),
    ({"do_sample": True, "paged": True}, ValueError, "greedy-only"),
    ({"speculative": "draft"}, ValueError, "draft_model"),
    ({"speculative": "beam"}, ValueError, "beam")])
def test_spec_options_raise(models, kw, exc, match):
    args = dict(ENGINE_KW)
    args.update(kw)
    with pytest.raises(exc, match=match):
        ContinuousBatchingEngine(models[1], device="cpu", **args)
