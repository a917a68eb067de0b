"""paddle_tpu_torch draft-model speculative decoding against paddle_tpu's.

- The draft engine (``speculative="draft"``, ``DraftModelProposer``) on an
  f32 slot cache and f32 paged pools serves requests one at a time
  beside paddle_tpu's draft engine on the same copied weights: identical
  greedy tokens, and identical ``spec_ticks`` / ``tokens_drafted`` /
  ``tokens_accepted`` after every request, with a draft of the target's
  own weights (full acceptance) and with a differently drawn draft
  (rejections). Both equal the port's sequential ``generate``.
- k = 1 (no single-token draft steps, full acceptance), a prefix-hit
  admission (the target prefills the suffix, the draft the whole
  prompt), an eos inside a verify block, an admission into a slot that
  ran free ticks, ``compiled_program_count`` flat under prompt drift, a
  draft on another device, /healthz's fields, and ``resolve_speculative``
  against paddle_tpu's on every knob.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.inference.engine import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.jit.functional import raw_state
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        PredictorServer)
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.models import GPTForCausalLM, generate, gpt_tiny

KW = dict(slots=2, max_len=64, cache_dtype="float32", prefill_buckets=(16,),
          tick_tokens=4, speculative="draft", spec_k=4)
_SPEC = ("spec_ticks", "tokens_drafted", "tokens_accepted",
         "tokens_rejected", "acceptance_rate", "accepted_tokens_per_tick")
# (prompt seed, prompt length, max_new_tokens), served one at a time; the
# last repeats a 16-token prompt (two complete pages: a paged prefix hit)
REQS = [(0, 6, 12), (1, 11, 8), (2, 16, 8), (2, 16, 6)]


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n,)).astype(np.int64)


def _port_copy(jm, seed):
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=seed)
    return load_paddle_tpu_params(tm, {n: np.asarray(v)
                                       for n, v in raw_state(jm)[0].items()})


@pytest.fixture(scope="module")
def models():
    """(jax target, port target, {"same"/"other": (jax draft, port
    draft)}): the same-weights draft is a second copy of the target."""
    paddle.seed(7)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    paddle.seed(7)
    jsame = JaxGPT(jax_gpt_tiny())
    jsame.eval()
    paddle.seed(99)
    jother = JaxGPT(jax_gpt_tiny())
    jother.eval()
    tm = _port_copy(jm, 1)
    drafts = {"same": (jsame, _port_copy(jsame, 2)),
              "other": (jother, _port_copy(jother, 3))}
    return jm, tm, drafts


def _sequential(eng):
    outs, stats = [], []
    for seed, p, n in REQS:
        outs.append(eng.generate(_prompt(seed, p), max_new_tokens=n,
                                 timeout=300))
        stats.append(eng.stats())
    return outs, stats


@pytest.mark.parametrize("which,paged", [("same", False), ("other", False),
                                         ("same", True), ("other", True)])
def test_draft_engine_matches_jax_engine(models, monkeypatch, which, paged):
    monkeypatch.setenv("PADDLE_TPU_FUSED_CACHE_WRITE", "1")
    jm, tm, drafts = models
    jdraft, tdraft = drafts[which]
    kw = dict(KW, paged=True, page_size=8) if paged else dict(KW)
    jeng = JaxEngine(jm, draft_model=jdraft, **kw)
    try:
        want, jstats = _sequential(jeng)
    finally:
        jeng.stop()
    teng = ContinuousBatchingEngine(tm, draft_model=tdraft, device="cpu",
                                    **kw)
    try:
        got, tstats = _sequential(teng)
    finally:
        teng.stop()
    for (seed, p, n), g, w in zip(REQS, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, generate(tm, _prompt(seed, p), n, cache_dtype="float32")[0])
    for ts, js in zip(tstats, jstats):
        assert {k: ts[k] for k in _SPEC} == {k: js[k] for k in _SPEC}
    st = tstats[-1]
    assert st["speculative"] == "draft" and st["spec_k"] == 4
    # every busy slot drafts k: every tick is a verify tick
    assert st["ticks"] == st["spec_ticks"] > 0
    if which == "same":
        assert st["acceptance_rate"] > 0.9
        assert st["accepted_tokens_per_tick"] > 2.0
    else:
        assert st["tokens_rejected"] > 0
    if paged:
        assert st["prefix_hits"] == tstats[2]["prefix_hits"] + 1


def test_draft_k1_full_acceptance(models):
    """k = 1: the sync block alone drafts (no single-token steps); a
    same-weights draft accepts every proposal."""
    _, tm, drafts = models
    eng = ContinuousBatchingEngine(tm, draft_model=drafts["same"][1],
                                   device="cpu", **dict(KW, spec_k=1))
    try:
        for seed, p, n in REQS[:2]:
            ids = _prompt(seed, p)
            np.testing.assert_array_equal(
                eng.generate(ids, n, timeout=300),
                generate(tm, ids, n, cache_dtype="float32")[0])
        st = eng.stats()
        assert st["acceptance_rate"] == 1.0
        # k + 1 = 2 a tick, less only where a budget ends inside a block
        assert 1.5 < st["accepted_tokens_per_tick"] <= 2.0
    finally:
        eng.stop()


def test_draft_eos_mid_block_and_free_slot_admission(models):
    """An eos inside a verify block truncates and pads as plain decode
    does; a request admitted into a slot that ran free ticks (its draft
    rows written at positions -1..k-1 by the free slot's proposals) gets
    plain decode's tokens."""
    _, tm, drafts = models
    eng = ContinuousBatchingEngine(tm, draft_model=drafts["same"][1],
                                   device="cpu", **KW)
    try:
        ids = _prompt(5, 7)
        eos = int(generate(tm, ids, 8, cache_dtype="float32")[0, 9])
        np.testing.assert_array_equal(
            eng.generate(ids, 12, eos_token_id=eos, timeout=300),
            generate(tm, ids, 12, cache_dtype="float32",
                     eos_token_id=eos)[0])
        long_ids, late_ids = _prompt(6, 5), _prompt(7, 9)
        ticked = threading.Event()
        fut = eng.submit(long_ids, max_new_tokens=40,
                         progress_cb=lambda t: eng.ticks >= 3
                         and ticked.set())
        assert ticked.wait(60)
        late = eng.submit(late_ids, max_new_tokens=10)   # into slot 1
        np.testing.assert_array_equal(
            late.result(timeout=300),
            generate(tm, late_ids, 10, cache_dtype="float32")[0])
        np.testing.assert_array_equal(
            fut.result(timeout=300),
            generate(tm, long_ids, 40, cache_dtype="float32")[0])
    finally:
        eng.stop()


def test_draft_compiled_program_count_flat_under_drift(models):
    _, tm, drafts = models
    eng = ContinuousBatchingEngine(tm, draft_model=drafts["other"][1],
                                   device="cpu", **KW)
    try:
        assert eng.warmup() == [16]
        warm = eng.compiled_program_count
        futs = [eng.submit(_prompt(30 + i, 3 + 3 * i), max_new_tokens=5)
                for i in range(4)]
        for f in futs:
            f.result(timeout=300)
        assert eng.compiled_program_count == warm
    finally:
        eng.stop()


def test_draft_on_another_device_raises(models):
    _, tm, _ = models
    draft = GPTForCausalLM(gpt_tiny(), device="cpu", seed=0).to("meta")
    with pytest.raises(ValueError, match="draft model lives on"):
        ContinuousBatchingEngine(tm, draft_model=draft, device="cpu", **KW)


def test_draft_healthz(models):
    _, tm, drafts = models
    eng = ContinuousBatchingEngine(tm, draft_model=drafts["same"][1],
                                   device="cpu", **KW)
    srv = PredictorServer(engine=eng, host="127.0.0.1", port=0).start()
    try:
        ids = _prompt(8, 6)
        req = urllib.request.Request(
            f"http://{srv.host}:{srv.port}/generate", data=json.dumps(
                {"input_ids": ids.tolist(), "max_new_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["tokens"] == generate(tm, ids, 8,
                                          cache_dtype="float32")[0].tolist()
        assert body["tokens_drafted"] >= body["tokens_accepted"] > 0
        with urllib.request.urlopen(f"http://{srv.host}:{srv.port}/healthz",
                                    timeout=60) as r:
            e = json.loads(r.read())["engine"]
        assert e["speculative"] == "draft" and e["spec_k"] == 4
        st = eng.stats()
        assert {k: e[k] for k in _SPEC} == {k: st[k] for k in _SPEC}
    finally:
        srv.stop()
        eng.stop()


def _resolved(mod, *args, **kw):
    """``resolve_speculative``'s result as comparable fields, or the
    exception type it raised."""
    try:
        cfg = mod.resolve_speculative(*args, **kw)
    except (ValueError, NotImplementedError) as e:
        return type(e)
    if cfg is None:
        return None
    return (cfg.kind, cfg.k, cfg.ngram_max, cfg.ngram_min,
            cfg.draft_model is not None)


_DRAFT = object()


@pytest.mark.parametrize("env,args,kw", [
    ({}, (None,), {}), ({}, (False,), {}), ({}, ("off",), {}),
    ({}, (True,), {"spec_k": 6, "spec_ngram": 2}),
    ({}, ("NGRAM",), {}), ({}, ("draft",), {}),
    ({}, ("draft",), {"draft_model": _DRAFT, "spec_k": 2}),
    ({}, ("ngram",), {"draft_model": _DRAFT}),
    ({}, (None,), {"draft_model": _DRAFT}),
    ({}, ("beam",), {}), ({}, (True,), {"spec_k": 0}),
    ({}, (True,), {"spec_ngram": 0}),
    ({"PADDLE_TPU_SERVE_SPEC": "draft"}, (None,), {"draft_model": _DRAFT}),
    ({"PADDLE_TPU_SERVE_SPEC": "draft"}, (None,), {}),
    ({"PADDLE_TPU_SERVE_SPEC": "ngram", "PADDLE_TPU_SERVE_SPEC_K": "3",
      "PADDLE_TPU_SERVE_SPEC_NGRAM": "5"}, (None,), {})])
def test_resolve_speculative_matches_reference(monkeypatch, env, args, kw):
    for name in ("PADDLE_TPU_SERVE_SPEC", "PADDLE_TPU_SERVE_SPEC_K",
                 "PADDLE_TPU_SERVE_SPEC_NGRAM"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert _resolved(tspec, *args, **kw) == _resolved(jspec, *args, **kw)


def test_unknown_mode_message_lists_draft():
    with pytest.raises(ValueError, match="'draft'"):
        tspec.resolve_speculative("beam")


def test_insert_row_finds_the_slot_axis():
    """Per-layer [N, ...] leaves take the row on axis 0, scan-stacked [L,
    N, ...] ones on axis 1, as paddle_tpu's insert."""
    caches = [(torch.zeros(3, 4, 2), {"data": torch.zeros(3, 4, 2)})]
    row = [(torch.ones(1, 4, 2), {"data": torch.full((1, 4, 2), 2.0)})]
    tspec.insert_row(caches, row, 1)
    assert caches[0][0][1].eq(1).all() and caches[0][0][[0, 2]].eq(0).all()
    assert caches[0][1]["data"][1].eq(2).all()
    stacked = (torch.zeros(2, 3, 4), torch.zeros(2, 3, 4))
    tspec.insert_row(stacked, (torch.ones(2, 1, 4), torch.ones(2, 1, 4)), 2)
    assert stacked[0][:, 2].eq(1).all() and stacked[0][:, :2].eq(0).all()
