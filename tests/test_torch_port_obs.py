"""paddle_tpu_torch.obs and distributed.resilience against paddle_tpu's.

The metrics registry renders the same text, byte for byte, as
paddle_tpu.obs.metrics for the same operations; parse_text, the
percentile estimators, samples_to_hist and render_tier give equal
results; modeled_tick_bytes prices the same bytes as paddle_tpu's
analytic formulas at gpt_tiny, gpt_125m and llama_13b; the tracer, the
flight recorder and the fault injector keep paddle_tpu's contracts
(tests/test_obs.py, tests/test_serve.py), and the engine's
instrumentation too: phase spans by request id that add up to the
engine's end-to-end time, nothing recorded with obs off, a constant
program count under shape drift.
"""
import json
import os
import time

import numpy as np
import pytest

from paddle_tpu.analysis import hlo_cost
from paddle_tpu.distributed import resilience as jresil
from paddle_tpu.models import gpt_125m as jax_gpt_125m
from paddle_tpu.models import llama_13b as jax_llama_13b
from paddle_tpu.obs import efficiency as jeff
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu_torch import obs
from paddle_tpu_torch.distributed import resilience as resil
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.obs import efficiency as eff
from paddle_tpu_torch.obs import metrics

ENGINE_KW = dict(slots=2, max_len=48, cache_dtype="float32",
                 prefill_buckets=(8, 16), tick_tokens=2, device="cpu")


def _ops(mod):
    """One sequence of registry operations through ``mod`` (either
    package's metrics module): counters with and without labels, a folded
    label set, gauges, histograms on default and given buckets, label
    values that need escaping, a removed series."""
    reg = mod.Registry()
    c = reg.counter("ptpu_ut_total", "requests \"served\"", labels=("k",),
                    max_series=3)
    for i, k in enumerate(["a", "b", "a", "c", "d", "e", 'q"uo\\te\n']):
        c.inc(i + 0.5, k=k)
    reg.counter("ptpu_plain_total").inc()
    g = reg.gauge("ptpu_ut_gauge", "a gauge", labels=("replica",))
    g.set(7.5, replica="r1")
    g.set(-3, replica="r2")
    g.inc(2.25, replica="r1")
    g.remove(replica="r2")
    reg.gauge("ptpu_big_gauge").set(123456789.0)
    h = reg.histogram("ptpu_ut_ms", "latency", buckets=(1, 10, 100))
    d = reg.histogram("ptpu_default_ms")
    rs = np.random.RandomState(0)
    for v in rs.exponential(40.0, 200):
        h.observe(float(v))
        d.observe(float(v) * 3)
    hl = reg.histogram("ptpu_lab_ms", labels=("phase",), buckets=(0.5, 2))
    hl.observe(0.1, phase="prefill")
    hl.observe(3, phase="decode")
    return reg


def test_render_is_byte_identical_to_reference():
    mine, ref = _ops(metrics).render(), _ops(jmetrics).render()
    assert mine == ref
    assert "_other" in mine and 'k="q\\"uo\\\\te\\n"' not in mine
    assert _ops(metrics).seq() == _ops(jmetrics).seq()


def test_parse_text_round_trips_and_matches_reference():
    text = _ops(metrics).render()
    got = metrics.parse_text(text)
    assert got == jmetrics.parse_text(text)
    d = {(n, tuple(sorted(l.items()))): v for n, l, v in got}
    assert d[("ptpu_ut_gauge", (("replica", "r1"),))] == 9.75
    assert d[("ptpu_ut_ms_bucket", (("le", "+Inf"),))] == 200.0
    # re-rendering the parsed samples through a registry gives them back
    reg = metrics.Registry()
    for n, labels, v in got:
        if n.startswith("ptpu_ut_total"):
            reg.counter(n, labels=tuple(labels)).inc(v, **labels)
    again = {(n, tuple(sorted(l.items()))): v
             for n, l, v in metrics.parse_text(reg.render())}
    assert again == {k: v for k, v in d.items()
                     if k[0].startswith("ptpu_ut_total")}


@pytest.mark.parametrize("q", [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_percentiles_match_reference(q):
    mine, ref = _ops(metrics), _ops(jmetrics)
    for name in ("ptpu_ut_ms", "ptpu_default_ms"):
        a, b = mine.get(name).snap(), ref.get(name).snap()
        assert a.percentile(q) == b.percentile(q)
        assert a.minus(a).count == 0
    text = mine.render()
    for name in ("ptpu_ut_ms", "ptpu_default_ms"):
        got = metrics.samples_to_hist(metrics.parse_text(text), name)
        want = jmetrics.samples_to_hist(jmetrics.parse_text(text), name)
        assert got == want
        assert (metrics.percentile_from_cum(*got, q)
                == jmetrics.percentile_from_cum(*want, q))


def test_render_tier_matches_reference():
    rep = _ops(metrics).render()
    other = ("# TYPE ptpu_x_total counter\nptpu_x_total 3\n"
             'ptpu_h_ms_bucket{le="10"} 2\nptpu_h_ms_bucket{le="+Inf"} 4\n')
    args = ("ptpu_router_forwards_total 9\n", {"r1": rep, "r2": other})
    assert metrics.render_tier(*args) == jmetrics.render_tier(*args)
    d = {(n, tuple(sorted(l.items()))): v for n, l, v in
         metrics.parse_text(metrics.render_tier(*args))}
    assert d[("ptpu_tier_x_total", ())] == 3.0


def test_registry_contracts():
    """tests/test_obs.py's registry units: same-name families, kind
    mismatch, the write-only overflow fold, label validation, seq."""
    reg = metrics.Registry()
    c = reg.counter("ptpu_bound_total", labels=("replica",), max_series=3)
    assert reg.counter("ptpu_bound_total", labels=("replica",)) is c
    with pytest.raises(TypeError):
        reg.gauge("ptpu_bound_total")
    s0 = reg.seq()
    for i in range(10):
        c.inc(replica=f"r{i}")
    assert reg.seq() == s0 + 10
    assert c.series()[(metrics.OVERFLOW_LABEL,)][0] == 7.0
    assert c.value(replica="never_written") == 0.0
    with pytest.raises(ValueError):
        c.inc(shard="x")


@pytest.mark.parametrize("kind", ["decode", "decode_paged", "verify"])
@pytest.mark.parametrize("cfg", ["gpt_tiny", "gpt_125m", "llama_13b"])
def test_modeled_tick_bytes_match_reference(kind, cfg):
    """Geometry from each config at serving shapes (8 slots, the
    config's max length, tick 8, 16-token pages; bf16 weights and
    cache), priced by both packages."""
    c = {"gpt_tiny": gpt_tiny(), "gpt_125m": jax_gpt_125m(),
         "llama_13b": jax_llama_13b()}[cfg]
    L, H = c.num_layers, c.hidden_size
    nkv = getattr(c, "num_kv_heads", None) or c.num_heads
    hd = H // c.num_heads
    inter = getattr(c, "intermediate_size", 4 * H)
    params = c.vocab_size * H + L * (4 * H * H + 2 * H * inter)
    kv = 2 * L * 8 * c.max_seq_len * nkv * hd * 2
    geom = {"tick_tokens": 8, "param_bytes": params * 2,
            "kv_cache_bytes": kv, "kv_view_bytes": kv}
    got = eff.modeled_tick_bytes(kind, geom)
    assert got == jeff.modeled_tick_bytes(kind, geom)
    want = {"decode": hlo_cost.analytic_decode_hbm_bytes,
            "decode_paged": hlo_cost.analytic_paged_decode_hbm_bytes,
            "verify": hlo_cost.analytic_verify_hbm_bytes}[kind](geom)
    assert got == want > 0


def test_efficiency_card_table(monkeypatch):
    """The denominator is the H100 SXM alone (no TPU entry); the env knob
    picks by device name and refuses unknown ones."""
    assert list(eff.CHIP_SPECS) == ["NVIDIA H100 80GB HBM3"]
    spec = eff.chip_spec()
    assert (spec.hbm_bandwidth, spec.peak_flops) == (3.35e12, 989e12)
    monkeypatch.setenv("PADDLE_TPU_EFF_CHIP", "v5lite")
    with pytest.raises(KeyError, match="PADDLE_TPU_EFF_CHIP"):
        eff.chip_spec()
    assert eff.mfu(eff.train_step_flops(10, 100), 1e-9, spec) == \
        pytest.approx(6000 / (1e-9 * 989e12))
    assert eff.model_bandwidth_eff(3.35e12, 2.0, spec) == 0.5
    import torch
    t = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
         "b": [torch.zeros(5), np.zeros(2, np.int8)]}
    assert eff.tree_nbytes(t) == 24 + 20 + 2
    assert eff.tree_nelems(t) == 19


def test_span_ring_and_disabled_fast_path():
    before = obs.recorder.appended
    with obs.span("ut.scope", cat="ut", request_id="ut-rid-1"):
        pass
    obs.record_span("ut.raw", 1.0, 1.001, cat="ut")
    assert obs.recorder.appended == before + 2
    ev = obs.recorder.events()[-2]
    assert ev["name"] == "ut.scope" and ev["ph"] == "X"
    assert ev["args"]["request_id"] == "ut-rid-1"
    assert obs.recorder.size >= 16
    obs.set_enabled(False)
    try:
        assert obs.span("a", request_id="x") is obs.span("b")
        before = obs.recorder.appended
        with obs.span("ut.off"):
            pass
        assert obs.recorder.appended == before
    finally:
        obs.set_enabled(None)


def test_flight_dump_export_and_capture(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_OBS_DIR", str(tmp_path))
    tok = obs.trace.begin_span("ut.open", cat="ut", request_id="ut-open")
    path = obs.dump_flight("ut_reason", extra={"why": "test"})
    obs.trace.end_span(tok)
    doc = json.load(open(path))
    assert os.path.basename(path).startswith("flight_ut_reason_")
    assert "ut-open" in doc["metadata"]["request_ids_in_flight"]
    assert doc["metadata"]["why"] == "test"
    t0 = time.perf_counter()
    cap = obs.trace.capture(0.05, jax_profile=True)
    assert time.perf_counter() - t0 >= 0.05
    prof = cap["metadata"]["torch_profile_dir"]
    assert prof.startswith(str(tmp_path)) and "torch_profile_error" not in \
        cap["metadata"]
    assert json.load(open(os.path.join(prof, "trace.json")))["traceEvents"]
    assert obs.trace.capture(0)["metadata"]["clock"] == "perf_counter_us"


def test_lock_factories_and_sanitizer_not_ported(monkeypatch):
    import threading
    assert isinstance(obs.make_lock("x"), type(threading.Lock()))
    assert isinstance(obs.make_condition("x"), threading.Condition)
    assert not obs.lock_san_enabled()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        obs.set_lock_san(True)
    monkeypatch.setenv("PADDLE_TPU_LOCK_SAN", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        obs.make_rlock("x")


def test_fault_injection_matches_reference():
    spec = "serve_backend:2, replica_stall ,serve_hang:3"
    assert resil._parse_spec(spec) == jresil._parse_spec(spec)
    assert resil._KNOWN_SITES == jresil._KNOWN_SITES
    for mod in (resil, jresil):
        with pytest.raises(ValueError, match="unknown fault-injection"):
            mod._parse_spec("replica_stal")
    with resil.FaultInjector({"serve_backend": 2}):
        for _ in range(2):
            with pytest.raises(resil.FaultInjected):
                resil.maybe_inject("serve_backend")
        resil.maybe_inject("serve_backend")          # spent
    with resil.FaultInjector("serve_hang", wedge_s=0.05):
        assert resil.wedge_seconds() == 0.05
        t0 = time.monotonic()
        resil.maybe_inject("serve_hang")
        assert time.monotonic() - t0 >= 0.05
    with resil.FaultInjector({"serve_backend": 1}):
        pass
    assert not resil.should_fire("serve_backend")   # disarmed on exit


@pytest.fixture(scope="module")
def model():
    return GPTForCausalLM(gpt_tiny(), device="cpu", seed=3)


def _spans(rid):
    return {e["name"]: e for e in obs.recorder.events()
            if e.get("args", {}).get("request_id") == rid}


def test_phase_spans_by_request_id_sum_to_engine_e2e(model):
    """queue wait, prefill and decode are contiguous submit -> retire:
    their sum sits within 10 % of the blocking call's latency, in order;
    an engine.tick span per tick; an id is minted when none is given."""
    eng = ContinuousBatchingEngine(model, **ENGINE_KW)
    try:
        eng.generate([1, 2, 3], 2, timeout=60)       # first use
        rid = "obs-direct-e2e"
        ticks0 = sum(e["name"] == "engine.tick"
                     for e in obs.recorder.events())
        t0 = time.perf_counter()
        eng.submit([2, 3, 4], 24, request_id=rid).result(timeout=60)
        e2e_ms = (time.perf_counter() - t0) * 1e3
        spans = _spans(rid)
        qw, pf, dec = (spans[n] for n in ("engine.queue_wait",
                                          "engine.prefill", "engine.decode"))
        phase_ms = (qw["dur"] + pf["dur"] + dec["dur"]) / 1e3
        assert 0.9 * e2e_ms <= phase_ms <= e2e_ms, (phase_ms, e2e_ms)
        assert qw["ts"] <= pf["ts"] <= dec["ts"]
        assert pf["args"]["bucket"] == 8 and dec["args"]["tokens"] == 24
        assert sum(e["name"] == "engine.tick"
                   for e in obs.recorder.events()) - ticks0 == 12
        fut = eng.submit([5, 6], 2)
        fut.result(timeout=60)
        assert len(obs.recorder.request_ids(obs.recorder.events()[-6:])) >= 1
        assert eng.stats()["tick_model_eff"] > 0
    finally:
        eng.stop()


def test_engine_with_obs_off_records_nothing(model):
    """The flag is read at construction: off, a whole submit -> decode ->
    retire cycle touches neither the ring nor the engine's series."""
    obs.set_enabled(False)
    try:
        eng = ContinuousBatchingEngine(model, **ENGINE_KW)
    finally:
        obs.set_enabled(None)
    try:
        fam = obs.metrics.registry.get("ptpu_engine_ticks_total")
        t0 = fam.value() if fam is not None else 0
        before = obs.recorder.appended
        eng.generate([1, 2, 3], 6, timeout=60)
        assert eng.ticks > 0 and obs.recorder.appended == before
        assert not hasattr(eng, "_m_ticks")
        if fam is not None:
            assert fam.value() == t0
        assert eng.stats()["tick_model_eff"] == 0.0
    finally:
        eng.stop()


def test_program_count_constant_under_shape_drift(model):
    """tests/test_engine.py:88: once every bucket and the tick ran, 18
    distinct (prompt length, budget) pairs add no program."""
    eng = ContinuousBatchingEngine(model, **ENGINE_KW)
    try:
        assert eng.compiled_program_count == 0 and not eng.warm
        for p in (4, 12):
            eng.generate(np.arange(1, p + 1), 3, timeout=60)
        warm = eng.compiled_program_count
        assert warm == 3 and eng.warm          # 2 buckets + the tick
        pairs = [(p, n) for p in range(3, 12) for n in (2, 3)]
        futs = [eng.submit(np.arange(i, i + p) % 256, n)
                for i, (p, n) in enumerate(pairs)]
        for f in futs:
            f.result(timeout=60)
        assert eng.compiled_program_count == warm
        assert eng.stats()["compiled_programs"] == warm
    finally:
        eng.stop()
