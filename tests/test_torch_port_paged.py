"""paddle_tpu_torch paged KV cache against paddle_tpu's, on the CPU.

Layers, bottom up:
- ``fused_paged_write`` (B3 paged): the port's plain version against
  paddle_tpu's Pallas kernel in interpret mode. Bit-exact.
- ``_paged_cache_write`` / ``_paged_cache_read``: against paddle_tpu's
  with PADDLE_TPU_FUSED_CACHE_WRITE on (its write then runs the Pallas
  kernel, interpreted). Bit-exact pools and views.
- GPT logits through paged pools with copied weights: prefill, then 4
  decode steps. atol 1e-4, as the slot test (f32 summation order differs
  between XLA:CPU and PyTorch, ~1e-6 per op at these widths).
- The paged engine: greedy tokens identical to paddle_tpu's paged engine
  (fused knob on), to the port's slot engine and to ``generate()``;
  prefix counters and fingerprints equal paddle_tpu's; the write gates,
  page accounting, ``CacheExhausted`` and the HTTP face.
"""
import importlib
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.jit.functional import functional_call, raw_state
from paddle_tpu.kernels.cache_write import \
    fused_paged_write as jax_paged_write
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch.inference import (CacheExhausted,
                                        ContinuousBatchingEngine,
                                        EngineOverloaded, PredictorServer,
                                        RequestCancelled)
from paddle_tpu_torch.kernels import cache_write as cw
from paddle_tpu_torch.models import GPTForCausalLM, generate, gpt_tiny

jfa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")

KNOB = "PADDLE_TPU_FUSED_CACHE_WRITE"
ENGINE_KW = dict(max_len=64, prefill_buckets=(8, 16), tick_tokens=2)
PAGED_KW = dict(paged=True, page_size=8)
# (prompt length, max_new_tokens): both buckets, whole pages, budgets
# ending mid-tick and on a tick boundary, more requests than slots
SHAPES = [(5, 6), (16, 9), (3, 12), (12, 4), (9, 7), (8, 5)]


def _np32(x):
    """numpy of a jax or torch array, floats as f32 (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "int8": torch.int8}


def _pair(a, dtype):
    """The same numpy array as a jax and a torch array of ``dtype``."""
    return (jnp.asarray(a).astype(_JDT[dtype]),
            torch.from_numpy(a.copy()).to(_TDT[dtype]))


# --------------------------------------------------------------- kernel

# rows 0-4 and 11 valid, all to distinct (page, offset) pairs; rows 5 and
# 10 invalid and aimed where valid rows write; rows 6-9 valid but out of
# range (page -1, page NP, offset PS, offset -1)
_PHYS = [0, 2, 5, 1, 1, 2, -1, 6, 3, 4, 0, 4]
_OFF = [0, 3, 1, 2, 0, 3, 0, 0, 4, -1, 0, 2]
_VALID = [1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1]


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8", "scale"])
def test_fused_paged_write_plain_matches_pallas(kind):
    """pool [6, 4, 3, 8] (or the [6, 4, 3] f32 scale plane), 12 rows:
    bit-exact against the Pallas kernel in interpret mode; the CPU path
    launches nothing."""
    NP, PS, n = 6, 4, len(_PHYS)
    inner = (3,) if kind == "scale" else (3, 8)
    rs = np.random.RandomState(11)
    if kind == "int8":
        pool = rs.randint(-127, 128, (NP, PS) + inner).astype(np.int8)
        rows = rs.randint(-127, 128, (n,) + inner).astype(np.int8)
    else:
        pool = rs.randn(NP, PS, *inner).astype(np.float32)
        rows = rs.randn(n, *inner).astype(np.float32)
    dtype = "float32" if kind == "scale" else kind
    jpool, tpool = _pair(pool, dtype)
    jrows, trows = _pair(rows, dtype)
    idx = [np.asarray(a, np.int32) for a in (_PHYS, _OFF, _VALID)]
    want = jax_paged_write(jpool, jrows, *map(jnp.asarray, idx),
                           interpret=True)
    cw.fused_paged_write.launches = 0
    got = cw.fused_paged_write(tpool, trows,
                               *map(torch.from_numpy, idx))
    assert got is tpool and cw.fused_paged_write.launches == 0
    np.testing.assert_array_equal(_np32(got), _np32(want))
    assert not np.array_equal(_np32(got), _np32(jnp.asarray(pool)))


def test_fused_paged_write_plain_keeps_the_last_of_colliding_rows():
    """Colliding valid rows: the plain version keeps the last, as the TPU
    kernel's per-page loop does (a sequential Python reference here)."""
    rs = np.random.RandomState(12)
    pool = rs.randn(5, 4, 2).astype(np.float32)
    rows = rs.randn(9, 2).astype(np.float32)
    phys = np.asarray([1, 3, 1, 1, 0, 3, 4, 2, 1], np.int32)
    off = np.asarray([2, 0, 2, 2, 1, 0, 3, 3, 2], np.int32)
    valid = np.asarray([1, 1, 1, 1, 1, 1, 1, 1, 0], np.int32)
    want = pool.copy()
    for i in range(9):
        if valid[i]:
            want[phys[i], off[i]] = rows[i]
    got = cw.fused_paged_write_plain(torch.from_numpy(pool.copy()),
                                     torch.from_numpy(rows),
                                     *map(torch.from_numpy,
                                          (phys, off, valid)))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------- functionals

NP_F, PS_F, PM_F, NKV, HD = 8, 4, 4, 2, 8
_BT = np.asarray([[3, 1, 6, 0], [5, 2, 7, 4], [0, 0, 0, 0]], np.int32)
# (B, S, pos, live, wlen): a padded admission at a scalar position, an
# S=1 decode at per-row positions with a dead row, a k+1 = 3 verify block,
# and writes running past the table (t >= PM * PS)
_WRITES = {
    "admission": (1, 8, 4, None, 5),
    "decode": (3, 1, [0, 9, 15], [True, False, True], None),
    "verify": (3, 3, [2, 13, 6], [True, True, False], None),
    "past_table": (2, 4, [14, 3], None, None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(_WRITES))
def test_paged_cache_write_and_read_match(monkeypatch, case, dtype):
    monkeypatch.setenv(KNOB, "1")
    B, S, pos, live, wlen = _WRITES[case]
    rs = np.random.RandomState(13)
    rows = rs.randn(B, S, NKV, HD).astype(np.float32)
    shape = (NP_F, PS_F, NKV, HD)
    if dtype == "int8":
        pool = {"pages": rs.randint(-127, 128, shape).astype(np.int8),
                "scale": (np.abs(rs.randn(*shape[:3])) * 0.02).astype(
                    np.float32)}
    else:
        pool = {"pages": rs.randn(*shape).astype(np.float32)}
    jc = {k: _pair(a, "float32" if k == "scale" else dtype)[0]
          for k, a in pool.items()}
    tc = {k: _pair(a, "float32" if k == "scale" else dtype)[1]
          for k, a in pool.items()}
    bt = _BT[:B]
    jc["bt"], tc["bt"] = jnp.asarray(bt), torch.from_numpy(bt)
    if live is not None:
        jc["live"] = jnp.asarray(live)
        tc["live"] = torch.tensor(live)
    if wlen is not None:
        jc["wlen"], tc["wlen"] = jnp.int32(wlen), wlen
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = (torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list)
            else pos)

    @jax.jit
    def jwrite(cache, rows, pos):
        cache = jfa._paged_cache_write(cache, rows, pos)
        return cache, jfa._paged_cache_read(cache)

    jout, jview = jwrite(jc, jnp.asarray(rows), jpos)
    tout = tfa._paged_cache_write(tc, torch.from_numpy(rows), tpos)
    assert tout is tc
    tview = tfa._paged_cache_read(tc)
    for k in pool:
        np.testing.assert_array_equal(_np32(tc[k]), _np32(jout[k]))
    assert tview.dtype == (torch.float32 if dtype == "int8"
                           else _TDT[dtype])
    np.testing.assert_array_equal(_np32(tview), _np32(jview))


def test_paged_kv_cache_is_zeroed():
    """Pools start at zero (never torch.empty): page 0, which every
    unallocated table entry reads, must hold finite values."""
    for dt in ("int8", torch.bfloat16):
        pool = tfa.paged_kv_cache(3, 4, 2, 8, dt, "cpu")
        assert all(not t.any() for t in pool.values())
    assert set(tfa.paged_kv_cache(3, 4, 2, 8, "int8", "cpu")) == {
        "pages", "scale"}


# ------------------------------------------------------------ GPT model

@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    load_paddle_tpu_params(tm, {n: np.asarray(v)
                                for n, v in raw_state(jm)[0].items()})
    return jm, tm


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_gpt_logits_through_paged_pools_match(models, monkeypatch,
                                              cache_dtype):
    """Prefill 7 tokens at position 0 into scattered pages, then 4 decode
    steps at per-row positions with the live gate attached."""
    monkeypatch.setenv(KNOB, "1")
    jm, tm = models
    B, P, NP, PS = 2, 7, 10, 4
    bt = np.asarray([[3, 7, 1, 0], [5, 2, 8, 9]], np.int32)
    ids = np.random.RandomState(1).randint(0, 256, (B, P)).astype(np.int64)
    jparams, jbuf = raw_state(jm)

    @jax.jit
    def jprog(x, caches, pos):
        return functional_call(jm, jparams, jbuf, x, caches, pos,
                               training=False)[0]

    def jstep(x, caches, pos, live=None):
        meta = {"bt": jnp.asarray(bt)}
        if live is not None:
            meta["live"] = jnp.asarray(live)
        caches = [({**k, **meta}, {**v, **meta}) for k, v in caches]
        logits, caches = jprog(jnp.asarray(x), caches, pos)
        return np.asarray(logits), [
            tuple({n: a for n, a in c.items() if n in ("pages", "scale")}
                  for c in kv) for kv in caches]

    def tstep(x, caches, pos, live=None):
        for kv in caches:
            for c in kv:
                c["bt"] = torch.from_numpy(bt)
                if live is not None:
                    c["live"] = torch.from_numpy(live)
        with torch.no_grad():
            logits, caches = tm(torch.from_numpy(x), caches, pos)
        for kv in caches:
            for c in kv:
                c.pop("bt")
                c.pop("live", None)
        return logits.numpy(), caches

    jc = jm.new_paged_cache(NP, PS, cache_dtype)
    tc = tm.new_paged_cache(NP, PS, cache_dtype)
    jl, jc = jstep(ids, jc, jnp.int32(0))
    tl, tc = tstep(ids, tc, 0)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    tok = np.argmax(jl[:, -1], -1)
    live = np.asarray([True, True])
    for i in range(4):
        pos = np.full(B, P + i, np.int32)
        x = tok[:, None].astype(np.int64)
        jl, jc = jstep(x, jc, jnp.asarray(pos), live)
        tl, tc = tstep(x, tc, torch.from_numpy(pos), live)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        tok = np.argmax(jl[:, -1], -1)
    leaf = "scale" if cache_dtype == "int8" else "pages"
    np.testing.assert_allclose(_np32(tc[0][0][leaf]), _np32(jc[0][0][leaf]),
                               rtol=0, atol=1e-5)


# --------------------------------------------------------------- engine

def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n,)).astype(
        np.int64)


def _serve_staggered(eng, prompts, shapes, eos=None):
    """Submit with staggered arrivals; ``eos`` maps a request's index to
    its eos token."""
    futs = []
    for i, (ids, (_, n)) in enumerate(zip(prompts, shapes)):
        futs.append(eng.submit(ids, max_new_tokens=n,
                               eos_token_id=(eos or {}).get(i)))
        time.sleep(0.01)          # arrivals land across tick boundaries
    return [f.result(timeout=300) for f in futs]


def _wait_idle(eng):
    deadline = time.time() + 60
    while eng.stats()["active"] and time.time() < deadline:
        time.sleep(0.01)
    assert eng.stats()["active"] == 0


@pytest.fixture(scope="module")
def paged_engine(models):
    eng = ContinuousBatchingEngine(models[1], slots=3, cache_dtype="float32",
                                   device="cpu", **ENGINE_KW, **PAGED_KW)
    yield eng
    eng.stop()


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_paged_engine_matches_jax_paged_and_slot_engines(
        models, monkeypatch, cache_dtype):
    """Staggered mixed-length traffic, shared prefixes included (the
    last 16-token prompt repeats an earlier one: a COW admission), and a
    request that ends on eos mid-tick."""
    monkeypatch.setenv(KNOB, "1")
    jm, tm = models
    prompts = [_prompt(i, p) for i, (p, _) in enumerate(SHAPES)]
    prompts.append(prompts[1].copy())
    shapes = SHAPES + [(16, 6)]
    # request 2 stops at its third token
    eos = {2: int(generate(tm, prompts[2], 3, cache_dtype=cache_dtype)[0,
                                                                      -1])}
    jeng = JaxEngine(jm, slots=3, cache_dtype=cache_dtype, **ENGINE_KW,
                     **PAGED_KW)
    try:
        want = _serve_staggered(jeng, prompts, shapes, eos)
    finally:
        jeng.stop()
    outs = {}
    for name, kw in (("paged", PAGED_KW), ("slot", {})):
        eng = ContinuousBatchingEngine(tm, slots=3, cache_dtype=cache_dtype,
                                       device="cpu", **ENGINE_KW, **kw)
        try:
            outs[name] = _serve_staggered(eng, prompts, shapes, eos)
            _wait_idle(eng)
            st = eng.stats()
        finally:
            eng.stop()
        assert st["admitted"] == st["completed"] == len(prompts)
    assert set(st["kernel_launches"]) == {"mega_decode_step",
                                          "kv_slot_write"}
    for i, (ids, (p, n), w, g, s) in enumerate(zip(
            prompts, shapes, want, outs["paged"], outs["slot"])):
        assert g.shape == (p + n,)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(s, w)
        np.testing.assert_array_equal(
            g, generate(tm, ids, n, cache_dtype=cache_dtype,
                        eos_token_id=eos.get(i))[0])
    # prompt 3 tokens, eos at the third new token, then eos padding
    assert (want[2][5:] == eos[2]).all() and (want[2][3:5] != eos[2]).all()


def test_paged_eos_retires_and_pads(models, paged_engine):
    _, tm = models
    ids = _prompt(0, 6)
    eos = int(generate(tm, ids, 3, cache_dtype="float32")[0, -1])
    out = paged_engine.generate(ids, max_new_tokens=10, eos_token_id=eos,
                                timeout=60)
    np.testing.assert_array_equal(
        out, generate(tm, ids, 10, cache_dtype="float32",
                      eos_token_id=eos)[0])
    assert out[-1] == eos


_COUNTERS = ("prefix_hits", "prefix_misses", "prefix_tokens_saved",
             "prefill_tokens", "pages_used", "pages_free",
             "pages_cached_prefix")


def _sequential(eng, reqs):
    """Serve ``reqs`` one at a time; returns (outputs, stats after each)."""
    outs, stats = [], []
    for ids, n in reqs:
        outs.append(eng.generate(ids, max_new_tokens=n, timeout=300))
        _wait_idle(eng)
        stats.append(eng.stats())
    return outs, stats


@pytest.mark.parametrize("pool", ["roomy", "small"])
def test_prefix_sharing_cow_and_eviction_match_jax(models, monkeypatch,
                                                   pool):
    """One request at a time: a 16-token prompt (miss), the same prompt
    (every page matched: COW of the tail page, one token prefilled), a
    partial hit (its first page), and fresh prompts. With an 8-page pool
    (one max_len request) the fifth request must evict trie pages.
    Tokens, prefix counters and fingerprints equal paddle_tpu's after
    every request."""
    monkeypatch.setenv(KNOB, "1")
    jm, tm = models
    p16 = _prompt(50, 16)
    reqs = [(p16, 6), (p16, 6), (np.concatenate([p16[:8], _prompt(51, 5)]), 5),
            (_prompt(52, 16), 9), (_prompt(53, 16), 20), (p16, 4)]
    kw = dict(slots=2, cache_dtype="float32", **ENGINE_KW, **PAGED_KW)
    if pool == "small":
        kw["num_pages"] = 8
    jeng = JaxEngine(jm, **kw)
    try:
        want, jstats = _sequential(jeng, reqs)
        jeng._allocator.check()
    finally:
        jeng.stop()
    teng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    try:
        got, tstats = _sequential(teng, reqs)
        teng._allocator.check()
    finally:
        teng.stop()
    for (ids, n), g, w in zip(reqs, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, generate(tm, ids, n, cache_dtype="float32")[0])
    for ts, js in zip(tstats, jstats):
        assert {k: ts[k] for k in _COUNTERS} == {k: js[k] for k in _COUNTERS}
        assert sorted(ts["prefix_fingerprints"]) == sorted(
            js["prefix_fingerprints"])
    # the COW admission prefilled exactly one token and saved 15
    assert tstats[1]["prefill_tokens"] - tstats[0]["prefill_tokens"] == 1
    assert (tstats[1]["prefix_tokens_saved"]
            - tstats[0]["prefix_tokens_saved"]) == 15
    if pool == "small":
        # the 5-page request found 4 pages free beside the trie's 4: it
        # evicted one before caching its own 2
        assert tstats[3]["pages_cached_prefix"] == 4
        assert tstats[4]["pages_cached_prefix"] == 5


def test_dead_slot_and_padded_admission_leave_page_zero_alone(models):
    """Page 0 holds the first request's complete prompt page (trie-shared,
    never written again). A padded admission whose bucket runs past its
    pages onto table entries that read 0, and dead slots whose zeroed
    table rows read 0, tick beside it: page 0 stays bit-unchanged in
    every layer, and every output equals generate()."""
    _, tm = models
    eng = ContinuousBatchingEngine(tm, slots=3, max_len=64,
                                   prefill_buckets=(8, 16, 32),
                                   tick_tokens=2, cache_dtype="float32",
                                   device="cpu", **PAGED_KW)
    try:
        a_ids = _prompt(60, 8)
        seen = threading.Event()

        def cb_wait():
            while len(eng._slots[0].emitted) < 3:
                time.sleep(0.001)
            seen.set()
        fa = eng.submit(a_ids, max_new_tokens=40)
        threading.Thread(target=cb_wait, daemon=True).start()
        assert seen.wait(timeout=60)
        assert eng._slots[0].pages[0] == 0
        page0 = [c["pages"][0].clone() for kv in eng._caches for c in kv]
        # 17 tokens -> bucket 32; 1 new token + overshoot 2 -> 3 pages,
        # so bucket rows 24..31 fall on table entries that read page 0
        b_ids = _prompt(61, 17)
        fb = eng.submit(b_ids, max_new_tokens=1)
        fc = eng.submit(_prompt(62, 5), max_new_tokens=3)
        outs = [f.result(timeout=120) for f in (fa, fb, fc)]
        after = [c["pages"][0] for kv in eng._caches for c in kv]
    finally:
        eng.stop()
    for before, now in zip(page0, after):
        assert torch.equal(before, now)
    for ids, n, out in zip((a_ids, b_ids, _prompt(62, 5)), (40, 1, 3), outs):
        np.testing.assert_array_equal(
            out, generate(tm, ids, n, cache_dtype="float32")[0])


def test_no_page_leak_after_churn_and_cancel(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, slots=3, cache_dtype="float32",
                                   device="cpu", max_queue=64, **ENGINE_KW,
                                   **PAGED_KW)
    rs = np.random.RandomState(3)
    try:
        shared = _prompt(77, 8)
        futs = []
        for i in range(14):
            if rs.rand() < 0.4:
                ids = np.concatenate([shared, _prompt(100 + i,
                                                      rs.randint(1, 6))])
            else:
                ids = _prompt(200 + i, rs.randint(3, 17))
            futs.append(eng.submit(ids, max_new_tokens=int(rs.randint(2, 8)),
                                   request_id=f"r{i}"))
        victim = eng.submit(shared, max_new_tokens=40, request_id="victim")
        while len(eng.stats()["prefix_fingerprints"]) == 0:
            time.sleep(0.001)
        assert eng.cancel("victim")
        with pytest.raises(RequestCancelled):
            victim.result(timeout=120)
        for f in futs:
            f.result(timeout=120)
        _wait_idle(eng)
        st = eng.stats()
        assert st["pages_used"] == st["pages_cached_prefix"]
        assert st["cancelled"] == 1 and st["completed"] == 14
        eng._allocator.check()
        eng._trie.evict_all()
        assert eng._allocator.used_pages == 0
        eng._allocator.check()
        assert not eng._block_tables.any()
    finally:
        eng.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, payload):
    """(status, headers, body) of a JSON POST."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_paged_submit_validation_and_cache_exhausted(models):
    """A request whose view cannot fit is rejected outright; when the
    queue is full while the page pool binds, submit raises the typed
    CacheExhausted and HTTP answers 503 cache_exhausted with Retry-After.
    Queued requests still complete."""
    _, tm = models
    eng = ContinuousBatchingEngine(tm, slots=4, max_len=32,
                                   cache_dtype="float32",
                                   prefill_buckets=(8, 16), tick_tokens=4,
                                   num_pages=4, max_queue=2,
                                   prefix_cache=False, device="cpu",
                                   **PAGED_KW)
    gate = threading.Event()
    tick = eng._tick

    def gated_tick():             # hold the loop after the first admission
        gate.wait(timeout=60)
        tick()
    eng._tick = gated_tick
    srv = PredictorServer(engine=eng, host="127.0.0.1", port=0).start()
    try:
        with pytest.raises(ValueError, match="overshoot"):
            eng.submit(_prompt(0, 16), max_new_tokens=13)
        # each request needs 3 of the 4 pages: the first is admitted, the
        # next two queue behind the pool with slots free
        futs = [eng.submit(_prompt(0, 8), max_new_tokens=12)]
        while eng.stats()["active"] == 0:
            time.sleep(0.001)
        futs += [eng.submit(_prompt(i, 8), max_new_tokens=12)
                 for i in (1, 2)]
        with pytest.raises(CacheExhausted) as ce:
            eng.submit(_prompt(9, 8), max_new_tokens=12)
        assert isinstance(ce.value, EngineOverloaded)
        assert ce.value.reason == "cache_exhausted"
        assert (ce.value.free_pages, ce.value.num_pages) == (1, 4)
        code, headers, body = _post(
            f"http://{srv.host}:{srv.port}/generate",
            {"input_ids": _prompt(10, 8).tolist(), "max_new_tokens": 12})
        assert code == 503 and body["error"] == "cache_exhausted", body
        assert headers["Retry-After"] == "2" and body["retry_after_s"] == 2.0
        assert (body["free_pages"], body["num_pages"]) == (1, 4)
        gate.set()
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(
                f.result(timeout=120),
                generate(tm, _prompt(i, 8), 12, cache_dtype="float32")[0])
    finally:
        gate.set()
        srv.stop()
        eng.stop()


def test_healthz_and_prewarm(models, paged_engine):
    """/prewarm runs one-token admission, so the prompt's complete pages
    land in the prefix cache; /healthz carries the pool fields, and the
    next /generate of that prompt is a prefix hit."""
    _, tm = models
    srv = PredictorServer(engine=paged_engine, host="127.0.0.1",
                          port=0).start()
    url = f"http://{srv.host}:{srv.port}"
    try:
        ids = _prompt(70, 16)
        before = paged_engine.stats()
        code, _, body = _post(url + "/prewarm", {"input_ids": ids.tolist()})
        assert code == 200 and body == {"prewarmed": True, "prompt_len": 16,
                                        "paged": True}
        assert _post(url + "/prewarm", {})[0] == 400
        hz = _get(url + "/healthz")
        e = hz["engine"]
        assert hz["status"] == "ready" and e["paged"] is True
        assert e["pages_total"] == paged_engine.num_pages == 24
        assert e["pages_free"] + e["pages_used"] == e["pages_total"]
        assert e["page_size"] == 8 and 0.0 <= e["page_utilization"] <= 1.0
        fps = set(e["prefix_fingerprints"])
        from paddle_tpu_torch.inference.paging import chain_hashes
        assert set(chain_hashes(ids, 8)) <= fps
        code, _, body = _post(url + "/generate", {"input_ids": ids.tolist(),
                                                  "max_new_tokens": 5})
        assert code == 200
        assert body["tokens"] == generate(tm, ids, 5,
                                          cache_dtype="float32")[0].tolist()
        after = paged_engine.stats()
        assert after["prefix_hits"] == before["prefix_hits"] + 1
        assert after["prefill_tokens"] - before["prefill_tokens"] == 16 + 1
    finally:
        srv.stop()
