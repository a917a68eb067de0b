"""paddle_tpu_torch sampling (``generation._select_token``, sampled
``generate``, the sampling engine and ``/generate``'s seed) against
paddle_tpu's, on the CPU.

The port keeps paddle_tpu's filter (temperature, top-k, top-p) exactly and
draws by Gumbel-max as ``jax.random.categorical`` does, but its random
bits come from its own counter-based hash, not from threefry: the same
seed gives other tokens than paddle_tpu. So the draws are compared as
distributions, and the filter as a set:

- the port's filtered support (the tokens left above -1e30) equals the
  tokens paddle_tpu's ``_select_token`` can draw (the logits it hands to
  ``jax.random.categorical``, captured), and the kept logits agree (atol
  1e-6: the same f32 division);
- 4,000 port draws and 4,000 paddle_tpu draws from the same logits each
  pass a chi-square test against the port's renormalised probabilities
  (fixed seeds; p > 1e-3, bins with fewer than 5 expected draws merged);
- a draw depends on (seed, position) alone: the engine's sampled tokens
  equal the sequential ``generate()``'s with the request's seed, whatever
  the slot, the tick composition or the other requests.
"""
import inspect
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from paddle_tpu.inference.engine import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import generation as jgen
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        PredictorServer)
from paddle_tpu_torch.models import LlamaForCausalLM, generate, llama_tiny
from paddle_tpu_torch.models import generation as tgen

ENGINE_KW = dict(max_len=64, prefill_buckets=(8, 16), tick_tokens=2,
                 cache_dtype="float32")
SAMPLE = dict(do_sample=True, temperature=0.9, top_k=40, top_p=0.95)
# (temperature, top_k, top_p): each knob alone, then all together
KNOBS = [(0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.8), (0.6, 9, 0.9),
         (1.0, 300, 1.0)]
N_DRAWS = 4000


def _logits(B=3, V=64, seed=0):
    """Rows of O(1) logits with ties, a dominant row and a flat row."""
    rs = np.random.RandomState(seed)
    lg = rs.randn(B, V).astype(np.float32) * 2
    lg[0, :8] = lg[0].max()                      # an 8-way tie at the top
    if B == 3:
        lg[1, 3] = 9.0                           # one token holds most mass
        lg[2] = 0.25                             # flat
    return lg


def _jax_filtered(monkeypatch, lg, temperature, top_k, top_p):
    """The logits paddle_tpu's ``_select_token`` hands to
    ``jax.random.categorical`` (its filtered logits)."""
    seen = {}

    def capture(key, logits, axis=-1):
        seen["logits"] = np.asarray(logits)
        return jnp.argmax(logits, axis=axis)
    monkeypatch.setattr(jax.random, "categorical", capture)
    jgen._select_token(jnp.asarray(lg), jax.random.PRNGKey(0), True,
                       temperature, top_k, top_p)
    return seen["logits"]


@pytest.mark.parametrize("temperature,top_k,top_p", KNOBS)
def test_filter_support_matches_paddle_tpu(monkeypatch, temperature, top_k,
                                           top_p):
    lg = _logits()
    want = _jax_filtered(monkeypatch, lg, temperature, top_k, top_p)
    got = tgen._filter_logits(torch.from_numpy(lg), temperature, top_k,
                              top_p).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    kept = want > -1e29
    np.testing.assert_allclose(got[kept], want[kept], rtol=0, atol=1e-6)
    assert kept.sum(1).min() >= 1
    if top_k and top_k < 64 and top_p == 1.0:
        assert (kept.sum(1) >= top_k).all()      # ties at the k-th are kept


def _chi_square_p(draws, probs):
    """p-value of ``draws`` (token ids) against ``probs`` [V]; bins with
    fewer than 5 expected draws are merged into one."""
    counts = np.bincount(draws, minlength=probs.shape[0]).astype(np.float64)
    expected = probs * draws.shape[0]
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    return stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(1.0, 0, 1.0), (0.8, 12, 0.9)])
def test_port_and_jax_draws_follow_the_port_probabilities(
        temperature, top_k, top_p):
    """4,000 draws each from one row of logits: the port's (4,000
    requests' keys at one position), paddle_tpu's (one key over 4,000
    rows). Both pass the chi-square test against softmax of the port's
    filtered logits, and neither draws a filtered token."""
    lg = _logits(B=1, V=24, seed=3)[0]
    filt = tgen._filter_logits(torch.from_numpy(lg[None]), temperature,
                               top_k, top_p)[0]
    probs = torch.softmax(filt, -1).numpy().astype(np.float64)
    keys = tgen.fold_in(torch.stack([tgen.prng_key(s)
                                     for s in range(N_DRAWS)]), 17)
    port = tgen._select_token(
        torch.from_numpy(np.tile(lg, (N_DRAWS, 1))), keys, True, temperature,
        top_k, top_p).numpy()
    jx = np.asarray(jgen._select_token(
        jnp.asarray(np.tile(lg, (N_DRAWS, 1))), jax.random.PRNGKey(5), True,
        temperature, top_k, top_p))
    for draws in (port, jx):
        assert (probs[draws] > 0).all()
        assert _chi_square_p(draws, probs) > 1e-3


def test_hash_is_exact_32_bit_arithmetic():
    """``_mix32`` is murmur3's fmix32 on Python ints, at the words where
    an int64 product would overflow; uniforms never reach 0 or 1."""
    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)
    words = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 0xDEADBEEF, 12345]
    got = tgen._mix32(torch.tensor(words, dtype=torch.int64)).tolist()
    assert got == [fmix(w) for w in words]
    key = tgen.prng_key(2 ** 40 + 7)
    assert key.tolist() == [256, 7]
    g = tgen._gumbel(torch.stack([tgen.fold_in(key, p) for p in range(64)]),
                     4096)
    assert torch.isfinite(g).all()
    assert -3.0 < g.min().item() and g.max().item() < 16.7
    assert abs(g.mean().item() - 0.5772) < 0.02       # Euler-Mascheroni


def test_draw_depends_on_key_alone():
    """A row's draw depends on its key and logits, not on its row or the
    other rows; folding another position in changes the bits."""
    lg = torch.from_numpy(np.tile(_logits(B=1, V=64, seed=4), (4, 1)))
    base = tgen.prng_key(9)
    keys = tgen.fold_in(torch.stack([base] * 4), torch.tensor([5, 6, 7, 5]))
    toks = tgen._select_token(lg, keys, True, 1.0, 0, 1.0)
    assert toks[0] == toks[3]
    alone = tgen._select_token(lg[:1], keys[3:], True, 1.0, 0, 1.0)
    assert alone[0] == toks[3]
    bits = tgen._gumbel(keys, 64)
    assert torch.equal(bits[0], bits[3])
    assert not torch.equal(bits[0], bits[1])
    greedy = tgen._select_token(lg, None, False, 0.5, 3, 0.5)
    assert torch.equal(greedy, torch.argmax(lg, -1))


@pytest.fixture(scope="module")
def model():
    return LlamaForCausalLM(llama_tiny(), device="cpu", seed=2)


def test_generate_samples_per_row_seed(model):
    ids = np.random.RandomState(0).randint(0, 256, (2, 6)).astype(np.int64)
    a = generate(model, ids, 10, seed=3, cache_dtype="float32", **SAMPLE)
    b = generate(model, ids, 10, seed=3, cache_dtype="float32", **SAMPLE)
    np.testing.assert_array_equal(a, b)
    for row in range(2):                   # row b samples with seed + b
        np.testing.assert_array_equal(
            a[row], generate(model, ids[row], 10, seed=3 + row,
                             cache_dtype="float32", **SAMPLE)[0])
    c = generate(model, ids, 10, seed=4, cache_dtype="float32", **SAMPLE)
    assert not np.array_equal(a[:, 6:], c[:, 6:])
    greedy = generate(model, ids, 10, cache_dtype="float32")
    assert not np.array_equal(a[:, 6:], greedy[:, 6:])


PROMPTS = [np.random.RandomState(i).randint(0, 256, (n,)).astype(np.int64)
           for i, n in enumerate((5, 12, 3, 16, 9))]
BUDGETS = [6, 9, 12, 4, 7]


@pytest.mark.parametrize("mode", ["slot", "paged"])
def test_engine_draws_ignore_slot_and_tick(model, mode):
    """Request 0 (seed 21) served alone, then again third in a staggered
    stream of five on a three-slot engine (another slot, other ticks, other
    neighbours): the same tokens, equal to ``generate()`` with its seed;
    the other requests equal theirs too."""
    kw = dict(ENGINE_KW, **SAMPLE)
    if mode == "paged":
        kw.update(paged=True, page_size=8)
    eng = ContinuousBatchingEngine(model, slots=3, device="cpu", **kw)
    seeds = [21, 5, 6, 7, 8]
    try:
        alone = eng.generate(PROMPTS[0], BUDGETS[0], seed=21, timeout=120)
        order = [1, 2, 0, 3, 4]
        futs = {}
        for i in order:
            futs[i] = eng.submit(PROMPTS[i], BUDGETS[i], None, seeds[i])
            time.sleep(0.01)
        got = {i: f.result(timeout=300) for i, f in futs.items()}
    finally:
        eng.stop()
    np.testing.assert_array_equal(got[0], alone)
    for i, out in got.items():
        want = generate(model, PROMPTS[i], BUDGETS[i], seed=seeds[i],
                        cache_dtype="float32", **SAMPLE)[0]
        np.testing.assert_array_equal(out, want)


def test_engine_seed_and_knobs(model):
    """Another seed gives other tokens; sampling knobs without
    ``do_sample`` leave the engine greedy, as in paddle_tpu."""
    eng = ContinuousBatchingEngine(model, slots=2, device="cpu",
                                   **dict(ENGINE_KW, **SAMPLE))
    try:
        a = eng.generate(PROMPTS[1], 12, seed=1, timeout=120)
        b = eng.generate(PROMPTS[1], 12, seed=2, timeout=120)
    finally:
        eng.stop()
    assert not np.array_equal(a, b)
    eng = ContinuousBatchingEngine(model, slots=2, device="cpu",
                                   temperature=0.3, top_k=2, top_p=0.5,
                                   **ENGINE_KW)
    try:
        out = eng.generate(PROMPTS[1], 8, seed=5, timeout=120)
    finally:
        eng.stop()
    np.testing.assert_array_equal(
        out, generate(model, PROMPTS[1], 8, cache_dtype="float32")[0])


def test_server_passes_the_seed(model):
    eng = ContinuousBatchingEngine(model, slots=2, device="cpu",
                                   **dict(ENGINE_KW, **SAMPLE))
    srv = PredictorServer(engine=eng, host="127.0.0.1", port=0).start()
    url = f"http://{srv.host}:{srv.port}/generate"
    try:
        bodies = {}

        def post(seed):
            data = json.dumps({"input_ids": PROMPTS[2].tolist(),
                               "max_new_tokens": 10, "seed": seed}).encode()
            req = urllib.request.Request(
                url, data=data, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                bodies[seed] = json.loads(r.read())
        threads = [threading.Thread(target=post, args=(s,)) for s in (3, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for seed in (3, 4):
            assert bodies[seed]["tokens"] == eng.generate(
                PROMPTS[2], 10, seed=seed, timeout=120).tolist()
        assert bodies[3]["tokens"] != bodies[4]["tokens"]
    finally:
        srv.stop()
        eng.stop()


@pytest.mark.parametrize("method", ["submit", "generate"])
def test_engine_methods_take_the_reference_parameter_order(method):
    """``seed`` sits where paddle_tpu puts it, and ``submit`` ends with
    the streaming ``progress_cb`` as paddle_tpu's does."""
    got = list(inspect.signature(
        getattr(ContinuousBatchingEngine, method)).parameters)
    want = list(inspect.signature(getattr(JaxEngine, method)).parameters)
    assert got == want
