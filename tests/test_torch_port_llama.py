"""paddle_tpu_torch Llama against paddle_tpu's, on the CPU.

``llama_tiny`` (hidden 64, 4 layers, 4 heads, 2 kv heads: GQA at g = 2)
is built by paddle_tpu from a seed; its parameters cross as numpy arrays
into the port's model through ``load_paddle_tpu_params``. Both run in f32
on the CPU, the port's kernels as their plain versions, paddle_tpu's
Pallas kernels in interpret mode (or through the PADDLE_TPU_MEGA_DECODE /
PADDLE_TPU_FUSED_CACHE_WRITE knobs, as its own tests run them).

Tolerances, each with its reason:
- logits, no-cache and cached: atol 1e-4, as GPT's (f32 matmul and softmax
  summation orders differ between XLA:CPU and PyTorch, ~1e-6 an op at
  these widths); through a bf16 cache 1e-3 (both sides round the same k/v
  to bf16, but an f32 value one ulp apart can round to the neighbouring
  bf16 step, 2^-8 of the entry);
- ``_rope``: atol 1e-6 on O(1) values (f32 cos/sin of the same angles);
- ``rms_norm``: f32 atol 1e-6; bf16 within one bf16 step (rtol 2^-7:
  rsqrt may differ in its last f32 bit, which can move the bf16 rounding
  by one step);
- loss and every grad atol 1e-5 and TrainStep losses rtol 1e-4, as GPT's;
- the sp = 2 ring against the unsplit model: logits atol 2e-5 and grads
  atol 2e-5 (two block partials merged against one softmax, as the sp
  tests hold the ring);
- B4's plain version against paddle_tpu's ``mega_decode_step`` in
  interpret mode at g = 3, 5 and 16: ctx atol 1e-5, caches bit-exact, as
  tests/test_torch_port_kernels.py holds g = 1 and 2.
"""
import dataclasses
import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.inference.engine import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.jit.functional import functional_call, raw_state
from paddle_tpu.kernels.mega_decode import mega_decode_step as jax_mega
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import mega_decode as md
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM, generate,
                                     llama_7b, llama_13b, llama_tiny)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW

tfa = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")

ATOL = 1e-4
ENGINE_KW = dict(max_len=64, prefill_buckets=(8, 16), tick_tokens=2)
# (prompt length, max_new_tokens): both buckets, budgets that end mid-tick
# and on a tick boundary, more requests than slots
SHAPES = [(5, 6), (12, 9), (3, 12), (16, 4), (9, 7)]


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny())
    jm.eval()
    params = {n: np.asarray(v) for n, v in raw_state(jm)[0].items()}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", seed=1)
    load_paddle_tpu_params(tm, params)
    return jm, tm, params


def _ids(B, S, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(
        np.int64)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    x = getattr(x, "value", x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


# ------------------------------------------------------------ config

def test_config_fields_and_factories_match_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(LlamaConfig)] \
        == [(f.name, f.default)
            for f in dataclasses.fields(jllama.LlamaConfig)]
    for port, ref in ((llama_tiny, jllama.llama_tiny),
                      (llama_7b, jllama.llama_7b),
                      (llama_13b, jllama.llama_13b)):
        assert dataclasses.asdict(port(rope_theta=5e5)) == \
            dataclasses.asdict(ref(rope_theta=5e5))
        assert port().kv_heads == ref().kv_heads
    assert llama_13b().kv_heads == 40 and llama_tiny().kv_heads == 2


def test_param_names_and_layouts_are_paddles(models):
    _, tm, params = models
    shapes = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert shapes == {n: a.shape for n, a in params.items()}
    assert shapes["llama.block_0.self_attn.k_proj.weight"] == (64, 32)
    assert shapes["llama.block_3.mlp.down_proj.weight"] == (176, 64)
    assert shapes["lm_head.weight"] == (64, 256)          # untied
    assert len(shapes) == 3 + 4 * 9


@pytest.mark.parametrize("field", ["scan_layers", "recompute",
                                   "fused_loss_chunk"])
def test_unported_config_raises(field):
    """These fields are ported: the model builds, as paddle_tpu's does,
    with paddle_tpu's parameter names and shapes."""
    paddle.seed(0)
    params, _ = raw_state(jllama.LlamaForCausalLM(
        jllama.llama_tiny(**{field: 1})))
    tm = LlamaForCausalLM(llama_tiny(**{field: 1}), device="cpu")
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: tuple(a.shape) for n, a in params.items()}


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert LlamaForCausalLM(llama_tiny()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LlamaForCausalLM(llama_tiny())


def test_construction_is_seeded_and_bad_shapes_raise(models):
    a = LlamaForCausalLM(llama_tiny(), device="cpu", seed=3)
    b = LlamaForCausalLM(llama_tiny(), device="cpu", seed=3)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
        if p.ndim == 1:
            assert torch.equal(p, torch.ones_like(p)), n
        else:
            assert 0.015 < p.std().item() < 0.025, n
    assert not a.training
    with pytest.raises(ValueError, match="num_kv_heads"):
        LlamaForCausalLM(dataclasses.replace(llama_tiny(), num_kv_heads=3),
                         device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        models[1](torch.zeros(1, 129, dtype=torch.int64))


# ------------------------------------------------------ functionals

@pytest.mark.parametrize("offset", [None, 5, "per-row"])
def test_rope_matches(offset):
    rs = np.random.RandomState(2)
    q = rs.randn(3, 6, 4, 16).astype(np.float32)
    k = rs.randn(3, 6, 2, 16).astype(np.float32)
    jo = to = offset
    if offset == "per-row":
        o = np.asarray([0, 7, 100], np.int32)
        jo, to = paddle.to_tensor(o), torch.from_numpy(o)
    jq, jk = jllama._rope(paddle.to_tensor(q), paddle.to_tensor(k), 10000.0,
                          offset=jo)
    tq, tk = tllama._rope(torch.from_numpy(q), torch.from_numpy(k), 10000.0,
                          offset=to)
    np.testing.assert_allclose(tq.numpy(), _np32(jq.value), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), _np32(jk.value), rtol=0,
                               atol=1e-6)
    if offset is None:                           # position 0 is the identity
        np.testing.assert_array_equal(tq[:, 0].numpy(), q[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    rs = np.random.RandomState(4)
    x = (rs.randn(4, 7, 64) * 3).astype(np.float32)
    w = rs.randn(64).astype(np.float32)
    want = JF.rms_norm(paddle.to_tensor(x).astype(dtype),
                       paddle.to_tensor(w).astype(dtype), 1e-6)
    tdt = getattr(torch, dtype)
    got = TF.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                      1e-6)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np32(want.value), rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(_np32(got), _np32(want.value),
                                   rtol=2 ** -7, atol=0)
    # the cast comes before the weight: without a weight the result is
    # x * rsqrt(ms + eps) rounded once
    plain = TF.rms_norm(torch.from_numpy(x).to(tdt))
    xf = torch.from_numpy(x).to(tdt).float()
    torch.testing.assert_close(
        plain, (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
                ).to(tdt), rtol=0, atol=0)


def test_silu_matches():
    x = np.random.RandomState(5).randn(100).astype(np.float32) * 4
    np.testing.assert_allclose(
        TF.silu(torch.from_numpy(x)).numpy(),
        _np32(JF.silu(paddle.to_tensor(x)).value), rtol=0, atol=1e-6)


# -------------------------------------------------------------- model

def test_no_cache_logits_match(models):
    jm, tm, _ = models
    ids = _ids(2, 12)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 12, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _jax_prog(jm):
    jparams, jbuf = raw_state(jm)

    @jax.jit
    def prog(x, caches, pos):
        return functional_call(jm, jparams, jbuf, x, caches, pos,
                               training=False)[0]
    return prog


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_prefill_and_decode_steps_match(models, monkeypatch, cache_dtype):
    """Prefill at scalar position 0, then 4 S=1 decode steps at per-row
    positions (the engine's decode shape: B4 for f32/bf16 caches, the
    fused slot write for int8) on both sides."""
    monkeypatch.setenv("PADDLE_TPU_MEGA_DECODE", "1")
    monkeypatch.setenv("PADDLE_TPU_FUSED_CACHE_WRITE", "1")
    jm, tm, _ = models
    atol = 1e-3 if cache_dtype == "bfloat16" else ATOL
    B, P, L = 2, 7, 16
    ids = _ids(B, P, seed=1)
    prog = _jax_prog(jm)
    jc = jm.new_cache(B, L, cache_dtype)
    tc = tm.new_cache(B, L, cache_dtype)
    jl, jc = prog(jnp.asarray(ids), jc, jnp.int32(0))
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(ids), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=atol)
    tok = np.argmax(np.asarray(jl)[:, -1], -1)
    for i in range(4):
        pos = np.asarray([P + i, P + 2 * i], np.int32)   # rows apart
        jl, jc = prog(jnp.asarray(tok[:, None]), jc, jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = tm(torch.from_numpy(tok[:, None].astype(np.int64)), tc,
                        torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=atol)
        tok = np.argmax(np.asarray(jl)[:, -1], -1)
    kc_t, kc_j = tc[0][0], jc[0][0]
    if cache_dtype == "int8":
        kc_t, kc_j = kc_t["scale"], kc_j["scale"]
    assert tuple(kc_t.shape[:3]) == (B, L, 2)            # nkv heads kept
    np.testing.assert_allclose(_np32(kc_t), _np32(kc_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_logits_through_paged_pools_match(models, monkeypatch, cache_dtype):
    """Prefill 7 tokens at 0 into scattered pages, then 4 decode steps at
    per-row positions with the live gate attached, both sides."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_CACHE_WRITE", "1")
    jm, tm, _ = models
    B, P, NP, PS = 2, 7, 10, 4
    bt = np.asarray([[3, 7, 1, 0], [5, 2, 8, 9]], np.int32)
    ids = _ids(B, P, seed=2)
    prog = _jax_prog(jm)

    def jstep(x, caches, pos, live=None):
        meta = {"bt": jnp.asarray(bt)}
        if live is not None:
            meta["live"] = jnp.asarray(live)
        caches = [({**k, **meta}, {**v, **meta}) for k, v in caches]
        logits, caches = prog(jnp.asarray(x), caches, pos)
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
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    tok = np.argmax(jl[:, -1], -1)
    live = np.asarray([True, True])
    for i in range(4):
        pos = np.full(B, P + i, np.int32)
        x = tok[:, None].astype(np.int64)
        jl, jc = jstep(x, jc, jnp.asarray(pos), live)
        tl, tc = tstep(x, tc, torch.from_numpy(pos), live)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
        tok = np.argmax(jl[:, -1], -1)
    leaf = "scale" if cache_dtype == "int8" else "pages"
    np.testing.assert_allclose(_np32(tc[0][0][leaf]), _np32(jc[0][0][leaf]),
                               rtol=0, atol=1e-5)


def test_bfloat16_casts_every_parameter(models):
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny())
    jm.bfloat16()
    jdt = {n: str(v.dtype) for n, v in raw_state(jm)[0].items()}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu").bfloat16()
    assert {n: str(p.dtype).replace("torch.", "")
            for n, p in tm.named_parameters()} == jdt
    with torch.no_grad():
        out = tm(torch.from_numpy(_ids(1, 8)))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


# ------------------------------------------------------------- engine

def _serve_staggered(eng, prompts):
    futs = []
    for ids, (_, n) in zip(prompts, SHAPES):
        futs.append(eng.submit(ids, max_new_tokens=n))
        time.sleep(0.01)          # arrivals land across tick boundaries
    return [f.result(timeout=300) for f in futs]


@pytest.mark.parametrize("mode", ["slot", "paged"])
def test_engine_greedy_tokens_match_jax_engine_and_generate(models,
                                                            monkeypatch,
                                                            mode):
    monkeypatch.setenv("PADDLE_TPU_MEGA_DECODE", "1")
    monkeypatch.setenv("PADDLE_TPU_FUSED_CACHE_WRITE", "1")
    jm, tm, _ = models
    kw = dict(ENGINE_KW, cache_dtype="float32")
    if mode == "paged":
        kw.update(paged=True, page_size=8)
    prompts = [np.random.RandomState(i).randint(0, 256, (p,)).astype(
        np.int64) for i, (p, _) in enumerate(SHAPES)]
    jeng = JaxEngine(jm, slots=3, **kw)
    try:
        want = _serve_staggered(jeng, prompts)
    finally:
        jeng.stop()
    teng = ContinuousBatchingEngine(tm, slots=3, device="cpu", **kw)
    try:
        got = _serve_staggered(teng, prompts)
        stats = teng.stats()
    finally:
        teng.stop()
    for ids, (p, n), g, w in zip(prompts, SHAPES, got, want):
        assert g.shape == (p + n,)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, generate(tm, ids, n, cache_dtype="float32")[0])
    assert stats["admitted"] == stats["completed"] == len(SHAPES)


# ----------------------------------------------------------- training

@pytest.fixture(scope="module")
def batches():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 256, (2, 32)).astype(np.int64) for _ in range(4)]


def test_loss_and_grads_match(models, batches):
    jm, _, params = models
    ids = batches[0]
    _, buffers = raw_state(jm)

    @jax.jit
    def value_and_grad(p, x):
        def loss_of(p_):
            out, _ = functional_call(jm, p_, buffers, x, training=True)
            return jllama.LlamaForCausalLM.loss_fn(Tensor(out),
                                                   Tensor(x)).value
        return jax.value_and_grad(loss_of)(p)

    jloss, jgrads = value_and_grad({n: jnp.asarray(v)
                                    for n, v in params.items()},
                                   jnp.asarray(ids))
    tm = load_paddle_tpu_params(
        LlamaForCausalLM(llama_tiny(), device="cpu", seed=1), params).train()
    x = torch.from_numpy(ids)
    loss = tm.make_loss_fn()(tm(x), x)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-5)
    got = dict(tm.named_parameters())
    assert set(got) == set(jgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(got[n].grad.numpy(), _np32(g), rtol=0,
                                   atol=1e-5, err_msg=n)


def test_train_step_trajectory_matches(batches):
    """Four AdamW TrainStep steps on one batch from the same weights:
    paddle_tpu's losses, rtol 1e-4, falling."""
    paddle.seed(11)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny())
    params = {n: np.asarray(v) for n, v in raw_state(jm)[0].items()}
    jstep = JaxTrainStep(jm, jm.make_loss_fn(), paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    x = paddle.to_tensor(batches[0])
    want = [float(jstep(x, x).numpy()) for _ in range(4)]
    tm = load_paddle_tpu_params(
        LlamaForCausalLM(llama_tiny(), device="cpu", seed=1), params)
    step = TrainStep(tm, tm.make_loss_fn(),
                     AdamW(learning_rate=1e-3, parameters=tm.parameters()))
    t = torch.from_numpy(batches[0])
    got = [step(t, t).item() for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert got[-1] < got[0]


def test_sp2_ring_matches_the_unsplit_model(models, monkeypatch):
    """Under an sp = 2 mesh every attention goes through the ring (B5),
    never through B1; logits and every grad equal the unsplit model's."""
    _, _, params = models
    tm = load_paddle_tpu_params(
        LlamaForCausalLM(llama_tiny(), device="cpu"), params).train()
    ids = torch.from_numpy(_ids(2, 64, seed=3))

    def run():
        tm.zero_grad()
        out = tm(ids)
        tm.loss_fn(out, ids).backward()
        return out.detach(), {n: p.grad.clone()
                              for n, p in tm.named_parameters()}

    want, wgrads = run()
    tdist.init_mesh({"sp": 2}, devices=["cpu"] * 2)
    try:
        def no_flash(*a, **kw):
            raise AssertionError("the unsharded flash attention ran under sp")
        monkeypatch.setattr(TF, "flash_attention", no_flash)
        got, grads = run()
        assert tdist.sequence_parallel.last_ring_dispatch()["path"] == \
            "kernel"
    finally:
        tdist.set_mesh(None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    for n, g in wgrads.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), rtol=0,
                                   atol=2e-5, err_msg=n)


# ------------------------------------------------- B4 at every group

@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,nkv", [(6, 2), (5, 1), (16, 1), (32, 2)])
def test_mega_decode_plain_any_group_matches_pallas(nh, nkv, cache_dtype):
    """g = 3, 5, 16 (MQA) and 16 with two kv heads: the port's B4 plain
    version against paddle_tpu's kernel, interpreted."""
    rs = np.random.RandomState(nh + nkv)
    L, hd = 16, 8
    pos = np.asarray([0, L - 1, 5, 5, L + 2], np.int32)
    B = pos.shape[0]
    q = rs.randn(B, 1, nh, hd).astype(np.float32)
    k, v = (rs.randn(B, 1, nkv, hd).astype(np.float32) for _ in range(2))
    kc, vc = (rs.randn(B, L, nkv, hd).astype(np.float32) for _ in range(2))
    jdt = getattr(jnp, cache_dtype)
    tdt = getattr(torch, cache_dtype)
    jctx, jkc, jvc = jax_mega(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(kc).astype(jdt),
                              jnp.asarray(vc).astype(jdt), jnp.asarray(pos),
                              interpret=True)
    tkc = torch.from_numpy(kc.copy()).to(tdt)
    tvc = torch.from_numpy(vc.copy()).to(tdt)
    tctx, _, _ = md.mega_decode_step(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tkc,
        tvc, torch.from_numpy(pos))
    np.testing.assert_allclose(tctx.numpy(), _np32(jctx), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_np32(tkc), _np32(jkc))
    np.testing.assert_array_equal(_np32(tvc), _np32(jvc))
    # pos 0: only the new row is attended, every query head of a kv head
    # gets its v
    np.testing.assert_array_equal(
        tctx[0, 0].numpy().reshape(nkv, nh // nkv, hd),
        np.repeat(v[0, 0][:, None], nh // nkv, 1))
    assert md.mega_decode_step.launches == 0             # plain on the CPU


def test_gqa_engine_routes_through_b4_at_g5(monkeypatch):
    """A 5-query-heads-per-kv-head Llama (hidden 80, 10 heads, 2 kv heads)
    serves through ``mega_decode_step`` (its plain version here), tokens
    equal to sequential generate()."""
    calls = []
    real = tfa.mega_decode_step

    def spy(q, k, v, kc, vc, pos):
        calls.append(q.shape[2] // kc.shape[2])
        return real(q, k, v, kc, vc, pos)
    monkeypatch.setattr(tfa, "mega_decode_step", spy)
    cfg = LlamaConfig(vocab_size=128, hidden_size=80, intermediate_size=96,
                      num_layers=2, num_heads=10, num_kv_heads=2,
                      max_seq_len=64)
    tm = LlamaForCausalLM(cfg, device="cpu", seed=4)
    eng = ContinuousBatchingEngine(tm, slots=2, cache_dtype="float32",
                                   device="cpu", **ENGINE_KW)
    try:
        ids = np.arange(1, 10, dtype=np.int64)
        out = eng.generate(ids, max_new_tokens=5, timeout=120)
    finally:
        eng.stop()
    np.testing.assert_array_equal(
        out, generate(tm, ids, 5, cache_dtype="float32")[0])
    assert calls and set(calls) == {5}
