"""paddle_tpu_torch's training memory features against paddle_tpu's:
``fused_linear_cross_entropy`` and ``fused_loss_chunk`` (A1),
``recompute`` and scan-stacked layers (A2).

Weights cross as numpy arrays (``load_paddle_tpu_params``, scan-stacked
leaves by paddle_tpu's ``__`` names); inputs are numpy arrays from a seed.
Everything runs in f32 on the CPU, where the port's kernels run their
plain versions and paddle_tpu's are compiled by XLA:CPU.

Tolerances (ROADMAP.md §C): logits atol 1e-4; losses and gradients atol
1e-5 (f32 matmul and softmax summation orders differ between XLA:CPU and
PyTorch's CPU kernels); engines identical greedy tokens; TrainStep
losses rtol 1e-4 a step. Port against port (recompute against none, a
scanned stack against the unrolled blocks it was loaded from) is exact:
the same operations on the same values.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.jit.functional import functional_call, raw_state
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import seed as tseed, set_device
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed.recompute import resolve_checkpoint_policy
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     generate, gpt_tiny, llama_tiny)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models.scanned import ScannedStack
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.optimizer import AdamW

B, S = 2, 32
FAMILIES = {"gpt": (JaxGPT, jax_gpt_tiny, GPTForCausalLM, gpt_tiny),
            "llama": (JaxLlama, jax_llama_tiny, LlamaForCausalLM,
                      llama_tiny)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ids(seed=0, shape=(B, S)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.int64)


def _pair(family, **cfg):
    """A seeded paddle_tpu model of ``family`` with ``cfg``, and the
    port's with its weights."""
    jcls, jcfg, tcls, tcfg = FAMILIES[family]
    paddle.seed(5)
    jm = jcls(jcfg(**cfg))
    params = {n: np.asarray(v) for n, v in raw_state(jm)[0].items()}
    tm = tcls(tcfg(**cfg), device="cpu", seed=1)
    return jm, load_paddle_tpu_params(tm, params), params


def _jax_loss_and_grads(jm, params, loss_of_out, *args):
    """paddle_tpu's training-mode loss and parameter grads, jitted."""
    _, buffers = raw_state(jm)

    @jax.jit
    def value_and_grad(p, *a):
        def loss_of(p_):
            out, _ = functional_call(jm, p_, buffers, *a, training=True)
            return loss_of_out(out, *a).value
        return jax.value_and_grad(loss_of)(p)

    return value_and_grad({n: jnp.asarray(v) for n, v in params.items()},
                          *[jnp.asarray(a) for a in args])


def _assert_grads(tm, jgrads, atol=1e-5):
    got = dict(tm.named_parameters())
    assert set(got) == set(jgrads)
    for n, g in jgrads.items():
        np.testing.assert_allclose(got[n].grad.numpy(), _np(g), rtol=0,
                                   atol=atol, err_msg=n)


def _lm_loss(jm):
    fn = jm.make_loss_fn()

    def loss(out, x):
        out = (tuple(Tensor(o) for o in out) if isinstance(out, tuple)
               else Tensor(out))
        return fn(out, Tensor(x))
    return loss


# -- A1: fused linear cross-entropy ------------------------------------------

@pytest.mark.parametrize("layout", ["vh", "hv"])
def test_fused_linear_ce_matches_reference(layout):
    """[V, H] (tied) and [H, V] weights; 26 tokens in chunks of 8 (a
    2-row tail chunk, padded); a quarter of the labels ignored: the loss
    and the grads of hidden and weight."""
    rs = np.random.RandomState(1)
    H, V = 16, 40
    h = rs.randn(2, 13, H).astype(np.float32)
    w = (rs.randn(V, H) if layout == "vh" else rs.randn(H, V)).astype(
        np.float32) * 0.3
    lbl = rs.randint(0, V, (2, 13)).astype(np.int64)
    lbl[rs.rand(2, 13) < 0.25] = -100

    def jloss(h_, w_):
        return jF.fused_linear_cross_entropy(Tensor(h_), Tensor(w_), lbl,
                                             chunk_size=8).value
    jl, (jdh, jdw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = tF.fused_linear_cross_entropy(th, tw, torch.from_numpy(lbl),
                                         chunk_size=8)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), _np(jdh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), _np(jdw), rtol=0, atol=1e-5)
    # the same loss as the whole logits through cross_entropy
    logits = th @ (tw.t() if layout == "vh" else tw)
    np.testing.assert_allclose(
        tF.cross_entropy(logits.reshape(-1, V),
                         torch.from_numpy(lbl).reshape(-1)).item(),
        loss.item(), rtol=0, atol=1e-6)


def test_fused_linear_ce_square_weight():
    """A square weight is ambiguous: both raise; with transpose_weight
    given, both agree."""
    rs = np.random.RandomState(2)
    h = rs.randn(6, 8).astype(np.float32)
    w = rs.randn(8, 8).astype(np.float32)
    lbl = rs.randint(0, 8, (6,)).astype(np.int64)
    with pytest.raises(ValueError, match="square"):
        jF.fused_linear_cross_entropy(Tensor(jnp.asarray(h)),
                                      Tensor(jnp.asarray(w)), lbl)
    with pytest.raises(ValueError, match="square"):
        tF.fused_linear_cross_entropy(torch.from_numpy(h),
                                      torch.from_numpy(w),
                                      torch.from_numpy(lbl))
    for tw in (True, False):
        want = jF.fused_linear_cross_entropy(
            Tensor(jnp.asarray(h)), Tensor(jnp.asarray(w)), lbl,
            chunk_size=4, transpose_weight=tw).value
        got = tF.fused_linear_cross_entropy(
            torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(lbl),
            chunk_size=4, transpose_weight=tw)
        np.testing.assert_allclose(got.item(), float(want), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_fused_loss_fn_matches_reference(family):
    """``fused_loss_chunk``: a training-mode forward gives (hidden,
    lm_weight) — GPT's tied [V, H], Llama's [H, V] — and
    ``make_loss_fn()`` streams it through the fused loss; loss and every
    grad against paddle_tpu's, and the loss equals the plain
    ``loss_fn`` of the logits."""
    jm, tm, params = _pair(family, fused_loss_chunk=24)
    ids = _ids(3)
    jl, jg = _jax_loss_and_grads(jm, params, _lm_loss(jm), ids)
    tm.train()
    x = torch.from_numpy(ids)
    out = tm(x)
    assert isinstance(out, tuple) and out[0].shape == (B, S, 64)
    w_shape = (256, 64) if family == "gpt" else (64, 256)
    assert tuple(out[1].shape) == w_shape
    loss = tm.make_loss_fn()(out, x)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=0, atol=1e-5)
    _assert_grads(tm, jg)
    tm.eval()
    with torch.no_grad():
        logits = tm(x)
        assert logits.shape == (B, S, 256)        # eval: logits
        np.testing.assert_allclose(tm.make_loss_fn()(logits, x).item(),
                                   loss.item(), rtol=0, atol=1e-5)


# -- A2: recompute -----------------------------------------------------------

def _port_loss_and_grads(tm, ids):
    tm.zero_grad(set_to_none=True)
    tm.train()
    x = torch.from_numpy(ids)
    loss = tm.make_loss_fn()(tm(x), x)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_recompute_matches_reference_and_no_recompute(family, policy):
    """Each block through ``recompute``: the loss and grads equal the
    port's without recompute exactly, and paddle_tpu's recompute model's
    within the f32 tolerance."""
    jm, tm, params = _pair(family, recompute=True, recompute_policy=policy)
    ids = _ids(4)
    jl, jg = _jax_loss_and_grads(jm, params, _lm_loss(jm), ids)
    loss, grads = _port_loss_and_grads(tm, ids)
    np.testing.assert_allclose(loss, float(jl), rtol=0, atol=1e-5)
    _assert_grads(tm, jg)
    _, plain, _ = _pair(family)
    want_loss, want = _port_loss_and_grads(plain, ids)
    assert loss == want_loss
    for n, g in grads.items():
        torch.testing.assert_close(g, want[n], rtol=0, atol=0, msg=n)


def test_recompute_replays_dropout_masks():
    """GPT at dropout 0.1: the port's dropout draws from its own
    generator, which torch.utils.checkpoint does not restore; recompute
    restores it at the boundary, so one seed gives the same loss and
    gradients with and without recompute."""
    results = []
    for rc in (False, True):
        tm = GPTForCausalLM(gpt_tiny(dropout=0.1, recompute=rc),
                            device="cpu", seed=0)
        tseed(11)
        results.append(_port_loss_and_grads(tm, _ids(5)))
    (l0, g0), (l1, g1) = results
    assert l0 == l1
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0, msg=n)
    # and the masks are really drawn: another seed, another loss
    tm = GPTForCausalLM(gpt_tiny(dropout=0.1, recompute=True), device="cpu",
                        seed=0)
    tseed(12)
    assert _port_loss_and_grads(tm, _ids(5))[0] != l0


@pytest.fixture
def on_cpu():
    """Layers build on the card by default; a test that builds them
    itself builds them on the CPU, as paddle's ``set_device("cpu")``
    asks."""
    set_device("cpu")
    yield
    set_device(None)


@pytest.mark.usefixtures("on_cpu")
def test_recompute_api():
    """``recompute(layer, x)`` equals ``layer(x)`` with the same grads;
    ``use_reentrant`` / ``preserve_rng_state`` are accepted; a plain
    function raises TypeError, an unknown policy ValueError, as
    paddle_tpu's; ``recompute_sequential`` over two segments."""
    lin = Linear(6, 5)
    seq = [Linear(6, 6), Linear(6, 6), Linear(6, 6), Linear(6, 6)]
    x = torch.randn(3, 6, requires_grad=True)
    y = tdist.recompute(lin, x, use_reentrant=True, preserve_rng_state=False,
                      policy="dots")
    y.sum().backward()
    gx, gw = x.grad.clone(), lin.weight.grad.clone()
    x.grad = lin.weight.grad = None
    lin(x).sum().backward()
    torch.testing.assert_close(gx, x.grad, rtol=0, atol=0)
    torch.testing.assert_close(gw, lin.weight.grad, rtol=0, atol=0)
    with pytest.raises(TypeError, match="Layer"):
        tdist.recompute(lambda t: t * 2, x)
    with pytest.raises(ValueError, match="policy"):
        tdist.recompute(lin, x, policy="some")
    want = x
    for m in seq:
        want = m(want)
    got = tdist.recompute_sequential({"segments": 2}, seq, x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert resolve_checkpoint_policy("full") is None
    assert callable(resolve_checkpoint_policy("dots"))


# -- A2: scan-stacked layers -------------------------------------------------

@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_scanned_model_matches_reference(family):
    """scan_layers (with recompute): paddle_tpu's stacked parameters load
    by name; eval logits, and the training loss and every grad (the
    stacked leaves' too) against paddle_tpu's scanned model."""
    jm, tm, params = _pair(family, scan_layers=True, recompute=True)
    assert any("__" in n for n in params)
    ids = _ids(6)
    jm.eval()
    _, buffers = raw_state(jm)
    jlogits, _ = jax.jit(lambda p, a: functional_call(
        jm, p, buffers, a, training=False))(
        {n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(ids))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(ids)).numpy(),
                                   _np(jlogits), rtol=0, atol=1e-4)
    jl, jg = _jax_loss_and_grads(jm, params, _lm_loss(jm), ids)
    loss, _ = _port_loss_and_grads(tm, ids)
    np.testing.assert_allclose(loss, float(jl), rtol=0, atol=1e-5)
    _assert_grads(tm, jg)


def test_scanned_bert_matches_reference():
    """BERT's encoder as one ScannedStack (its padding mask handed to
    every layer): the classifier's outputs, loss and grads against
    paddle_tpu's scanned BERT, with and without a mask."""
    paddle.seed(3)
    cfg = dict(scan_layers=True)
    jm = jbert.BertForSequenceClassification(jbert.bert_tiny(**cfg))
    params = {n: np.asarray(v) for n, v in raw_state(jm)[0].items()}
    tm = load_paddle_tpu_params(tbert.BertForSequenceClassification(
        tbert.bert_tiny(**cfg), device="cpu", seed=1), params)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 512, (B, 16)).astype(np.int64)
    tt = rs.randint(0, 2, (B, 16)).astype(np.int64)
    mask = np.ones((B, 16), np.int64)
    mask[1, 11:] = 0
    labels = np.array([1, 0], np.int64)
    for m in (None, mask):
        args = (ids, tt) if m is None else (ids, tt, m)

        def loss_of_out(out, *a):
            return jbert.BertForSequenceClassification.loss_fn(
                Tensor(out), Tensor(jnp.asarray(labels)))
        jl, jg = _jax_loss_and_grads(jm, params, loss_of_out, *args)
        tm.zero_grad(set_to_none=True)
        tm.train()
        logits = tm(*[torch.from_numpy(a) for a in args])
        loss = tm.loss_fn(logits, torch.from_numpy(labels))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jl), rtol=0,
                                   atol=1e-5)
        _assert_grads(tm, jg)


def test_load_from_blocks_gives_the_unrolled_model():
    """A scanned GPT loaded from an unrolled one's blocks gives its
    logits and its loss exactly; a wrong block count raises."""
    unrolled = GPTForCausalLM(gpt_tiny(), device="cpu", seed=0)
    scanned = GPTForCausalLM(gpt_tiny(scan_layers=True), device="cpu",
                             seed=9)
    scanned.gpt.blocks.load_from_blocks(unrolled.gpt.blocks)
    with torch.no_grad():
        for name in ("embeddings", "ln_f"):
            getattr(scanned.gpt, name).load_state_dict(
                getattr(unrolled.gpt, name).state_dict())
    x = torch.from_numpy(_ids(7))
    with torch.no_grad():
        torch.testing.assert_close(scanned(x), unrolled(x), rtol=0, atol=0)
    w = scanned.gpt.blocks.attn__qkv__weight
    assert torch.equal(w[2], unrolled.gpt.blocks[2].attn.qkv.weight)
    with pytest.raises(ValueError, match="num_layers"):
        scanned.gpt.blocks.load_from_blocks(unrolled.gpt.blocks[:3])


def _kind(v):
    v = np.asarray(v)
    if np.all(v == 1):
        return "ones"
    if np.all(v == 0):
        return "zeros"
    return "normal"


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_stacked_initialisation_rule_matches_reference(family):
    """Every stacked leaf is drawn, ones or zeros as paddle_tpu's
    ScannedStack makes it, and the drawn ones have its spread."""
    jm, _, _ = _pair(family, scan_layers=True)
    jcls, jcfg, tcls, tcfg = FAMILIES[family]
    tm = tcls(tcfg(scan_layers=True), device="cpu", seed=4)
    want = {n: _kind(v) for n, v in raw_state(jm)[0].items() if "__" in n}
    got = {n: _kind(p.detach().numpy()) for n, p in tm.named_parameters()
           if "__" in n}
    assert got == want and "normal" in got.values()
    for n, p in tm.named_parameters():
        if got.get(n) == "normal":
            assert abs(p.std().item() - 0.02) < 0.004, n
    # a stack built on its own draws from the framework generator
    stack = ScannedStack(lambda: Linear(8, 8), 3, 0.5)
    assert stack.weight.shape == (3, 8, 8) and stack.bias.eq(0).all()
    assert 0.4 < stack.weight.std().item() < 0.6


def test_scanned_rejects_dropout_and_buffers():
    """As paddle_tpu's: dropout > 0 raises at construction (GPT, BERT),
    and so do blocks with buffers and an unknown recompute policy."""
    with pytest.raises(NotImplementedError, match="dropout"):
        GPTForCausalLM(gpt_tiny(scan_layers=True, dropout=0.1), device="cpu")
    with pytest.raises(NotImplementedError, match="dropout"):
        jax_gpt = JaxGPT(jax_gpt_tiny(scan_layers=True, dropout=0.1))
        del jax_gpt
    with pytest.raises(NotImplementedError, match="dropout"):
        tbert.BertModel(dataclasses.replace(
            tbert.bert_tiny(scan_layers=True), dropout=0.1), device="cpu")

    class Buffered(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = Linear(4, 4)
            self.register_buffer("count", torch.zeros(1))

    with pytest.raises(NotImplementedError, match="buffer"):
        ScannedStack(Buffered, 2, 0.02)
    with pytest.raises(ValueError, match="policy"):
        GPTForCausalLM(gpt_tiny(scan_layers=True, recompute=True,
                                recompute_policy="most"), device="cpu")


@pytest.mark.parametrize("family,cache_dtype,paged", [
    ("gpt", "float32", False), ("gpt", "int8", False), ("gpt", "float32",
                                                        True),
    ("gpt", "int8", True), ("llama", "float32", True)])
def test_stacked_caches_serve_the_unrolled_tokens(family, cache_dtype,
                                                  paged):
    """A scanned model keeps stacked caches ([L, N, ...] slots, [L, NP,
    ...] pools; page and slot on axis 1): through the engine (staggered
    requests, a prefix hit with copy-on-write on the pools) it gives the
    unrolled model's greedy tokens, and its stacked caches equal the
    unrolled ones layer by layer after the same single request."""
    tcls, tcfg = FAMILIES[family][2:]
    unrolled = tcls(tcfg(), device="cpu", seed=0)
    scanned = tcls(tcfg(scan_layers=True), device="cpu", seed=0)
    body = "gpt" if family == "gpt" else "llama"
    getattr(scanned, body).blocks.load_from_blocks(
        getattr(unrolled, body).blocks)
    names = dict(scanned.named_parameters())
    with torch.no_grad():
        for n, p in unrolled.named_parameters():
            if n in names:
                names[n].copy_(p)
    kw = dict(slots=3, max_len=64, cache_dtype=cache_dtype,
              prefill_buckets=(8, 16), tick_tokens=2, device="cpu")
    if paged:
        kw.update(paged=True, page_size=8)
    reqs = [(_ids(20 + i, (p,)), n)
            for i, (p, n) in enumerate([(5, 6), (16, 7), (11, 9), (3, 5)])]
    reqs.append((reqs[1][0], 4))                 # a prefix hit when paged
    outs = []
    for m in (unrolled, scanned):
        eng = ContinuousBatchingEngine(m, **kw)
        try:
            futs = [eng.submit(ids, max_new_tokens=n) for ids, n in reqs]
            outs.append([f.result(timeout=300) for f in futs])
            if paged:
                assert eng.stats()["prefix_hits"] >= 1
                eng._allocator.check()
        finally:
            eng.stop()
    for (ids, n), a, b in zip(reqs, *outs):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(
            a, generate(unrolled, ids, n, cache_dtype=cache_dtype)[0])
    c_u = unrolled.new_cache(1, 32, cache_dtype)
    c_s = scanned.new_cache(1, 32, cache_dtype)
    assert isinstance(c_s, tuple) and len(c_s) == 2
    x = torch.from_numpy(reqs[0][0])[None]
    with torch.no_grad():
        unrolled(x, c_u, 0)
        scanned(x, c_s, 0)
    for i, (kc, vc) in enumerate(c_u):
        for half, stacked in ((kc, c_s[0]), (vc, c_s[1])):
            if isinstance(half, dict):
                for key in half:
                    torch.testing.assert_close(stacked[key][i], half[key],
                                               rtol=0, atol=0)
            else:
                torch.testing.assert_close(stacked[i], half, rtol=0, atol=0)


def test_train_step_trajectory_with_every_feature_matches_reference():
    """TrainStep over a GPT with scan_layers, recompute and
    fused_loss_chunk (AdamW, f32): the losses of 4 steps against
    paddle_tpu's TrainStep of the same model, rtol 1e-4 a step."""
    jm, tm, _ = _pair("gpt", scan_layers=True, recompute=True,
                      fused_loss_chunk=16)
    batches = [_ids(40 + i) for i in range(4)]
    jopt = paddle.optimizer.AdamW(learning_rate=3e-3,
                                  parameters=jm.parameters())
    jstep = JaxTrainStep(jm, jm.make_loss_fn(), jopt)
    want = []
    for ids in batches:
        x = paddle.to_tensor(ids)
        want.append(float(jstep(x, x).numpy()))
    step = TrainStep(tm, tm.make_loss_fn(),
                     AdamW(learning_rate=3e-3, parameters=tm.parameters()))
    got = [step(torch.from_numpy(b), torch.from_numpy(b)).item()
           for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


# -- the meta-device build of GPT --------------------------------------------

# sha256 over (name, f32 bytes) of every parameter of
# GPTForCausalLM(gpt_tiny(**cfg), device="cpu", seed=seed), taken from the
# build that drew every weight in host memory before moving the model
_DIGESTS = {
    ((), 0): "6fd22e0e69c118bcc32cfa2d3c5241e31cb5a00d0bce2091f490ba1a4b234549",
    ((), 1): "5717d4a79b82ccc5495a581a46f3e89e821a3eb99e7815792b81e6c1bd4e2663",
    ((("tie_embeddings", False),), 0):
        "36e7c64d4006adf914b3034dbf13f448d92e0efde04cb06315a51cda694ffb75",
    ((("tie_embeddings", False),), 1):
        "295ee8095ebdb0f6f0c8c9ce2fa185605f92399720a280ebedf97be5b6cc7de3"}


@pytest.mark.parametrize("cfg,seed", list(_DIGESTS))
def test_gpt_weights_are_unchanged_by_the_meta_build(cfg, seed):
    m = GPTForCausalLM(gpt_tiny(**dict(cfg)), device="cpu", seed=seed)
    h = hashlib.sha256()
    for n, p in m.named_parameters():
        h.update(n.encode())
        h.update(p.detach().contiguous().numpy().tobytes())
    assert h.hexdigest() == _DIGESTS[(cfg, seed)]
