"""paddle_tpu_torch GPT against paddle_tpu GPT with copied weights.

gpt_tiny (hidden 64, 4 layers, 4 heads) built by paddle_tpu from a seed;
its parameters cross as numpy arrays into the port's model through
``load_paddle_tpu_params``. Both run in f32 on the CPU; logits agree
within atol 1e-4 (f32 matmul and softmax summation order differs between
XLA:CPU and PyTorch's CPU kernels, ~1e-6 per op at these widths).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import functional_call, raw_state
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

jfa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    params, _ = raw_state(jm)
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=1)
    load_paddle_tpu_params(tm, {n: np.asarray(v) for n, v in params.items()})
    return jm, tm


def _ids(B, S, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(
        np.int64)


def test_no_cache_logits_match(models):
    jm, tm = models
    ids = _ids(2, 12)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 12, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_prefill_and_decode_steps_match(models, monkeypatch, cache_dtype):
    """Prefill at scalar position 0, then 4 S=1 decode steps at per-row
    positions — the engine's decode shape, through the mega-decode (f32)
    or fused slot-write (int8) path on both sides."""
    monkeypatch.setenv("PADDLE_TPU_MEGA_DECODE", "1")
    monkeypatch.setenv("PADDLE_TPU_FUSED_CACHE_WRITE", "1")
    jm, tm = models
    B, P, L = 2, 7, 16
    ids = _ids(B, P, seed=1)
    jparams, jbuf = raw_state(jm)
    jc = jm.new_cache(B, L, cache_dtype)
    tc = tm.new_cache(B, L, cache_dtype)

    @jax.jit
    def jprog(x, caches, pos):
        return functional_call(jm, jparams, jbuf, x, caches, pos,
                               training=False)[0]

    def jstep(x, caches, pos):
        logits, caches = jprog(x, caches, pos)
        return np.asarray(logits), caches

    jl, jc = jstep(jnp.asarray(ids), jc, jnp.int32(0))
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(ids), tc, 0)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=ATOL)
    tok = np.argmax(jl[:, -1], -1)
    for i in range(4):
        pos = np.full(B, P + i, np.int32)
        jl, jc = jstep(jnp.asarray(tok[:, None]), jc, jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = tm(torch.from_numpy(tok[:, None].astype(np.int64)), tc,
                        torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=ATOL)
        tok = np.argmax(jl[:, -1], -1)
    kc_t, kc_j = tc[0][0], jc[0][0]
    if cache_dtype == "int8":
        kc_t, kc_j = kc_t["scale"], kc_j["scale"]
    np.testing.assert_allclose(kc_t.float().numpy(),
                               np.asarray(kc_j, np.float32), rtol=0,
                               atol=1e-5)


def test_load_params_is_strict(models):
    _, tm = models
    good = {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}
    missing = dict(good)
    missing.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError, match="gpt.ln_f.bias"):
        load_paddle_tpu_params(tm, missing)
    bad_shape = dict(good)
    bad_shape["gpt.block_0.attn.qkv.weight"] = np.zeros((192, 64),
                                                        np.float32)
    with pytest.raises(ValueError, match="qkv"):
        load_paddle_tpu_params(tm, bad_shape)
    not_numpy = dict(good)
    not_numpy["gpt.ln_f.bias"] = torch.zeros(64)
    with pytest.raises(TypeError, match="numpy"):
        load_paddle_tpu_params(tm, not_numpy)


def test_param_layout_is_paddles(models):
    _, tm = models
    shapes = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert shapes["gpt.block_0.attn.qkv.weight"] == (64, 192)    # [in, out]
    assert shapes["gpt.block_3.mlp.fc_out.weight"] == (256, 64)
    assert shapes["gpt.embeddings.word_embeddings.weight"] == (256, 64)
    assert len(shapes) == 4 + 12 * 4


def test_default_device_is_the_card():
    """No device argument means the CUDA card: on a machine without one
    the constructor raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert GPTForCausalLM(gpt_tiny()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GPTForCausalLM(gpt_tiny())


@pytest.mark.parametrize("field", ["scan_layers", "use_moe", "recompute",
                                   "fused_loss_chunk"])
def test_unported_config_raises(field):
    """``use_moe`` is not ported and raises naming ROADMAP.md. The other
    fields are ported: the model builds, as paddle_tpu's does, with
    paddle_tpu's parameter names and shapes (scan_layers: the stacked
    ``blocks.*__*`` leaves)."""
    if field == "use_moe":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            GPTForCausalLM(gpt_tiny(use_moe=True), device="cpu")
        return
    paddle.seed(0)
    params, _ = raw_state(JaxGPT(jax_gpt_tiny(**{field: True})))
    tm = GPTForCausalLM(gpt_tiny(**{field: True}), device="cpu")
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: tuple(a.shape) for n, a in params.items()}
