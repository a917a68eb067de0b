"""paddle_tpu_torch kernels and cached attention against paddle_tpu.

The port's kernel wrappers run their plain PyTorch versions on CPU
tensors; each is held against the JAX function it ports, run the way
paddle_tpu's own tests run it on the CPU (Pallas ``interpret=True``, or
through the PADDLE_TPU_MEGA_DECODE / PADDLE_TPU_FUSED_CACHE_WRITE knobs).
Inputs are made with numpy from a seed and handed to both; the port's
inputs are cloned first, because the port writes caches in place.

Tolerances: ctx atol 1e-5 in f32 (the softmax reassociation bound
tests/test_kernels.py holds paddle_tpu's fused kernels to); caches and
slot writes bit-exact (the same rows land at the same positions).
"""
import ast
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.cache_write import fused_slot_write as jax_slot_write
from paddle_tpu.kernels.mega_decode import mega_decode_step as jax_mega
from paddle_tpu_torch.kernels import cache_write as cw
from paddle_tpu_torch.kernels import mega_decode as md

# both packages re-export a flash_attention function under the module's name
jfa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")
PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "paddle_tpu_torch"


def _fixture(nh=4, nkv=2, L=16, hd=8, int8=False, seed=0,
             pos=None):
    """numpy q/k/v [B,1,*,hd], caches [B,L,nkv,hd] (or int8 dicts), pos:
    0, L-1, a duplicate pair and one >= L by default."""
    pos = np.asarray(pos if pos is not None else [0, L - 1, 5, 5, L + 2],
                     np.int32)
    B = pos.shape[0]
    rs = np.random.RandomState(seed)
    q = rs.randn(B, 1, nh, hd).astype(np.float32)
    k = rs.randn(B, 1, nkv, hd).astype(np.float32)
    v = rs.randn(B, 1, nkv, hd).astype(np.float32)
    if int8:
        def cache():
            return {"data": rs.randint(-90, 90, (B, L, nkv, hd)).astype(
                        np.int8),
                    "scale": (np.abs(rs.randn(B, L, nkv)) * 0.02).astype(
                        np.float32)}
        return q, k, v, cache(), cache(), pos
    kc = rs.randn(B, L, nkv, hd).astype(np.float32)
    vc = rs.randn(B, L, nkv, hd).astype(np.float32)
    return q, k, v, kc, vc, pos


_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _j(x, dtype="float32"):
    if isinstance(x, dict):
        return {n: jnp.asarray(a) for n, a in x.items()}
    return jnp.asarray(x).astype(_JDT[dtype])


def _t(x, dtype="float32"):
    if isinstance(x, dict):
        return {n: torch.from_numpy(a.copy()) for n, a in x.items()}
    return torch.from_numpy(x.copy()).to(_TDT[dtype])


def _np(x):
    """numpy f32 (or the integer dtype) of a jax or torch array."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    x = getattr(x, "value", x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2)])
def test_mega_decode_plain_matches_pallas_interpret(nh, nkv, cache_dtype):
    q, k, v, kc, vc, pos = _fixture(nh=nh, nkv=nkv)
    jctx, jkc, jvc = jax_mega(_j(q), _j(k), _j(v), _j(kc, cache_dtype),
                              _j(vc, cache_dtype), jnp.asarray(pos),
                              interpret=True)
    tkc, tvc = _t(kc, cache_dtype), _t(vc, cache_dtype)
    tctx, tkc2, tvc2 = md.mega_decode_step(_t(q), _t(k), _t(v), tkc, tvc,
                                           torch.from_numpy(pos))
    assert tkc2 is tkc and tvc2 is tvc            # written in place
    np.testing.assert_allclose(_np(tctx), _np(jctx), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_np(tkc), _np(jkc))
    np.testing.assert_array_equal(_np(tvc), _np(jvc))
    # pos = 0 (empty cache): the only attended row is the new one
    np.testing.assert_array_equal(_np(tctx)[0, 0].reshape(nkv, -1, 8),
                                  np.repeat(v[0, 0][:, None], nh // nkv, 1))


@pytest.mark.parametrize("kind", ["int8 data", "f32 scale plane",
                                  "f32 data"])
def test_slot_write_plain_matches_pallas_interpret(kind):
    rs = np.random.RandomState(3)
    B, L = 5, 16
    pos = np.asarray([0, L - 1, 5, 5, L + 2], np.int32)
    if kind == "int8 data":
        cache = rs.randint(-127, 128, (B, L, 2, 8)).astype(np.int8)
        rows = rs.randint(-127, 128, (B, 1, 2, 8)).astype(np.int8)
    elif kind == "f32 scale plane":
        cache = rs.rand(B, L, 2).astype(np.float32)
        rows = rs.rand(B, 1, 2).astype(np.float32)
    else:
        cache = rs.randn(B, L, 2, 8).astype(np.float32)
        rows = rs.randn(B, 1, 2, 8).astype(np.float32)
    want = jax_slot_write(jnp.asarray(cache), jnp.asarray(rows),
                          jnp.asarray(pos), interpret=True)
    got = torch.from_numpy(cache.copy())
    out = cw.fused_slot_write(got, torch.from_numpy(rows),
                              torch.from_numpy(pos))
    assert out is got
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_cached(monkeypatch, knob, q, k, v, kc, vc, pos):
    if knob:
        monkeypatch.setenv(knob, "1")
    ctx, kc2, vc2 = jfa.cached_attention(q, k, v, kc, vc, pos)
    return ctx, kc2, vc2


def _assert_caches_equal(tc, jc):
    if isinstance(tc, dict):
        for n in ("data", "scale"):
            np.testing.assert_array_equal(_np(tc[n]), _np(jc[n]))
    else:
        np.testing.assert_array_equal(_np(tc), _np(jc))


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2)])
def test_cached_attention_slot_decode_matches_mega_knob(monkeypatch, nh,
                                                        nkv):
    q, k, v, kc, vc, pos = _fixture(nh=nh, nkv=nkv, seed=1)
    jctx, jkc, jvc = _jax_cached(monkeypatch, "PADDLE_TPU_MEGA_DECODE",
                                 _j(q), _j(k), _j(v), _j(kc), _j(vc),
                                 jnp.asarray(pos))
    tkc, tvc = _t(kc), _t(vc)
    tctx, _, _ = tfa.cached_attention(_t(q), _t(k), _t(v), tkc, tvc,
                                      torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tctx), _np(jctx), rtol=0, atol=1e-5)
    _assert_caches_equal(tkc, jkc)
    _assert_caches_equal(tvc, jvc)


def test_cached_attention_int8_slot_decode_matches_fused_knob(monkeypatch):
    q, k, v, kc, vc, pos = _fixture(int8=True, seed=2)
    jctx, jkc, jvc = _jax_cached(monkeypatch, "PADDLE_TPU_FUSED_CACHE_WRITE",
                                 _j(q), _j(k), _j(v), _j(kc), _j(vc),
                                 jnp.asarray(pos))
    tkc, tvc = _t(kc), _t(vc)
    tctx, _, _ = tfa.cached_attention(_t(q), _t(k), _t(v), tkc, tvc,
                                      torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tctx), _np(jctx), rtol=0, atol=1e-5)
    _assert_caches_equal(tkc, jkc)
    _assert_caches_equal(tvc, jvc)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
def test_cached_attention_multi_token_matches(monkeypatch, int8, per_row):
    """S > 1 writes: a prefill block at a scalar position, and a block at
    per-row positions (plain tensor code on both sides)."""
    q, k, v, kc, vc, _ = _fixture(int8=int8, seed=4, pos=[0, 0, 0])
    rs = np.random.RandomState(5)
    S = 4
    q = rs.randn(3, S, 4, 8).astype(np.float32)
    k = rs.randn(3, S, 2, 8).astype(np.float32)
    v = rs.randn(3, S, 2, 8).astype(np.float32)
    jpos = jnp.asarray([0, 3, 14], jnp.int32) if per_row else 3
    tpos = torch.tensor([0, 3, 14], dtype=torch.int32) if per_row else 3
    jctx, jkc, jvc = _jax_cached(monkeypatch, None, _j(q), _j(k), _j(v),
                                 _j(kc), _j(vc), jpos)
    tkc, tvc = _t(kc), _t(vc)
    tctx, _, _ = tfa.cached_attention(_t(q), _t(k), _t(v), tkc, tvc, tpos)
    np.testing.assert_allclose(_np(tctx), _np(jctx), rtol=0, atol=1e-5)
    _assert_caches_equal(tkc, jkc)
    _assert_caches_equal(tvc, jvc)


def test_quant_rows_matches():
    x = np.random.RandomState(6).randn(3, 5, 2, 8).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: scale 0
    jq, js = jfa._quant_rows(jnp.asarray(x))
    tq, ts = tfa._quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_wrappers_on_cpu_launch_nothing():
    md.mega_decode_step.launches = 0
    cw.fused_slot_write.launches = 0
    q, k, v, kc, vc, pos = _fixture()
    md.mega_decode_step(_t(q), _t(k), _t(v), _t(kc), _t(vc),
                        torch.from_numpy(pos))
    cw.fused_slot_write(_t(kc), _t(k), torch.from_numpy(pos))
    assert md.mega_decode_step.launches == 0
    assert cw.fused_slot_write.launches == 0


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_paddle_tpu():
    """jax is imported at interpreter start in this image, so sys.modules
    proves nothing: read the port's sources instead."""
    files = sorted(PORT_ROOT.rglob("*.py"))
    assert len(files) >= 11
    names = {str(f.relative_to(PORT_ROOT)) for f in files}
    assert {"kernels/flash_block.py", "distributed/mesh.py",
            "distributed/sequence_parallel.py", "distributed/resilience.py",
            "obs/__init__.py", "obs/locks.py", "obs/metrics.py",
            "obs/trace.py", "obs/efficiency.py",
            "inference/router.py", "models/scanned.py",
            "distributed/recompute.py", "regularizer.py",
            "optimizer/optimizer.py", "optimizer/lr.py", "nn/clip.py",
            "jit/training.py", "convert.py", "framework/random.py",
            "framework/dtype.py", "nn/layer_base.py", "nn/initializer.py",
            "nn/utils.py", "nn/layer/container.py", "nn/layer/transformer.py",
            "io/state.py"} <= names
    files.append(PORT_ROOT.parent / "chip_smoke.py")
    bad = [(str(f.relative_to(PORT_ROOT.parent)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, bad
