"""paddle_tpu_torch sequence parallelism (distributed/mesh.py,
distributed/sequence_parallel.py, GPT under an ``sp`` mesh) against
paddle_tpu.distributed.

paddle_tpu runs on the 8-device virtual CPU mesh ``tests/conftest.py``
sets up, ``init_mesh({"sp": 4})`` taking the leading four, its Pallas
kernels in interpret mode; the port runs on a single-controller mesh of
four CPU positions (``devices=["cpu"] * 4``), where B5's wrappers run their
plain versions. Inputs are made with numpy from a seed and handed to both
sides.

Tolerances: ring and Ulysses outputs and q/k/v grads atol 2e-5 in f32
(O(1) values; each side merges sp block partials or runs one softmax over
512 keys in its own order, and paddle_tpu's own ring tests hold 2e-5);
at a geometry paddle_tpu's kernel does not tile, the port's B5 ring
against paddle_tpu's einsum body atol 1e-5 (sp merges of 16-key blocks
against one online-softmax recurrence, O(1) values); without an sp axis
B1 against paddle_tpu's plain attention atol 1e-5 (one softmax over 32
keys); GPT TrainStep losses rtol 1e-4 per step, as the port's unsharded
trajectory test.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.sequence_parallel import \
    last_ring_dispatch as jax_dispatch
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.jit.functional import raw_state
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch.distributed import sequence_parallel as tsp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import flash_attention as tka
from paddle_tpu_torch.kernels import flash_block as tfb
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW

SP = 4
CPU4 = ["cpu"] * SP
# paddle_tpu writes "pallas" where the port writes "kernel", and "plain"
# (no sp axis) where it writes "flash"
_PATHS = {"pallas": "kernel", "plain": "flash"}


@pytest.fixture(autouse=True)
def fresh_meshes():
    jdist.set_mesh(None)
    tdist.set_mesh(None)
    yield
    jdist.set_mesh(None)
    tdist.set_mesh(None)


def _meshes():
    jdist.init_mesh({"sp": SP})
    return tdist.init_mesh({"sp": SP}, devices=CPU4)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


# --------------------------------------------------------------------- mesh

def test_mesh_init_and_queries():
    assert tdist.get_mesh() is None
    assert tdist.mesh_axis_size("sp") == 1
    mesh = tdist.init_mesh({"sp": 4}, devices=CPU4)
    assert mesh.shape == {"sp": 4} and mesh.axis_names == ("sp",)
    assert mesh.axis_devices("sp") == [torch.device("cpu")] * 4
    assert tdist.get_mesh() is mesh and tdist.mesh_axis_size("sp") == 4
    # degree-1 axes are kept, in AXIS_ORDER
    mesh = tdist.init_mesh({"sp": 2, "dp": 1, "mp": 1}, devices=CPU4[:2])
    assert mesh.axis_names == ("dp", "sp", "mp")
    assert mesh.shape == {"dp": 1, "sp": 2, "mp": 1}
    assert len(mesh.axis_devices("sp")) == 2
    other = tdist.init_mesh({"sp": 1}, devices=["cpu"])
    with tdist.use_mesh(mesh):
        assert tdist.get_mesh() is mesh and tdist.mesh_axis_size("sp") == 2
    assert tdist.get_mesh() is other


@pytest.mark.parametrize("degrees,devices,err", [
    ({"sp": 8}, CPU4, ValueError),              # more positions than devices
    ({"sp": 2}, CPU4, ValueError),              # fewer positions than devices
    ({"xx": 2}, CPU4, ValueError),              # unknown axis
    ({"sp": -1}, CPU4, ValueError),             # degrees are never inferred
    ({}, CPU4, ValueError),                     # no default {"dp": n}
    ({"sp": 2, "dp": 2}, CPU4, NotImplementedError),
    ({"mp": 4}, CPU4, NotImplementedError),
    ({"sp": 4}, None, RuntimeError),            # no card: never the CPU
])
def test_mesh_errors(degrees, devices, err):
    with pytest.raises(err):
        tdist.init_mesh(degrees, devices=devices)
    assert tdist.get_mesh() is None


# ---------------------------------------------------------------- attention

def _jax_attention(fn, arrays, g, causal):
    """paddle_tpu's output and q/k/v grads of sum(fn(q, k, v) * g)."""
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts, causal=causal)
    (out * paddle.to_tensor(g)).sum().backward()
    return (np.asarray(out.numpy()), [np.asarray(t.grad.numpy()) for t in ts],
            jax_dispatch())


def _port_attention(fn, arrays, g, causal):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*ts, causal=causal)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    return out, grads, tsp.last_ring_dispatch()


def _assert_same_dispatch(port, jax_):
    assert port["path"] == _PATHS[jax_["path"]], (port, jax_)
    for key in ("sl", "d", "op"):
        assert port[key] == jax_[key], (key, port, jax_)


@pytest.mark.parametrize("op,H", [("ring", 2), ("ulysses", 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_sp_attention_matches_paddle_tpu(op, H, causal):
    """B=1, S=512, D=64 at sp=4: the fused path on both sides (shards of
    128 rows, or the full 512 after Ulysses' all-to-all), outputs and
    grads, and the same dispatch decision."""
    _meshes()
    rs = np.random.RandomState(11 + causal)
    arrays = [rs.randn(1, 512, H, 64).astype(np.float32) for _ in range(3)]
    g = rs.randn(1, 512, H, 64).astype(np.float32)
    jfn = getattr(jdist, f"{op}_attention")
    tfn = getattr(tdist, f"{op}_attention")
    want, wgrads, jd = _jax_attention(jfn, arrays, g, causal)
    out, grads, td = _port_attention(tfn, arrays, g, causal)
    assert td["path"] == "kernel"
    _assert_same_dispatch(td, jd)
    _close(out, want, 2e-5)
    for got, w in zip(grads, wgrads):
        _close(got, w, 2e-5)


def _record_blocks(monkeypatch):
    """Record the (q_off, k_off) of every B5 forward and backward call."""
    seen = {"fwd": [], "bwd": []}
    for kind in seen:
        real = getattr(tfb, f"flash_block_{kind}")

        def record(q, k, v, q_off, k_off, *a, _real=real, _kind=kind):
            seen[_kind].append((q_off, k_off))
            return _real(q, k, v, q_off, k_off, *a)
        monkeypatch.setattr(tfb, f"flash_block_{kind}", record)
    return seen


def _full_attention(q, k, v, scale, causal):
    """Unsharded [B, S, H, D] attention, softmax in f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril()
        s = torch.where(keep, s, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def test_ring_block_calls_and_rotation(monkeypatch):
    """The fused ring calls B5 sp*sp times each way, each position against
    every block once at the block's global offset, and the dK/dV
    accumulators come home: k/v grads equal the unsharded attention's."""
    tdist.init_mesh({"sp": SP}, devices=CPU4)
    seen = _record_blocks(monkeypatch)
    rs = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rs.randn(2, 512, 2, 16).astype(
        np.float32)).requires_grad_() for _ in range(4))
    out = tdist.ring_attention(q, k, v, causal=True)
    grads = torch.autograd.grad((out * g).sum(), (q, k, v))
    pairs = sorted((i * 128, j * 128) for i in range(SP) for j in range(SP))
    assert sorted(seen["fwd"]) == pairs and sorted(seen["bwd"]) == pairs
    ref = _full_attention(q, k, v, 0.25, True)
    wgrads = torch.autograd.grad((ref * g).sum(), (q, k, v))
    _close(out, ref.detach().numpy(), 2e-5)
    for got, w in zip(grads, wgrads):
        _close(got, w.numpy(), 2e-5)


@pytest.mark.parametrize("op", ["ring", "ulysses"])
def test_non_tiling_geometry_runs_the_kernel(op, monkeypatch):
    """S = 40 at sp = 4: shards of 10 rows at offsets 0, 10, 20, 30, which
    paddle_tpu's kernel does not tile, so it takes its einsum body. B5
    takes any geometry: the port stays on the kernel path (every ring
    block, or the full sequence once per position after Ulysses'
    all-to-all) and its outputs and grads match paddle_tpu's."""
    _meshes()
    seen = _record_blocks(monkeypatch)
    rs = np.random.RandomState(5)
    arrays = [rs.randn(2, 40, 4, 8).astype(np.float32) for _ in range(3)]
    g = rs.randn(2, 40, 4, 8).astype(np.float32)
    jfn = getattr(jdist, f"{op}_attention")
    tfn = getattr(tdist, f"{op}_attention")
    want, wgrads, jd = _jax_attention(jfn, arrays, g, True)
    out, grads, td = _port_attention(tfn, arrays, g, True)
    assert jd["path"] == "xla" and td["path"] == "kernel"
    assert (td["sl"], td["d"], td["op"]) == (jd["sl"], jd["d"], jd["op"])
    pairs = (sorted((i * 10, j * 10) for i in range(SP) for j in range(SP))
             if op == "ring" else [(0, 0)] * SP)
    assert sorted(seen["fwd"]) == pairs and sorted(seen["bwd"]) == pairs
    _close(out, want, 1e-5)
    for got, w in zip(grads, wgrads):
        _close(got, w, 1e-5)


def test_no_sp_axis_runs_flash_attention(monkeypatch):
    """Without an sp axis both functions are the flash-attention kernels
    (B1) on one device, matching paddle_tpu's plain attention."""
    calls = []
    real = tka.flash_attn_fwd

    def record(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    # the flash_attn operator calls B1's wrapper by its module's name
    monkeypatch.setattr(tka, "flash_attn_fwd", record)
    rs = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rs.randn(1, 32, 2, 8).astype(np.float32))
               for _ in range(3))
    out = tdist.ring_attention(q, k, v, causal=True)
    assert tsp.last_ring_dispatch()["path"] == "flash"
    want = jdist.ring_attention(*(paddle.to_tensor(t.numpy())
                                  for t in (q, k, v)), causal=True)
    _assert_same_dispatch(tsp.last_ring_dispatch(), jax_dispatch())
    _close(out, want.numpy(), 1e-5)
    _close(tdist.ulysses_attention(q, k, v), jdist.ulysses_attention(
        *(paddle.to_tensor(t.numpy()) for t in (q, k, v))).numpy(), 1e-5)
    assert calls == [(1, 2, 32, 8)] * 2


def test_sp_errors():
    tdist.init_mesh({"sp": SP}, devices=CPU4)
    x = torch.zeros(1, 30, 4, 8)
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        tdist.ring_attention(x, x, x)
    y = torch.zeros(1, 32, 6, 8)
    with pytest.raises(ValueError, match="num_heads 6 not divisible"):
        tdist.ulysses_attention(y, y, y)


# --------------------------------------------------------------------- GPT

_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=512)


def test_gpt_sp_train_step_trajectory_matches(monkeypatch):
    """GPT (hidden 64, 2 layers, 4 heads) at seq 512 under sp=4: three
    AdamW TrainStep losses against paddle_tpu's sp=4 trajectory from the
    same weights and batch; the attention goes through the ring's fused
    body on both sides, never through the unsharded flash attention."""
    paddle.seed(7)
    jm = JaxGPT(JaxGPTConfig(**_CFG))
    params = {n: np.asarray(v) for n, v in raw_state(jm)[0].items()}
    ids = np.random.RandomState(0).randint(0, 256, (2, 512)).astype(np.int64)
    _meshes()
    jstep = JaxTrainStep(jm, jm.make_loss_fn(), paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    x = paddle.to_tensor(ids)
    want = [float(jstep(x, x).numpy()) for _ in range(3)]
    assert jax_dispatch()["path"] == "pallas"

    def no_flash(*a, **kw):
        raise AssertionError("the unsharded flash attention ran under sp")
    monkeypatch.setattr(TF, "flash_attention", no_flash)
    tm = load_paddle_tpu_params(
        GPTForCausalLM(GPTConfig(**_CFG), device="cpu", seed=1), params)
    step = TrainStep(tm, tm.make_loss_fn(),
                     AdamW(learning_rate=1e-3, parameters=tm.parameters()))
    t = torch.from_numpy(ids)
    got = [step(t, t).item() for _ in range(3)]
    assert tsp.last_ring_dispatch() == {
        "path": "kernel", "sl": 128, "d": 16, "op": "ring",
        "reason": "B5 ring"}
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert got[-1] < got[0]
