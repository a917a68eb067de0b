"""paddle_tpu_torch's ``jit.save`` / ``jit.load``, inference predictor and
the predict path of ``PredictorServer``, against paddle_tpu's.

The slice as a whole: an ``ernie_3_tiny`` encoder (vocab 512, hidden 64,
2 layers, 4 heads, relu) saved by paddle_tpu's ``jit.save`` and run by its
``create_predictor``, and the same weights saved by the port's and run by
its predictor, on the CPU, on the same ids: the sequence and pooled
outputs agree within atol 1e-5 (the same f32 operations, sums taken in
other orders by XLA:CPU and PyTorch's CPU kernels). Then the contract of
the predictor, the artifact and the server, which ``tests/test_serve.py``
pins for paddle_tpu.
"""
import json
import os
import pickle
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu.jit.functional import raw_state
from paddle_tpu.models import ErnieModel as JaxErnie
from paddle_tpu.models import ernie_3_tiny as jax_ernie_3_tiny
from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import load_paddle_tpu_params
from paddle_tpu_torch.inference import (Config, ContinuousBatchingEngine,
                                        DataType, PredictorPool,
                                        PredictorServer, create_predictor,
                                        get_num_bytes_of_data_type,
                                        get_version)
from paddle_tpu_torch.models import (ErnieModel, GPTForCausalLM,
                                     ernie_3_tiny, generate, gpt_tiny)

S = 16


def _cpu_config(path):
    cfg = Config(path + ".pdmodel")
    cfg.disable_gpu()
    return cfg


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """paddle_tpu's artifacts of one seeded ernie_3_tiny at ``[1, 16]`` and
    ``[3, 16]`` int64 ids (its export cannot take a dynamic batch here:
    BERT's reshape turns the symbolic batch into an int), the port's
    artifact of the same weights at ``[None, 16]``, and the port's eager
    model."""
    d = tmp_path_factory.mktemp("predictor")
    paddle.seed(0)
    jm = JaxErnie(jax_ernie_3_tiny())
    jm.eval()
    params, _ = raw_state(jm)
    tm = ErnieModel(ernie_3_tiny(), device="cpu", seed=1)
    load_paddle_tpu_params(tm, {n: np.asarray(v) for n, v in params.items()})
    for b in (1, 3):
        paddle.jit.save(jm, str(d / f"jax{b}"), input_spec=[
            paddle.jit.InputSpec([b, S], dtype="int64")],
            platforms=("cpu",))
    jit.save(tm, str(d / "port"),
             input_spec=[jit.InputSpec([None, S], dtype="int64")])
    return str(d / "jax"), str(d / "port"), tm


@pytest.mark.parametrize("batch", [1, 3])
def test_predictor_matches_reference_predictor(saved, batch):
    """paddle_tpu's jit.save + create_predictor and the port's, on the same
    weights and ids: both outputs within 1e-5, at batch 1 and 3 from the
    port's one ``[None, 16]`` program; and equal to the port's eager
    model."""
    jpath, tpath, tm = saved
    ids = np.random.RandomState(batch).randint(0, 512, (batch, S))
    want = jax_create_predictor(
        JaxConfig(f"{jpath}{batch}.pdmodel")).run([ids])
    got = create_predictor(_cpu_config(tpath)).run([ids])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
    with torch.no_grad():
        eager = tm(torch.from_numpy(ids))
    for g, e in zip(got, eager):
        np.testing.assert_array_equal(g, e.numpy())


def test_predictor_handles_and_names(saved):
    _, tpath, tm = saved
    pred = create_predictor(_cpu_config(tpath))
    assert pred.get_input_names() == ["x0"]
    assert pred.get_input_dtype("x0") == "int64"
    with pytest.raises(KeyError):
        pred.get_input_dtype("x1")
    ids = np.arange(2 * S).reshape(2, S) % 512
    h = pred.get_input_handle("x0")
    h.reshape([2, S])
    h.copy_from_cpu(ids)
    assert pred.run() is True
    assert pred.get_output_names() == ["out0", "out1"]
    out = pred.get_output_handle("out1")
    assert out.shape() == [2, 64]
    with torch.no_grad():
        want = tm(torch.from_numpy(ids))[1].numpy()
    np.testing.assert_array_equal(out.copy_to_cpu(), want)
    pred.clear_intermediate_tensor()
    with pytest.raises(RuntimeError, match="run"):
        out.copy_to_cpu()
    pool = PredictorPool(_cpu_config(tpath), size=2)
    assert len(pool) == 2 and pool.retrive(1) is pool.retrieve(1)


def test_artifact_layout(saved):
    """``.pdiparams`` holds paddle_tpu's keys (state by parameter name,
    the input spec) and the program holds no weights."""
    _, tpath, tm = saved
    with open(tpath + ".pdiparams", "rb") as f:
        meta = pickle.load(f)
    assert set(meta) == {"state", "input_spec", "dtypes"}
    assert set(meta["state"]) == {n for n, _ in tm.named_parameters()}
    assert meta["input_spec"] == [(["_dyn0", str(S)], "int64")]
    assert meta["dtypes"] == {}
    with open(tpath + ".pdmodel", "rb") as f:
        program = torch.export.load(f)
    assert not program.state_dict and not program.constants
    assert program.example_inputs is None
    params_bytes = sum(a.nbytes for a in meta["state"].values())
    assert os.path.getsize(tpath + ".pdmodel") < params_bytes


def test_load_is_eval_only_and_bf16_round_trips(saved, tmp_path):
    _, tpath, tm = saved
    layer = jit.load(tpath, device="cpu")
    ids = torch.randint(0, 512, (2, S))
    with torch.no_grad():
        want = tm(ids)
    for g, w in zip(layer(ids.numpy()), want):
        assert torch.equal(g, w)
    assert layer.eval() is layer
    with pytest.raises(RuntimeError, match="inference"):
        layer.train()
    # a bf16 model: stored as 16-bit patterns, named in "dtypes", and the
    # predictor hands its outputs back as float32
    m16 = ErnieModel(ernie_3_tiny(), device="cpu", seed=2).bfloat16()
    m16.train()
    jit.save(m16, str(tmp_path / "b"),
             input_spec=[jit.InputSpec([-1, S], "int64")])
    assert m16.training                  # training mode restored
    with open(str(tmp_path / "b.pdiparams"), "rb") as f:
        assert set(pickle.load(f)["dtypes"].values()) == {"bfloat16"}
    got = create_predictor(_cpu_config(str(tmp_path / "b"))).run(
        [ids.numpy()])
    m16.eval()
    with torch.no_grad():
        want = m16(ids)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w.float().numpy())


def test_save_needs_input_spec(saved):
    _, _, tm = saved
    with pytest.raises(ValueError, match="input_spec"):
        jit.save(tm, "unused")


def test_config_contract(saved, tmp_path):
    _, tpath, _ = saved
    cfg = Config(tpath + ".pdmodel")
    assert cfg.prog_file() == tpath + ".pdmodel"
    assert cfg.params_file() == tpath + ".pdiparams"
    cfg.set_model(str(tmp_path / "m.pdmodel"), str(tmp_path / "p"))
    assert cfg.prog_file() == str(tmp_path / "m.pdmodel")
    assert cfg.params_file() == str(tmp_path / "p")
    assert cfg.model_dir() == str(tmp_path)
    assert cfg.use_gpu()                      # the card by default
    cfg.enable_use_gpu(256, device_id=1)
    assert "cuda:1" in cfg.summary()
    cfg.disable_gpu()
    assert not cfg.use_gpu() and cfg.device() == torch.device("cpu")
    for knob in (cfg.enable_mkldnn, cfg.enable_memory_optim,
                 cfg.switch_ir_optim):
        knob()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfg.enable_int8()
    # the engine predictor is ported: without a live model it refuses as
    # paddle_tpu's does (tests/test_torch_port_serve_tier.py drives it)
    cfg.enable_continuous_batching()
    with pytest.raises(ValueError, match="live model"):
        create_predictor(cfg)
    assert get_num_bytes_of_data_type(DataType.BFLOAT16) == 2
    assert get_num_bytes_of_data_type(DataType.INT64) == 8
    assert "torch" in get_version()


def test_default_device_is_the_card(saved):
    """Without ``disable_gpu`` the predictor runs on the card, and raises
    where there is none."""
    _, tpath, _ = saved
    if torch.cuda.is_available():
        assert create_predictor(Config(tpath)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            create_predictor(Config(tpath))


# ------------------------------------------------------------------ server

def _req(srv, path, payload=None):
    url = f"http://{srv.host}:{srv.port}{path}"
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


@pytest.fixture()
def server(saved):
    _, tpath, tm = saved
    srv = PredictorServer(_cpu_config(tpath), port=0).start()
    yield srv, tm
    srv.stop()


def test_server_metadata_and_predict_match_eager(server):
    srv, tm = server
    code, meta, _ = _req(srv, "/metadata")       # outputs known after a run
    assert code == 200 and meta == {"inputs": ["x0"], "outputs": ["out0"]}
    ids = np.random.RandomState(0).randint(0, 512, (2, S))
    with torch.no_grad():
        want = [t.numpy() for t in tm(torch.from_numpy(ids))]
    # a plain nested list (coerced to the declared int64) and the
    # {"data", "dtype"} form
    for inp in (ids.tolist(), {"data": ids.tolist(), "dtype": "int64"}):
        code, body, _ = _req(srv, "/predict", {"inputs": {"x0": inp}})
        assert code == 200, body
        for name, w in zip(("out0", "out1"), want):
            out = body["outputs"][name]
            assert out["shape"] == list(w.shape) and out["dtype"] == \
                "float32"
            np.testing.assert_array_equal(
                np.asarray(out["data"], dtype=out["dtype"]), w)
    code, meta, _ = _req(srv, "/metadata")
    assert meta == {"inputs": ["x0"], "outputs": ["out0", "out1"]}


def test_server_predict_errors(server):
    srv, _ = server
    code, body, _ = _req(srv, "/predict", {"inputs": {"nope": [[1]]}})
    assert code == 400 and "unknown" in body["error"]
    code, body, _ = _req(srv, "/predict", {"inputs": {}})
    assert code == 400 and "missing" in body["error"]
    code, body, _ = _req(srv, "/predict", {"bad": 1})
    assert code == 400
    code, body, _ = _req(srv, "/generate", {"input_ids": [1, 2]})
    assert code == 404 and "engine" in body["error"]
    code, _, _ = _req(srv, "/nothing")
    assert code == 404
    code, body, _ = _req(srv, "/healthz")
    assert code == 200 and body["status"] == "ready"


def _assert_retry_after(code, body, headers, reason):
    """A 503 naming ``reason`` (a request's ``error``, or /healthz's
    ``status``) with a Retry-After header and ``retry_after_s``."""
    assert code == 503, body
    assert body.get("error", body.get("status")).split(":")[0] == reason, \
        body
    assert float(body["retry_after_s"]) > 0, body
    assert int(headers["Retry-After"]) >= 1, headers


def test_503_overloaded_carries_retry_after(saved):
    _, tpath, _ = saved
    srv = PredictorServer(_cpu_config(tpath), port=0, max_queue=0).start()
    try:
        code, body, hdr = _req(srv, "/predict", {"inputs": {"x0": [[1]]}})
        _assert_retry_after(code, body, hdr, "overloaded")
        code, body, hdr = _req(srv, "/healthz")
        _assert_retry_after(code, body, hdr, "unready")
        assert "queue" in body["reason"]
    finally:
        srv.stop()


def test_503_deadline_carries_retry_after(saved):
    """A wedged predictor: the request gets 503 deadline_exceeded at its
    deadline, the abandoned call keeps its queue slot until it ends, and
    three failures in a row make /healthz unready."""
    _, tpath, _ = saved
    srv = PredictorServer(_cpu_config(tpath), port=0, deadline_s=0.2,
                          max_queue=4).start()
    release = threading.Event()
    real_run = srv.predictor.run

    def wedged_run(*a, **kw):
        release.wait(30)
        return real_run(*a, **kw)

    srv.predictor.run = wedged_run
    try:
        payload = {"inputs": {"x0": np.zeros((1, S), int).tolist()}}
        for _ in range(3):
            code, body, hdr = _req(srv, "/predict", payload)
            _assert_retry_after(code, body, hdr, "deadline_exceeded")
        code, body, hdr = _req(srv, "/healthz")
        _assert_retry_after(code, body, hdr, "unready")
        assert "consecutive" in body["reason"]
        release.set()
        deadline = time.monotonic() + 30
        while srv._depth and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv._depth == 0
        code, body, _ = _req(srv, "/predict", payload)
        assert code == 200, body
        assert srv._failure_streak == 0
    finally:
        release.set()
        srv.stop()


def test_server_needs_a_backend():
    with pytest.raises(ValueError, match="engine"):
        PredictorServer(port=0)


def test_server_with_predictor_and_engine(saved):
    """One server, both paths: /predict on the predictor, /generate on the
    engine given as ``engine=`` (tokens as generate()'s)."""
    _, tpath, tm = saved
    m = GPTForCausalLM(gpt_tiny(), device="cpu", seed=0)
    eng = ContinuousBatchingEngine(m, slots=2, max_len=64,
                                   cache_dtype="float32",
                                   prefill_buckets=(8, 16), tick_tokens=2,
                                   device="cpu")
    srv = PredictorServer(_cpu_config(tpath), port=0, engine=eng).start()
    try:
        prompt = np.random.RandomState(1).randint(0, 256, 9)
        code, body, _ = _req(srv, "/generate", {
            "input_ids": prompt.tolist(), "max_new_tokens": 5})
        assert code == 200, body
        want = generate(m, prompt, 5, cache_dtype="float32")[0]
        assert body["tokens"] == want.tolist()
        code, body, _ = _req(srv, "/predict", {
            "inputs": {"x0": np.ones((1, S), int).tolist()}})
        assert code == 200 and body["outputs"]["out1"]["shape"] == [1, 64]
        code, body, _ = _req(srv, "/healthz")
        assert code == 200 and body["engine"]["slots"] == 2
    finally:
        srv.stop()
        eng.stop()
    eng_only = PredictorServer(engine=ContinuousBatchingEngine(
        m, slots=2, max_len=64, cache_dtype="float32", device="cpu"),
        port=0).start()
    try:
        code, body, _ = _req(eng_only, "/predict", {"inputs": {}})
        assert code == 404 and "predictor" in body["error"]
        code, meta, _ = _req(eng_only, "/metadata")
        assert meta == {"inputs": ["input_ids"], "outputs": ["tokens"]}
    finally:
        eng_only.stop()
        eng_only.engine.stop()
