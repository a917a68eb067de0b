"""A live serving tier of the port on the CPU: Router over two replica
processes.

Two ``device="cpu"`` replicas of gpt_tiny behind the slot f32 engine of
tests/test_router.py (slots 2, max_len 48, bucket 8, 2 tokens a tick).
The replicas build their model with the ``factory`` kind: ``tiny_gpt``
below loads weights copied from paddle_tpu's gpt_tiny out of an ``.npz``
this module writes. The top level of this module imports only the port,
numpy and pytest (a replica child imports it to reach ``tiny_gpt``, and
never imports JAX); paddle_tpu is imported inside the fixtures.

Greedy tokens through the tier equal paddle_tpu's direct engine and the
port's on the same weights; the chaos paths run live: an ejected replica
skipped, an injected ``router_forward`` fault retried elsewhere, kill -9
under traffic with clean outcomes, a respawn and a journaled resume equal
to the undisturbed run, a streamed request's failover, a rolling restart
and the truthful 503. The tier is module-scoped.
"""
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu_torch.distributed import resilience as resil
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference.router import (ReplicaSpec, Router,
                                               single_device_child_env)

ENGINE = {"slots": 2, "max_len": 48, "cache_dtype": "float32",
          "prefill_buckets": [8], "tick_tokens": 2}
# (prompt, new tokens): prompts within the one prefill bucket
PROMPTS = [([1, 2, 3, 4], 8), ([5, 6], 4), ([11, 3, 5], 5), ([7, 8, 9], 4),
           ([9, 9, 9], 24), ([4, 4, 4], 6)]


def tiny_gpt(npz, device="cpu"):
    """The replicas' model: the port's gpt_tiny with the weights in
    ``npz`` (paddle_tpu's, by parameter name)."""
    from paddle_tpu_torch.convert import load_paddle_tpu_params
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    model = GPTForCausalLM(gpt_tiny(), device=device, seed=1)
    with np.load(npz) as f:
        load_paddle_tpu_params(model, {k: f[k] for k in f.files})
    return model


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """paddle_tpu's gpt_tiny (seed 0) as an .npz, and its direct engine's
    greedy tokens for every prompt of PROMPTS."""
    import paddle_tpu as paddle
    from paddle_tpu.inference.engine import \
        ContinuousBatchingEngine as JaxEngine
    from paddle_tpu.jit.functional import raw_state
    from paddle_tpu.models import GPTForCausalLM as JaxGPT
    from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    path = str(tmp_path_factory.mktemp("tier_weights") / "gpt_tiny.npz")
    np.savez(path, **{n: np.asarray(v)
                      for n, v in raw_state(jm)[0].items()})
    kw = dict(ENGINE, prefill_buckets=tuple(ENGINE["prefill_buckets"]))
    with pytest.MonkeyPatch.context() as mp:
        # the f32 slot decode through its Pallas kernel (interpreted), as
        # the port's engine runs B4's counterpart
        mp.setenv("PADDLE_TPU_MEGA_DECODE", "1")
        with JaxEngine(jm, **kw) as eng:
            want = {tuple(p): eng.generate(p, max_new_tokens=n).tolist()
                    for p, n in PROMPTS}
    return path, want


@pytest.fixture(scope="module")
def tier(weights):
    env = dict(single_device_child_env("cpu"), OMP_NUM_THREADS="1",
               PADDLE_TPU_CHAOS_ADMIN="1")
    spec = ReplicaSpec({"kind": "factory",
                        "path": "tests.test_torch_port_tier:tiny_gpt",
                        "kwargs": {"npz": weights[0], "device": "cpu"}},
                       ENGINE, warmup=True, drain_s=10.0, seed=0, env=env)
    router = Router(spec, replicas=2, poll_s=0.1, deadline_s=60.0)
    router.start()
    try:
        assert router.wait_ready(2, timeout=120), router.replicas()
        yield router
    finally:
        router.stop()


def _post(url, path, payload, timeout=60):
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _url(router):
    return f"http://{router.host}:{router.port}"


def _gen(router, ids, n, timeout=60):
    return _post(_url(router), "/generate",
                 {"input_ids": ids, "max_new_tokens": n}, timeout)


def _stream(router, ids, n, first=None):
    """A streamed /generate through the tier: its NDJSON events;
    ``first`` is set once the first token block arrived."""
    req = urllib.request.Request(_url(router) + "/generate", json.dumps(
        {"input_ids": ids, "max_new_tokens": n, "stream": True}).encode(),
        {"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        for raw in r:
            if raw.strip():
                events.append(json.loads(raw))
                if first is not None and "t" in events[-1]:
                    first.set()
    return events


def _wait(what, cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _stall_all(router, wedge_s):
    """Arm one ``replica_stall`` on every replica: each one's next decode
    tick sleeps ``wedge_s`` (the request stays mid-decode meanwhile)."""
    for r in router.replicas():
        code, body, _ = _post(f"http://127.0.0.1:{r['port']}",
                              "/admin/inject", {"site": "replica_stall",
                                                "count": 1,
                                                "wedge_s": wedge_s})
        assert code == 200, body


def _owner(router):
    """The one replica with a forward in flight."""
    busy = [r for r in router.replicas() if r["inflight"] > 0]
    return busy[0] if len(busy) == 1 else None


def test_tier_tokens_equal_both_direct_engines(tier, weights):
    path, want = weights
    with ContinuousBatchingEngine(tiny_gpt(path), device="cpu", **dict(
            ENGINE, prefill_buckets=(8,))) as eng:
        port = {tuple(p): eng.generate(p, max_new_tokens=n).tolist()
                for p, n in PROMPTS}
    assert port == want
    served = set()
    for p, n in PROMPTS:
        code, body, _ = _gen(tier, p, n)
        assert code == 200, body
        assert body["tokens"] == want[tuple(p)]
        assert body["tokens_generated"] == n
        served.add(body["served_by"])
    assert served <= {r["name"] for r in tier.replicas()}
    with urllib.request.urlopen(_url(tier) + "/healthz", timeout=10) as r:
        hz = json.loads(r.read())
    assert hz["tier"] and hz["ready_replicas"] == 2
    for rep in tier.replicas():
        with urllib.request.urlopen(f"http://127.0.0.1:{rep['port']}/healthz",
                                    timeout=10) as r:
            assert json.loads(r.read())["compilation"]["nvcc_runs"] == 0
        path = os.path.join(tier.workdir, f"{rep['name']}.log")

        def log():
            with open(path) as f:
                return f.read()
        # the replica logs its ready line within a quarter second
        _wait("the ready line", lambda: "replica ready" in log())
        assert '"nvcc_runs": 0' in log(), log()


def test_ejected_replica_is_skipped(tier, weights):
    victim, survivor = tier._replicas[0], tier._replicas[1]
    victim.ejected_until = time.monotonic() + 30.0
    try:
        for _ in range(3):
            code, body, _ = _gen(tier, [5, 6], 4)
            assert code == 200 and body["served_by"] == survivor.name, body
            assert body["tokens"] == weights[1][(5, 6)]
    finally:
        victim.ejected_until = 0.0


def test_injected_router_forward_is_retried_elsewhere(tier, weights):
    before = tier.stats_counters["retries"]
    with resil.FaultInjector({"router_forward": 1}):
        code, body, _ = _gen(tier, [7, 8, 9], 4)
    assert code == 200, body
    assert body["tokens"] == weights[1][(7, 8, 9)]
    assert tier.stats_counters["retries"] >= before + 1
    for r in tier._replicas:
        r.failure_streak = 0


def test_kill9_mid_traffic_resumes_from_the_journal(tier, weights):
    """kill -9 the replica that owns a request mid-decode, under
    concurrent traffic: every request ends 200 with the undisturbed run's
    tokens (the owned one resumed from its journal on the other replica),
    and the tier respawns back to two."""
    want = weights[1]
    respawns = tier.stats_counters["respawns"]
    recoveries = tier.stats_counters["recoveries"]
    _stall_all(tier, 1.0)
    first, results, errors = threading.Event(), {}, []
    streamed = threading.Thread(target=lambda: results.update(
        s=_stream(tier, [9, 9, 9], 24, first)))
    streamed.start()
    first.wait(timeout=30)
    victim = _owner(tier)
    assert victim is not None, tier.replicas()

    def client(i, p, n):
        try:
            results[i] = _gen(tier, p, n)
        except Exception as e:   # noqa: BLE001 — a reset or hang fails
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i, p, n))
               for i, (p, n) in enumerate(PROMPTS)]
    for t in threads:
        t.start()
    os.kill(victim["pid"], signal.SIGKILL)
    for t in threads + [streamed]:
        t.join(timeout=60)
    assert not errors, errors
    for i, (p, n) in enumerate(PROMPTS):
        code, body, _ = results[i]
        assert code == 200, body
        assert body["tokens"] == want[tuple(p)]
    ev = results["s"]
    done = ev[-1]["done"]
    assert [t for e in ev[:-1] for t in e["t"]] == want[(9, 9, 9)][3:]
    assert done["tokens"] == want[(9, 9, 9)] and done["recovered"] >= 1
    assert tier.stats_counters["recoveries"] >= recoveries + 1
    assert tier.wait_ready(2, timeout=60), tier.replicas()
    assert tier.stats_counters["respawns"] >= respawns + 1
    assert victim["name"] not in {r["name"] for r in tier.replicas()}
    code, body, _ = _gen(tier, [1, 2, 3, 4], 8)
    assert code == 200 and body["tokens"] == want[(1, 2, 3, 4)]


def test_streamed_request_fails_over_byte_exact(tier, weights):
    """A stream whose replica dies mid-decode carries on from the journal
    frontier on the other replica: every token once, in order, then one
    done body with the full sequence."""
    want = weights[1][(4, 4, 4)]
    respawns = tier.stats_counters["respawns"]
    _stall_all(tier, 1.0)
    first, out = threading.Event(), {}
    th = threading.Thread(target=lambda: out.update(
        s=_stream(tier, [4, 4, 4], 6, first)))
    th.start()
    first.wait(timeout=30)
    victim = _owner(tier)
    assert victim is not None, tier.replicas()
    os.kill(victim["pid"], signal.SIGKILL)
    th.join(timeout=60)
    ev = out["s"]
    assert [t for e in ev[:-1] for t in e["t"]] == want[3:]
    assert ev[-1]["done"]["tokens"] == want
    assert ev[-1]["done"]["recovered"] >= 1
    assert ev[-1]["done"]["served_by"] != victim["name"]
    _wait("the respawn", lambda: tier.stats_counters["respawns"]
          > respawns and tier.ready_count() == 2, timeout=60)


def test_rolling_restart_under_traffic(tier, weights):
    want = weights[1][(4, 4, 4)]
    pids = {r["pid"] for r in tier.replicas()}
    stop, bad = threading.Event(), []

    def traffic():
        while not stop.is_set():
            code, body, _ = _gen(tier, [4, 4, 4], 6)
            if code != 200 or body["tokens"] != want:
                bad.append((code, body))
            time.sleep(0.02)

    th = threading.Thread(target=traffic)
    th.start()
    try:
        res = tier.rolling_restart(ready_timeout=60)
    finally:
        stop.set()
        th.join(timeout=60)
    assert res["ok"] and len(res["replaced"]) == 2, res
    assert not bad, bad
    live = tier.replicas()
    assert len(live) == 2 and not {r["pid"] for r in live} & pids
    for r in live:
        with urllib.request.urlopen(f"http://127.0.0.1:{r['port']}/healthz",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["compilation"]["nvcc_runs"] == 0


def test_truthful_503_when_no_replica_admits(tier):
    saved = [(r, r.ejected_until) for r in tier._replicas]
    for r, _ in saved:
        r.ejected_until = time.monotonic() + 30.0
    try:
        code, body, hdr = _gen(tier, [1], 2, timeout=30)
        assert code == 503 and body["error"] == "no_replica_ready", body
        assert float(body["retry_after_s"]) > 0
        assert int(hdr["Retry-After"]) >= 1
    finally:
        for r, prev in saved:
            r.ejected_until = prev
    code, _, _ = _gen(tier, [1], 2)
    assert code == 200
