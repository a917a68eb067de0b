"""paddle_tpu_torch.inference.router's decisions against paddle_tpu's.

Each deterministic scenario of tests/test_router.py (and a few more of
the same kind) runs through paddle_tpu's ``Router`` and the port's, built
by the same ``bare_router`` recipe (a router that never spawned anything,
its HTTP socket bound and unserved) over fake replicas and scripted
stream attempts, with no process started; the two must record the same
decisions: picks, ejections, autoscaler actions, respawn times, the
recovery coordinator's verdicts and bodies, the client relay's NDJSON,
the QoS scheduler's dispatch order and Retry-After hints, the hedge and
TTFT budgets. ``RetryPolicy`` / ``with_retries`` give the same schedules
and sleeps on a fake clock, and a fresh router's ``/metrics`` text is the
same byte for byte.
"""
import io
import json
import os
import random
import subprocess
import threading
import time
import types

import pytest

from paddle_tpu.distributed import resilience as jresil
from paddle_tpu.inference import paging as jpaging
from paddle_tpu.inference import router as jrouter
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu_torch.distributed import resilience as tresil
from paddle_tpu_torch.inference import paging as tpaging
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.obs import metrics as tmetrics

MODEL = {"kind": "gpt", "vocab_size": 128, "hidden_size": 32,
         "num_layers": 1, "num_heads": 2, "max_seq_len": 64}
ENGINE = {"slots": 2, "max_len": 48, "cache_dtype": "float32",
          "prefill_buckets": [8], "tick_tokens": 2}

SIDES = {"paddle_tpu": types.SimpleNamespace(
             router=jrouter, resil=jresil, paging=jpaging, metrics=jmetrics),
         "port": types.SimpleNamespace(
             router=trouter, resil=tresil, paging=tpaging, metrics=tmetrics)}


def _bare(m, tmp_path, **kw):
    """tests/test_router.py's ``bare_router`` recipe on module set ``m``."""
    spec = m.router.ReplicaSpec(MODEL, ENGINE,
                                env=m.router.single_device_child_env())
    args = dict(replicas=2, min_replicas=1, max_replicas=3, poll_s=0.1,
                workdir=str(tmp_path), scale_cycles=2, scale_cooldown_s=0.0)
    args.update(kw)
    return m.router.Router(spec, **args)


class _FakeProc:
    pid = 0

    def __init__(self, alive=True):
        self._alive = alive

    def poll(self):
        return None if self._alive else 1


def _fake(m, name, state="ready", inflight=0, queued=0, ejected_for=0.0,
          draining=False, alive=True):
    r = m.router.Replica(name, _FakeProc(alive), f"/nonexistent/{name}.port",
                         f"/nonexistent/{name}.log", "127.0.0.1")
    r.port = 1
    r.state = state
    r.inflight = inflight
    r.draining = draining
    r.health = {"engine": {"queued": queued, "active": 0}}
    if ejected_for:
        r.ejected_until = time.monotonic() + ejected_for
    return r


def _name(rep):
    return None if rep is None else rep.name


def _scripted(script):
    """A ``_StreamAttempt`` stand-in running ``script[seq]`` in the attempt
    thread (the attributes the coordinator reads, as the real one's)."""

    class Scripted(threading.Thread):
        made = []

        def __init__(self, router, rep, st, base, deadline_at, is_hedge,
                     seq):
            super().__init__(daemon=True)
            self.router, self.rep, self.j = router, rep, st
            self.base, self.is_hedge = int(base), bool(is_hedge)
            self.rid = f"scripted.{seq}"
            self.status = "running"
            self.reaped = False
            self.kind = None
            self.reason = ""
            self.code = 0
            self.body = None
            self.retry_after = None
            self.done_body = None
            self.streamed = True
            self.got = 0
            self._behave = script[min(seq, len(script) - 1)]
            Scripted.made.append(self)

        def run(self):
            try:
                self._behave(self)
            except Exception as e:   # noqa: BLE001 — surface as a failure
                self.kind = "io"
                self.reason = f"scripted: {e}"
                self.status = "failed"
            with self.j.cond:
                self.j.cond.notify_all()

        def cancel(self):
            pass
    return Scripted


def _finish(a, prompt, full_new):
    a.j.extend(a.base, full_new[a.base:], a.rep.name)
    a.got = len(full_new) - a.base
    a.done_body = {"tokens": list(prompt) + list(full_new),
                   "prompt_len": len(prompt) + a.base,
                   "new_tokens": len(full_new) - a.base,
                   "tokens_generated": len(full_new) - a.base,
                   "request_id": a.rid}
    a.status = "done"


class _FakeStreamHandler:
    def __init__(self, wfile=None):
        self.wfile = wfile if wfile is not None else io.BytesIO()
        self.status = None
        self.sent_headers = {}
        self.close_connection = False

    def send_response(self, code):
        self.status = code

    def send_header(self, k, v):
        self.sent_headers[k] = v

    def end_headers(self):
        pass


class _ExplodingFile:
    def write(self, b):
        raise BrokenPipeError("client went away")

    def flush(self):
        pass


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# routing scenarios: each returns a JSON-able record of its decisions
# ---------------------------------------------------------------------------

def sc_pick_skips(m, r, mp):
    ready = _fake(m, "ready1")
    r._replicas = [_fake(m, "warm1", state="warming"),
                   _fake(m, "eject1", ejected_for=30.0),
                   _fake(m, "drain1", draining=True),
                   _fake(m, "unready1", state="unready"),
                   _fake(m, "unreach1", state="unreachable"),
                   _fake(m, "dead1", alive=False), ready]
    return {"picks": [_name(r._pick(set())) for _ in range(5)],
            "excluded": _name(r._pick({"ready1"})),
            "routable": [x.routable(time.monotonic()) for x in r._replicas]}


def sc_pick_least_loaded(m, r, mp):
    a = _fake(m, "a", inflight=2)
    b = _fake(m, "b", inflight=0, queued=1)
    c = _fake(m, "c", inflight=0, queued=4)
    r._replicas = [a, b, c]
    first = _name(r._pick(set()))
    b.inflight = 5
    return {"first": first, "then": _name(r._pick(set())),
            "scores": [list(x.load_score()) for x in r._replicas]}


def sc_pick_prefix_affinity(m, r, mp):
    prompt = list(range(12))
    hashes = m.paging.chain_hashes(prompt, 4)
    warm = _fake(m, "warm", inflight=1)
    warm.prefix_fps = frozenset(hashes)
    cold = _fake(m, "cold", inflight=0)
    r._replicas = [cold, warm]
    out = {"hashes": hashes, "load_only": _name(r._pick(set())),
           "affinity": _name(r._pick(set(), hashes))}
    broken = _fake(m, "broken", inflight=0)
    broken.prefix_fps = frozenset(hashes[1:])
    r._replicas = [broken, warm]
    out["broken_chain"] = _name(r._pick(set(), hashes))
    r.affinity_w = 0.0
    r._replicas = [cold, warm]
    out["affinity_off"] = _name(r._pick(set(), hashes))
    return out


def sc_circuit_breaker(m, r, mp):
    rep = _fake(m, "r")
    r._replicas = [rep]
    out = {"threshold": r.breaker_threshold, "eject_s": r.eject_s}
    for _ in range(r.breaker_threshold - 1):
        r._note_failure(rep)
    out["under_streak"] = _name(r._pick(set()))
    r._note_failure(rep)
    out.update(ejected=rep.ejected_until > time.monotonic(),
               while_ejected=_name(r._pick(set())),
               ejections=r.stats_counters["ejections"],
               streak_after=rep.failure_streak)
    rep.ejected_until = 0.0
    out["after_cooldown"] = _name(r._pick(set()))
    return out


def sc_autoscale_up_down(m, r, mp):
    spawned, retired = [], []
    r._spawn_replica = lambda: spawned.append(1)
    r._terminate = lambda rep, drain_timeout=0.0: retired.append(
        (rep.name, drain_timeout))
    busy = [_fake(m, "a", queued=3), _fake(m, "b", queued=2)]
    r._replicas = list(busy)
    r._autoscale()
    out = {"after_one": len(spawned)}
    r._autoscale()
    out.update(after_two=len(spawned), scale_ups=r.stats_counters["scale_ups"])
    for x in busy:
        x.health = {"engine": {"queued": 0, "active": 0}}
    busy[1].spawned_at = busy[0].spawned_at + 1
    r._autoscale()
    r._autoscale()
    _wait(lambda: retired)
    out.update(retired=retired, scale_downs=r.stats_counters["scale_downs"],
               scale_up_queued=r.scale_up_queued)
    return out


def sc_autoscale_cooldown(m, r, mp):
    r.scale_cooldown_s = 3600.0
    r._last_scale = time.monotonic()
    spawned = []
    r._spawn_replica = lambda: spawned.append(1)
    r._replicas = [_fake(m, "a", queued=9)]
    for _ in range(5):
        r._autoscale()
    return {"spawned": len(spawned), "up_streak": r._up_streak}


def sc_trim_surplus(m, r, mp):
    retired = []
    r._terminate = lambda rep, drain_timeout=0.0: retired.append(rep.name)
    reps = [_fake(m, n) for n in ("a", "b", "c", "d")]
    for i, x in enumerate(reps):
        x.spawned_at = 100.0 + i
    r._replicas = reps
    r._trim_surplus()
    _wait(lambda: retired)
    return {"retired": retired}


def sc_governor_escalates(m, r, mp):
    now = [100.0]
    gov = m.router.RespawnGovernor(
        budget=3, window_s=10.0,
        policy=m.resil.RetryPolicy(max_attempts=8, base_delay=1.0,
                                   multiplier=2.0, max_delay=8.0,
                                   jitter=0.0),
        clock=lambda: now[0])
    out = [gov.note_death(0.5, became_ready=False) for _ in range(5)]
    gov.note_stable()
    out.append(gov.note_death(0.5, became_ready=False))
    return {"spawn_at": out, "streak": gov.streak}


def sc_governor_slow_death(m, r, mp):
    gov = m.router.RespawnGovernor(budget=2, window_s=5.0,
                                   clock=lambda: 50.0)
    gov.note_death(0.1, became_ready=False)
    gov.note_death(0.1, became_ready=False)
    streak = gov.streak
    return {"streak": streak,
            "slow": gov.note_death(3600.0, became_ready=True),
            "after": gov.streak, "schedule": list(gov.policy.schedule())}


def sc_governor_never_ready(m, r, mp):
    gov = m.router.RespawnGovernor(budget=1, window_s=5.0, clock=lambda: 0.0)
    first = gov.note_death(600.0, became_ready=False)
    return {"first": first, "streak": gov.streak,
            "second": gov.note_death(600.0, became_ready=False)}


def sc_crash_loops_in_stats(m, r, mp):
    r._replicas = [_fake(m, "a", queued=2), _fake(m, "b", state="warming")]
    body = r.stats()
    ok, hz = r._readiness()
    keep = ("status", "tier", "replicas_total", "ready_replicas",
            "min_replicas", "max_replicas", "rolling_restart_in_progress",
            "queued_total", "active_total", "inflight_total", "qos",
            "stats")
    return {"crash_loops": body["stats"]["crash_loops"],
            "body": {k: body[k] for k in keep}, "ready": ok,
            "replicas": [{k: v for k, v in x.items()
                          if k not in ("pid", "last_scrape_age_s")}
                         for x in hz["replicas"]]}


def sc_hedge_budget(m, r, mp):
    r.hedge_frac = 0.25
    r._journaled = 20
    grabbed = 0
    while r._reserve_hedge() and grabbed < 50:
        grabbed += 1
    r._release_hedge()
    again = r._reserve_hedge()
    r._hedges_live = 0
    r._journaled = 1
    return {"grabbed": grabbed, "again": again,
            "lone": [r._reserve_hedge(), r._reserve_hedge()]}


def sc_hedge_budget_derivation(m, r, mp):
    out = {}
    for hs in (0.0, 1.5, -1.0):
        r.hedge_s = hs
        out[str(hs)] = r._hedge_budget()
    for v in [3.0] * 40:              # a warm tier: 20 x the p99 of gaps
        r._m_progress.observe(v)
    out["derived"] = r._hedge_budget()
    return out


def sc_retry_after_hint(m, r, mp):
    f = m.router._retry_after_hint
    return [f(b) for b in ({"retry_after_s": 2.5}, {"retry_after_s": "3"},
                           {}, {"retry_after_s": "soon"},
                           {"retry_after_s": None}, {"retry_after_s": [1]})]


def sc_flatten_ids(m, r, mp):
    f = m.router._flatten_ids
    return [f(v) for v in ([1, 2, 3], [[1, 2], [3]], [], [True, 1], "ab",
                           [1.5], [[4]])]


def sc_single_shot_503(m, r, mp):
    """Opaque payloads take the single-shot path: with no replica the
    tier answers the truthful no_replica_ready 503."""
    code, body, ra = r.forward_generate(
        json.dumps({"prompt": "opaque"}).encode(), deadline_s=2.0)
    return {"code": code, "body": body, "ra": ra,
            "stats": r.stats_counters["tier_unavailable_503"]}


def sc_journal_extend(m, r, mp):
    j = m.router._ReqJournal([1, 2], 5, 9, 0, "rid")
    out = [j.extend(0, [3, 4], "a"), j.extend(1, [4, 5], "b"),
           j.extend(0, [3, 7], "c"), j.size(), j.mismatched]
    j2 = m.router._ReqJournal([1], 4, 6, 0, None)
    out += [j2.extend(0, [2], "a"), j2.extend(2, [3], "a"), j2.mismatched]
    j3 = m.router._ReqJournal([1], 4, 6, 0, "x")
    j3.extend(0, [2, 6], "z")
    out += [j3.complete(), j3.synthesize_body()]
    return out


# ---------------------------------------------------------------------------
# recovery and stream scenarios (scripted attempts)
# ---------------------------------------------------------------------------

def sc_coordinator_relaunch(m, r, mp):
    r.hedge_s = 0.0
    prompt, full = [1, 2, 3], [11, 12, 13, 14]
    rep = _fake(m, "fr")
    picks = {"n": 0}

    def pick(exclude):
        picks["n"] += 1
        return None if 2 <= picks["n"] <= 6 else rep

    mp.setattr(r, "_pick", pick)

    def die_with_progress(a):
        a.j.extend(0, full[:2], a.rep.name)
        a.kind, a.reason = "io", "stream truncated"
        a.status = "failed"

    def resume(a):
        assert a.base == 2
        _finish(a, prompt, full)

    cls = _scripted([die_with_progress, resume])
    mp.setattr(m.router, "_StreamAttempt", cls)
    t0 = time.monotonic()
    code, body, ra = r._forward_recovering(prompt, 4, None, 0, 8.0,
                                           "rid-gap", t0)
    return {"code": code, "body": body, "ra": ra,
            "picks_ge_7": picks["n"] >= 7,
            "bases": [a.base for a in cls.made],
            "in_time": time.monotonic() - t0 < 6.0,
            "recoveries": r.stats_counters["recoveries"],
            "retries": r.stats_counters["retries"]}


def sc_token_mismatch(m, r, mp):
    r.hedge_s = 0.0
    prompt, full = [7, 8], [21, 22, 23]
    rep = _fake(m, "fr")
    mp.setattr(r, "_pick", lambda exclude: rep)

    def mismatch_after_progress(a):
        a.j.extend(0, full[:2], a.rep.name)
        a.kind, a.reason = "mismatch", "token mismatch vs journal"
        a.status = "failed"

    def rerun(a):
        _finish(a, prompt, full)

    cls = _scripted([mismatch_after_progress, rerun])
    mp.setattr(m.router, "_StreamAttempt", cls)
    code, body, _ = r._forward_recovering(prompt, 3, None, 0, 8.0,
                                          "rid-mm", time.monotonic())
    return {"code": code, "body": body, "bases": [a.base for a in cls.made],
            "fallbacks": r.stats_counters["resume_fallbacks"]}


def sc_sampling_never_seeds(m, r, mp):
    r.hedge_s = 0.0
    r.spec.engine["do_sample"] = True
    prompt, full = [4, 5], [31, 32]
    rep = _fake(m, "fr")
    mp.setattr(r, "_pick", lambda exclude: rep)

    def die_with_progress(a):
        a.j.extend(0, full[:1], a.rep.name)
        a.kind, a.reason = "io", "stream truncated"
        a.status = "failed"

    def rerun(a):
        _finish(a, prompt, full)

    cls = _scripted([die_with_progress, rerun])
    mp.setattr(m.router, "_StreamAttempt", cls)
    try:
        code, body, _ = r._forward_recovering(prompt, 2, None, 0, 8.0,
                                              "rid-samp", time.monotonic())
    finally:
        r.spec.engine.pop("do_sample", None)
    return {"code": code, "body": body, "bases": [a.base for a in cls.made]}


def sc_resume_rejected_falls_back(m, r, mp):
    """A replica that 400s a RESUMED prompt: the coordinator reruns from
    scratch (the journal verifies instead of seeding)."""
    r.hedge_s = 0.0
    prompt, full = [3, 3], [41, 42, 43]
    rep = _fake(m, "fr")
    mp.setattr(r, "_pick", lambda exclude: rep)

    def die_with_progress(a):
        a.j.extend(0, full[:2], a.rep.name)
        a.kind, a.reason = "io", "stream truncated"
        a.status = "failed"

    def reject_resume(a):
        a.kind, a.code, a.body = "client_error", 400, {"error": "too long"}
        a.status = "failed"

    def rerun(a):
        _finish(a, prompt, full)

    cls = _scripted([die_with_progress, reject_resume, rerun])
    mp.setattr(m.router, "_StreamAttempt", cls)
    code, body, _ = r._forward_recovering(prompt, 3, None, 0, 8.0,
                                          "rid-rej", time.monotonic())
    return {"code": code, "body": body, "bases": [a.base for a in cls.made],
            "fallbacks": r.stats_counters["resume_fallbacks"]}


def sc_journal_complete_synthesizes(m, r, mp):
    """The replica died after its last token, before ``done``: the body
    is synthesised from the journal (eos-padded)."""
    r.hedge_s = 0.0
    prompt = [2, 9]
    rep = _fake(m, "fr")
    mp.setattr(r, "_pick", lambda exclude: rep)

    def all_tokens_then_die(a):
        a.j.extend(0, [5, 7], a.rep.name)
        a.kind, a.reason = "io", "stream truncated"
        a.status = "failed"

    cls = _scripted([all_tokens_then_die])
    mp.setattr(m.router, "_StreamAttempt", cls)
    code, body, _ = r._forward_recovering(prompt, 4, 7, 0, 8.0, "rid-syn",
                                          time.monotonic())
    return {"code": code, "body": body}


def sc_stream_failover_splice(m, r, mp):
    r.hedge_s = 0.0
    r.ttft_hedge_s = 0.0
    prompt, full = [1, 2, 3], [41, 42, 43, 44, 45]
    rep = _fake(m, "fr")
    mp.setattr(r, "_pick", lambda exclude: rep)

    def die_with_progress(a):
        a.j.extend(0, full[:3], a.rep.name)
        time.sleep(0.1)
        a.kind, a.reason = "io", "stream truncated"
        a.status = "failed"

    def resume(a):
        _finish(a, prompt, full)

    cls = _scripted([die_with_progress, resume])
    mp.setattr(m.router, "_StreamAttempt", cls)
    h = _FakeStreamHandler()
    relay = m.router._ClientRelay(h, "rid-stream")
    code, body, _ = r._forward_recovering(prompt, 5, None, 0, 8.0,
                                          "rid-stream", time.monotonic(),
                                          relay=relay)
    lines = [json.loads(ln) for ln in h.wfile.getvalue().splitlines()]
    return {"code": code, "status": h.status, "headers": h.sent_headers,
            "streamed": [t for ln in lines if "t" in ln for t in ln["t"]],
            "done": [ln["done"] for ln in lines if "done" in ln],
            "last_is_done": "done" in lines[-1],
            "bases": [a.base for a in cls.made],
            "streams": r.stats_counters["streams"]}


def sc_stream_error_record(m, r, mp):
    r.hedge_s = 0.0
    r.ttft_hedge_s = 0.0
    prompt, full = [5, 5], [71, 72, 73, 74]

    def die_then_nothing(a):
        a.j.extend(0, full[:2], a.rep.name)
        a.kind, a.reason = "io", "stream truncated"
        a.status = "failed"

    rep = _fake(m, "fr")
    picks = {"n": 0}

    def pick(exclude):
        picks["n"] += 1
        return rep if picks["n"] == 1 else None

    mp.setattr(r, "_pick", pick)
    mp.setattr(m.router, "_StreamAttempt", _scripted([die_then_nothing]))
    h = _FakeStreamHandler()
    relay = m.router._ClientRelay(h, "rid-err")
    code, body, ra = r._forward_recovering(prompt, 4, None, 0, 1.0,
                                           "rid-err", time.monotonic(),
                                           relay=relay)
    lines = [json.loads(ln) for ln in h.wfile.getvalue().splitlines()]
    return {"code": code, "body": body, "ra": ra,
            "streamed": [t for ln in lines if "t" in ln for t in ln["t"]],
            "err": lines[-1].get("err")}


def sc_stream_disconnect(m, r, mp):
    r.hedge_s = 0.0
    r.ttft_hedge_s = 0.0
    prompt, full = [9, 9], [51, 52, 53, 54]

    def progress_then_linger(a):
        a.j.extend(0, full[:2], a.rep.name)

    rep = _fake(m, "fr")
    mp.setattr(r, "_pick", lambda exclude: rep)
    cls = _scripted([progress_then_linger])
    cancelled = []
    cls.cancel = lambda self: cancelled.append(self.rid)
    mp.setattr(m.router, "_StreamAttempt", cls)
    h = _FakeStreamHandler(wfile=_ExplodingFile())
    relay = m.router._ClientRelay(h, "rid-gone")
    code, body, ra = r._forward_recovering(prompt, 4, None, 0, 8.0,
                                           "rid-gone", time.monotonic(),
                                           relay=relay)
    _wait(lambda: cancelled)
    return {"code": code, "body": body, "ra": ra, "cancelled": cancelled,
            "disconnects": r.stats_counters["client_disconnects"]}


def sc_stream_refusals_plain_json(m, r, mp):
    h = _FakeStreamHandler()
    relay = m.router._ClientRelay(h, None)
    payload = json.dumps({"prompt": "opaque", "stream": True}).encode()
    first = r.forward_generate(payload, deadline_s=2.0, relay=relay)
    out = {"first": list(first), "started": relay.started_http,
           "status": h.status}
    r.recovery = False
    h2 = _FakeStreamHandler()
    relay2 = m.router._ClientRelay(h2, None)
    out["journal_off"] = list(r.forward_generate(payload, deadline_s=2.0,
                                                 relay=relay2))
    out["started2"] = relay2.started_http
    return out


# ---------------------------------------------------------------------------
# QoS scenarios
# ---------------------------------------------------------------------------

def _queue_up(s, clients):
    threads = []
    for fn in clients:
        th = threading.Thread(target=fn)
        th.start()
        threads.append(th)
        _wait(lambda: s.snapshot()["waiting"] >= len(threads))
    return threads


def sc_qos_strict_priority(m, r, mp):
    s = m.router._QosScheduler(capacity=1, queue_limit=8, starvation_s=60.0)
    first = s.try_acquire("seed", "standard", 5.0)
    order = []

    def client(tenant, qcls):
        def run():
            s.try_acquire(tenant, qcls, 30.0)
            order.append(tenant)
            s.release(tenant, qcls, tokens=0)
        return run

    threads = _queue_up(s, [client("tb", "batch"), client("ts", "standard"),
                            client("ti", "interactive")])
    snap = s.snapshot()
    s.release("seed", "standard", tokens=0)
    for th in threads:
        th.join(timeout=10)
    return {"first": list(first), "order": order,
            "waiting_by_class": snap["waiting_by_class"]}


def sc_qos_token_charge(m, r, mp):
    s = m.router._QosScheduler(capacity=1, queue_limit=8, starvation_s=60.0)
    s.try_acquire("hog", "standard", 1.0)
    s.release("hog", "standard", tokens=1000)
    s.try_acquire("seed", "standard", 1.0)
    order = []

    def client(tenant):
        def run():
            s.try_acquire(tenant, "standard", 30.0)
            order.append(tenant)
            s.release(tenant, "standard", tokens=0)
        return run

    threads = _queue_up(s, [client("hog"), client("sipper")])
    s.release("seed", "standard", tokens=0)
    for th in threads:
        th.join(timeout=10)
    return {"order": order, "charge": dict(sorted(s._charge.items()))}


def sc_qos_starvation_aging(m, r, mp):
    now = [0.0]
    s = m.router._QosScheduler(capacity=1, queue_limit=8, starvation_s=5.0,
                               clock=lambda: now[0])
    s.try_acquire("seed", "standard", 1.0)
    order = []

    def client(tenant, qcls):
        def run():
            s.try_acquire(tenant, qcls, 9999.0)
            order.append(tenant)
            s.release(tenant, qcls, tokens=0)
        return run

    threads = _queue_up(s, [client("old-batch", "batch")])
    now[0] += 6.0
    threads += _queue_up(s, [client("fresh-i", "interactive")])[-1:]
    _wait(lambda: s.snapshot()["waiting"] >= 2)
    s.release("seed", "standard", tokens=0)
    for th in threads:
        th.join(timeout=10)
    return {"order": order}


def sc_qos_retry_after(m, r, mp):
    now = [0.0]
    s = m.router._QosScheduler(capacity=1, queue_limit=1, starvation_s=60.0,
                               clock=lambda: now[0])
    for _ in range(3):
        s.try_acquire("t", "standard", 1.0)
        now[0] += 0.5
        s.release("t", "standard", tokens=4)
    drain = s.snapshot()["drain_per_s"]
    s.try_acquire("t", "standard", 1.0)
    done = threading.Event()

    def blocked_batch():
        s.try_acquire("b1", "batch", 9999.0)
        s.release("b1", "batch", tokens=0)
        done.set()

    th = threading.Thread(target=blocked_batch)
    th.start()
    _wait(lambda: s.snapshot()["waiting"] >= 1)
    shed = s.try_acquire("b2", "batch", 5.0)
    timeout = s.try_acquire("i1", "interactive", 0.0)
    snap = s.snapshot()
    s.release("t", "standard", tokens=0)
    done.wait(timeout=10)
    th.join(timeout=10)
    return {"drain": drain, "shed": list(shed), "timeout": list(timeout),
            "snap": snap}


def sc_qos_forward_shed(m, r, mp):
    r.qos = m.router._QosScheduler(capacity=1, queue_limit=1,
                                   starvation_s=60.0)
    r.qos.try_acquire("seed", "standard", 1.0)

    def pay(tenant, qcls):
        return json.dumps({"input_ids": [1], "max_new_tokens": 1,
                           "tenant": tenant, "qos_class": qcls}).encode()

    results = []
    th = threading.Thread(target=lambda: results.append(
        r.forward_generate(pay("t1", "batch"), deadline_s=30.0)))
    th.start()
    _wait(lambda: r.qos.snapshot()["waiting"] >= 1)
    shed = r.forward_generate(pay("t2", "batch"), deadline_s=5.0)
    interactive = r.forward_generate(pay("t3", "interactive"),
                                     deadline_s=0.0)
    r.qos.release("seed", "standard", tokens=0)
    th.join(timeout=15)
    snap = r.qos.snapshot()
    return {"shed": [shed[0], shed[1], shed[2] is not None and shed[2] > 0],
            "interactive": [interactive[0], interactive[1]],
            "queued": [results[0][0], results[0][1]],
            "inflight": snap["inflight"], "waiting": snap["waiting"],
            "stats": {k: r.stats_counters[k] for k in (
                "qos_shed", "qos_admitted", "deadline_503",
                "tier_unavailable_503")}}


def sc_ttft_budget(m, r, mp):
    out = {}
    for v in (0, 1.5, -1.0):
        r.ttft_hedge_s = v
        out[str(v)] = r._ttft_budget()
    for v in [40.0] * 40:             # a warm tier: 3 x the p99 TTFT
        r._m_ttft.observe(v)
    out["derived"] = r._ttft_budget()
    return out


def sc_ttft_hedge(m, r, mp):
    r.hedge_s = 0.0
    r.ttft_hedge_s = 0.15
    prompt, full = [2, 2], [61, 62]
    reps = [_fake(m, "p"), _fake(m, "h")]

    def pick(exclude, prompt_hashes=None):
        for rep in reps:
            if rep.name not in exclude:
                return rep
        return None

    mp.setattr(r, "_pick", pick)

    def wedged_prefill(a):
        time.sleep(1.0)

    def hedged(a):
        _finish(a, prompt, full)

    cls = _scripted([wedged_prefill, hedged])
    mp.setattr(m.router, "_StreamAttempt", cls)
    t0 = time.monotonic()
    code, body, _ = r._forward_recovering(prompt, 2, None, 0, 8.0,
                                          "rid-ttft", t0)
    return {"code": code, "body": body,
            "hedge_flags": [a.is_hedge for a in cls.made],
            "in_time": time.monotonic() - t0 < 4.0,
            "stats": {k: r.stats_counters[k] for k in (
                "ttft_hedges", "hedges", "hedge_wins")},
            "primary_streak": reps[0].failure_streak}


ROUTER_SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
                    if name.startswith("sc_")}


@pytest.fixture
def fresh_registries(monkeypatch):
    """A fresh metrics registry in both packages, so that each router
    registers its families on an empty one (and histograms start
    empty)."""
    for m in SIDES.values():
        monkeypatch.setattr(m.metrics, "registry", m.metrics.Registry())


@pytest.mark.parametrize("scenario", sorted(ROUTER_SCENARIOS))
def test_router_decisions_match_reference(scenario, tmp_path, monkeypatch,
                                          fresh_registries):
    got = {}
    for side, m in SIDES.items():
        r = _bare(m, tmp_path / side)
        try:
            with monkeypatch.context() as mp:
                got[side] = json.loads(json.dumps(
                    ROUTER_SCENARIOS[scenario](m, r, mp), default=list))
        finally:
            r.httpd.server_close()
    assert got["port"] == got["paddle_tpu"]


# ---------------------------------------------------------------------------
# RetryPolicy / with_retries on a fake clock
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0
        self.slept = []

    def __call__(self):
        return self.t

    def sleep(self, d):
        self.slept.append(round(d, 9))
        self.t += d


class _Shed(Exception):
    def __init__(self, ra):
        super().__init__("shed")
        self.retry_after_s = ra


def _run(m, fails, exc=lambda i: RuntimeError(f"boom {i}"), run_kw=None,
         **kw):
    """Fail ``fails`` times, then return; record the calls, the sleeps and
    the outcome."""
    clock = _Clock()
    pol = m.resil.RetryPolicy(clock=clock, sleep_fn=clock.sleep, **kw)
    calls, retries = [], []

    def fn(x, y=0):
        calls.append(clock.t)
        if len(calls) <= fails:
            raise exc(len(calls))
        return x + y

    try:
        out = ("ok", pol.run(fn, 2, y=3, on_retry=lambda a, e: retries.append(
            (a, str(e))), **(run_kw or {})))
    except Exception as e:   # noqa: BLE001 — the outcome is the record
        out = ("raised", type(e).__name__, str(e))
    return {"out": list(out), "calls": calls, "slept": clock.slept,
            "retries": retries, "schedule": list(pol.schedule())}


RETRY_CASES = {
    "default_schedule": lambda m: list(m.resil.RetryPolicy().schedule()),
    "schedule_capped": lambda m: [
        list(m.resil.RetryPolicy(max_attempts=7, base_delay=0.1,
                                 multiplier=3.0, max_delay=1.0).schedule()),
        m.resil.RetryPolicy(base_delay=0.2).delay(3)],
    "succeeds_after_two": lambda m: _run(m, 2, jitter=0.0, base_delay=0.5),
    "exhausts_attempts": lambda m: _run(m, 9, jitter=0.0, max_attempts=4),
    "deadline_budget": lambda m: _run(m, 9, jitter=0.0, max_attempts=10,
                                      base_delay=1.0, deadline=2.5),
    "per_call_deadline": lambda m: _run(m, 9, jitter=0.0, max_attempts=10,
                                        base_delay=1.0,
                                        run_kw={"deadline": 1.5}),
    "retry_after_hint": lambda m: _run(
        m, 3, exc=lambda i: _Shed([0.25, "x", 7.0][i - 1]), jitter=0.0,
        max_attempts=5, base_delay=1.0, deadline=5.0),
    "retry_on_filters": lambda m: _run(
        m, 1, exc=lambda i: KeyError("k"), jitter=0.0,
        retry_on=(ValueError,)),
    "full_jitter_draws": lambda m: (random.seed(7), _run(
        m, 4, max_attempts=5, base_delay=1.0, full_jitter=True))[1],
    "band_jitter_draws": lambda m: (random.seed(7), _run(
        m, 3, max_attempts=4, base_delay=1.0, jitter=0.5))[1],
}


def _with_retries(m):
    clock = _Clock()
    pol = m.resil.RetryPolicy(max_attempts=3, base_delay=0.1, jitter=0.0,
                              clock=clock, sleep_fn=clock.sleep)
    n = [0]

    def fn(a):
        n[0] += 1
        if n[0] < 3:
            raise ValueError("again")
        return a * 2
    return [m.resil.with_retries(fn, 21, policy=pol), n[0], clock.slept]


def _invalid(m):
    out = []
    for kw in ({"max_attempts": 0}, {"multiplier": 0.5}, {"jitter": 1.5}):
        try:
            m.resil.RetryPolicy(**kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    try:
        m.resil.RetryPolicy().delay(0)
    except ValueError as e:
        out.append(str(e))
    return out


RETRY_CASES["with_retries"] = _with_retries
RETRY_CASES["invalid_arguments"] = _invalid


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_retry_policy_matches_reference(case):
    got = {side: json.loads(json.dumps(RETRY_CASES[case](m)))
           for side, m in SIDES.items()}
    assert got["port"] == got["paddle_tpu"]


def test_retry_policy_from_env_matches_reference(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RETRY_MAX_ATTEMPTS", "6")
    monkeypatch.setenv("PADDLE_TPU_RETRY_BASE_DELAY", "0.3")
    monkeypatch.setenv("PADDLE_TPU_RETRY_MAX_DELAY", "garbage")
    monkeypatch.setenv("PADDLE_TPU_RETRY_DEADLINE", "9.5")
    got = {}
    for side, m in SIDES.items():
        p = m.resil.RetryPolicy.from_env(jitter=0.0, max_delay=4.0)
        got[side] = (p.max_attempts, p.base_delay, p.max_delay, p.deadline,
                     p.jitter, p.schedule())
    assert got["port"] == got["paddle_tpu"] == (
        6, 0.3, 4.0, 9.5, 0.0, (0.3, 0.6, 1.2, 2.4, 4.0))


# ---------------------------------------------------------------------------
# the router's metrics and the surface that is not ported
# ---------------------------------------------------------------------------

def _router_families(reg):
    return {n: (f.kind, f.help, getattr(f, "buckets", None))
            for n, f in reg._families.items()
            if n.startswith(("ptpu_router_", "ptpu_tier_"))}


def test_router_metrics_equal_reference(tmp_path, fresh_registries):
    """A fresh router registers paddle_tpu's ptpu_router_* and ptpu_tier_*
    families (names, help, kinds, buckets), and its /metrics text (no
    replica to scrape) is the same byte for byte."""
    text, fams = {}, {}
    for side, m in SIDES.items():
        r = _bare(m, tmp_path / side)
        try:
            text[side] = r.render_metrics()
            fams[side] = _router_families(m.metrics.registry)
        finally:
            r.httpd.server_close()
    assert fams["port"] == fams["paddle_tpu"]
    assert sum(n.startswith("ptpu_router_") for n in fams["port"]) == 17
    assert text["port"] == text["paddle_tpu"]
    assert "# TYPE ptpu_router_recoveries_total counter" in text["port"]


def test_constants_match_reference():
    assert trouter.QOS_CLASSES == jrouter.QOS_CLASSES
    assert trouter.TIER_RETRY_AFTER_S == jrouter.TIER_RETRY_AFTER_S
    assert (trouter.TENANT_HEADER, trouter.CLASS_HEADER) == (
        jrouter.TENANT_HEADER, jrouter.CLASS_HEADER)
    assert sorted(trouter.__all__) == sorted(jrouter.__all__)


def test_not_ported_raises_naming_roadmap(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        trouter.ReplicaSpec(MODEL, ENGINE, tp=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        trouter.single_device_child_env("cpu", tp=2)
    spec = trouter.ReplicaSpec(MODEL, ENGINE)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8"):
        trouter.Router(spec, exec_store_dir=str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_EXEC_STORE_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8"):
        trouter.Router(spec)
    monkeypatch.delenv("PADDLE_TPU_EXEC_STORE_DIR")
    # accepted and ignored
    trouter.Router(spec, workdir=str(tmp_path),
                   jax_cache_dir="/x").httpd.server_close()


def test_replica_spec_json_and_argv_match_reference(tmp_path):
    """The spec's wire form is paddle_tpu's; the child is the port's own
    module; the child env pins the device and nothing of XLA."""
    kw = dict(warmup=False, drain_s=3.0, seed=5, env={"A": "1"})
    mine = trouter.ReplicaSpec(dict(MODEL, device="cpu"), ENGINE, **kw)
    ref = jrouter.ReplicaSpec(dict(MODEL, device="cpu"), ENGINE, **kw)
    assert mine.to_json() == ref.to_json()
    argv = mine.argv(str(tmp_path / "p"))
    assert argv[1:3] == ["-m", "paddle_tpu_torch.inference.router"]
    assert argv[3:] == ref.argv(str(tmp_path / "p"))[3:]
    assert trouter.single_device_child_env("cpu") == {
        "CUDA_VISIBLE_DEVICES": ""}
    assert set(trouter.single_device_child_env("gpu")) == {
        "CUDA_VISIBLE_DEVICES"}
    assert not mine.on_card
    assert trouter.ReplicaSpec(MODEL, ENGINE).on_card
    assert trouter.ReplicaSpec({"kind": "factory", "path": "m:f", "kwargs": {
        "device": "cpu"}}).on_card is False


def test_replica_child_without_a_card_exits_nonzero(tmp_path):
    """A child whose spec says the card and that finds none exits 1; it
    never serves on the CPU."""
    spec = trouter.ReplicaSpec(dict(MODEL, device="cuda"), ENGINE,
                               env=trouter.single_device_child_env("cpu"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, **spec.env)
    port_file = str(tmp_path / "r.port")
    proc = subprocess.run(spec.argv(port_file), env=env, cwd=str(tmp_path),
                          capture_output=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert b"CUDA" in proc.stderr
    assert not os.path.exists(port_file)
