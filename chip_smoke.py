#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it fails (exit code 1, no result
line) without a card or outside the repository. Phases, each fatal on
failure:

1. card: name and power limit (nvidia-smi); TF32 matmuls off.
2. build: compile every kernel from the repository's CUDA sources.
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving slice's shapes (gpt_125m: B=8, L=1024, 12 heads of 64),
   several position vectors; error, kernel / plain / library-call time
   (CUDA events, L2 flushed before each launch) and the least time the
   card could take (bytes over 3.35 TB/s, f32 operations over 67 TFLOP/s).
4. serving, bf16 cache: gpt_125m with seeded random weights behind
   ContinuousBatchingEngine(slots=8, max_len=1024, tick_tokens=8) and
   PredictorServer; 8 concurrent POST /generate. The mega-decode launch
   count must equal ticks x tick_tokens x 12 layers.
5. serving, f32 cache: 4 requests, tokens identical to the sequential
   greedy generate() of a CPU copy of the same weights (a differing token
   is accepted only where the CPU oracle's top-2 logit margin is < 1e-4).
6. serving, int8 cache: 4 requests; slot-write launches must equal
   ticks x tick_tokens x 12 layers x 4.
7. summary: one {"kernels": [...]} line, the card line, and last the
   {"ok": true, "device": {...}} line.
"""
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

L_SLICE, B_SLICE, NKV, HD = 1024, 8, 12, 64
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
F32_OPS_PER_S = 67e12               # H100 SXM f32 outside the tensor cores
MAX_NEW = 32
TICK = 8
LAYERS = 12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def timed(torch, fn, flush, iters=30, warmup=3):
    """Median ms of ``fn`` on the card: the launches queue up behind a
    sleep kernel so host enqueue gaps stay outside the events, and the L2
    is flushed (a 128 MB write) before each timed launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(3e8))
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in ev)
    return ts[len(ts) // 2]


def b4_cost(pos, L, nh, nkv, hd, q_bytes, c_bytes):
    """(bytes, operations) one mega-decode launch needs at these
    positions: old cache rows read once, q/k/v/pos read, ctx and the new
    rows written; 4 f32 operations per attended element and head."""
    n_old = [min(max(p, 0), L) for p in pos]
    n_write = sum(1 for p in pos if 0 <= p < L)
    B = len(pos)
    nbytes = (sum(n_old) * nkv * hd * 2 * c_bytes
              + B * (2 * nh + 2 * nkv) * hd * q_bytes + B * 4
              + n_write * nkv * hd * 2 * c_bytes)
    ops = sum(n + 1 for n in n_old) * nh * hd * 4
    return nbytes, ops


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_mega_decode(torch, md, flush, rng_pos):
    """Phase 3, B4: kernel vs plain at the slice shapes."""
    B, L, nh, nkv, hd = B_SLICE, L_SLICE, NKV, NKV, HD
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    pos_sets = [[0, 1, 5, 5, 511, 700, L - 1, L],
                [L + 7, 0, -1, 3, 1000, L - 1, 2, 64],
                rng_pos,
                [L] * B]
    configs = [(torch.float32, torch.float32, 1e-5),
               (torch.float32, torch.bfloat16, 1e-5),
               (torch.bfloat16, torch.bfloat16, 2e-2)]
    errs = {}
    for qdt, cdt, tol in configs:
        worst = 0.0
        for pv in pos_sets:
            q = torch.randn(B, 1, nh, hd, device=dev, generator=gen).to(qdt)
            k = torch.randn(B, 1, nkv, hd, device=dev, generator=gen).to(qdt)
            v = torch.randn(B, 1, nkv, hd, device=dev, generator=gen).to(qdt)
            kc = torch.randn(B, L, nkv, hd, device=dev, generator=gen).to(cdt)
            vc = torch.randn(B, L, nkv, hd, device=dev, generator=gen).to(cdt)
            pos = torch.tensor(pv, dtype=torch.int32, device=dev)
            kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            ctx1, _, _ = md.mega_decode_step(q, k, v, kc1, vc1, pos)
            ctx2, _, _ = md.mega_decode_step_plain(q, k, v, kc2, vc2, pos)
            torch.cuda.synchronize()
            err = (ctx1.float() - ctx2.float()).abs().max().item()
            if not (err <= tol):
                fail(f"mega_decode {qdt}/{cdt} pos={pv}: ctx err {err} > {tol}")
            if not (torch.equal(kc1, kc2) and torch.equal(vc1, vc2)):
                fail(f"mega_decode {qdt}/{cdt} pos={pv}: caches differ")
            for b, p in enumerate(pv):
                if p == 0 and qdt == torch.float32 and not torch.equal(
                        ctx1[b, 0], v[b, 0]):
                    fail(f"mega_decode {cdt}: pos=0 row {b} ctx != v")
            worst = max(worst, err)
        errs[(qdt, cdt)] = worst
        print(f"  mega_decode_step q={qdt} cache={cdt}: max |ctx err| "
              f"{worst:.3e} (tol {tol}), caches bit-exact", flush=True)

    rows = {}
    for cdt, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for pv, where in ((rng_pos, "serving-like pos"),
                          ([L] * B, "full cache")):
            q = torch.randn(B, 1, nh, hd, device=dev, generator=gen)
            k = torch.randn(B, 1, nkv, hd, device=dev, generator=gen)
            v = torch.randn(B, 1, nkv, hd, device=dev, generator=gen)
            kc = torch.randn(B, L, nkv, hd, device=dev, generator=gen).to(cdt)
            vc = torch.randn(B, L, nkv, hd, device=dev, generator=gen).to(cdt)
            pos = torch.tensor(pv, dtype=torch.int32, device=dev)
            ms = timed(torch, lambda: md.mega_decode_step(q, k, v, kc, vc, pos),
                       flush)
            plain_ms = timed(torch, lambda: md.mega_decode_step_plain(
                q, k, v, kc, vc, pos), flush)
            # yardstick: SDPA over the same cache, mask l <= pos (the
            # kernel has written the new rows by now), attention only
            q4 = q.to(cdt).transpose(1, 2)
            k4, v4 = kc.transpose(1, 2), vc.transpose(1, 2)
            lid = torch.arange(L, device=dev)
            mask = (lid[None, :] <= pos.long()[:, None])[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_ms = timed(torch, lambda: sdpa(q4, k4, v4, attn_mask=mask),
                           flush)
            nbytes, ops = b4_cost(pv, L, nh, nkv, hd, 4,
                                  torch.tensor([], dtype=cdt).element_size())
            bound_ms, by = bound(nbytes, ops)
            rows[(label, where)] = dict(ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, bound_ms=bound_ms,
                                        bound_by=by, bytes=nbytes, ops=ops)
            print(f"  mega_decode_step cache={label} {where}: kernel {ms:.4f} "
                  f"ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({by}: {nbytes} B, {ops} ops)",
                  flush=True)
    return errs, rows


def check_slot_write(torch, cw, flush, rng_pos):
    """Phase 3, B3: kernel vs plain at the int8 slice shapes."""
    B, L, nkv, hd = B_SLICE, L_SLICE, NKV, HD
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    pos_sets = [[0, 1, 5, 5, 511, 700, L - 1, L],
                [L + 7, 0, -1, 3, 1000, L - 1, 2, 64], rng_pos]

    def make(kind):
        if kind == "int8 data":
            c = torch.randint(-127, 128, (B, L, nkv, hd), device=dev,
                              generator=gen, dtype=torch.int8)
            r = torch.randint(-127, 128, (B, 1, nkv, hd), device=dev,
                              generator=gen, dtype=torch.int8)
        elif kind == "f32 scale plane":
            c = torch.rand(B, L, nkv, device=dev, generator=gen)
            r = torch.rand(B, 1, nkv, device=dev, generator=gen)
        else:
            dt = torch.bfloat16 if kind == "bf16 data" else torch.float32
            c = torch.randn(B, L, nkv, hd, device=dev, generator=gen).to(dt)
            r = torch.randn(B, 1, nkv, hd, device=dev, generator=gen).to(dt)
        return c, r

    rows = {}
    for kind in ("int8 data", "f32 scale plane", "bf16 data", "f32 data"):
        for pv in pos_sets:
            c, r = make(kind)
            pos = torch.tensor(pv, dtype=torch.int32, device=dev)
            c1, c2 = c.clone(), c.clone()
            cw.fused_slot_write(c1, r, pos)
            cw.fused_slot_write_plain(c2, r, pos)
            torch.cuda.synchronize()
            if not torch.equal(c1, c2):
                fail(f"fused_slot_write {kind} pos={pv}: caches differ")
        c, r = make(kind)
        pos = torch.tensor(rng_pos, dtype=torch.int32, device=dev)
        ms = timed(torch, lambda: cw.fused_slot_write(c, r, pos), flush)
        plain_ms = timed(torch, lambda: cw.fused_slot_write_plain(c, r, pos),
                         flush)
        ar, pl = torch.arange(B, device=dev), pos.long()
        src = r[:, 0]

        def lib():
            c[ar, pl] = src
        lib_ms = timed(torch, lib, flush)
        nbytes = 2 * r.numel() * r.element_size() + B * 4
        bound_ms, by = bound(nbytes, 0)
        rows[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=by, bytes=nbytes)
        print(f"  fused_slot_write {kind}: bit-exact; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, index_put {lib_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({by}: {nbytes} B)", flush=True)
    return rows


def post_all(url, prompts, max_new):
    """POST /generate for every prompt at once; returns (status, body)s."""
    results = [None] * len(prompts)

    def one(i):
        data = json.dumps({"input_ids": [int(t) for t in prompts[i]],
                           "max_new_tokens": max_new}).encode()
        req = urllib.request.Request(url + "/generate", data=data,
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                results[i] = (r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            results[i] = (e.code, json.loads(e.read() or b"{}"))
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            fail("a /generate request never returned")
    return results


def serve(torch, pkg, model, cache_dtype, prompts, slots=8):
    """Serve ``prompts`` through engine + HTTP server with the launch
    counters zeroed just before; returns (token lists, engine ticks,
    launch counts, wall seconds)."""
    md, cw = pkg["md"], pkg["cw"]
    eng = pkg["Engine"](model, slots=slots, max_len=L_SLICE,
                        cache_dtype=cache_dtype, tick_tokens=TICK)
    srv = pkg["Server"](eng, host="127.0.0.1", port=0, deadline_s=600).start()
    try:
        url = f"http://{srv.host}:{srv.port}"
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                fail("/health")
        md.mega_decode_step.launches = 0
        cw.fused_slot_write.launches = 0
        t0 = time.perf_counter()
        res = post_all(url, prompts, MAX_NEW)
        wall = time.perf_counter() - t0
        counts = {"mega_decode_step": md.mega_decode_step.launches,
                  "fused_slot_write": cw.fused_slot_write.launches}
        ticks = eng.ticks
    finally:
        srv.stop()
        eng.stop()
    vocab = model.cfg.vocab_size
    toks = []
    for (code, body), p in zip(res, prompts):
        if code != 200:
            fail(f"/generate ({cache_dtype}) -> {code} {body}")
        t = body["tokens"]
        if (len(t) != len(p) + MAX_NEW or t[:len(p)] != [int(x) for x in p]
                or body["new_tokens"] != MAX_NEW
                or not all(0 <= x < vocab for x in t)):
            fail(f"/generate ({cache_dtype}) body malformed: {body}")
        toks.append(t)
    torch.cuda.synchronize()
    print(f"  {cache_dtype}: {len(prompts)} requests x {MAX_NEW} tokens in "
          f"{wall:.3f} s ({len(prompts) * MAX_NEW / wall:.1f} new tok/s "
          f"incl. prefill), {ticks} ticks, launches {counts}", flush=True)
    return toks, ticks, counts, wall


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    try:
        import numpy as np
        from paddle_tpu_torch.convert import load_paddle_tpu_params
        from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                                PredictorServer)
        from paddle_tpu_torch.kernels import _build
        from paddle_tpu_torch.kernels import cache_write as cw
        from paddle_tpu_torch.kernels import mega_decode as md
        from paddle_tpu_torch.models import (GPTForCausalLM, generate,
                                             gpt_125m)
    except ImportError as e:
        fail(f"cannot import paddle_tpu_torch (run from the repo root): {e}")
    pkg = {"md": md, "cw": cw, "Engine": ContinuousBatchingEngine,
           "Server": PredictorServer}
    t_start = time.perf_counter()

    print("phase 1: card", flush=True)
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)

    print("phase 2: build", flush=True)
    t0 = time.perf_counter()
    per = _build.build()
    print(f"  built {sorted(per)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.NVCC_FLAGS})", flush=True)

    print("phase 3: kernels vs plain versions", flush=True)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)
    rng_pos = [int(x) for x in rng.integers(16, 16 + 300 + MAX_NEW,
                                            B_SLICE)]
    b4_errs, b4_rows = check_mega_decode(torch, md, flush, rng_pos)
    b3_rows = check_slot_write(torch, cw, flush, rng_pos)
    del flush

    print("phase 4: serving gpt_125m, bf16 cache", flush=True)
    model = GPTForCausalLM(gpt_125m(), seed=0)        # the card by default
    vocab = model.cfg.vocab_size
    prompts = [rng.integers(0, vocab, int(n))
               for n in rng.integers(16, 301, 8)]
    _, ticks, counts, _ = serve(torch, pkg, model, "bfloat16", prompts)
    want = ticks * TICK * LAYERS
    if counts["mega_decode_step"] != want or counts["fused_slot_write"]:
        fail(f"bf16 launches {counts} != mega {want} (= {ticks} ticks x "
             f"{TICK} x {LAYERS}), slot 0")
    b4_launches = counts["mega_decode_step"]

    print("phase 5: serving, f32 cache vs the sequential CPU oracle",
          flush=True)
    prompts5 = [rng.integers(0, vocab, int(n))
                for n in rng.integers(16, 301, 4)]
    toks5, ticks, counts, _ = serve(torch, pkg, model, "float32", prompts5,
                                    slots=4)
    if counts["mega_decode_step"] != ticks * TICK * LAYERS:
        fail(f"f32 launches {counts} != {ticks} x {TICK} x {LAYERS}")
    oracle = GPTForCausalLM(gpt_125m(), device="cpu", seed=1)
    load_paddle_tpu_params(oracle, {n: p.detach().cpu().numpy()
                                    for n, p in model.named_parameters()})
    for p, got in zip(prompts5, toks5):
        want_t = generate(oracle, p, MAX_NEW, cache_dtype="float32")[0]
        diff = [i for i, (a, b) in enumerate(zip(got, want_t.tolist()))
                if a != b]
        if not diff:
            continue
        i = diff[0]
        with torch.no_grad():
            lg = oracle(torch.from_numpy(want_t[None, :i]))[0, -1]
        top2 = torch.topk(lg, 2).values
        margin = float(top2[0] - top2[1])
        print(f"  token {i} differs (card {got[i]}, cpu {want_t[i]}); CPU "
              f"top-2 margin {margin:.3e}", flush=True)
        if margin >= 1e-4:
            fail("f32 serving tokens differ from the CPU oracle")
    print("  f32 serving tokens match the sequential CPU oracle", flush=True)

    print("phase 6: serving, int8 cache", flush=True)
    prompts6 = [rng.integers(0, vocab, int(n))
                for n in rng.integers(16, 301, 4)]
    _, ticks, counts, _ = serve(torch, pkg, model, "int8", prompts6)
    want = ticks * TICK * LAYERS * 4
    if counts["fused_slot_write"] != want or counts["mega_decode_step"]:
        fail(f"int8 launches {counts} != slot {want} (= {ticks} x {TICK} x "
             f"{LAYERS} x 4), mega 0")
    b3_launches = counts["fused_slot_write"]

    print("phase 7: summary", flush=True)
    main_b4 = b4_rows[("bf16", "serving-like pos")]
    main_b3 = b3_rows["int8 data"]
    kernels = [
        {"name": "mega_decode_step", "route": "cuda",
         "source": "paddle_tpu_torch/kernels/csrc/mega_decode.cu",
         "replaces": "paddle_tpu/kernels/mega_decode.py:107",
         "launches": b4_launches,
         "max_abs_err": b4_errs[(torch.float32, torch.bfloat16)],
         "ms": main_b4["ms"], "plain_ms": main_b4["plain_ms"],
         "bound_ms": main_b4["bound_ms"], "bound_by": main_b4["bound_by"],
         "library_ms": main_b4["library_ms"]},
        {"name": "fused_slot_write", "route": "cuda",
         "source": "paddle_tpu_torch/kernels/csrc/cache_write.cu",
         "replaces": "paddle_tpu/kernels/cache_write.py:75",
         "launches": b3_launches, "max_abs_err": 0.0,
         "ms": main_b3["ms"], "plain_ms": main_b3["plain_ms"],
         "bound_ms": main_b3["bound_ms"], "bound_by": main_b3["bound_by"],
         "library_ms": main_b3["library_ms"]},
    ]
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
