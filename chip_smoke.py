#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it fails (exit code 1, no result
line) without a card or outside the repository. Phases, each fatal on
failure:

1. card: name and power limit (nvidia-smi); TF32 matmuls off.
2. build: compile every kernel from the repository's CUDA sources, one
   nvcc per source, all at once, each timed; ptxas's registers and spills
   of every tensor-core flash kernel (the bf16 wgmma ones and the f32
   3xTF32 ones) and the dynamic shared memory each asks for.
3. kernels: each kernel against its plain PyTorch version on the card at
   its slice's shapes; error, kernel / plain / library-call time (CUDA
   events, L2 flushed before each launch) and the least time the card
   could take (bytes over 3.35 TB/s, operations over the peak of the
   route that takes them: 989 TFLOP/s bf16 on the tensor cores, 67
   TFLOP/s f32 outside them, and for f32 flash on the tensor cores three
   TF32 products an operation at 495 TFLOP/s; beside those rows also the
   67-TFLOP/s bound of the SIMT kernels they replace).
   Serving (gpt_125m: B=8, L=1024, 12 heads of 64): mega decode (B4) with
   f32 / bf16 q and caches, at positions that include its chunk edges, and
   at GQA g = 2, 4, 8, at g = 3, 5, 16 and MQA (40 and 64 query heads on
   one kv head: sub-groups of at most 8 heads a block), and head sizes
   36, 33 and 256 (rows that take 8-, 4- and 2-byte loads), timed with a
   bf16 and an f32 cache, serving-like and
   full, beside SDPA and three floors (a one-element fill; B4 at pos =
   -1, which reads nothing; torch.sum over the full cache's bytes);
   int8 quantisation (quant_rows) on the card against the CPU, bit for
   bit; the per-plane slot write (B3) and the fused one (kv_slot_write:
   the int8 slot decode's four planes in one launch, at positions with
   -1, L and L + 7); the per-plane paged write (B3 paged) into a [512, 16,
   12, 64] pool at the decode shape (n = 8 rows) and an admission shape
   (n = 512), bf16/f32 pages, int8 pages and their f32 scale plane; and
   the fused one (kv_paged_write: both halves of a layer, the page
   arithmetic, the gates and the int8 quantisation in one launch) from
   strided qkv rows, f32 and bf16, into bf16, f32 and int8 pools at
   decode, verify and admission shapes, with dead rows, wlen, negative
   positions, the page edges and rows past the table; all bit-exact
   (NaN where NaN), the fused writes timed beside the launches they
   replace, index_put_ and the byte bound. Training
   (gpt_125m at batch 8 x seq 1024): flash attention forward and backward
   (B1) at B=8, H=12, S=1024, D=64, bf16 on the wgmma kernels and f32 on
   the 3xTF32 mma.sync kernels, both on the tensor cores (each launch's
   path checked by its counters), both held to the plain versions (f32
   products), the f32 ones also to the plain formula in f64 on the same
   inputs (the plain version's own error against it printed beside, so
   that a failure tells the kernel's error from the reference's
   rounding), with SDPA's error against the f32 plain version printed
   beside each case without offsets (LIM_BF16 or LIM_F32 as the
   yardstick); the f32 rows also timed on the SIMT kernels they replace,
   through their C entries, in the same call; fused cross-entropy forward and backward (B2) at
   N=8192, V=50304. Sequence parallelism (the ring step of phase 14: B=8,
   H=12, 256-row shards, D=64): the blockwise flash forward and backward
   (B5) on a diagonal, a past, a future (out 0, lse -inf, zero grads) and
   a non-causal block, bf16 and f32 (paths, limits and the f32 rows' f64
   reference as B1's; the error
   of aten flash, bf16, or aten memory-efficient attention, f32, against
   the f32 products beside; timed beside the same calls, and the f32 rows
   beside the SIMT kernels), the backward against a given delta with a
   nonzero lse cotangent folded in; then, untimed, the same kind of blocks
   (and one with the causal edge across every tile) at 250-row shards and
   offsets off every multiple of 64.
   LLaMA-13B's shapes (phases 15-18): B4 at B=8, L=2048, 40 heads of 128,
   bf16 q and cache, against its plain version and timed serving-like and
   full; kv_paged_write into [1024, 16, 40, 128] bf16 pools from bf16
   rows, bit-exact, timed at decode and admission; B1 bf16 at B=4, H=40,
   S=2048, D=128, causal (the wgmma D-128 kernels), and B2 at N=8192,
   V=32000, bf16, each held and timed as above; and the sampling filter
   and draw (``generation._select_token``) on the card against the CPU on
   64 rows of logits at V=32000, each knob alone and all together: the
   same tokens except where the CPU's perturbed top-2 margin is < 1e-4.
   BERT/ERNIE's shapes (phases 19-21): B1 non-causal, bf16 at B=1, H=12,
   S=128, D=64 (ERNIE serving; forward only, expected at the launch
   floor: its bound is ~0.24 us) and at B=32 (forward and backward), f32
   at B=2 (the oracle, 3xTF32, also against f64); B2 at N=32, V=2 (the
   classifier) and at N=4096, V=30522 with a quarter of the rows at the
   ignore index (an MLM batch of 32 x 128), bf16 and f32, beside
   F.cross_entropy with the same ignored rows; each held and timed as
   above.
   Phases 24-25's shapes: B4 at the draft's steps (B=8, L=2048, 12 heads
   of 64, f32 q and cache, at its chunk edges; timed serving-like);
   kv_paged_write into GPT-6.7B's [1024, 16, 32, 128] bf16 pools from
   bf16 rows, bit-exact, timed at the verify shape (8 x 5 rows) and an
   admission; B1 bf16 causal at GPT-1.3B's (4, 16, 2048, 128) on the
   wgmma D-128 kernels; B2 at one loss chunk, N=2048 x V=50304, in f32
   (the fused loss's logits dtype); each held and timed as above.
4. serving, bf16 cache: gpt_125m with seeded random weights behind
   ContinuousBatchingEngine(slots=8, max_len=1024, tick_tokens=8) and
   PredictorServer; 8 concurrent POST /generate. The mega-decode launch
   count must equal ticks x tick_tokens x 12 layers. The same requests
   run once more under torch.profiler (device busy share, top kernels,
   device kernels a forward, B4's device time).
5. serving, f32 cache: 4 requests, tokens identical to the sequential
   greedy generate() of a CPU copy of the same weights (a differing token
   is accepted only where the CPU oracle's top-2 logit margin is < 1e-4).
6. serving, int8 cache: 4 requests; kv_slot_write launches must equal
   ticks x tick_tokens x 12 layers (one a layer for the four planes);
   profiled as phase 4. In phases 4-6 and 9-12 no plain version of a
   serving kernel and no per-plane write (fused_slot_write,
   fused_paged_write) may run.
7. training, f32: gpt_125m with f32 weights on the card and a CPU copy;
   one loss and backward at batch 2 x seq 128; loss and every parameter's
   grad against the CPU's, every B1 launch on the 3xTF32 kernels. Then
   phase 8's step on the f32 model (AdamW without master weights, batch 8
   x seq 1024, 1 warm step then 5): finite, decreasing losses, the first
   within 0.5 of ln V; B1 launches 5 x 12 each way, all on the tensor-core
   path; B2 1 + 1 a step; no plain version; one step profiled (device
   busy share, the flash kernels' device time).
8. training step, bf16: TrainStep(gpt_125m().bfloat16(), loss_fn,
   AdamW(lr=1e-4, multi_precision=True)) at batch 8 x seq 1024, 1 warm
   step then 5 on the same batch: finite, decreasing losses; the kernel
   launch counts equal their formulas, every B1 launch takes the
   tensor-core kernels and no plain version runs.
9. paged serving, bf16 pool: the same engine with paged=True,
   page_size=16, prefix_cache=True (512 pages); 8 concurrent requests
   share one 256-token prefix (16 pages) before distinct 16-200-token
   suffixes. Prefix hits must be 7 with 7 x 256 tokens saved; after the
   requests retire only the trie's pages stay in use and the allocator's
   invariants hold; kv_paged_write launches must equal (admissions +
   ticks x tick_tokens) x 12 layers (one a layer for both halves) and B4
   must not run. The same requests run once more under torch.profiler,
   prefix cache warm.
10. paged serving, f32 pool, vs the sequential CPU oracle (phase 5's
   rule): 4 requests, one repeating another's 128-token prompt, so its
   admission copies the tail page and prefills one token.
11. paged serving, int8 pool: kv_paged_write launches equal (admissions
   + ticks x tick_tokens) x 12, the quantisation in the launch; profiled
   as phase 9.
12. n-gram speculative decoding (spec_k=4) on paged f32 pools: prompts
   repeat a 32-token motif; tokens vs the CPU oracle (phase 5's rule),
   acceptance rate > 0 and accepted tokens per verify tick > 1;
   kv_paged_write launches equal (admissions + verify ticks + plain ticks
   x tick_tokens) x 12. Then one line a phase of 6, 9 and 11: wall, ticks,
   ms a tick, device busy share, device kernels a forward.
13. sequence-parallel attention: ring_attention and ulysses_attention on a
   4-position mesh on the one card (devices=["cuda:0"] * 4) at B=8,
   S=1024, H=12, D=64, causal, f32 and bf16: outputs and q/k/v grads
   against the plain full attention; the dispatch takes the kernel path;
   B5 launches equal 16 forward and 16 backward for the ring, 4 and 4 for
   Ulysses (one per position), all on the tensor-core kernels (bf16
   wgmma, f32 3xTF32), B1 none. Timed, then the same untimed at
   S=1000 (250-row shards); on a host with 4 or more cards, the S=1024
   run once more with one shard on each of cuda:0..3 (rotations and
   all-to-alls become peer copies), timed.
14. training step under sp=4: phase 8's step exactly, its attention
   through the ring (devices=["cuda:0"] * 4): B5 launches equal 12 x 16
   per step each way, all on the tensor-core kernels, B1 none, B2 1 + 1;
   no plain version runs; the
   losses are held to phase 8's (LOSS_RTOL_SP); one step profiled.
15. serving LLaMA-13B: LlamaForCausalLM(llama_13b(), seed=0).bfloat16()
   (40 layers at full width, 13.02 B parameters, drawn on the card) behind
   the engine (slots=8, max_len=2048, tick_tokens=8) and the server; 8
   concurrent POST /generate of 16-300-token prompts, 32 new tokens each;
   mega-decode launches must equal ticks x 8 x 40; profiled as phase 4.
16. paged LLaMA-13B serving with sampling: bf16 pool of 1024 pages,
   prefix cache, do_sample with temperature 0.8, top-k 50, top-p 0.95;
   8 requests sharing a 256-token prefix, each with its own seed: prefix
   hits 7, kv_paged_write launches (admissions + ticks x 8) x 40, B4 none;
   profiled; then one 12-token prompt with one seed alone and again beside
   a request in slot 0 (another slot, other ticks) must give the same
   tokens, and another seed other tokens.
17. the f32 oracle: llama_13b() cut to 2 layers with 10 kv heads (full
   width, g = 4) in f32 on the card and a CPU copy of its weights; 4 requests of
   16-64 tokens, 16 new tokens each, held to the CPU's sequential
   generate() by phase 5's rule; B4 launches ticks x 8 x 2.
18. training at LLaMA-13B's width: llama_13b() cut to 2 layers, f32, loss
   and every grad at batch 1 x 64 against a CPU copy (as phase 7); then
   TrainStep(llama_13b() cut to 4 layers .bfloat16(), AdamW(lr=1e-4,
   multi_precision=True)) at batch 4 x seq 2048, 1 warm step then 5:
   finite, falling losses, the first within 0.5 of ln V + H r^2 / 2 (the
   loss of the random logits, H = 5120, r = 0.02: 11.39, where ln V alone
   is 10.37); B1 4 launches a step each way, all on the tensor-core
   kernels, B2 1 + 1, no plain version; one step profiled. Depth is cut
   to 4: all 40 layers would need 208 GB of weights and optimizer state.
19. serving ERNIE-3.0-base: ErnieModel(ernie_3_base(), seed=0).bfloat16()
   (12 layers, hidden 768, relu, V 30522, full width and depth) through
   jit.save(input_spec=[InputSpec([None, 128], "int64")]) ->
   PredictorServer(Config(path + ".pdmodel")); 8 concurrent POST /predict
   at batch 1 and one at batch 8: both outputs (sequence, pooled) equal to
   the eager model's on the card; B1 launches 12 x 9 requests, all on the
   tensor-core kernels, no backward, no plain version. Then 50 sequential
   batch-1 Predictor.runs timed copy_from_cpu to copy_to_cpu (p50, p99;
   tools/bench_serving.py:bench_encoder's timing), one profiled (device
   busy share); then ernie_3_base saved in f32 on the CPU, served by a
   card predictor and held to the CPU predictor (LIM_F32).
20. the BERT f32 oracle: bert_base() cut to 2 layers, dropout 0, f32 on
   the card and a CPU copy (phase 7's rule) at batch 2 x 128: the
   classifier's loss and every gradient without a mask (B1 non-causal on
   the 3xTF32 kernels, 2 + 2), with a padding mask (the plain masked
   attention, no B1), and BertForMaskedLM's at V 30522 with a quarter of
   the labels ignored (B2 1 + 1).
21. fine-tuning BERT-base: TrainStep(BertForSequenceClassification(
   bert_base(), num_classes=2, seed=0).bfloat16(), loss_fn, AdamW(lr=5e-5,
   multi_precision=True), n_inputs=3), full width and depth, dropout 0.1,
   batch 32 x 128 with padding masks of lengths 32-128: one seed gives one
   loss twice and another seed another, the first attention-dropout mask
   keeps 0.9 +- 0.005; 1 warm step then 5: finite losses, the last below
   the first; B2 1 + 1 a step, B1 and B5 never (the dropout branch is
   plain code, as in paddle_tpu), no plain version; one step profiled.
22. the serving tier: gpt_125m (full width and depth) behind a paged bf16
   engine with the prefix cache and n-gram speculation (slots 8, max_len
   1024, tick 8, 16-token pages), obs on, PredictorServer(warmup=True):
   /healthz 503 "warming" first, then 200 (the warmup's wall time, and
   the first request's TTFT after it beside phase 9's cold first request,
   from the engine.prefill span); 8 concurrent streamed /generate and the
   same 8 single-shot (each set admitted in one pass, after one pass that
   caches their prefixes): the {"t"} lines are the done body's generated
   tokens and equal the single-shot reply, token for token;
   kv_paged_write launches equal forwards x 12, B4 and every plain
   version never; a 256-token request cancelled by POST /cancel
   mid-decode gets 409 with partial tokens that are a prefix of the same
   request uncancelled; a stream whose client closes the socket is
   cancelled, and after both no slot is busy and the allocator's
   invariants hold; /metrics before and after: every series of
   paddle_tpu's paged speculative engine present, counters monotone, the
   tick, admit, retire and cancel deltas equal to stats(); TTFT and queue
   wait p50/p99 from the histograms and the last tick_model_eff; POST
   /admin/trace?duration_s=2&profile=1 over 8 requests: serve.generate
   spans with their ids, engine.tick spans, the torch.profiler trace names
   kv_paged_write, no torch_profile_error; stop(drain_s=120) with one
   request in flight: a new /generate gets 503 "draining" with
   Retry-After, the in-flight one 200 with all its tokens. Then a slot
   bf16 engine (B4) streams 4 requests held to their single-shot replies
   (mega_decode_step launches ticks x 8 x 12); last, phase 4's serving
   with PADDLE_TPU_OBS off and on, in turns, six times each (ms a tick
   each and the medians).
23. the router tier: Router(ReplicaSpec(gpt_125m at full width and depth
   on the card, paged f32 pool of 16-token pages with the prefix cache,
   slots 8, max_len 1024, tick 8, seed 0), replicas=2): two replica
   processes on the one card, the kernels built in this process before
   the spawn; each replica's time from spawn to ready, the tier's
   /healthz 200 with 2 ready, no replica runs nvcc (its /healthz and its
   log). 8 prompts of 16-300 tokens with distinct first pages, one at a
   time, 32 new tokens, held to the CPU oracle's sequential generate() by
   phase 5's rule; then POST /admin/trace?duration_s=2&profile=1 on each
   replica over 8 concurrent streams of the same prompts (held the same
   way): each replica's torch.profiler trace names kv_paged_write and no
   mega_decode kernel; kv_paged_write launches equal forwards x 12 on
   each replica (their /healthz counters, before and after); TTFT p50/p99
   through the tier (the router's histogram, and on the client) beside
   phase 22's direct figures, and the router's added wall (its
   router.forward span minus the replica's serve.generate span of the
   same request id). Kill -9: 8 concurrent streams of 64-token prompts,
   128 new tokens each; once every stream has its first token, the
   replica with the most in flight is killed: every stream ends complete
   (streamed tokens = done body, 128 each) and held to the CPU oracle
   (one batched generate() of the 8) by phase 5's rule; at least one
   recovery counted (stats, ptpu_router_recoveries_total, the done
   bodies), a request_recovery flight dump naming only these requests;
   the dead replica respawned and ready again without nvcc. An armed
   router_forward fault is retried once and answers 200. rolling_restart()
   under light traffic: both replaced, every request 200, no nvcc. The
   tier's /metrics carries the 17 ptpu_router_* families and each
   replica's series (render_tier). Both replicas drained: /generate gets
   503 no_replica_ready with Retry-After. router.stop() ends every
   replica process.
24. draft-model speculation at full width: GPTForCausalLM(gpt_6p7b(),
   seed=0).bfloat16() (32 layers, hidden 4096, V 50304; its host draw
   and copy timed on a line of its own) behind the paged engine (slots
   8, max_len 2048, 16-token pages, 1024 pages, prefix cache, bf16 pool)
   and the server, drafted by GPTForCausalLM(gpt_125m(), seed=1) in f32
   (its own f32 slot cache), spec_k 4; 8 concurrent POST /generate of
   16-300-token prompts, 32 new tokens each. The same prompts through a
   plain paged engine on the same weights first: the draft engine's
   tokens must be identical, except that at a first differing token the
   bf16 target's own top-2 logit margin over that prefix (one cacheless
   forward) is below DRAFT_MARGIN, and the request is not compared
   beyond it. Every tick is a verify tick; kv_paged_write launches equal
   (admissions + verify ticks) x 32, B4 launches draft ticks x 3 x 12,
   nothing else and no plain version. /healthz reports speculative
   "draft" and the counters; the same requests once more with each draft
   proposal and each verify forward timed by CUDA events, in one
   profiled window (device busy share). Then the full-acceptance oracle:
   an f32 gpt_125m drafted by a copy of its own weights (f32 slot cache,
   4 requests) held to the CPU oracle by phase 5's rule; acceptance >
   0.9 and > 2 tokens per slot per verify tick; B4 launches draft ticks
   x 3 x 12.
25. training memory features at bench.py's GPT-1.3B step (bench.py:
   270-283): TrainStep(GPTForCausalLM(gpt_1p3b(recompute=True,
   scan_layers=True, fused_loss_chunk=2048, recompute_policy="full"),
   seed=0).bfloat16(), make_loss_fn(), AdamW(lr=1e-4,
   multi_precision=False)) at batch 4 x 2048, full width and depth, 1
   warm step then 5: finite, falling losses, the first within 0.5 of ln V
   + H r^2 / 2; B1 forward 2 x 24 a step (the recompute runs it again),
   backward 24, all on the tensor-core kernels; B2 4 + 4 a step (four
   2048-token chunks); no plain version; peak memory and ms a step; one
   step profiled. The same start weights under recompute_policy "dots"
   for 2 steps, and copied into an unrolled model trained with the
   features off (no recompute, loss_fn) for 1 + 5 steps: both within
   FEATURES_LOSS_ATOL of the features-on losses, step by step, the peak
   memory and ms a step of both runs printed, and beside each the memory
   one loss and backward alone takes above what was held before it (the
   activations, apart from the optimizer's update). Then the f32 oracle: the
   same config cut to 2 layers, f32, card vs a CPU copy at batch 2 x
   1100 (the fused loss in two chunks, the second padded), loss and every
   grad by phase 7's rule (B1 forward 2 + 2, backward 2, B2 2 + 2).
26. the training API (TrainStep's windows, warm, skip and flush,
   eval_fn; the optimizers, schedulers and clips of paddle_tpu): GPT-125M
   at bench.py's geometry (bf16, AdamW multi_precision, OneCycleLR, batch
   8 x 1024), every run from one snapshot of parameters, slots, counters
   and scheduler: warm(ids, ids, scan_k=4) returns paddle_tpu's sites and
   moves no parameter, counter, scheduler or generator state, its slots
   are zeros and f32 copies, and it runs no nvcc; 8 calls, 2 x
   scan_steps(4) (the first time under set_sync_debug_mode("error")), 8
   calls again and the windows again: the windows' losses, parameters,
   slots, counters and scheduler equal the calls' bit for bit, or within
   the card's own spread (hold_runs: torch's embedding backward uses
   atomics), B1 96 / 96 launches on the tensor-core kernels and B2 8 / 8
   in the windows, no plain version; ms a step by calls and by windows,
   one window profiled; with accumulate_steps=2, 2 x scan_steps(3),
   flush_accumulation, skip_step and a call against 6 calls, the same
   three and a call (counters 8, 4, 4); eval_fn's logits equal model(ids)
   in eval mode, the training mode restored. BERT-base fine-tuning at
   phase 21's 32 x 128, dropout 0.1, Lamb + ClipGradByGlobalNorm +
   LinearWarmup over PolynomialDecay: each of two scan_steps(4) equals 4
   calls by the same rule, the spread the largest of three repeats of the
   calls (so the masks are equal); at lr 0 a run with a skip_step at step 2
   gives the unfaulted run's losses at steps 3-5. Each of the nine A4
   optimizers, and SGD / Momentum under ClipGradByNorm /
   ClipGradByValue: 3 steps of gpt_tiny in f32 on the card against a CPU
   copy that takes the card's parameters, slots and gradients before each
   update (atol 1e-6 + rtol 1e-5; losses rel 1e-5), the card's updates
   under set_sync_debug_mode("error").
27. paddle.nn's layer system: nn.Transformer at its defaults
   (Transformer-base: d_model 512, 8 heads, 6 + 6 layers, FFN 2048,
   relu) with weight_attr=ParamAttr(initializer=XavierUniform()),
   dropout 0.1 and attn_dropout 0.0, in user code (``seq2seq``: a shared
   nn.Embedding over V 32000, a scaled sinusoidal position table, an
   nn.Linear projection, one nn.Layer) built on the card (nn.Layer's
   default: parameters and buffers checked there), bf16 through
   Layer.astype: 1 warm and 5 TrainStep steps (AdamW multi_precision) at 32 x
   128 source and 127 target tokens: losses finite and falling, the first
   within 0.5 of ln 32000; B1 12 + 12 a step (encoder self-attention at
   128 x 128, cross-attention at 127 x 128, launches by shape), all on the
   tensor-core kernels (the decoder's masked self-attention takes the
   plain branch), B2 1 + 1, no plain version; ms a step. Greedy decoding
   of 32 tokens through decoder.gen_cache (Cache + StaticCache): B1 6 +
   32 x 12 (1 x 1..32 and 1 x 128), ms a token; the tokens against the
   cacheless decode on the same prefix with the causal mask (ties within
   twice the logits' difference, which stays within TB_LOGIT_ATOL); and
   before training, the cache on 32 random target tokens (teacher
   forced) against the cacheless decoder, decoder outputs within
   TB_HIDDEN_RMS, and its control, an empty Cache at every step, over
   it. State:
   save -> load -> set_state_dict into a fresh model gives the logits bit
   for bit; astype("float32") and to("cpu") give the card's logits within
   phase 7's rule. flash_attn_unpadded over packed lengths 37, 128, 5, 90,
   causal and not, against SDPA a sequence at a time (B1) at LIM_BF16.
   An f32 oracle (2 + 2 layers, d_model 64, one head) on the card by
   default against a copy built after set_device("cpu"), by phase 7's
   rule. Phase 3 holds B1 at these shapes (Sq 127 / Sk 128, Sq 1 / Sk 32
   and 128; forward only at Sq 1 / Sk 1, 7 and 31) and B2 at N 4064 x V
   32000.
28. summary: one {"kernels": [...]} line (B1 and B5 twice: the bf16
   wgmma kernels of phases 8 and 14, and the f32 3xTF32 ones of phases 7
   and 13, their launches from the tensor-core counts; B3 five times:
   kv_slot_write and kv_paged_write with their launches in phases 6 and
   9, kv_paged_write_f32_tier with phase 23's (timed on an f32 pool), and
   the per-plane fused_slot_write and fused_paged_write, which no
   serving path launches: 0; then LLaMA-13B's rows: B4 and kv_paged_write
   with their launches in phases 15 and 16, B1 at D 128 and B2 at V 32000
   with phase 18's; then BERT/ERNIE's rows: B1 non-causal bf16 with phase
   19's launches, B1 f32 with phase 20's, B2 at V 2 with phase 21's and at
   V 30522 with phase 20's; then phase 24's and 25's rows: B4 at the
   draft's shape and kv_paged_write into GPT-6.7B's pool with phase 24's
   launches, B1 at GPT-1.3B's D 128 and B2 on an f32 loss chunk with
   phase 25's features-on launches; then phase 27's: B1 at Transformer-
   base's encoder, cross-attention and decode shapes and B2 at N 4064 x V
   32000 with its launches), the serving lines of phases 15 and 16, phase
   19's latency and phase 22's to 27's figures, the card line, and last
   the {"ok": true, "device": {...}} line.

``python3 chip_smoke.py --sp-cards`` on a host with 4 or more cards runs
phases 1 and 2 and then only phase 13's run with one shard on each of
cuda:0..3, and prints no result line. ``python3 chip_smoke.py --serving``
runs phases 1 and 2 and then phases 6, 9 and 11 alone after a warm-up
serve, served and profiled as in the full run but without launch-count
checks, and prints
their summary lines and no result line: copied into a checkout of an
earlier commit, it measures that commit's serving the same way.
"""
import atexit
import collections
import copy
import dataclasses
import gc
import importlib
import importlib.util
import itertools
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

L_SLICE, B_SLICE, NKV, HD = 1024, 8, 12, 64
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
F32_OPS_PER_S = 67e12               # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12             # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12             # H100 SXM TF32 tensor cores, dense
MAX_NEW = 32
TICK = 8
LAYERS = 12
PAGE, NUM_PAGES = 16, 512           # the paged engine's default pool
SP = 4                              # the sequence-parallel degree
# LLaMA-13B (paddle_tpu/models/llama.py:llama_13b): 40 layers of 40 heads
# of 128, V = 32000, served at max_len 2048; its paged pool holds 8 slots'
# worth of 16-row pages
LLAMA_L, LLAMA_LAYERS, LLAMA_HEADS, LLAMA_HD = 2048, 40, 40, 128
LLAMA_V, LLAMA_NP = 32000, B_SLICE * 2048 // 16
# BERT/ERNIE (paddle_tpu/models/bert.py): ERNIE-3.0-base served at the
# reference bench's sequence (tools/bench_serving.py:bench_encoder), timed
# over as many sequential runs; BERT-base fine-tuned at 32 x 128
ERNIE_S, ERNIE_RUNS, FT_BATCH = 128, 50, 32
BERT_V, BERT_H, BERT_HD = 30522, 12, 64
# draft-model speculation (phase 24): GPT-6.7B (32 layers of 32 heads of
# 128, bf16) served at max_len 2048 from a 1024-page bf16 pool, drafted k =
# 4 a tick by GPT-125M (12 layers, f32 slot cache). A differing token is
# accepted only where the bf16 target's own top-2 logit margin at that
# prefix is below DRAFT_MARGIN: the verify forward (5 tokens a row) and
# plain decode (1) run the bf16 GEMMs at other row counts, so their sums
# round differently, and through 32 bf16 layers that moves a logit by
# about 2 % (~0.1 where the top logits sit near 5; one bf16 step there
# is 2^-5 = 0.031)
GPT67_LAYERS, DRAFT_LAYERS, DRAFT_K, DRAFT_NP = 32, 12, 4, 1024
DRAFT_MARGIN = 0.25
# bench.py's GPT-1.3B step (phase 25, bench.py:270-283): 24 layers of 16
# heads of 128, batch 4 x 2048, recompute + scan_layers + fused loss in
# chunks of 2048 tokens (4 a step). The features-off run on the same
# weights and batch differs by the loss's logits (f32 in the chunks, bf16
# in loss_fn: one bf16 step of a logit near 4 is 2^-6) and what the
# updates make of that: its losses must stay within FEATURES_LOSS_ATOL of
# the features-on run's, step by step (0.2 % of the ~11.2 start, below a
# step's fall)
G13_LAYERS, G13_B, G13_S, G13_CHUNK = 24, 4, 2048, 2048
FEATURES_LOSS_ATOL = 0.02


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def timed(torch, fn, flush, iters=30, warmup=3, clean=False):
    """Median ms of ``fn`` on the card: the launches queue up behind a
    sleep kernel so host enqueue gaps stay outside the events, and the L2
    is flushed (a 128 MB write) before each timed launch. ``clean`` reads
    the 128 MB instead, so the L2 holds no dirty lines that the timed
    launch has to write back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(3e8))
    for s, e in ev:
        if clean:
            flush.amax()
        else:
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


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# (nh, nkv, hd) of B4's further cases: GQA at g = 2, 4, 8, head sizes whose
# row is no multiple of 16 bytes in bf16 (36: 8-byte loads; 33: 2-byte
# loads, 4-byte in f32), the largest head size, and group counts off the
# powers of two: g = 3, 5, 16 (two sub-groups of 8 query heads a block)
# and MQA at 40 and 64 query heads (5 and 8 sub-groups)
B4_CASES = ((24, 12, 64), (32, 8, 128), (64, 8, 128), (12, 12, 36),
            (8, 4, 33), (8, 2, 256), (36, 12, 64), (40, 8, 128),
            (128, 8, 128), (40, 1, 128), (64, 1, 64))


def b4_vs_plain(torch, md, gen, qdt, cdt, tol, nh, nkv, hd, pv, L=L_SLICE):
    """One B4 launch against the plain version on copies of the same
    inputs: ctx within ``tol``, caches bit-exact, ctx == v where pos = 0
    and q is f32. Returns the max |ctx error|."""
    B, dev = len(pv), torch.device("cuda")
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
    what = f"mega_decode {qdt}/{cdt} nh/nkv/hd={nh}/{nkv}/{hd} pos={pv}"
    err = (ctx1.float() - ctx2.float()).abs().max().item()
    if not (err <= tol):
        fail(f"{what}: ctx err {err} > {tol}")
    if not (torch.equal(kc1, kc2) and torch.equal(vc1, vc2)):
        fail(f"{what}: caches differ")
    g = nh // nkv
    for b, p in enumerate(pv):
        if p == 0 and qdt == torch.float32 and not torch.equal(
                ctx1[b, 0], v[b, 0].repeat_interleave(g, 0)):
            fail(f"{what}: pos=0 row {b} ctx != v")
    return err


def check_mega_decode(torch, md, flush, rng_pos):
    """Phase 3, B4: kernel vs plain at the slice shapes and at B4_CASES,
    at positions that include the kernel's chunk edges; then timed at
    the slice shape, bf16 and f32 cache, serving-like and full cache,
    beside three floors: a one-element fill (a launch), B4 with nothing
    to read (pos = -1: every block only takes its ticket) and a plain
    one-launch read of the full cache's bytes (torch.sum over one tensor
    of that size)."""
    B, L, nh, nkv, hd = B_SLICE, L_SLICE, NKV, NKV, HD
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    chunk, nchunks = md.plan_chunks(B, nkv, L, md._sm_count(0))
    print(f"  mega_decode_step chunks at B={B} nkv={nkv} L={L}: {nchunks} "
          f"of {chunk} rows, {B * nkv * nchunks} blocks", flush=True)
    pos_sets = [[0, 1, 5, 5, 511, 700, L - 1, L],
                [L + 7, 0, -1, 3, 1000, L - 1, 2, 64],
                rng_pos,
                [L] * B,
                [chunk - 1, chunk, chunk + 1, 2 * chunk - 1, 2 * chunk,
                 L - chunk, L - 1, -5]]
    configs = [(torch.float32, torch.float32, 1e-5),
               (torch.float32, torch.bfloat16, 1e-5),
               (torch.bfloat16, torch.bfloat16, 2e-2)]
    errs = {}
    for qdt, cdt, tol in configs:
        worst = max(b4_vs_plain(torch, md, gen, qdt, cdt, tol, nh, nkv, hd,
                                pv) for pv in pos_sets)
        errs[(qdt, cdt)] = worst
        print(f"  mega_decode_step q={qdt} cache={cdt}: max |ctx err| "
              f"{worst:.3e} (tol {tol}), caches bit-exact", flush=True)
        for c_nh, c_nkv, c_hd in B4_CASES:
            worst = max(b4_vs_plain(torch, md, gen, qdt, cdt, tol, c_nh,
                                    c_nkv, c_hd, pv) for pv in pos_sets[:2])
            print(f"    nh/nkv/hd={c_nh}/{c_nkv}/{c_hd} (g={c_nh // c_nkv}): "
                  f"max |ctx err| {worst:.3e}", flush=True)

    one = torch.zeros(1, device=dev)
    floors = {"launch": timed(torch, one.zero_, flush)}
    rows = {}
    for cdt, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for pv, where in ((rng_pos, "serving-like pos"),
                          ([L] * B, "full cache")):
            rows[(label, where)] = b4_timed(
                torch, md, flush, gen, (B, L, nh, nkv, hd), torch.float32,
                cdt, pv, f"cache={label} {where}")
        q = torch.randn(B, 1, nh, hd, device=dev, generator=gen)
        k, v = (torch.randn(B, 1, nkv, hd, device=dev, generator=gen)
                for _ in range(2))
        kc, vc = (torch.randn(B, L, nkv, hd, device=dev,
                              generator=gen).to(cdt) for _ in range(2))
        pos = torch.full((B,), -1, dtype=torch.int32, device=dev)
        floors[f"B4 {label}, pos = -1"] = timed(
            torch, lambda: md.mega_decode_step(q, k, v, kc, vc, pos), flush)
        both = torch.cat([kc.reshape(-1), vc.reshape(-1)])
        floors[f"torch.sum of {both.numel() * both.element_size()} B "
               f"{label}"] = timed(torch, both.sum, flush)
        del both
    print("  floors: " + ", ".join(f"{n} {t:.4f} ms"
                                    for n, t in floors.items()), flush=True)
    return errs, rows


def b4_timed(torch, md, flush, gen, shape, qdt, cdt, pv, what):
    """Time one B4 launch at ``shape`` = (B, L, nh, nkv, hd), q/k/v of
    ``qdt``, caches of ``cdt``, positions ``pv``, beside its plain version,
    SDPA over the same cache (mask l <= pos: the kernel has written the
    new rows by then; attention only) and the bound; returns the row."""
    B, L, nh, nkv, hd = shape
    dev = torch.device("cuda")
    q = torch.randn(B, 1, nh, hd, device=dev, generator=gen).to(qdt)
    k, v = (torch.randn(B, 1, nkv, hd, device=dev, generator=gen).to(qdt)
            for _ in range(2))
    kc, vc = (torch.randn(B, L, nkv, hd, device=dev, generator=gen).to(cdt)
              for _ in range(2))
    pos = torch.tensor(pv, dtype=torch.int32, device=dev)
    ms = timed(torch, lambda: md.mega_decode_step(q, k, v, kc, vc, pos),
               flush)
    plain_ms = timed(torch, lambda: md.mega_decode_step_plain(
        q, k, v, kc, vc, pos), flush, iters=10)
    q4 = q.to(cdt).transpose(1, 2)
    k4, v4 = kc.transpose(1, 2), vc.transpose(1, 2)
    lid = torch.arange(L, device=dev)
    mask = (lid[None, :] <= pos.long()[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timed(torch, lambda: sdpa(q4, k4, v4, attn_mask=mask), flush)
    nbytes, ops = b4_cost(pv, L, nh, nkv, hd, q.element_size(),
                          kc.element_size())
    bound_ms, by = bound(nbytes, ops)
    print(f"  mega_decode_step {what}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by}: {nbytes} B, {ops} ops)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=ops)


def check_mega_decode_llama(torch, md, flush, rng_pos):
    """Phase 3, B4 at LLaMA-13B's serving shape (B=8, L=2048, 40 heads of
    128, bf16 q and cache, as phase 15 runs it): kernel vs plain at
    positions that include the chunk edges of its plan, then timed
    serving-like and full."""
    B, L, nh, hd = B_SLICE, LLAMA_L, LLAMA_HEADS, LLAMA_HD
    gen = torch.Generator(device="cuda").manual_seed(13)
    chunk, nchunks = md.plan_chunks(B, nh, L, md._sm_count(0))
    print(f"  mega_decode_step chunks at B={B} nkv={nh} L={L}: {nchunks} "
          f"of {chunk} rows, {B * nh * nchunks} blocks", flush=True)
    pos_sets = [rng_pos, [L] * B,
                [0, chunk - 1, chunk, chunk + 1, L - chunk, L - 1, L, -1]]
    worst = max(b4_vs_plain(torch, md, gen, torch.bfloat16, torch.bfloat16,
                            2e-2, nh, nh, hd, pv, L=L) for pv in pos_sets)
    print(f"  mega_decode_step llama_13b bf16 q and cache, L={L}: max |ctx "
          f"err| {worst:.3e} (tol 2e-2), caches bit-exact", flush=True)
    rows = {where: b4_timed(torch, md, flush, gen, (B, L, nh, nh, hd),
                            torch.bfloat16, torch.bfloat16, pv,
                            f"llama_13b bf16 {where}")
            for pv, where in ((rng_pos, "serving-like pos"),
                              ([L] * B, "full cache"))}
    return worst, rows


def check_mega_decode_draft(torch, md, flush, rng_pos):
    """Phase 3, B4 at phase 24's draft shape (GPT-125M's single-token
    steps: B=8, L=2048, 12 heads of 64, f32 q and cache): kernel vs plain
    at positions that include the chunk edges of its plan and a free
    slot's, then timed serving-like (the draft steps at pos + 1..3)."""
    B, L, nh, hd = B_SLICE, 2048, NKV, HD
    gen = torch.Generator(device="cuda").manual_seed(24)
    chunk, nchunks = md.plan_chunks(B, nh, L, md._sm_count(0))
    print(f"  mega_decode_step chunks at B={B} nkv={nh} L={L}: {nchunks} "
          f"of {chunk} rows, {B * nh * nchunks} blocks", flush=True)
    pos_sets = [[p + 2 for p in rng_pos], [L] * B,
                [1, chunk - 1, chunk, chunk + 1, L - chunk, L - 1, L, 3]]
    worst = max(b4_vs_plain(torch, md, gen, torch.float32, torch.float32,
                            1e-5, nh, nh, hd, pv, L=L) for pv in pos_sets)
    print(f"  mega_decode_step draft f32 q and cache, L={L}: max |ctx err| "
          f"{worst:.3e} (tol 1e-5), caches bit-exact", flush=True)
    row = b4_timed(torch, md, flush, gen, (B, L, nh, nh, hd), torch.float32,
                   torch.float32, [p + 2 for p in rng_pos],
                   "draft f32 serving-like pos")
    return worst, row


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


def paged_indices(np, rng, n, NP, PS, mix):
    """(phys, off, valid) int32 numpy for n rows into an [NP, PS, ...]
    pool: valid rows at distinct (page, offset) pairs; with ``mix``, a
    quarter of the rows are invalid and aimed where valid rows write or at
    page 0, and three valid ones fall out of range (page NP, page -1,
    offset PS)."""
    flat = rng.choice(NP * PS, n, replace=False)
    phys, off = (flat // PS).astype(np.int32), (flat % PS).astype(np.int32)
    valid = np.ones(n, np.int32)
    if mix:
        bad = rng.choice(n, max(4, n // 4), replace=False)
        valid[bad] = 0
        src = rng.choice(np.setdiff1d(np.arange(n), bad), bad.shape[0])
        phys[bad], off[bad] = phys[src], off[src]
        phys[bad[::2]] = 0
        oor = rng.choice(np.setdiff1d(np.arange(n), bad), 3, replace=False)
        valid[oor] = 1
        phys[oor[0]], phys[oor[1]], off[oor[2]] = NP, -1, PS
    return phys, off, valid


def check_paged_write(torch, np, cw, flush):
    """Phase 3, B3 paged: kernel vs plain into the paged engine's pool
    [512, 16, 12, 64] at the decode shape (n = 8) and an admission shape
    (n = 512), bit-exact; times with every row valid (the main path's
    case)."""
    NP, PS, nkv, hd = NUM_PAGES, PAGE, NKV, HD
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rng = np.random.default_rng(7)

    def make(kind, n):
        if kind == "int8 pages":
            c = torch.randint(-127, 128, (NP, PS, nkv, hd), device=dev,
                              generator=gen, dtype=torch.int8)
            r = torch.randint(-127, 128, (n, nkv, hd), device=dev,
                              generator=gen, dtype=torch.int8)
        elif kind == "f32 scale plane":
            c = torch.rand(NP, PS, nkv, device=dev, generator=gen)
            r = torch.rand(n, nkv, device=dev, generator=gen)
        else:
            dt = torch.bfloat16 if kind == "bf16 pages" else torch.float32
            c = torch.randn(NP, PS, nkv, hd, device=dev, generator=gen).to(dt)
            r = torch.randn(n, nkv, hd, device=dev, generator=gen).to(dt)
        return c, r

    rows = {}
    for kind in ("bf16 pages", "int8 pages", "f32 scale plane", "f32 pages"):
        for n, shape in ((B_SLICE, "decode"), (512, "admission")):
            for mix in (True, False):
                c, r = make(kind, n)
                idx = [torch.from_numpy(a).to(dev)
                       for a in paged_indices(np, rng, n, NP, PS, mix)]
                c1, c2 = c.clone(), c.clone()
                cw.fused_paged_write(c1, r, *idx)
                cw.fused_paged_write_plain(c2, r, *idx)
                torch.cuda.synchronize()
                if not torch.equal(c1, c2) or torch.equal(c1, c):
                    fail(f"fused_paged_write {kind} n={n} mix={mix}: pools "
                         "differ from the plain version's (or nothing was "
                         "written)")
            c, r = make(kind, n)
            phys, off, valid = (torch.from_numpy(a).to(dev) for a in
                                paged_indices(np, rng, n, NP, PS, False))
            ms = timed(torch, lambda: cw.fused_paged_write(c, r, phys, off,
                                                           valid), flush)
            plain_ms = timed(torch, lambda: cw.fused_paged_write_plain(
                c, r, phys, off, valid), flush)
            pv, ov = phys.long(), off.long()
            lib_ms = timed(torch, lambda: c.index_put_((pv, ov), r), flush)
            nbytes = 2 * r.numel() * r.element_size() + 3 * n * 4
            bound_ms, by = bound(nbytes, 0)
            rows[(kind, shape)] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=bound_ms,
                                       bound_by=by, bytes=nbytes)
            print(f"  fused_paged_write {kind} n={n} ({shape}): bit-exact; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_put "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.6f} ms ({by}: "
                  f"{nbytes} B)", flush=True)
    return rows


def same(torch, a, b):
    """Equal bit for bit, but for NaN payloads: NaN at the same places."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def check_quant(torch, cw):
    """Phase 3: ``quant_rows`` on the card against the CPU, bit for bit
    (IEEE amax / 127 on both), over 49,152 rows of 64; beside it, how many
    scales amax / 127.0 by a Python number gives otherwise (PyTorch's CUDA
    division by a Python number multiplies by the f32 reciprocal)."""
    gen = torch.Generator().manual_seed(11)
    x = (torch.randn(4096, NKV, HD, generator=gen)
         * torch.rand(4096, NKV, 1, generator=gen) * 4)
    q_cpu, s_cpu = cw.quant_rows(x)
    xc = x.cuda()
    q, s = cw.quant_rows(xc)
    n_old = int((xc.abs().amax(-1) / 127.0).cpu().ne(s_cpu).sum())
    torch.cuda.synchronize()
    if not (torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)):
        fail("quant_rows: the card's int8 rows or scales differ from the "
             "CPU's")
    print(f"  quant_rows: card == CPU bit for bit over {s_cpu.numel()} rows"
          f"; amax / 127.0 by a Python number gives another scale in "
          f"{n_old} of them", flush=True)


def composite_paged_write(torch, cw, pool, rows, bt, pos, live=None,
                          wlen=None):
    """One half as the paged path wrote it before ``kv_paged_write``: the
    page arithmetic in tensor ops, the cast (or ``quant_rows``), a
    contiguous copy, then ``fused_paged_write`` on each pool leaf. A layer
    made two such calls."""
    pages, bt = pool["pages"], bt.long()
    PS, dev = pages.shape[1], pages.device
    B, S = rows.shape[0], rows.shape[1]
    PM = bt.shape[1]
    s_ids = torch.arange(S, device=dev)
    if isinstance(pos, torch.Tensor):
        base = pos.to(torch.int64)[:, None]
    else:
        base = torch.full((B, 1), int(pos), dtype=torch.int64, device=dev)
    t = base + s_ids[None, :]
    valid = t < PM * PS
    if live is not None:
        valid = valid & live[:, None]
    if wlen is not None:
        valid = valid & (s_ids[None, :] < wlen)
    page_slot = torch.clamp(torch.div(t, PS, rounding_mode="floor"), 0,
                            PM - 1)
    n = B * S
    phys = torch.gather(bt, 1, page_slot).reshape(n).to(torch.int32)
    off = torch.remainder(t, PS).reshape(n).to(torch.int32)
    valid = valid.reshape(n).to(torch.int32)
    if "scale" in pool:
        qrows, scale = cw.quant_rows(rows)
        cw.fused_paged_write(pages, qrows.reshape((n,) + qrows.shape[2:]),
                             phys, off, valid)
        cw.fused_paged_write(pool["scale"], scale.reshape(
            (n,) + scale.shape[2:]), phys, off, valid)
        return
    cw.fused_paged_write(pages, rows.to(pages.dtype).reshape(
        (n,) + rows.shape[2:]).contiguous(), phys, off, valid)


def kv_targets(np, bt, pos, S, PS, live, wlen, NP):
    """Host view of one kv_paged_write: (pool rows written a half,
    distinct (b, page slot) table entries read). Fails the script if two
    valid rows of one half would land on one pool row (the cases below
    never do)."""
    bt = np.asarray(bt)
    B, PM = bt.shape
    base = (np.asarray(pos, np.int64)[:, None] if np.ndim(pos)
            else np.full((B, 1), int(pos), np.int64))
    t = base + np.arange(S)[None, :]
    ok = t < PM * PS
    if live is not None:
        ok &= np.asarray(live)[:, None]
    if wlen is not None:
        ok &= np.arange(S)[None, :] < wlen
    slot = np.clip(np.floor_divide(t, PS), 0, PM - 1)
    phys = np.take_along_axis(bt, slot, 1)
    ok &= (phys >= 0) & (phys < NP)
    flat = (phys * PS + np.mod(t, PS))[ok]
    if np.unique(flat).shape[0] != flat.shape[0]:
        fail("kv_paged_write case: two valid rows target one pool row")
    b_ids = np.broadcast_to(np.arange(B)[:, None], t.shape)
    entries = np.unique((b_ids * PM + slot)[ok]).shape[0]
    return flat.shape[0], entries


# kv_paged_write's cases: (name, B, S, pos, live, wlen, bad table entries
# {(b, slot): page}). Decode at serving-like positions (pos None: phase 3's
# rng_pos) and at the page edges, -1, -3 and past the table with a dead row
# and two table entries out of [0, NP); a speculative verify block of 5
# across page edges, from -2 and running past the table; admissions of 512
# rows from 0 with wlen 300, from an unaligned 261, from 700 (past the
# table), and a block of 8 from -3.
KV_PAGED_CASES = (
    ("decode", B_SLICE, 1, None, None, None, {}),
    ("decode edges", B_SLICE, 1, [15, 16, 17, -1, -3, 0, 1024, 1031],
     [True, True, True, True, True, False, True, True], None,
     {(3, 0): -1, (1, 1): NUM_PAGES + 5}),
    ("verify", B_SLICE, 5, [14, 15, 16, 300, 1020, -2, 47, 511],
     [True, True, True, True, True, True, False, True], None, {}),
    ("admission wlen", 1, 512, 0, None, 300, {}),
    ("admission 261", 1, 512, 261, None, None, {}),
    ("admission past", 1, 512, 700, None, None, {}),
    ("block -3", 1, 8, -3, None, None, {}),
)
# (pool, rows) dtypes: the f32 model's rows into bf16, f32 and int8 pools
# (phases 9-12), and bf16 rows into each
KV_PAGED_KINDS = (("bf16", "f32"), ("f32", "f32"), ("int8", "f32"),
                  ("bf16", "bf16"), ("f32", "bf16"), ("int8", "bf16"))


# the rows kv_paged_write is timed at: (pool kind, shape, rows kind)
KV_PAGED_TIMED = (("bf16", "decode", "f32"), ("int8", "decode", "f32"),
                  ("f32", "decode", "f32"), ("bf16", "admission", "f32"),
                  ("int8", "admission", "f32"))


def check_kv_paged_write(torch, np, cw, flush, rng_pos, NP=NUM_PAGES,
                         nkv=NKV, hd=HD, L=L_SLICE, cases=KV_PAGED_CASES,
                         kinds=KV_PAGED_KINDS, timing=KV_PAGED_TIMED):
    """Phase 3, B3 paged fused: ``kv_paged_write`` against its plain version
    (and the composite it replaced) into two [NP, 16, nkv, hd] pool halves
    with L / 16-page tables ([512, 16, 12, 64] and 64 pages for the GPT
    slice), the rows cut from a [B, S, 3 x nkv hd] qkv output as GPT cuts
    them; every case of ``cases`` in every kind of ``kinds``, both pool
    leaves compared (NaN where NaN: one k head row is all zero, one v row
    holds a NaN). Times the main path's rows (``timing``: decode, n = 8 a
    half, verify, n = 8 x 5, and admission, n = 512) beside the
    composite, index_put_ on each leaf with the indices precomputed, and
    the byte bound."""
    PS = PAGE
    PM, H = L // PS, nkv * hd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.default_rng(9)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}

    def pool(kind):
        shape = (NP, PS, nkv, hd)
        if kind == "int8":
            return {"pages": torch.randint(-127, 128, shape, device=dev,
                                           generator=gen, dtype=torch.int8),
                    "scale": torch.rand(shape[:3], device=dev,
                                        generator=gen)}
        return {"pages": torch.randn(shape, device=dev,
                                     generator=gen).to(dts[kind])}

    def inputs(case, rows_kind, specials=True):
        _, B, S, pos, live, wlen, bad = case
        pos = rng_pos if pos is None else pos
        qkv = torch.randn(B, S, 3 * H, device=dev, generator=gen)
        if specials:
            qkv[0, 0, H:H + hd] = 0.0
            qkv[-1, -1, 2 * H + 2 * hd + 5] = float("nan")
        qkv = qkv.to(dts[rows_kind])
        k = qkv[..., H:2 * H].reshape(B, S, nkv, hd)
        v = qkv[..., 2 * H:].reshape(B, S, nkv, hd)
        bt = rng.permutation(NP)[:B * PM].reshape(B, PM).astype(np.int64)
        for (b, slot), page in bad.items():
            bt[b, slot] = page
        n_rows, entries = kv_targets(np, bt, pos, S, PS, live, wlen, NP)
        tpos = (torch.tensor(pos, dtype=torch.int32, device=dev)
                if isinstance(pos, list) else pos)
        tlive = None if live is None else torch.tensor(live, device=dev)
        return (k, v, torch.from_numpy(bt).to(dev), tpos, tlive, wlen,
                n_rows, entries)

    def clone(p):
        return {n: t.clone() for n, t in p.items()}

    for kind, rows_kind in kinds:
        for case in cases:
            k, v, bt, pos, live, wlen, _, _ = inputs(case, rows_kind)
            pools = [pool(kind), pool(kind)]
            got, want, comp = ([clone(p) for p in pools] for _ in range(3))
            cw.kv_paged_write(k, v, *got, bt, pos, live, wlen)
            cw.kv_paged_write_plain(k, v, *want, bt, pos, live, wlen)
            for p, rows in zip(comp, (k, v)):
                composite_paged_write(torch, cw, p, rows, bt, pos, live,
                                      wlen)
            torch.cuda.synchronize()
            for g, w, c, p in zip(got, want, comp, pools):
                for n in p:
                    if not same(torch, g[n], w[n]) or torch.equal(g[n],
                                                                  p[n]):
                        fail(f"kv_paged_write {kind} pool, {rows_kind} rows"
                             f", {case[0]}: {n} differs from the plain "
                             "version's (or nothing was written)")
                    if not same(torch, c[n], w[n]):
                        fail(f"kv_paged_write {kind} pool, {rows_kind} rows"
                             f", {case[0]}: the composite's {n} differs "
                             "from the plain version's")
        print(f"  kv_paged_write {kind} pool [{NP}, {PS}, {nkv}, {hd}], "
              f"{rows_kind} rows: bit-exact (NaN where NaN) with the plain "
              f"version and the composite in {len(cases)} cases",
              flush=True)

    rows = {}
    for kind, shape, rows_kind in timing:
        case = {"decode": (shape, B_SLICE, 1, None, None, None, {}),
                "verify": (shape, B_SLICE, DRAFT_K + 1, None, None, None,
                           {})}.get(shape, (shape, 1, 512, 0, None, None, {}))
        k, v, bt, pos, _, _, n_rows, entries = inputs(case, rows_kind,
                                                       specials=False)
        pools = [pool(kind), pool(kind)]
        ms = timed(torch, lambda: cw.kv_paged_write(k, v, *pools, bt, pos),
                   flush)
        plain_ms = timed(torch, lambda: cw.kv_paged_write_plain(
            k, v, *pools, bt, pos), flush)

        def composite():
            for p, r in zip(pools, (k, v)):
                composite_paged_write(torch, cw, p, r, bt, pos)
        comp_ms = timed(torch, composite, flush)
        S = k.shape[1]
        t = (pos.long()[:, None] if isinstance(pos, torch.Tensor)
             else torch.full((1, 1), pos, device=dev)) + torch.arange(
                 S, device=dev)
        phys = torch.gather(bt, 1, t // PS).reshape(-1)
        off = (t % PS).reshape(-1)
        leaves = []
        for p, r in zip(pools, (k, v)):
            if kind == "int8":
                q, s = cw.quant_rows(r)
                leaves += [(p["pages"], q.reshape(-1, nkv, hd)),
                           (p["scale"], s.reshape(-1, nkv))]
            else:
                leaves.append((p["pages"], r.to(p["pages"].dtype).reshape(
                    -1, nkv, hd)))

        def lib():
            for dst, src in leaves:
                dst.index_put_((phys, off), src)
        lib_ms = timed(torch, lib, flush)
        el = pools[0]["pages"].element_size()
        nbytes = (2 * n_rows * nkv * hd * (k.element_size() + el)
                  + (2 * n_rows * nkv * 4 if kind == "int8" else 0)
                  + entries * 8
                  + (k.shape[0] * 4 if isinstance(pos, torch.Tensor) else 0))
        bound_ms, by = bound(nbytes, 0)
        rows[(kind, shape)] = dict(ms=ms, plain_ms=plain_ms,
                                   composite_ms=comp_ms, library_ms=lib_ms,
                                   bound_ms=bound_ms, bound_by=by,
                                   bytes=nbytes)
        print(f"  kv_paged_write {kind} pool [{NP}, {PS}, {nkv}, {hd}], "
              f"{rows_kind} rows, n={n_rows} a half ({shape}): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"composite (2 calls) {comp_ms:.4f} ms, index_put_ "
              f"({len(leaves)} leaves) {lib_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({by}: {nbytes} B)", flush=True)
    return rows


def check_kv_slot_write(torch, cw, flush, rng_pos):
    """Phase 3, B3 slot fused: ``kv_slot_write`` against its plain version
    on the int8 slot decode's four planes ([8, 1024, 12, 64] int8 data and
    [8, 1024, 12] f32 scales, k and v) at pos sets with -1, L and L + 7,
    and on one, two and three planes of other types (bf16 rows of 3 x 33,
    f32 data, an f32 plane of 5); times the four int8 planes beside four
    fused_slot_write launches, four index_put_ calls and the byte bound."""
    B, L, nkv, hd = B_SLICE, L_SLICE, NKV, HD
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)

    def int8_planes():
        out = []
        for _ in range(2):
            out.append((torch.randint(-127, 128, (B, L, nkv, hd), device=dev,
                                      generator=gen, dtype=torch.int8),
                        torch.randint(-127, 128, (B, 1, nkv, hd), device=dev,
                                      generator=gen, dtype=torch.int8)))
            out.append((torch.rand(B, L, nkv, device=dev, generator=gen),
                        torch.rand(B, 1, nkv, device=dev, generator=gen)))
        return out

    def other_planes(n):
        shapes = [((3, 33), torch.bfloat16), ((nkv, hd), torch.float32),
                  ((5,), torch.float32)][:n]
        return [(torch.randn((B, L) + s, device=dev, generator=gen).to(dt),
                 torch.randn((B, 1) + s, device=dev, generator=gen).to(dt))
                for s, dt in shapes]

    odd = [L + 7, 0, -1, 3, 1000, L - 1, 2, 64]
    cases = [(int8_planes, [0, 1, 5, 5, 511, 700, L - 1, L]),
             (int8_planes, odd), (int8_planes, rng_pos)] + [
        (lambda n=n: other_planes(n), odd) for n in (1, 2, 3)]
    for make, pv in cases:
        planes = make()
        pos = torch.tensor(pv, dtype=torch.int32, device=dev)
        got = [c.clone() for c, _ in planes]
        want = [c.clone() for c, _ in planes]
        cw.kv_slot_write(got, [r for _, r in planes], pos)
        cw.kv_slot_write_plain(want, [r for _, r in planes], pos)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"kv_slot_write {len(planes)} planes pos={pv}: caches "
                 "differ from the plain version's")
    planes = int8_planes()
    caches, rws = [c for c, _ in planes], [r for _, r in planes]
    pos = torch.tensor(rng_pos, dtype=torch.int32, device=dev)
    ms = timed(torch, lambda: cw.kv_slot_write(caches, rws, pos), flush)
    plain_ms = timed(torch, lambda: cw.kv_slot_write_plain(caches, rws, pos),
                     flush)

    def composite():
        for c, r in planes:
            cw.fused_slot_write(c, r, pos)
    comp_ms = timed(torch, composite, flush)
    ar, pl = torch.arange(B, device=dev), pos.long()

    def lib():
        for c, r in planes:
            c[ar, pl] = r[:, 0]
    lib_ms = timed(torch, lib, flush)
    nbytes = sum(2 * r.numel() * r.element_size() for r in rws) + B * 4
    bound_ms, by = bound(nbytes, 0)
    print(f"  kv_slot_write: bit-exact in {len(cases)} cases (4 int8 planes "
          f"at three pos sets; 1, 2, 3 planes of bf16 / f32); 4 int8 planes:"
          f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, 4 x "
          f"fused_slot_write {comp_ms:.4f} ms, 4 x index_put_ {lib_ms:.4f} "
          f"ms, bound {bound_ms:.6f} ms ({by}: {nbytes} B)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, composite_ms=comp_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                bytes=nbytes)


def close(torch, got, want, rtol, atol_frac):
    """Element-by-element check ``|got - want| <= rtol |want| + atol`` on
    the entries where the reference is finite (the others must be equal),
    with ``atol = atol_frac * typical`` and ``typical`` the median of the
    nonzero |want| in an even subsample of at most 2^20 entries: the size
    of a typical entry, so that no single large entry sets the limit for
    the rest, and entries that are 0 by masking do not shrink it.
    Returns (max |err|, typical, worst err / limit); the check passes when
    the last is <= 1, and it is inf where the two disagree on which
    entries are finite."""
    g, w = got.float(), want.float()
    fin = w.isfinite()
    if not bool((g.isfinite() == fin).all()) or not torch.equal(
            torch.where(fin, 0.0, g), torch.where(fin, 0.0, w)):
        return float("inf"), 0.0, float("inf")
    a = torch.where(fin, w, 0.0).abs()
    sub = a.flatten()[::max(1, a.numel() >> 20)]
    sub = sub[sub > 0]
    typical = sub.median().item() if sub.numel() else 0.0
    err = torch.where(fin, g - w, 0.0).abs()
    limit = a.mul_(rtol).add_(atol_frac * typical)
    worst = torch.where(limit > 0, err / limit,
                        torch.where(err > 0, float("inf"), 0.0)).max()
    return err.max().item(), typical, worst.item()


# Limits (rtol, atol_frac) for close(), element by element:
# - lse and per-row loss (f32): the log of an f32 sum at 6-16, where one
#   f32 step is ~1e-6: 1e-6 of each entry plus 1e-6 of a typical one
#   (on the card: at most 1.9e-6, two steps).
# - f32 outputs of B1 (out, dq, dk, dv): the same f32 operations as the
#   plain version with sums of up to 1,024 terms taken in another order,
#   so 1e-5 of each entry plus 5e-5 of a typical one.
#   An entry that cancels to near 0 (dq, dk) keeps the f32 error of its
#   larger terms: on the card up to 8e-7, 1.5e-5 of a typical |dq| or
#   |dk| (0.03-0.05).
# - bf16 outputs of B1 and B5: both sides take every product as an f32
#   product of the inputs (the tensor-core kernels carry P and dS into
#   their bf16 products as bf16 parts: three for the forward's P, within
#   2^-24, two for the backward's P and dS, within 2^-16) and round
#   their own f32 result to bf16, so an entry may differ by one bf16 step,
#   at most 2^-7 of its size; the atol of one step of a typical entry
#   covers the f32 differences of entries that cancel to near 0 (dq, dk).
#   A kernel that rounded P or dS to bf16 (as _pallas_flash does) would
#   not hold it: phase 3 prints how far SDPA and aten flash, which round P,
#   sit from the same plain version.
# - dlogits: an elementwise exp of the same f32 values, no sum, so one
#   step of the output type (2^-7 bf16, 1e-6 f32) and no atol: a zero
#   (a masked column) must stay exactly zero.
# - bf16 outputs of the sp ring (phase 13) are held in norm, not entry by
#   entry: each entry is the f32 sum of sp = 4 block terms (the merged
#   block outputs, or the blocks' dq / dk / dv contributions) that the
#   kernel rounded to bf16 one by one, then rounded once more, and where
#   those terms cancel (dk, dv of the early keys, which every query sees)
#   the error is half a step of a term several times the entry (a CPU
#   rehearsal with the plain versions: 1.2 % of an entry of |dv| ~ 2.7,
#   3 % of one of |dk| ~ 0.5). The RMS of the error must stay within
#   RMS_SP_BF16 of the reference's RMS: 4 steps, where a block at a wrong
#   offset or an accumulator rotated the wrong way gives errors of the
#   entries' own size. The kernel itself is held entry by entry in phase 3.
# - the sp step's losses (phase 14) against phase 8's: the same weights,
#   batch and optimizer, the attention rounded as above. A CPU rehearsal
#   (plain versions, 2 layers of gpt_125m, batch 2 x 1024, 6 steps)
#   measured a max rel 2.0e-5; LOSS_RTOL_SP is 50 times that, and 25 times
#   below one step's change of the loss (~2.5 %), so a ring that trained
#   differently would show.
LIM_LSE = (1e-6, 1e-6)
LIM_F32 = (1e-5, 5e-5)
LIM_BF16 = (2.0 ** -7, 2.0 ** -7)
RMS_SP_BF16 = 2.0 ** -6
LOSS_RTOL_SP = 1e-3
LIM_DLOGITS = {"bf16": (2.0 ** -7, 0.0), "f32": (1e-6, 0.0)}


def check_all(torch, what, comparisons):
    """Run close() on each (name, got, want, (rtol, atol_frac)), print
    every result on one line, then fail if any is over its limit.
    Returns {name: max |err|}."""
    row, bad, parts = {}, [], []
    for name, got, want, (rtol, atol_frac) in comparisons:
        err, typical, worst = close(torch, got, want, rtol, atol_frac)
        row[name] = err
        parts.append(f"{name} {err:.3e} (typical {typical:.3e}, limit "
                     f"{rtol:.3g}|x| + {atol_frac:.3g} typical, worst "
                     f"{worst:.3g} of limit)")
        if not worst <= 1.0:
            bad.append(name)
    print(f"  {what}: max |err| " + "; ".join(parts), flush=True)
    if bad:
        fail(f"{what}: {', '.join(bad)} over the limit")
    return row


def rms_ratio(torch, got, want):
    """RMS(got - want) / RMS(want), in f32."""
    g, w = got.float(), want.float()
    return ((g - w).square().mean().sqrt() / w.square().mean().sqrt()).item()


def check_rms(torch, what, comparisons, limit):
    """Fail unless RMS(got - want) <= limit * RMS(want) for each (name,
    got, want); prints the ratios and the max |err|."""
    parts, bad = [], []
    for name, got, want in comparisons:
        ratio = rms_ratio(torch, got, want)
        parts.append(f"{name} rms ratio {ratio:.3e} (max |err| "
                     f"{(got.float() - want.float()).abs().max().item():.3e})")
        if not ratio <= limit:
            bad.append(name)
    print(f"  {what}: " + "; ".join(parts) + f"; limit {limit:.3g}",
          flush=True)
    if bad:
        fail(f"{what}: {', '.join(bad)} over the limit")


def b1_cost(B, H, Sq, Sk, D, causal, q_off, k_off, elem):
    """(fwd bytes, fwd ops, bwd bytes, bwd ops) at these shapes: each
    input read once and each output written once; 2 matmuls of 2*D
    operations per visible (query, key) pair forward, 5 backward
    (s recomputed, dP, dV, dK, dQ)."""
    if causal:
        pairs = sum(max(0, min(Sk, q_off + i - k_off + 1))
                    for i in range(Sq))
    else:
        pairs = Sq * Sk
    pairs *= B * H
    q_b, kv_b, lse_b = B * H * Sq * D * elem, B * H * Sk * D * elem, \
        B * H * Sq * 4
    fwd_bytes = 2 * q_b + 2 * kv_b + lse_b           # q, k, v in; out, lse
    bwd_bytes = 3 * q_b + 2 * kv_b + lse_b + q_b + 2 * kv_b  # + dq, dk, dv
    return fwd_bytes, 4 * D * pairs, bwd_bytes, 10 * D * pairs


def short_kernel_name(mangled):
    """``fwd_tc_kernel<64, 2>`` from its mangled name (template arguments
    in order: D, consumer warpgroups, DELTA_IN), a plain kernel's name
    alone."""
    import re
    name, rest = mangled, ""
    # <length><name> of the kernel; the length's digits may follow other
    # digits (an anonymous namespace's hash), so try each suffix of a run
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
        digits, start = m.group(1), m.end()
        for i in range(len(digits)):
            cand = mangled[start:start + int(digits[i:])]
            if (cand.endswith("_kernel")
                    and mangled[start + len(cand):][:1] in ("E", "I")):
                name, rest = cand, mangled[start + len(cand):]
    if not rest.startswith("I"):
        return name
    args = re.findall(r"Li(\d+)E|Lb(\d)E", rest.split("EEv")[0])
    return f"{name}<" + ", ".join(
        a or ("true" if b == "1" else "false") for a, b in args) + ">"


def tc_smem(lib, name):
    """The dynamic shared memory (bytes) a tensor-core flash kernel asks
    for, from its short name (``fwd_tc_kernel<64, 2>`` of the bf16
    library, ``dq_tf32_kernel<64, false>`` of the f32 one); 0 for a kernel
    without templates."""
    if "<" not in name:
        return 0
    pas = 0 if name.startswith("fwd") else 1 if name.startswith("dq") else 2
    args = [int(x) for x in name.split("<")[1].rstrip(">").split(", ")
            if x.isdigit()]
    if "_tf32_" in name:
        return lib.flash_tf32_smem_bytes(pas, args[0])
    return lib.flash_tc_smem_bytes(pas, args[0], args[1])


def path_counts(*wrappers):
    """(tensor-core, SIMT) launch counts summed over ``wrappers``."""
    return (sum(w.tc_launches for w in wrappers),
            sum(w.simt_launches for w in wrappers))


def reset_counts(*wrappers):
    for w in wrappers:
        w.launches = w.tc_launches = w.simt_launches = 0


def expect_path(what, fa, dt, D, counts, n):
    """Fail unless the ``n`` launches behind ``counts`` = (tc, simt) all
    took the path ``fa._tc_path`` gives for (dt, D)."""
    want = (n, 0) if fa._tc_path(dt, D) else (0, n)
    if counts != want:
        fail(f"{what}: (tensor-core, SIMT) launches {counts} != {want}")


def evidence(torch, what, pairs, f32=False):
    """Print worst error / limit (LIM_BF16, or LIM_F32 for f32 inputs) of
    each (name, library's result, plain version's): how far the library
    call sits from the f32 products that the kernel is held to (not a
    check)."""
    lim, lim_name = (LIM_F32, "LIM_F32") if f32 else (LIM_BF16, "LIM_BF16")
    print(f"    {what} vs the plain version (worst / {lim_name}): " + ", ".join(
        f"{n} {close(torch, g, w, *lim)[2]:.3g}" for n, g, w in pairs),
        flush=True)


def simt_entry(fa, name):
    """A SIMT flash kernel's C entry (``csrc/flash_attention.cu``), which
    the wrappers no longer launch for f32 at D 64: phase 3 times the
    previous design beside the new one through it."""
    return getattr(fa._build.load("flash_attention", fa._SIGNATURES),
                   f"{name}_launch")


def simt_flash_fwd(torch, fa, q, k, v, causal, scale, q_off=0, k_off=0):
    """(out, lse) of B1's SIMT forward kernel on these inputs."""
    from paddle_tpu_torch.kernels import ptr, stream_ptr
    B, H, Sq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    rc = simt_entry(fa, "flash_fwd")(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse),
        *fa._geo(B * H, Sq, k.shape[2], D, causal, q_off, k_off, scale,
                 q.dtype), stream_ptr(q.device))
    fa.check_launch("simt flash_fwd", rc)
    return out, lse


def simt_flash_bwd(torch, fa, q, k, v, lse, do, causal, scale, q_off=0,
                   k_off=0, out=None, delta=None):
    """(dq, dk, dv) of the SIMT backward: B1's (``out`` given) or B5's
    (``delta`` given)."""
    from paddle_tpu_torch.kernels import ptr, stream_ptr
    B, H, Sq, D = q.shape
    geo = fa._geo(B * H, Sq, k.shape[2], D, causal, q_off, k_off, scale,
                  q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if delta is None:
        scratch = torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device)
        rc = simt_entry(fa, "flash_bwd")(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(do), ptr(lse),
            ptr(scratch), ptr(dq), ptr(dk), ptr(dv), *geo,
            stream_ptr(q.device))
    else:
        rc = simt_entry(fa, "flash_block_bwd")(
            ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
            ptr(dk), ptr(dv), *geo, stream_ptr(q.device))
    fa.check_launch("simt flash_bwd", rc)
    return dq, dk, dv


def flash_peak(torch, fa, dt, D):
    """Operations a second at the peak of the route that B1/B5 take for
    (dt, D): bf16 wgmma; f32 on the tensor cores as three TF32 products
    an operation; f32 FMAs outside them (the SIMT kernels)."""
    if dt == torch.bfloat16:
        return BF16_OPS_PER_S
    return TF32_OPS_PER_S / 3 if fa._tc_path(dt, D) else F32_OPS_PER_S


def hold_to_f64(torch, what, got, plain, ref):
    """Hold the f32 kernels' (out, lse, dq, dk, dv) ``got`` to ``ref``,
    the plain formula in f64 on the same inputs (the backward at the same
    f32 residuals), at the f32 limits; print first how far the f32 plain
    version ``plain`` sits from it. Where the kernels pass here and fail
    against the plain version, the f32 plain version's rounding is what
    differs; where both fail, the kernels' own error."""
    names = ("out", "lse", "dq", "dk", "dv")
    lims = [LIM_LSE if n == "lse" else LIM_F32 for n in names]
    print("    plain vs f64 (worst / limit): " + ", ".join(
        f"{n} {close(torch, p, r, *lim)[2]:.3g}"
        for n, p, r, lim in zip(names, plain, ref, lims)), flush=True)
    check_all(torch, f"{what} vs f64", list(zip(names, got, ref, lims)))


# B1's cases at the training slice's shape: (dtype, causal, q_off, k_off);
# with keys from global position 512, query rows 0..511 see no key (out 0,
# lse -inf, zero grads)
B1_CASES = (("bfloat16", True, 0, 0), ("float32", True, 0, 0),
            ("bfloat16", False, 0, 0), ("float32", False, 0, 0),
            ("float32", True, 0, 512), ("bfloat16", True, 0, 512))


def check_flash(torch, fa, flush, shape=(B_SLICE, NKV, L_SLICE, HD),
                cases=B1_CASES, timing=("bfloat16", "float32"),
                timed_causal=True, kinds=("fwd", "bwd"), simt=True, sk=None):
    """Phase 3, B1: kernel vs plain at the training slice's shapes (or
    ``shape`` and ``cases``); bf16 (``LIM_BF16``) and f32 (``LIM_F32``)
    at D 64 take the tensor-core kernels, both held to the plain versions
    (f32 products), the f32 ones first to the same formula in f64
    (``hold_to_f64``). Beside each case without offsets: SDPA's error
    against the f32 plain version (its f32 path is the memory-efficient
    kernel, 3xTF32). Timed (``kinds`` of them, causal or not as
    ``timed_causal``): each dtype's kernels beside SDPA, the plain version
    and the bound of their route, and for f32 (with ``simt``) the SIMT
    kernels at the same inputs through their C entries (the design these
    replace) and their 67-TFLOP/s bound. ``sk``: keys of their own
    length (``shape``'s S is then the queries')."""
    B, H, S, D = shape
    Sk = S if sk is None else sk
    geo = f"{B}/{H}/{S}/{D}" if Sk == S else f"{B}/{H}/{S}x{Sk}/{D}"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    scale = 1.0 / D ** 0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    errs = {}
    for dt_name, causal, q_off, k_off in cases:
        dt = getattr(torch, dt_name)
        q, k, v, do = (torch.randn(B, H, n, D, device=dev,
                                   generator=gen).to(dt)
                       for n in (S, Sk, Sk, S))
        reset_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)
        out, lse = fa.flash_attn_fwd(q, k, v, causal, scale, q_off, k_off)
        out_p, lse_p = fa.flash_attn_fwd_plain(q, k, v, causal, scale, q_off,
                                               k_off)
        grads = fa.flash_attn_bwd(q, k, v, out_p, lse_p, do, causal, scale,
                                  q_off, k_off)
        grads_p = fa.flash_attn_bwd_plain(q, k, v, out_p, lse_p, do, causal,
                                          scale, q_off, k_off)
        torch.cuda.synchronize()
        what = (f"flash_attn {dt} B/H/S/D={geo} causal={causal} "
                f"q_off/k_off={q_off}/{k_off}")
        expect_path(what, fa, dt, D,
                    path_counts(fa.flash_attn_fwd, fa.flash_attn_bwd), 2)
        lim = LIM_BF16 if dt == torch.bfloat16 else LIM_F32
        if dt == torch.float32:
            q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
            ref = fa.flash_attn_fwd_plain(
                q64, k64, v64, causal, scale, q_off, k_off) + \
                fa.flash_attn_bwd_plain(q64, k64, v64, out_p.double(),
                                        lse_p.double(), do64, causal, scale,
                                        q_off, k_off)
            hold_to_f64(torch, what, (out, lse) + grads,
                        (out_p, lse_p) + grads_p, ref)
            del q64, k64, v64, do64, ref
        row = check_all(
            torch, what, (("out", out, out_p, lim),
                          ("lse", lse, lse_p, LIM_LSE),
                          ("dq", grads[0], grads_p[0], lim),
                          ("dk", grads[1], grads_p[1], lim),
                          ("dv", grads[2], grads_p[2], lim)))
        if k_off > q_off and not (bool((lse[:, :, :k_off] == float(
                "-inf")).all()) and not out[:, :, :k_off].any()
                and not grads[0][:, :, :k_off].any()):
            fail("flash: fully masked rows must give out 0, lse -inf, dq 0")
        errs[(dt, causal, k_off)] = row
        if q_off == k_off:                   # SDPA has no offsets
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            o_l = sdpa(*leaves, is_causal=causal)
            g_l = torch.autograd.grad(o_l, leaves, do)
            evidence(torch, "SDPA", list(zip(("out", "dq", "dk", "dv"),
                                             (o_l,) + g_l,
                                             (out_p,) + grads_p)),
                     f32=dt == torch.float32)

    rows = {}
    for dt in (getattr(torch, n) for n in timing):
        q, k, v, do = (torch.randn(B, H, n, D, device=dev,
                                   generator=gen).to(dt)
                       for n in (S, Sk, Sk, S))
        c = timed_causal
        out, lse = fa.flash_attn_fwd(q, k, v, c, scale)
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
        ms, plain, lib = {}, {}, {}
        ms["fwd"] = timed(torch, lambda: fa.flash_attn_fwd(q, k, v, c, scale),
                          flush)
        plain["fwd"] = timed(torch, lambda: fa.flash_attn_fwd_plain(
            q, k, v, c, scale), flush, iters=10)
        lib["fwd"] = timed(torch, lambda: sdpa(q, k, v, is_causal=c), flush)
        if "bwd" in kinds:
            ms["bwd"] = timed(torch, lambda: fa.flash_attn_bwd(
                q, k, v, out, lse, do, c, scale), flush)
            plain["bwd"] = timed(torch, lambda: fa.flash_attn_bwd_plain(
                q, k, v, out, lse, do, c, scale), flush, iters=10)
            lib["bwd"] = timed(torch, lambda: torch.autograd.grad(
                sdpa(qr, kr, vr, is_causal=c), (qr, kr, vr), do),
                flush) - lib["fwd"]
        simt_ms = {"fwd": None, "bwd": None}
        if dt == torch.float32 and simt:
            simt_ms["fwd"] = timed(torch, lambda: simt_flash_fwd(
                torch, fa, q, k, v, c, scale), flush)
            simt_ms["bwd"] = timed(torch, lambda: simt_flash_bwd(
                torch, fa, q, k, v, lse, do, c, scale, out=out), flush)
        fb, fo, bb, bo = b1_cost(B, H, S, Sk, D, c, 0, 0, q.element_size())
        cost = {"fwd": (fb, fo), "bwd": (bb, bo)}
        peak = flash_peak(torch, fa, dt, D)
        label = "bf16" if dt == torch.bfloat16 else "f32"
        for kind in kinds:
            nb, ops = cost[kind]
            bound_ms, by = bound(nb, ops, peak)
            rows[(label, kind)] = dict(
                ms=ms[kind], plain_ms=plain[kind], library_ms=lib[kind],
                bound_ms=bound_ms, bound_by=by)
            extra = "" if simt_ms[kind] is None else (
                f", SIMT kernel {simt_ms[kind]:.4f} ms (its bound "
                f"{bound(nb, ops)[0]:.4f} ms)")
            print(f"  flash_attn_{kind} {label} B/H/S/D={geo} "
                  f"{'causal' if c else 'non-causal'}: kernel "
                  f"{ms[kind]:.4f} ms, "
                  f"plain {plain[kind]:.4f} ms, sdpa {lib[kind]:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({by}: {nb} B, {ops} ops)"
                  f"{extra}", flush=True)
    return errs, rows


def check_flash_decode_tails(torch, fa, shape, sks):
    """Phase 3, B1 forward at one query row against ``sks`` keys (the
    decode's self-attention at its short caches: tail tiles of the
    64-row tensor-core tiles), non-causal, bf16, kernel against its plain
    version at LIM_BF16 (out) and LIM_LSE (lse). Forward only: the decode
    runs no backward, and at one key dq = dk = 0 exactly, so a backward
    there is rounding noise on both sides. Returns {sk: max |err|}."""
    B, H, D = shape
    gen = torch.Generator(device="cuda").manual_seed(31)
    errs = {}
    for sk in sks:
        q, k, v = (torch.randn(B, H, n, D, device="cuda",
                               generator=gen).to(torch.bfloat16)
                   for n in (1, sk, sk))
        reset_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)
        out, lse = fa.flash_attn_fwd(q, k, v, False, D ** -0.5)
        out_p, lse_p = fa.flash_attn_fwd_plain(q, k, v, False, D ** -0.5)
        torch.cuda.synchronize()
        what = (f"flash_attn_fwd bf16 B/H/S/D={B}/{H}/1x{sk}/{D} "
                "non-causal")
        expect_path(what, fa, torch.bfloat16, D,
                    path_counts(fa.flash_attn_fwd, fa.flash_attn_bwd), 1)
        row = check_all(torch, what, (("out", out, out_p, LIM_BF16),
                                      ("lse", lse, lse_p, LIM_LSE)))
        errs[sk] = max(row.values())
    return errs


def b5_cost(B, H, Sq, Sk, D, causal, q_off, k_off, elem):
    """(fwd bytes, fwd ops, bwd bytes, bwd ops) of one B5 block: B1's
    counts, except that the backward reads delta [B, H, Sq] f32 where B1
    reads out, and a block that no query sees needs no input: it only
    writes its outputs (out 0 and lse -inf, or zero grads)."""
    fwd_b, fwd_o, bwd_b, bwd_o = b1_cost(B, H, Sq, Sk, D, causal, q_off,
                                         k_off, elem)
    q_b, kv_b, row_b = B * H * Sq * D * elem, B * H * Sk * D * elem, \
        B * H * Sq * 4
    if fwd_o == 0:
        return q_b + row_b, 0, q_b + 2 * kv_b, 0
    return fwd_b, fwd_o, bwd_b - q_b + row_b, bwd_o


# (name, causal, q_off, k_off) of the ring step's blocks at 256-row shards
B5_CASES = (("diagonal", True, 256, 256), ("past", True, 768, 0),
            ("future", True, 0, 768), ("non-causal", False, 256, 0))
# the same at 250-row shards (S = 1000 at sp = 4), which tile neither the
# kernel's 64-row blocks nor 128 rows, at offsets off every multiple of
# 64; "skewed" puts the causal edge across every tile of the block
B5_ODD_SL = 250
B5_ODD_CASES = (("diagonal", True, 250, 250), ("past", True, 750, 250),
                ("future", True, 0, 750), ("skewed", True, 280, 250),
                ("non-causal", False, 500, 0))


def b5_vs_plain(torch, fb, gen, dt, lim, B, H, sl, D, case, causal, q_off,
                k_off, scale):
    """One B5 case, forward and backward (against the plain forward's
    lse and a delta with a random lse cotangent folded in) vs the plain
    versions, each launch on the path ``_tc_path`` gives; a future block
    must give out 0, lse -inf and zero grads; f32 kernels are held first
    to the same formula in f64 (``hold_to_f64``). Beside a block that is
    plain causal or full: the forward error of aten flash (bf16) or aten
    memory-efficient attention (f32) against the same plain version.
    Returns (max errors, forward args, backward args)."""
    label = "bf16" if dt == torch.bfloat16 else "f32"
    dev = torch.device("cuda")
    q, k, v, do = (torch.randn(B, H, sl, D, device=dev,
                               generator=gen).to(dt) for _ in range(4))
    dlse = torch.randn(B, H, sl, device=dev, generator=gen)
    fwd_args = (q, k, v, q_off, k_off, causal, scale)
    reset_counts(fb.flash_block_fwd, fb.flash_block_bwd)
    out, lse = fb.flash_block_fwd(*fwd_args)
    out_p, lse_p = fb.flash_block_fwd_plain(*fwd_args)
    delta = fb.compute_delta(out_p, do, dlse)
    bwd_args = (q, k, v, q_off, k_off, lse_p, do, delta, causal, scale)
    grads = fb.flash_block_bwd(*bwd_args)
    grads_p = fb.flash_block_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    what = (f"flash_block {label} {case} sl={sl} q_off/k_off={q_off}/"
            f"{k_off} causal={causal}")
    expect_path(what, fb._fa, dt, D,
                path_counts(fb.flash_block_fwd, fb.flash_block_bwd), 2)
    if dt == torch.float32:
        q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
        ref = fb.flash_block_fwd_plain(q64, k64, v64, q_off, k_off, causal,
                                       scale) + fb.flash_block_bwd_plain(
            q64, k64, v64, q_off, k_off, lse_p.double(), do64,
            delta.double(), causal, scale)
        hold_to_f64(torch, what, (out, lse) + grads,
                    (out_p, lse_p) + grads_p, ref)
    errs = check_all(
        torch, what,
        (("out", out, out_p, lim), ("lse", lse, lse_p, LIM_LSE),
         ("dq", grads[0], grads_p[0], lim),
         ("dk", grads[1], grads_p[1], lim),
         ("dv", grads[2], grads_p[2], lim)))
    if case == "future" and not (
            bool((lse == float("-inf")).all()) and not out.any()
            and not any(g.any() for g in grads)):
        fail("flash_block: a future block must give out 0, lse -inf and "
             "zero grads")
    if dt == torch.bfloat16 and case in ("diagonal", "past", "non-causal"):
        lib = torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, case == "diagonal", False, scale=scale)
        evidence(torch, "aten flash", [("out", lib[0], out_p)])
    elif case in ("diagonal", "past", "non-causal"):
        lib = torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k, v, None, True, 0.0, case == "diagonal", scale=scale)
        # its lse is padded to a multiple of 32 rows
        evidence(torch, "aten mem-efficient", [
            ("out", lib[0], out_p), ("lse", lib[1][..., :sl], lse_p)],
            f32=True)
    return errs, fwd_args, bwd_args


def check_flash_block(torch, fb, flush):
    """Phase 3, B5: forward and backward vs plain at the sp step's ring
    shape, the backward against a given delta with a nonzero lse cotangent
    folded in, timed; then, untimed, the same at 250-row shards. bf16 and
    f32 both on the tensor-core kernels at D 64, each row's bound at its
    route's peak; the f32 rows are also timed on the SIMT kernels (the
    design they replace) beside their 67-TFLOP/s bound. Yardsticks, both returning the logsumexp: aten's flash
    attention for bf16, its memory-efficient attention (3xTF32) for f32
    (the flash backend takes no f32; its backward through autograd on a
    kept graph); causal on the diagonal block, full on the past and
    non-causal ones (every key visible)."""
    B, H, sl, D = B_SLICE, NKV, L_SLICE // SP, HD
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    scale = 1.0 / D ** 0.5
    from torch.nn.attention import SDPBackend, sdpa_kernel
    lib_f = torch.ops.aten._scaled_dot_product_flash_attention
    lib_b = torch.ops.aten._scaled_dot_product_flash_attention_backward
    eff_f = torch.ops.aten._scaled_dot_product_efficient_attention
    errs, rows = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        label = "bf16" if dt == torch.bfloat16 else "f32"
        lim = LIM_BF16 if dt == torch.bfloat16 else LIM_F32
        for case, causal, q_off, k_off in B5_CASES:
            errs[(label, case)], fwd_args, bwd_args = b5_vs_plain(
                torch, fb, gen, dt, lim, B, H, sl, D, case, causal, q_off,
                k_off, scale)
            (q, k, v), do = fwd_args[:3], bwd_args[6]
            ms = timed(torch, lambda: fb.flash_block_fwd(
                q, k, v, q_off, k_off, causal, scale), flush)
            bwd_ms = timed(torch, lambda: fb.flash_block_bwd(*bwd_args),
                           flush)
            pfwd_ms = timed(torch, lambda: fb.flash_block_fwd_plain(
                q, k, v, q_off, k_off, causal, scale), flush, iters=10)
            pbwd_ms = timed(torch, lambda: fb.flash_block_bwd_plain(
                *bwd_args), flush, iters=10)
            lib_fwd = lib_bwd = None
            if dt == torch.bfloat16 and case != "future":
                lc = case == "diagonal"
                res = lib_f(q, k, v, 0.0, lc, False, scale=scale)
                lib_fwd = timed(torch, lambda: lib_f(q, k, v, 0.0, lc, False,
                                                     scale=scale), flush)
                lib_bwd = timed(torch, lambda: lib_b(
                    do, q, k, v, res[0], res[1], res[2], res[3], res[4],
                    res[5], 0.0, lc, res[6], res[7], scale=scale), flush)
            elif case != "future":
                lc = case == "diagonal"
                lib_fwd = timed(torch, lambda: eff_f(
                    q, k, v, None, True, 0.0, lc, scale=scale), flush)
                qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    og = torch.nn.functional.scaled_dot_product_attention(
                        qg, kg, vg, is_causal=lc, scale=scale)
                lib_bwd = timed(torch, lambda: torch.autograd.grad(
                    og, (qg, kg, vg), do, retain_graph=True), flush)
            simt = {"fwd": None, "bwd": None}
            if dt == torch.float32:
                simt["fwd"] = timed(torch, lambda: simt_flash_fwd(
                    torch, fb._fa, q, k, v, causal, scale, q_off, k_off),
                    flush)
                simt["bwd"] = timed(torch, lambda: simt_flash_bwd(
                    torch, fb._fa, q, k, v, bwd_args[5], do, causal, scale,
                    q_off, k_off, delta=bwd_args[7]), flush)
            fb_, fo, bb, bo = b5_cost(B, H, sl, sl, D, causal, q_off, k_off,
                                      q.element_size())
            peak = flash_peak(torch, fb._fa, dt, D)
            for kind, t, plain_ms, lib_ms, nb, ops in (
                    ("fwd", ms, pfwd_ms, lib_fwd, fb_, fo),
                    ("bwd", bwd_ms, pbwd_ms, lib_bwd, bb, bo)):
                bound_ms, by = bound(nb, ops, peak)
                rows[(label, case, kind)] = dict(
                    ms=t, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound_ms, bound_by=by)
                lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
                lib_name = "aten flash" if label == "bf16" else "aten eff"
                extra = "" if simt[kind] is None else (
                    f", SIMT kernel {simt[kind]:.4f} ms (its bound "
                    f"{bound(nb, ops)[0]:.4f} ms)")
                print(f"  flash_block_{kind} {label} {case}: kernel {t:.4f} "
                      f"ms, plain {plain_ms:.4f} ms, {lib_name} {lib_txt}, "
                      f"bound {bound_ms:.4f} ms ({by}: {nb} B, {ops} ops)"
                      f"{extra}", flush=True)
    for dt, lim in ((torch.bfloat16, LIM_BF16), (torch.float32, LIM_F32)):
        for case, causal, q_off, k_off in B5_ODD_CASES:
            b5_vs_plain(torch, fb, gen, dt, lim, B, H, B5_ODD_SL, D, case,
                        causal, q_off, k_off, scale)
    return errs, rows


def ce_cost(N, V, elem, out_elem=None):
    """(fwd bytes, fwd ops, bwd bytes, bwd ops): logits of ``elem`` bytes
    read once (and dlogits of ``out_elem``, default ``elem``, written once
    backward), the [N] vectors once; 4 f32 operations per logit forward
    (max, subtract, exp, add), 5 backward."""
    fwd = N * V * elem + N * 4 + 2 * N * 4
    bwd = N * V * (elem + (out_elem or elem)) + 3 * N * 4
    return fwd, 4 * N * V, bwd, 5 * N * V


def ce_labels(torch, N, V, gen, vv=None, ignore_frac=0.0):
    """(labels as B2 gets them, the upstream gradient g, labels as
    ``F.cross_entropy`` gets them): a share ``ignore_frac`` of the rows at
    the ignore index -100, which ``cross_entropy`` clamps to 0 for the
    kernel and whose rows' g it zeroes; the other rows' g is the mean's
    1 / (kept rows) as in the loss, or random where nothing is ignored."""
    dev = torch.device("cuda")
    lab = torch.randint(0, vv or V, (N,), device=dev, generator=gen)
    if not ignore_frac:
        g = torch.rand(N, device=dev, generator=gen)
        return lab.to(torch.int32), g, lab
    ign = torch.rand(N, device=dev, generator=gen) < ignore_frac
    lib_lab = torch.where(ign, -100, lab)
    g = torch.where(ign, 0.0, 1.0 / int((~ign).sum()))
    return lib_lab.clamp(0, V - 1).to(torch.int32), g, lib_lab


def dt_label(torch, dt):
    return "bf16" if dt == torch.bfloat16 else "f32"


def check_ce(torch, ce, flush, V=50304, cases=None,
             timing=("bfloat16", "float32"), timing_n=8192, ignore_frac=0.0):
    """Phase 3, B2: kernel vs plain at the training slice's shapes (the
    port runs all B*S = 8192 rows; 8184 = 8 x 1023 is the sliced count),
    or at ``V`` and ``cases`` ((N, dtype, valid vocab[, dlogits dtype]),
    errors keyed by the case) given, with a share
    ``ignore_frac`` of the rows at the ignore index (``ce_labels``); timed
    at N = ``timing_n`` for each entry of ``timing`` (a dtype, or
    "float32->bfloat16" for f32 logits and bf16 dlogits), beside
    ``F.cross_entropy`` with the same ignored rows. Rows are keyed
    (label, "fwd" / "bwd"), the label "bf16", "f32" or "f32->bf16"."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    if cases is None:
        cases = [(8192, torch.bfloat16, None), (8192, torch.float32, None),
                 (8184, torch.bfloat16, 50257), (8184, torch.float32, 50257)]
    errs = {}
    for case in cases:
        N, dt, vv = case[:3]
        out = case[3] if len(case) > 3 else dt
        lg = (torch.randn(N, V, device=dev, generator=gen) * 3).to(dt)
        lab, g, _ = ce_labels(torch, N, V, gen, vv, ignore_frac)
        if not ignore_frac:
            lab[:4] = torch.tensor([0, 0, (vv or V) - 1, V - 1])
        per, lse = ce.ce_fwd(lg, lab, vv)
        per_p, lse_p = ce.ce_fwd_plain(lg, lab, vv)
        d = ce.ce_bwd(lg, lab, lse_p, g, vv, out_dtype=out)
        d_p = ce.ce_bwd_plain(lg, lab, lse_p, g, vv, out_dtype=out)
        torch.cuda.synchronize()
        errs[case] = check_all(
            torch, f"fused_ce N={N} V={V} {dt}"
            + (f" -> {out} dlogits" if out != dt else "")
            + f" valid_vocab={vv}"
            + (f" ignored {ignore_frac:g}" if ignore_frac else ""),
            (("per", per, per_p, LIM_LSE), ("lse", lse, lse_p, LIM_LSE),
             ("dlogits", d, d_p, LIM_DLOGITS[dt_label(torch, out)])))

    rows = {}
    lib = torch.nn.functional.cross_entropy
    for name in timing:
        src, _, dst = name.partition("->")
        dt, out = getattr(torch, src), getattr(torch, dst or src)
        N = timing_n
        lg = (torch.randn(N, V, device=dev, generator=gen) * 3).to(dt)
        lab, g, lab64 = ce_labels(torch, N, V, gen, None, ignore_frac)
        per, lse = ce.ce_fwd(lg, lab)
        lgr = lg.detach().clone().requires_grad_()
        fwd_ms = timed(torch, lambda: ce.ce_fwd(lg, lab), flush)
        bwd_ms = timed(torch, lambda: ce.ce_bwd(lg, lab, lse, g,
                                                out_dtype=out), flush)
        clean = {"fwd": timed(torch, lambda: ce.ce_fwd(lg, lab), flush,
                              clean=True),
                 "bwd": timed(torch, lambda: ce.ce_bwd(lg, lab, lse, g,
                                                       out_dtype=out),
                              flush, clean=True)}
        pfwd_ms = timed(torch, lambda: ce.ce_fwd_plain(lg, lab), flush,
                        iters=10)
        pbwd_ms = timed(torch, lambda: ce.ce_bwd_plain(
            lg, lab, lse, g, out_dtype=out), flush, iters=10)
        lib_fwd = timed(torch, lambda: lib(lg, lab64, reduction="none"),
                        flush)
        lib_both = timed(torch, lambda: torch.autograd.grad(
            lib(lgr, lab64, reduction="none"), lgr, g.to(dt)), flush)
        fb, fo, bb, bo = ce_cost(N, V, lg.element_size(),
                                 torch.empty((), dtype=out).element_size())
        label = dt_label(torch, dt) + (f"->{dt_label(torch, out)}"
                                       if dst else "")
        for kind, ms, plain_ms, lib_ms, nb, ops in (
                ("fwd", fwd_ms, pfwd_ms, lib_fwd, fb, fo),
                ("bwd", bwd_ms, pbwd_ms, lib_both - lib_fwd, bb, bo)):
            if dst and kind == "fwd":
                continue                  # the forward is the f32 row's
            bound_ms, by = bound(nb, ops)
            rows[(label, kind)] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=bound_ms,
                                       bound_by=by)
            print(f"  ce_{kind} {label} N={N} V={V}"
                  + (f" ({ignore_frac:g} of the rows ignored)"
                     if ignore_frac else "")
                  + f": kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"F.cross_entropy {lib_ms:.4f} ms, bound {bound_ms:.4f} "
                  f"ms ({by}: {nb} B, {ops} ops), {bound_ms / ms:.1%} of "
                  f"the bound (after a read-only flush {clean[kind]:.4f} "
                  f"ms, {bound_ms / clean[kind]:.1%}); path: "
                  f"{ce.describe(lg, out)}", flush=True)
            if bound_ms < ms / 2:
                b2_account(torch, f"ce_{kind} {label} N={N} V={V}",
                           (lambda: ce.ce_fwd(lg, lab)) if kind == "fwd"
                           else (lambda: ce.ce_bwd(lg, lab, lse, g,
                                                   out_dtype=out)), flush)
    return errs, rows


def b2_account(torch, what, fn, flush, n=20):
    """What holds a B2 row under half its bound: the kernel's own device
    time a launch (torch.profiler over ``n`` launches, the L2 flushed
    before each, as ``timed`` does), the event time with no flush, and a
    one-element fill's event time (the launch floor)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    dev = [e.self_device_time_total / e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and ("ce_fwd_kernel" in e.key or "ce_bwd_kernel" in e.key)]
    small = torch.empty(1, device="cuda")
    unflushed = timed(torch, fn, small)
    floor = timed(torch, lambda: small.fill_(1.0), small)
    print(f"    under half its bound, {what}: the kernel on the device "
          + (f"{dev[0] / 1e3:.4f} ms a launch (profiler, L2 flushed)"
             if dev else "not measured (the profiler reported none)")
          + f"; event time without the flush {unflushed:.4f} ms; a "
          f"one-element fill {floor:.4f} ms", flush=True)


# B2's layouts beyond the slice shapes, (N, V, logits, valid vocab, base
# offset in elements, dlogits): vocabularies no multiple of 8 (rows start
# at drifting offsets), bases 1 and 3 elements past a 16-byte boundary (a
# [k:] view of a larger buffer), short batches (N 1, 7, 64) and phase 20's
# N 256, valid_vocab inside a row's head (3) and inside its tail (V - 2),
# f32 logits with bf16 dlogits and the converse
B2_LAYOUTS = tuple(
    [(300, V, dt, None, 0, dt) for V in (30522, 1003)
     for dt in ("bfloat16", "float32")]
    + [(300, V, dt, None, off, dt) for V in (30522, 1003)
       for dt in ("bfloat16", "float32") for off in (1, 3)]
    + [(N, 30522, dt, None, off, dt) for N in (1, 7, 64, 256)
       for dt in ("bfloat16", "float32") for off in (0, 3)]
    + [(64, 1003, dt, vv, off, dt) for vv in (3, 1001)
       for dt in ("bfloat16", "float32") for off in (0, 1)]
    + [(300, 50304, "float32", None, off, "bfloat16") for off in (0, 1, 3)]
    + [(7, 30522, "float32", 30520, 1, "bfloat16"),
       (300, 1003, "bfloat16", None, 3, "float32")])


def check_ce_layouts(torch, ce, what=""):
    """Phase 3, B2 at ``B2_LAYOUTS``: kernel vs plain at LIM_LSE /
    LIM_DLOGITS (the dlogits' type's), labels at the first, the last valid,
    the last and two outside columns ([0, vv - 1, V - 1, -1, V + 5])."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    for N, V, dt, vv, off, out in B2_LAYOUTS:
        dt, out = getattr(torch, dt), getattr(torch, out)
        buf = (torch.randn(N * V + 8, device=dev, generator=gen) * 3).to(dt)
        lg = buf[off:off + N * V].view(N, V)
        lab = torch.randint(0, vv or V, (N,), device=dev, generator=gen,
                            dtype=torch.int32)
        edge = torch.tensor([0, (vv or V) - 1, V - 1, -1, V + 5],
                            dtype=torch.int32)[:N]
        lab[:len(edge)] = edge
        g = torch.rand(N, device=dev, generator=gen)
        per, lse = ce.ce_fwd(lg, lab, vv)
        per_p, lse_p = ce.ce_fwd_plain(lg, lab, vv)
        d = ce.ce_bwd(lg, lab, lse_p, g, vv, out_dtype=out)
        d_p = ce.ce_bwd_plain(lg, lab, lse_p, g, vv, out_dtype=out)
        torch.cuda.synchronize()
        label = f"{dt_label(torch, dt)}->{dt_label(torch, out)}"
        check_all(
            torch, f"fused_ce{what} N={N} V={V} {label} valid_vocab={vv} "
            f"base +{off} ({ce.describe(lg, out)})",
            (("per", per, per_p, LIM_LSE), ("lse", lse, lse_p, LIM_LSE),
             ("dlogits", d, d_p, LIM_DLOGITS[dt_label(torch, out)])))


# _select_token's knobs, (temperature, top_k, top_p): each alone, then all
# together as phase 16 serves
SAMPLING_KNOBS = ((1.0, 0, 1.0), (0.8, 0, 1.0), (1.0, 50, 1.0),
                  (1.0, 0, 0.95), (0.8, 50, 0.95))


def check_sampling(torch, np, gm, flush):
    """Phase 3, sampling: ``generation._select_token`` on the card against
    the CPU on the same 64 rows of logits at V = 32000 (row i keyed as a
    request with seed i at a position of its own), for each of
    SAMPLING_KNOBS. The tokens must be the same, except where the CPU's
    perturbed top-2 margin (filtered logits plus the Gumbel noise) is
    below 1e-4 (phase 5's rule: the hash's bits are the same on both, the
    f32 logs may differ in the last bit). Then the all-knobs draw of the
    serving tick (8 rows of bf16 logits) timed."""
    rs = np.random.RandomState(21)
    lg = torch.from_numpy((rs.randn(64, LLAMA_V) * 3).astype(np.float32))
    keys = gm.fold_in(torch.stack([gm.prng_key(i) for i in range(64)]),
                      torch.from_numpy(rs.randint(0, LLAMA_L, 64)))
    for knobs in SAMPLING_KNOBS:
        cpu = gm._select_token(lg, keys, True, *knobs)
        card = gm._select_token(lg.cuda(), keys.cuda(), True, *knobs).cpu()
        pert = gm._filter_logits(lg, *knobs) + gm._gumbel(keys, LLAMA_V)
        top2 = torch.topk(pert, 2).values
        near = top2[:, 0] - top2[:, 1] < 1e-4
        bad = (cpu != card) & ~near
        if bool(bad.any()):
            fail(f"_select_token T/k/p={knobs}: rows "
                 f"{bad.nonzero()[:, 0].tolist()} differ between the card "
                 "and the CPU")
        print(f"  _select_token T/k/p={knobs}: {int((cpu == card).sum())}"
              f"/64 rows the same token on the card and the CPU; "
              f"{int(near.sum())} rows with a perturbed top-2 margin < 1e-4",
              flush=True)
    lg8, k8 = lg[:8].cuda().bfloat16(), keys[:8].cuda()
    ms = timed(torch, lambda: gm._select_token(lg8, k8, True,
                                               *SAMPLING_KNOBS[-1]), flush)
    print(f"  _select_token at the serving tick (8 x {LLAMA_V} bf16, "
          f"T/k/p={SAMPLING_KNOBS[-1]}): {ms:.4f} ms", flush=True)


def train_parity(torch, pkg, build=None, shape=(2, 128), layers=LAYERS,
                 loss_of=None, what="f32 parity", recompute=False,
                 b2=(1, 1)):
    """Phase 7, first part: one f32 loss + backward of gpt_125m on the
    card against a CPU copy of the same weights, batch 2 x seq 128; every
    B1 launch on the 3xTF32 tensor-core kernels, B2 one launch each way.
    Phase 18 the same with ``build(device=..., seed=...)``'s model at
    ``shape``, B1 on the path ``_tc_path`` gives its head size; phase 20
    with BERT's models and ``loss_of(model, ids)``, ``layers`` B1 launches
    each way (0 on its masked path); phase 25 with ``recompute`` (B1
    forward twice a layer) and the fused loss's ``b2`` launches."""
    if build is None:
        def build(**kw):
            return pkg["GPT"](pkg["gpt_125m"](), **kw)
    if loss_of is None:
        def loss_of(m, x):
            return m.loss_fn(m(x), x)
    model = build(seed=2).train()
    cpu = build(device="cpu", seed=3).train()
    pkg["load"](cpu, {n: p.detach().cpu().numpy()
                      for n, p in model.named_parameters()})
    ids = pkg["np"].random.RandomState(1).randint(
        0, model.cfg.vocab_size, shape)
    losses, grads = [], []
    fa, ce = pkg["fa"], pkg["ce"]
    reset_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)
    ce.ce_fwd.launches = ce.ce_bwd.launches = 0
    for m in (model, cpu):
        x = torch.from_numpy(ids).to(m.device)
        loss = loss_of(m, x)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in m.named_parameters()})
    counts = {w.__name__: (w.tc_launches, w.simt_launches)
              for w in (fa.flash_attn_fwd, fa.flash_attn_bwd)}
    D = model.cfg.hidden_size // model.cfg.num_heads
    tc = fa._tc_path(torch.float32, D)
    want = {}
    for name, n in (("flash_attn_fwd", layers * (2 if recompute else 1)),
                    ("flash_attn_bwd", layers)):
        want[name] = (n, 0) if tc else (0, n)
    if counts != want:
        fail(f"{what}: B1 (tensor-core, SIMT) launches {counts} != "
             f"{want}: f32 at D {D} must run the kernels _tc_path picks")
    if (ce.ce_fwd.launches, ce.ce_bwd.launches) != b2:
        fail(f"{what}: B2 launches {ce.ce_fwd.launches} + "
             f"{ce.ce_bwd.launches} != {b2[0]} + {b2[1]}")
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    if not rel <= 1e-5:
        fail(f"{what}: loss card {losses[0]} cpu {losses[1]} (rel {rel} "
             "> 1e-5)")
    worst, worst_name = 0.0, ""
    for n, g_cpu in grads[1].items():
        if g_cpu is None or grads[0][n] is None:   # unused (MLM's pooler)
            if (g_cpu is None) != (grads[0][n] is None):
                fail(f"{what}: grad {n} is None on one side only")
            continue
        d = (grads[0][n].cpu() - g_cpu).abs().max().item()
        r = d / max(g_cpu.abs().max().item(), 1e-30)
        if r > worst:
            worst, worst_name = r, n
    if not worst <= 1e-4:
        fail(f"{what}: grad {worst_name} max|diff| / max|g| = {worst} "
             "> 1e-4")
    print(f"  {what}: loss card {losses[0]:.6f} cpu {losses[1]:.6f} (rel "
          f"{rel:.2e}, tol 1e-5); worst grad max|diff|/max|g| {worst:.2e} "
          f"({worst_name}; tol 1e-4) over {len(grads[1])} parameters; B1 "
          f"(tensor-core, SIMT) launches {counts}, B2 {b2[0]} + {b2[1]}",
          flush=True)
    return counts


def _count_plain(mods):
    """Wrap every ``*_plain`` function of ``mods`` with a call counter;
    returns (counts, restore)."""
    counts, saved = {}, []
    for mod in mods:
        for name in [n for n in vars(mod) if n.endswith("_plain")]:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))
            counts[name] = 0

            def counted(*a, _fn=fn, _name=name, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)
            setattr(mod, name, counted)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return counts, restore


def busy_share(prof, wall_us):
    """The device's busy share of a profiled window (None: not
    measured)."""
    return sum(r[0] for r in prof) / wall_us if prof else None


def profile_window(torch, what, fn, top=10):
    """Run ``fn`` once under torch.profiler: device time by kernel (the
    ``top`` largest) and the device's busy share of the window's wall
    time. Prints "not measured" when the profiler reports no device time.
    Only device events count: a CPU op's device time repeats its
    kernels'. Returns ([(device us, count, kernel name)] (empty when not
    measured), the window's wall us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    if not rows:
        print(f"  profiled {what}: device time not measured (the profiler "
              "reported none)", flush=True)
        return rows, wall_us
    print(f"  profiled {what}: wall {wall_us / 1e3:.1f} ms (profiler on), "
          f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.0f}"
          " % of wall; one stream, so kernels do not overlap); top by "
          "device time:", flush=True)
    for us, n, key in sorted(rows, reverse=True)[:top]:
        print(f"    {us / 1e3:8.3f} ms {100 * us / busy_us:5.1f} % x{n:<5d} "
              f"{key[:90]}", flush=True)
    return rows, wall_us


def train_step(torch, pkg, steps=5, sp=1, f32=False, build=None,
               batch=B_SLICE, seq=L_SLICE, layers=LAYERS, first_loss=None):
    """Phase 8 (sp = 1, bf16), phase 14 (the same step under an sp-way
    mesh on the one card) and phase 7's f32 step (``f32``: the same model
    with f32 weights, AdamW without master weights): the slice's step,
    bench.py's geometry. Phase 18 gives ``build()`` (the f32 model),
    ``batch`` x ``seq``, its ``layers`` and the loss its random weights
    start at (``first_loss``; ln V by default). Returns the kernel launch
    counts of the timed steps, the losses (warm step first), the ms per
    timed step and the attention wrappers' (tensor-core, SIMT) launch
    counts."""
    fa, ce, fb, dist = pkg["fa"], pkg["ce"], pkg["fb"], pkg["dist"]
    torch.cuda.reset_peak_memory_stats()
    model = (build() if build is not None
             else pkg["GPT"](pkg["gpt_125m"](), seed=0))
    if not f32:
        model = model.bfloat16()
        torch.cuda.empty_cache()
    opt = pkg["AdamW"](learning_rate=1e-4, parameters=model.parameters(),
                       multi_precision=not f32)
    step = pkg["TrainStep"](model, model.make_loss_fn(), opt)
    label = "f32" if f32 else "bf16"
    rs = pkg["np"].random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, model.cfg.vocab_size,
                                      (batch, seq)).astype("int64"))
    ids = ids.to(model.device)
    if sp > 1:
        dist.init_mesh({"sp": sp}, devices=["cuda:0"] * sp)
    try:
        losses = [step(ids, ids)]                # warm: allocations, cuBLAS
        torch.cuda.synchronize()
        plain, restore = _count_plain([fa, ce, fb])
        attn = (fa.flash_attn_fwd, fa.flash_attn_bwd, fb.flash_block_fwd,
                fb.flash_block_bwd)
        reset_counts(*attn)
        ce.ce_fwd.launches = ce.ce_bwd.launches = 0
        try:
            t0 = time.perf_counter()
            for _ in range(steps):
                losses.append(step(ids, ids))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            restore()
        counts = {"flash_attn_fwd": fa.flash_attn_fwd.launches,
                  "flash_attn_bwd": fa.flash_attn_bwd.launches,
                  "flash_block_fwd": fb.flash_block_fwd.launches,
                  "flash_block_bwd": fb.flash_block_bwd.launches,
                  "ce_fwd": ce.ce_fwd.launches, "ce_bwd": ce.ce_bwd.launches}
        vals = [float(x) for x in losses]
        b1 = steps * layers if sp == 1 else 0
        b5 = steps * layers * sp * sp if sp > 1 else 0
        want = {"flash_attn_fwd": b1, "flash_attn_bwd": b1,
                "flash_block_fwd": b5, "flash_block_bwd": b5,
                "ce_fwd": steps, "ce_bwd": steps}
        paths = {w.__name__: (w.tc_launches, w.simt_launches) for w in attn}
        if counts != want or any(plain.values()) or paths != {
                w.__name__: (want[w.__name__], 0) for w in attn}:
            fail(f"train step (sp={sp}, {label}) launches {counts} != "
                 f"{want} (= {steps} steps x {layers} layers x 1, or x "
                 f"sp^2 = {sp * sp} ring blocks / x 1), plain calls "
                 f"{plain}, (tensor-core, SIMT) {paths}: every launch must "
                 "take the tensor-core kernels")
        if sp > 1 and dist.last_ring_dispatch()["path"] != "kernel":
            fail(f"sp step dispatch {dist.last_ring_dispatch()}")
        start = (math.log(model.cfg.vocab_size) if first_loss is None
                 else first_loss)
        if not all(math.isfinite(x) for x in vals):
            fail(f"train step: non-finite loss in {vals}")
        if not abs(vals[0] - start) <= 0.5:
            fail(f"train step: first loss {vals[0]} not within 0.5 of "
                 f"{start:.4f}")
        if not vals[-1] < min(vals[0], vals[1]):
            fail(f"train step: the last loss is not below the first: {vals}")
        ms = wall / steps * 1e3
        prof, prof_wall = profile_window(
            torch, f"step (sp={sp}, {label})", lambda: step(ids, ids))
    finally:
        if sp > 1:
            dist.set_mesh(None)
    attn_us = sum(us for us, _, key in prof
                  if "tf32_kernel" in key or "tc_kernel" in key)
    attn = ("not measured" if not prof else
            f"{attn_us / 1e3:.3f} ms device time in the flash kernels "
            f"({100 * attn_us / prof_wall:.1f} % of the profiled step's wall)")
    print(f"  losses {['%.4f' % x for x in vals]} (warm step first); "
          f"{ms:.1f} ms/step, {batch * seq / (ms / 1e3):.0f} tokens/s "
          f"(smoke number, {steps} steps); launches {counts}, (tensor-core, "
          f"SIMT) {paths}, plain calls {plain}; profiled step: {attn}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
          flush=True)
    return counts, vals, ms, paths


def check_sp_attention(torch, pkg, S, devices, timing):
    """Phase 13: ring and Ulysses attention on an sp-position mesh over
    ``devices`` against the plain full attention at sequence ``S``,
    launches counted per call; with ``timing`` each call's forward +
    backward timed beside B1's on the full sequence."""
    fa, fb, dist = pkg["fa"], pkg["fb"], pkg["dist"]
    B, H, D = B_SLICE, NKV, HD
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(9)
    scale = 1.0 / D ** 0.5
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    sp_paths = {}
    mesh = dist.init_mesh({"sp": SP}, devices=devices)
    where = "one card" if len(set(mesh.axis_devices("sp"))) == 1 else \
        f"{SP} cards"
    try:
        for dt in (torch.float32, torch.bfloat16):
            label = f"{'bf16' if dt == torch.bfloat16 else 'f32'} S={S} " \
                f"on {where}"
            q, k, v, g = (torch.randn(B, S, H, D, device=dev,
                                      generator=gen).to(dt) for _ in range(4))
            qh, kh, vh, gh = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v, g))
            o_ref, l_ref = fa.flash_attn_fwd_plain(qh, kh, vh, True, scale)
            ref = (o_ref,) + fa.flash_attn_bwd_plain(qh, kh, vh, o_ref,
                                                     l_ref, gh, True, scale)
            for op, per_call in (("ring", SP * SP), ("ulysses", SP)):
                fn = getattr(dist, f"{op}_attention")
                leaves = [t.detach().clone().requires_grad_()
                          for t in (q, k, v)]
                plain, restore = _count_plain([fa, fb])
                reset_counts(fa.flash_attn_fwd, fa.flash_attn_bwd,
                             fb.flash_block_fwd, fb.flash_block_bwd)
                try:
                    out = fn(*leaves, causal=True)
                    grads = torch.autograd.grad(out, leaves, g)
                    torch.cuda.synchronize()
                finally:
                    restore()
                counts = {"flash_block_fwd": fb.flash_block_fwd.launches,
                          "flash_block_bwd": fb.flash_block_bwd.launches,
                          "flash_attn_fwd": fa.flash_attn_fwd.launches,
                          "flash_attn_bwd": fa.flash_attn_bwd.launches}
                want = {"flash_block_fwd": per_call,
                        "flash_block_bwd": per_call,
                        "flash_attn_fwd": 0, "flash_attn_bwd": 0}
                disp = dist.last_ring_dispatch()
                expect_path(f"{op}_attention {label}", fa, dt, D, path_counts(
                    fb.flash_block_fwd, fb.flash_block_bwd), 2 * per_call)
                sp_paths[(dt, op)] = {
                    w.__name__: (w.tc_launches, w.simt_launches)
                    for w in (fb.flash_block_fwd, fb.flash_block_bwd)}
                if counts != want or any(plain.values()) or (
                        disp["path"], disp["op"]) != ("kernel", op) or any(
                        t.device != dev for t in (out,) + grads):
                    fail(f"{op}_attention {label}: launches {counts} != "
                         f"{want}, plain calls {plain}, dispatch {disp}, "
                         f"devices {[t.device for t in (out,) + grads]}")
                got = [(n, x.transpose(1, 2), r) for n, x, r in
                       zip(("out", "dq", "dk", "dv"), (out,) + grads, ref)]
                what = f"{op}_attention {label} sp={SP} vs the plain full " \
                    "attention"
                if op == "ring" and dt == torch.bfloat16:
                    check_rms(torch, what, got, RMS_SP_BF16)
                else:
                    lim = LIM_F32 if dt == torch.float32 else LIM_BF16
                    check_all(torch, what, [c + (lim,) for c in got])
                txt = ""
                if timing:
                    ms = timed(torch, lambda: torch.autograd.grad(
                        fn(*leaves, causal=True), leaves, g), flush,
                        iters=10)
                    txt = f"; fwd + bwd {ms:.3f} ms"
                print(f"  {op}_attention {label}: launches {counts}{txt}",
                      flush=True)
            if timing:
                b1_ms = timed(torch, lambda: fa.flash_attn_bwd(
                    qh, kh, vh, *fa.flash_attn_fwd(qh, kh, vh, True, scale),
                    gh, True, scale), flush, iters=10)
                print(f"  B1 fwd + bwd on the full sequence ({label}): "
                      f"{b1_ms:.3f} ms", flush=True)
    finally:
        dist.set_mesh(None)
    return sp_paths


def post_all(url, prompts, max_new, seeds=None):
    """POST /generate for every prompt at once (``seeds[i]`` as request
    i's "seed" when given); returns (status, body)s."""
    results = [None] * len(prompts)

    def one(i):
        payload = {"input_ids": [int(t) for t in prompts[i]],
                   "max_new_tokens": max_new}
        if seeds is not None:
            payload["seed"] = int(seeds[i])
        data = json.dumps(payload).encode()
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


# the kernel wrappers a serving path may reach, by module: the fused
# writes are the serving paths' own; the per-plane writes must not run
# there. A tree without one of them (an earlier commit, for --serving)
# reports the others.
SERVE_KERNELS = (("md", "mega_decode_step"), ("cw", "kv_slot_write"),
                 ("cw", "kv_paged_write"), ("cw", "fused_slot_write"),
                 ("cw", "fused_paged_write"))


def forwards(st):
    """Model forwards an engine ran: one per admission, one per verify
    tick, tick_tokens per plain tick."""
    spec = st.get("spec_ticks", 0)
    return st["admitted"] + spec + (st["ticks"] - spec) * TICK


def serve(torch, pkg, model, cache_dtype, prompts, slots=8, profile=False,
          max_len=L_SLICE, max_new=MAX_NEW, seeds=None, extra=None,
          **engine_kw):
    """Serve ``prompts`` (``max_new`` tokens each, ``seeds`` as their
    "seed") through engine + HTTP server with the launch counters zeroed
    just before, and every plain version of a serving kernel counted;
    returns a dict of the token lists, the engine's stats just after the
    requests, the launch counts, the wall seconds and ms a tick. Fails on
    a malformed reply or a plain call. With ``profile``, serves the same
    prompts once more under torch.profiler after reading the counts (a
    paged engine's prefix cache is warm by then) and adds the device busy
    share and the device kernels a forward of that rerun. ``extra(eng,
    url)`` runs last, before the engine stops; its result is "extra"."""
    wrappers = {name: getattr(pkg[m], name) for m, name in SERVE_KERNELS
                if hasattr(pkg[m], name)}
    eng = pkg["Engine"](model, slots=slots, max_len=max_len,
                        cache_dtype=cache_dtype, tick_tokens=TICK,
                        **engine_kw)
    srv = pkg["Server"](engine=eng, host="127.0.0.1", port=0,
                        deadline_s=600).start()
    what = f"{cache_dtype}{' paged' if eng.paged else ''}" + (
        " speculative" if engine_kw.get("speculative") else "")
    plain, restore = _count_plain([pkg["md"], pkg["cw"]])
    out = {}
    try:
        url = f"http://{srv.host}:{srv.port}"
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                fail("/health")
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        res = post_all(url, prompts, max_new, seeds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: w.launches for n, w in wrappers.items()}
        stats = eng.stats()
        if "obs" in pkg and pkg["obs"].enabled():
            # the engine's first admission: its TTFT from the prefill span
            first = min((e for e in pkg["obs"].recorder.events(t0)
                         if e["name"] == "engine.prefill"),
                        key=lambda e: e["ts"], default=None)
            if first is not None:
                out["first_ttft_ms"] = first["args"]["ttft_ms"]
        if eng.paged:
            eng._allocator.check()
        if profile:
            prof, wall_us = profile_window(
                torch, f"{what} serving, the same {len(prompts)} requests "
                "again", lambda: post_all(url, prompts, max_new, seeds),
                top=8)
            n_fwd = forwards(eng.stats()) - forwards(stats)
            if prof:
                busy_us = sum(r[0] for r in prof)
                n_kern = sum(r[1] for r in prof)
                out.update(busy_share=busy_us / wall_us,
                           kernels_per_forward=n_kern / n_fwd,
                           profiled_wall_ms=wall_us / 1e3,
                           busy_ms=busy_us / 1e3)
                print(f"    device kernels {n_kern} over {n_fwd} forwards: "
                      f"{n_kern / n_fwd:.1f} a forward; busy "
                      f"{100 * busy_us / wall_us:.1f} % of the window",
                      flush=True)
            b4 = [r for r in prof if "mega_decode" in r[2]]
            if b4:
                us = sum(r[0] for r in b4)
                print(f"    B4 (mega_decode_kernel): {us / 1e3:.3f} ms "
                      f"device, x{sum(r[1] for r in b4)}, "
                      f"{100 * us / sum(r[0] for r in prof):.1f} % of the "
                      "device time", flush=True)
                out["b4_device_ms"] = us / 1e3
        if extra is not None:
            out["extra"] = extra(eng, url)
    finally:
        restore()
        srv.stop()
        eng.stop()
    vocab = model.cfg.vocab_size
    toks = []
    for (code, body), p in zip(res, prompts):
        if code != 200:
            fail(f"/generate ({what}) -> {code} {body}")
        t = body["tokens"]
        if (len(t) != len(p) + max_new or t[:len(p)] != [int(x) for x in p]
                or body["new_tokens"] != max_new
                or not all(0 <= x < vocab for x in t)):
            fail(f"/generate ({what}) body malformed: {body}")
        toks.append(t)
    if any(plain.values()):
        fail(f"{what}: plain versions ran on the card: {plain}")
    ms_tick = 1e3 * wall / stats["ticks"]
    print(f"  {what}: {len(prompts)} requests x {max_new} tokens in "
          f"{wall:.3f} s ({len(prompts) * max_new / wall:.1f} new tok/s "
          f"incl. prefill), {stats['ticks']} ticks ({ms_tick:.2f} ms a tick, "
          f"host clock), {forwards(stats)} forwards, launches {counts}",
          flush=True)
    out.update(toks=toks, stats=stats, ticks=stats["ticks"], counts=counts,
               wall=wall, ms_tick=ms_tick)
    return out


def expect_launches(what, counts, **want):
    """Fail unless every counted wrapper launched as ``want`` says (those
    not named: never)."""
    full = {n: want.get(n, 0) for n in counts}
    if counts != full:
        fail(f"{what}: launches {counts} != {full}")


def check_oracle(torch, pkg, oracle, prompts, toks, what, max_new=MAX_NEW,
                 wants=None):
    """Phase 5's rule: each request's tokens equal the sequential greedy
    generate() of the CPU copy, except where the CPU's top-2 logit margin
    at the first differing token is < 1e-4. Identical prompts are checked
    once. ``wants``: the oracle's tokens for each prompt, computed
    already."""
    gen = {}
    for i, (p, got) in enumerate(zip(prompts, toks)):
        key = tuple(int(x) for x in p)
        if wants is not None:
            gen[key] = wants[i]
        elif key not in gen:
            gen[key] = pkg["generate"](oracle, p, max_new,
                                       cache_dtype="float32")[0]
        want_t = gen[key]
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
            fail(f"{what} tokens differ from the CPU oracle")
    print(f"  {what} tokens match the sequential CPU oracle", flush=True)


def paged_launch_check(run, what, layers=LAYERS):
    """kv_paged_write launches must equal the forwards the engine ran (one
    per admission, one per verify tick, tick_tokens per plain tick) x
    ``layers``, one launch a layer for both halves whatever the pool's
    type; every other serving kernel never."""
    st = run["stats"]
    want = forwards(st) * layers
    expect_launches(f"{what} (({st['admitted']} admissions + "
                    f"{st.get('spec_ticks', 0)} verify ticks + plain ticks "
                    f"x {TICK}) x {layers})", run["counts"],
                    kv_paged_write=want)
    return want


def check_pool(run):
    """After every request retired: only the trie's pages are in use."""
    st = run["stats"]
    if st["active"] or st["pages_used"] != st["pages_cached_prefix"]:
        fail(f"paged pool after the requests: active {st['active']}, "
             f"pages_used {st['pages_used']} != pages_cached_prefix "
             f"{st['pages_cached_prefix']}")


def serving_prompts(np, vocab):
    """Each serving phase's prompts, from a generator of its own (seeded
    with the phase number), so that ``--serving`` serves phases 6, 9 and
    11 with the prompts the full run serves them: 8 prompts of 16-300
    tokens (phase 4), 4 (phases 5, 6, 11); phase 9's 8 share a 256-token
    prefix before 16-200 tokens of their own; phase 10 repeats a 128-token
    prompt; phase 12's repeat a 32-token motif 3-5 times."""
    out = {}
    for ph, n in ((4, 8), (5, 4), (6, 4), (11, 4)):
        rng = np.random.default_rng(ph)
        out[ph] = [rng.integers(0, vocab, int(m))
                   for m in rng.integers(16, 301, n)]
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, vocab, 16 * PAGE)
    out[9] = [np.concatenate([prefix, rng.integers(0, vocab, int(m))])
              for m in rng.integers(16, 201, 8)]
    rng = np.random.default_rng(10)
    a = rng.integers(0, vocab, 8 * PAGE)
    out[10] = [a] + [rng.integers(0, vocab, int(m))
                     for m in rng.integers(16, 301, 2)] + [a.copy()]
    rng = np.random.default_rng(12)
    out[12] = [np.tile(rng.integers(0, vocab, 32), int(r))
               for r in rng.integers(3, 6, 4)]
    return out


def serving_summary(runs, card):
    """One line a serving phase of ``runs`` ({phase: serve()'s result}):
    the wall, ticks, ms a tick, the profiled rerun's device busy share and
    device kernels a forward, and the launches, with the card."""
    for ph, run in runs.items():
        print(f"  serving phase {ph}: " + json.dumps({
            k: run.get(k) for k in ("wall", "ticks", "ms_tick", "busy_share",
                                    "kernels_per_forward", "counts")}) +
            f" ({card})", flush=True)


def serving_profiles(torch, pkg, card):
    """``--serving``: phases 6, 9 and 11 alone (int8 slot cache, bf16 and
    int8 paged pools; the full run's prompts and weights) after a warm-up
    serve, each served and then profiled, with no launch-count checks
    (libraries built earlier are taken as they are): a before/after
    measurement that runs on an earlier commit too."""
    np = pkg["np"]
    model = pkg["GPT"](pkg["gpt_125m"](), seed=0)
    prompts = serving_prompts(np, model.cfg.vocab_size)
    paged = dict(paged=True, page_size=PAGE, prefix_cache=True)
    runs = {}
    print("warm-up: phase 4's requests, bf16 slot cache (not reported)",
          flush=True)
    serve(torch, pkg, model, "bfloat16", prompts[4])
    print("phase 6: serving, int8 cache", flush=True)
    runs[6] = serve(torch, pkg, model, "int8", prompts[6], profile=True)
    print("phase 9: paged serving, bf16 pool", flush=True)
    runs[9] = serve(torch, pkg, model, "bfloat16", prompts[9], profile=True,
                    **paged)
    print("phase 11: paged serving, int8 pool", flush=True)
    runs[11] = serve(torch, pkg, model, "int8", prompts[11], profile=True,
                     **paged)
    serving_summary(runs, card)
    print(card, flush=True)


def release(torch):
    """Free the card memory of what a phase dropped: a stopped server and
    its engine (the 13.4 GB cache of a LLaMA-13B engine, and the model it
    holds) sit in a reference cycle (the server's handler class refers back
    to the server) until the cyclic collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def llama_repro(eng, np):
    """Phase 16's reproducibility check on the sampling engine: a 12-token
    prompt (no complete page, so nothing is shared through the prefix
    cache) with seed 11 alone, then again while another request holds
    slot 0 (so it takes another slot, at other ticks), then with seed 12.
    The first two must be identical, the third must differ."""
    rng = np.random.default_rng(16)
    p, filler = rng.integers(0, LLAMA_V, 12), rng.integers(0, LLAMA_V, 200)
    t_a = eng.ticks
    a = eng.generate(p, MAX_NEW, seed=11, timeout=600)
    fut = eng.submit(filler, 4 * MAX_NEW, None, 5)
    deadline = time.time() + 600
    while eng.stats()["active"] < 1 and time.time() < deadline:
        time.sleep(0.005)
    busy = [not sl.free for sl in eng._slots]
    t_b = eng.ticks
    b = eng.generate(p, MAX_NEW, seed=11, timeout=600)
    fut.result(timeout=600)
    c = eng.generate(p, MAX_NEW, seed=12, timeout=600)
    if not np.array_equal(a, b):
        fail(f"sampling: one prompt and seed gave {a[12:].tolist()} alone "
             f"and {b[12:].tolist()} in another slot at other ticks")
    if np.array_equal(a, c):
        fail("sampling: seeds 11 and 12 gave the same tokens")
    print(f"  reproducible: seed 11 alone (from tick {t_a}) and beside a "
          f"request in slot 0 (slots busy {busy}, from tick {t_b}) gave the "
          f"same {MAX_NEW} tokens; seed 12 differs in "
          f"{int((a != c).sum())} of them", flush=True)


def llama_serving(torch, pkg):
    """Phases 15 and 16: LLaMA-13B served at full width and depth (bf16
    slot cache; paged bf16 pool with sampling). Returns the numbers the
    summary line takes."""
    np, Llama, cfg13 = pkg["np"], pkg["Llama"], pkg["llama_13b"]
    out = {}
    print("phase 15: serving LLaMA-13B (40 layers, full width), bf16 slot "
          f"cache, max_len {LLAMA_L}", flush=True)
    release(torch)                  # 52 GB of f32 draws before the cast
    t0 = time.perf_counter()
    model = Llama(cfg13(), seed=0).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n = sum(p.numel() for p in model.parameters())
    print(f"  built {n / 1e9:.3f} B parameters ({2 * n / 1e9:.1f} GB bf16) "
          f"on the card in {time.perf_counter() - t0:.1f} s (drawn in f32 "
          "there, then cast)", flush=True)
    prompts = serving_prompts(np, LLAMA_V)
    run = serve(torch, pkg, model, "bfloat16", prompts[4], profile=True,
                max_len=LLAMA_L)
    out["b4"] = run["ticks"] * TICK * LLAMA_LAYERS
    expect_launches(f"phase 15 (mega = {run['ticks']} ticks x {TICK} x "
                    f"{LLAMA_LAYERS})", run["counts"],
                    mega_decode_step=out["b4"])
    out["serve15"] = run
    release(torch)

    print("phase 16: paged LLaMA-13B serving, bf16 pool, shared 256-token "
          "prefix, sampling (temperature 0.8, top-k 50, top-p 0.95)",
          flush=True)
    run = serve(torch, pkg, model, "bfloat16", prompts[9], profile=True,
                max_len=LLAMA_L, seeds=list(range(8)),
                extra=lambda eng, url: llama_repro(eng, np), paged=True,
                page_size=PAGE, prefix_cache=True, do_sample=True,
                temperature=0.8, top_k=50, top_p=0.95)
    st = run["stats"]
    if st["pages_total"] != LLAMA_NP or (
            st["prefix_hits"], st["prefix_misses"],
            st["prefix_tokens_saved"]) != (7, 1, 7 * 16 * PAGE):
        fail(f"phase 16: pages {st['pages_total']} != {LLAMA_NP} or prefix "
             f"hits/misses/saved {st['prefix_hits']}/{st['prefix_misses']}/"
             f"{st['prefix_tokens_saved']} != 7/1/{7 * 16 * PAGE}")
    check_pool(run)
    out["kvp"] = paged_launch_check(run, "phase 16", LLAMA_LAYERS)
    out["serve16"] = run
    del model
    release(torch)
    return out


def llama_depth_cut(cfg13, layers, **kw):
    """LLaMA-13B's config at ``layers`` layers (the reference's factory
    fixes num_layers, so it is replaced after)."""
    return dataclasses.replace(cfg13(), num_layers=layers, **kw)


def llama_oracle_and_training(torch, pkg):
    """Phases 17 and 18: LLaMA-13B's f32 oracle at full width and 2
    layers (g = 4), and its training at full width (2 layers against the
    CPU, then a 4-layer bf16 step). Returns phase 18's step (counts,
    losses, ms, paths)."""
    np, Llama, cfg13 = pkg["np"], pkg["Llama"], pkg["llama_13b"]
    print("phase 17: LLaMA-13B width, 2 layers, 10 kv heads (g = 4), f32 "
          "slot cache, vs the sequential CPU oracle", flush=True)
    cfg = llama_depth_cut(cfg13, 2, num_kv_heads=10)
    model = Llama(cfg, seed=1)
    oracle = Llama(cfg, device="cpu", seed=2)
    pkg["load"](oracle, {n: p.detach().cpu().numpy()
                         for n, p in model.named_parameters()})
    rng = np.random.default_rng(17)
    prompts17 = [rng.integers(0, LLAMA_V, int(m))
                 for m in rng.integers(16, 65, 4)]
    run = serve(torch, pkg, model, "float32", prompts17, slots=4,
                max_len=LLAMA_L, max_new=16)
    expect_launches(f"phase 17 (mega = {run['ticks']} ticks x {TICK} x 2)",
                    run["counts"], mega_decode_step=run["ticks"] * TICK * 2)
    check_oracle(torch, pkg, oracle, prompts17, run["toks"],
                 "LLaMA f32 serving (g = 4)", max_new=16)
    del model, oracle
    release(torch)

    print("phase 18: LLaMA-13B width, training: 2 layers f32 vs the CPU at "
          "batch 1 x 64, then a 4-layer bf16 TrainStep at batch 4 x seq "
          f"{LLAMA_L} (full depth would need 13 B x 16 B = 208 GB of "
          "weights and optimizer state: ZeRO over four cards, ROADMAP A12)",
          flush=True)
    train_parity(torch, pkg,
                 build=lambda **kw: Llama(llama_depth_cut(cfg13, 2), **kw),
                 shape=(1, 64), layers=2)
    torch.cuda.empty_cache()
    cfg = llama_depth_cut(cfg13, 4)
    # random logits of variance H r^2 start the loss at ln V + H r^2 / 2
    first = math.log(cfg.vocab_size) + \
        cfg.hidden_size * cfg.initializer_range ** 2 / 2
    step = train_step(torch, pkg, build=lambda: Llama(cfg, seed=0),
                      batch=4, seq=LLAMA_L, layers=4, first_loss=first)
    torch.cuda.empty_cache()
    return step


def post_predict(url, arrays):
    """POST /predict with ``{"inputs": {"x0": ids}}`` for every array at
    once; returns (status, body)s."""
    results = [None] * len(arrays)

    def one(i):
        data = json.dumps({"inputs": {"x0": arrays[i].tolist()}}).encode()
        req = urllib.request.Request(url + "/predict", data=data,
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                results[i] = (r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            results[i] = (e.code, json.loads(e.read() or b"{}"))
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(arrays))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            fail("a /predict request never returned")
    return results


def file_mb(path):
    return os.path.getsize(path) / 1e6


def ernie_serving(torch, pkg, card):
    """Phase 19: ERNIE-3.0-base (12 layers, hidden 768, relu, V 30522, seeded
    random weights, bf16) through jit.save -> Config -> PredictorServer's
    /predict on the card: 8 concurrent requests at batch 1 x 128 and one at
    batch 8, their outputs equal to the eager model's, B1 12 launches a
    request, non-causal, on the tensor-core kernels, no backward and no
    plain version; then 50 sequential batch-1 Predictor.runs (copy_from_cpu
    to copy_to_cpu, as tools/bench_serving.py:bench_encoder times them), one
    profiled; then the program saved in f32 on the CPU, served by a card
    predictor and held to the CPU predictor on the same ids."""
    np, fa, jit, Config = pkg["np"], pkg["fa"], pkg["jit"], pkg["Config"]
    cfg = pkg["ernie_3_base"]()
    print(f"phase 19: serving ERNIE-3.0-base ({cfg.num_layers} layers, "
          f"hidden {cfg.hidden_size}, {cfg.hidden_act}, V {cfg.vocab_size}), "
          f"bf16, jit.save -> Config -> PredictorServer /predict, seq "
          f"{ERNIE_S}", flush=True)
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ernie_")
    try:
        model = pkg["Ernie"](cfg, seed=0).bfloat16()
        path = os.path.join(tmp, "ernie")
        t0 = time.perf_counter()
        jit.save(model, path, input_spec=[jit.InputSpec([None, ERNIE_S],
                                                        "int64")])
        print(f"  jit.save [None, {ERNIE_S}] int64 in "
              f"{time.perf_counter() - t0:.1f} s: program "
              f"{file_mb(path + '.pdmodel'):.2f} MB, params "
              f"{file_mb(path + '.pdiparams'):.1f} MB", flush=True)
        rng = np.random.default_rng(19)
        batches = [rng.integers(0, cfg.vocab_size, (1, ERNIE_S))
                   for _ in range(8)]
        batches.append(rng.integers(0, cfg.vocab_size, (8, ERNIE_S)))
        with torch.no_grad():
            eager = [[t.float().cpu() for t in model(
                torch.from_numpy(b).to(model.device))] for b in batches]
        srv = pkg["Server"](Config(path + ".pdmodel"), host="127.0.0.1",
                            port=0, deadline_s=600, max_queue=16).start()
        plain, restore = _count_plain([fa, pkg["ce"], pkg["fb"]])
        try:
            url = f"http://{srv.host}:{srv.port}"
            with urllib.request.urlopen(url + "/metadata", timeout=60) as r:
                meta = json.loads(r.read())
            if meta["inputs"] != ["x0"]:
                fail(f"/metadata {meta}")
            reset_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)
            t0 = time.perf_counter()
            res = post_predict(url, batches)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {w.__name__: (w.tc_launches, w.simt_launches)
                      for w in (fa.flash_attn_fwd, fa.flash_attn_bwd)}
        finally:
            restore()
            srv.stop()
        exact = 0
        for i, ((code, body), want) in enumerate(zip(res, eager)):
            if code != 200:
                fail(f"/predict {i} -> {code} {body}")
            for name, w in zip(("out0", "out1"), want):
                o = body["outputs"][name]
                got = torch.tensor(o["data"], dtype=torch.float32)
                if o["shape"] != list(w.shape) or o["dtype"] != "float32":
                    fail(f"/predict {i} {name}: {o['shape']} {o['dtype']}, "
                         f"want {list(w.shape)} float32")
                if not torch.equal(got, w):
                    fail(f"/predict {i} {name} differs from the eager "
                         f"model: max |err| {(got - w).abs().max().item()}")
                exact += 1
        n = len(batches)
        want_counts = {"flash_attn_fwd": (cfg.num_layers * n, 0),
                       "flash_attn_bwd": (0, 0)}
        if counts != want_counts or any(plain.values()):
            fail(f"ERNIE serving: B1 (tensor-core, SIMT) launches {counts} "
                 f"!= {want_counts} ({cfg.num_layers} layers x {n} requests,"
                 f" no backward), plain calls {plain}")
        out["b1"] = cfg.num_layers * n
        print(f"  {n} requests (8 x batch 1, 1 x batch 8) in {wall:.3f} s "
              f"(JSON both ways included); {exact} outputs (sequence, "
              f"pooled) equal to the eager model's on the card, bit for "
              f"bit; B1 (tensor-core, SIMT) launches {counts}; plain calls "
              f"{plain}", flush=True)
        del model
        release(torch)

        pred = pkg["create_predictor"](Config(path + ".pdmodel"))
        ids = rng.integers(0, cfg.vocab_size, (1, ERNIE_S))
        h = pred.get_input_handle(pred.get_input_names()[0])

        def run_once():
            h.copy_from_cpu(ids)
            pred.run()
            pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
        lat = []
        for i in range(ERNIE_RUNS + 3):
            t0 = time.perf_counter()
            run_once()                    # copy_to_cpu: the host sync
            if i >= 3:                    # warm-up dropped, as bench_encoder
                lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        out["p50"] = lat[len(lat) // 2]
        out["p99"] = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        prof, prof_wall = profile_window(torch, "one batch-1 Predictor.run",
                                         run_once, top=6)
        busy = sum(r[0] for r in prof)
        out["busy_share"] = busy_share(prof, prof_wall)
        print(f"  ERNIE-3.0-base Predictor.run, batch 1 x {ERNIE_S}, bf16: "
              f"p50 {out['p50']:.3f} ms, p99 {out['p99']:.3f} ms over "
              f"{ERNIE_RUNS} sequential runs (host clock, copy_from_cpu to "
              f"copy_to_cpu; min {lat[0]:.3f}, max {lat[-1]:.3f}); device "
              + ("busy not measured" if not prof else
                 f"busy {busy / 1e3:.3f} ms of the profiled run's "
                 f"{prof_wall / 1e3:.3f} ms ({100 * busy / prof_wall:.1f} %), "
                 f"{sum(r[1] for r in prof)} device kernels")
              + f" ({card})", flush=True)
        del pred
        release(torch)

        print("  a program saved in f32 on the CPU, served on the card and "
              "held to the CPU predictor", flush=True)
        cpu_model = pkg["Ernie"](cfg, device="cpu", seed=0)
        path32 = os.path.join(tmp, "ernie_f32")
        t0 = time.perf_counter()
        jit.save(cpu_model, path32,
                 input_spec=[jit.InputSpec([None, ERNIE_S], "int64")])
        del cpu_model
        cfg_cpu = Config(path32 + ".pdmodel")
        cfg_cpu.disable_gpu()
        ids2 = rng.integers(0, cfg.vocab_size, (2, ERNIE_S))
        want = pkg["create_predictor"](cfg_cpu).run([ids2])
        reset_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)
        card_pred = pkg["create_predictor"](Config(path32 + ".pdmodel"))
        got = card_pred.run([ids2])
        if card_pred.device.type != "cuda" or path_counts(
                fa.flash_attn_fwd) != (cfg.num_layers, 0):
            fail(f"f32 program on the card: device {card_pred.device}, B1 "
                 f"(tensor-core, SIMT) {path_counts(fa.flash_attn_fwd)}")
        check_all(torch, "f32 program saved on the CPU: card predictor vs "
                  "CPU predictor", [
                      ("sequence", torch.from_numpy(got[0]),
                       torch.from_numpy(want[0]), LIM_F32),
                      ("pooled", torch.from_numpy(got[1]),
                       torch.from_numpy(want[1]), LIM_F32)])
        print(f"  (saved and served in {time.perf_counter() - t0:.1f} s; B1 "
              f"on the 3xTF32 kernels, {cfg.num_layers} launches)",
              flush=True)
        del card_pred
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    release(torch)
    return out


def bert_oracle(torch, pkg):
    """Phase 20: BERT-base at full width cut to 2 layers, dropout 0, f32 on
    the card against a CPU copy of its weights (phase 7's rule): the
    classifier's loss and every gradient at batch 2 x 128 without a mask
    (B1 non-causal on the 3xTF32 kernels, 2 launches each way), the same
    with a padding mask (the plain masked attention, no B1), and the MLM
    head's at V 30522 with a quarter of the labels ignored (B2 1 + 1).
    Returns (the unmasked classifier's B1 counts, the MLM's B2 launches)."""
    np = pkg["np"]
    cfg = dataclasses.replace(pkg["bert_base"](), num_layers=2, dropout=0.0)
    print("phase 20: BERT-base width, 2 layers, f32 on the card vs the CPU "
          f"(loss and every gradient at batch 2 x {ERNIE_S})", flush=True)
    pad = np.ones((2, ERNIE_S), np.int64)
    pad[1, 70:] = 0

    def cls_loss(masked):
        def loss_of(m, x):
            mask = torch.from_numpy(pad).to(m.device) if masked else None
            labels = (x[:, 1] % 2).long()
            return m.loss_fn(m(x, None, mask), labels)
        return loss_of

    def mlm_loss(m, x):
        rs = np.random.RandomState(20)
        ign = torch.from_numpy(rs.rand(*x.shape) < 0.25).to(m.device)
        return m.loss_fn(m(x), torch.where(ign, -100, x))

    def cls(**kw):
        return pkg["BertCls"](cfg, **kw)
    b1 = train_parity(torch, pkg, build=cls, shape=(2, ERNIE_S), layers=2,
                      loss_of=cls_loss(False),
                      what="classifier, no mask (B1 non-causal)")
    train_parity(torch, pkg, build=cls, shape=(2, ERNIE_S), layers=0,
                 loss_of=cls_loss(True),
                 what="classifier, padding mask (plain masked attention)")
    train_parity(torch, pkg, build=lambda **kw: pkg["BertMLM"](cfg, **kw),
                 shape=(2, ERNIE_S), layers=2, loss_of=mlm_loss,
                 what=f"MLM, V {cfg.vocab_size}, a quarter of the labels "
                 "ignored")
    release(torch)
    return b1, (pkg["ce"].ce_fwd.launches, pkg["ce"].ce_bwd.launches)


def finetune_batch(torch, np, vocab, device):
    """Phase 21's batch: 32 x 128 ids with padding masks of lengths 32-128
    (pad id 0), token types 1 from the middle of each row's tokens, labels
    the parity of each row's second token (the input determines them)."""
    rng = np.random.default_rng(21)
    lens = rng.integers(32, ERNIE_S + 1, FT_BATCH)
    cols = np.arange(ERNIE_S)[None, :]
    mask = (cols < lens[:, None]).astype(np.int64)
    ids = rng.integers(1, vocab, (FT_BATCH, ERNIE_S)) * mask
    tt = (cols >= lens[:, None] // 2) * mask
    labels = ids[:, 1] % 2
    return [torch.from_numpy(a.astype(np.int64)).to(device)
            for a in (ids, tt, mask, labels)]


def bert_finetune(torch, pkg, steps=5):
    """Phase 21: TrainStep(BertForSequenceClassification(bert_base(),
    num_classes=2).bfloat16(), loss_fn, AdamW(lr=5e-5,
    multi_precision=True), n_inputs=3) at full width and depth, dropout
    0.1, batch 32 x 128 with padding masks: first the generator (one seed
    gives one loss twice, another seed another; the keep rate of the first
    attention-dropout mask within 0.9 +- 0.005), then 1 warm step and 5 on
    the same batch: finite losses, the last below the first, B2 1 + 1 a
    step, B1 and B5 never (the dropout branch is plain code, as in
    paddle_tpu), no plain version; one step profiled. Returns (launch
    counts, losses, ms a step)."""
    np, fa, ce, fb = pkg["np"], pkg["fa"], pkg["ce"], pkg["fb"]
    cfg = pkg["bert_base"]()
    print(f"phase 21: fine-tuning BERT-base ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, dropout {cfg.dropout}), bf16, AdamW lr 5e-5 "
          f"multi_precision, batch {FT_BATCH} x {ERNIE_S}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    model = pkg["BertCls"](cfg, num_classes=2, seed=0).bfloat16()
    batch = finetune_batch(torch, np, cfg.vocab_size, model.device)
    nnfa, keep_mask = pkg["nnfa"], pkg["nnfa"].keep_mask
    rates = []

    def recording(shape, p, device):
        m = keep_mask(shape, p, device)
        if not rates:
            rates.append((tuple(shape), p, m.float().mean().item()))
        return m
    model.train()
    firsts = []
    nnfa.keep_mask = recording
    try:
        with torch.no_grad():
            for s in (7, 7, 8):
                pkg["seed"](s)
                firsts.append(model.loss_fn(model(*batch[:3]),
                                            batch[3]).item())
    finally:
        nnfa.keep_mask = keep_mask
    shape, p, rate = rates[0]
    if firsts[0] != firsts[1] or firsts[2] == firsts[0]:
        fail(f"generator: seeds 7, 7, 8 gave losses {firsts}")
    if not abs(rate - (1 - p)) <= 0.005:
        fail(f"attention-dropout keep rate {rate} not within 0.005 of "
             f"{1 - p}")
    print(f"  generator: seed 7 twice gave loss {firsts[0]:.6f} both times, "
          f"seed 8 {firsts[2]:.6f}; the first attention-dropout mask "
          f"{list(shape)} kept {rate:.5f} (1 - p = {1 - p})", flush=True)

    opt = pkg["AdamW"](learning_rate=5e-5, parameters=model.parameters(),
                       multi_precision=True)
    step = pkg["TrainStep"](model, model.loss_fn, opt, n_inputs=3)
    pkg["seed"](0)
    losses = [step(*batch)]                      # warm: allocations, cuBLAS
    torch.cuda.synchronize()
    plain, restore = _count_plain([fa, ce, fb])
    attn = (fa.flash_attn_fwd, fa.flash_attn_bwd, fb.flash_block_fwd,
            fb.flash_block_bwd)
    reset_counts(*attn)
    ce.ce_fwd.launches = ce.ce_bwd.launches = 0
    try:
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(step(*batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    counts = {w.__name__: w.launches for w in attn}
    counts.update(ce_fwd=ce.ce_fwd.launches, ce_bwd=ce.ce_bwd.launches)
    want = {w.__name__: 0 for w in attn}
    want.update(ce_fwd=steps, ce_bwd=steps)
    vals = [float(x) for x in losses]
    if counts != want or any(plain.values()):
        fail(f"fine-tuning launches {counts} != {want}, plain calls {plain}")
    if not all(math.isfinite(x) for x in vals):
        fail(f"fine-tuning: non-finite loss in {vals}")
    if not vals[-1] < vals[0]:
        fail(f"fine-tuning: the last loss is not below the first: {vals}")
    ms = wall / steps * 1e3
    prof, prof_wall = profile_window(torch, "fine-tuning step",
                                     lambda: step(*batch))
    busy = sum(r[0] for r in prof)
    print(f"  losses {['%.4f' % x for x in vals]} (warm step first); "
          f"{ms:.1f} ms/step, {FT_BATCH * ERNIE_S / (ms / 1e3):.0f} tokens/s "
          f"(smoke number, {steps} steps); launches {counts}; plain calls "
          f"{plain}; profiled step busy "
          + ("not measured" if not prof else
             f"{busy / 1e3:.1f} ms, {100 * busy / prof_wall:.1f} % of its "
             f"wall, {sum(r[1] for r in prof)} device kernels")
          + f"; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    del model, opt, step
    release(torch)
    return counts, vals, ms


# paddle_tpu's engine series for a paged, speculative engine
# (paddle_tpu/inference/engine.py:518-598): what phase 22's /metrics must
# carry
TIER_FAMILIES = (
    "ptpu_engine_mesh_devices", "ptpu_engine_ticks_total",
    "ptpu_engine_admits_total", "ptpu_engine_retires_total",
    "ptpu_engine_cancels_total", "ptpu_engine_batch_occupancy",
    "ptpu_engine_queue_wait_ms", "ptpu_engine_prefill_ms",
    "ptpu_engine_decode_ms", "ptpu_engine_ttft_ms", "ptpu_engine_e2e_ms",
    "ptpu_engine_pages_free", "ptpu_engine_pages_used",
    "ptpu_engine_prefix_hits_total", "ptpu_engine_prefix_misses_total",
    "ptpu_engine_spec_ticks_total", "ptpu_engine_spec_drafted_total",
    "ptpu_engine_spec_accepted_total", "ptpu_engine_spec_rejected_total",
    "ptpu_engine_spec_accepted_per_tick", "ptpu_engine_tick_model_eff")


def http(url, path, payload=None, headers=None, timeout=600):
    """(status, JSON body, headers) of one GET (no payload) or POST."""
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url + path, data=data, headers=dict(
        {"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def stream_generate(url, prompt, max_new, rid, cut_after=None):
    """A streamed POST /generate: its NDJSON lines. With ``cut_after``,
    the socket is closed once that many tokens arrived."""
    req = urllib.request.Request(url + "/generate", data=json.dumps(
        {"input_ids": [int(t) for t in prompt], "max_new_tokens": max_new,
         "stream": True}).encode(), headers={
        "Content-Type": "application/json", "X-PTPU-Request-Id": rid})
    events, n = [], 0
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.headers["Content-Type"] != "application/x-ndjson":
            fail(f"stream {rid}: content type {r.headers['Content-Type']}")
        for raw in r:
            if raw.strip():
                events.append(json.loads(raw))
                n += len(events[-1].get("t", []))
                if cut_after is not None and n >= cut_after:
                    break
    return events


def in_threads(fns):
    """Run every callable at once; their results in order."""
    out = [None] * len(fns)

    def one(i):
        out[i] = fns[i]()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            fail("a request never returned")
    return out


def scrape(url):
    """GET /metrics: ({sample name: value summed over its labels}, the
    family names with a # TYPE line)."""
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        if "text/plain" not in r.headers["Content-Type"]:
            fail("/metrics content type")
        text = r.read().decode()
    vals, types = {}, set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            types.add(line.split()[2])
        elif line and not line.startswith("#"):
            name = line.split("{")[0].split()[0]
            vals[name] = vals.get(name, 0.0) + float(line.split()[-1])
    return vals, types


def wait_until(what, cond, timeout=120):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"timed out waiting for {what}")
        time.sleep(0.005)


def admit_together(eng, n):
    """Hold the engine's next admission pass until ``n`` requests wait, so
    that they are admitted in one pass and tick together: two runs of the
    same requests then run the same forwards, and their bf16 tokens can be
    held to each other token for token (with arrivals spread over ticks,
    a row would see other verify and plain ticks, other GEMM shapes)."""
    orig = eng._admit_ready

    def gated():
        wait_until(f"{n} queued requests", lambda: len(eng._queue) >= n)
        del eng._admit_ready                 # the class's method again
        orig()
    eng._admit_ready = gated


def check_streams(what, prompts, streams, singles, max_new):
    """Each stream's {"t"} lines are its done body's generated suffix and
    the done body's tokens the single-shot reply's."""
    for i, (p, ev, (code, one)) in enumerate(zip(prompts, streams,
                                                 singles)):
        if code != 200 or "done" not in ev[-1]:
            fail(f"{what} request {i}: single-shot {code}, stream end "
                 f"{ev[-1]}")
        body = ev[-1]["done"]
        got = [t for e in ev[:-1] for t in e["t"]]
        if (got != body["tokens"][len(p):len(p) + body["tokens_generated"]]
                or body["tokens"] != one["tokens"]
                or len(body["tokens"]) != len(p) + max_new
                or len(ev[0]["t"]) != 1):
            fail(f"{what} request {i}: streamed tokens differ from the "
                 "done body or from the single-shot reply")


def serving_tier(torch, pkg, card, cold_ttft_ms):
    """Phase 22 (see the module docstring): the serving tier's engine
    surface on gpt_125m at full width and depth. Returns the figures it
    prints."""
    np, obs, resil = pkg["np"], pkg["obs"], pkg["resil"]
    reg = obs.metrics.registry
    model = pkg["GPT"](pkg["gpt_125m"](), seed=0)
    prompts = serving_prompts(np, model.cfg.vocab_size)
    p8 = prompts[4]
    wrappers = {name: getattr(pkg[m], name) for m, name in SERVE_KERNELS}
    out = {}
    eng = pkg["Engine"](model, slots=8, max_len=L_SLICE,
                        cache_dtype="bfloat16", tick_tokens=TICK,
                        paged=True, page_size=PAGE, prefix_cache=True,
                        speculative="ngram")
    if not eng._obs:
        fail("obs is off (PADDLE_TPU_OBS): the tier phase needs it on")
    plain, restore = _count_plain([pkg["md"], pkg["cw"]])
    t0 = time.perf_counter()
    srv = pkg["Server"](engine=eng, host="127.0.0.1", port=0,
                        deadline_s=600, warmup=True).start()
    url = f"http://{srv.host}:{srv.port}"
    try:
        code, body, _ = http(url, "/healthz")
        if code != 503 or body["status"] != "warming":
            fail(f"/healthz during warmup: {code} {body.get('status')}")
        wait_until("warmup", lambda: http(url, "/healthz")[0] == 200)
        out["warmup_s"] = time.perf_counter() - t0
        _, body, _ = http(url, "/healthz")
        st0 = eng.stats()
        if "warmup_error" in body or not body["engine"]["warm"] or (
                st0["ticks"], st0["admitted"], st0["pages_used"]) != (0, 0,
                                                                      0):
            fail(f"after warmup: {body}")
        eng._allocator.check()
        print(f"  warmup: 503 warming, then ready after "
              f"{out['warmup_s']:.3f} s (server start to /healthz 200; "
              f"{st0['compiled_programs']} programs run: "
              f"{len(eng.prefill_buckets)} prefill buckets, decode, verify, "
              f"page copy) ({card})", flush=True)
        for w in wrappers.values():
            w.launches = 0
        m0, _ = scrape(url)
        code, _, _ = http(url, "/generate", {
            "input_ids": p8[0].tolist(), "max_new_tokens": MAX_NEW},
            {"X-PTPU-Request-Id": "tier-first"})
        first = [e for e in obs.recorder.events()
                 if e["name"] == "engine.prefill"
                 and e["args"].get("request_id") == "tier-first"]
        if code != 200 or len(first) != 1:
            fail(f"first request after warmup: {code}, spans {first}")
        out["first_ttft_ms"] = first[0]["args"]["ttft_ms"]
        print(f"  first request after warmup: TTFT "
              f"{out['first_ttft_ms']:.3f} ms; phase 9's cold first "
              f"request (no warmup): {cold_ttft_ms:.3f} ms ({card})",
              flush=True)

        print("  streaming: the 8 prompts once (their prefixes cached), "
              "then 8 concurrent streams and the same 8 single-shot, each "
              "set admitted in one pass", flush=True)
        snaps = {n: reg.get(n).snap() for n in ("ptpu_engine_ttft_ms",
                                                "ptpu_engine_queue_wait_ms")}
        if any(c != 200 for c, _ in post_all(url, p8, MAX_NEW)):
            fail("tier: a request of the first pass failed")
        # TTFT and queue wait of these 8 requests, which arrive at once
        for n, snap in snaps.items():
            dl = reg.get(n).snap().minus(snap)
            out[n] = (dl.percentile(0.5), dl.percentile(0.99))
        admit_together(eng, len(p8))
        streams = in_threads([
            (lambda p=p, i=i: stream_generate(url, p, MAX_NEW, f"tier-s{i}"))
            for i, p in enumerate(p8)])
        admit_together(eng, len(p8))
        singles = post_all(url, p8, MAX_NEW)
        check_streams("paged speculative", p8, streams, singles, MAX_NEW)
        st1 = eng.stats()
        counts = {n: w.launches for n, w in wrappers.items()}
        expect_launches(f"tier streaming (forwards {forwards(st1)} x "
                        f"{LAYERS})", counts,
                        kv_paged_write=forwards(st1) * LAYERS)
        if any(plain.values()):
            fail(f"tier: plain versions ran on the card: {plain}")
        print(f"  streams equal their done bodies and the single-shot "
              f"replies; kv_paged_write {counts['kv_paged_write']} = "
              f"{forwards(st1)} forwards x {LAYERS}, no plain version; "
              f"{st1['spec_ticks']} verify ticks of {st1['ticks']}",
              flush=True)

        print("  cancel: /cancel mid-decode, then a stream cut by its "
              "client", flush=True)
        long_p = p8[1]
        code, full = post_all(url, [long_p], 256)[0]
        if code != 200:
            fail(f"long request: {code} {full}")
        greedy = full["tokens"][len(long_p):]
        res = {}
        th = threading.Thread(target=lambda: res.update(r=http(
            url, "/generate", {"input_ids": long_p.tolist(),
                               "max_new_tokens": 256},
            {"X-PTPU-Request-Id": "tier-cancel"})))
        ticks = eng.stats()["ticks"]
        th.start()
        wait_until("the long request's decode", lambda: eng.stats()["ticks"]
                   >= ticks + 3)
        resil.arm_fault("replica_stall", 1, wedge_s=1.0)
        code, body, _ = http(url, "/cancel", {"request_id": "tier-cancel"})
        th.join(timeout=120)
        if th.is_alive() or code != 200 or not body["cancelled"]:
            fail(f"/cancel: {code} {body}")
        code, body, _ = res["r"]
        part = body.get("partial_tokens", [])
        if (code != 409 or body["error"] != "cancelled" or not part
                or len(part) >= 256 or part != greedy[:len(part)]):
            fail(f"cancelled request: {code} {body}")
        cancelled = eng.stats()["cancelled"]
        ev = stream_generate(url, p8[2], 256, "tier-cut", cut_after=8)
        wait_until("the cut stream's cancellation", lambda: (
            eng.stats()["cancelled"] == cancelled + 1
            and eng.stats()["active"] == 0))
        eng._allocator.check()
        st2 = eng.stats()
        print(f"  cancelled mid-decode: 409 with {len(part)} partial "
              f"tokens, a prefix of the uncancelled run's; the stream cut "
              f"after {sum(len(e.get('t', [])) for e in ev)} tokens was "
              f"cancelled; active {st2['active']}, pages in use "
              f"{st2['pages_used']} (cached prefix "
              f"{st2['pages_cached_prefix']}), allocator clean", flush=True)

        m1, types = scrape(url)
        missing = [f for f in TIER_FAMILIES if f not in types]
        if missing:
            fail(f"/metrics lacks {missing}")
        back = [n for n in m0 if (n.endswith("_total") or
                                  n.endswith("_count")) and m1[n] < m0[n]]
        d = {n: m1[n] - m0.get(n, 0.0) for n in (
            "ptpu_engine_ticks_total", "ptpu_engine_admits_total",
            "ptpu_engine_retires_total", "ptpu_engine_cancels_total")}
        want = {"ptpu_engine_ticks_total": st2["ticks"] - st0["ticks"],
                "ptpu_engine_admits_total": st2["admitted"],
                "ptpu_engine_retires_total": st2["completed"]
                + st2["cancelled"],
                "ptpu_engine_cancels_total": st2["cancelled"]}
        if back or d != want:
            fail(f"/metrics: counters went back {back}; deltas {d} != "
                 f"stats {want}")
        out["tick_model_eff"] = st2["tick_model_eff"]
        print(f"  /metrics: {len(TIER_FAMILIES)} families present, counters "
              f"monotone, deltas = stats {want}; TTFT p50 "
              f"{out['ptpu_engine_ttft_ms'][0]:.2f} ms p99 "
              f"{out['ptpu_engine_ttft_ms'][1]:.2f} ms, queue wait p50 "
              f"{out['ptpu_engine_queue_wait_ms'][0]:.2f} ms p99 "
              f"{out['ptpu_engine_queue_wait_ms'][1]:.2f} ms over the 8 "
              "requests of the first pass, which arrive at once (bucket "
              "estimates); last "
              f"tick_model_eff {st2['tick_model_eff']} ({card})", flush=True)

        print("  /admin/trace?duration_s=2&profile=1 over 8 requests",
              flush=True)
        rids = [f"tier-t{i}" for i in range(8)]
        tr = {}
        th = threading.Thread(target=lambda: tr.update(r=http(
            url, "/admin/trace?duration_s=2&profile=1", {})))
        th.start()
        time.sleep(0.3)
        replies = in_threads([
            (lambda p=p, r=r: http(url, "/generate", {
                "input_ids": p.tolist(), "max_new_tokens": MAX_NEW},
                {"X-PTPU-Request-Id": r})) for p, r in zip(p8, rids)])
        th.join(timeout=300)
        code, doc, _ = tr["r"]
        meta = doc.get("metadata", {})
        if (code != 200 or "torch_profile_error" in meta
                or any(c != 200 for c, _, _ in replies)):
            fail(f"/admin/trace: {code} {meta}")
        gen_ids = {e["args"].get("request_id") for e in doc["traceEvents"]
                   if e["name"] == "serve.generate"}
        n_tick = sum(e["name"] == "engine.tick" for e in doc["traceEvents"])
        if not set(rids) <= gen_ids or not n_tick:
            fail(f"trace: serve.generate ids {sorted(gen_ids)}, "
                 f"{n_tick} engine.tick spans")
        with open(os.path.join(meta["torch_profile_dir"], "trace.json")) as f:
            kern = [e for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "kernel"]
        n_kvp = sum("kv_paged_write" in e.get("name", "") for e in kern)
        if not n_kvp:
            fail(f"the profiler's trace names no kv_paged_write kernel "
                 f"({len(kern)} kernels)")
        print(f"  trace: {len(doc['traceEvents'])} spans, {n_tick} "
              f"engine.tick, serve.generate for all 8 request ids; the "
              f"profiler's trace holds {len(kern)} kernels, {n_kvp} of "
              "them kv_paged_write", flush=True)

        print("  drain: stop(drain_s=120) with one request in flight",
              flush=True)
        res = {}
        th = threading.Thread(target=lambda: res.update(r=http(
            url, "/generate", {"input_ids": p8[3].tolist(),
                               "max_new_tokens": 128})))
        th.start()
        wait_until("the in-flight request", lambda: srv.inflight() >= 1
                   and eng.stats()["active"] >= 1)
        resil.arm_fault("replica_stall", 1, wedge_s=2.0)
        stopper = threading.Thread(target=srv.stop,
                                   kwargs={"drain_s": 120.0})
        stopper.start()
        wait_until("the drain", lambda: srv._draining)
        code, body, hdr = http(url, "/generate", {
            "input_ids": p8[0].tolist(), "max_new_tokens": 4})
        if (code != 503 or body.get("error") != "draining"
                or int(hdr.get("Retry-After", 0)) < 1):
            fail(f"/generate while draining: {code} {body}")
        th.join(timeout=300)
        stopper.join(timeout=300)
        code, body, _ = res["r"]
        if (th.is_alive() or stopper.is_alive() or code != 200
                or len(body["tokens"]) != len(p8[3]) + 128):
            fail(f"the in-flight request across the drain: {code}")
        st3 = eng.stats()
        expect_launches(f"tier, whole phase (forwards {forwards(st3)} x "
                        f"{LAYERS})", {n: w.launches for n, w in
                                       wrappers.items()},
                        kv_paged_write=forwards(st3) * LAYERS)
        if any(plain.values()):
            fail(f"tier: plain versions ran on the card: {plain}")
        print("  the new request got 503 draining with Retry-After "
              f"{hdr['Retry-After']}; the in-flight one finished, 200 with "
              "all 128 tokens", flush=True)
    finally:
        restore()
        srv.stop()
        eng.stop()
    release(torch)

    print("  slot engine, bf16 cache (B4): 4 streams vs single-shot",
          flush=True)
    eng = pkg["Engine"](model, slots=8, max_len=L_SLICE,
                        cache_dtype="bfloat16", tick_tokens=TICK)
    srv = pkg["Server"](engine=eng, host="127.0.0.1", port=0,
                        deadline_s=600).start()
    url = f"http://{srv.host}:{srv.port}"
    plain, restore = _count_plain([pkg["md"], pkg["cw"]])
    try:
        for w in wrappers.values():
            w.launches = 0
        p4 = p8[:4]
        admit_together(eng, len(p4))
        streams = in_threads([
            (lambda p=p, i=i: stream_generate(url, p, MAX_NEW, f"slot-s{i}"))
            for i, p in enumerate(p4)])
        admit_together(eng, len(p4))
        singles = post_all(url, p4, MAX_NEW)
        check_streams("slot", p4, streams, singles, MAX_NEW)
        st = eng.stats()
        counts = {n: w.launches for n, w in wrappers.items()}
        expect_launches(f"slot streams (mega = {st['ticks']} ticks x {TICK}"
                        f" x {LAYERS})", counts,
                        mega_decode_step=st["ticks"] * TICK * LAYERS)
        if any(plain.values()):
            fail(f"slot streams: plain versions ran on the card: {plain}")
        print(f"  streams equal the single-shot replies; mega_decode_step "
              f"{counts['mega_decode_step']} launches", flush=True)
    finally:
        restore()
        srv.stop()
        eng.stop()

    print("  instrumentation cost: phase 4's serving with PADDLE_TPU_OBS off"
          " and on, in turns (off, on, on, off three times)", flush=True)
    ms = {False: [], True: []}
    for on in (False, True, True, False) * 3:
        obs.set_enabled(on)
        try:
            run = serve(torch, pkg, model, "bfloat16", p8, max_len=L_SLICE)
        finally:
            obs.set_enabled(None)
        ms[on].append(run["ms_tick"])
    out["ms_tick_obs"] = ms
    med = {k: sorted(v)[len(v) // 2 - 1:len(v) // 2 + 1] for k, v in
           ms.items()}
    med = {k: sum(v) / 2 for k, v in med.items()}
    out["ms_tick_median_obs_off_on"] = (med[False], med[True])
    print(f"  ms a tick (host clock), obs off {ms[False]}, on {ms[True]}; "
          f"medians {med[False]:.2f} / {med[True]:.2f} ({card})", flush=True)
    del model
    release(torch)
    return out


# the router's families (paddle_tpu/inference/router.py:1318-1410): what
# phase 23's /metrics must carry
ROUTER_FAMILIES = (
    "ptpu_router_forward_ms", "ptpu_router_forwards_total",
    "ptpu_router_retries_total", "ptpu_router_ejections_total",
    "ptpu_router_breaker_open", "ptpu_router_ready_replicas",
    "ptpu_router_recoveries_total", "ptpu_router_hedges_total",
    "ptpu_router_hedge_wins_total", "ptpu_router_cancels_total",
    "ptpu_router_token_progress_ms", "ptpu_router_ttft_ms",
    "ptpu_router_streams_total", "ptpu_router_client_disconnects_total",
    "ptpu_router_ttft_hedges_total", "ptpu_router_prewarms_total",
    "ptpu_router_prewarmed_resumes_total")
TIER_NEW = 128                      # phase 23's kill -9 streams


def tier_stream(url, prompt, max_new, rid, first=None):
    """A streamed POST /generate through the tier: (its NDJSON events, ms
    to the first token block); ``first`` is set when that block arrives."""
    req = urllib.request.Request(url + "/generate", data=json.dumps(
        {"input_ids": [int(t) for t in prompt], "max_new_tokens": max_new,
         "stream": True}).encode(), headers={
        "Content-Type": "application/json", "X-PTPU-Request-Id": rid})
    t0, ttft, events = time.perf_counter(), None, []
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.headers["Content-Type"] != "application/x-ndjson":
            fail(f"tier stream {rid}: content type "
                 f"{r.headers['Content-Type']}")
        for raw in r:
            if raw.strip():
                events.append(json.loads(raw))
                if ttft is None and "t" in events[-1]:
                    ttft = (time.perf_counter() - t0) * 1e3
                    if first is not None:
                        first.set()
    return events, ttft


def stream_body(what, prompt, events, max_new):
    """The done body of a finished stream whose {"t"} lines are exactly its
    generated tokens, each once."""
    if not events or "done" not in events[-1]:
        fail(f"{what}: the stream ended with {events[-1:] or 'nothing'}")
    body = events[-1]["done"]
    got = [t for e in events[:-1] for t in e["t"]]
    if (len(body["tokens"]) != len(prompt) + max_new
            or body["tokens"][:len(prompt)] != [int(x) for x in prompt]
            or got != body["tokens"][len(prompt):]):
        fail(f"{what}: {len(got)} streamed tokens against a done body of "
             f"{len(body['tokens'])} (prompt {len(prompt)}, {max_new} new)")
    return body


class ReplicaWatch:
    """Polls the router's replicas every 20 ms on a thread: when each was
    spawned and first seen ready (``time.monotonic()``)."""

    def __init__(self, router):
        self.router, self.seen, self.ready = router, {}, {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.02):
            now = time.monotonic()
            with self.router._lock:
                reps = list(self.router._replicas)
            for r in reps:
                self.seen.setdefault(r.name, r.spawned_at)
                if r.state == "ready":
                    self.ready.setdefault(r.name, now)

    def ready_s(self, name):
        return self.ready[name] - self.seen[name]

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def replica_health(rep):
    """/healthz of one replica (its body, whatever the status)."""
    return http(f"http://127.0.0.1:{rep['port']}", "/healthz")[1]


def replica_counts(router):
    """{replica name: (kv_paged_write launches, forwards)} from each
    replica's /healthz, read once the tier is idle (no slot busy, the same
    counts twice in a row: a standby's /prewarm may still be landing)."""
    def read():
        out = {}
        for rep in router.replicas():
            eng = replica_health(rep)["engine"]
            if eng["active"] or eng["queued"]:
                return None
            out[rep["name"]] = (eng["kernel_launches"]["kv_paged_write"],
                                eng["admitted"] + eng["ticks"] * TICK)
        return out
    prev = None
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        cur = read()
        if cur is not None and cur == prev:
            return cur
        prev = cur
        time.sleep(0.2)
    fail(f"the tier never went idle: {router.replicas()}")


def no_nvcc(router, rep):
    """The replica compiled nothing: its /healthz and its log say so.
    Returns its start-up stages, in seconds from its spawn: the
    interpreter and imports ("main"), the model built on the card, the
    engine, the server (its listener, the profiler primed), ready
    (warmup done, within the child's quarter-second poll)."""
    comp = replica_health(rep)["compilation"]
    path = os.path.join(router.workdir, f"{rep['name']}.log")

    def log():
        with open(path) as f:
            return f.read()
    # the replica logs its line within a quarter second of turning ready
    wait_until(f"{rep['name']}'s ready line", lambda: "replica ready" in
               log(), timeout=30)
    if comp["nvcc_runs"] != 0 or '"nvcc_runs": 0' not in log():
        fail(f"replica {rep['name']} ran nvcc: {comp}; log "
             f"{log()[-2000:]}")
    line = [ln for ln in log().splitlines() if "replica ready" in ln][0]
    stages = json.loads(line.split(" stages ", 1)[1])
    spawned = next(r.spawned_at for r in router._replicas
                   if r.name == rep["name"])
    return {k: round(v - spawned, 3) for k, v in stages.items()}


def profile_kernels(meta):
    """The device kernels' names in a ``/admin/trace?profile=1`` capture's
    torch.profiler trace."""
    with open(os.path.join(meta["torch_profile_dir"], "trace.json")) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel"]


def router_tier(torch, pkg, card, direct):
    """Phase 23 (see the module docstring): Router over two replica
    processes of gpt_125m on the card. ``direct`` is phase 22's figures.
    Returns the figures it prints."""
    t_phase = time.perf_counter()
    np, obs, resil, rt = pkg["np"], pkg["obs"], pkg["resil"], pkg["router"]
    reg = obs.metrics.registry
    cfg = pkg["gpt_125m"]()
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab_size, int(m))
               for m in rng.integers(16, 301, 8)]
    kill_p = rng.integers(0, cfg.vocab_size, (8, 64))
    if len({tuple(p[:PAGE]) for p in prompts}) != 8:
        fail("phase 23's prompts share a first page")
    out = {}

    print("  the CPU oracle (phase 5's rule) first, so that the replicas "
          "start on idle host cores", flush=True)
    card_model = pkg["GPT"](cfg, seed=0)
    oracle = pkg["GPT"](cfg, device="cpu", seed=1)
    pkg["load"](oracle, {n: p.detach().cpu().numpy()
                         for n, p in card_model.named_parameters()})
    del card_model
    release(torch)
    t0 = time.perf_counter()
    want = {i: pkg["generate"](oracle, p, MAX_NEW, cache_dtype="float32")[0]
            for i, p in enumerate(prompts)}
    # the kill streams' prompts are one length: one batched call
    want["kill"] = pkg["generate"](oracle, kill_p, TIER_NEW,
                                   cache_dtype="float32")
    print(f"  oracle: {time.perf_counter() - t0:.1f} s (8 x {MAX_NEW} tokens "
          f"one prompt at a time, 8 x {TIER_NEW} as one batch)", flush=True)

    model_spec = {"kind": "gpt", "vocab_size": cfg.vocab_size,
                  "hidden_size": cfg.hidden_size,
                  "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
                  "max_seq_len": cfg.max_seq_len, "device": "cuda"}
    engine_spec = {"paged": True, "page_size": PAGE, "prefix_cache": True,
                   "cache_dtype": "float32", "slots": 8, "max_len": L_SLICE,
                   "tick_tokens": TICK}
    spec = rt.ReplicaSpec(model_spec, engine_spec, warmup=True,
                          drain_s=30.0, seed=0,
                          env=rt.single_device_child_env("gpu"))
    t0 = time.perf_counter()
    built = pkg["build"]()           # every library, before any spawn
    print(f"  kernels built in the parent before the spawn: "
          f"{sorted(built) or 'all already built'} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    router = rt.Router(spec, replicas=2, poll_s=0.1, deadline_s=600.0)
    watch = None
    try:
        t0 = time.perf_counter()
        router.start()
        watch = ReplicaWatch(router)
        if not router.wait_ready(2, timeout=300):
            fail(f"tier not ready: {router.replicas()}")
        url = f"http://{router.host}:{router.port}"
        code, hz, _ = http(url, "/healthz")
        if code != 200 or hz["ready_replicas"] != 2 or not hz["tier"]:
            fail(f"tier /healthz: {code} {hz}")
        fresh = {r["name"]: r for r in router.replicas()}
        wait_until("the watcher", lambda: set(fresh) <= set(watch.ready))
        out["ready_fresh_s"] = [watch.ready_s(n) for n in sorted(fresh)]
        out["stages_fresh_s"] = [no_nvcc(router, fresh[n])
                                 for n in sorted(fresh)]
        print(f"  2 replicas ({', '.join(sorted(fresh))}, pids "
              f"{[r['pid'] for r in fresh.values()]}) ready after "
              f"{time.perf_counter() - t0:.3f} s; each from spawn "
              f"{['%.3f s' % s for s in out['ready_fresh_s']]}; tier "
              f"/healthz 200 with 2 ready; neither ran nvcc; stages from "
              f"spawn {out['stages_fresh_s']} ({card})", flush=True)

        base = replica_counts(router)
        print("  identity: the 8 prompts one at a time, 32 new tokens each",
              flush=True)
        toks = []
        for i, p in enumerate(prompts):
            code, body, _ = http(url, "/generate", {
                "input_ids": p.tolist(), "max_new_tokens": MAX_NEW},
                {"X-PTPU-Request-Id": f"tier23-i{i}"})
            if code != 200 or body.get("request_id") != f"tier23-i{i}":
                fail(f"tier request {i}: {code} {body}")
            toks.append(body["tokens"])
        check_oracle(torch, pkg, oracle, prompts, toks, "tier (sequential)",
                     wants=[want[i] for i in range(8)])

        print("  /admin/trace?duration_s=2&profile=1 on each replica, 8 "
              "concurrent streams through the tier", flush=True)
        snap = reg.get("ptpu_router_ttft_ms").snap()
        traces = {}
        reps = router.replicas()
        tths = [threading.Thread(target=lambda r=r: traces.update({
            r["name"]: http(f"http://127.0.0.1:{r['port']}",
                            "/admin/trace?duration_s=2&profile=1", {})}))
            for r in reps]
        for th in tths:
            th.start()
        time.sleep(0.3)
        rids = [f"tier23-t{i}" for i in range(8)]
        streams = in_threads([
            (lambda p=p, r=r: tier_stream(url, p, MAX_NEW, r))
            for p, r in zip(prompts, rids)])
        for th in tths:
            th.join(timeout=300)
        bodies = [stream_body(f"trace stream {i}", p, ev, MAX_NEW)
                  for i, (p, (ev, _)) in enumerate(zip(prompts, streams))]
        check_oracle(torch, pkg, oracle, prompts,
                     [b["tokens"] for b in bodies], "tier (8 streams)",
                     wants=[want[i] for i in range(8)])
        dl = reg.get("ptpu_router_ttft_ms").snap().minus(snap)
        client = sorted(t for _, t in streams)
        out["tier_ttft_ms"] = (dl.percentile(0.5), dl.percentile(0.99))
        out["tier_ttft_client_ms"] = (client[len(client) // 2 - 1],
                                      client[-1])
        for name, (code, doc, _) in traces.items():
            meta = doc.get("metadata", {})
            if code != 200 or "torch_profile_error" in meta:
                fail(f"replica {name} /admin/trace: {code} {meta}")
            kern = profile_kernels(meta)
            n_kvp = sum("kv_paged_write" in k for k in kern)
            n_md = sum("mega_decode" in k for k in kern)
            if not n_kvp or n_md:
                fail(f"replica {name}'s profiler trace: {n_kvp} "
                     f"kv_paged_write and {n_md} mega_decode of "
                     f"{len(kern)} kernels")
            print(f"    {name}: the profiler's trace holds {len(kern)} "
                  f"kernels, {n_kvp} of them kv_paged_write, no "
                  "mega_decode", flush=True)
        # the router's wall around each request: its router.forward span
        # (the attempt "<rid>.0") minus the replica's serve.generate span
        fwd = {e["args"]["request_id"]: e["dur"] for e in
               obs.recorder.events() if e["name"] == "router.forward"
               and e.get("args", {}).get("request_id", "").startswith(
                   "tier23-t")}
        gen = {}
        for r in router.replicas():
            _, doc, _ = http(f"http://127.0.0.1:{r['port']}",
                             "/admin/trace?duration_s=0", {})
            gen.update({e["args"]["request_id"]: e["dur"]
                        for e in doc["traceEvents"]
                        if e["name"] == "serve.generate"
                        and e.get("args", {}).get("request_id") in fwd})
        added = sorted((fwd[k] - gen[k]) / 1e3 for k in gen)
        if len(added) != 8:
            fail(f"router.forward / serve.generate pairs: {len(added)} of 8 "
                 f"({sorted(fwd)}, {sorted(gen)})")
        out["router_added_ms"] = (added[3], added[-1])
        after = replica_counts(router)
        launches = {n: after[n][0] - base[n][0] for n in base}
        fwds = {n: after[n][1] - base[n][1] for n in base}
        if any(launches[n] != fwds[n] * LAYERS or not launches[n]
               for n in base):
            fail(f"tier kv_paged_write launches {launches} != forwards "
                 f"{fwds} x {LAYERS} on every replica")
        out["kv_paged_write"] = sum(launches.values())
        print(f"  tokens of both passes match the CPU oracle; streams equal "
              f"their done bodies; kv_paged_write launches {launches} = "
              f"forwards {fwds} x {LAYERS}; TTFT over the 8 streams (router "
              f"histogram, bucket estimates) p50 {out['tier_ttft_ms'][0]:.2f}"
              f" ms p99 {out['tier_ttft_ms'][1]:.2f} ms, client-side p50 "
              f"{out['tier_ttft_client_ms'][0]:.2f} ms max "
              f"{out['tier_ttft_client_ms'][1]:.2f} ms; phase 22's direct "
              f"engine p50 {direct['ptpu_engine_ttft_ms'][0]:.2f} ms p99 "
              f"{direct['ptpu_engine_ttft_ms'][1]:.2f} ms; the router's "
              f"added wall (router.forward - serve.generate) median "
              f"{added[3]:.3f} ms max {added[-1]:.3f} ms ({card})",
              flush=True)

        print(f"  kill -9: 8 concurrent streams of {TIER_NEW} new tokens, "
              "one replica killed mid-decode", flush=True)
        rec0 = router.stats_counters["recoveries"]
        resp0 = router.stats_counters["respawns"]
        firsts = [threading.Event() for _ in range(8)]
        kres = [None] * 8

        def kill_client(i):
            kres[i] = tier_stream(url, kill_p[i], TIER_NEW, f"tier23-k{i}",
                                  firsts[i])
        kths = [threading.Thread(target=kill_client, args=(i,))
                for i in range(8)]
        for th in kths:
            th.start()
        wait_until("every stream's first token",
                   lambda: all(e.is_set() for e in firsts))
        busy = max(router.replicas(), key=lambda r: r["inflight"])
        if busy["inflight"] <= 0:
            fail(f"no replica has a forward in flight: {router.replicas()}")
        t_kill = time.monotonic()
        os.kill(busy["pid"], signal.SIGKILL)
        for th in kths:
            th.join(timeout=600)
            if th.is_alive():
                fail("a kill -9 stream never ended")
        kb = [stream_body(f"kill stream {i}", kill_p[i], kres[i][0],
                          TIER_NEW) for i in range(8)]
        check_oracle(torch, pkg, oracle, list(kill_p),
                     [b["tokens"] for b in kb], "tier across the kill",
                     max_new=TIER_NEW, wants=list(want["kill"]))
        recovered = [b.get("recovered", 0) for b in kb]
        nrec = router.stats_counters["recoveries"] - rec0
        vals, _ = scrape(url)
        dumps = []
        for fn in sorted(os.listdir(obs.trace.artifact_dir())):
            if fn.startswith("flight_request_recovery_"):
                with open(os.path.join(obs.trace.artifact_dir(), fn)) as f:
                    dumps += [m["request_id"] for m in
                              json.load(f)["metadata"]["migrated"]]
        if (nrec < 1 or vals.get("ptpu_router_recoveries_total", 0) < 1
                or not any(recovered) or not dumps
                or not set(dumps) <= {f"tier23-k{i}" for i in range(8)}):
            fail(f"recovery: {nrec} counted, metric "
                 f"{vals.get('ptpu_router_recoveries_total')}, recovered "
                 f"{recovered}, flight dump ids {dumps}")
        wait_until("the respawn", lambda: router.ready_count() == 2
                   and router.stats_counters["respawns"] > resp0,
                   timeout=300)
        new = [r for r in router.replicas() if r["name"] not in fresh]
        wait_until("the watcher", lambda: new[0]["name"] in watch.ready)
        out["stages_successor_s"] = [no_nvcc(router, new[0])]
        out["respawn_ready_s"] = watch.ready[new[0]["name"]] - t_kill
        out["ready_successor_s"] = [watch.ready_s(new[0]["name"])]
        out["recoveries"] = nrec
        print(f"  killed {busy['name']} (pid {busy['pid']}, {busy['inflight']}"
              f" in flight): every stream complete, {TIER_NEW} tokens each, "
              f"streamed = done body, held to the CPU oracle; recoveries "
              f"{nrec} (streams recovered {recovered}), flight dump names "
              f"{sorted(set(dumps))}; {new[0]['name']} respawned and ready "
              f"{out['respawn_ready_s']:.3f} s after the kill "
              f"({out['ready_successor_s'][0]:.3f} s from its spawn), no "
              f"nvcc ({card})", flush=True)

        print("  an armed router_forward fault", flush=True)
        retries = router.stats_counters["retries"]
        resil.arm_fault("router_forward", 1)
        code, body, _ = http(url, "/generate", {
            "input_ids": prompts[0].tolist(), "max_new_tokens": 8})
        if code != 200 or router.stats_counters["retries"] != retries + 1:
            fail(f"injected fault: {code} {body}, retries "
                 f"{router.stats_counters['retries'] - retries}")
        print(f"  retried once, answered 200 by {body['served_by']}",
              flush=True)

        print("  rolling restart under light traffic", flush=True)
        stop, light = threading.Event(), []

        def traffic():
            while not stop.is_set():
                light.append(http(url, "/generate", {
                    "input_ids": prompts[1][:32].tolist(),
                    "max_new_tokens": 16})[0])
                time.sleep(0.05)
        th = threading.Thread(target=traffic)
        th.start()
        t0 = time.perf_counter()
        try:
            res = router.rolling_restart(ready_timeout=300)
        finally:
            stop.set()
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        if not res["ok"] or len(res["replaced"]) != 2 or not light or any(
                c != 200 for c in light):
            fail(f"rolling restart: {res}; requests {light}")
        succ = [new for _, new in res["replaced"]]
        out["stages_successor_s"] += [
            no_nvcc(router, r) for r in router.replicas()]
        wait_until("the watcher", lambda: set(succ) <= set(watch.ready))
        out["ready_successor_s"] += [watch.ready_s(n) for n in succ]
        print(f"  replaced {res['replaced']} in {wall:.1f} s; {len(light)} "
              f"requests meanwhile, all 200; successors ready "
              f"{['%.3f s' % watch.ready_s(n) for n in succ]} from spawn, "
              f"no nvcc ({card})", flush=True)

        text = urllib.request.urlopen(url + "/metrics", timeout=60).read(
            ).decode()
        types = {ln.split()[2] for ln in text.splitlines()
                 if ln.startswith("# TYPE ")}
        live = [r["name"] for r in router.replicas()]
        missing = [f for f in ROUTER_FAMILIES if f not in types] + [
            n for n in live if f'replica="{n}"' not in text] + [
            s for s in ("ptpu_tier_engine_ticks_total",
                        "ptpu_tier_engine_ttft_ms_count")
            if f"\n{s} " not in text]
        if missing:
            fail(f"tier /metrics lacks {missing}")
        print(f"  tier /metrics: the {len(ROUTER_FAMILIES)} ptpu_router_* "
              f"families, {live}'s series relabeled, ptpu_tier_engine_* "
              "sums", flush=True)

        print("  nothing admits: both replicas draining", flush=True)
        for rep in router.replicas():
            code, body, _ = http(f"http://127.0.0.1:{rep['port']}",
                                 "/drain", {})
            if code != 200:
                fail(f"/drain {rep['name']}: {code} {body}")
        wait_until("no ready replica", lambda: router.ready_count() == 0)
        code, body, hdr = http(url, "/generate", {
            "input_ids": prompts[0].tolist(), "max_new_tokens": 4})
        if (code != 503 or body.get("error") != "no_replica_ready"
                or int(hdr.get("Retry-After", 0)) < 1):
            fail(f"/generate with both draining: {code} {body}")
        print(f"  503 {body['error']} with Retry-After {hdr['Retry-After']}",
              flush=True)
        out["stats"] = {k: router.stats_counters[k] for k in (
            "forwards", "retries", "recoveries", "respawns", "hedges",
            "hedge_wins", "rolling_restarts", "streams")}
        out["wall_s"] = time.perf_counter() - t_phase
    finally:
        if watch is not None:
            watch.stop()
        procs = [r.proc for r in router._replicas]
        router.stop()
        if any(p.poll() is None for p in procs):
            fail("a replica process outlived router.stop()")
    del oracle
    release(torch)
    return out


def hold_to_plain(torch, model, prompts, got, want, what):
    """Phase 24's token rule: each request's tokens equal the plain
    engine's, except at a token where the bf16 target itself cannot tell
    the top two apart: at the first differing token, one cacheless
    forward of ``model`` over the common prefix must show a top-2 logit
    margin below DRAFT_MARGIN, and the request is not compared beyond it.
    Returns the number of requests identical to the end."""
    same = 0
    for p, g, w in zip(prompts, got, want):
        diff = [i for i, (a, b) in enumerate(zip(g, w)) if a != b]
        if not diff:
            same += 1
            continue
        i = diff[0]
        with torch.no_grad():
            lg = model(torch.tensor([w[:i]], device=model.device))[0, -1]
        top2 = torch.topk(lg.float(), 2).values
        margin = float(top2[0] - top2[1])
        print(f"  {what}: token {i - len(p)} of a {len(p)}-token prompt "
              f"differs (spec {g[i]}, plain {w[i]}); the bf16 target's top-2 "
              f"margin there {margin:.4f} (limit {DRAFT_MARGIN})", flush=True)
        if not margin < DRAFT_MARGIN:
            fail(f"{what}: tokens differ from plain decode where the "
                 f"target's margin {margin} is not below {DRAFT_MARGIN}")
    print(f"  {what}: {same} of {len(prompts)} requests identical to plain "
          "decode to the end; the others held by the margin rule", flush=True)
    return same


def draft_window(torch, pkg, eng, url, prompts):
    """Phase 24's extra, on the draft engine before it stops: /healthz
    reports the draft engine and its counters; then the same requests
    once more with each draft proposal and each verify forward timed on
    the card's clock (CUDA events around the calls, both end in a host
    read) inside one torch.profiler window (device busy share)."""
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        e = json.loads(r.read())["engine"]
    keys = ("spec_ticks", "tokens_drafted", "tokens_accepted",
            "tokens_rejected", "acceptance_rate", "accepted_tokens_per_tick")
    if e.get("speculative") != "draft" or e.get("spec_k") != DRAFT_K or any(
            k not in e for k in keys):
        fail(f"/healthz engine: {e}")
    spans = {"draft": [], "verify": []}

    def timed_call(fn, acc):
        def run(*a):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            out = fn(*a)
            t1.record()
            acc.append((t0, t1))
            return out
        return run
    eng._proposer.propose = timed_call(eng._proposer.propose,
                                       spans["draft"])
    eng._verify_forward = timed_call(eng._verify_forward, spans["verify"])
    try:
        prof, wall_us = profile_window(
            torch, "draft engine, the same requests again",
            lambda: post_all(url, prompts, MAX_NEW), top=8)
    finally:
        del eng._proposer.propose, eng._verify_forward
    torch.cuda.synchronize()
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    n = len(spans["verify"])
    busy = busy_share(prof, wall_us)
    b4_us = sum(r[0] for r in prof if "mega_decode" in r[2])
    print(f"  healthz: speculative {e['speculative']}, spec_k {e['spec_k']}, "
          + ", ".join(f"{k} {e[k]}" for k in keys), flush=True)
    print(f"  {n} verify ticks: draft {ms['draft']:.1f} ms, verify "
          f"{ms['verify']:.1f} ms on the card's clock ({ms['draft'] / n:.2f}"
          f" + {ms['verify'] / n:.2f} ms a tick); window {wall_us / 1e3:.1f} "
          "ms, device busy "
          + ("not measured" if busy is None else f"{100 * busy:.1f} %")
          + f"; B4 (the draft's steps) {b4_us / 1e3:.3f} ms device",
          flush=True)
    return {"draft_ms_tick": ms["draft"] / n, "verify_ms_tick":
            ms["verify"] / n, "window_ms": wall_us / 1e3, "busy_share": busy,
            "b4_device_ms": b4_us / 1e3}


def draft_serving(torch, pkg, card):
    """Phase 24: draft-model speculation at full width: GPT-6.7B (bf16,
    paged bf16 pool, prefix cache) drafted by GPT-125M (f32 slot cache),
    held to a plain paged engine on the same weights by DRAFT_MARGIN's
    rule, with its launch counts; then the full-acceptance oracle
    (gpt_125m drafted by a copy of its own weights, f32 slot cache, vs
    the CPU by phase 5's rule). Returns the numbers the summary takes."""
    np, GPT = pkg["np"], pkg["GPT"]
    print("phase 24: draft-model speculation: GPT-6.7B (bf16, 32 layers, "
          "paged bf16 pool of 1024 pages) drafted by GPT-125M (f32 slot "
          f"cache), spec_k={DRAFT_K}", flush=True)
    release(torch)
    t0 = time.perf_counter()
    model = GPT(pkg["gpt_6p7b"](), seed=0)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    model = model.bfloat16()
    torch.cuda.empty_cache()
    n = sum(p.numel() for p in model.parameters())
    print(f"  GPT-6.7B host draw and copy: {draw_s:.1f} s ({n / 1e9:.3f} B "
          "parameters drawn by one CPU generator, one at a time, then "
          "copied to the card in f32)", flush=True)
    draft = GPT(pkg["gpt_125m"](), seed=1)
    V = model.cfg.vocab_size
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, V, int(m)) for m in rng.integers(16, 301, 8)]
    paged = dict(paged=True, page_size=PAGE, num_pages=DRAFT_NP,
                 prefix_cache=True)
    print("  plain paged decode, the same weights and prompts:", flush=True)
    plain = serve(torch, pkg, model, "bfloat16", prompts, max_len=2048,
                  **paged)
    paged_launch_check(plain, "phase 24 plain", GPT67_LAYERS)
    print("  draft-model speculation:", flush=True)
    spec = serve(torch, pkg, model, "bfloat16", prompts, max_len=2048,
                 speculative="draft", draft_model=draft, spec_k=DRAFT_K,
                 extra=lambda eng, url: draft_window(torch, pkg, eng, url,
                                                     prompts), **paged)
    st = spec["stats"]
    check_pool(spec)
    if not st["ticks"] == st["spec_ticks"] > 0:
        fail(f"phase 24: {st['ticks']} ticks, {st['spec_ticks']} verify: "
             "every tick of a draft engine is a verify tick")
    kvp = (st["admitted"] + st["spec_ticks"]) * GPT67_LAYERS
    b4 = st["spec_ticks"] * (DRAFT_K - 1) * DRAFT_LAYERS
    expect_launches(f"phase 24 (kv_paged_write = ({st['admitted']} "
                    f"admissions + {st['spec_ticks']} verify ticks) x "
                    f"{GPT67_LAYERS}; mega = {st['spec_ticks']} draft ticks "
                    f"x {DRAFT_K - 1} x {DRAFT_LAYERS})", spec["counts"],
                    kv_paged_write=kvp, mega_decode_step=b4)
    same = hold_to_plain(torch, model, prompts, spec["toks"], plain["toks"],
                         "GPT-6.7B draft speculation")
    print(f"  acceptance {st['acceptance_rate']}, "
          f"{st['accepted_tokens_per_tick']} tokens per slot per verify "
          f"tick; {spec['ms_tick']:.2f} ms a verify tick against plain "
          f"decode's {plain['ms_tick']:.2f} ms a tick of {TICK} ({card})",
          flush=True)
    out = {"b4": b4, "kvp": kvp, "identical": same,
           "acceptance_rate": st["acceptance_rate"],
           "accepted_tokens_per_tick": st["accepted_tokens_per_tick"],
           "ms_tick": spec["ms_tick"], "plain_ms_tick": plain["ms_tick"],
           "wall": spec["wall"], "plain_wall": plain["wall"],
           "draw_s": draw_s, **spec["extra"]}
    del model, draft
    release(torch)

    print("  full-acceptance oracle: gpt_125m f32 drafted by a copy of its "
          "own weights, f32 slot cache, vs the sequential CPU oracle",
          flush=True)
    target = GPT(pkg["gpt_125m"](), seed=0)
    copy = GPT(pkg["gpt_125m"](), seed=5)
    oracle = GPT(pkg["gpt_125m"](), device="cpu", seed=6)
    weights = {n: p.detach().cpu().numpy()
               for n, p in target.named_parameters()}
    pkg["load"](copy, weights)
    pkg["load"](oracle, weights)
    prompts = [rng.integers(0, V, int(m)) for m in rng.integers(16, 301, 4)]
    run = serve(torch, pkg, target, "float32", prompts, slots=4,
                speculative="draft", draft_model=copy, spec_k=DRAFT_K)
    st = run["stats"]
    expect_launches(f"phase 24 oracle (mega = {st['spec_ticks']} draft "
                    f"ticks x {DRAFT_K - 1} x {LAYERS})", run["counts"],
                    mega_decode_step=st["spec_ticks"] * (DRAFT_K - 1)
                    * LAYERS)
    if not (st["acceptance_rate"] > 0.9
            and st["accepted_tokens_per_tick"] > 2):
        fail(f"full-acceptance draft: acceptance {st['acceptance_rate']}, "
             f"{st['accepted_tokens_per_tick']} tokens per verify tick")
    check_oracle(torch, pkg, oracle, prompts, run["toks"],
                 "full-acceptance draft speculation")
    print(f"  acceptance {st['acceptance_rate']}, "
          f"{st['accepted_tokens_per_tick']} tokens per slot per verify "
          f"tick, {st['spec_ticks']} verify ticks", flush=True)
    out["oracle"] = {k: st[k] for k in ("acceptance_rate",
                                        "accepted_tokens_per_tick",
                                        "spec_ticks")}
    del target, copy, oracle
    release(torch)
    return out


def g13_steps(torch, pkg, model, ids, recompute_policy=None, steps=5,
              profile=False, what=""):
    """TrainStep(model, model.make_loss_fn(), AdamW(lr 1e-4, no master
    weights)) at ``ids``: a warm step, then ``steps`` timed ones with the
    kernel launches counted (every plain version too) and the peak
    memory from the warm step on; then one loss and backward alone, whose
    peak above the memory held before it is what the activations (and the
    grads) take, apart from the optimizer's update. Returns (losses, ms a
    step, launches, (tensor-core, SIMT) B1 paths, peak GiB, forward +
    backward GiB)."""
    fa, ce, fb = pkg["fa"], pkg["ce"], pkg["fb"]
    if recompute_policy is not None:
        from paddle_tpu_torch.distributed.recompute import \
            resolve_checkpoint_policy
        model.gpt.blocks._ckpt_policy = resolve_checkpoint_policy(
            recompute_policy)
    opt = pkg["AdamW"](learning_rate=1e-4, parameters=model.parameters(),
                       multi_precision=False)
    step = pkg["TrainStep"](model, model.make_loss_fn(), opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids, ids)]
    torch.cuda.synchronize()
    plain, restore = _count_plain([fa, ce, fb])
    reset_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)
    ce.ce_fwd.launches = ce.ce_bwd.launches = 0
    try:
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(step(ids, ids))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / max(steps, 1) * 1e3
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {"flash_attn_fwd": fa.flash_attn_fwd.launches,
              "flash_attn_bwd": fa.flash_attn_bwd.launches,
              "ce_fwd": ce.ce_fwd.launches, "ce_bwd": ce.ce_bwd.launches}
    paths = {w.__name__: (w.tc_launches, w.simt_launches)
             for w in (fa.flash_attn_fwd, fa.flash_attn_bwd)}
    torch.cuda.reset_peak_memory_stats()
    rest = torch.cuda.memory_allocated()
    step.loss_fn(model(ids), ids).backward()
    torch.cuda.synchronize()
    fwd_bwd = (torch.cuda.max_memory_allocated() - rest) / 2 ** 30
    for p in model.parameters():
        p.grad = None
    if any(plain.values()):
        fail(f"{what}: plain versions ran: {plain}")
    if profile:
        profile_window(torch, what, lambda: step(ids, ids))
    vals = [float(x) for x in losses[:steps + 1]]
    print(f"  {what}: losses {['%.4f' % x for x in vals]} (warm step "
          f"first); {ms:.1f} ms/step ({G13_B * G13_S / (ms / 1e3):.0f} "
          f"tokens/s, {steps} steps); peak memory {peak:.2f} GiB (one loss "
          f"and backward alone: {fwd_bwd:.2f} GiB above the {rest / 2**30:.2f}"
          f" GiB held); launches {counts}, (tensor-core, SIMT) {paths}",
          flush=True)
    del step, opt
    torch.cuda.empty_cache()
    return vals, ms, counts, paths, peak, fwd_bwd


def gpt13_training(torch, pkg, card):
    """Phase 25: the training memory features at bench.py's GPT-1.3B
    step (recompute "full", scan_layers, fused_loss_chunk 2048, AdamW
    without master weights, batch 4 x 2048), full width and depth; then
    the same weights with the features off (an unrolled model, plain
    loss_fn), "dots" for two steps, and the f32 oracle at 2 layers
    against the CPU. Returns the numbers the summary takes."""
    np, GPT, cfg13 = pkg["np"], pkg["GPT"], pkg["gpt_1p3b"]
    print("phase 25: training memory features at bench.py's GPT-1.3B step "
          "(24 layers, hidden 2048; recompute, scan_layers, fused loss in "
          f"chunks of {G13_CHUNK}), AdamW without master weights, batch "
          f"{G13_B} x {G13_S}", flush=True)
    release(torch)
    t0 = time.perf_counter()
    model = GPT(cfg13(recompute=True, scan_layers=True,
                      fused_loss_chunk=G13_CHUNK, recompute_policy="full"),
                seed=0).bfloat16()
    torch.cuda.synchronize()
    print(f"  built in {time.perf_counter() - t0:.1f} s (host draw)",
          flush=True)
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    rs = np.random.RandomState(25)
    ids = torch.from_numpy(rs.randint(0, model.cfg.vocab_size,
                                      (G13_B, G13_S))).to(model.device)
    on = g13_steps(torch, pkg, model, ids, profile=True,
                   what="features on (recompute full)")
    vals, _, counts, paths, _, _ = on
    steps = len(vals) - 1
    b1f, b1b = 2 * G13_LAYERS * steps, G13_LAYERS * steps
    chunks = G13_B * G13_S // G13_CHUNK
    want = {"flash_attn_fwd": b1f, "flash_attn_bwd": b1b,
            "ce_fwd": chunks * steps, "ce_bwd": chunks * steps}
    if counts != want or paths != {"flash_attn_fwd": (b1f, 0),
                                   "flash_attn_bwd": (b1b, 0)}:
        fail(f"phase 25: launches {counts}, paths {paths} != {want} (B1 "
             f"forward 2 x {G13_LAYERS} a step under recompute, backward "
             f"{G13_LAYERS}, B2 {chunks} chunks a step each way; every B1 "
             "launch on the tensor-core kernels)")
    cfg = model.cfg
    first = math.log(cfg.vocab_size) + \
        cfg.hidden_size * cfg.initializer_range ** 2 / 2
    if not all(math.isfinite(x) for x in vals):
        fail(f"phase 25: non-finite loss in {vals}")
    if not abs(vals[0] - first) <= 0.5:
        fail(f"phase 25: first loss {vals[0]} not within 0.5 of {first:.4f}"
             " (ln V + H r^2 / 2)")
    if not vals[-1] < min(vals[0], vals[1]):
        fail(f"phase 25: the last loss is not below the first: {vals}")

    with torch.no_grad():                 # "dots" from the same weights
        for n, p in model.named_parameters():
            p.copy_(w0[n])
    dots, _, _, _, _, dots_gib = g13_steps(torch, pkg, model, ids, "dots",
                                           steps=1,
                                           what='recompute_policy "dots"')
    d = max(abs(a - b) for a, b in zip(dots, vals))
    if not d <= FEATURES_LOSS_ATOL:
        fail(f"phase 25: dots losses {dots} vs full {vals[:2]}: max "
             f"|diff| {d} > {FEATURES_LOSS_ATOL}")
    del model
    torch.cuda.empty_cache()

    plain = GPT(cfg13(), seed=0).bfloat16()  # unrolled, features off
    with torch.no_grad():
        own = dict(plain.named_parameters())
        for n, t in w0.items():
            if "__" in n:                 # a stacked leaf: one a block
                head, leaf = n.split(".blocks.")
                for i, blk in enumerate(plain.gpt.blocks):
                    dict(blk.named_parameters())[
                        leaf.replace("__", ".")].copy_(t[i])
            else:
                own[n].copy_(t)
    off = g13_steps(torch, pkg, plain, ids, what="features off (unrolled, "
                    "no recompute, plain loss_fn)")
    d = max(abs(a - b) for a, b in zip(off[0], vals))
    if not d <= FEATURES_LOSS_ATOL:
        fail(f"phase 25: features-off losses {off[0]} vs on {vals}: max "
             f"|diff| {d} > {FEATURES_LOSS_ATOL}")
    print(f"  features on vs off: max |loss diff| {d:.2e} (limit "
          f"{FEATURES_LOSS_ATOL}); peak memory {on[4]:.2f} vs {off[4]:.2f} "
          f"GiB, a loss and backward alone {on[5]:.2f} vs {off[5]:.2f} GiB "
          f"(dots {dots_gib:.2f}); {on[1]:.1f} vs {off[1]:.1f} ms a step "
          f"({card})", flush=True)
    del plain, w0
    release(torch)

    n_chunks = -(-2 * 1100 // G13_CHUNK)
    print("  f32 oracle: gpt_1p3b cut to 2 layers, f32, the three features "
          f"on, card vs CPU at batch 2 x 1100 (the fused loss in {n_chunks} "
          "chunks, the last padded)", flush=True)
    cfg2 = dataclasses.replace(cfg13(recompute=True, scan_layers=True,
                                     fused_loss_chunk=G13_CHUNK), num_layers=2)
    train_parity(torch, pkg, build=lambda **kw: GPT(cfg2, **kw),
                 shape=(2, 1100), layers=2, recompute=True,
                 b2=(n_chunks, n_chunks),
                 loss_of=lambda m, x: m.make_loss_fn()(m(x), x),
                 what="GPT-1.3B width f32 oracle")
    release(torch)
    return {"counts": counts, "losses_on": vals, "losses_off": off[0],
            "ms_on": on[1], "ms_off": off[1], "peak_gib_on": on[4],
            "peak_gib_off": off[4], "fwd_bwd_gib_on": on[5],
            "fwd_bwd_gib_off": off[5], "fwd_bwd_gib_dots": dots_gib,
            "dots": dots}


# phase 26: the training API. GPT-125M at bench.py's geometry takes two
# windows of API_K steps against 2 x API_K calls; BERT-base fine-tunes at
# phase 21's shape with Lamb, the global clip and warmup over polynomial
# decay; the nine optimizers of A4 (and two clips) run gpt_tiny in f32 on
# the card against a CPU copy.
API_K = 4
API_OPTIMIZERS = (
    ("SGD", dict(learning_rate=0.1), None),
    ("Momentum", dict(learning_rate=0.05, use_nesterov=True), None),
    ("Adamax", dict(learning_rate=0.01), None),
    ("Adagrad", dict(learning_rate=0.1), None),
    ("Adadelta", dict(learning_rate=1.0, rho=0.9), None),
    ("RMSProp", dict(learning_rate=0.01, centered=True, momentum=0.9), None),
    ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.01,
                  exclude_from_weight_decay_fn=lambda p: p.ndim == 1), None),
    ("Lars", dict(learning_rate=0.1, lars_coeff=0.02,
                  exclude_from_weight_decay=["bias"]), None),
    ("DGCMomentum", dict(learning_rate=0.1, rampup_begin_step=1,
                         rampup_step=1, sparsity=[0.5, 0.9]), None),
    ("SGD", dict(learning_rate=0.1), ("ClipGradByNorm", 0.05)),
    ("Momentum", dict(learning_rate=0.05), ("ClipGradByValue", 0.01)),
)


def snapshot(step):
    """Copies of ``step``'s parameters, optimizer slots, counters (its
    own and the optimizer's step number) and scheduler state."""
    opt = step.optimizer
    return ({n: p.detach().clone() for n, p in step.model.named_parameters()},
            {s: {n: t.clone() for n, t in d.items()}
             for s, d in opt._accumulators.items()},
            (step.step_count, step.update_count, opt._step_count),
            copy.deepcopy(opt._learning_rate.state_dict()))


def restore(torch, step, snap):
    """Put ``snap`` (from ``snapshot``) back into ``step`` (or another
    TrainStep over the same model with the same kind of optimizer)."""
    params, slots, counters, sched = snap
    opt = step.optimizer
    with torch.no_grad():
        for n, p in step.model.named_parameters():
            p.copy_(params[n])
            p.grad = None
    opt._accumulators = {s: {n: t.clone() for n, t in d.items()}
                         for s, d in slots.items()}
    step.step_count, step.update_count, opt._step_count = counters
    opt._learning_rate.set_state_dict(copy.deepcopy(sched))


def snapshot_diff(torch, a, b):
    """(max |difference| over parameters and slots, counters and
    scheduler equal) between two snapshots."""
    if set(a[1]) != set(b[1]):
        return math.inf, False
    worst = 0.0
    for x, y in ((a[0], b[0]), *((a[1][s], b[1][s]) for s in a[1])):
        for n in x:
            worst = max(worst, (x[n].float() - y[n].float()).abs().max()
                        .item())
    return worst, (a[2], a[3]) == (b[2], b[3])


def hold_runs(what, repeat, other, base_losses, repeat_losses,
              other_losses):
    """Hold a run through windows to the same steps as single calls:
    equal counters and scheduler, and losses, parameters and slots bit
    for bit, or within the larger of four times the calls' own spread (a
    second calls' run's, or the largest of several) and 1e-7 on a
    parameter or slot (1e-6 of the loss's size).
    One repeat cannot prove the card deterministic: torch's CUDA
    embedding backward sums a row's duplicate indices with atomics, and
    BERT-base's token-type embedding (4,096 indices into 2 rows) differs
    by up to 3e-8 between identical calls. A wrong lr, step number or
    mask moves them by far more (an update at a 4e-5 lr is ~4e-5).
    ``repeat`` and ``other`` are (max |param or slot diff| against the
    first calls' run, counters and scheduler equal) of the second calls'
    run and of the windows' run; then the three runs' losses."""
    loss_other = max(abs(a - b) for a, b in zip(other_losses, base_losses))
    loss_repeat = max(abs(a - b) for a, b in zip(repeat_losses, base_losses))
    if not (other[1] and repeat[1]):
        fail(f"{what}: counters or scheduler differ from the calls'")
    if other[0] == 0.0 and loss_other == 0.0:
        return "bit for bit"
    lim = max(4 * repeat[0], 1e-7)
    lim_loss = max(4 * loss_repeat,
                   1e-6 * max(abs(x) for x in base_losses))
    if not (other[0] <= lim and loss_other <= lim_loss):
        fail(f"{what}: windows vs calls max |diff| {other[0]} (losses "
             f"{loss_other}) beyond {lim} ({lim_loss}); the calls' own "
             f"spread {repeat[0]} ({loss_repeat})")
    return (f"within the card's own spread (params/slots {other[0]:.2e} <= "
            f"{lim:.2e}, losses {loss_other:.2e} <= {lim_loss:.2e}; the "
            f"calls' own spread: {repeat[0]:.2e} / {loss_repeat:.2e})")


def gpt_window(torch, pkg, card):
    """Phase 26, GPT-125M: warm, windows against calls (also under
    gradient merge), launches, eval_fn, timing. Returns the numbers the
    summary takes."""
    np, fa, ce, fb = pkg["np"], pkg["fa"], pkg["ce"], pkg["fb"]
    model = pkg["GPT"](pkg["gpt_125m"](), seed=0).bfloat16()
    torch.cuda.empty_cache()

    def make(k=1):
        opt = pkg["AdamW"](learning_rate=pkg["lr"].OneCycleLR(1e-3, 40),
                           parameters=model.parameters(),
                           multi_precision=True)
        return pkg["TrainStep"](model, model.make_loss_fn(), opt,
                                accumulate_steps=k)
    step = make()
    n = 2 * API_K
    rs = np.random.RandomState(26)
    ids = torch.from_numpy(rs.randint(0, model.cfg.vocab_size,
                                      (n, B_SLICE, L_SLICE))).to(model.device)
    windows = (ids[:API_K], ids[API_K:])
    pkg["seed"](0)
    before = snapshot(step)
    rng = pkg["random"].get_rng_state()
    nvcc = pkg["kbuild"].summary()["nvcc_runs"]
    recs = step.warm(ids[0], ids[0], scan_k=API_K)
    snap = snapshot(step)
    after_rng = pkg["random"].get_rng_state()
    sites = [r["site"] for r in recs]
    if sites != ["train_step", f"train_step_scan_k{API_K}"]:
        fail(f"warm: sites {sites}")
    moved = max((snap[0][n] != before[0][n]).sum().item() for n in snap[0])
    if (moved or snap[2:] != before[2:]
            or pkg["kbuild"].summary()["nvcc_runs"] != nvcc
            or after_rng["seed"] != rng["seed"]
            or any(not torch.equal(after_rng["states"][d], s)
                   for d, s in rng["states"].items())):
        fail(f"warm moved state: {moved} parameter elements, counters "
             f"{before[2]} -> {snap[2]}, nvcc runs {nvcc} -> "
             f"{pkg['kbuild'].summary()['nvcc_runs']}")
    masters = snap[1]["master"]
    if any(masters[n].dtype != torch.float32 or not torch.equal(
            masters[n], snap[0][n].float()) for n in snap[0]) or any(
            m.any().item() for m in snap[1]["moment1"].values()):
        fail("warm: slots are not zeros and f32 copies of the parameters")
    print(f"  warm: sites {sites}, {recs[0]['slots']} parameters with slots,"
          f" built {recs[0]['built']} (nvcc runs stay {nvcc}), "
          f"{recs[0]['seconds']:.3f} s; parameters, counters, scheduler and "
          "generators unchanged", flush=True)

    def calls():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step(b, b) for b in ids]
        torch.cuda.synchronize()
        return [float(x) for x in losses], time.perf_counter() - t0

    def scans(debug=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if debug:
            torch.cuda.set_sync_debug_mode("error")
        try:
            losses = [step.scan_steps(API_K, w, w) for w in windows]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return ([float(x) for x in torch.cat(losses)],
                time.perf_counter() - t0)

    runs = {}
    attn = (fa.flash_attn_fwd, fa.flash_attn_bwd, fb.flash_block_fwd,
            fb.flash_block_bwd)
    # the first two runs check, the next three pairs (in turns) time
    order = [("calls", calls), ("windows", lambda: scans(True))] + [
        (f"{name} {r}", fn) for r in (1, 2, 3)
        for name, fn in (("calls", calls), ("windows", scans))]
    for name, fn in order:
        restore(torch, step, snap)
        if name == "windows":
            plain, restore_plain = _count_plain([fa, ce, fb])
            reset_counts(*attn)
            ce.ce_fwd.launches = ce.ce_bwd.launches = 0
            try:
                runs[name] = fn()
            finally:
                restore_plain()
            counts = {w.__name__: (w.launches, w.tc_launches)
                      for w in attn}
            counts.update(ce_fwd=ce.ce_fwd.launches,
                          ce_bwd=ce.ce_bwd.launches)
        else:
            runs[name] = fn()
        runs[name] += (snapshot(step) if name in ("calls", "windows",
                                                  "calls 1") else None,)
    b1 = n * LAYERS
    want = {"flash_attn_fwd": (b1, b1), "flash_attn_bwd": (b1, b1),
            "flash_block_fwd": (0, 0), "flash_block_bwd": (0, 0),
            "ce_fwd": n, "ce_bwd": n}
    if counts != want or any(plain.values()):
        fail(f"windows: launches (all, tensor-core) {counts} != {want}, "
             f"plain calls {plain}")
    base = runs["calls"]
    how = hold_runs("GPT-125M windows",
                    snapshot_diff(torch, base[2], runs["calls 1"][2]),
                    snapshot_diff(torch, base[2], runs["windows"][2]),
                    base[0], runs["calls 1"][0], runs["windows"][0])
    if any(runs[f"windows {r}"][0] != runs["windows"][0] for r in (1, 2, 3)):
        fail("a timed windows run gave other losses than the first")
    vals = base[0]
    if not all(math.isfinite(x) for x in vals):
        fail(f"GPT-125M losses {vals}: not finite")
    per_step = {kind: sorted(runs[f"{kind} {r}"][1] / n * 1e3
                             for r in (1, 2, 3))
                for kind in ("calls", "windows")}
    ms_call, ms_window = per_step["calls"][1], per_step["windows"][1]
    print(f"  {n} calls vs 2 x scan_steps({API_K}) (the first window run "
          "under set_sync_debug_mode('error')): losses "
          f"{['%.4f' % x for x in vals]}, equal {how}; launches (all, "
          f"tensor-core) {counts}, plain calls {plain}; ms a step, three "
          f"runs of 8 steps each way in turns (sorted): calls "
          f"{[round(x, 1) for x in per_step['calls']]}, windows "
          f"{[round(x, 1) for x in per_step['windows']]} (medians "
          f"{ms_call:.1f} / {ms_window:.1f}; smoke numbers, {card})",
          flush=True)

    restore(torch, step, snap)
    prof, prof_wall = profile_window(
        torch, f"window of {API_K} steps",
        lambda: step.scan_steps(API_K, windows[0], windows[0]))
    busy = busy_share(prof, prof_wall)

    # gradient merge: windows of 3 that drift across the phase, a flush
    # (a no-op: 6 steps leave the cadence aligned), a skipped micro-step
    # and a call, against the same sequence of single calls, twice
    step2 = make(k=2)
    merged = []
    for use_windows in (False, True, False):
        restore(torch, step2, snap)
        losses = []
        if use_windows:
            for w in (ids[:3], ids[3:6]):
                losses += [float(x) for x in step2.scan_steps(3, w, w)]
        else:
            losses += [float(step2(b, b)) for b in ids[:6]]
        step2.flush_accumulation()
        step2.skip_step()
        losses.append(float(step2(ids[6], ids[6])))
        merged.append((losses, snapshot(step2)))
    if merged[0][1][2] != (8, 4, 4):
        fail(f"gradient merge counters {merged[0][1][2]} != (8, 4, 4)")
    d = [snapshot_diff(torch, merged[0][1], m[1]) for m in merged]
    how2 = hold_runs("GPT-125M gradient merge", d[2], d[1],
                     merged[0][0], merged[2][0], merged[1][0])
    print(f"  accumulate_steps=2: 2 x scan_steps(3), flush_accumulation, "
          f"skip_step, one call against 6 calls and the same: losses "
          f"{['%.4f' % x for x in merged[0][0]]}, equal {how2}; counters "
          f"(step, update, t) {merged[0][1][2]}", flush=True)

    x = ids[0][:2]
    got = step.eval_fn()(x)
    model.eval()
    with torch.no_grad():
        want_logits = model(x)
    model.train()
    if not torch.equal(got, want_logits) or not model.training:
        fail("eval_fn's logits differ from model(ids) in eval mode, or the "
             "training mode was not restored")
    print(f"  eval_fn: logits {list(got.shape)} equal to model(ids) in eval "
          "mode, bit for bit; training mode restored", flush=True)
    del model, step, step2, snap, before, runs, merged
    release(torch)
    return {"losses": vals, "window_vs_calls": how, "merge": how2,
            "ms_per_step_calls": [round(x, 3) for x in per_step["calls"]],
            "ms_per_step_window": [round(x, 3) for x in per_step["windows"]],
            "window_busy_share": None if busy is None else round(busy, 4),
            "launches": counts}


def bert_window(torch, pkg, card):
    """Phase 26, BERT-base fine-tuning with Lamb: window masks, and masks
    after a skip at learning rate 0."""
    np = pkg["np"]
    cfg = pkg["bert_base"]()
    model = pkg["BertCls"](cfg, num_classes=2, seed=0).bfloat16()
    batch = finetune_batch(torch, np, cfg.vocab_size, model.device)
    stacked = [torch.stack([t] * API_K) for t in batch]

    def make(lr):
        lrm = pkg["lr"]
        sched = lrm.LinearWarmup(lrm.PolynomialDecay(lr, 20, end_lr=0.0), 2,
                                 0.0, lr)
        opt = pkg["optim"].Lamb(learning_rate=sched, lamb_weight_decay=0.01,
                                parameters=model.parameters(),
                                grad_clip=pkg["clip"].ClipGradByGlobalNorm(
                                    1.0), multi_precision=True)
        return pkg["TrainStep"](model, model.loss_fn, opt, n_inputs=3)
    step = make(1e-4)
    step.warm(*batch, scan_k=API_K)
    snap = snapshot(step)
    pkg["seed"](0)
    # calls, a window, calls, a window, calls, calls: both windows are held
    # to the first calls' run within four times the card's own spread,
    # the largest of the three later calls' runs (one repeat can read ~0
    # by chance: 3e-9 beside a window's 1.2e-7 on one H100 run)
    order = (False, True, False, True, False, False)
    runs = []
    for use_window in order:
        restore(torch, step, snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if use_window:
            losses = step.scan_steps(API_K, *stacked)
        else:
            losses = torch.stack([step(*batch) for _ in range(API_K)])
        torch.cuda.synchronize()
        runs.append(([float(x) for x in losses], time.perf_counter() - t0,
                     snapshot(step)))
    calls = [i for i, w in enumerate(order) if not w][1:]
    spreads = [snapshot_diff(torch, runs[0][2], runs[i][2]) for i in calls]
    repeat = (max(d for d, _ in spreads), all(ok for _, ok in spreads))
    # each step's repeat loss farthest from the first run's
    far = [max(vals, key=lambda x: abs(x - b)) for b, *vals in
           zip(runs[0][0], *(runs[i][0] for i in calls))]
    how = " / ".join(dict.fromkeys(
        hold_runs("BERT-base window", repeat,
                  snapshot_diff(torch, runs[0][2], runs[i][2]), runs[0][0],
                  far, runs[i][0])
        for i, w in enumerate(order) if w))
    window = runs[1][0]
    ms_call, ms_window = (runs[2][1] / API_K * 1e3, runs[3][1] / API_K * 1e3)
    print(f"  BERT-base, Lamb + global clip + warmup over polynomial decay: "
          f"scan_steps({API_K}) losses {['%.4f' % x for x in window]} equal "
          f"{API_K} calls' {how}, parameters and slots too (so the dropout "
          f"masks are equal); {ms_call:.1f} ms a step by calls, "
          f"{ms_window:.1f} by a window (smoke numbers, the second of two "
          f"runs each; {card})", flush=True)
    del runs

    zero = make(0.0)                  # snap's weights, zero's own schedule
    zsnap = snap[:3] + (copy.deepcopy(
        zero.optimizer._learning_rate.state_dict()),)
    runs = []
    for skip in (False, True):
        restore(torch, zero, zsnap)
        losses = []
        for i in range(5):
            if skip and i == 1:
                zero.skip_step()
                losses.append(None)
            else:
                losses.append(float(zero(*batch)))
        runs.append(losses)
    if runs[1][2:] != runs[0][2:] or len(set(runs[0])) < 4:
        fail(f"BERT-base at lr 0: losses with a skip {runs[1]} vs without "
             f"{runs[0]} (steps 3-5 must be equal, and the masks must move)")
    print(f"  at lr 0: losses {['%.4f' % x for x in runs[0]]}, with a skip "
          f"at step 2 {['-' if x is None else '%.4f' % x for x in runs[1]]}:"
          " steps 3-5 equal, bit for bit", flush=True)
    del model, step, zero, snap, zsnap
    release(torch)
    return {"window": window, "window_vs_calls": how,
            "lr0": runs[0], "lr0_skip": runs[1],
            "ms_per_step_calls": round(ms_call, 3),
            "ms_per_step_window": round(ms_window, 3)}


def optimizers_on_card(torch, pkg):
    """Phase 26, A4: each of the nine optimizers, and SGD / Momentum
    under ClipGradByNorm / ClipGradByValue, 3 steps of gpt_tiny in f32 on
    the card against a CPU copy. Before each step the CPU side takes the
    card's parameters, slots and gradients, so both updates start from the
    same state and differ only by the card's arithmetic (fused
    multiply-adds, reduction order): parameters and slots within atol
    1e-6 + rtol 1e-5; the losses within rel 1e-5 (phase 7's rule). The
    card's updates run under set_sync_debug_mode("error")."""
    np, GPT = pkg["np"], pkg["GPT"]
    cfg = pkg["gpt_tiny"]()
    ids = pkg["np"].random.RandomState(3).randint(0, cfg.vocab_size, (2, 64))
    rows = []
    for cls, kw, clip in API_OPTIMIZERS:
        card = GPT(cfg, seed=3).train()
        cpu = GPT(cfg, device="cpu", seed=4).train()
        pkg["load"](cpu, {n: p.detach().cpu().numpy()
                          for n, p in card.named_parameters()})
        opts = [getattr(pkg["optim"], cls)(
            parameters=m.named_parameters(), **kw,
            grad_clip=(None if clip is None
                       else getattr(pkg["clip"], clip[0])(clip[1])))
            for m in (card, cpu)]
        worst, worst_loss = 0.0, 0.0
        for _ in range(3):
            losses = []
            for m in (card, cpu):
                x = torch.from_numpy(ids).to(m.device)
                loss = m.loss_fn(m(x), x)
                loss.backward()
                losses.append(loss.item())
            worst_loss = max(worst_loss, abs(losses[0] - losses[1])
                             / abs(losses[1]))
            with torch.no_grad():
                for (n, pc), ph in zip(card.named_parameters(),
                                       cpu.parameters()):
                    ph.copy_(pc.cpu())
                    ph.grad = pc.grad.cpu()
            opts[1]._accumulators = {
                s: {n: t.cpu().clone() for n, t in d.items()}
                for s, d in opts[0]._accumulators.items()}
            opts[1]._step_count = opts[0]._step_count
            torch.cuda.set_sync_debug_mode("error")
            try:
                opts[0].step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            opts[1].step()
            pairs = [(pc, ph) for pc, ph in zip(card.parameters(),
                                                cpu.parameters())]
            pairs += [(opts[0]._accumulators[s][n], t)
                      for s, d in opts[1]._accumulators.items()
                      for n, t in d.items()]
            for a, b in pairs:
                a = a.detach().cpu()
                excess = ((a - b).abs() - 1e-5 * b.abs()).max().item()
                worst = max(worst, excess)
            for m, o in zip((card, cpu), opts):
                o.clear_grad(set_to_zero=False)
        name = cls + ("" if clip is None else f" + {clip[0]}")
        if not (worst <= 1e-6 and worst_loss <= 1e-5):
            fail(f"{name}: card vs CPU max(|diff| - 1e-5 |cpu|) {worst} > "
                 f"1e-6 or loss rel {worst_loss} > 1e-5")
        rows.append(f"{name} {worst:.1e}")
        del card, cpu, opts
    print("  A4 on gpt_tiny f32, 3 steps, card vs CPU from the same state "
          "each step (max |diff| - 1e-5 |cpu| over parameters and slots, "
          "limit 1e-6; updates under set_sync_debug_mode('error')): "
          + ", ".join(rows), flush=True)
    return rows


def training_api(torch, pkg, card):
    """Phase 26: the training API (A5, A4) on the card."""
    print(f"phase 26: the training API: GPT-125M windows (bf16, AdamW "
          f"multi_precision, OneCycleLR, batch {B_SLICE} x {L_SLICE}), "
          f"BERT-base fine-tuning windows (Lamb), the A4 optimizers",
          flush=True)
    release(torch)
    out = gpt_window(torch, pkg, card)
    out["bert"] = bert_window(torch, pkg, card)
    out["optimizers"] = optimizers_on_card(torch, pkg)
    return out


# phase 27: paddle.nn's Transformer at Transformer-base
# (paddle_tpu/nn/layer/transformer.py:276: d_model 512, 8 heads, 6 + 6
# layers, FFN 2048, relu) in user code over the ported nn API: one shared
# embedding over V 32000 (the order of WMT14 en-de's shared BPE
# vocabulary), scaled by sqrt(d_model), plus a sinusoidal position table,
# and an output projection. Trained at 32 x 128 source tokens and 128
# target tokens (the decoder reads the first 127 and predicts the last
# 127), then decoded greedily for 32 tokens through gen_cache. A token of
# the cached decode that differs from the cacheless one (teacher-forced on
# the same prefix, with the causal mask) is a tie only where the
# cacheless top-2 margin is within twice the largest |logit| difference of
# the two decodes, which must itself stay within TB_LOGIT_ATOL: in bf16
# the two run their GEMMs and attention at other shapes, and this phase's
# sound runs read 0.0156 (one bf16 ulp of a logit in [2, 4)); the limit
# is four such ulps. After 6 steps on random tokens the decoder's outputs
# hardly depend on their context (its greedy tokens repeat; on a CPU
# rehearsal a broken cache moved them no more than bf16 rounding does),
# so that check cannot see a broken cache. The cache is held on its own
# first, on the model as built: TB_DECODE random target tokens, teacher
# forced, against the cacheless decoder, the decoder outputs' RMS ratio
# within TB_HIDDEN_RMS (phase 14's bf16 limit), and the same with an
# empty Cache at every step, the check's control, over it.
TB_V, TB_B, TB_S, TB_DECODE, TB_BOS = 32000, 32, 128, 32, 1
TB_D, TB_H, TB_LAYERS, TB_FFN = 512, 8, 6, 2048
TB_STEPS, TB_LR = 5, 1e-3
TB_LOGIT_ATOL = 0.0625
TB_HIDDEN_RMS = RMS_SP_BF16
TB_UNPADDED_LENS = (37, 128, 5, 90)
# phase 3's forward-only rows at one query row against the decode's
# shorter caches (beside its 1 x 32 and 1 x 128 rows)
TB_TAIL_SKS = (1, 7, 31)
# the f32 oracle: 2 + 2 layers at d_model 64, one head (head dim 64: B1's
# 3xTF32 kernels), FFN 256, V 1000, batch 4 x 48 source, 33 target tokens
TB_ORACLE = dict(vocab=1000, d_model=64, nhead=1, num_encoder_layers=2,
                 num_decoder_layers=2, dim_feedforward=256, dropout=0.0)


def seq2seq(torch, nn, vocab, d_model, max_len=2 * TB_S, **kw):
    """User code over the ported paddle.nn API: a shared ``nn.Embedding``
    (N(0, d_model^-1/2) through a ParamAttr) scaled by sqrt(d_model) plus
    a sinusoidal position table (a non-persistable buffer), then
    ``nn.Transformer(d_model, **kw)`` and an ``nn.Linear`` projection to
    the vocabulary, in one ``nn.Layer``."""
    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.d_model = d_model
            self.embedding = nn.Embedding(vocab, d_model, weight_attr=(
                nn.ParamAttr(initializer=nn.initializer.Normal(
                    0.0, d_model ** -0.5))))
            dev = self.embedding.weight.device
            pos = torch.arange(max_len, dtype=torch.float32,
                               device=dev)[:, None]
            div = torch.exp(torch.arange(0, d_model, 2, device=dev).float()
                            * (-math.log(10000.0) / d_model))
            table = torch.zeros(max_len, d_model, device=dev)
            table[:, 0::2] = torch.sin(pos * div)
            table[:, 1::2] = torch.cos(pos * div)
            self.register_buffer("pos_table", table, persistable=False)
            self.transformer = nn.Transformer(d_model, **kw)
            self.dropout = nn.Dropout(kw.get("dropout", 0.1))
            self.project = nn.Linear(d_model, vocab)

        def embed(self, ids, offset=0):
            x = self.embedding(ids) * self.d_model ** 0.5
            return self.dropout(
                x + self.pos_table[offset:offset + ids.shape[1]])

        def forward(self, src, tgt):
            mask = nn.Transformer.generate_square_subsequent_mask(
                tgt.shape[1]).to(src.device)
            return self.project(self.transformer(
                self.embed(src), self.embed(tgt), tgt_mask=mask))
    return Seq2Seq()


def b1_tally(fa, shapes):
    """Count B1's launches by (kind, Sq, Sk) in ``shapes``: the wrappers
    check every launch's shapes through ``fa._check`` first, so this
    wraps that (the launch counters move as ever); returns the
    restore."""
    check = fa._check

    def tally(op, q, k, v):
        out = check(op, q, k, v)
        if op in ("flash_attn_fwd", "flash_attn_bwd"):
            shapes[(op[-3:], q.shape[2], k.shape[2])] += 1
        return out
    fa._check = tally

    def restore():
        fa._check = check
    return restore


def tbase_training(torch, pkg, model, src, tgt_in, labels):
    """Phase 27's training: 1 warm step and TB_STEPS through TrainStep
    (AdamW multi_precision); B1 12 + 12 a step (6 encoder self-attentions
    at 128 x 128 and 6 cross-attentions at 127 x 128, all on the
    tensor-core kernels; the decoder's self-attention carries the causal
    mask and takes the plain masked branch), B2 1 + 1 a step, no plain
    version; one more step profiled. Returns (losses, ms a step, shapes,
    the profiled step's busy share)."""
    F, fa, ce = pkg["F"], pkg["fa"], pkg["ce"]

    def loss_fn(logits, lab):
        return F.cross_entropy(logits.reshape(-1, TB_V), lab.reshape(-1))
    opt = pkg["AdamW"](learning_rate=TB_LR, parameters=model.parameters(),
                       multi_precision=True)
    step = pkg["TrainStep"](model, loss_fn, opt, n_inputs=2)
    losses = [step(src, tgt_in, labels)]          # warm
    torch.cuda.synchronize()
    shapes = collections.Counter()
    reset_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)
    ce.ce_fwd.launches = ce.ce_bwd.launches = 0
    plain, restore_plain = _count_plain([fa, ce])
    restore_tally = b1_tally(fa, shapes)
    try:
        t0 = time.perf_counter()
        for _ in range(TB_STEPS):
            losses.append(step(src, tgt_in, labels))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore_tally()
        restore_plain()
    S, T = src.shape[1], tgt_in.shape[1]
    want = collections.Counter({
        (kind, sq, sk): TB_LAYERS * TB_STEPS
        for kind in ("fwd", "bwd") for sq, sk in ((S, S), (T, S))})
    n = 2 * TB_LAYERS * TB_STEPS
    counts = (fa.flash_attn_fwd.launches, fa.flash_attn_bwd.launches,
              ce.ce_fwd.launches, ce.ce_bwd.launches)
    if shapes != want or counts != (n, n, TB_STEPS, TB_STEPS) or \
            path_counts(fa.flash_attn_fwd, fa.flash_attn_bwd) != (2 * n, 0) \
            or any(plain.values()):
        fail(f"phase 27 training: B1 launches by shape {dict(shapes)} != "
             f"{dict(want)}, launches (B1 fwd, bwd, B2 fwd, bwd) {counts}, "
             f"paths {path_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)}, "
             f"plain calls {plain}")
    vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in vals):
        fail(f"phase 27: non-finite loss in {vals}")
    if not abs(vals[0] - math.log(TB_V)) <= 0.5:
        fail(f"phase 27: first loss {vals[0]} not within 0.5 of "
             f"ln {TB_V} = {math.log(TB_V):.4f}")
    if not vals[-1] < vals[0]:
        fail(f"phase 27: the last loss is not below the first: {vals}")
    prof, prof_wall = profile_window(torch, "Transformer-base step",
                                     lambda: step(src, tgt_in, labels))
    del step, opt
    return vals, wall / TB_STEPS * 1e3, shapes, busy_share(prof, prof_wall)


def pct(share):
    return "not measured" if share is None else f"{100 * share:.1f} %"


def tbase_decode(torch, pkg, model, src, forced=None, fresh=False):
    """Incremental decoding of TB_DECODE tokens: the encoder once, then
    ``decoder.gen_cache(memory)`` (an incremental Cache and a StaticCache
    a layer) and one token a step: greedy, or the tokens ``forced`` [B,
    TB_DECODE] (teacher forcing); ``fresh``: a new, empty cache at every
    step (the cache check's control). Returns (tokens [B, 1 + TB_DECODE]
    with BOS first, the step logits [B, TB_DECODE, V], the decoder's
    outputs [B, TB_DECODE, d_model], memory)."""
    nn = pkg["nn"]
    tr = model.transformer
    with torch.no_grad():
        memory = tr.encoder(model.embed(src))
        cache = tr.decoder.gen_cache(memory)
        if not (isinstance(cache[0][0], nn.MultiHeadAttention.Cache) and
                isinstance(cache[0][1], nn.MultiHeadAttention.StaticCache)
                and len(cache) == TB_LAYERS):
            fail("phase 27: gen_cache gave "
                 f"{[type(c).__name__ for c in cache[0]]} x {len(cache)}")
        ys = torch.full((src.shape[0], 1), TB_BOS, dtype=torch.int64,
                        device=src.device)
        steps, hs = [], []
        for t in range(TB_DECODE):
            if fresh:
                cache = tr.decoder.gen_cache(memory)
            tok = ys[:, -1:] if forced is None else forced[:, t:t + 1]
            h, cache = tr.decoder(model.embed(tok, t), memory, cache=cache)
            lg = model.project(h[:, -1])
            steps.append(lg)
            hs.append(h[:, -1])
            ys = torch.cat([ys, lg.argmax(-1, keepdim=True)], 1)
    return ys, torch.stack(steps, 1), torch.stack(hs, 1), memory


def cacheless(torch, pkg, model, tokens, memory):
    """The decoder over ``tokens`` [B, T] at once with the causal mask:
    (outputs [B, T, d_model], f32 logits [B, T, V])."""
    with torch.no_grad():
        mask = pkg["nn"].Transformer.generate_square_subsequent_mask(
            tokens.shape[1]).to(tokens.device)
        h = model.transformer.decoder(model.embed(tokens), memory, mask)
        return h, model.project(h).float()


def tbase_cache_check(torch, pkg, model, src, forced):
    """The cache's own check, on the model as built (in eval mode) and
    random target tokens: ``forced`` decoded through the cache against
    the cacheless decoder on the same tokens, RMS ratio of the decoder
    outputs within TB_HIDDEN_RMS; and its control, the same with an empty
    Cache at every step, over TB_HIDDEN_RMS. Returns (ratio, control's
    ratio, control's max |logit diff|)."""
    _, lg_c, h_c, memory = tbase_decode(torch, pkg, model, src,
                                        forced=forced)
    _, lg_b, h_b, _ = tbase_decode(torch, pkg, model, src, forced=forced,
                                   fresh=True)
    h_full, lg_full = cacheless(torch, pkg, model, forced, memory)
    ratio, broken = rms_ratio(torch, h_c, h_full), rms_ratio(torch, h_b,
                                                             h_full)
    broken_lg = (lg_b.float() - lg_full).abs().max().item()
    if not ratio <= TB_HIDDEN_RMS < broken:
        fail(f"phase 27: teacher-forced decode through the cache vs "
             f"cacheless: decoder outputs' RMS ratio {ratio} (limit "
             f"{TB_HIDDEN_RMS}); with an empty Cache at every step "
             f"{broken}, which must be over the limit")
    return ratio, broken, broken_lg


def tbase_eval(torch, pkg, model, src):
    """Phase 27's eval: a warm decode, then the counted and timed one (B1
    6 + TB_DECODE x 12 forward launches on the tensor-core kernels: the
    encoder's 6 at 128 x 128, then a step's 6 self-attentions at 1 x t and
    6 cross-attentions at 1 x 128; no plain version), held to the
    cacheless decode on the same prefix (TB_LOGIT_ATOL, ties); one more
    decode profiled. Returns (ms a token, shapes, the largest |logit|
    difference, ties, the profiled decode's busy share, the largest
    cacheless |logit|)."""
    fa, ce = pkg["fa"], pkg["ce"]
    model.eval()
    tbase_decode(torch, pkg, model, src)
    torch.cuda.synchronize()
    shapes = collections.Counter()
    reset_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)
    plain, restore_plain = _count_plain([fa, ce])
    restore_tally = b1_tally(fa, shapes)
    try:
        t0 = time.perf_counter()
        ys, lg_cached, _, memory = tbase_decode(torch, pkg, model, src)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore_tally()
        restore_plain()
    S = src.shape[1]
    want = collections.Counter({("fwd", S, S): TB_LAYERS,
                                ("fwd", 1, S): TB_LAYERS * TB_DECODE})
    for t in range(1, TB_DECODE + 1):
        want[("fwd", 1, t)] += TB_LAYERS
    n = TB_LAYERS + 2 * TB_LAYERS * TB_DECODE
    if shapes != want or fa.flash_attn_fwd.launches != n or \
            fa.flash_attn_bwd.launches or \
            path_counts(fa.flash_attn_fwd, fa.flash_attn_bwd) != (n, 0) or \
            any(plain.values()):
        fail(f"phase 27 decode: B1 launches by shape {dict(shapes)} != "
             f"{dict(want)}, launches {fa.flash_attn_fwd.launches} + "
             f"{fa.flash_attn_bwd.launches}, paths "
             f"{path_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)}, plain "
             f"calls {plain}")
    _, lg_full = cacheless(torch, pkg, model, ys[:, :-1], memory)
    delta = (lg_cached.float() - lg_full).abs().max().item()
    top2 = lg_full.topk(2, -1).values
    margin = top2[..., 0] - top2[..., 1]
    differ = ys[:, 1:] != lg_full.argmax(-1)
    ties = int(differ.sum())
    if not delta <= TB_LOGIT_ATOL:
        fail(f"phase 27: cached vs cacheless logits differ by {delta} > "
             f"{TB_LOGIT_ATOL}")
    if bool((differ & (margin > 2 * delta)).any()):
        fail(f"phase 27: cached tokens differ from the cacheless decode "
             f"beyond ties ({ties} differ; margins "
             f"{margin[differ].tolist()[:8]} vs 2 x {delta:.4f})")
    if ties:
        at = differ.nonzero().tolist()
        steps = sorted(collections.Counter(t for _, t in at).items())
        print(f"  ties at (row, step) {at[:8]}{' ...' if ties > 8 else ''}: "
              f"by step {steps}, cacheless top-2 margins up to "
              f"{margin[differ].max().item():.4f}", flush=True)
    prof, prof_wall = profile_window(
        torch, f"greedy decode of {TB_DECODE} tokens",
        lambda: tbase_decode(torch, pkg, model, src))
    return (wall / TB_DECODE * 1e3, shapes, delta, ties,
            busy_share(prof, prof_wall), lg_full.abs().max().item())


def tbase_state(torch, pkg, model, src, tgt_in, build):
    """save -> load -> set_state_dict into a freshly built model: equal
    logits bit for bit; then astype("float32") on the card and to("cpu"):
    logits on 4 rows within phase 7's rule (max |diff| / max |logit| <=
    1e-4). Returns (file MB, f32 worst ratio)."""
    model.eval()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "transformer_base.pdparams")
        pkg["save"](model.state_dict(), path)
        mb = os.path.getsize(path) / 2**20
        state = pkg["pload"](path)
    fresh = build().astype("bfloat16")
    missing, unexpected = fresh.set_state_dict(state)
    del state
    fresh.eval()
    with torch.no_grad():
        a, b = model(src, tgt_in), fresh(src, tgt_in)
    if missing or unexpected or a.dtype != torch.bfloat16 or \
            not torch.equal(a.view(torch.int16), b.view(torch.int16)):
        fail(f"phase 27: save/load/set_state_dict: missing {missing}, "
             f"unexpected {unexpected}, logits equal "
             f"{torch.equal(a, b)}")
    del fresh, a, b
    model.astype("float32")
    sub_src, sub_tgt = src[:4], tgt_in[:4]
    with torch.no_grad():
        card_lg = model(sub_src, sub_tgt).cpu()
        model.to("cpu")
        cpu_lg = model(sub_src.cpu(), sub_tgt.cpu())
    if model.project.weight.device.type != "cpu" or \
            cpu_lg.dtype != torch.float32:
        fail("phase 27: astype / to('cpu') left the model on "
             f"{model.project.weight.device} in {cpu_lg.dtype}")
    ratio = ((card_lg - cpu_lg).abs().max() / cpu_lg.abs().max()).item()
    if not ratio <= 1e-4:
        fail(f"phase 27: f32 logits card vs CPU: max|diff| / max|logit| "
             f"{ratio} > 1e-4")
    return mb, ratio


def tbase_unpadded(torch, pkg):
    """flash_attn_unpadded on the card over packed ragged lengths,
    causal and not, bf16, 8 heads of 64: against
    scaled_dot_product_attention one sequence at a time (B1, 4 launches
    on the tensor-core kernels) at LIM_BF16. Returns {causal: max err}."""
    F, fa = pkg["F"], pkg["fa"]
    gen = torch.Generator(device="cuda").manual_seed(27)
    lens = TB_UNPADDED_LENS
    cu = torch.tensor([0] + list(itertools.accumulate(lens)),
                      dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn(int(cu[-1]), TB_H, TB_D // TB_H, device="cuda",
                           generator=gen).to(torch.bfloat16)
               for _ in range(3))
    errs = {}
    for causal in (False, True):
        out, none = F.flash_attn_unpadded(q, k, v, cu, cu, max(lens),
                                          max(lens), (TB_D // TB_H) ** -0.5,
                                          causal=causal)
        reset_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)
        per = [F.scaled_dot_product_attention(
            q[s:e][None], k[s:e][None], v[s:e][None], is_causal=causal)[0]
            for s, e in zip(cu[:-1].tolist(), cu[1:].tolist())]
        torch.cuda.synchronize()
        if none is not None or path_counts(fa.flash_attn_fwd,
                                           fa.flash_attn_bwd) != (4, 0):
            fail(f"phase 27 unpadded: second result {none}, B1 paths "
                 f"{path_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)}")
        errs[causal] = check_all(
            torch, f"flash_attn_unpadded lengths {list(lens)} causal="
            f"{causal} vs SDPA a sequence at a time",
            (("out", out, torch.cat(per), LIM_BF16),))["out"]
    return errs


def tbase_oracle(torch, pkg):
    """The small f32 oracle: TB_ORACLE on the card against a CPU copy of
    its weights (set_state_dict), one loss and backward, phase 7's rule
    (loss rel 1e-5, every gradient max|diff| / max|g| 1e-4; a
    k_proj.bias's, zero in exact arithmetic, over its k_proj.weight's
    max|g|); B1 2 + 2 forward and 4 backward on the 3xTF32 kernels, B2
    1 + 1."""
    nn, F, fa, ce, np = pkg["nn"], pkg["F"], pkg["fa"], pkg["ce"], pkg["np"]
    kw = dict(TB_ORACLE)
    vocab = kw.pop("vocab")
    attr = nn.ParamAttr(initializer=nn.initializer.XavierUniform())
    card = seq2seq(torch, nn, vocab, weight_attr=attr, **kw)
    pkg["set_device"]("cpu")
    try:
        cpu = seq2seq(torch, nn, vocab, weight_attr=attr, **kw)
    finally:
        pkg["set_device"](None)
    if {p.device.type for p in card.parameters()} != {"cuda"} or \
            {p.device.type for p in cpu.parameters()} != {"cpu"}:
        fail("phase 27 oracle: the default build is not on the card, or "
             "set_device('cpu')'s not on the CPU")
    if cpu.set_state_dict(card.state_dict()) != ([], []):
        fail("phase 27 oracle: the CPU copy's state dict differs")
    rs = np.random.RandomState(28)
    src = torch.from_numpy(rs.randint(0, vocab, (4, 48)))
    tgt = torch.from_numpy(rs.randint(0, vocab, (4, 33)))
    reset_counts(fa.flash_attn_fwd, fa.flash_attn_bwd)
    ce.ce_fwd.launches = ce.ce_bwd.launches = 0
    losses, grads = [], []
    for m in (card, cpu):
        m.train()
        dev = m.project.weight.device
        lg = m(src.to(dev), tgt[:, :-1].to(dev))
        loss = F.cross_entropy(lg.reshape(-1, vocab),
                               tgt[:, 1:].reshape(-1).to(dev))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in m.named_parameters()})
    paths = {w.__name__: (w.tc_launches, w.simt_launches)
             for w in (fa.flash_attn_fwd, fa.flash_attn_bwd)}
    want = {"flash_attn_fwd": (4, 0), "flash_attn_bwd": (4, 0)}
    if paths != want or (ce.ce_fwd.launches, ce.ce_bwd.launches) != (1, 1):
        fail(f"phase 27 oracle: B1 (tensor-core, SIMT) {paths} != {want} "
             f"or B2 {ce.ce_fwd.launches} + {ce.ce_bwd.launches} != 1 + 1")
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    worst, worst_name = 0.0, ""
    for n, g in grads[1].items():
        # a bias on the keys adds one constant to every logit of a row,
        # which the softmax removes: its gradient is zero but for rounding
        # on both sides, so it is measured against its layer's
        # k_proj.weight gradient, which carries the same dK
        ref = grads[1][n[:-len("bias")] + "weight"] \
            if n.endswith("k_proj.bias") else g
        r = ((grads[0][n].cpu() - g).abs().max()
             / max(ref.abs().max().item(), 1e-30)).item()
        if r > worst:
            worst, worst_name = r, n
    if not (rel <= 1e-5 and worst <= 1e-4):
        fail(f"phase 27 oracle: loss card {losses[0]} cpu {losses[1]} (rel "
             f"{rel:.2e}); worst grad {worst_name} {worst:.2e}")
    return {"loss_rel": rel, "worst_grad": worst, "worst_grad_name":
            worst_name, "params": len(grads[1])}


def transformer_base(torch, pkg, card):
    """Phase 27: paddle.nn's layer system and nn.Transformer at
    Transformer-base on the card (module constants). Returns the numbers
    the summary takes."""
    nn = pkg["nn"]
    print(f"phase 27: paddle.nn.Transformer at Transformer-base (d_model "
          f"{TB_D}, {TB_H} heads, {TB_LAYERS} + {TB_LAYERS} layers, FFN "
          f"{TB_FFN}), shared embedding V {TB_V}, bf16 AdamW "
          f"multi_precision, batch {TB_B} x {TB_S} source x {TB_S} target "
          f"tokens", flush=True)
    release(torch)
    t_phase = time.perf_counter()
    attr = nn.ParamAttr(initializer=nn.initializer.XavierUniform())

    def build():
        return seq2seq(torch, nn, TB_V, TB_D, weight_attr=attr, dropout=0.1,
                       attn_dropout=0.0)
    pkg["seed"](27)
    model = build()                 # nn.Layer builds on the card by default
    if {p.device.type for p in model.parameters()} | \
            {b.device.type for b in model.buffers()} != {"cuda"}:
        fail("phase 27: nn.Layer's default build is not on the card")
    tr = model.transformer
    geo = (tr.d_model, tr.nhead, len(tr.encoder.layers),
           len(tr.decoder.layers),
           tr.encoder.layers[0].linear1.weight.shape[1],
           tr.encoder.layers[0].activation.__name__)
    if geo != (TB_D, TB_H, TB_LAYERS, TB_LAYERS, TB_FFN, "relu"):
        fail(f"phase 27: nn.Transformer's defaults gave {geo}")
    model.astype("bfloat16")
    n_params = sum(p.numel() for p in model.parameters())
    rs = pkg["np"].random.RandomState(27)
    src = torch.from_numpy(rs.randint(2, TB_V, (TB_B, TB_S))).cuda()
    tgt = torch.from_numpy(rs.randint(2, TB_V, (TB_B, TB_S))).cuda()
    tgt_in, labels = tgt[:, :-1], tgt[:, 1:]
    out = {"params": n_params}
    model.eval()
    (out["forced_hidden_rms"], out["broken_cache_hidden_rms"],
     out["broken_cache_logit_delta"]) = tbase_cache_check(
        torch, pkg, model, src, tgt_in[:, :TB_DECODE])
    model.train()
    print(f"  the cache, before training, on {TB_DECODE} random target "
          f"tokens (teacher forced) vs the cacheless decoder: decoder "
          f"outputs' RMS ratio "
          f"{out['forced_hidden_rms']:.2e} (limit {TB_HIDDEN_RMS:.3g}); "
          f"the control, an empty Cache at every step: "
          f"{out['broken_cache_hidden_rms']:.2e} (max |logit diff| "
          f"{out['broken_cache_logit_delta']:.4f})", flush=True)
    losses, out["train_ms_step"], train_shapes, out["train_busy"] = \
        tbase_training(torch, pkg, model, src, tgt_in, labels)
    out["losses"] = losses
    print(f"  training: losses {['%.4f' % x for x in losses]} (warm step "
          f"first; ln {TB_V} = {math.log(TB_V):.4f}); "
          f"{out['train_ms_step']:.2f} ms/step ({TB_STEPS} steps, "
          f"{n_params / 1e6:.1f} M parameters); B1 launches by (kind, Sq, "
          f"Sk) {dict(train_shapes)}, all on the tensor-core kernels; "
          f"B2 1 + 1 a step; no plain version; a profiled step's device "
          f"busy share {pct(out['train_busy'])} ({card})", flush=True)
    (out["decode_ms_token"], dec_shapes, out["logit_delta"], out["ties"],
     out["decode_busy"], out["max_logit"]) = tbase_eval(torch, pkg, model,
                                                        src)
    print(f"  greedy decode of {TB_DECODE} tokens through gen_cache: "
          f"{out['decode_ms_token']:.3f} ms a token (the encoder's pass "
          f"included); B1 forward {sum(dec_shapes.values())} = "
          f"{TB_LAYERS} + {TB_DECODE} x {2 * TB_LAYERS} on the tensor-core "
          f"kernels; vs the cacheless decode: max |logit diff| "
          f"{out['logit_delta']:.4f} (limit {TB_LOGIT_ATOL}; largest "
          f"|logit| {out['max_logit']:.3f}), "
          f"{out['ties']} of {TB_B * TB_DECODE} tokens differ, each a tie; "
          f"a profiled decode's device busy share "
          f"{pct(out['decode_busy'])} ({card})", flush=True)
    out["state_mb"], out["f32_ratio"] = tbase_state(
        torch, pkg, model, src, tgt_in, build)
    print(f"  state: save ({out['state_mb']:.1f} MB) -> load -> "
          f"set_state_dict into a fresh model: logits equal bit for bit; "
          f"astype('float32') and to('cpu'): card vs CPU max|diff| / "
          f"max|logit| {out['f32_ratio']:.2e} (tol 1e-4)", flush=True)
    del model
    release(torch)
    out["unpadded_err"] = tbase_unpadded(torch, pkg)
    out["oracle"] = tbase_oracle(torch, pkg)
    print(f"  f32 oracle (2 + 2 layers, d_model 64): loss rel "
          f"{out['oracle']['loss_rel']:.2e} (tol 1e-5), worst grad "
          f"max|diff|/max|g| {out['oracle']['worst_grad']:.2e} "
          f"({out['oracle']['worst_grad_name']}; tol 1e-4) over "
          f"{out['oracle']['params']} parameters", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 27 took {out['wall_s']:.1f} s", flush=True)
    release(torch)
    return out, train_shapes, dec_shapes


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    try:
        import numpy as np
        from paddle_tpu_torch import distributed as dist
        from paddle_tpu_torch.convert import load_paddle_tpu_params
        from paddle_tpu_torch import jit, seed
        from paddle_tpu_torch.inference import (Config,
                                                ContinuousBatchingEngine,
                                                PredictorServer,
                                                create_predictor)
        from paddle_tpu_torch.kernels import _build
        from paddle_tpu_torch.jit import TrainStep
        from paddle_tpu_torch.kernels import cache_write as cw
        from paddle_tpu_torch.kernels import flash_attention as fa
        from paddle_tpu_torch.kernels import flash_block as fb
        from paddle_tpu_torch.kernels import fused_ce as ce
        from paddle_tpu_torch.kernels import mega_decode as md
        from paddle_tpu_torch.models import (BertForMaskedLM,
                                             BertForSequenceClassification,
                                             ErnieModel, GPTForCausalLM,
                                             LlamaForCausalLM, bert_base,
                                             ernie_3_base, generate,
                                             gpt_125m, gpt_1p3b, gpt_6p7b,
                                             llama_13b)
        from paddle_tpu_torch.models import generation as gm
        from paddle_tpu_torch import optimizer as optim
        from paddle_tpu_torch.framework import random as framework_random
        from paddle_tpu_torch.models import gpt_tiny
        from paddle_tpu_torch.nn import clip as nn_clip
        from paddle_tpu_torch.optimizer import AdamW
        import paddle_tpu_torch
        from paddle_tpu_torch import nn as ptnn
        # the module's name is shadowed by its flash_attention function
        nnfa = importlib.import_module(
            "paddle_tpu_torch.nn.functional.flash_attention")
        # an earlier commit (``--serving`` copied into it) has no obs
        tier = ({"obs": importlib.import_module("paddle_tpu_torch.obs"),
                 "resil": importlib.import_module(
                     "paddle_tpu_torch.distributed.resilience")}
                if importlib.util.find_spec("paddle_tpu_torch.obs") else {})
        if importlib.util.find_spec("paddle_tpu_torch.inference.router"):
            tier["router"] = importlib.import_module(
                "paddle_tpu_torch.inference.router")
    except ImportError as e:
        fail(f"cannot import paddle_tpu_torch (run from the repo root): {e}")
    pkg = {"md": md, "cw": cw, "fa": fa, "fb": fb, "ce": ce, "np": np,
           "dist": dist,
           "generate": generate,
           "Engine": ContinuousBatchingEngine, "Server": PredictorServer,
           "GPT": GPTForCausalLM, "gpt_125m": gpt_125m, "AdamW": AdamW,
           "gpt_1p3b": gpt_1p3b, "gpt_6p7b": gpt_6p7b,
           "Llama": LlamaForCausalLM, "llama_13b": llama_13b,
           "TrainStep": TrainStep, "load": load_paddle_tpu_params,
           "Ernie": ErnieModel, "ernie_3_base": ernie_3_base,
           "BertCls": BertForSequenceClassification,
           "BertMLM": BertForMaskedLM, "bert_base": bert_base, "jit": jit,
           "Config": Config, "create_predictor": create_predictor,
           "seed": seed, "nnfa": nnfa, "build": _build.build,
           "kbuild": _build, "optim": optim, "lr": optim.lr, "clip": nn_clip,
           "random": framework_random, "gpt_tiny": gpt_tiny, "nn": ptnn,
           "F": ptnn.functional, "save": paddle_tpu_torch.save,
           "pload": paddle_tpu_torch.load,
           "set_device": paddle_tpu_torch.set_device, **tier}
    # the flight recorder's and the profiler's files go to a directory of
    # the run's own
    obs_dir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    atexit.register(shutil.rmtree, obs_dir, True)
    os.environ["PADDLE_TPU_OBS_DIR"] = obs_dir
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
    if sorted(per) != sorted(_build.SOURCES) and sys.argv[1:] != ["--serving"]:
        fail(f"build: compiled {sorted(per)}, expected {_build.SOURCES}")
    print(f"  built {len(per)} libraries in {time.perf_counter() - t0:.2f} "
          "s (" + ", ".join(f"{n} {t:.2f} s" for n, t in per.items()) +
          f"; nvcc {_build.NVCC_FLAGS})", flush=True)
    for src, sigs in (("flash_attention_sm90", fa._TC_SIGNATURES),
                      ("flash_attention_sm90_f32", fa._TF32_SIGNATURES)):
        lib = _build.load(src, sigs)
        for kernel, regs, spills in _build.ptxas_report(src):
            name = short_kernel_name(kernel)
            print(f"  ptxas {name}: {regs}; {spills}; dynamic smem "
                  f"{tc_smem(lib, name)} B", flush=True)
    b4_ptxas = {}
    for kernel, regs, spills in _build.ptxas_report("mega_decode"):
        cache = "bf16" if "bfloat16" in kernel else "f32"
        b4_ptxas.setdefault(cache, []).append(
            f"{short_kernel_name(kernel).split('<')[1][:-1]}: "
            f"{regs.split()[0]}" + ("" if spills.startswith(
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                "loads") else f" ({spills})"))
    for cache, rows in b4_ptxas.items():
        print(f"  ptxas mega_decode_kernel, {cache} cache (g, load bytes: "
              f"registers; spills only where there are any): "
              + ", ".join(rows), flush=True)

    cw_ptxas = _build.ptxas_report("cache_write")
    regs = sorted(int(r.split()[0]) for _, r, _ in cw_ptxas)
    spilled = [short_kernel_name(k) for k, _, sp in cw_ptxas
               if not sp.startswith("0 bytes stack frame, 0 bytes spill "
                                    "stores, 0 bytes spill loads")]
    print(f"  ptxas cache_write: {len(cw_ptxas)} kernels, {regs[0]}-"
          f"{regs[-1]} registers; stack or spills in {spilled or 'none'}",
          flush=True)

    if sys.argv[1:] == ["--sp-cards"]:
        if torch.cuda.device_count() < SP:
            fail(f"--sp-cards needs {SP} cards, found "
                 f"{torch.cuda.device_count()}")
        print(f"phase 13 alone: sequence-parallel attention, sp={SP}, one "
              f"shard on each of cuda:0..{SP - 1}", flush=True)
        check_sp_attention(torch, pkg, L_SLICE,
                           [f"cuda:{i}" for i in range(SP)], timing=True)
        print(card, flush=True)
        return
    if sys.argv[1:] == ["--serving"]:
        serving_profiles(torch, pkg, card)
        return

    print("phase 3: kernels vs plain versions", flush=True)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)
    rng_pos = [int(x) for x in rng.integers(16, 16 + 300 + MAX_NEW,
                                            B_SLICE)]
    b4_errs, b4_rows = check_mega_decode(torch, md, flush, rng_pos)
    check_quant(torch, cw)
    b3_rows = check_slot_write(torch, cw, flush, rng_pos)
    kvs_row = check_kv_slot_write(torch, cw, flush, rng_pos)
    b3p_rows = check_paged_write(torch, np, cw, flush)
    kvp_rows = check_kv_paged_write(torch, np, cw, flush, rng_pos)
    b1_errs, b1_rows = check_flash(torch, fa, flush)
    b2_errs, b2_rows = check_ce(torch, ce, flush)
    check_ce_layouts(torch, ce)
    b5_errs, b5_rows = check_flash_block(torch, fb, flush)
    print("  LLaMA-13B's shapes:", flush=True)
    b4l_err, b4l_rows = check_mega_decode_llama(torch, md, flush, rng_pos)
    kvpl_rows = check_kv_paged_write(
        torch, np, cw, flush, rng_pos, NP=LLAMA_NP, nkv=LLAMA_HEADS,
        hd=LLAMA_HD, L=LLAMA_L,
        cases=[c for c in KV_PAGED_CASES if c[0] != "decode edges"],
        kinds=(("bf16", "bf16"),),
        timing=(("bf16", "decode", "bf16"), ("bf16", "admission", "bf16")))
    b1l_errs, b1l_rows = check_flash(
        torch, fa, flush, shape=(4, LLAMA_HEADS, LLAMA_L, LLAMA_HD),
        cases=(("bfloat16", True, 0, 0),), timing=("bfloat16",))
    b2l_errs, b2l_rows = check_ce(torch, ce, flush, V=LLAMA_V,
                                  cases=[(8192, torch.bfloat16, None)],
                                  timing=("bfloat16",))
    check_sampling(torch, np, gm, flush)
    print("  BERT/ERNIE's shapes:", flush=True)
    nc = (("bfloat16", False, 0, 0),)
    b1e_errs, b1e_rows = check_flash(
        torch, fa, flush, shape=(1, BERT_H, ERNIE_S, BERT_HD), cases=nc,
        timing=("bfloat16",), timed_causal=False, kinds=("fwd",), simt=False)
    check_flash(torch, fa, flush, shape=(FT_BATCH, BERT_H, ERNIE_S, BERT_HD),
                cases=nc, timing=("bfloat16",), timed_causal=False,
                simt=False)
    b1f_errs, b1f_rows = check_flash(
        torch, fa, flush, shape=(2, BERT_H, ERNIE_S, BERT_HD),
        cases=(("float32", False, 0, 0),), timing=("float32",),
        timed_causal=False, simt=False)
    b2c_errs, b2c_rows = check_ce(
        torch, ce, flush, V=2, cases=[(FT_BATCH, torch.bfloat16, None),
                                      (FT_BATCH, torch.float32, None)],
        timing_n=FT_BATCH)
    n_mlm = FT_BATCH * ERNIE_S
    b2m_errs, b2m_rows = check_ce(
        torch, ce, flush, V=BERT_V, cases=[(n_mlm, torch.bfloat16, None),
                                           (n_mlm, torch.float32, None)],
        timing_n=n_mlm, ignore_frac=0.25)
    n_mlm20 = 2 * ERNIE_S                 # phase 20's MLM rows
    b2m20_errs, b2m20_rows = check_ce(
        torch, ce, flush, V=BERT_V, cases=[(n_mlm20, torch.bfloat16, None),
                                           (n_mlm20, torch.float32, None)],
        timing_n=n_mlm20, ignore_frac=0.25)
    print("  phase 24's and 25's shapes:", flush=True)
    b4d_err, b4d_row = check_mega_decode_draft(torch, md, flush, rng_pos)
    kvpg_rows = check_kv_paged_write(
        torch, np, cw, flush, rng_pos, NP=DRAFT_NP, nkv=32, hd=128, L=2048,
        cases=[c for c in KV_PAGED_CASES if c[0] != "decode edges"],
        kinds=(("bf16", "bf16"),),
        timing=(("bf16", "verify", "bf16"), ("bf16", "admission", "bf16")))
    b1g_errs, b1g_rows = check_flash(
        torch, fa, flush, shape=(G13_B, 16, G13_S, 128),
        cases=(("bfloat16", True, 0, 0),), timing=("bfloat16",))
    b2g_errs, b2g_rows = check_ce(torch, ce, flush, V=50304,
                                  cases=[(G13_CHUNK, torch.float32, None),
                                         (G13_CHUNK, torch.float32, None,
                                          torch.bfloat16)],
                                  timing=("float32", "float32->bfloat16"),
                                  timing_n=G13_CHUNK)
    print("  phase 27's shapes (Transformer-base, bf16, 8 heads of 64):",
          flush=True)
    nc = (("bfloat16", False, 0, 0),)
    tb_dh = TB_D // TB_H
    b1t_errs, b1t_rows = {}, {}
    # (key, query rows, key rows, kinds): the encoder's self-attention and
    # the decoder's cross-attention in training; at decode the last
    # self-attention (1 x 32) and every cross-attention (1 x 128)
    for key, sq, sk, kinds in (("enc", TB_S, TB_S, ("fwd", "bwd")),
                               ("cross", TB_S - 1, TB_S, ("fwd", "bwd")),
                               ("dec_self", 1, TB_DECODE, ("fwd",)),
                               ("dec_cross", 1, TB_S, ("fwd",))):
        b1t_errs[key], b1t_rows[key] = check_flash(
            torch, fa, flush, shape=(TB_B, TB_H, sq, tb_dh), cases=nc,
            timing=("bfloat16",), timed_causal=False, kinds=kinds,
            simt=False, sk=sk)
    b1t_tails = check_flash_decode_tails(torch, fa, (TB_B, TB_H, tb_dh),
                                         TB_TAIL_SKS)
    tb_n = TB_B * (TB_S - 1)               # phase 27's loss rows
    b2t_errs, b2t_rows = check_ce(torch, ce, flush, V=TB_V,
                                  cases=[(tb_n, torch.bfloat16, None)],
                                  timing=("bfloat16",), timing_n=tb_n)
    del flush
    torch.cuda.empty_cache()

    print("phase 4: serving gpt_125m, bf16 cache", flush=True)
    model = GPTForCausalLM(gpt_125m(), seed=0)        # the card by default
    prompts = serving_prompts(np, model.cfg.vocab_size)
    run4 = serve(torch, pkg, model, "bfloat16", prompts[4], profile=True)
    b4_launches = run4["ticks"] * TICK * LAYERS
    expect_launches(f"phase 4 (mega = {run4['ticks']} ticks x {TICK} x "
                    f"{LAYERS})", run4["counts"],
                    mega_decode_step=b4_launches)

    print("phase 5: serving, f32 cache vs the sequential CPU oracle",
          flush=True)
    run5 = serve(torch, pkg, model, "float32", prompts[5], slots=4)
    expect_launches(f"phase 5 (mega = {run5['ticks']} ticks x {TICK} x "
                    f"{LAYERS})", run5["counts"],
                    mega_decode_step=run5["ticks"] * TICK * LAYERS)
    oracle = GPTForCausalLM(gpt_125m(), device="cpu", seed=1)
    load_paddle_tpu_params(oracle, {n: p.detach().cpu().numpy()
                                    for n, p in model.named_parameters()})
    check_oracle(torch, pkg, oracle, prompts[5], run5["toks"], "f32 serving")

    print("phase 6: serving, int8 cache", flush=True)
    run6 = serve(torch, pkg, model, "int8", prompts[6], profile=True)
    kvs_launches = run6["ticks"] * TICK * LAYERS
    expect_launches(f"phase 6 (kv_slot_write = {run6['ticks']} ticks x "
                    f"{TICK} x {LAYERS} x 1)", run6["counts"],
                    kv_slot_write=kvs_launches)
    del model

    print("phase 7: training parity, f32 gpt_125m on the card vs the CPU",
          flush=True)
    train_parity(torch, pkg)
    torch.cuda.empty_cache()
    print("  then the f32 training step: f32 gpt_125m, AdamW, batch "
          f"{B_SLICE} x seq {L_SLICE}", flush=True)
    _, _, _, f32_paths = train_step(torch, pkg, f32=True)
    torch.cuda.empty_cache()

    print("phase 8: training step, bf16 gpt_125m, AdamW multi_precision, "
          f"batch {B_SLICE} x seq {L_SLICE}", flush=True)
    train_counts, losses8, ms8, _ = train_step(torch, pkg)
    torch.cuda.empty_cache()

    model = GPTForCausalLM(gpt_125m(), seed=0)        # phase 4's weights
    paged = dict(paged=True, page_size=PAGE, prefix_cache=True)
    print("phase 9: paged serving gpt_125m, bf16 pool, shared 256-token "
          "prefix", flush=True)
    run9 = serve(torch, pkg, model, "bfloat16", prompts[9], profile=True,
                 **paged)
    st = run9["stats"]
    if st["pages_total"] != NUM_PAGES:
        fail(f"paged pool holds {st['pages_total']} pages, not {NUM_PAGES}")
    if (st["prefix_hits"], st["prefix_misses"],
            st["prefix_tokens_saved"]) != (7, 1, 7 * 16 * PAGE):
        fail(f"prefix hits/misses/saved {st['prefix_hits']}/"
             f"{st['prefix_misses']}/{st['prefix_tokens_saved']} != 7/1/"
             f"{7 * 16 * PAGE}")
    check_pool(run9)
    kvp_launches = paged_launch_check(run9, "phase 9")
    print(f"  prefix hits {st['prefix_hits']}, tokens saved "
          f"{st['prefix_tokens_saved']}, prefilled {st['prefill_tokens']}; "
          f"pages in use after {st['pages_used']} (= cached prefix), "
          f"allocator clean; slot phase 4 wall {run4['wall']:.3f} s, paged "
          f"{run9['wall']:.3f} s", flush=True)

    print("phase 10: paged serving, f32 pool vs the sequential CPU oracle",
          flush=True)
    run10 = serve(torch, pkg, model, "float32", prompts[10], slots=4,
                  **paged)
    st = run10["stats"]
    want_prefill = sum(len(p) for p in prompts[10][:3]) + 1
    if st["prefix_hits"] != 1 or st["prefill_tokens"] != want_prefill:
        fail(f"COW admission: prefix hits {st['prefix_hits']} != 1 or "
             f"prefilled {st['prefill_tokens']} != {want_prefill}")
    check_pool(run10)
    paged_launch_check(run10, "phase 10")
    check_oracle(torch, pkg, oracle, prompts[10], run10["toks"],
                 "f32 paged serving")

    print("phase 11: paged serving, int8 pool", flush=True)
    run11 = serve(torch, pkg, model, "int8", prompts[11], profile=True,
                  **paged)
    check_pool(run11)
    paged_launch_check(run11, "phase 11")

    print("phase 12: n-gram speculative decoding, spec_k=4, paged f32 pool",
          flush=True)
    run12 = serve(torch, pkg, model, "float32", prompts[12], slots=4,
                  speculative="ngram", spec_k=4, **paged)
    st = run12["stats"]
    check_pool(run12)
    paged_launch_check(run12, "phase 12")
    if not (st["spec_ticks"] > 0 and st["acceptance_rate"] > 0
            and st["accepted_tokens_per_tick"] > 1):
        fail(f"speculative: spec ticks {st['spec_ticks']}, acceptance "
             f"{st['acceptance_rate']}, accepted tokens per tick "
             f"{st['accepted_tokens_per_tick']}")
    print(f"  {st['spec_ticks']} verify ticks of {st['ticks']}; drafted "
          f"{st['tokens_drafted']}, accepted {st['tokens_accepted']} "
          f"(rate {st['acceptance_rate']}), {st['accepted_tokens_per_tick']}"
          " tokens per slot per verify tick", flush=True)
    check_oracle(torch, pkg, oracle, prompts[12], run12["toks"],
                 "speculative paged serving")
    del model, oracle
    serving_summary({6: run6, 9: run9, 11: run11}, card)

    print(f"phase 13: sequence-parallel attention, sp={SP}, B={B_SLICE} "
          f"H={NKV} D={HD}", flush=True)
    sp_paths = check_sp_attention(torch, pkg, L_SLICE, ["cuda:0"] * SP,
                                  timing=True)
    check_sp_attention(torch, pkg, B5_ODD_SL * SP, ["cuda:0"] * SP,
                       timing=False)
    if torch.cuda.device_count() >= SP:
        check_sp_attention(torch, pkg, L_SLICE,
                           [f"cuda:{i}" for i in range(SP)], timing=True)
    torch.cuda.empty_cache()

    print(f"phase 14: training step under sp={SP} (ring attention on B5), "
          f"bf16 gpt_125m, batch {B_SLICE} x seq {L_SLICE}", flush=True)
    sp_counts, losses14, ms14, _ = train_step(torch, pkg, sp=SP)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses14, losses8)]
    if not max(rel) <= LOSS_RTOL_SP:
        fail(f"sp losses {losses14} vs phase 8's {losses8}: max rel "
             f"{max(rel):.3e} > {LOSS_RTOL_SP}")
    print(f"  losses vs phase 8's: max rel {max(rel):.3e} (tol "
          f"{LOSS_RTOL_SP}); {ms14:.1f} ms/step under sp={SP} against phase "
          f"8's {ms8:.1f} ms/step", flush=True)
    torch.cuda.empty_cache()

    llama = llama_serving(torch, pkg)
    llama["train"] = llama_oracle_and_training(torch, pkg)

    ernie = ernie_serving(torch, pkg, card)
    b1_oracle, b2_mlm = bert_oracle(torch, pkg)
    ft_counts, _, _ = bert_finetune(torch, pkg)

    print("phase 22: serving tier: streamed /generate, /cancel, /drain, "
          "/metrics, /admin/trace", flush=True)
    if "obs" not in pkg:
        fail("paddle_tpu_torch.obs is missing")
    tier = serving_tier(torch, pkg, card, run9.get("first_ttft_ms"))

    print("phase 23: the router tier: Router over 2 replica processes of "
          "gpt_125m on the card", flush=True)
    if "router" not in pkg:
        fail("paddle_tpu_torch.inference.router is missing")
    router = router_tier(torch, pkg, card, tier)

    spec = draft_serving(torch, pkg, card)
    g13 = gpt13_training(torch, pkg, card)
    api = training_api(torch, pkg, card)
    tbase, tb_train, tb_dec = transformer_base(torch, pkg, card)

    print("phase 28: summary", flush=True)
    main_b4 = b4_rows[("bf16", "serving-like pos")]
    main_b3 = b3_rows["int8 data"]
    main_b3p = b3p_rows[("bf16 pages", "decode")]
    main_kvp = kvp_rows[("bf16", "decode")]
    cw_src = "paddle_tpu_torch/kernels/csrc/cache_write.cu"
    kernels = [
        {"name": "mega_decode_step", "route": "cuda",
         "source": "paddle_tpu_torch/kernels/csrc/mega_decode.cu",
         "replaces": "paddle_tpu/kernels/mega_decode.py:107",
         "launches": b4_launches,
         "max_abs_err": b4_errs[(torch.float32, torch.bfloat16)],
         "ms": main_b4["ms"], "plain_ms": main_b4["plain_ms"],
         "bound_ms": main_b4["bound_ms"], "bound_by": main_b4["bound_by"],
         "library_ms": main_b4["library_ms"]}]
    # B3: the fused writes the serving paths launch (phases 6 and 9; the
    # f32 pools of phase 23's replicas, their launches read from each
    # replica's /healthz), and the per-plane ones, which no serving path
    # launches any more
    for name, replaces, n, row in (
            ("kv_slot_write", 75, kvs_launches, kvs_row),
            ("kv_paged_write", 171, kvp_launches, main_kvp),
            ("kv_paged_write_f32_tier", 171, router["kv_paged_write"],
             kvp_rows[("f32", "decode")]),
            ("fused_slot_write", 75, run6["counts"]["fused_slot_write"],
             main_b3),
            ("fused_paged_write", 171, run9["counts"]["fused_paged_write"],
             main_b3p)):
        kernels.append({
            "name": name, "route": "cuda", "source": cw_src,
            "replaces": f"paddle_tpu/kernels/cache_write.py:{replaces}",
            "launches": n, "max_abs_err": 0.0, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    b1_main = b1_errs[(torch.bfloat16, True, 0)]
    b1_f32 = b1_errs[(torch.float32, True, 0)]
    b2_main = b2_errs[(8192, torch.bfloat16, None)]
    b1_src = "paddle_tpu/nn/functional/flash_attention.py:134"
    # (name, source, replaces, max error, timing row, launches): bf16 B1 on
    # the wgmma kernels (phase 8), f32 B1 on the 3xTF32 kernels (phase 7's
    # f32 step, their tensor-core launches)
    for name, src, replaces, err, row, n in (
            ("flash_attn_fwd", "flash_attention_sm90.cu", b1_src,
             max(b1_main["out"], b1_main["lse"]), b1_rows[("bf16", "fwd")],
             train_counts["flash_attn_fwd"]),
            ("flash_attn_bwd", "flash_attention_sm90.cu", b1_src,
             max(b1_main["dq"], b1_main["dk"], b1_main["dv"]),
             b1_rows[("bf16", "bwd")], train_counts["flash_attn_bwd"]),
            ("flash_attn_fwd_f32", "flash_attention_sm90_f32.cu", b1_src,
             max(b1_f32["out"], b1_f32["lse"]), b1_rows[("f32", "fwd")],
             f32_paths["flash_attn_fwd"][0]),
            ("flash_attn_bwd_f32", "flash_attention_sm90_f32.cu", b1_src,
             max(b1_f32["dq"], b1_f32["dk"], b1_f32["dv"]),
             b1_rows[("f32", "bwd")], f32_paths["flash_attn_bwd"][0]),
            ("ce_fwd", "fused_ce.cu", "paddle_tpu/kernels/fused_ce.py:172",
             max(b2_main["per"], b2_main["lse"]), b2_rows[("bf16", "fwd")],
             train_counts["ce_fwd"]),
            ("ce_bwd", "fused_ce.cu", "paddle_tpu/kernels/fused_ce.py:210",
             b2_main["dlogits"], b2_rows[("bf16", "bwd")],
             train_counts["ce_bwd"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": n,
            "max_abs_err": err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # B5: bf16 on the wgmma kernels (phase 14's sp step), f32 on the 3xTF32
    # kernels (phase 13's f32 ring and Ulysses calls on one card, their
    # tensor-core launches)
    for name, kind, replaces in (
            ("flash_block_attention", "fwd",
             "paddle_tpu/kernels/flash_block.py:348"),
            ("flash_block_attention_bwd", "bwd",
             "paddle_tpu/kernels/flash_block.py:386")):
        for label, src, n in (
                ("bf16", "flash_attention_sm90.cu",
                 sp_counts[f"flash_block_{kind}"]),
                ("f32", "flash_attention_sm90_f32.cu",
                 sum(sp_paths[(torch.float32, op)][f"flash_block_{kind}"][0]
                     for op in ("ring", "ulysses")))):
            row = b5_rows[(label, "past", kind)]
            err = b5_errs[(label, "past")]
            kernels.append({
                "name": name + ("" if label == "bf16" else "_f32"),
                "route": "cuda",
                "source": f"paddle_tpu_torch/kernels/csrc/{src}",
                "replaces": replaces, "launches": n,
                "max_abs_err": max(err["out"], err["lse"]) if kind == "fwd"
                else max(err["dq"], err["dk"], err["dv"]),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]})
    # LLaMA-13B's shapes: B4 and kv_paged_write of phases 15 and 16, B1
    # bf16 at D 128 and B2 at V 32000 of phase 18's 4-layer step
    counts18 = llama["train"][0]
    b1l, b2l = b1l_errs[(torch.bfloat16, True, 0)], \
        b2l_errs[(8192, torch.bfloat16, None)]
    for name, src, replaces, n, err, row in (
            ("mega_decode_step_llama13b", "mega_decode.cu",
             "paddle_tpu/kernels/mega_decode.py:107", llama["b4"], b4l_err,
             b4l_rows["serving-like pos"]),
            ("kv_paged_write_llama13b", "cache_write.cu",
             "paddle_tpu/kernels/cache_write.py:171", llama["kvp"], 0.0,
             kvpl_rows[("bf16", "decode")]),
            ("flash_attn_fwd_d128", "flash_attention_sm90.cu", b1_src,
             counts18["flash_attn_fwd"], max(b1l["out"], b1l["lse"]),
             b1l_rows[("bf16", "fwd")]),
            ("flash_attn_bwd_d128", "flash_attention_sm90.cu", b1_src,
             counts18["flash_attn_bwd"],
             max(b1l["dq"], b1l["dk"], b1l["dv"]), b1l_rows[("bf16", "bwd")]),
            ("ce_fwd_v32000", "fused_ce.cu",
             "paddle_tpu/kernels/fused_ce.py:172", counts18["ce_fwd"],
             max(b2l["per"], b2l["lse"]), b2l_rows[("bf16", "fwd")]),
            ("ce_bwd_v32000", "fused_ce.cu",
             "paddle_tpu/kernels/fused_ce.py:210", counts18["ce_bwd"],
             b2l["dlogits"], b2l_rows[("bf16", "bwd")])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    # BERT/ERNIE's shapes: B1 non-causal bf16 at batch 1 x 128 (phase 19's
    # serving launches), f32 at 2 x 128 (phase 20's oracle), B2 at V 2
    # (phase 21's fine-tuning steps) and at V 30522: phase 20's MLM at its
    # N 256 (its launches), and N 4096 (fine-tuning's 32 x 128, which no
    # phase runs through the MLM head: no launches)
    b1e, b1f = b1e_errs[(torch.bfloat16, False, 0)], \
        b1f_errs[(torch.float32, False, 0)]
    b2c, b2m = b2c_errs[(FT_BATCH, torch.bfloat16, None)], \
        b2m_errs[(n_mlm, torch.float32, None)]
    b2m20 = b2m20_errs[(n_mlm20, torch.float32, None)]
    for name, src, replaces, n, err, row in (
            ("flash_attn_fwd_noncausal_s128", "flash_attention_sm90.cu",
             b1_src, ernie["b1"], max(b1e["out"], b1e["lse"]),
             b1e_rows[("bf16", "fwd")]),
            ("flash_attn_fwd_f32_noncausal_s128",
             "flash_attention_sm90_f32.cu", b1_src,
             b1_oracle["flash_attn_fwd"][0], max(b1f["out"], b1f["lse"]),
             b1f_rows[("f32", "fwd")]),
            ("flash_attn_bwd_f32_noncausal_s128",
             "flash_attention_sm90_f32.cu", b1_src,
             b1_oracle["flash_attn_bwd"][0],
             max(b1f["dq"], b1f["dk"], b1f["dv"]), b1f_rows[("f32", "bwd")]),
            ("ce_fwd_v2", "fused_ce.cu", "paddle_tpu/kernels/fused_ce.py:172",
             ft_counts["ce_fwd"], max(b2c["per"], b2c["lse"]),
             b2c_rows[("bf16", "fwd")]),
            ("ce_bwd_v2", "fused_ce.cu", "paddle_tpu/kernels/fused_ce.py:210",
             ft_counts["ce_bwd"], b2c["dlogits"], b2c_rows[("bf16", "bwd")]),
            ("ce_fwd_v30522", "fused_ce.cu",
             "paddle_tpu/kernels/fused_ce.py:172", 0,
             max(b2m["per"], b2m["lse"]), b2m_rows[("f32", "fwd")]),
            ("ce_bwd_v30522", "fused_ce.cu",
             "paddle_tpu/kernels/fused_ce.py:210", 0,
             b2m["dlogits"], b2m_rows[("f32", "bwd")]),
            ("ce_fwd_v30522_n256", "fused_ce.cu",
             "paddle_tpu/kernels/fused_ce.py:172", b2_mlm[0],
             max(b2m20["per"], b2m20["lse"]), b2m20_rows[("f32", "fwd")]),
            ("ce_bwd_v30522_n256", "fused_ce.cu",
             "paddle_tpu/kernels/fused_ce.py:210", b2_mlm[1],
             b2m20["dlogits"], b2m20_rows[("f32", "bwd")])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    # phase 24's and 25's shapes: B4 at the draft's f32 steps and
    # kv_paged_write into GPT-6.7B's pool (phase 24's launches), B1 at
    # GPT-1.3B's D 128 and B2 on one f32 loss chunk, its backward to bf16
    # dlogits (phase 25's features-on run; its backward to f32 dlogits,
    # which phase 25 no longer launches, beside it)
    b1g, b2g = b1g_errs[(torch.bfloat16, True, 0)], \
        b2g_errs[(G13_CHUNK, torch.float32, None)]
    b2gh = b2g_errs[(G13_CHUNK, torch.float32, None, torch.bfloat16)]
    for name, src, replaces, n, err, row in (
            ("mega_decode_step_draft125m", "mega_decode.cu",
             "paddle_tpu/kernels/mega_decode.py:107", spec["b4"], b4d_err,
             b4d_row),
            ("kv_paged_write_gpt6p7b", "cache_write.cu",
             "paddle_tpu/kernels/cache_write.py:171", spec["kvp"], 0.0,
             kvpg_rows[("bf16", "verify")]),
            ("flash_attn_fwd_gpt1p3b", "flash_attention_sm90.cu", b1_src,
             g13["counts"]["flash_attn_fwd"], max(b1g["out"], b1g["lse"]),
             b1g_rows[("bf16", "fwd")]),
            ("flash_attn_bwd_gpt1p3b", "flash_attention_sm90.cu", b1_src,
             g13["counts"]["flash_attn_bwd"],
             max(b1g["dq"], b1g["dk"], b1g["dv"]), b1g_rows[("bf16", "bwd")]),
            ("ce_fwd_chunk2048_f32", "fused_ce.cu",
             "paddle_tpu/kernels/fused_ce.py:172", g13["counts"]["ce_fwd"],
             max(b2g["per"], b2g["lse"]), b2g_rows[("f32", "fwd")]),
            ("ce_bwd_chunk2048_f32", "fused_ce.cu",
             "paddle_tpu/kernels/fused_ce.py:210", 0, b2g["dlogits"],
             b2g_rows[("f32", "bwd")]),
            ("ce_bwd_chunk2048_f32_to_bf16", "fused_ce.cu",
             "paddle_tpu/kernels/fused_ce.py:210", g13["counts"]["ce_bwd"],
             b2gh["dlogits"], b2g_rows[("f32->bf16", "bwd")])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    # phase 27's shapes: B1 at Transformer-base's encoder self-attention
    # and cross-attention (training, and the encoder's pass at decode),
    # its decode steps (the self-attention row timed at 1 x 32, launched
    # at 1 x 1..32, its error the largest of 1 x 32 and the forward-only
    # tails at 1 x TB_TAIL_SKS; every cross-attention at 1 x 128), and B2
    # on its loss
    for name, key, kind, n in (
            ("flash_attn_fwd_tbase_enc", "enc", "fwd",
             tb_train[("fwd", TB_S, TB_S)]
             + tb_dec[("fwd", TB_S, TB_S)]),
            ("flash_attn_bwd_tbase_enc", "enc", "bwd",
             tb_train[("bwd", TB_S, TB_S)]),
            ("flash_attn_fwd_tbase_cross", "cross", "fwd",
             tb_train[("fwd", TB_S - 1, TB_S)]),
            ("flash_attn_bwd_tbase_cross", "cross", "bwd",
             tb_train[("bwd", TB_S - 1, TB_S)]),
            ("flash_attn_fwd_tbase_decode_self", "dec_self", "fwd",
             sum(c for (k, sq, sk), c in tb_dec.items()
                 if k == "fwd" and sq == 1 and sk <= TB_DECODE)),
            ("flash_attn_fwd_tbase_decode_cross", "dec_cross", "fwd",
             tb_dec[("fwd", 1, TB_S)])):
        err = dict(b1t_errs[key][(torch.bfloat16, False, 0)])
        if key == "dec_self":            # and the shorter caches' tails
            err["out"] = max([err["out"]] + list(b1t_tails.values()))
        row = b1t_rows[key][("bf16", kind)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/"
                      "flash_attention_sm90.cu",
            "replaces": b1_src, "launches": n,
            "max_abs_err": max(err["out"], err["lse"]) if kind == "fwd"
            else max(err["dq"], err["dk"], err["dv"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    b2t = b2t_errs[(tb_n, torch.bfloat16, None)]
    for name, kind, replaces, err in (
            ("ce_fwd_tbase_v32000", "fwd", 172, max(b2t["per"], b2t["lse"])),
            ("ce_bwd_tbase_v32000", "bwd", 210, b2t["dlogits"])):
        row = b2t_rows[("bf16", kind)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/fused_ce.cu",
            "replaces": f"paddle_tpu/kernels/fused_ce.py:{replaces}",
            "launches": TB_STEPS, "max_abs_err": err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    serving_summary({15: llama["serve15"], 16: llama["serve16"]}, card)
    print(f"  ERNIE-3.0-base Predictor.run latency, batch 1 x {ERNIE_S}: p50 "
          f"{ernie['p50']:.3f} ms, p99 {ernie['p99']:.3f} ms ({card})",
          flush=True)
    print("  serving tier: " + json.dumps(tier) + f" ({card})", flush=True)
    print("  router tier: " + json.dumps(router) + f" ({card})", flush=True)
    print("  draft speculation: " + json.dumps(spec) + f" ({card})",
          flush=True)
    print("  GPT-1.3B memory features: " + json.dumps(g13) + f" ({card})",
          flush=True)
    print("  training API: " + json.dumps(api) + f" ({card})", flush=True)
    print("  Transformer-base: " + json.dumps(tbase) + f" ({card})",
          flush=True)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
