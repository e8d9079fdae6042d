#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (skypilot_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal (nonzero exit, no result line) when it fails:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the flash kernels from csrc/ into build/ (one
   process per source, all at once) and reports ptxas's registers and
   spills per kernel, and each Hopper kernel's launch registers, shared
   memory, threads and setmaxnreg split; cuobjdump -sass must find HGMMA
   (wgmma) and UTMALDG (TMA load) instructions, and fewer wgmma waits than
   wgmmas, in every instance (head_dim 64, 128, 256, 512 and 2048, the
   one instance of the widths past 512; bf16 and f16) of
   the nine Hopper kernels (flash_fwd, flash_dq, flash_dkv, flash_fwd_tri,
   flash_dq_tri, flash_dkv_tri, flash_fwd_streamed, flash_dq_streamed,
   flash_dkv_streamed), and FFMA and no HMMA or HGMMA in every instance of
   the fp32 forward, dq and dk/dv and in their wide bodies past 512 (exact
   fp32), which ptxas must build without spills;
3. kernels: each kernel of the three families against its plain PyTorch
   version on the card in bf16 (the resident family at its training
   shape and four others, causal and not, two with ragged S; the
   triangular family at five causal shapes past the resident budget, two
   with S not a multiple of 128; the streamed family at four non-causal
   shapes past it, one ragged, and one causal), and in f16 at each
   family's main shape; each family's backward pair run twice on the same
   inputs at its main shape must give bit-identical dq, dk and dv; then,
   at each family's main shape, its time in bf16 and f16, the plain
   version's, the library call's (scaled_dot_product_attention, a
   yardstick the port never calls), the bound, and, for the triangular
   and streamed families, the resident kernels' time at the same shape;
   the streamed forward (the Hopper forward with the overlapped schedule)
   and the streamed dq (the Hopper dq, Q and dO in registers, exp2) are
   also timed at the resident and triangular main shapes, in turns beside
   flash_fwd and flash_fwd_tri, flash_dq and flash_dq_tri (the dq checked
   against the family's own there); nvidia-smi samples the SM clock and
   power every 100 ms, and each kernel time is printed beside their
   medians over its timing; at seq 32768, where no full plain version
   fits, the streamed kernels against the resident kernels, both timed,
   and against the plain versions on the first and last 512 q rows (o,
   lse, dq) and KV rows (dk, dv) of every head, the plain lse and delta
   for the latter built in q chunks; then the three families at head_dim
   256 ([kernels d256]: the resident trio at Gemma-2B's 8 x 2048 MQA
   shape, a ragged non-causal S and Gemma-7B's MHA at S = 200, and its
   backward pair past the budget at a ragged causal S = 4136 and at
   4160 non-causal; the triangular trio at Gemma-2B's 1 x 8192,
   Gemma-7B's MHA at 4096, and S = 4136 and 4160; the streamed trio
   non-causal at 1 x 4096 and 4136; each launch's items, P and shared
   memory printed, P being the parts of the GQA group every width-256
   dk/dv splits across CTAs, and the resident dq's CTA shape) against
   the plain versions, at each family's first shape the pair
   bit-identical twice, f16 and times, and the resident pair's time
   beside SDPA's whole backward); then at head_dim 512 ([kernels d512]:
   the cluster bodies, two CTAs an item, each its 256-column chunk of
   every operand, exchanging fp32 partials; the resident trio at 8 x 1024, Gemma-7B's MHA at S = 200
   and an odd GQA group (6) at a ragged non-causal S = 1000; the
   triangular at 1 x 8192, 4136 and 4160 (GQA 6); the streamed
   non-causal at 1 x 4096, 4136 (MHA) and 4160) against the plain
   versions, one launch of each kernel a trio, at each main shape the
   pair bit-identical twice, f16, times and SDPA's time with the backend
   it picked (the only one that takes 512 with GQA is MATH); then past
   head_dim 512 ([kernels dxwide]: the cluster bodies of width / 256
   CTAs an item, one instance for every width, each CTA's partials read
   by every rank in rank order; at width 1024 the resident trio at 8 x
   512, the triangular at 1 x 8192 and the streamed non-causal at 1 x
   4096; at 768 ragged S 200, 1000 and 4136, S 4160, MHA and a GQA group
   of 6; at 2048 one shape a family) against the plain versions, one
   launch of each kernel a trio, the pair bit-identical twice at every
   shape, at each main shape f16, times and SDPA's time with its backend,
   and the trio's time at the main shape's batch, S and heads at widths
   768 and 2048;
   then the public attention op through autograd, with exactly one
   launch of each kernel of its family: at a ragged S (200) against the
   plain versions; at head_dim 16, 96 and 192 (zero-padded to the
   kernels' 64, 128 and 256; 192 at S 384 and, triangular, at 4096, where
   the padded columns of the kernels' outputs must be exactly 0) against
   the plain versions at that head_dim; at width 256 past the resident
   budget ([wide op]) the triangular trio causal and the streamed trio
   non-causal against the plain versions, then head_dim 264 and 448
   (resident), 320 (triangular), 392 (streamed) and 512 (all three)
   zero-padded to the width-512 kernels, one launch of each kernel of
   the family, against the plain versions at the caller's head_dim, the
   padded columns of the kernels' outputs exactly 0, the same for head_dim
   520 (triangular) and 640 (resident) at width 768, 1000 (resident and
   streamed) at 1024, 1536 (triangular) and 2048 (resident), and head_dim
   2056 a ValueError naming it before any launch; and with f32 inputs (2 x 256,
   4 heads, 2 KV heads, head_dim 64, causal and not; 1 x 200 at head_dim
   128; 1 x 2048 and 1 x 4096 at head_dim 256, 8 heads over 1; 1 x 1024
   at 512, causal and not; 1 x 1000 at 1024, 6 heads over 2; then at
   each width 64-512, both causal flags,
   ragged S 1000 with 6 heads over 2, ragged S 4136 MHA and S 4160 with 6
   heads over 2), through the fp32 kernels (one launch each; the dk/dv's
   GQA parts printed, at least one case past one part), against the fp32
   plain versions at the JAX reference tests' elementwise bounds (and,
   printed, not held, the first seven cases as f16 through the f16
   kernels), the fp32 forward and the fp32 backward pair each run twice
   bit-identical, then the fp32 kernels' time at the slice's shape and
   at widths 256, 512 and 1024,
   beside their bound at the card's fp32 peak (each kernel's share of
   it), the plain versions' and SDPA's in f32 (forward, whole backward;
   the fp32 pair's ratio to SDPA's backward);
4. streamed: the public attention op, non-causal, at Llama-3-8B
   attention width and seq 8192 (1 x 8192, 32 heads, 8 KV heads,
   head_dim 128), forward and autograd backward of a fixed dO; output
   and gradients against the plain versions, launch counts exactly 1/1/1
   streamed and no other;
5. slice: the Llama-3-8B-width training step (4 layers, batch 2 x seq
   2048, adamw, full remat) takes 8 steps on one repeated batch through
   the port's entry points; the loss must fall and the launch counts must
   show every step went through the three resident kernels (2L/L/L);
   one forward's loss through the kernels must match the reference
   attention's;
5b. parallel: distributed.initialize_from_env() on the machine's env
   must give the single-process context, and make_mesh of dp, fsdp, sp
   and tp at 1 a world-1 NCCL group (backend and world size printed);
   the slice's configuration and seed then take 8 steps through
   make_train_step(..., mesh=, rules=DEFAULT_RULES), the state placed
   by state_shardings and place_state, beside the one-device step from
   a copy of the same weights: losses finite and falling, each within
   LOSS_TOL of the one-device step's, launches exactly the slice's
   (2L/L/L resident); prints the largest parameter difference and both
   median step times; attention_impl="ring" at sp 1 (one forward on the
   trained weights: L resident forward launches, loss within LOSS_TOL of
   "auto"'s) and forward_pipelined at 2 microbatches against forward
   (PIPE_REL_TOL); then the ring's chunk arithmetic
   (ring_attention.ring_chunks) at Llama-3-8B's attention shape (1 x
   8192, 32 heads, 8 KV heads, head_dim 128) in 4 chunks, causal and
   not, output and gradients against the flash op (triangular causal,
   streamed not) within OUT_REL_TOL / GRAD_REL_TOL, both timed;
6. long context: the same width at batch 1 x seq 8192, remat policy
   save_flash_offload_qkv, chunked cross entropy through
   make_train_step(trunk_fn=..., head_fn=...), 8 steps; the loss must
   fall, the launch counts must be exactly L/L/L triangular and no
   other per step, and one forward's loss through the kernels must match
   the reference attention's;
6b. parallel_tp: the sharded step's meshes and policies past world 1,
   two processes of this script (``chip_smoke.py ptp-rank``) sharing
   cuda:0 over a gloo group (NCCL refuses two ranks on one device), each
   leg PTP_STEPS adamw steps from its reference's seed: (a) [long]'s
   configuration (save_flash_offload_qkv, chunked CE, 1 x 8192) on
   {tp: 2}, the triangular trio at 16 query and 4 KV heads a rank; (b)
   [slice]'s (2 x 2048) on {tp: 2} with rank-8 adapters on wq, wk, wv
   and wo (the LoRA recipe's targets; only they train), remat
   save_flash, the resident trio; (c) (a)'s model on {sp: 2},
   attention_impl="kernel", full remat: each rank's embedding, norms,
   projections, MLP and loss on 4096 tokens, the attention gathered to
   all 8192 (the triangular trio at 32 and 8 heads). The tp legs keep the
   vocabulary whole on every rank (PTP_RULES): gloo on CUDA tensors
   cannot take DTensor's all-gather of a shard. Each leg's losses within
   LOSS_TOL of the one-device step's ([long]'s first PTP_STEPS for (a)
   and (c); for (b) a one-device run here, its first-step adapter
   gradients within GRAD_REL_TOL norm-relative and its final adapters
   within LOSS_TOL); exactly one forward, one dq and one dk/dv launch per
   layer, step and rank under save_flash*, two forwards under full
   remat, and no other kernel, on both ranks; the step ms printed. (d)
   an adafactor state placed onto a world-1 NCCL mesh after one
   one-device step, two steps more, within LOSS_TOL of three one-device
   steps (the pipeline part of (d), {pp: n} alone under adafactor, runs
   in tools/torch_parallel_cards.py pipe: gloo's send/recv of CUDA
   tensors kills the process);
7. tiny: LlamaConfig.tiny() (head_dim 16) takes 8 steps in bf16 and in
   f32 (batch 4 x seq 256, full remat): the loss must fall and the launch
   counts must be 2L/L/L, resident in bf16, fp32 kernels in f32;
8. adafactor: bench.py's 8B-shape leg at its largest candidate (Llama-3-8B
   layer geometry, vocab 32768, 8 layers), batch 8 x seq 2048,
   TrainConfig(optimizer="adafactor"), full remat, 8 steps on one batch:
   the loss must fall, launches exactly 2L/L/L resident and no other, one
   forward's loss within LOSS_TOL of the reference attention's; prints the
   step, tokens/s, model TFLOP/s, the optimizer's time per step (CUDA
   events) beside adamw's on the same parameters, and peak memory;
9. lora: the LoRA recipe (recipes.llama_lora.main) at Llama-3-8B, full
   width and depth, batch 8 x seq 2048 (examples/llama31_lora.yaml), three
   runs: A 4 steps saving every 2, B 2 steps into a fresh directory, B'
   resuming B to step 4; B' must report resumed_from 2, its step-4
   checkpoint must equal A's byte for byte (adapters, optimizer state,
   step, data position, RNG state), launches exactly 2L/L/L resident per
   step over the 8 steps and no other, and A's trained adapters must
   lower the loss on A's first batch below its step-1 loss; prints the
   wall time per step of B' and peak memory. A runs with the training
   telemetry armed (observability/trainstats, a timed synchronize after
   each step): its train_mfu must be a number in (0, 1], the card's
   trainstats.PEAK_FLOPS entry its data-sheet peak (989e12 for the H100
   80GB HBM3, written in this script), the live MFU gauge equal to the
   tokens/s gauge x flops_per_token(2048) / that peak within 1e-6, the
   train_* keys those gauges rounded, the ring's tokens/s at least 0.95x
   the recipe's wall rate, the goodput fractions the ring records' sums
   over its window with the loop's untracked share under UNTRACKED_MAX,
   snapshot.json and the host JSONL written; the stpu_ckpt_* counters
   over A, B and B' must read 4 saves, 1 restore and 2 restores that
   found nothing; prints train_mfu, goodput and dispatch vs device ms;
10. mixtral: Mixtral-8x7B widths (8 experts, top 2), depth cut to 2,
   batch 2 x seq 2048, adafactor, full remat, 6 steps on one batch: CE +
   aux must fall, the aux loss be finite and positive, launches exactly
   2L/L/L resident and no other, one forward's loss within LOSS_TOL of the
   reference attention's; prints the step and the share of token choices
   dropped by capacity at step 1;
10b. mixtral_ep: the expert-parallel recipe (recipes/mixtral_ep.run) at
   [mixtral]'s configuration with its adamw (warmup 100) on a world-1
   NCCL mesh {dp 1, ep 1}, MXEP_STEPS of its batches, with trainstats
   armed, against the one-device make_train_step from the same weights on
   the same batches: every step's CE and the final aux within LOSS_TOL,
   the parameters within LOSS_TOL, launches exactly 2L/L/L resident;
   prints the step, tokens/s and train_mfu;
10c. recipes: resnet_ddp at resnet101, 224 x 224, batch 32, one process
   (examples/s, p50 iteration, the loss finite; cuDNN TF32 printed);
   mnist for 300 steps under the benchmark recorder (accuracy >= 0.8,
   benchmark_summary.json written under STPU_BENCHMARK_LOG_DIR with 300
   steps); glue_imdb for 200 steps (accuracy >= 0.75);
11. serve: one Llama-3-8B replica (full width and depth, bf16, random
   weights) through the port's serve_llm.serve in-process, 8 engine
   slots, paged 64-token blocks, max_seq 1280: eight concurrent streamed
   /generate requests (prompts 32 to 1024 tokens, 64 tokens each, four
   greedy, four seeded at T=0.8), then a ninth sharing a 512-token
   prefix with the longest. Every stream must end in its stats frame and
   [DONE] after 64 tokens, the ninth must hit the prefix cache, and no
   flash kernel may launch during the engine's work (serving attention
   is the split-KV torch path, as it is XLA in the JAX package). The
   greedy streams are teacher-forced through llama.forward (one resident
   forward launch per layer and stream) and through the engine's dense
   and paged cache paths (its prefill chunks, then batched T = 1 steps):
   paged == dense bit for bit, logits within 3.5e-2 norm-relative, two
   planted faults (a query's own key masked; positions one late) past
   it, and every emitted token the forward's argmax but at near-ties
   (gap within twice the two paths' largest logit difference, printed).
   Then the same requests with int8
   weights and int8 KV (printed, not gated: its numbers and the share of
   greedy tokens equal to the bf16 leg's). Prints TTFT and tokens/s per
   request, aggregate tokens/s, decode-step ms by live slots and ms per
   64-token prefill chunk (stepstats), peak memory and the weight-read
   bound per decode step, each beside the card's name and power limit.
   Last, in f32 at the 8B width cut to 4 layers with TF32 off: paged ==
   dense == llama.decode, speculative decoding on == off, and a seeded
   stream cut at token 16 and resumed == the uninterrupted one, where
   two paths may part only at a near-tie (the first divergence's logit
   gap, printed, within 1e-3); the teacher-forced cache paths as above
   within 1e-4 and the planted faults past it; and the host tier: a
   seeded stream whose prefix blocks were spilled to the host (clone,
   then the side stream's D2H) while the next request rewrote them, then
   re-admitted, equal to its cold run;
11b. tp_serve (after serve and its bench legs): the tensor-parallel
   replica (serve/gang_replica.py) at tp 2 on the one card: two processes
   on cuda:0 over a gloo group (NCCL refuses two ranks on one device; gloo
   carries their CUDA tensors), the backend printed. Rank legs (two
   processes of this script, ``chip_smoke.py tp-rank``, each drawing
   [serve]'s seed-5 tree and keeping its shard): (a) [serve]'s greedy
   streams teacher-forced through the model's forward on each rank's 16
   query and 4 KV heads (flash_fwd, L launches a stream per rank) and the
   tp paged cache path, within CACHE_REL_TOL of the one-card forward's
   logits, positions one late (over each stream's first TP_FAULT_TOKENS)
   past it; f32 at 4 layers (the [serve] f32 leg's model and streams):
   the tp cache path within F32_CACHE_REL_TOL and the fault past it, the
   tp engine's streams equal to one card's; (b) int8 weights and KV (the
   tree quantized whole, then sharded): [serve]'s greedy requests for
   TP_INT8_TOKENS tokens against the one-card int8 leg's (printed); (e) Mixtral-8x7B width at TP_MIXTRAL_LAYERS layers, bf16,
   four greedy prompts against one card's engine (printed). Then a
   ``serve_llm --model llama3-8b --tp 2 --device cuda:0 --tp-backend
   gloo`` replica: (a) [serve]'s eight streams and the ninth through its
   /generate, greedy ones parting from one card's only at a near-tie of
   the one-card forward's logits (gap within twice the tp path's largest
   logit difference there), its decode-step ms (/perf) beside [serve]'s;
   (c) its tp rank SIGKILLed mid-stream: 503, the whole-gang restart,
   stpu_gang_restarts_total 1, 200, and a request's tokens equal to its
   run before the kill. (d) decode_bench.measure_engine_tp("llama",
   tp=2) at Llama-3-8B width, TP_BENCH_LAYERS layers, its dict beside
   measure_engine_ragged on the same model and mix on one card;
12. gemma_lora (run after mixtral, before serve): the Gemma LoRA recipe at
   Gemma-2B full width and depth, seq 2048, 4 steps, at the largest of
   batch 8, 7, 6, ... that fits the card (cut printed): launches exactly
   2L/L/L of the width-256 resident kernels per step and no other, the
   trained adapters lower the first batch's loss, one forward's loss
   within LOSS_TOL of the reference attention's; ms a step, tokens/s,
   peak memory; trainstats armed, with [lora] A's readings and checks at
   Gemma-2B's flops_per_token(2048);
13. gemma_long (right after gemma_lora): the same recipe at Gemma-2B's
   own context, seq 8192, full width and depth, 4 steps with a save at
   the last, at the largest of batch 8, 4, 2, 1 that fits (cut printed):
   launches exactly 2L/L/L of the width-256 triangular kernels per step
   and no other, the same loss gates and trainstats readings; ms a step,
   tokens/s, peak memory;
13b. gemma_wide (right after gemma_long): Gemma-2B's widths with head_dim
   512, depth cut to 2 layers, 1 x 8192 through make_train_step as [long]
   (save_flash_offload_qkv, chunked CE), 4 adamw steps: the loss falls,
   launches exactly L/L/L of the width-512 triangular kernels a step and
   no other, one forward's loss within LOSS_TOL of the reference
   attention's; ms a step, tokens/s, peak memory;
13c. gemma_xwide (right after gemma_wide): the same at head_dim 1024, 3
   steps, through the width-1024 triangular clusters (4 CTAs an item);
14. gemma_serve: [serve]'s bf16 leg on a Gemma-2B replica (full width and
   depth, the same nine requests and gates; teacher-forced within
   GEMMA_CACHE_REL_TOL of gemma.forward, whose check launches the
   width-256 forward), then f32 at 4 layers: paged == dense ==
   gemma.decode, the cache paths within F32_CACHE_REL_TOL of
   gemma.forward (through the fp32 kernels at width 256) with three
   planted faults past it (the third: the serving embed without its
   sqrt(dim) multiplier);
15. mixtral_serve: Mixtral-8x7B at full width in three legs. Dense
   routing is discontinuous: where a token's gates nearly tie, bf16
   roundings that differ by GEMM shape flip its second expert, so each
   bf16 reading is taken twice, as served (within the loose
   MIXTRAL_ROUTED_REL_TOL) and with routing pinned to the reference's
   picks (within MIXTRAL_CACHE_REL_TOL, the attention faults and the
   routing faults past it; the flips it pinned and their gate gaps
   printed; leg 1 plants the nearest, own key masked). Leg 1: the int8
   tree at MXS_INT8_LAYERS layers (11.7 GB; the full depth's 46.7 GB runs
   in tools/torch_parallel_cards.py tp_serve), built by serve_llm's
   --model mixtral-8x7b --weight-quant 1 (depth patched) a layer at a time,
   served through serve_llm with [serve]'s geometry and nine requests
   (every stream complete, the ninth a prefix hit, no flash launch in
   the engine); on the greedy streams the batched T = 1 steps against a
   fresh prefill over each whole prefix (the emitted tokens its argmax
   but at near-ties; pinned: paged == dense bit for bit); one decode
   step at 8 slots profiled (launches, device busy, idle share). Leg 2:
   bf16 at MXS_BF16_LAYERS layers: those streams
   teacher-forced through the dense and paged cache paths against
   mixtral.forward at capacity_factor n_experts / top_k (C = T: no token
   dropped, so capacity routing equals dense routing; one sequence at a
   time, flash_fwd per layer); the int8 cache path's (weights and KV)
   top-1 agreement with the bf16 one's at least 0.55. Leg 3: f32 at 4
   layers, TF32 off: paged == dense == mixtral.decode, speculative
   decoding on == off (greedy and seeded, parting only at near-ties), the
   cache paths within F32_CACHE_REL_TOL of the no-drop forward (fp32
   kernels) and both routing faults past it. Prints each leg's seconds;
16. lb: the port's data plane at Llama-3-8B full width and depth, on
   [serve]'s bf16 params (run inside [serve], after its int8 leg), three
   legs on one card with no flash kernel launched. (a) One replica with
   [serve]'s geometry behind the port's load balancer (serve/
   load_balancer.py, PrefixAffinityPolicy): [serve]'s eight requests one
   at a time (LB_BYTES_TOKENS tokens each), through the balancer and
   straight to the replica; the greedy ones' SSE data: frames must be
   equal (the seeded ones' printed), every stream must end in [DONE], and
   the balancer's /metrics must carry the replica's stpu_engine_* and its
   own stpu_lb_* families. (b) The port's load generator through that
   balancer (chat mix, Poisson, LB_QPS for LB_DURATION s, LB_MAX_TOKENS
   tokens, seed 0, a 300 s upstream timeout): every scheduled request
   must complete without error and the scraper must have read the
   balancer's merged metrics; slo_goodput, TTFT p50/p99, tokens/s,
   achieved qps and the schedule's sha printed beside the card (readings,
   not gates). (c) Two replicas on the one param tree (each its own KV
   pool) behind the balancer: a greedy LB_KILL_TOKENS-token stream whose
   prompt the policy routes to A; once LB_KILL_AFTER tokens reached the
   client, A's engine and server are torn down. The stream must complete
   through B in [DONE] with exactly LB_KILL_TOKENS token frames, B must
   have been asked to resume with exactly the tokens the client already
   had (A's, at least LB_KILL_AFTER of them) for the rest of the budget,
   and stpu_lb_stream_resumes_total{outcome="ok"} must rise; whether B's
   tail equals a kill-free stream's is printed, not gated (bf16 prefill
   and decode differ at near-ties). Then, with the 8B weights freed,
   decode_bench's measure_engine_slo and measure_engine_chaos for Llama
   at their default shape, once each, their dicts printed. Prints each
   part's seconds;
17. decode_bench: the port's measure_decode and measure_engine_paged at
   the JAX bench's Mixtral shape (decode_bench.build), once each, their
   dicts printed;
18. tune: the engine sweep (tune/sweep.run_sweep) for Llama's paged mode
   at decode_bench.build("llama")'s shape, quick budgets, 8 slots, on the
   card: each probe's tokens/s, the winner beside the default; the
   manifest must validate, name this card as its device_kind and hold a
   winner that passes check_parity on the card (run again here); read
   back through STPU_TUNE_MANIFEST, resolve_kv_geometry must take the
   winner's chunk, window and the manifest's tag, and a decode_bench
   engine built beside it must keep "manifest": "default". Every other
   phase runs with STPU_TUNE_MANIFEST=0;
19. a summary of the Hopper kernels (registers, shared memory, time
   beside bound and SDPA and the SM clock during it, their step's time);
   the kernels line ({"kernels": [...]}, forty-eight records: the nine
   Hopper kernels at head_dim 128, 256, 512 and 1024 (the last with their
   times at 768 and 2048 under "width_ms"), and the three fp32 kernels at
   each of F32_TIMED_SHAPES, their launches [tiny]'s f32 run's), then the
   last line
   {"ok": true, "device": {...}}.

Each phase's wall seconds are printed as it ends (``[timing]``).
Needs a CUDA card, the CUDA toolkit and this file's checkout (it imports
the port from beside itself). Imports nothing of JAX.
"""
import contextlib
import copy
import ctypes
import dataclasses
import gc
import http.client
import io
import json
import os
import pathlib
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

# H100 SXM dense peaks: bf16 tensor cores and HBM3 (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
# The MFU identity's denominator, by card name, written here from NVIDIA's
# data sheets (dense bf16) and not read from trainstats.PEAK_FLOPS, the
# table under test.
DATASHEET_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": PEAK_BF16_FLOPS,
                        "NVIDIA H100 PCIe": 756e12,
                        "NVIDIA H100 NVL": 835e12}
PEAK_BYTES_PER_S = 3.35e12
# fp32 outside the tensor cores (the same data sheet): the fp32 kernels'
# bound.
PEAK_F32_FLOPS = 67e12
LN2 = 0.6931471805599453

# Kernel vs plain, both on the card from the same bf16 (or f16) inputs.
# The kernel rounds P and dS to the input type before its second product
# and writes that type; the plain version stays fp32 until the final cast.
# Norm-relative error:
OUT_REL_TOL = 1e-2     # o and lse
GRAD_REL_TOL = 2e-2    # dq, dk, dv
# and the largest single error, as a share of the largest |reference|:
MAX_ABS_SHARE = 3e-2
LOSS_TOL = 2e-2        # |loss(kernel) - loss(reference)|, same weights
# The op with f32 inputs (the fp32 kernels) against the fp32 plain
# versions, elementwise |out - ref| <= tol * (1 + |ref|): the JAX reference
# tests' own bounds (tests/test_flash_attention.py).
F32_OUT_TOL = 2e-3
F32_GRAD_TOL = 5e-3

# (B, S, H, KVH, D, causal): the slice's shape (Llama-3-8B attention at
# seq 2048), a non-causal head_dim-64 case, an unequal GQA group (6), and
# two ragged S (a multiple of 8, not of the 64- or 128-row tiles).
MAIN_SHAPE = (2, 2048, 32, 8, 128, True)
CHECK_SHAPES = (MAIN_SHAPE, (2, 1024, 16, 4, 64, False),
                (1, 768, 12, 2, 128, True), (1, 200, 8, 2, 128, True),
                (2, 1000, 16, 4, 64, False))
# The triangular family, causal past the resident budget (S * D >
# 524,288): the long-context shape (Llama-3-8B attention at seq 8192),
# head_dim 64, an unequal GQA group (6) just past the budget, a ragged S
# and an S that is a multiple of 64 but not of the backward's 128-row
# tiles (the second consumer of the last tile has no rows).
TRI_MAIN_SHAPE = (1, 8192, 32, 8, 128, True)
TRI_CHECK_SHAPES = (TRI_MAIN_SHAPE, (1, 16384, 8, 2, 64, True),
                    (1, 4608, 12, 2, 128, True), (1, 4136, 12, 2, 128, True),
                    (1, 4160, 12, 2, 128, True))
# The streamed family, non-causal past the budget (the public op's
# bidirectional use at long context, Llama-3-8B attention width), head_dim
# 64, an unequal GQA group just past the budget, and the causal mode the
# TPU kernels also have. At seq 32768 the plain versions no longer fit:
# there the streamed kernels are held against the resident kernels and,
# on STR_SUBSET_ROWS rows at each end, against the plain versions.
STR_MAIN_SHAPE = (1, 8192, 32, 8, 128, False)
STR_CHECK_SHAPES = (STR_MAIN_SHAPE, (1, 16384, 8, 2, 64, False),
                    (1, 4608, 12, 2, 128, False), (1, 4608, 12, 2, 128, True),
                    (1, 4136, 12, 2, 128, False))
STR_LONG_SHAPE = (1, 32768, 32, 8, 128, False)
STR_SUBSET_ROWS = 512
# q rows a chunk of the plain forward at STR_LONG_SHAPE (its fp32 scores:
# 2 GiB per KV head's group).
STR_PLAIN_CHUNK = 4096
# The public op at a ragged S, through autograd (resident family).
RAGGED_OP_SHAPE = (1, 200, 8, 2, 128, True)
# The public op with f32 inputs: the JAX reference test's _make_qkv shape,
# both causal modes, a ragged S at head_dim 128, and Gemma-2B's attention
# at width 256 within the resident budget and past it.
F32_OP_SHAPES = ((2, 256, 4, 2, 64, True), (2, 256, 4, 2, 64, False),
                 (1, 200, 8, 2, 128, True), (1, 2048, 8, 1, 256, True),
                 (1, 4096, 8, 1, 256, True), (1, 1024, 8, 1, 512, True),
                 (1, 1024, 8, 1, 512, False), (1, 1000, 6, 2, 1024, True))
# The closing set of the fp32 backward (csrc/flash_f32.cu), at each width
# and both causal flags: a ragged S (1000, not a multiple of the 32- or
# 64-row tiles) with an odd GQA group (6 over 2), a ragged S past the
# resident budget with MHA (4136, 4 over 4), and S 4160 (a multiple of 64
# but not of 128) with the odd group. The f16 comparison runs on the
# cases above only.
F32_CLOSING_SHAPES = tuple(
    (1, s, h, kvh, d, causal) for d in (64, 128, 256, 512)
    for s, h, kvh in ((1000, 6, 2), (4136, 4, 4), (4160, 6, 2))
    for causal in (True, False))
# The fp32 kernels timed (with their bound at PEAK_F32_FLOPS, beside the
# plain versions' and SDPA's f32 time): the slice's attention shape, and
# widths 256, 512 and 1024 (the wide kernels).
F32_TIMED_SHAPES = ((2, 2048, 32, 8, 128, True), (1, 4096, 8, 1, 256, True),
                    (1, 1024, 8, 1, 512, True), (1, 1024, 8, 1, 1024, True))
# The public op at head_dims the kernels take only zero-padded: the tiny
# Llama's 16, a 96 and a 192 (to width 256; at S 4096 past the budget,
# through the triangular kernels).
PAD_OP_SHAPES = ((2, 256, 8, 4, 16, True), (1, 384, 8, 2, 96, True),
                 (1, 384, 8, 1, 192, True), (1, 4096, 8, 1, 192, True))
# Width 256 (Gemma's head_dim), each family at its own shapes, the first
# its main one. Resident: Gemma-2B's LoRA shape (examples/gemma_lora.yaml:
# 8 x 2048, 8 heads, MQA), a ragged non-causal S, Gemma-7B's MHA (16/16)
# at a ragged causal S, and an odd GQA group (3). Triangular (causal past
# the budget, S > 2048 at width 256): Gemma-2B at its max_seq_len,
# Gemma-7B's MHA, a ragged S and a multiple of 64 that is not one of 128
# (the second consumer of the last tile has no rows). Streamed: the op's
# non-causal use past the budget, a ragged S, and Gemma-7B's MHA at it.
WIDE_MAIN_SHAPE = (8, 2048, 8, 1, 256, True)
WIDE_CHECK_SHAPES = (WIDE_MAIN_SHAPE, (2, 1000, 8, 1, 256, False),
                     (1, 200, 16, 16, 256, True), (2, 1000, 6, 2, 256, True))
# The resident backward pair at width 256 past the budget (the op sends
# such S to the triangular or streamed family; the kernels take any S): a
# ragged causal S and a multiple of 64 that is not one of 128.
WIDE_PAIR_SHAPES = ((1, 4136, 8, 1, 256, True), (1, 4160, 8, 1, 256, False))
# The resident dq's CTA at width 256 (csrc/flash_bwd_sm90.cuh DqResident)
# and the triangular one's (DqTri).
WIDE_DQ_DESIGN = "DqWide: 128 q rows, 32-row K/V tiles in 3 stages"
TRI_WIDE_DQ_DESIGN = ("DqSplitKV: 128 q rows, 64-row K tiles in 2 stages "
                      "and V in 1 on barriers of their own, warpgroup "
                      "index uniform")
# The forwards' CTA at width 256 (csrc/flash_fwd_sm90.cuh fwd_cta_wide),
# by kernel: the resident one with kWideQReg of S's k steps reading Q
# from registers, the streamed and triangular ones with Q all in shared
# memory. Each builds without spills.
_WIDE_LOCKSTEP = "lockstep, one CTA (no cluster), "
WIDE_FWD_DESIGN = {
    "flash_fwd": _WIDE_LOCKSTEP + "S's k steps 0-7 with Q in registers",
    "flash_fwd_streamed": _WIDE_LOCKSTEP + "Q in shared memory",
    "flash_fwd_tri": _WIDE_LOCKSTEP + "Q in shared memory"}
NO_SPILL_KERNELS = ("flash_fwd_kernel<256", "flash_fwd_streamed_kernel<256",
                    "flash_fwd_tri_kernel<256", "flash_dq_tri_kernel<256")
# Every width-512 instance builds without spills too (168 registers at
# launch, 232 a consumer).
NO_SPILL_KERNELS += tuple(
    f"flash_{k}{fam}_kernel<{d}" for k in ("fwd", "dq", "dkv")
    for fam in ("", "_tri", "_streamed") for d in (512, 2048))
# The fp32 kernels at every width (csrc/flash_f32.cu: 128-254 registers,
# no spills).
F32_KERNELS = ("flash_fwd_f32_kernel", "flash_dq_f32_kernel",
               "flash_dkv_f32_kernel")
NO_SPILL_KERNELS += tuple(f"{k}<{d}>" for k in F32_KERNELS
                          for d in (64, 128, 256, 512))
# Past 512 the fp32 kernels' wide bodies (no template head_dim: one for
# every width), FFMA alone and no spills too.
F32_WIDE_KERNELS = ("flash_fwd_f32_wide_kernel", "flash_dq_f32_wide_kernel",
                    "flash_dkv_f32_wide_kernel")
NO_SPILL_KERNELS += tuple(f"{k}:" for k in F32_WIDE_KERNELS)
TRI_WIDE_MAIN_SHAPE = (1, 8192, 8, 1, 256, True)
TRI_WIDE_CHECK_SHAPES = (TRI_WIDE_MAIN_SHAPE, (1, 4096, 16, 16, 256, True),
                         (1, 4136, 8, 1, 256, True),
                         (1, 4160, 8, 1, 256, True))
STR_WIDE_MAIN_SHAPE = (1, 4096, 8, 1, 256, False)
STR_WIDE_CHECK_SHAPES = (STR_WIDE_MAIN_SHAPE, (1, 4136, 8, 1, 256, False),
                         (1, 4136, 16, 16, 256, False))
# The op past the resident budget at width 256 ([wide op]): causal takes
# the triangular trio, non-causal the streamed one. Then head_dims that
# pad to the width-512 kernels, each through one family (264 and 448
# resident, 320 triangular, 392 streamed, 512 in all three), the padded
# columns of the kernels' outputs exactly 0. Past width 512 no kernel
# exists: the op must refuse before any launch.
WIDE_OP_SHAPE = (1, 4096, 8, 1, 256, True)
PAD512_OP_SHAPES = ((1, 1024, 8, 1, 264, True), (1, 4096, 8, 1, 320, True),
                    (1, 4096, 8, 1, 392, False), (2, 512, 8, 2, 448, False),
                    (1, 1024, 8, 1, 512, True), (1, 4096, 8, 1, 512, True),
                    (1, 4096, 8, 1, 512, False))
# Then head_dims past 512, each padded to its cluster width and through
# one family: 520 (triangular) and 640 (resident) to 768, 1000 to 1024
# (resident and streamed: their @1024 records' launches), 1536
# (triangular), 2048 (resident). Past width 2048 no kernel exists (a
# cluster would pass 8 CTAs): the op must refuse before any launch.
XW_OP_SHAPES = ((1, 1024, 8, 1, 520, True), (2, 512, 8, 2, 640, False),
                (1, 512, 8, 1, 1000, True), (1, 2048, 8, 1, 1000, False),
                (1, 1024, 8, 1, 1536, True), (1, 256, 8, 1, 2048, False))
REFUSED_HEAD_DIM = 2056
# Width 512 ([kernels d512]): each family at its main shape (the
# width-256 rows' with D doubled: resident 8 x 1024, the budget's longest
# S at 512; triangular 1 x 8192; streamed 1 x 4096 non-causal), then
# ragged S (200, 1000, 4136), S = 4160, Gemma-7B's MHA (16/16) and an odd
# GQA group (6).
X512_MAIN_SHAPE = (8, 1024, 8, 1, 512, True)
X512_CHECK_SHAPES = (X512_MAIN_SHAPE, (1, 200, 16, 16, 512, True),
                     (2, 1000, 12, 2, 512, False))
TRI_X512_MAIN_SHAPE = (1, 8192, 8, 1, 512, True)
TRI_X512_CHECK_SHAPES = (TRI_X512_MAIN_SHAPE, (1, 4136, 8, 1, 512, True),
                         (1, 4160, 12, 2, 512, True))
STR_X512_MAIN_SHAPE = (1, 4096, 8, 1, 512, False)
STR_X512_CHECK_SHAPES = (STR_X512_MAIN_SHAPE,
                         (1, 4136, 16, 16, 512, False),
                         (1, 4160, 8, 1, 512, False))
# The width-512 clusters (csrc/flash_fwd_sm90.cuh fwd_cta_512,
# flash_bwd_sm90.cuh dq_cta_512 and dkv_cta_512): two CTAs an item, each
# its 256-column chunk of every operand, partials exchanged through
# distributed shared memory and summed in one order in both.
X512_DESIGN = ("a cluster of two CTAs an item, each its 256-column chunk "
               "of every operand, fp32 partials exchanged through "
               "distributed shared memory; fwd: 128 q rows against 64-row "
               "K/V tiles (2 stages each), S partials sent a tile ahead; "
               "dq (triangular, streamed): 64 q rows against 64-row K tiles "
               "(3 stages) and V (1), consumer 0 S and consumer 1 dP "
               "partials sent a tile ahead, each consumer a 128-column half "
               "of dq; the resident dq one CTA an item, a consumer a chunk, "
               "S and dP recomputed, 32-row K/V tiles; dk/dv: a 64-row kv "
               "tile against 2 stages of 64-row Q/dO tiles, S^T and dP^T "
               "partials, dv and dk in separate consumers")
# Past width 512 ([kernels dxwide]): each family's main shape at width
# 1024 (the width-512 rows' with the resident S halved, the budget's
# longest S at 1024: resident 8 x 512; triangular 1 x 8192; streamed 1 x
# 4096 non-causal), then at 768 ragged S (200, 1000, 4136), S = 4160,
# Gemma-7B's MHA (16/16) and a GQA group of 6 (12/2), and at 2048 one
# shape a family; the trio is timed at the main shapes and again, at the
# same (B, S, H, KVH), at widths 768 and 2048 (XW_TIMED_WIDTHS).
XW_WIDTH = 1024
XW_TIMED_WIDTHS = (768, 2048)
XW_MAIN_SHAPE = (8, 512, 8, 1, 1024, True)
XW_CHECK_SHAPES = (XW_MAIN_SHAPE, (1, 200, 16, 16, 768, True),
                   (2, 512, 12, 2, 768, False), (2, 256, 8, 1, 2048, True))
TRI_XW_MAIN_SHAPE = (1, 8192, 8, 1, 1024, True)
TRI_XW_CHECK_SHAPES = (TRI_XW_MAIN_SHAPE, (1, 1000, 8, 1, 768, True),
                       (1, 4136, 16, 16, 768, True),
                       (1, 4160, 12, 2, 768, True),
                       (1, 1024, 8, 1, 2048, True))
STR_XW_MAIN_SHAPE = (1, 4096, 8, 1, 1024, False)
STR_XW_CHECK_SHAPES = (STR_XW_MAIN_SHAPE, (1, 1000, 12, 2, 768, False),
                       (1, 4136, 8, 1, 768, False),
                       (1, 4160, 16, 16, 768, False),
                       (1, 1024, 8, 1, 2048, False))
# The clusters past 512 (csrc/flash_fwd_sm90.cuh fwd_cta_x,
# flash_bwd_sm90.cuh dq_cta_x and dkv_cta_x): one instance for every
# width, n = width / 256 CTAs an item, each its chunk of every operand,
# partials pulled by every rank in rank order.
XW_DESIGN = ("a cluster of width / 256 CTAs an item, each its 256-column "
             "chunk of every operand, each CTA's fp32 partial left in a slot "
             "of its own shared memory and read by every rank through "
             "distributed shared memory in rank order; fwd: 128 q rows "
             "against 64-row K/V tiles (2 stages each); dq (every family): "
             "64 q rows against 64-row K tiles (2 stages) and V (1), "
             "consumer 0 S and consumer 1 dP partials, each summed by its "
             "consumer and handed to the other, each consumer a 128-column "
             "half of dq; dk/dv: a 64-row kv tile against 2 stages of 64-row "
             "Q/dO tiles, consumer 0 S^T and consumer 1 dP^T partials, dv "
             "and dk in separate consumers; all in lockstep across the "
             "ranks, one tile at a time")
# The instance of every Hopper kernel that serves the widths past 512
# (csrc kClusterD).
CLUSTER_D = 2048

# The Hopper kernels (wgmma + TMA): launch counter, library, kernel name in
# the SASS.
SM90_KERNELS = (("flash_fwd", "flash_fwd", "flash_fwd_kernel"),
                ("flash_dq", "flash_bwd", "flash_dq_kernel"),
                ("flash_dkv", "flash_bwd", "flash_dkv_kernel"),
                ("flash_fwd_tri", "flash_tri", "flash_fwd_tri_kernel"),
                ("flash_dq_tri", "flash_tri", "flash_dq_tri_kernel"),
                ("flash_dkv_tri", "flash_tri", "flash_dkv_tri_kernel"),
                ("flash_fwd_streamed", "flash_streamed",
                 "flash_fwd_streamed_kernel"),
                ("flash_dq_streamed", "flash_streamed",
                 "flash_dq_streamed_kernel"),
                ("flash_dkv_streamed", "flash_streamed",
                 "flash_dkv_streamed_kernel"))
# The kernels' element types (_build.DTYPES) by their tag in a kernel's
# mangled name.
ELEM_TAGS = {"bf16": "Bf16", "f16": "F16"}
RESIDENT_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")
TRI_NAMES = ("flash_fwd_tri", "flash_dq_tri", "flash_dkv_tri")
STREAMED_NAMES = ("flash_fwd_streamed", "flash_dq_streamed",
                  "flash_dkv_streamed")
# The head_dim instances of every Hopper kernel.
HEAD_DIMS = (64, 128, 256, 512)

N_LAYERS = 4
BATCH, SEQ = 2, 2048
TRAIN_STEPS = 8
# The parallel phase: [slice]'s configuration on a world-1 mesh of every
# training axis, and the ring's chunk arithmetic at Llama-3-8B's
# attention shape (its published context, batch 1) cut into RING_CHUNKS
# chunks, against the flash op; forward_pipelined at two microbatches
# against forward, norm-relative (bf16 logits of two batchings).
PAR_AXES = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}
RING_SHAPE = (1, 8192, 32, 8, 128)
RING_CHUNKS = 4
PIPE_REL_TOL = 2e-2
# The long-context phase: JAX bench's long-context leg at its headline
# point (Llama-3-8B's published context), depth cut to 4 layers.
LC_LAYERS, LC_BATCH, LC_SEQ = 4, 1, 8192
LC_POLICY = "save_flash_offload_qkv"
# The tiny phase: LlamaConfig.tiny() (dim 128, 8 heads: head_dim 16).
TINY_BATCH, TINY_SEQ = 4, 256
# The adafactor phase: bench.py's 8B-shape leg (_eight_b_shape_leg) at its
# largest candidate, as bench.py runs it.
AF_LAYERS, AF_VOCAB, AF_MAX_SEQ = 8, 32768, 4096
AF_BATCH, AF_SEQ = 8, 2048
# The lora phase: examples/llama31_lora.yaml's shape, Llama-3-8B at full
# width and depth; run A's steps, B's, and B' resuming B to A's count.
LORA_BATCH, LORA_SEQ = 8, 2048
LORA_STEPS, LORA_SPLIT = 4, 2
# Run A (and [gemma_lora], [gemma_long]) run with the training telemetry
# armed (observability/trainstats), a timed synchronize after every step
# so each step's dispatch / device split is read. The goodput fractions
# are held to the ring's own records (each the component over the window,
# rounded to 4 decimals): the module's own formula, so this is no
# independent check of goodput. The fractions are not a partition: they
# count the first step's input wait, which lies before the window (the
# JAX package's rule, a fault of the reference that the port matches;
# ROADMAP Queue 3), so their sum passes 1 by that share. What the ring
# leaves out of the window (the loop's moments outside its timed spans,
# the telemetry's own sinks among them) must stay under UNTRACKED_MAX.
TRAINSTATS_SYNC_EVERY = 1
UNTRACKED_MAX = 1e-2
# The tune phase: the sweep of the port's engine constants for Llama's
# paged mode at decode_bench.build("llama")'s shape (quick budgets, 8
# slots), then the manifest it wrote read back through the engine's
# geometry at TUNE_MAX_SEQ (wide enough that no window is clamped).
TUNE_SLOTS, TUNE_MAX_SEQ = 8, 2048
# The mixtral phase: Mixtral-8x7B widths; depth cut from 32 to 2 layers
# (47 B parameters in bf16 do not fit one 80 GB card).
MX_LAYERS, MX_BATCH, MX_SEQ, MX_STEPS = 2, 2, 2048, 6
# The mixtral_ep phase: the expert-parallel recipe (recipes/mixtral_ep.run)
# at [mixtral]'s configuration with the recipe's adamw, on a world-1 NCCL
# mesh {dp 1, ep 1}, against the one-device step from the same weights
# and batches.
MXEP_STEPS, MXEP_SEED = 6, 4
# The recipes phase: resnet_ddp at its published config (resnet101, 224 x
# 224, batch 32 a process, one process), its p50 over steps 3 on; mnist
# and glue_imdb at their default step counts with their accuracy gates.
RESNET_STEPS, MNIST_STEPS, GLUE_STEPS = 12, 300, 200

# The gemma_lora phase: examples/gemma_lora.yaml's shape (batch 8 x seq
# 2048), Gemma-2B at full width and depth, where every attention call
# takes the width-256 resident kernels (3 * 2048 * 256 * 4 bytes = the 6
# MiB budget). The recipe's full-vocabulary f32 logits are 16.8 GB at
# batch 8, and a step holds several logit-sized tensors: the largest of
# GL_BATCHES that fits the card is taken, and the cut printed.
GL_BATCHES, GL_SEQ, GL_STEPS = (8, 7, 6, 5, 4), 2048, 4
# The gemma_long phase: the same recipe at Gemma-2B's max_seq_len, where
# every attention call takes the width-256 triangular kernels; its f32
# logits are 8.4 GB a copy at batch 1.
GLONG_BATCHES, GLONG_SEQ, GLONG_STEPS = (8, 4, 2, 1), 8192, 4
# The gemma_wide phase: Gemma-2B's widths (GemmaConfig(): dim 2048, 8 heads
# over 1 KV head, mlp 16384, vocab 256000 tied) with head_dim_ 512, depth
# cut from 18 to 2 layers, at 1 x 8192 through make_train_step as [long]
# runs it (save_flash_offload_qkv, chunked CE), adamw: every attention
# call takes the width-512 triangular kernels. A check of the path, not a
# cell.
GW_LAYERS, GW_HEAD_DIM, GW_BATCH, GW_SEQ, GW_STEPS = 2, 512, 1, 8192, 4
# The gemma_xwide phase: the same at head_dim_ 1024, 3 steps: every
# attention call takes the width-1024 triangular clusters (4 CTAs an
# item).
GX_HEAD_DIM, GX_STEPS = 1024, 3
# The serve phase: one Llama-3-8B replica (full width and depth, bf16,
# random weights) through the port's serve_llm at its own max_seq
# (MAX_PROMPT_TOKENS + MAX_GEN_TOKENS = 1280), 8 engine slots, paged,
# 64-token blocks; eight concurrent streamed requests, four greedy and
# four seeded, then a ninth sharing a 512-token prefix with the longest.
# Each request generates SV_MAX_TOKENS (128 before [mixtral_ep] and
# [recipes] were added; cut to 64 with [tp_serve]'s legs below to keep
# the run inside its time limit: the serving phases are host-bound, and
# a slower host ran them 1.3x longer).
SV_SLOTS, SV_BLOCK = 8, 64
SV_PROMPTS = (32, 64, 128, 256, 384, 512, 768, 1024)
SV_MAX_TOKENS, SV_TEMP, SV_PREFIX = 64, 0.8, 512
# The lb phase, on [serve]'s params: leg (a) sends [serve]'s eight
# requests with LB_BYTES_TOKENS tokens each (cut from SV_MAX_TOKENS: one
# request at a time decodes at ~0.12 s a token here); leg (b) runs the
# load generator's chat mix at LB_QPS for LB_DURATION s, LB_MAX_TOKENS
# tokens a request, graded against decode_bench's default SLOs; leg (c)
# kills replica A once LB_KILL_AFTER of a greedy LB_KILL_TOKENS-token
# stream's tokens (prompt LB_KILL_PROMPT tokens) reached the client.
LB_BYTES_TOKENS = 8
LB_QPS, LB_DURATION, LB_MAX_TOKENS = 1.0, 8.0, 16
LB_SLO_TTFT, LB_SLO_TPOT = 3.0, 0.5
LB_KILL_PROMPT, LB_KILL_TOKENS, LB_KILL_AFTER = 96, 64, 16
# The cache paths' bf16 logits against the full forward's (flash kernels),
# norm-relative, on the greedy streams teacher-forced. Set between the
# sound reading and the planted faults' (H100, 32 layers: 1.93e-2; faults
# 6.6e-2 and 1.8e-1): bf16 rounding grown over 32 random layers puts
# any two summation orders ~2e-2 apart.
CACHE_REL_TOL = 3.5e-2
# The same at Gemma-2B ([gemma_serve], 18 layers, MQA), set between its
# sound reading and its faults' (H100: 1.81e-2; own key masked 2.76e-2,
# shift 7.27e-2): with one KV head over long contexts a query's own key
# moves its output less than in Llama, so [serve]'s 3.5e-2 would not see
# that fault.
GEMMA_CACHE_REL_TOL = 2.25e-2
# Exactness checks in f32 at the 8B width, depth cut to 4 layers: two
# paths' tokens may part only where the two candidates' (perturbed, when
# sampled) logits lie within this of each other.
SV_EXACT_LAYERS, SV_EXACT_TOKENS = 4, 32
F32_NEAR_TIE = 1e-3
# The cache paths' f32 logits against the full forward's, teacher-forced
# (H100, 4 layers: 3.0e-6; the planted faults 1.3e-1 and 2.8e-1).
F32_CACHE_REL_TOL = 1e-4
# The host-tier leg (f32, 4 layers): one slot, a pool of 9 usable 64-token
# blocks, prompts A and B (B needs all nine), a 64 MiB host tier.
SP_POOL_BLOCKS, SP_PROMPTS, SP_HOST_MB = 10, (200, 520), 64
# The mixtral_serve phase: Mixtral-8x7B at full width. Its 46.70 B
# parameters are 93.4 GB in bf16, more than the card holds, and 46.7 GB in
# int8: leg 1 serves the int8 tree through serve_llm, its depth cut to
# MXS_INT8_LAYERS (11.7 GB; the full 32 layers, 46.7 GB, ran here until
# [tp_serve] needed the time, then 16 until [mixtral_ep] and [recipes]
# did, and run in tools/torch_parallel_cards.py tp_serve); leg 2 holds
# the cache paths in bf16 at MXS_BF16_LAYERS (11.9 GB) against the
# no-drop capacity forward, and the int8 cache path's top-1 against
# them; leg 3 does the same in f32 at 4 layers (24.3 GB).
MXS_INT8_LAYERS, MXS_BF16_LAYERS, MXS_F32_LAYERS = 8, 8, 4
# The int8 cache path's teacher-forced top-1 agreement with the bf16
# tree's, at least the JAX package's floor for Mixtral (tests/test_quant.py
# TOP1_FLOOR["mixtral"], int8 weights and KV against bf16).
MXS_TOP1_FLOOR = 0.55
# Mixtral's bf16 cache paths' logits, norm-relative, on the greedy streams:
# teacher-forced against the no-drop forward's (flash kernels) at 16
# layers, and the int8 tree's batched T = 1 steps against a fresh prefill
# over each whole prefix at 32 layers. Dense routing is discontinuous:
# bf16 roundings that differ by GEMM shape flip a token's second expert
# where its gates nearly tie, and a flip moves that token's whole layer
# output. As served, the readings are 1.08e-1 and 1.22e-1 (H100), the
# routing faults 4.9e-1 up: MIXTRAL_ROUTED_REL_TOL bounds them. With
# routing pinned to the reference's picks (_RoutingPins: 1.5% of the
# (layer, token) picks flip, each by a gate mass under 1.1e-2) the paths'
# own arithmetic is left: 1.43e-2 and 1.58e-2, against own key masked
# 4.69e-2 and 4.10e-2, positions shifted 1.37e-1 and 1.09e-1, gates
# unnormalised 4.87e-1, top-1 routing 7.66e-1. MIXTRAL_CACHE_REL_TOL sits
# 1.6x over the larger sound reading and 1.6x under the nearest fault.
MIXTRAL_ROUTED_REL_TOL = 2.5e-1
MIXTRAL_CACHE_REL_TOL = 2.5e-2
# One Mixtral decode step profiled: its slots, each at this context.
MXS_PROFILE_CONTEXT = 128

# The TPU kernel each port kernel replaces: its body, file:line.
_FA = "skypilot_tpu/ops/pallas/flash_attention.py"
TPU_KERNELS = {
    "flash_fwd": f"{_FA}:759", "flash_dq": f"{_FA}:862",
    "flash_dkv": f"{_FA}:906", "flash_fwd_tri": f"{_FA}:417",
    "flash_dq_tri": f"{_FA}:543", "flash_dkv_tri": f"{_FA}:598",
    "flash_fwd_streamed": f"{_FA}:57", "flash_dq_streamed": f"{_FA}:178",
    "flash_dkv_streamed": f"{_FA}:227",
}
# The port source each kernel is instantiated in (the bodies it shares are
# csrc/flash_fwd_sm90.cuh and csrc/flash_bwd_sm90.cuh).
_CSRC = "skypilot_tpu_torch/csrc"
SOURCES = {
    "flash_fwd": f"{_CSRC}/flash_fwd.cu", "flash_dq": f"{_CSRC}/flash_bwd.cu",
    "flash_dkv": f"{_CSRC}/flash_bwd.cu",
    "flash_fwd_tri": f"{_CSRC}/flash_tri.cu",
    "flash_dq_tri": f"{_CSRC}/flash_tri.cu",
    "flash_dkv_tri": f"{_CSRC}/flash_tri.cu",
    "flash_fwd_streamed": f"{_CSRC}/flash_streamed.cu",
    "flash_dq_streamed": f"{_CSRC}/flash_streamed.cu",
    "flash_dkv_streamed": f"{_CSRC}/flash_streamed.cu",
}


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


class ClockSampler:
    """The card's SM clock, its maximum, power draw, temperature and active
    clock-limit reasons, sampled by nvidia-smi every 100 ms in a child
    process and stamped with the host's perf_counter when read. Timings
    (time_ms) mark their windows; `last()` summarises the samples within
    PAD seconds of the last window (a window of a few ms holds no sample
    of its own). Without nvidia-smi it samples nothing and says so."""

    FIELDS = ("clocks.sm", "clocks.max.sm", "power.draw", "temperature.gpu")
    # The limit reasons' field, under its current name and its older one.
    REASONS = ("clocks_event_reasons.active", "clocks_throttle_reasons.active")
    PAD = 0.15

    def __init__(self):
        self.samples, self.window = [], None
        self.proc = self.thread = None

    def start(self):
        for reasons in self.REASONS:
            query = ["nvidia-smi", "-i", "0", "--format=csv,noheader,nounits",
                     "--query-gpu=" + ",".join(self.FIELDS + (reasons,))]
            try:
                probe = subprocess.run(query, capture_output=True, text=True,
                                       timeout=30)
            except (OSError, subprocess.SubprocessError):
                return
            if probe.returncode == 0:
                self.proc = subprocess.Popen(
                    query + ["-lms", "100"], stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL, text=True)
                self.thread = threading.Thread(target=self._read,
                                               daemon=True)
                self.thread.start()
                return

    def _read(self):
        for line in self.proc.stdout:
            parts = [x.strip() for x in line.split(",")]
            try:
                values = [float(x) for x in parts[:4]]
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), *values, parts[4]))

    def stop(self):
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.thread.join(timeout=10)
            self.proc = None

    def mark(self, t0, t1):
        self.window = (t0, t1)

    def last(self):
        """{"sm_mhz", "max_mhz", "power_w", "temp_c", "reasons"} over the
        last window: medians, the reasons seen; None without samples."""
        if self.window is None:
            return None
        t0, t1 = self.window
        got = [x for x in list(self.samples)
               if t0 - self.PAD <= x[0] <= t1 + self.PAD]
        if not got:
            return None
        return {"sm_mhz": statistics.median(x[1] for x in got),
                "max_mhz": max(x[2] for x in got),
                "power_w": statistics.median(x[3] for x in got),
                "temp_c": max(x[4] for x in got),
                "reasons": sorted({x[5] for x in got})}


CLOCKS = ClockSampler()


def clock_note(clk):
    """A timing's clocks as printed beside it."""
    if clk is None:
        return "SM clock not sampled"
    return (f"SM {clk['sm_mhz']:.0f} MHz (max {clk['max_mhz']:.0f}), "
            f"{clk['power_w']:.1f} W, {clk['temp_c']:.0f} C, limit reasons "
            f"{'/'.join(clk['reasons'])}")


def time_ms(fn, reps, warmup=2):
    """Mean device time of fn over reps, by CUDA events after warm-up; the
    window is marked on CLOCKS."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    CLOCKS.mark(t0, time.perf_counter())
    return start.elapsed_time(end) / reps


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    return card


def phase_build(build):
    t0 = time.perf_counter()
    info = build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rec in info.items():
        summary = _ptxas_summary(rec["ptxas"])
        print(f"[build] {name}.cu nvcc {rec['seconds']:.1f} s: "
              + "; ".join(summary), flush=True)
        for line in summary:
            if line.startswith(NO_SPILL_KERNELS):
                check(line.endswith("spills 0/0 bytes"),
                      f"ptxas spills in {line}")
        for line in rec["ptxas"].splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"[build] {name}.cu: {line.strip()}", flush=True)
    attrs = {}
    for name, source, kernel in SM90_KERNELS:
        fn = getattr(build.library(source), f"stpu_{name}_attrs")
        # At XW_WIDTH the report is the CLUSTER_D instance's.
        for d in HEAD_DIMS + (XW_WIDTH,):
            for elem, code in build.DTYPES.items():
                tag = ELEM_TAGS[elem]
                out = (ctypes.c_int * 5)()
                check(fn(d, code, out) == 0, "cudaFuncGetAttributes failed "
                      f"for {kernel}<{d}, {tag}>")
                regs, smem, threads, producer, consumer = out
                attrs[(kernel, d, tag)] = (regs, smem)
                inst = d if d in HEAD_DIMS else f"{CLUSTER_D}> at width {d}"
                print(f"[build] {kernel}<{inst}, {tag}>: {regs} registers per "
                      f"thread at launch (setmaxnreg: producer {producer}, "
                      f"consumers {consumer}), {smem} bytes dynamic shared "
                      f"memory, {threads} threads", flush=True)
    phase_sass(build)
    return attrs


def phase_sass(build):
    """Every instance of the Hopper kernels (head_dim 64, 128, 256, 512
    and CLUSTER_D, the one past 512; bf16 and f16) must hold wgmma (HGMMA)
    and TMA loads (UTMALDG) in its
    SASS, and its wgmmas must run asynchronously: ptxas serialises them
    (with a "Potential Performance Loss" note) by placing a wait
    (WARPGROUP.DEPBAR) after each one, so a kernel with as many waits as
    wgmmas fails. Every instance of the fp32 forward, dq and dk/dv, and
    their wide bodies past 512, must hold FFMA and no HMMA or HGMMA: their
    products stay exact fp32."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = {}
    for name, source, kernel in SM90_KERNELS:
        lib = build.build_dir() / f"lib{source}.so"
        if source not in sass:
            out = subprocess.run([cuobjdump, "-sass", str(lib)],
                                 capture_output=True, text=True, timeout=300)
            check(out.returncode == 0, f"cuobjdump failed on {lib}: "
                  f"{out.stderr[-2000:]}")
            sass[source] = out.stdout
        found = set()
        for part in sass[source].split("Function : ")[1:]:
            mangled = part.split(None, 1)[0]
            m = re.search(kernel + r"ILi(\d+)ENS_\d(Bf16|F16)E", mangled)
            if not m:
                continue
            found.add(m.groups())
            hgmma, utmaldg = part.count("HGMMA"), part.count("UTMALDG")
            waits = part.count("WARPGROUP.DEPBAR")
            print(f"[sass] {kernel}<{m.group(1)}, {m.group(2)}>: {hgmma} "
                  f"HGMMA, {utmaldg} UTMALDG, {waits} wgmma waits",
                  flush=True)
            check(hgmma > 0 and utmaldg > 0,
                  f"{mangled} holds no wgmma or no TMA load")
            check(waits < hgmma, f"{mangled}: ptxas serialised its wgmmas")
        want = {(str(d), tag) for d in HEAD_DIMS + (CLUSTER_D,)
                for tag in ELEM_TAGS.values()}
        check(found == want, f"{kernel}: instances {sorted(found)} in "
              f"{lib}'s SASS, expected {sorted(want)}")
    # The fp32 kernels are exact fp32: FFMA on the CUDA cores, no
    # tensor-core product (HMMA, HGMMA) in any instance.
    lib = build.build_dir() / "libflash_f32.so"
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {lib}: "
          f"{out.stderr[-2000:]}")
    for kernel in F32_KERNELS:
        found = set()
        for part in out.stdout.split("Function : ")[1:]:
            m = re.search(kernel + r"ILi(\d+)E", part.split(None, 1)[0])
            if not m:
                continue
            found.add(int(m.group(1)))
            ffma, mma = part.count("FFMA"), part.count("HMMA")
            gmma = part.count("HGMMA")
            print(f"[sass] {kernel}<{m.group(1)}>: {ffma} FFMA, {mma} HMMA, "
                  f"{gmma} HGMMA", flush=True)
            check(ffma > 0 and mma == 0 and gmma == 0,
                  f"{kernel}<{m.group(1)}> is not FFMA alone")
        check(found == set(HEAD_DIMS), f"{kernel}: instances "
              f"{sorted(found)} in {lib}'s SASS, expected {HEAD_DIMS}")
    for kernel in F32_WIDE_KERNELS:
        parts = [part for part in out.stdout.split("Function : ")[1:]
                 if kernel in part.split(None, 1)[0]]
        check(len(parts) == 1, f"{kernel}: {len(parts)} bodies in {lib}'s "
              "SASS, expected 1")
        ffma, mma = parts[0].count("FFMA"), parts[0].count("HMMA")
        gmma = parts[0].count("HGMMA")
        print(f"[sass] {kernel}: {ffma} FFMA, {mma} HMMA, {gmma} HGMMA",
              flush=True)
        check(ffma > 0 and mma == 0 and gmma == 0,
              f"{kernel} is not FFMA alone")


def _ptxas_summary(log):
    """'kernel<D[, T]>: N registers, spills S/L bytes' from nvcc -Xptxas
    -v (the fp32 kernels have no element type)."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"(flash_(?:fwd|dq|dkv)(?:_tri|_streamed|_f32)?_kernel)"
                      r"ILi(\d+)E(?:NS_\d(Bf16|F16)E)?", line)
        wide = re.search(r"(flash_(?:fwd|dq|dkv)_f32_wide_kernel)", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}" + (
                f", {m.group(3)}>" if m.group(3) else ">")
        elif wide:
            name = wide.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name}: {m.group(1)} registers, spills {spill} "
                       "bytes")
    return out


def _inputs(shape, seed, dtype=torch.bfloat16):
    b, s, h, kvh, d, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*dims):
        return torch.randn(*dims, device="cuda", generator=g).to(dtype)

    return (rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d),
            rnd(b, s, h, d))


def _err(out, ref):
    out, ref = out.float(), ref.float()
    rel = ((out - ref).norm() / ref.norm()).item()
    max_abs = (out - ref).abs().max().item()
    return rel, max_abs, ref.abs().max().item()


class Family:
    """One kernel family's three wrappers and two plain versions, closed
    over (causal, scale), with its kernels' names. The triangular
    functions are causal only and take no flag."""

    def __init__(self, fa, fam, causal, scale):
        suffix = {fa.RESIDENT: "", fa.TRIANGULAR: "_tri",
                  fa.STREAMED: "_streamed"}[fam]
        flag = () if fam == fa.TRIANGULAR else (causal,)
        self.names = tuple(f"flash_{n}{suffix}" for n in ("fwd", "dq", "dkv"))
        fwd, dq, dkv = (getattr(fa, n) for n in self.names)
        fwd_plain = getattr(fa, f"flash_fwd{suffix}_plain")
        bwd_plain = getattr(fa, f"flash_bwd{suffix}_plain")
        self.fwd = lambda q, k, v: fwd(q, k, v, *flag, scale)
        self.dq = lambda q, k, v, o, lse, do: dq(q, k, v, o, lse, do, *flag,
                                                 scale)
        self.dkv = lambda q, k, v, do, lse, delta: dkv(q, k, v, do, lse,
                                                       delta, *flag, scale)
        self.fwd_plain = lambda q, k, v: fwd_plain(q, k, v, *flag, scale)
        self.bwd_plain = lambda q, k, v, o, lse, do: bwd_plain(
            q, k, v, o, lse, do, *flag, scale)

    def run(self, q, k, v, do):
        """(o, lse, dq, delta, dk, dv) through the three kernels."""
        o, lse = self.fwd(q, k, v)
        dq, delta = self.dq(q, k, v, o, lse, do)
        dk, dv = self.dkv(q, k, v, do, lse, delta)
        return o, lse, dq, delta, dk, dv


def _hold(label, shape, pairs):
    """Print and check each (name, (out, ref), tol) of pairs against the
    tolerances above; returns the errors by name."""
    errs = {}
    for name, (out, ref), tol in pairs:
        rel, max_abs, peak = errs[name] = _err(out, ref)
        print(f"{label} {shape} {name}: rel {rel:.3e} (tol {tol}) max_abs "
              f"{max_abs:.3e} (cap {MAX_ABS_SHARE * peak:.3e})", flush=True)
        check(rel <= tol and max_abs <= MAX_ABS_SHARE * peak,
              f"{name} disagrees at {shape} ({label})")
    return errs


def phase_kernels(fa):
    """Kernels against plain versions; returns per-kernel records at each
    family's main shape."""
    records = {}
    for fam, shapes, main in ((fa.RESIDENT, CHECK_SHAPES, MAIN_SHAPE),
                              (fa.TRIANGULAR, TRI_CHECK_SHAPES,
                               TRI_MAIN_SHAPE),
                              (fa.STREAMED, STR_CHECK_SHAPES,
                               STR_MAIN_SHAPE)):
        for idx, shape in enumerate(shapes):
            b, s, h, kvh, d, causal = shape
            # Past the budget: the shape the JAX dispatcher sends to this
            # family (the streamed family's causal case included).
            check(fam == fa.RESIDENT
                  or fa.family(s, d, fam == fa.TRIANGULAR) == fam,
                  f"{shape} is not past the resident budget")
            fns = Family(fa, fam, causal, d ** -0.5)
            q, k, v, do = _inputs(shape, idx)
            o, lse, dq, delta, dk, dv = fns.run(q, k, v, do)
            torch.cuda.synchronize()
            o_p, lse_p = fns.fwd_plain(q, k, v)
            # The backward pair is held against the plain backward of the
            # same saved forward (the kernel's o and lse).
            dq_p, dk_p, dv_p = fns.bwd_plain(q, k, v, o, lse, do)
            errs = _hold(f"[kernels] {fam}", shape, (
                ("o", (o, o_p), OUT_REL_TOL), ("lse", (lse, lse_p),
                                               OUT_REL_TOL),
                ("dq", (dq, dq_p), GRAD_REL_TOL),
                ("dk", (dk, dk_p), GRAD_REL_TOL),
                ("dv", (dv, dv_p), GRAD_REL_TOL)))
            del o_p, lse_p, dq_p, dk_p, dv_p
            if shape == main:
                _check_deterministic(fns, (q, k, v, do), (o, lse),
                                     (dq, dk, dv))
                records.update(_measure(fns, shape, (q, k, v, do),
                                        (o, lse, delta), errs))
                _check_f16(fns, shape, idx, records)
            if fam != fa.STREAMED and shape == main:
                _time_streamed_forward(fa, fns, shape, (q, k, v), records)
                _time_streamed_dq(fa, fam, fns, shape, (q, k, v, do),
                                  (o, lse), records)
            if fam != fa.RESIDENT and shape == main:
                # The resident kernels at the same shape: the same Hopper
                # bodies in lockstep, dq with both operands of S and dP in
                # shared memory and natural exp.
                res = Family(fa, fa.RESIDENT, causal, d ** -0.5)
                o_r, lse_r = res.fwd(q, k, v)
                _, delta_r = res.dq(q, k, v, o_r, lse_r, do)
                times = [time_ms(lambda: res.fwd(q, k, v), 10),
                         time_ms(lambda: res.dq(q, k, v, o_r, lse_r, do), 10),
                         time_ms(lambda: res.dkv(q, k, v, do, lse_r, delta_r),
                                 10)]
                print(f"[kernels] resident kernels at {shape}: forward "
                      f"{times[0]:.4f} ms, dq {times[1]:.4f} ms, dk/dv "
                      f"{times[2]:.4f} ms", flush=True)
                for name, t in zip(fns.names, times):
                    records[name]["resident_ms_same_shape"] = t
                del o_r, lse_r, delta_r
            del q, k, v, do, o, lse, dq, delta, dk, dv
            torch.cuda.empty_cache()
    phase_streamed_vs_resident(fa, records)
    return records


def phase_kernels_wide(fa, records):
    """[kernels] at width 256: each family's trio (the forward's
    fwd_consumer_wide, WIDE_FWD_DESIGN; the resident dq on
    WIDE_DQ_DESIGN, the triangular one on TRI_WIDE_DQ_DESIGN, the
    streamed one with a one-stage ring of 64-row K/V tiles (DqBase); every
    dk/dv on dkv_cta_wide, the GQA group in P parts summed by the last
    item of each kv tile; natural exp for the resident and streamed
    families, base 2 for the triangular one) against its plain versions in
    bf16 at its shapes (the resident pair also at WIDE_PAIR_SHAPES), each
    launch's items, P and shared memory printed, then at its main shape
    the backward pair twice bit-identical, the times (bf16, f16, plain,
    SDPA, bound), the pair beside SDPA's whole backward and f16 against
    the plain versions. Records keyed "<name>@256"."""
    seed = 40
    for fam, shapes, main in ((fa.RESIDENT, WIDE_CHECK_SHAPES,
                               WIDE_MAIN_SHAPE),
                              (fa.TRIANGULAR, TRI_WIDE_CHECK_SHAPES,
                               TRI_WIDE_MAIN_SHAPE),
                              (fa.STREAMED, STR_WIDE_CHECK_SHAPES,
                               STR_WIDE_MAIN_SHAPE)):
        for shape in shapes:
            b, s, h, kvh, d, causal = shape
            check(fa.family(s, d, causal) == fam
                  and fa.kernel_head_dim(d) == 256,
                  f"{shape} is not a width-256 {fam} shape")
            fns = Family(fa, fam, causal, d ** -0.5)
            _print_launches(fa, fam, fns, shape)
            q, k, v, do = _inputs(shape, seed)
            o, lse, dq, delta, dk, dv = fns.run(q, k, v, do)
            torch.cuda.synchronize()
            o_p, lse_p = fns.fwd_plain(q, k, v)
            dq_p, dk_p, dv_p = fns.bwd_plain(q, k, v, o, lse, do)
            errs = _hold(f"[kernels d256] {fam}", shape, (
                ("o", (o, o_p), OUT_REL_TOL),
                ("lse", (lse, lse_p), OUT_REL_TOL),
                ("dq", (dq, dq_p), GRAD_REL_TOL),
                ("dk", (dk, dk_p), GRAD_REL_TOL),
                ("dv", (dv, dv_p), GRAD_REL_TOL)))
            del o_p, lse_p, dq_p, dk_p, dv_p
            if shape == main:
                _check_deterministic(fns, (q, k, v, do), (o, lse),
                                     (dq, dk, dv))
                wide = _measure(fns, shape, (q, k, v, do), (o, lse, delta),
                                errs)
                _check_f16(fns, shape, seed, wide)
                records.update((f"{name}@256", rec)
                               for name, rec in wide.items())
                _print_pair_vs_sdpa(fam, fns, wide)
            del q, k, v, do, o, lse, dq, delta, dk, dv
            torch.cuda.empty_cache()
            seed += 1
    _check_resident_pair_past_budget(fa, seed)


def _print_pair_vs_sdpa(fam, fns, records, tag="[kernels d256]"):
    """A family's backward pair's time at width 256 (or 512) beside SDPA's
    whole backward (dq, dk, dv) on the same inputs, both from this run."""
    dq, dkv = fns.names[1:]
    dq_ms, dkv_ms = records[dq]["ms"], records[dkv]["ms"]
    lib = records[dq]["library_ms"]
    total = dq_ms + dkv_ms
    print(f"{tag} {fam} backward pair: {dq} {dq_ms:.4f} + {dkv} "
          f"{dkv_ms:.4f} = {total:.4f} ms; SDPA's whole backward "
          + ("none" if lib is None else
             f"{lib:.4f} ms (pair / SDPA {total / lib:.3f})"), flush=True)


def _check_resident_pair_past_budget(fa, seed):
    """The resident dq and dk/dv at width 256 at WIDE_PAIR_SHAPES against
    the plain backward of the resident forward, and bit-identical twice."""
    for shape in WIDE_PAIR_SHAPES:
        b, s, h, kvh, d, causal = shape
        fns = Family(fa, fa.RESIDENT, causal, d ** -0.5)
        _print_launches(fa, fa.RESIDENT, fns, shape)
        q, k, v, do = _inputs(shape, seed)
        o, lse, dq, delta, dk, dv = fns.run(q, k, v, do)
        torch.cuda.synchronize()
        dq_p, dk_p, dv_p = fns.bwd_plain(q, k, v, o, lse, do)
        _hold("[kernels d256] resident pair", shape, (
            ("dq", (dq, dq_p), GRAD_REL_TOL),
            ("dk", (dk, dk_p), GRAD_REL_TOL),
            ("dv", (dv, dv_p), GRAD_REL_TOL)))
        _check_deterministic(fns, (q, k, v, do), (o, lse), (dq, dk, dv))
        del q, k, v, do, o, lse, dq, delta, dk, dv, dq_p, dk_p, dv_p
        torch.cuda.empty_cache()
        seed += 1


def _print_launches(fa, fam, fns, shape, tag="[kernels d256]"):
    """Each kernel's launch at a shape of width 256 or more: its CTAs, P
    (the parts of the GQA group every dk/dv from width 256 on splits
    across CTAs) and its dynamic shared memory (the kernel's build
    report); the resident and triangular dq's CTA shapes at 256,
    X512_DESIGN at 512, XW_DESIGN past it."""
    b, s, h, kvh, d, causal = shape
    width = fa.kernel_head_dim(d)
    parts = fa.dkv_parts(b, s, kvh, h // kvh, causal,
                         fa._sm_count(torch.device("cuda")), width)
    n = fa.chunks(width)
    dq_tile = fa.CHUNKED_DQ_TILE if width > 256 else fa.BWD_TILE
    # The resident dq at 512 runs a CTA an item (X512_DESIGN).
    n_dq = 1 if fam == fa.RESIDENT and width == 512 else n
    items = (b * h * -(-s // fa.FWD_TILE) * n, b * h * -(-s // dq_tile) * n_dq,
             b * kvh * -(-s // fa.WIDE_KV_TILE) * parts * n)
    source = {fa.RESIDENT: ("flash_fwd", "flash_bwd", "flash_bwd"),
              fa.TRIANGULAR: ("flash_tri",) * 3,
              fa.STREAMED: ("flash_streamed",) * 3}[fam]
    notes = []
    for name, src, n, p in zip(fns.names, source, items, (1, 1, parts)):
        out = (ctypes.c_int * 5)()
        check(getattr(fa._build.library(src), f"stpu_{name}_attrs")(
            width, fa._build.DTYPES["bf16"], out) == 0,
            f"{name} attrs failed")
        notes.append(f"{name} {n} CTAs, P {p}, {out[1]} B shared")
    if width > 512:
        notes.append(f"{n} CTAs a cluster ({XW_DESIGN})")
    elif width > 256:
        notes.append(X512_DESIGN)
    else:
        notes[0] += f" ({WIDE_FWD_DESIGN[fns.names[0]]})"
        if fam == fa.RESIDENT:
            notes[1] += f" ({WIDE_DQ_DESIGN})"
        elif fam == fa.TRIANGULAR:
            notes[1] += f" ({TRI_WIDE_DQ_DESIGN})"
    print(f"{tag} {fam} {shape} launches: " + "; ".join(notes), flush=True)


def phase_kernels_512(fa, records):
    """[kernels d512]: each family's trio at width 512 (fwd_cta_512,
    dq_cta_512, dkv_cta_512: X512_DESIGN; natural exp for the resident
    and streamed families, base 2 for the triangular one) against its
    plain versions in bf16 at its shapes, one launch of each kernel per
    trio, each launch's CTAs, P and shared memory printed; then at its
    main shape the backward pair twice bit-identical, the times (bf16,
    f16, plain, SDPA with the backend it picks, bound), the pair beside
    SDPA's whole backward and f16 against the plain versions. Records
    keyed "<name>@512"."""
    seed = 60
    for fam, shapes, main in ((fa.RESIDENT, X512_CHECK_SHAPES,
                               X512_MAIN_SHAPE),
                              (fa.TRIANGULAR, TRI_X512_CHECK_SHAPES,
                               TRI_X512_MAIN_SHAPE),
                              (fa.STREAMED, STR_X512_CHECK_SHAPES,
                               STR_X512_MAIN_SHAPE)):
        for shape in shapes:
            b, s, h, kvh, d, causal = shape
            check(fa.family(s, d, causal) == fam
                  and fa.kernel_head_dim(d) == 512,
                  f"{shape} is not a width-512 {fam} shape")
            fns = Family(fa, fam, causal, d ** -0.5)
            _print_launches(fa, fam, fns, shape, "[kernels d512]")
            q, k, v, do = _inputs(shape, seed)
            fa.reset_launches()
            o, lse, dq, delta, dk, dv = fns.run(q, k, v, do)
            torch.cuda.synchronize()
            _expect_launches(fa, f"[kernels d512] {fam}", shape, fns.names)
            o_p, lse_p = fns.fwd_plain(q, k, v)
            dq_p, dk_p, dv_p = fns.bwd_plain(q, k, v, o, lse, do)
            errs = _hold(f"[kernels d512] {fam}", shape, (
                ("o", (o, o_p), OUT_REL_TOL),
                ("lse", (lse, lse_p), OUT_REL_TOL),
                ("dq", (dq, dq_p), GRAD_REL_TOL),
                ("dk", (dk, dk_p), GRAD_REL_TOL),
                ("dv", (dv, dv_p), GRAD_REL_TOL)))
            del o_p, lse_p, dq_p, dk_p, dv_p
            if shape == main:
                _check_deterministic(fns, (q, k, v, do), (o, lse),
                                     (dq, dk, dv))
                x512 = _measure(fns, shape, (q, k, v, do), (o, lse, delta),
                                errs)
                _check_f16(fns, shape, seed, x512)
                records.update((f"{name}@512", rec)
                               for name, rec in x512.items())
                _print_pair_vs_sdpa(fam, fns, x512, "[kernels d512]")
                backend = _sdpa_backend(shape, (q, k, v))
                for rec in x512.values():
                    rec["library_backend"] = backend
            del q, k, v, do, o, lse, dq, delta, dk, dv
            torch.cuda.empty_cache()
            seed += 1


def phase_kernels_xwide(fa, records):
    """[kernels dxwide]: each family's trio past width 512 (fwd_cta_x,
    dq_cta_x, dkv_cta_x: XW_DESIGN; natural exp for the resident and
    streamed families, base 2 for the triangular one) against its plain
    versions in bf16 at its shapes (widths 1024, 768 and 2048), one launch
    of each kernel per trio, each launch's CTAs, P and shared memory
    printed, the backward pair twice bit-identical at every shape; at its
    main shape (width 1024) the times (bf16, f16, plain, SDPA with the
    backend it picks, bound), the pair beside SDPA's whole backward and
    f16 against the plain versions; then the trio's time at the main
    shape's (B, S, H, KVH) at XW_TIMED_WIDTHS beside its bound there.
    Records keyed "<name>@1024" (the other widths' times under
    "width_ms")."""
    seed = 70
    for fam, shapes, main in ((fa.RESIDENT, XW_CHECK_SHAPES, XW_MAIN_SHAPE),
                              (fa.TRIANGULAR, TRI_XW_CHECK_SHAPES,
                               TRI_XW_MAIN_SHAPE),
                              (fa.STREAMED, STR_XW_CHECK_SHAPES,
                               STR_XW_MAIN_SHAPE)):
        for shape in shapes:
            b, s, h, kvh, d, causal = shape
            check(fa.family(s, d, causal) == fam
                  and d in fa.CLUSTER_WIDTHS,
                  f"{shape} is not a {fam} shape at a width past 512")
            fns = Family(fa, fam, causal, d ** -0.5)
            _print_launches(fa, fam, fns, shape, "[kernels dxwide]")
            q, k, v, do = _inputs(shape, seed)
            fa.reset_launches()
            o, lse, dq, delta, dk, dv = fns.run(q, k, v, do)
            torch.cuda.synchronize()
            _expect_launches(fa, f"[kernels dxwide] {fam}", shape, fns.names)
            o_p, lse_p = fns.fwd_plain(q, k, v)
            dq_p, dk_p, dv_p = fns.bwd_plain(q, k, v, o, lse, do)
            errs = _hold(f"[kernels dxwide] {fam}", shape, (
                ("o", (o, o_p), OUT_REL_TOL),
                ("lse", (lse, lse_p), OUT_REL_TOL),
                ("dq", (dq, dq_p), GRAD_REL_TOL),
                ("dk", (dk, dk_p), GRAD_REL_TOL),
                ("dv", (dv, dv_p), GRAD_REL_TOL)))
            del o_p, lse_p, dq_p, dk_p, dv_p
            _check_deterministic(fns, (q, k, v, do), (o, lse), (dq, dk, dv))
            if shape == main:
                xw = _measure(fns, shape, (q, k, v, do), (o, lse, delta),
                              errs)
                _check_f16(fns, shape, seed, xw)
                records.update((f"{name}@{XW_WIDTH}", rec)
                               for name, rec in xw.items())
                _print_pair_vs_sdpa(fam, fns, xw, "[kernels dxwide]")
                backend = _sdpa_backend(shape, (q, k, v), "[kernels dxwide]")
                for rec in xw.values():
                    rec["library_backend"] = backend
            del q, k, v, do, o, lse, dq, delta, dk, dv
            torch.cuda.empty_cache()
            seed += 1
        _time_other_widths(fa, fam, main, records, seed)


def _time_other_widths(fa, fam, main, records, seed):
    """The family's trio at the main shape's (B, S, H, KVH) at
    XW_TIMED_WIDTHS (the cluster instance at 3 and 8 CTAs an item), each
    beside its bound there (the FLOPs and bytes of _measure); under
    "width_ms" and "width_bound_ms" of the @XW_WIDTH records."""
    b, s, h, kvh, _, causal = main
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    for width in XW_TIMED_WIDTHS:
        shape = (b, s, h, kvh, width, causal)
        fns = Family(fa, fam, causal, width ** -0.5)
        q, k, v, do = _inputs(shape, seed)
        o, lse = fns.fwd(q, k, v)
        _, delta = fns.dq(q, k, v, o, lse, do)
        qb, kvb, stb = 2 * q.numel(), 2 * k.numel(), 4 * b * h * s
        work = ((4, 2 * qb + 2 * kvb + stb), (6, 4 * qb + 2 * kvb + 2 * stb),
                (8, 2 * qb + 4 * kvb + 2 * stb))
        notes = []
        for name, fn, (mul, nbytes) in zip(fns.names, (
                lambda: fns.fwd(q, k, v),
                lambda: fns.dq(q, k, v, o, lse, do),
                lambda: fns.dkv(q, k, v, do, lse, delta)), work):
            ms = time_ms(fn, 10)
            bound, by = _bound(mul * width * pairs, nbytes)
            rec = records[f"{name}@{XW_WIDTH}"]
            rec.setdefault("width_ms", {})[str(width)] = ms
            rec.setdefault("width_bound_ms", {})[str(width)] = bound
            notes.append(f"{name} {ms:.4f} ms (bound {bound:.4f} ms, {by}; "
                         f"{bound / ms:.1%}; {clock_note(CLOCKS.last())})")
        print(f"[kernels dxwide] {fam} at {shape}, "
              f"{fa.chunks(width)} CTAs an item: " + "; ".join(notes),
              flush=True)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()


def _sdpa_backend(shape, qkv, tag="[kernels d512]"):
    """Which of SDPA's backends take these inputs, each tried alone
    (torch.nn.attention.sdpa_kernel, forward), and the one its default
    dispatch ran: named from the CUDA kernels a profiled default call
    launched ("not identified" when the profiler saw none)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    causal, scale = shape[-1], shape[4] ** -0.5
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in qkv)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True)

    takes = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with torch.no_grad(), sdpa_kernel(backend):
                sdpa()
            takes.append(backend.name)
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        sdpa()
        torch.cuda.synchronize()
    names = [e.key for e in sorted(
        prof.key_averages(), key=lambda e: -e.device_time_total)
        if e.device_time_total > 0][:3]
    joined = " ".join(names).lower()
    picked = ("FLASH_ATTENTION" if "flash" in joined else
              "EFFICIENT_ATTENTION" if ("fmha" in joined
                                        or "efficient" in joined) else
              "CUDNN_ATTENTION" if "cudnn" in joined else
              "MATH" if names else "not identified")
    print(f"{tag} SDPA at {shape}: backends that take it {takes}; "
          f"the default call ran {picked} (kernels {names})", flush=True)
    return picked


def phase_wide_op(fa, attention_ops, records):
    """[wide op]: the public op past the resident budget at width 256,
    through autograd: causal, exactly one launch of each triangular
    kernel, non-causal one of each streamed kernel (their launches in the
    kernels line: per call of the op), each against its family's plain
    versions; then at PAD512_OP_SHAPES, the head_dims that pad to the
    width-512 kernels, and at XW_OP_SHAPES, head_dims past 512 padded to
    the cluster widths, one launch of each kernel of the caller's family
    (the resident and streamed calls at 512 and 1024 give their @512 and
    @1024 records' launches), against the plain versions at the caller's
    head_dim, and the padded columns of the kernels' outputs on the
    padded inputs exactly 0. Past width 2048 no kernel exists: head_dim
    REFUSED_HEAD_DIM must raise a ValueError naming it, before any
    launch."""
    b, s, h, kvh, d, _ = WIDE_OP_SHAPE
    for causal in (True, False):
        shape = (b, s, h, kvh, d, causal)
        fam = fa.TRIANGULAR if causal else fa.STREAMED
        check(fa.family(s, d, causal) == fam,
              f"{shape} does not take the {fam} family")
        fns = Family(fa, fam, causal, d ** -0.5)
        q, k, v, do = _inputs(shape, 49)
        fa.reset_launches()
        out, grads = _op_grads(attention_ops, q, k, v, causal, do)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        _expect_launches(fa, f"[wide op] attention(causal={causal})", shape,
                         fns.names)
        o_p, lse_p = fns.fwd_plain(q, k, v)
        dq_p, dk_p, dv_p = fns.bwd_plain(q, k, v, o_p, lse_p, do)
        _hold("[wide op]", shape, (("o", (out, o_p), OUT_REL_TOL),
                                   ("dq", (grads[0], dq_p), GRAD_REL_TOL),
                                   ("dk", (grads[1], dk_p), GRAD_REL_TOL),
                                   ("dv", (grads[2], dv_p), GRAD_REL_TOL)))
        if fam == fa.STREAMED:
            for name in fns.names:
                records[f"{name}@256"]["launches"] = launches[name]
        del q, k, v, do, out, grads, o_p, lse_p, dq_p, dk_p, dv_p
        torch.cuda.empty_cache()
    for idx, shape in enumerate(PAD512_OP_SHAPES + XW_OP_SHAPES):
        _op_at_width(fa, attention_ops, records, shape, 51 + idx)
    shape = (b, s, h, kvh, REFUSED_HEAD_DIM, True)
    q, k, v, do = _inputs(shape, 50)
    fa.reset_launches()
    try:
        _op_grads(attention_ops, q, k, v, True, do)
        msg = None
    except ValueError as exc:
        msg = str(exc)
    torch.cuda.synchronize()
    print(f"[wide op] attention(causal=True) at {shape}: ValueError "
          f"{msg!r}", flush=True)
    check(msg is not None and str(REFUSED_HEAD_DIM) in msg,
          f"the op at {shape} did not refuse head_dim {REFUSED_HEAD_DIM} "
          "by name")
    _expect_launches(fa, "[wide op]", shape, ())


def _op_at_width(fa, attention_ops, records, shape, seed):
    """The op at a head_dim that pads to 512 or past it
    (phase_wide_op)."""
    b, s, h, kvh, d, causal = shape
    fam = fa.family(s, d, causal)
    width = fa.kernel_head_dim(d)
    check(width >= 512, f"{shape} does not pad to 512 or past it")
    fns = Family(fa, fam, causal, d ** -0.5)
    q, k, v, do = _inputs(shape, seed)
    fa.reset_launches()
    out, grads = _op_grads(attention_ops, q, k, v, causal, do)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    _expect_launches(fa, f"[wide op] attention(causal={causal}) {fam}",
                     shape, fns.names)
    check(out.shape == q.shape and grads[1].shape == k.shape,
          "padded head_dim leaked out of the op")
    o_p, lse_p = fns.fwd_plain(q, k, v)
    dq_p, dk_p, dv_p = fns.bwd_plain(q, k, v, o_p, lse_p, do)
    _hold("[wide op]", shape, (("o", (out, o_p), OUT_REL_TOL),
                               ("dq", (grads[0], dq_p), GRAD_REL_TOL),
                               ("dk", (grads[1], dk_p), GRAD_REL_TOL),
                               ("dv", (grads[2], dv_p), GRAD_REL_TOL)))
    del out, grads, o_p, lse_p, dq_p, dk_p, dv_p
    if (d == 512 or width == XW_WIDTH) and fam != fa.TRIANGULAR:
        for name in fns.names:
            records[f"{name}@{width}"]["launches"] = launches[name]
    if d < width:
        o, _, dq, _, dk, dv = fns.run(
            *(fa.pad_head_dim(t, width) for t in (q, k, v, do)))
        torch.cuda.synchronize()
        zero = {n: bool((t[..., d:] == 0).all()) for n, t in
                (("o", o), ("dq", dq), ("dk", dk), ("dv", dv))}
        print(f"[wide op] {shape} {fns.names} at width {width}: columns "
              f"{d}-{width - 1} exactly 0 {zero}", flush=True)
        check(all(zero.values()), f"padded columns not 0 at {shape}")
        del o, dq, dk, dv
    del q, k, v, do
    torch.cuda.empty_cache()


def _time_streamed_forward(fa, fns, shape, qkv, records):
    """The streamed forward (the Hopper forward, each consumer's softmax
    overlapped with its own P V) at another family's main shape, timed in
    turns with that family's forward (the same body in lockstep): what the
    schedule would give there. Not used on that path."""
    causal, scale = shape[-1], shape[4] ** -0.5
    q, k, v = qkv
    name = fns.names[0]
    runs = {name: lambda: fns.fwd(q, k, v),
            "streamed": lambda: fa.flash_fwd_streamed(q, k, v, causal,
                                                      scale)}
    times = _in_turns(runs, name, "streamed")
    records[name]["streamed_instance_ms"] = times["streamed"]
    print(f"[kernels] flash_fwd_streamed at {shape}: {times['streamed']} ms "
          f"beside {name} {times[name]} ms (in turns)", flush=True)


def _in_turns(runs, a, b, reps=20):
    """runs[a] and runs[b] timed a, b, b, a: {key: [ms, ms]}, each timing
    printed with its clocks."""
    times = {key: [] for key in runs}
    for key in (a, b, b, a):
        times[key].append(time_ms(runs[key], reps))
        print(f"[kernels]   {key}: {times[key][-1]:.4f} ms; "
              f"{clock_note(CLOCKS.last())}", flush=True)
    return times


def _time_streamed_dq(fa, fam, fns, shape, inputs, saved, records):
    """The streamed dq (the Hopper dq with each consumer's Q and dO held
    in registers, exp2 on the natural-log lse) at another family's main
    shape, held against that family's dq there and timed in turns with it
    (the same body with both operands of S and dP read from shared
    memory; natural exp for the resident one, base 2 for the triangular
    one, the same work): what that instance would give those rows. Not
    used on their paths."""
    causal, scale = shape[-1], shape[4] ** -0.5
    q, k, v, do = inputs
    o, lse = saved
    # The streamed dq reads a natural-log lse; the triangular one is base 2.
    lse_e = lse * LN2 if fam == fa.TRIANGULAR else lse
    name = fns.names[1]
    runs = {name: lambda: fns.dq(q, k, v, o, lse, do),
            "streamed": lambda: fa.flash_dq_streamed(q, k, v, o, lse_e, do,
                                                     causal, scale)}
    (dq, _), (dq_s, _) = runs[name](), runs["streamed"]()
    torch.cuda.synchronize()
    _hold(f"[kernels] flash_dq_streamed vs {name}", shape,
          (("dq", (dq_s, dq), GRAD_REL_TOL),))
    times = _in_turns(runs, name, "streamed")
    records[name]["streamed_dq_instance_ms"] = times["streamed"]
    records[name]["ms_in_turns"] = times[name]
    print(f"[kernels] flash_dq_streamed at {shape}: {times['streamed']} ms "
          f"beside {name} {times[name]} ms (in turns)", flush=True)


def _check_deterministic(fns, inputs, saved, grads):
    """The backward pair again on the same inputs: no atomics, a fixed
    order of sums, so dq, dk and dv must be bit-identical."""
    q, k, v, do = inputs
    o, lse = saved
    dq, delta = fns.dq(q, k, v, o, lse, do)
    dk, dv = fns.dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip((dq, dk, dv), grads)]
    print(f"[kernels] {fns.names[1]}, {fns.names[2]} twice on the same "
          f"inputs: dq, dk, dv bit-identical {same}", flush=True)
    check(all(same), f"{fns.names[1]}/{fns.names[2]} are not deterministic")


def _check_f16(fns, shape, seed, records):
    """The family's f16 instances at its main shape, on f16 inputs,
    against the plain versions on the same inputs at the bf16 tolerances
    (f16 keeps more mantissa bits), and timed."""
    q, k, v, do = _inputs(shape, seed, torch.float16)
    o, lse, dq, delta, dk, dv = fns.run(q, k, v, do)
    torch.cuda.synchronize()
    check(all(t.dtype == torch.float16 for t in (o, dq, dk, dv)),
          "f16 kernels wrote another dtype")
    o_p, lse_p = fns.fwd_plain(q, k, v)
    dq_p, dk_p, dv_p = fns.bwd_plain(q, k, v, o, lse, do)
    _hold("[kernels] f16", shape, (
        ("o", (o, o_p), OUT_REL_TOL), ("lse", (lse, lse_p), OUT_REL_TOL),
        ("dq", (dq, dq_p), GRAD_REL_TOL), ("dk", (dk, dk_p), GRAD_REL_TOL),
        ("dv", (dv, dv_p), GRAD_REL_TOL)))
    del o_p, lse_p, dq_p, dk_p, dv_p
    for name, fn in zip(fns.names, (
            lambda: fns.fwd(q, k, v), lambda: fns.dq(q, k, v, o, lse, do),
            lambda: fns.dkv(q, k, v, do, lse, delta))):
        t = records[name]["f16_ms"] = time_ms(fn, 20)
        print(f"[kernels] {name} f16: {t:.4f} ms (bf16 "
              f"{records[name]['ms']:.4f} ms); {clock_note(CLOCKS.last())}",
              flush=True)


def _op_grads(attention_ops, q, k, v, causal, do=None):
    """The public op's output and autograd gradients of (q, k, v): of
    sum(out * do), or of sum(out ** 2) (the JAX reference tests' loss)
    when do is None."""
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention_ops.attention(*leaves, causal=causal)
    loss = (out * do).sum() if do is not None else (out.float() ** 2).sum()
    return out.detach(), torch.autograd.grad(loss, leaves)


F32_NAMES = ("flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32")


def _expect_launches(fa, label, shape, names, count=1):
    """The launch counts since the last reset: `count` of each of `names`,
    none of any other kernel."""
    launches = dict(fa.LAUNCHES)
    print(f"{label} {shape}: launches {launches}", flush=True)
    expect = dict.fromkeys(launches, 0)
    expect.update(dict.fromkeys(names, count))
    check(launches == expect, f"launch counts {launches} != {expect}")


def phase_ragged_op(fa, attention_ops):
    """The public attention op at a ragged S (a multiple of 8, not of the
    tiles), forward and autograd backward: it runs the resident kernels,
    one launch each, and matches the plain versions."""
    shape = RAGGED_OP_SHAPE
    b, s, h, kvh, d, causal = shape
    scale = d ** -0.5
    check(fa.family(s, d, causal) == fa.RESIDENT and s % fa.BWD_INNER,
          f"{shape} is not a ragged resident shape")
    q, k, v, do = _inputs(shape, 13)
    fa.reset_launches()
    out, grads = _op_grads(attention_ops, q, k, v, causal, do)
    torch.cuda.synchronize()
    _expect_launches(fa, f"[ragged op] attention(causal={causal})", shape,
                     RESIDENT_NAMES)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
    dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, o_p, lse_p, do, causal,
                                          scale)
    _hold("[ragged op]", shape, (("o", (out, o_p), OUT_REL_TOL),
                                 ("dq", (grads[0], dq_p), GRAD_REL_TOL),
                                 ("dk", (grads[1], dk_p), GRAD_REL_TOL),
                                 ("dv", (grads[2], dv_p), GRAD_REL_TOL)))


def _f32_backward(fa, q, k, v, o, lse, do, causal, scale):
    """The fp32 backward pair on a forward's (o, lse): (dq, delta, dk,
    dv)."""
    dq, delta = fa.flash_dq_f32(q, k, v, o, lse, do, causal, scale)
    dk, dv = fa.flash_dkv_f32(q, k, v, do, lse, delta, causal, scale)
    return dq, delta, dk, dv


def phase_f32_op(fa, attention_ops, records):
    """The public op with f32 inputs on the card: the fp32 kernels, one
    launch each, outputs and gradients in f32, within the JAX reference
    tests' elementwise bounds of the fp32 plain versions (matmuls in full
    fp32: TF32 off), at F32_OP_SHAPES and the fp32 backward's closing set;
    then at F32_TIMED_SHAPES the forward and the backward pair each
    bit-identical when run twice, and the fp32 kernels' times, each
    kernel's record (keyed "<name>@<shape>") added to records."""
    torch.backends.cuda.matmul.allow_tf32 = False
    split = []
    cases = F32_OP_SHAPES + F32_CLOSING_SHAPES
    for idx, shape in enumerate(cases):
        b, s, h, kvh, d, causal = shape
        scale = d ** -0.5
        q, k, v, _ = _inputs(shape, 20 + idx, torch.float32)
        fa.reset_launches()
        out, grads = _op_grads(attention_ops, q, k, v, causal)
        torch.cuda.synchronize()
        _expect_launches(fa, "[f32 op]", shape, F32_NAMES)
        check(out.dtype == torch.float32
              and all(g.dtype == torch.float32 for g in grads),
              "the op did not return f32 for f32 inputs")
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        ref = (o_p, *fa.flash_bwd_plain(q, k, v, o_p, lse_p, 2 * o_p,
                                        causal, scale))
        parts = (1 if h == kvh else fa.dkv_parts(
            b, s, kvh, h // kvh, causal, fa._sm_count(q.device), d, True))
        split.append(parts > 1)
        for name, got, want, tol in zip(
                ("o", "dq", "dk", "dv"), (out, *grads), ref,
                (F32_OUT_TOL, F32_GRAD_TOL, F32_GRAD_TOL, F32_GRAD_TOL)):
            excess = ((got - want).abs() - tol * want.abs()).max().item()
            print(f"[f32 op] {shape} {name}: max |err| - rtol |ref| "
                  f"{excess:.3e} (atol {tol}); dk/dv in {parts} part(s)",
                  flush=True)
            check(excess <= tol, f"f32 {name} outside rtol = atol = {tol} "
                  f"at {shape}")
        if idx >= len(F32_OP_SHAPES):
            continue
        # Not a gate: the same inputs rounded to f16 through the f16
        # kernels, against the same fp32 references, show why f32 has
        # kernels of its own.
        out16, grads16 = _op_grads(attention_ops, q.half(), k.half(),
                                   v.half(), causal)
        excess = [((got.float() - want).abs() - tol * want.abs()).max().item()
                  for got, want, tol in zip(
                      (out16, *grads16), ref,
                      (F32_OUT_TOL, F32_GRAD_TOL, F32_GRAD_TOL, F32_GRAD_TOL))]
        print(f"[f32 op] {shape} as f16 through the f16 kernels: max |err| - "
              f"rtol |ref| o {excess[0]:.3e}, dq {excess[1]:.3e}, dk "
              f"{excess[2]:.3e}, dv {excess[3]:.3e} (bounds {F32_OUT_TOL}, "
              f"{F32_GRAD_TOL})", flush=True)
    check(any(split), "no f32 case split the dk/dv's GQA group in parts")
    # The fp32 kernels' time at the slice's attention shape and at widths
    # 256 and 512 (not a path the port's bf16 models take: f32 is the
    # exact path, not the fast one), beside their bound at the card's
    # fp32 peak, the fp32 plain versions' and SDPA's; the forward and the
    # backward pair twice on the same inputs must agree bit for bit.
    for shape in F32_TIMED_SHAPES:
        q, k, v, do = _inputs(shape, 22, torch.float32)
        b, s, h, kvh, d, causal = shape
        scale = d ** -0.5
        o, lse = fa.flash_fwd_f32(q, k, v, causal, scale)
        o2, lse2 = fa.flash_fwd_f32(q, k, v, causal, scale)
        grads = _f32_backward(fa, q, k, v, o, lse, do, causal, scale)
        again = _f32_backward(fa, q, k, v, o, lse, do, causal, scale)
        delta = grads[1]
        torch.cuda.synchronize()
        same_fwd = torch.equal(o, o2) and torch.equal(lse, lse2)
        same = [torch.equal(x, y) for x, y in zip(grads, again)]
        print(f"[f32 op] fp32 forward twice at {shape}: o, lse bit-identical "
              f"{same_fwd}; backward twice: dq, delta, dk, dv bit-identical "
              f"{same}", flush=True)
        check(same_fwd, f"the fp32 forward is not deterministic at {shape}")
        check(all(same), f"the fp32 backward is not deterministic at {shape}")
        # Each kernel's largest error against the plain versions here.
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        ref = fa.flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
        errs = (max((o - o_p).abs().max().item(),
                    (lse - lse_p).abs().max().item()),
                (grads[0] - ref[0]).abs().max().item(),
                max((g - r).abs().max().item()
                    for g, r in zip(grads[2:], ref[1:])))
        del o2, lse2, grads, again, o_p, lse_p, ref
        times = (time_ms(lambda: fa.flash_fwd_f32(q, k, v, causal, scale),
                         3, warmup=1),
                 time_ms(lambda: fa.flash_dq_f32(q, k, v, o, lse, do, causal,
                                                 scale), 3, warmup=1),
                 time_ms(lambda: fa.flash_dkv_f32(q, k, v, do, lse, delta,
                                                  causal, scale), 3,
                         warmup=1))
        plain = (time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, scale),
                         3, warmup=1),
                 time_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do,
                                                    causal, scale), 3,
                         warmup=1))
        # SDPA in f32 (TF32 off), forward and whole backward: a yardstick
        # only.
        lib = _sdpa_ms(shape, (q, k, v, do), reps=3)
        pair = times[1] + times[2]
        lib_note = ("SDPA none" if lib[0] is None else
                    f"SDPA forward {lib[0]:.3f} ms, whole backward "
                    f"{lib[1]:.3f} ms (fp32 dq + dk/dv {pair:.3f} ms, "
                    f"{pair / lib[1]:.3f}x SDPA's)")
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        # Bytes: each input read once, each output written once (fp32).
        q_b, kv_b, st_b = 4 * q.numel(), 4 * k.numel(), 4 * b * h * s
        nbytes = (2 * q_b + 2 * kv_b + st_b,
                  4 * q_b + 2 * kv_b + 2 * st_b,
                  2 * q_b + 4 * kv_b + 2 * st_b)
        bounds = [max(n * d * pairs / PEAK_F32_FLOPS, nb / PEAK_BYTES_PER_S)
                  * 1e3 for n, nb in zip((4, 6, 8), nbytes)]
        shares = [bound / ms for bound, ms in zip(bounds, times)]
        print(f"[f32 op] fp32 kernels at {shape}: forward {times[0]:.3f} "
              f"ms, dq {times[1]:.3f} ms, dk/dv {times[2]:.3f} ms; bound "
              f"at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s fp32 "
              f"{bounds[0]:.3f} / {bounds[1]:.3f} / {bounds[2]:.3f} ms "
              f"(operations), shares {shares[0]:.1%} / {shares[1]:.1%} / "
              f"{shares[2]:.1%}; plain forward {plain[0]:.3f} ms, backward "
              f"{plain[1]:.3f} ms; {lib_note}", flush=True)
        fam = fa.family(s, d, causal)
        suffix = {fa.RESIDENT: "", fa.TRIANGULAR: "_tri",
                  fa.STREAMED: "_streamed"}[fam]
        tag = str(tuple(shape[:5])).replace(" ", "")
        for i, name in enumerate(F32_NAMES):
            kind = ("fwd", "dq", "dkv")[i]
            n_ops = (4, 6, 8)[i] * d * pairs
            records[f"{name}@{tag}"] = {
                "name": name, "route": "cuda",
                "source": f"{_CSRC}/flash_f32.cu",
                "replaces": TPU_KERNELS[f"flash_{kind}{suffix}"],
                # Set by [tiny]'s f32 training run, the port's f32 path.
                "launches": 0,
                "max_abs_err": errs[i], "ms": times[i],
                "plain_ms": plain[0] if i == 0 else plain[1],
                "bound_ms": bounds[i],
                "bound_by": ("operations" if n_ops / PEAK_F32_FLOPS
                             >= nbytes[i] / PEAK_BYTES_PER_S else "bytes"),
                "library_ms": lib[0] if i == 0 else lib[1],
                "plain_covers": "o, lse" if i == 0 else "dq, dk, dv",
                "library_covers": ("sdpa forward, f32" if i == 0 else
                                   "sdpa backward, f32: dq, dk, dv"),
                "flops": n_ops, "bytes": nbytes[i], "shape": list(shape),
                "head_dim": d, "dtype": "float32", "family": fam,
            }
        del q, k, v, do, o, lse, delta


def phase_pad_op(fa, attention_ops):
    """The public op at head_dims the kernels take zero-padded (16 -> 64,
    96 -> 128, 192 -> 256), bf16, through autograd: one launch of each
    kernel of the family the caller's shape takes (resident, or at 192 x
    4096 triangular), outputs and gradients of the caller's head_dim,
    against the plain versions at that head_dim; then the family's kernels
    on the padded inputs, whose padded columns must come out exactly 0."""
    for idx, shape in enumerate(PAD_OP_SHAPES):
        b, s, h, kvh, d, causal = shape
        scale = d ** -0.5
        check(d not in fa.HEAD_DIMS, f"{shape} needs no padding")
        fns = Family(fa, fa.family(s, d, causal), causal, scale)
        q, k, v, do = _inputs(shape, 30 + idx)
        fa.reset_launches()
        out, grads = _op_grads(attention_ops, q, k, v, causal, do)
        torch.cuda.synchronize()
        _expect_launches(fa, "[pad op]", shape, fns.names)
        check(out.shape == q.shape and grads[1].shape == k.shape,
              "padded head_dim leaked out of the op")
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, o_p, lse_p, do,
                                              causal, scale)
        _hold("[pad op]", shape, (("o", (out, o_p), OUT_REL_TOL),
                                  ("dq", (grads[0], dq_p), GRAD_REL_TOL),
                                  ("dk", (grads[1], dk_p), GRAD_REL_TOL),
                                  ("dv", (grads[2], dv_p), GRAD_REL_TOL)))
        width = fa.kernel_head_dim(d)
        o, _, dq, _, dk, dv = fns.run(
            *(fa.pad_head_dim(t, width) for t in (q, k, v, do)))
        torch.cuda.synchronize()
        zero = {n: bool((t[..., d:] == 0).all()) for n, t in
                (("o", o), ("dq", dq), ("dk", dk), ("dv", dv))}
        print(f"[pad op] {shape} {fns.names} at width {width}: columns "
              f"{d}-{width - 1} exactly 0 {zero}", flush=True)
        check(all(zero.values()), f"padded columns not 0 at {shape}")
        del q, k, v, do, out, grads, o_p, lse_p, dq_p, dk_p, dv_p


def phase_streamed_vs_resident(fa, records):
    """At seq 32768 no full plain version fits on the card: the streamed
    kernels are held against the resident kernels (the same function; the
    forward and dk/dv the same bodies in another schedule, dq another
    kernel), as the JAX package's test_streamed_kernels_match_resident
    holds its two families, and both are timed with few repetitions; then
    against the plain versions on a subset of rows
    (_check_streamed_subset)."""
    shape = STR_LONG_SHAPE
    b, s, h, kvh, d, causal = shape
    check(fa.family(s, d, causal) == fa.STREAMED,
          f"{shape} does not take the streamed family")
    q, k, v, do = _inputs(shape, 7)
    fams = {fam: Family(fa, fam, causal, d ** -0.5)
            for fam in (fa.STREAMED, fa.RESIDENT)}
    out = {fam: fns.run(q, k, v, do) for fam, fns in fams.items()}
    torch.cuda.synchronize()
    names = ("o", "lse", "dq", "delta", "dk", "dv")
    got, ref = out[fa.STREAMED], out[fa.RESIDENT]
    _hold("[kernels] streamed vs resident", shape, [
        (n, (got[i], ref[i]), OUT_REL_TOL if n in ("o", "lse")
         else GRAD_REL_TOL)
        for i, n in enumerate(names) if n != "delta"])
    times = {}
    for fam, fns in fams.items():
        o, lse, _, delta, _, _ = out[fam]
        times[fam] = [time_ms(lambda: fns.fwd(q, k, v), 2, warmup=1),
                      time_ms(lambda: fns.dq(q, k, v, o, lse, do), 2,
                              warmup=1),
                      time_ms(lambda: fns.dkv(q, k, v, do, lse, delta), 2,
                              warmup=1)]
        print(f"[kernels] {fam} kernels at {shape}: forward "
              f"{times[fam][0]:.3f} ms, dq {times[fam][1]:.3f} ms, dk/dv "
              f"{times[fam][2]:.3f} ms", flush=True)
    for i, name in enumerate(fams[fa.STREAMED].names):
        records[name]["seq32768_ms"] = times[fa.STREAMED][i]
        records[name]["seq32768_resident_ms"] = times[fa.RESIDENT][i]
    del ref, out
    torch.cuda.empty_cache()
    _check_streamed_subset(fa, shape, (q, k, v, do), got)
    del q, k, v, do, got
    torch.cuda.empty_cache()


def _check_streamed_subset(fa, shape, inputs, got):
    """The streamed kernels at seq 32768 against the plain versions, on
    the first and last STR_SUBSET_ROWS rows: o, lse and dq of those q rows
    of every head against all keys (dq from the kernels' o and lse, as in
    [kernels]), and dk and dv of those KV rows of every KV head over all q
    rows, from a plain o and lse built STR_PLAIN_CHUNK q rows at a time
    (delta = rowsum(dO * o) from that o)."""
    b, s, h, kvh, d, causal = shape
    scale = d ** -0.5
    q, k, v, do = inputs
    o, lse, dq, _, dk, dv = got
    n = STR_SUBSET_ROWS
    rows = torch.cat([torch.arange(n), torch.arange(s - n, s)]).to(q.device)
    o_p, lse_p = fa.flash_fwd_streamed_plain(q[:, rows], k, v, causal,
                                             scale)
    dq_p, _, _ = fa.flash_bwd_streamed_plain(
        q[:, rows], k, v, o[:, rows], lse[:, :, rows], do[:, rows], causal,
        scale)
    label = f"[kernels] streamed vs plain, q rows 0-{n - 1} and {s - n}-" \
            f"{s - 1},"
    _hold(label, shape, (("o", (o[:, rows], o_p), OUT_REL_TOL),
                         ("lse", (lse[:, :, rows], lse_p), OUT_REL_TOL),
                         ("dq", (dq[:, rows], dq_p), GRAD_REL_TOL)))
    del o_p, lse_p, dq_p
    o_all = torch.empty_like(q)
    lse_all = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for c0 in range(0, s, STR_PLAIN_CHUNK):
        c = slice(c0, c0 + STR_PLAIN_CHUNK)
        o_all[:, c], lse_all[:, :, c] = fa.flash_fwd_streamed_plain(
            q[:, c], k, v, causal, scale)
    _, dk_p, dv_p = fa.flash_bwd_streamed_plain(
        q, k[:, rows], v[:, rows], o_all, lse_all, do, causal, scale)
    label = f"[kernels] streamed vs plain, kv rows 0-{n - 1} and {s - n}-" \
            f"{s - 1},"
    _hold(label, shape, (("dk", (dk[:, rows], dk_p), GRAD_REL_TOL),
                         ("dv", (dv[:, rows], dv_p), GRAD_REL_TOL)))


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _sdpa_ms(shape, inputs, reps=20):
    """Library yardstick: SDPA's forward and whole backward (dq, dk, dv)
    on the same inputs, in its own (B, H, S, D) layout, GQA native; (None,
    None), printed, where PyTorch has no SDPA kernel for the shape."""
    causal, scale = shape[-1], shape[4] ** -0.5
    q, k, v, do = inputs
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True)

    try:
        with torch.no_grad():
            lib_fwd = time_ms(sdpa, reps)
        out = sdpa()
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), reps)
        del out
    except RuntimeError as exc:
        print(f"[kernels] SDPA at {shape}: no kernel ({exc})", flush=True)
        return None, None
    return lib_fwd, lib_bwd


def _measure(fns, shape, inputs, saved, errs):
    b, s, h, kvh, d, causal = shape
    scale = d ** -0.5
    q, k, v, do = inputs
    o, lse, delta = saved
    fwd_name, dq_name, dkv_name = fns.names
    # Work this run's inputs need: the (q, k) pairs the causal mask keeps.
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    q_bytes, kv_bytes, stat_bytes = 2 * q.numel(), 2 * k.numel(), 4 * b * h * s
    work = {
        fwd_name: (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + stat_bytes),
        dq_name: (6 * d * pairs, 4 * q_bytes + 2 * kv_bytes + 2 * stat_bytes),
        dkv_name: (8 * d * pairs, 2 * q_bytes + 4 * kv_bytes
                   + 2 * stat_bytes),
    }
    kernel_ms, clocks = {}, {}
    for name, fn in ((fwd_name, lambda: fns.fwd(q, k, v)),
                     (dq_name, lambda: fns.dq(q, k, v, o, lse, do)),
                     (dkv_name, lambda: fns.dkv(q, k, v, do, lse, delta))):
        kernel_ms[name] = time_ms(fn, 20)
        clocks[name] = CLOCKS.last()
    plain_fwd = time_ms(lambda: fns.fwd_plain(q, k, v), 3, warmup=1)
    plain_bwd = time_ms(lambda: fns.bwd_plain(q, k, v, o, lse, do), 3,
                        warmup=1)
    lib_fwd, lib_bwd = _sdpa_ms(shape, inputs)
    records = {}
    for name, err_keys in ((fwd_name, ("o", "lse")), (dq_name, ("dq",)),
                           (dkv_name, ("dk", "dv"))):
        flops, nbytes = work[name]
        bound_ms, bound_by = _bound(flops, nbytes)
        max_abs = max(errs[k][1] for k in err_keys)
        fwd = name == fwd_name
        records[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": 0,
            "max_abs_err": max_abs, "ms": kernel_ms[name],
            "plain_ms": plain_fwd if fwd else plain_bwd,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_fwd if fwd else lib_bwd,
            # The plain backward and SDPA's backward each compute dq, dk
            # and dv in one call; the dq and dk/dv rows share them.
            "plain_covers": "o, lse" if fwd else "dq, dk, dv",
            "library_covers": "sdpa forward" if fwd
                              else "sdpa backward: dq, dk, dv",
            "flops": flops, "bytes": nbytes, "shape": list(shape),
            "head_dim": d,
            # Medians of nvidia-smi's samples around the kernel's timing.
            "sm_clock_mhz": clocks[name] and clocks[name]["sm_mhz"],
            "power_w": clocks[name] and clocks[name]["power_w"],
        }
        lib = records[name]["library_ms"]
        print(f"[kernels] {name} (D={d}): {kernel_ms[name]:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), "
              f"{flops / kernel_ms[name] / 1e9:.1f} TFLOP/s, plain "
              f"{records[name]['plain_ms']:.3f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}; "
              f"{clock_note(clocks[name])}", flush=True)
    return records


def phase_streamed(fa, attention_ops, records):
    """The slice's path: the public attention op, non-causal, past the
    resident budget, forward and backward under autograd."""
    shape = STR_MAIN_SHAPE
    b, s, h, kvh, d, causal = shape
    scale = d ** -0.5
    check(fa.family(s, d, causal) == fa.STREAMED,
          f"{shape} does not take the streamed family")
    q, k, v, do = _inputs(shape, 11)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launches()
    out = attention_ops.attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    print(f"[streamed] attention(causal=False) at {shape}: launches "
          f"{launches}", flush=True)
    expect = dict.fromkeys(launches, 0)
    expect.update(dict.fromkeys(STREAMED_NAMES, 1))
    check(launches == expect, f"launch counts {launches} != {expect} "
          "(one streamed forward, dq and dk/dv, nothing else)")
    for name, t, ref in (("o", out, q), ("dq", grads[0], q),
                         ("dk", grads[1], k), ("dv", grads[2], v)):
        check(t.shape == ref.shape and t.dtype == torch.bfloat16
              and bool(torch.isfinite(t).all()),
              f"bad {name} from the attention op")
    o_p, lse_p = fa.flash_fwd_streamed_plain(q, k, v, causal, scale)
    dq_p, dk_p, dv_p = fa.flash_bwd_streamed_plain(q, k, v, o_p, lse_p, do,
                                                   causal, scale)
    _hold("[streamed]", shape, (("o", (out, o_p), OUT_REL_TOL),
                              ("dq", (grads[0], dq_p), GRAD_REL_TOL),
                              ("dk", (grads[1], dk_p), GRAD_REL_TOL),
                              ("dv", (grads[2], dv_p), GRAD_REL_TOL)))
    for name in STREAMED_NAMES:
        records[name]["launches"] = launches[name]


def phase_slice(fa, llama, trainer, records):
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=N_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device="cuda",
                           generator=gen)
    batch = {"tokens": tokens}
    tx = trainer.make_optimizer(trainer.TrainConfig(warmup_steps=1,
                                                    total_steps=100))
    state = trainer.init_train_state(params, tx)
    step = trainer.make_train_step(
        lambda p, t: llama.forward(cfg, p, t), tx, with_grad_norm=False)
    print(f"[slice] llama3_8b width, {N_LAYERS} layers, "
          f"{cfg.num_params() / 1e9:.3f} B params, batch {BATCH} x seq "
          f"{SEQ}, bf16, remat {cfg.remat_policy}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    losses = [float(x) for x in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"[slice] losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"[slice] launches {launches}", flush=True)
    check(all(x == x and abs(x) != float("inf") for x in losses),
          "non-finite loss")
    check(losses[-1] < losses[0], "loss did not fall")
    expect = dict.fromkeys(launches, 0)
    expect.update({"flash_fwd": 2 * N_LAYERS * TRAIN_STEPS,
                   "flash_dq": N_LAYERS * TRAIN_STEPS,
                   "flash_dkv": N_LAYERS * TRAIN_STEPS})
    check(launches == expect, f"launch counts {launches} != {expect} "
          "(2L resident forward under full remat, L dq, L dk/dv per step)")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tok_s = BATCH * SEQ / steady
    tflops = cfg.flops_per_token(SEQ) * tok_s / 1e12
    print(f"[slice] step {steady * 1e3:.1f} ms (median of steps 2-"
          f"{TRAIN_STEPS}; first {step_s[0] * 1e3:.1f} ms), {tok_s:.0f} "
          f"tokens/s, {tflops:.1f} model TFLOP/s (6N + attention), peak "
          f"memory {peak_gb:.2f} GB", flush=True)
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        records[name]["launches"] = launches[name]
        records[name]["step_ms"] = steady * 1e3

    # One forward through the kernels against the reference attention,
    # same trained weights, loss in fp32.
    with torch.no_grad():
        out = {}
        for impl in ("kernel", "reference"):
            c = dataclasses.replace(cfg, attention_impl=impl, remat=False)
            logits = llama.forward(c, state.params, tokens)
            check(logits.shape == (BATCH, SEQ, cfg.vocab_size)
                  and logits.dtype == torch.float32
                  and bool(torch.isfinite(logits).all()),
                  f"bad logits from impl={impl}")
            out[impl] = float(trainer.cross_entropy_loss(
                logits[:, :-1], tokens[:, 1:]))
            del logits
    diff = abs(out["kernel"] - out["reference"])
    print(f"[slice] loss kernel {out['kernel']:.5f} reference "
          f"{out['reference']:.5f} |diff| {diff:.2e} (tol {LOSS_TOL})",
          flush=True)
    check(diff <= LOSS_TOL, "kernel forward disagrees with the reference")


def _slice_setup(llama, dev="cuda"):
    """[slice]'s weights and tokens, from its seed."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=N_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device=dev,
                           generator=gen)
    return cfg, params, tokens


def _timed_steps(fa, step, state, batch):
    """TRAIN_STEPS steps from zeroed launch counts: (losses, step seconds,
    launches)."""
    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return [float(x) for x in losses], step_s, dict(fa.LAUNCHES)


def _steady_ms(step_s):
    rest = sorted(step_s[1:])
    return rest[len(rest) // 2] * 1e3


def phase_parallel(fa, llama, trainer, attention_ops):
    """The training-across-ranks layer on the one card: the env
    bring-up, a world-1 NCCL mesh of every training axis, the sharded
    step against the one-device step from the same weights, the ring's
    fallback and its chunk arithmetic at full size, and the pipeline's
    fallback."""
    import torch.distributed as dist

    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import ring_attention
    from skypilot_tpu_torch.train import distributed
    t_phase = time.perf_counter()
    ctx = distributed.initialize_from_env()
    print(f"[parallel] env context {ctx}", flush=True)
    check(not ctx.initialized and not ctx.is_multiprocess,
          "initialize_from_env brought up a group on one process")
    mesh = mesh_lib.make_mesh(PAR_AXES)
    print(f"[parallel] mesh {mesh}: backend {dist.get_backend()}, world "
          f"size {dist.get_world_size()}", flush=True)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "the world-1 mesh is not an NCCL group of one process")
    rules = mesh_lib.DEFAULT_RULES
    try:
        _parallel_step(fa, llama, trainer, mesh, rules)
        _parallel_ring(ring_attention, attention_ops)
    finally:
        dist.destroy_process_group()
    print(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def _parallel_step(fa, llama, trainer, mesh, rules):
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cfg, params, tokens = _slice_setup(llama)
    plain = copy.deepcopy(params)
    batch = {"tokens": tokens}
    tcfg = trainer.TrainConfig(warmup_steps=1, total_steps=100)
    tx = trainer.make_optimizer(tcfg)
    state = trainer.init_train_state(plain, tx)
    step = trainer.make_train_step(lambda p, t: llama.forward(cfg, p, t), tx,
                                   with_grad_norm=False)
    losses_1, step_1, _ = _timed_steps(fa, step, state, batch)
    del state, step
    tx = trainer.make_optimizer(tcfg)
    state = trainer.init_train_state(params, tx)
    state = trainer.place_state(state, trainer.state_shardings(
        mesh, rules, llama.param_specs(cfg), state), tx)
    step = trainer.make_train_step(lambda p, t: llama.forward(cfg, p, t), tx,
                                   with_grad_norm=False, mesh=mesh,
                                   rules=rules)
    losses, step_s, launches = _timed_steps(fa, step, state, batch)
    print(f"[parallel] sharded step losses {[round(x, 4) for x in losses]}"
          f"; one-device {[round(x, 4) for x in losses_1]}", flush=True)
    print(f"[parallel] sharded step launches {launches}", flush=True)
    check(_finite(losses) and losses[-1] < losses[0],
          "sharded step: non-finite loss or loss did not fall")
    worst = max(abs(a - b) for a, b in zip(losses, losses_1))
    check(worst <= LOSS_TOL, f"sharded step loss off the one-device step's "
          f"by {worst:.3e} (tol {LOSS_TOL})")
    check(launches == _step_expect(launches, N_LAYERS, TRAIN_STEPS),
          f"sharded step launch counts {launches} (2L resident forward, L "
          "dq, L dk/dv per step)")
    with torch.no_grad():
        diff = max((p.full_tensor().float() - q.float()).abs().max().item()
                   for p, q in zip(state.params.parameters(),
                                   plain.parameters()))
    print(f"[parallel] sharded vs one-device: largest loss |diff| "
          f"{worst:.3e} (tol {LOSS_TOL}), largest parameter |diff| after "
          f"{TRAIN_STEPS} steps {diff:.3e}; step {_steady_ms(step_s):.1f} ms"
          f" sharded (world 1, DTensor + NCCL) vs "
          f"{_steady_ms(step_1):.1f} ms one-device (median of steps 2-"
          f"{TRAIN_STEPS})", flush=True)
    del plain

    # The ring at sp 1 falls back to the flash op; the pipeline at pp 1 to
    # the layers in turn. Both on the trained, placed weights.
    fwd_cfg = dataclasses.replace(cfg, remat=False)
    loss = {}
    with torch.no_grad(), mesh_lib.use_mesh(mesh, rules):
        for impl in ("auto", "ring"):
            fa.reset_launches()
            logits = llama.forward(dataclasses.replace(
                fwd_cfg, attention_impl=impl), state.params, tokens)
            launches = dict(fa.LAUNCHES)
            loss[impl] = float(trainer.cross_entropy_loss(
                logits[:, :-1], tokens[:, 1:]))
            print(f"[parallel] forward impl={impl}: loss {loss[impl]:.5f}, "
                  f"launches {launches}", flush=True)
            expect = dict.fromkeys(launches, 0)
            expect["flash_fwd"] = N_LAYERS
            check(launches == expect, f"impl={impl} forward launches "
                  f"{launches} != {expect}")
            if impl == "auto":
                ref = logits
            del logits
    check(abs(loss["ring"] - loss["auto"]) <= LOSS_TOL,
          "ring at sp 1 disagrees with the flash op")
    with torch.no_grad():
        piped = llama.forward_pipelined(fwd_cfg, state.params, tokens,
                                        mesh=mesh, rules=rules,
                                        num_microbatches=2)
    rel = _rel([piped], [ref])
    print(f"[parallel] forward_pipelined (2 microbatches, pp 1) vs forward: "
          f"logits rel {rel:.3e} (tol {PIPE_REL_TOL})", flush=True)
    check(piped.shape == ref.shape and rel <= PIPE_REL_TOL,
          "forward_pipelined disagrees with forward")
    del piped, ref, state


def _parallel_ring(ring_attention, attention_ops):
    for causal in (True, False):
        shape = RING_SHAPE + (causal,)
        q, k, v, do = _inputs(shape, 11)

        def ring_grads():
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = ring_attention.ring_chunks(*leaves, RING_CHUNKS,
                                             causal=causal)
            return out.detach(), torch.autograd.grad((out * do).sum(),
                                                     leaves)

        out, grads = ring_grads()
        ref, ref_grads = _op_grads(attention_ops, q, k, v, causal, do)
        label = f"[parallel] ring x{RING_CHUNKS}"
        _hold(label, shape,
              [("o", (out, ref), OUT_REL_TOL)] +
              [(n, (g, r), GRAD_REL_TOL) for n, g, r in
               zip(("dq", "dk", "dv"), grads, ref_grads)])
        del out, grads, ref, ref_grads
        with torch.no_grad():
            ring_fwd = time_ms(lambda: ring_attention.ring_chunks(
                q, k, v, RING_CHUNKS, causal=causal), 3, warmup=1)
            op_fwd = time_ms(lambda: attention_ops.attention(
                q, k, v, causal=causal), 5, warmup=1)
        ring_all = time_ms(ring_grads, 3, warmup=1)
        op_all = time_ms(lambda: _op_grads(attention_ops, q, k, v, causal,
                                           do), 5, warmup=1)
        print(f"{label} {shape}: forward {ring_fwd:.2f} ms vs the flash op "
              f"{op_fwd:.2f} ms; forward + backward {ring_all:.2f} ms vs "
              f"{op_all:.2f} ms", flush=True)
        del q, k, v, do
        torch.cuda.empty_cache()


def phase_long_context(fa, llama, trainer, records):
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=LC_LAYERS, max_seq_len=LC_SEQ,
                              remat_policy=LC_POLICY)
    check(fa.family(LC_SEQ, cfg.head_dim, True) == fa.TRIANGULAR,
          f"seq {LC_SEQ} does not take the triangular family")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = llama.init(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (LC_BATCH, LC_SEQ),
                           device="cuda", generator=gen)
    batch = {"tokens": tokens}
    tx = trainer.make_optimizer(trainer.TrainConfig(warmup_steps=1,
                                                    total_steps=100))
    state = trainer.init_train_state(params, tx)
    step = trainer.make_train_step(
        lambda p, t: llama.forward(cfg, p, t), tx,
        trunk_fn=lambda p, t: llama.forward_trunk(cfg, p, t),
        head_fn=llama.head_weights, with_grad_norm=False)
    print(f"[long] llama3_8b width, {LC_LAYERS} layers, "
          f"{cfg.num_params() / 1e9:.3f} B params, batch {LC_BATCH} x seq "
          f"{LC_SEQ}, bf16, remat {cfg.remat_policy}, chunked CE "
          f"({trainer.CE_CHUNK}-row chunks)", flush=True)

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    losses = [float(x) for x in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"[long] losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"[long] launches {launches}", flush=True)
    check(all(x == x and abs(x) != float("inf") for x in losses),
          "non-finite loss")
    check(losses[-1] < losses[0], "loss did not fall")
    expect = dict.fromkeys(launches, 0)
    expect.update(dict.fromkeys(TRI_NAMES, LC_LAYERS * TRAIN_STEPS))
    check(launches == expect, f"launch counts {launches} != {expect} "
          "(L triangular forward, dq and dk/dv per step, no other)")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tok_s = LC_BATCH * LC_SEQ / steady
    tflops = cfg.flops_per_token(LC_SEQ) * tok_s / 1e12
    print(f"[long] step {steady * 1e3:.1f} ms (median of steps 2-"
          f"{TRAIN_STEPS}; first {step_s[0] * 1e3:.1f} ms), {tok_s:.0f} "
          f"tokens/s, {tflops:.1f} model TFLOP/s (6N + attention), peak "
          f"memory {peak_gb:.2f} GB", flush=True)
    for name in TRI_NAMES:
        records[name]["launches"] = launches[name]
        records[name]["step_ms"] = steady * 1e3

    # One forward loss through the kernels against the reference attention
    # (fp32 scores, ~9 GB per layer at this length, freed layer by layer
    # under no_grad), same trained weights, chunked loss in fp32.
    with torch.no_grad():
        out = {}
        for impl in ("kernel", "reference"):
            c = dataclasses.replace(cfg, attention_impl=impl, remat=False)
            hidden = llama.forward_trunk(c, state.params, tokens)
            check(hidden.shape == (LC_BATCH, LC_SEQ, cfg.dim)
                  and bool(torch.isfinite(hidden).all()),
                  f"bad hidden states from impl={impl}")
            out[impl] = float(trainer.chunked_cross_entropy_loss(
                hidden[:, :-1], llama.head_weights(state.params),
                tokens[:, 1:]))
            del hidden
    diff = abs(out["kernel"] - out["reference"])
    print(f"[long] loss kernel {out['kernel']:.5f} reference "
          f"{out['reference']:.5f} |diff| {diff:.2e} (tol {LOSS_TOL})",
          flush=True)
    check(diff <= LOSS_TOL, "kernel forward disagrees with the reference")
    return losses


# ----------------------------------------------------------- [parallel_tp]
# The sharded step's meshes and policies beyond world 1 on the one card:
# two processes on cuda:0 over a gloo group, as [tp_serve]'s are (NCCL
# refuses two ranks on one device). gloo on CUDA tensors (torch 2.11)
# carries all_reduce, all_gather, broadcast and reduce-scatter, but
# DTensor's all-gather of a shard (Shard -> Replicate) kills the process,
# and so do point-to-point sends: so the tp legs replicate the vocabulary
# over tp (PTP_RULES: the embedding and head whole on every rank, the
# layers split as DEFAULT_RULES split them), and the pipeline leg runs on
# cards of their own (tools/torch_parallel_cards.py pipe) with only its
# place_state part here, at world 1 over NCCL. Legs: (a) [long]'s
# configuration and seed on {tp: 2}, held to [long]'s first PTP_STEPS
# losses; (b) [slice]'s on {tp: 2} with rank-PTP_LORA_RANK adapters on
# PTP_LORA_TARGETS (B drawn nonzero, so the first step's A gradients are
# too), remat save_flash, against the one-device step from the same
# weights: losses, the first step's adapter gradients (norm-relative,
# GRAD_REL_TOL) and the final adapters (LOSS_TOL); (c) (a)'s model on
# {sp: 2}, attention_impl="kernel", full remat, held to [long]'s losses
# (the remat policy does not change the function); (d) an adafactor state
# placed after one one-device step, then PTP_STEPS - 1 steps on a world-1
# mesh, against the one-device steps.
PTP_RANKS, PTP_BACKEND = 2, "gloo"
PTP_STEPS = 3
PTP_LORA_RANK, PTP_LORA_SEED = 8, 23
PTP_LORA_TARGETS = ("wq", "wk", "wv", "wo")


def _ptp_rules(mesh_lib):
    return mesh_lib.ShardingRules(rules={**mesh_lib.DEFAULT_RULES.rules,
                                         "vocab": None})


def _ptp_lora(cfg, dev):
    """The adapters of leg (b): the LoRA recipe's init (A ~ N(0, 1/in)),
    B drawn N(0, 0.02^2) from the next seed."""
    from skypilot_tpu_torch.recipes import llama_lora
    lora = llama_lora.init_lora(cfg, PTP_LORA_RANK, torch.Generator(
        ).manual_seed(PTP_LORA_SEED), PTP_LORA_TARGETS, device=dev)
    gen = torch.Generator().manual_seed(PTP_LORA_SEED + 1)
    with torch.no_grad():
        for lp in lora.layers:
            for name, p in lp.named_parameters():
                if name.endswith("_lora_b"):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return lora


def _ptp_model(leg, llama, dev):
    """A leg's (cfg, params, tokens, adapter names) from its seed, as its
    one-device reference draws them ([long]'s, [slice]'s)."""
    cfg = leg["cfg"]
    gen = torch.Generator(device=dev).manual_seed(leg["seed"])
    params = llama.init(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, leg["batch"], device=dev,
                           generator=gen)
    names = []
    if leg.get("lora"):
        from skypilot_tpu_torch.recipes import llama_lora
        lora = _ptp_lora(cfg, dev)
        params.requires_grad_(False)
        llama_lora.merge_params(params, lora)
        names = [f"layers.{i}.{n}" for i, lp in enumerate(lora.layers)
                 for n, _ in lp.named_parameters()]
    return cfg, params, tokens, names


class _GradTap:
    """An optimizer whose first update_ keeps a copy of the gradients it is
    given (before the clip), by parameter name."""

    def __init__(self, tx, module, names):
        self.tx, self.module, self.names = tx, module, set(names)
        self.grads = None

    def init(self, module):
        return self.tx.init(module)

    def update_(self, params, grads, state, g_norm=None):
        if self.grads is None:
            # By the module's names now: place_state replaces parameters.
            ids = {id(p): n for n, p in self.module.named_parameters()}
            self.grads = {ids[id(p)]: (g.to_local() if hasattr(
                g, "to_local") else g).float().cpu()
                for p, g in zip(params, grads) if ids[id(p)] in self.names}
        self.tx.update_(params, grads, state, g_norm)


def _ptp_train(leg, llama, trainer, fa, dev, mesh=None, rules=None):
    """PTP_STEPS steps of a leg from zeroed launch counts: losses, grad
    norms, step seconds, launches; with adapters, the first step's
    adapter gradients and the final adapters."""
    cfg, params, tokens, names = _ptp_model(leg, llama, dev)
    tx = _GradTap(trainer.make_optimizer(trainer.TrainConfig(
        warmup_steps=1, total_steps=100)), params, names)
    state = trainer.init_train_state(params, tx)
    if mesh is not None:
        state = trainer.place_state(state, trainer.state_shardings(
            mesh, rules, llama.param_specs(cfg), state), tx)
    kw = dict(mesh=mesh, rules=rules)
    if leg.get("chunked"):
        kw.update(trunk_fn=lambda p, t: llama.forward_trunk(cfg, p, t),
                  head_fn=llama.head_weights)
    step = trainer.make_train_step(lambda p, t: llama.forward(cfg, p, t),
                                   tx, **kw)
    fa.reset_launches()
    losses, norms, step_s = [], [], []
    for _ in range(PTP_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
    out = {"losses": losses, "norms": norms, "step_s": step_s,
           "launches": dict(fa.LAUNCHES), "grads": tx.grads}
    named = dict(state.params.named_parameters())
    out["adapters"] = {n: (named[n].to_local() if hasattr(
        named[n], "to_local") else named[n]).detach().float().cpu()
        for n in names}
    return out


def _ptp_rank_main(work: pathlib.Path, rank: int, addr: str) -> int:
    """``chip_smoke.py ptp-rank <dir> <rank> <addr>``: one rank of
    [parallel_tp]'s legs (``<dir>/job.pkl``) on cuda:0; writes
    ``<dir>/result<rank>.pkl``."""
    import pickle
    from datetime import timedelta

    import torch.distributed as dist
    os.environ["STPU_TUNE_MANIFEST"] = "0"
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.train import trainer
    job = pickle.loads((work / "job.pkl").read_bytes())
    dev = job[0]["device"]
    if dev.startswith("cuda"):
        torch.cuda.set_device(dev)
    dist.init_process_group(PTP_BACKEND, init_method=f"tcp://{addr}",
                            rank=rank, world_size=PTP_RANKS,
                            timeout=timedelta(seconds=300))
    out = {"backend": dist.get_backend()}
    try:
        for leg in job:
            mesh = mesh_lib.make_mesh(leg["axes"], device=dev)
            rules = (_ptp_rules(mesh_lib) if leg["tp_rules"]
                     else mesh_lib.DEFAULT_RULES)
            out[leg["name"]] = _ptp_train(leg, llama, trainer, fa, dev, mesh,
                                          rules)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    (work / f"result{rank}.pkl").write_bytes(pickle.dumps(out))
    return 0


def _ptp_run_ranks(work, job, timeout=600):
    """[parallel_tp]'s rank legs in PTP_RANKS processes of this script on
    the card; every rank's results."""
    import pickle
    from skypilot_tpu_torch.serve import gang_replica
    (work / "job.pkl").write_bytes(pickle.dumps(job))
    addr = gang_replica.free_addr()
    logs = [open(work / f"rank{r}.log", "wb") for r in range(PTP_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "ptp-rank", str(work),
         str(r), addr], stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if rcs != [0] * PTP_RANKS:
        for r in range(PTP_RANKS):
            tail = (work / f"rank{r}.log").read_text(errors="replace")
            print(f"[parallel_tp] rank {r} log tail:\n{tail[-3000:]}",
                  file=sys.stderr, flush=True)
    check(rcs == [0] * PTP_RANKS,
          f"[parallel_tp] rank processes exited {rcs}")
    return [pickle.loads((work / f"result{r}.pkl").read_bytes())
            for r in range(PTP_RANKS)]


def _ptp_replace(llama, trainer, mesh_lib, card, dev):
    """Leg (d)'s place-state part at world 1: an adafactor state placed
    onto a world-1 NCCL mesh after one one-device step, then two steps
    there, against three one-device steps from a copy of the weights."""
    import torch.distributed as dist
    cfg, params, tokens = _slice_setup(llama, dev)
    plain = copy.deepcopy(params)
    tcfg = trainer.TrainConfig(warmup_steps=1, total_steps=100,
                               optimizer="adafactor")
    batch = {"tokens": tokens}

    def one_device(p):
        tx = trainer.make_optimizer(tcfg)
        return tx, trainer.init_train_state(p, tx), trainer.make_train_step(
            lambda q, t: llama.forward(cfg, q, t), tx)
    tx, state, step = one_device(plain)
    want = []
    for _ in range(PTP_STEPS):
        state, m = step(state, batch)
        want.append(float(m["loss"]))
    del state, step, plain
    tx, state, step = one_device(params)
    state, m = step(state, batch)
    got = [float(m["loss"])]
    mesh = mesh_lib.make_mesh(PAR_AXES, device=dev)
    try:
        rules = mesh_lib.DEFAULT_RULES
        state = trainer.place_state(state, trainer.state_shardings(
            mesh, rules, llama.param_specs(cfg), state), tx)
        step = trainer.make_train_step(
            lambda q, t: llama.forward(cfg, q, t), tx, mesh=mesh,
            rules=rules)
        for _ in range(PTP_STEPS - 1):
            state, m = step(state, batch)
            got.append(float(m["loss"]))
    finally:
        dist.destroy_process_group()
    worst = max(abs(a - b) for a, b in zip(got, want))
    print(f"[parallel_tp] (d) adafactor state placed on a world-1 mesh "
          f"after one one-device step: losses {[round(x, 4) for x in got]}"
          f"; one-device {[round(x, 4) for x in want]}; largest |diff| "
          f"{worst:.3e} (tol {LOSS_TOL}) ({card})", flush=True)
    check(_finite(got) and worst <= LOSS_TOL, "[parallel_tp] (d) the placed "
          "adafactor state's steps are off the one-device steps'")
    del state, step, params


def phase_parallel_tp(fa, llama, trainer, card, lc_losses, dev="cuda"):
    """[parallel_tp] (module docstring, phase 6b): legs (a)-(c) on two
    ranks sharing cuda:0 over gloo, (d)'s place_state at world 1."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    t0 = time.perf_counter()
    dev = "cuda:0" if dev == "cuda" else dev
    _ptp_replace(llama, trainer, mesh_lib, card, dev)
    torch.cuda.empty_cache()
    lc_cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                                 n_layers=LC_LAYERS, max_seq_len=LC_SEQ,
                                 remat_policy=LC_POLICY)
    sl_cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                                 n_layers=N_LAYERS)
    legs = {
        "a": dict(cfg=lc_cfg, seed=1, batch=(LC_BATCH, LC_SEQ),
                  chunked=True, axes={"tp": PTP_RANKS}, tp_rules=True),
        "b": dict(cfg=dataclasses.replace(sl_cfg, remat_policy="save_flash"),
                  seed=0, batch=(BATCH, SEQ), lora=True,
                  axes={"tp": PTP_RANKS}, tp_rules=True),
        "c": dict(cfg=dataclasses.replace(lc_cfg, attention_impl="kernel",
                                          remat_policy="full"),
                  seed=1, batch=(LC_BATCH, LC_SEQ), chunked=True,
                  axes={"sp": PTP_RANKS}, tp_rules=False),
    }
    one_b = _ptp_train(legs["b"], llama, trainer, fa, dev)
    gc.collect()
    torch.cuda.empty_cache()
    work = pathlib.Path(tempfile.mkdtemp(prefix="stpu_parallel_tp_"))
    try:
        t1 = time.perf_counter()
        ranks = _ptp_run_ranks(work, [dict(leg, name=k, device=dev)
                                      for k, leg in legs.items()])
        ranks_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[parallel_tp] {PTP_RANKS} ranks on cuda:0 over "
          f"{ranks[0]['backend']}; rank legs {ranks_s:.1f} s ({card})",
          flush=True)
    refs = {"a": lc_losses[:PTP_STEPS], "b": one_b["losses"],
            "c": lc_losses[:PTP_STEPS]}
    kinds = {"a": (TRI_NAMES, 1), "b": (RESIDENT_NAMES, 1),
             "c": (TRI_NAMES, 2)}
    for k, leg in legs.items():
        cfg = leg["cfg"]
        names, fwd = kinds[k]
        want = dict.fromkeys(ranks[0][k]["launches"], 0)
        want.update(zip(names, (fwd * cfg.n_layers * PTP_STEPS,
                                cfg.n_layers * PTP_STEPS,
                                cfg.n_layers * PTP_STEPS)))
        got = ranks[0][k]
        worst = max(abs(a - b) for a, b in zip(got["losses"], refs[k]))
        b, s = leg["batch"]
        heads = (cfg.n_heads // PTP_RANKS, cfg.n_kv_heads // PTP_RANKS
                 ) if "tp" in leg["axes"] else (cfg.n_heads, cfg.n_kv_heads)
        seq = (f"{s // PTP_RANKS} tokens a rank outside attention, "
               f"attention on all {s}" if "sp" in leg["axes"] else
               f"{s} tokens")
        print(f"[parallel_tp] ({k}) {leg['axes']}, remat "
              f"{cfg.remat_policy}, {b} x {seq}, attention at "
              f"{(b, s) + heads + (cfg.head_dim,)} a rank: losses "
              f"{[round(x, 4) for x in got['losses']]}; one-device "
              f"{[round(x, 4) for x in refs[k]]}; largest |diff| "
              f"{worst:.3e} (tol {LOSS_TOL}); step "
              f"{_steady_ms(got['step_s']):.1f} ms (median of steps 2-"
              f"{PTP_STEPS}; first "
              f"{got['step_s'][0] * 1e3:.1f} ms); launches per rank "
              f"{[r[k]['launches'] for r in ranks]} ({card})", flush=True)
        check(_finite(got["losses"]) and worst <= LOSS_TOL,
              f"[parallel_tp] ({k}) loss off the one-device step's")
        for r, res in enumerate(ranks):
            check(res[k]["launches"] == want, f"[parallel_tp] ({k}) rank "
                  f"{r} launches {res[k]['launches']} != {want}")
    got = ranks[0]["b"]
    names = sorted(one_b["grads"])
    # Norm-relative over every adapter's gradient at once, as the kernels'
    # gradients are held: one small adapter gradient summed over tp from
    # bf16 partials can sit further off alone (printed).
    grad_rel = _rel([got["grads"][n] for n in names],
                    [one_b["grads"][n] for n in names])
    worst_one = max((_rel([got["grads"][n]], [one_b["grads"][n]]), n)
                    for n in names)
    adapter_diff = max(float((got["adapters"][n] - one_b["adapters"][n]
                              ).abs().max()) for n in one_b["adapters"])
    norm_diff = max(abs(a - b) / b for a, b in zip(got["norms"],
                                                   one_b["norms"]))
    print(f"[parallel_tp] (b) {len(names)} adapters: first-step "
          f"gradients {grad_rel:.3e} norm-relative from the one-device "
          f"step's (tol {GRAD_REL_TOL}; the farthest alone: "
          f"{worst_one[1]} {worst_one[0]:.3e}); grad norms "
          f"{[round(x, 4) for x in got['norms']]} vs "
          f"{[round(x, 4) for x in one_b['norms']]}; final adapters "
          f"largest |diff| {adapter_diff:.3e} (tol {LOSS_TOL}); one-device "
          f"step {_steady_ms(one_b['step_s']):.1f} ms ({card})", flush=True)
    check(len(got["grads"]) == len(one_b["grads"]) ==
          2 * len(PTP_LORA_TARGETS) * N_LAYERS,
          "[parallel_tp] (b) adapter gradients missing")
    check(grad_rel <= GRAD_REL_TOL and norm_diff <= GRAD_REL_TOL and
          adapter_diff <= LOSS_TOL,
          "[parallel_tp] (b) adapters off the one-device step's")
    print(f"[parallel_tp] {time.perf_counter() - t0:.1f} s", flush=True)


def phase_tiny(fa, llama, trainer, records):
    """LlamaConfig.tiny() (head_dim 16: the kernels' 64, zero-padded) on the
    card, in bf16 and in f32: 8 steps each on one repeated batch, full
    remat; the loss must fall and every step must go through the resident
    kernels (bf16) or the fp32 kernels (f32), 2L/L/L. The f32 run's
    counts are the fp32 kernels' launches in records."""
    for dtype, names in ((torch.bfloat16, RESIDENT_NAMES),
                         (torch.float32, F32_NAMES)):
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(2)
        params = llama.init(cfg, gen)
        tokens = torch.randint(0, cfg.vocab_size, (TINY_BATCH, TINY_SEQ),
                               device="cuda", generator=gen)
        tx = trainer.make_optimizer(trainer.TrainConfig(
            warmup_steps=1, total_steps=100, learning_rate=1e-2))
        state = trainer.init_train_state(params, tx)
        step = trainer.make_train_step(
            lambda p, t: llama.forward(cfg, p, t), tx, with_grad_norm=False)
        fa.reset_launches()
        losses = []
        for _ in range(TRAIN_STEPS):
            state, metrics = step(state, {"tokens": tokens})
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        print(f"[tiny] {dtype}, head_dim {cfg.head_dim}, {cfg.n_layers} "
              f"layers, batch {TINY_BATCH} x seq {TINY_SEQ}: losses "
              f"{[round(x, 4) for x in losses]}, launches {launches}",
              flush=True)
        check(all(x == x and abs(x) != float("inf") for x in losses),
              "non-finite loss")
        check(losses[-1] < losses[0], "loss did not fall")
        expect = dict.fromkeys(launches, 0)
        expect.update(zip(names, (2 * cfg.n_layers * TRAIN_STEPS,
                                  cfg.n_layers * TRAIN_STEPS,
                                  cfg.n_layers * TRAIN_STEPS)))
        check(launches == expect, f"launch counts {launches} != {expect}")
        if dtype == torch.float32:
            for rec in records.values():
                if rec["name"] in F32_NAMES:
                    rec["launches"] = launches[rec["name"]]


def _step_expect(launches, n_layers, steps, names=RESIDENT_NAMES):
    """2L forwards (full remat), L dq and L dk/dv per step of the family
    whose kernels are `names` (the resident one by default), no other
    kernel."""
    expect = dict.fromkeys(launches, 0)
    expect.update(zip(names, (2 * n_layers * steps, n_layers * steps,
                              n_layers * steps)))
    return expect


def _finite(xs):
    return all(x == x and abs(x) != float("inf") for x in xs)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


class _TimedOptimizer:
    """An optimizer whose ``update_`` is bracketed by CUDA events on the
    current stream: its device time per step, with no host sync added."""

    def __init__(self, tx):
        self.tx, self.events = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update_(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.tx.update_(*args, **kwargs)
        end.record()
        self.events.append((start, end))

    def ms(self):
        """Median over the steps after the first (synchronise first)."""
        times = [s.elapsed_time(e) for s, e in self.events[1:]]
        return sorted(times)[len(times) // 2]


def _train_steps(fa, step, state, batch, steps):
    """``steps`` steps from zeroed launch counts: (losses, aux losses,
    step seconds, launches, peak GB)."""
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, aux, step_s = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["total_loss"])
        aux.append(metrics["aux_loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    return ([float(x) for x in losses], [float(x) for x in aux], step_s,
            launches, torch.cuda.max_memory_allocated() / 1e9)


def _kernel_vs_reference(label, forward, cfg, params, tokens, trainer):
    """One forward's CE through the kernels and through the reference
    attention, same weights; fails past LOSS_TOL."""
    out = {}
    with torch.no_grad():
        for impl in ("kernel", "reference"):
            c = dataclasses.replace(cfg, attention_impl=impl, remat=False)
            logits = forward(c, params, tokens)
            check(logits.dtype == torch.float32
                  and bool(torch.isfinite(logits).all()),
                  f"bad logits from impl={impl}")
            out[impl] = float(trainer.cross_entropy_loss(
                logits[:, :-1], tokens[:, 1:]))
            del logits
    diff = abs(out["kernel"] - out["reference"])
    print(f"{label} loss kernel {out['kernel']:.5f} reference "
          f"{out['reference']:.5f} |diff| {diff:.2e} (tol {LOSS_TOL})",
          flush=True)
    check(diff <= LOSS_TOL, "kernel forward disagrees with the reference")


def phase_adafactor(fa, llama, trainer):
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              vocab_size=AF_VOCAB, n_layers=AF_LAYERS,
                              max_seq_len=AF_MAX_SEQ)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = llama.init(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (AF_BATCH, AF_SEQ),
                           device="cuda", generator=gen)
    tx = _TimedOptimizer(trainer.make_optimizer(trainer.TrainConfig(
        warmup_steps=1, total_steps=100, optimizer="adafactor")))
    state = trainer.init_train_state(params, tx)
    step = trainer.make_train_step(
        lambda p, t: llama.forward(cfg, p, t), tx, with_grad_norm=False)
    print(f"[adafactor] 8B layer shape, vocab {cfg.vocab_size}, "
          f"{cfg.n_layers} layers, {cfg.num_params() / 1e9:.3f} B params, "
          f"batch {AF_BATCH} x seq {AF_SEQ}, bf16, adafactor, remat "
          f"{cfg.remat_policy}", flush=True)
    losses, _, step_s, launches, peak_gb = _train_steps(
        fa, step, state, {"tokens": tokens}, TRAIN_STEPS)
    print(f"[adafactor] losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"[adafactor] launches {launches}", flush=True)
    check(_finite(losses), "non-finite loss")
    check(losses[-1] < losses[0], "loss did not fall")
    expect = _step_expect(launches, cfg.n_layers, TRAIN_STEPS)
    check(launches == expect, f"launch counts {launches} != {expect}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tok_s = AF_BATCH * AF_SEQ / steady
    tflops = cfg.flops_per_token(AF_SEQ) * tok_s / 1e12
    print(f"[adafactor] step {steady * 1e3:.1f} ms (median of steps 2-"
          f"{TRAIN_STEPS}; first {step_s[0] * 1e3:.1f} ms), {tok_s:.0f} "
          f"tokens/s, {tflops:.1f} model TFLOP/s (6N + attention) of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f}, peak memory {peak_gb:.2f} GB",
          flush=True)
    _kernel_vs_reference("[adafactor]", llama.forward, cfg, state.params,
                         tokens, trainer)

    # Each optimizer's device time on these parameters, in turns, from
    # the same gradients (their values do not change the work).
    plist = list(state.params.parameters())
    grads = [torch.randn_like(p) * 1e-3 for p in plist]
    adamw = _TimedOptimizer(trainer.make_optimizer(trainer.TrainConfig()))
    adamw_state = adamw.init(state.params)
    for _ in range(4):
        tx.update_(plist, [g.clone() for g in grads], state.opt_state)
        adamw.update_(plist, [g.clone() for g in grads], adamw_state)
    torch.cuda.synchronize()
    af_in_step = sorted(s.elapsed_time(e)
                        for s, e in tx.events[1:TRAIN_STEPS])
    af_in_step = af_in_step[len(af_in_step) // 2]
    tx.events = tx.events[TRAIN_STEPS:]
    print(f"[adafactor] optimizer per step: adafactor "
          f"{af_in_step:.2f} ms in the step (median of steps 2-"
          f"{TRAIN_STEPS}), {tx.ms():.2f} ms alone; adamw (fused) "
          f"{adamw.ms():.2f} ms alone on the same parameters (CUDA events, "
          f"in turns)", flush=True)


@contextlib.contextmanager
def _trainstats_armed(out_dir):
    """observability/trainstats armed and empty for the block, its files in
    ``out_dir``, a timed synchronize after every step; disarmed after."""
    from skypilot_tpu_torch.observability import trainstats
    old = os.environ.get(trainstats.DIR_ENV)
    os.environ[trainstats.DIR_ENV] = str(out_dir)
    trainstats.arm(sync_every=TRAINSTATS_SYNC_EVERY)
    trainstats.reset()
    try:
        yield trainstats
    finally:
        trainstats.disarm()
        if old is None:
            os.environ.pop(trainstats.DIR_ENV, None)
        else:
            os.environ[trainstats.DIR_ENV] = old


def _train_readings(label, run, cfg, seq, card, out_dir):
    """The recipe's train_* keys, held to trainstats' live gauges (the
    same window, unrounded): MFU a number in (0, 1], equal to tokens/s x
    flops_per_token(seq) / the card's peak within 1e-6; the ring's
    tokens/s at least 0.95 x the recipe's wall-clock rate (the ring
    leaves out the checkpoint waits after the loop); the goodput
    fractions equal to the ring records' sums over its window, and the
    window's untracked share under UNTRACKED_MAX; snapshot.json and the
    host JSONL written. A card missing from the peak table fails here
    (MFU None)."""
    from skypilot_tpu_torch.observability import metrics, trainstats
    snap = trainstats.snapshot()
    name = torch.cuda.get_device_name(0)
    peak = DATASHEET_BF16_FLOPS.get(name, 0.0)
    fpt = cfg.flops_per_token(seq)
    mfu = metrics.gauge("stpu_train_mfu").get()
    tok_s = metrics.gauge("stpu_train_tokens_per_sec").get()
    goodput = run.get("train_goodput") or {}
    sync = snap.get("sync") or {}
    recs = trainstats.steps_tail()
    window = recs[-1]["mono"] - recs[0]["mono"] + recs[0]["dur"]
    parts = {"productive": sum(r["dur"] for r in recs),
             "data_wait": sum(r["data_wait_s"] for r in recs),
             "ckpt": sum(r["ckpt_s"] for r in recs), "restart": 0.0}
    first_wait = recs[0]["data_wait_s"] / window
    untracked = 1 - sum(parts.values()) / window + first_wait
    gaps_ms = [(b["mono"] - a["mono"] - b["dur"] - b["data_wait_s"]
                - b["ckpt_s"]) * 1e3 for a, b in zip(recs, recs[1:])]
    print(f"{label} trainstats ({card}): train_mfu {run.get('train_mfu')} "
          f"(live {mfu:.6f}; peak {peak / 1e12:.0f} TFLOP/s for {name!r}, "
          f"{fpt / 1e9:.3f} GFLOP a token: 6N + causal attention), "
          f"train_tokens_per_sec {run.get('train_tokens_per_sec')} vs "
          f"the recipe's wall {run['tokens_per_second']}, "
          f"train_step_seconds {run.get('train_step_seconds')}, "
          f"train_goodput {json.dumps(goodput)} (the first step's input "
          f"wait {first_wait:.6f} of it, untracked {untracked:.6f}: "
          f"{', '.join(f'{g:.3f}' for g in gaps_ms)} ms between steps), "
          f"dispatch "
          f"{snap.get('dispatch_ms_mean')} ms vs device "
          f"{sync.get('device_ms_mean')} ms a step over "
          f"{sync.get('samples')} synced steps", flush=True)
    check(peak > 0, f"{name!r} has no data-sheet peak in chip_smoke.py")
    check(trainstats.PEAK_FLOPS.get(name) == peak,
          f"trainstats.PEAK_FLOPS[{name!r}] is "
          f"{trainstats.PEAK_FLOPS.get(name)}, the data sheet's {peak}")
    check(isinstance(run.get("train_mfu"), float)
          and 0 < run["train_mfu"] <= 1,
          f"train_mfu {run.get('train_mfu')} is not a number in (0, 1]")
    check(abs(mfu - tok_s * fpt / peak) <= 1e-6 * mfu,
          f"live MFU {mfu} != {tok_s} tokens/s x {fpt} / {peak}")
    check(run["train_mfu"] == round(mfu, 4)
          and run["train_tokens_per_sec"] == round(tok_s, 1),
          "the recipe's train_* keys are not the live gauges")
    check(run["train_tokens_per_sec"] >= 0.95 * run["tokens_per_second"],
          "the ring's tokens/s is below 0.95x the recipe's wall rate")
    check(goodput == {k: round(min(v / window, 1.0), 4)
                      for k, v in parts.items()},
          f"goodput {goodput} is not the ring's {parts} over {window} s")
    check(-1e-9 <= untracked <= UNTRACKED_MAX,
          f"the loop's untracked share {untracked:.6f} of the window")
    check(sync.get("samples") == snap["steps"],
          f"{sync.get('samples')} synced steps of {snap['steps']}")
    for f in ("snapshot.json", "host-0.jsonl"):
        check((pathlib.Path(out_dir) / f).is_file(), f"no trainstats {f}")


def _ckpt_outcomes(checkpoint):
    return {(kind, outcome): fam.labels(outcome=outcome).get()
            for kind, fam in (("saves", checkpoint._SAVES),
                              ("restores", checkpoint._RESTORES))
            for outcome in ("ok", "none", "error")}


def _lora_run(llama_lora, argv):
    """The recipe's main() with its stdout kept: its metrics line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = llama_lora.main(argv)
    return metrics


def phase_lora(fa, llama, trainer, card):
    from skypilot_tpu_torch.recipes import llama_lora
    from skypilot_tpu_torch.train import checkpoint
    cfg = llama.LlamaConfig.llama3_8b()
    common = ["--model", "8b", "--batch-size", str(LORA_BATCH),
              "--seq-len", str(LORA_SEQ), "--ckpt-every", str(LORA_SPLIT)]
    print(f"[lora] llama3_8b, {cfg.n_layers} layers (full depth), "
          f"{cfg.num_params() / 1e9:.3f} B params frozen, rank-8 adapters "
          f"on wq/wk/wv/wo, batch {LORA_BATCH} x seq {LORA_SEQ}, bf16, "
          f"remat {cfg.remat_policy}: A {LORA_STEPS} steps saving every "
          f"{LORA_SPLIT}, B {LORA_SPLIT} steps, B' resumes B to "
          f"{LORA_STEPS}", flush=True)
    sigterm = signal.getsignal(signal.SIGTERM)  # the recipe installs its own
    with tempfile.TemporaryDirectory(prefix="stpu-lora-") as tmp:
        dir_a, dir_b = f"{tmp}/a", f"{tmp}/b"
        stats_dir = f"{tmp}/trainstats"
        ckpt0 = _ckpt_outcomes(checkpoint)
        try:
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            argv_a = common + ["--steps", str(LORA_STEPS),
                               "--checkpoint-dir", dir_a]
            with _trainstats_armed(stats_dir):
                run_a = _lora_run(llama_lora, argv_a)
                _train_readings("[lora] A", run_a, cfg, LORA_SEQ, card,
                                stats_dir)
            run_b = _lora_run(llama_lora, common + [
                "--steps", str(LORA_SPLIT), "--checkpoint-dir", dir_b])
            run_b2 = _lora_run(llama_lora, common + [
                "--steps", str(LORA_STEPS), "--checkpoint-dir", dir_b])
            launches = dict(fa.LAUNCHES)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finally:
            signal.signal(signal.SIGTERM, sigterm)
        for name, run in (("A", run_a), ("B", run_b), ("B'", run_b2)):
            print(f"[lora] {name}: {json.dumps(run)}", flush=True)
        print(f"[lora] launches {launches}", flush=True)
        # A saves at steps 2 and 4, B at 2, B' at 4 (after its restore);
        # A and B find nothing to restore.
        ckpt = {k: v - ckpt0[k] for k, v in _ckpt_outcomes(
            checkpoint).items()}
        print(f"[lora] stpu_ckpt_* over A, B, B': {ckpt}", flush=True)
        want = {("saves", "ok"): 4, ("saves", "none"): 0,
                ("saves", "error"): 0, ("restores", "ok"): 1,
                ("restores", "none"): 2, ("restores", "error"): 0}
        check(ckpt == want, f"checkpoint outcomes {ckpt} != {want}")
        check(_finite([run_a["first_loss"], run_a["final_loss"]]),
              "non-finite loss")
        check(run_b2["resumed_from"] == LORA_SPLIT,
              f"B' resumed from {run_b2['resumed_from']}, not {LORA_SPLIT}")
        check(run_b2["final_loss"] == run_a["final_loss"],
              "B' final loss differs from A's")
        got_a = checkpoint.restore_latest(dir_a)
        got_b = checkpoint.restore_latest(dir_b)
        check(got_a.step == got_b.step == LORA_STEPS,
              f"checkpoints at {got_a.step} and {got_b.step}")
        state_keys = [k for k in got_a.tree
                      if k.startswith(("lora/", "opt_state/"))]
        for key in state_keys:
            a, b = got_a.tree[key], got_b.tree[key]
            check(a.dtype == b.dtype and a.shape == b.shape
                  and torch.equal(a.reshape(-1).view(torch.uint8),
                                  b.reshape(-1).view(torch.uint8)),
                  f"{key}: resumed state differs from uninterrupted")
        check(got_a.manifest_sha256 == got_b.manifest_sha256,
              "checkpoint payloads differ")
        print(f"[lora] B' at step {LORA_STEPS} equals A byte for byte: "
              f"{len(state_keys)} adapter and optimizer leaves, payload "
              f"sha256 {got_a.manifest_sha256[:16]}", flush=True)
        expect = _step_expect(launches, cfg.n_layers,
                                  LORA_STEPS + 2 * LORA_SPLIT)
        check(launches == expect, f"launch counts {launches} != {expect}")
        per_step = run_b2["wall_seconds"] / LORA_SPLIT
        print(f"[lora] B' {per_step * 1e3:.0f} ms per step (wall over its "
              f"{LORA_SPLIT} steps, checkpoint save included), "
              f"{run_b2['tokens_per_second']:.0f} tokens/s; A "
              f"{run_a['tokens_per_second']:.0f} tokens/s (first step "
              f"included); peak memory {peak_gb:.2f} GB", flush=True)

        # Losses fall: A's adapters at step 4 against the base (the
        # adapters at step 1, B = 0) on A's first batch, both as the
        # recipe makes them from A's arguments.
        args_a = llama_lora.build_arg_parser(["tiny", "8b"],
                                             "tiny").parse_args(argv_a)
        base, lora = llama_lora.init_model(llama, cfg, args_a,
                                           torch.device("cuda"))
        llama_lora.load_lora(lora, checkpoint.restore_latest(
            dir_a, like={"lora": lora.stacked()}).tree["lora"])
    first = next(llama_lora.train_batches(cfg, args_a, 1))[0]
    tokens = torch.from_numpy(first).long().cuda()
    with torch.no_grad():
        logits = llama.forward(cfg, llama_lora.merge_params(base, lora),
                               tokens)
        trained = float(trainer.cross_entropy_loss(logits[:, :-1],
                                                   tokens[:, 1:]))
    del logits, base, lora
    print(f"[lora] A's first batch: loss {run_a['first_loss']:.5f} at step "
          f"1, {trained:.5f} with the step-{LORA_STEPS} adapters",
          flush=True)
    check(trained < run_a["first_loss"], "loss did not fall")


def _dropped_share(mixtral, llama, cfg, params, tokens):
    """Per layer, the share of (token, choice) pairs past an expert's
    capacity at these weights."""
    shares = []
    with torch.no_grad():
        x = llama.embed_tokens(params, tokens)
        positions = torch.arange(tokens.shape[1], device="cuda").expand(
            tokens.shape)
        for lp in params.layers:
            y = llama.rms_norm(llama.attention_block(cfg, x, lp, positions),
                               lp.mlp_norm, cfg.norm_eps)
            dispatch, _, _ = mixtral._top2_dispatch(
                mixtral.router_gates(y, lp),
                mixtral.capacity(cfg, tokens.numel()))
            shares.append(1.0 - float(dispatch.sum()) /
                          (cfg.top_k * tokens.numel()))
            x, _ = lp(cfg, x, positions)
    return shares


def phase_mixtral(fa, llama, trainer):
    from skypilot_tpu_torch.models import mixtral
    cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                              n_layers=MX_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = mixtral.init(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (MX_BATCH, MX_SEQ),
                           device="cuda", generator=gen)
    print(f"[mixtral] mixtral_8x7b width ({cfg.n_experts} experts, top "
          f"{cfg.top_k}, capacity {mixtral.capacity(cfg, tokens.numel())} "
          f"per expert), {cfg.n_layers} layers, "
          f"{cfg.num_params() / 1e9:.3f} B params, batch {MX_BATCH} x seq "
          f"{MX_SEQ}, bf16, adafactor, full remat", flush=True)
    shares = _dropped_share(mixtral, llama, cfg, params, tokens)
    tx = trainer.make_optimizer(trainer.TrainConfig(
        warmup_steps=1, total_steps=100, optimizer="adafactor"))
    state = trainer.init_train_state(params, tx)
    step = trainer.make_train_step(
        lambda p, t: mixtral.forward(cfg, p, t), tx, with_grad_norm=False)
    losses, aux, step_s, launches, peak_gb = _train_steps(
        fa, step, state, {"tokens": tokens}, MX_STEPS)
    print(f"[mixtral] losses (CE + aux) {[round(x, 4) for x in losses]}, "
          f"aux {[round(x, 5) for x in aux]}", flush=True)
    print(f"[mixtral] launches {launches}", flush=True)
    check(_finite(losses + aux), "non-finite loss")
    check(losses[-1] < losses[0], "loss did not fall")
    check(all(x > 0 for x in aux), "aux loss not positive")
    expect = _step_expect(launches, cfg.n_layers, MX_STEPS)
    check(launches == expect, f"launch counts {launches} != {expect}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tok_s = MX_BATCH * MX_SEQ / steady
    print(f"[mixtral] step {steady * 1e3:.1f} ms (median of steps 2-"
          f"{MX_STEPS}; first {step_s[0] * 1e3:.1f} ms), {tok_s:.0f} "
          f"tokens/s, peak memory {peak_gb:.2f} GB; token choices dropped "
          f"by capacity at step 1: "
          f"{', '.join(f'{x:.4f}' for x in shares)} (by layer)", flush=True)
    _kernel_vs_reference(
        "[mixtral]", lambda c, p, t: mixtral.forward(c, p, t)[0], cfg,
        state.params, tokens, trainer)


def phase_mixtral_ep(fa, trainer, card, dev="cuda", cfg=None):
    """The expert-parallel recipe's step on the one card: a world-1 NCCL
    mesh {dp 1, ep 1}; the recipe's run() (its weights, batches and adamw
    from its seed) against the one-device make_train_step from the same
    weights on the same batches. ``dev="cpu"`` and a small ``cfg``
    rehearse it on the CPU (gloo; the launch check then fails: no kernel
    runs there)."""
    import torch.distributed as dist

    from skypilot_tpu_torch.models import mixtral
    from skypilot_tpu_torch.recipes import mixtral_ep
    t_phase = time.perf_counter()
    cfg = cfg or dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                                     n_layers=MX_LAYERS)
    args = mixtral_ep.build_arg_parser().parse_args([
        "--model", "8x7b", "--steps", str(MXEP_STEPS), "--batch-size",
        str(MX_BATCH), "--seq-len", str(MX_SEQ), "--seed", str(MXEP_SEED),
        "--device", dev])
    cuda = dev == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    print(f"[mixtral_ep] mixtral_8x7b width, {cfg.n_layers} layers, "
          f"{cfg.num_params() / 1e9:.3f} B params, batch {MX_BATCH} x seq "
          f"{MX_SEQ}, bf16, adamw, full remat, {MXEP_STEPS} steps of the "
          f"recipe's batches (seed {MXEP_SEED})", flush=True)
    batches = [torch.from_numpy(t).long().to(dev)
               for t in mixtral_ep.train_batches(cfg, args)]

    def draw():
        return mixtral.init(cfg, torch.Generator(dev).manual_seed(
            args.seed), dev)
    tx = trainer.make_optimizer(trainer.TrainConfig(total_steps=args.steps))
    state = trainer.init_train_state(draw(), tx)
    step = trainer.make_train_step(lambda p, t: mixtral.forward(cfg, p, t),
                                   tx, with_grad_norm=False)
    ref_loss, ref_aux, ref_s = [], [], []
    for tokens in batches:
        sync()
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        ref_loss.append(float(m["loss"]))
        ref_aux.append(float(m["aux_loss"]))
        ref_s.append(time.perf_counter() - t0)
    ref = [p.detach() for p in state.params.parameters()]
    del state, step, tx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="stpu-mxep-") as tmp:
        try:
            fa.reset_launches()
            with _trainstats_armed(tmp) as trainstats:
                out, state = mixtral_ep.run(args, cfg)
                launches = dict(fa.LAUNCHES)
                peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if cuda
                           else 0.0)
                recs = trainstats.steps_tail()
                losses = [r["loss"] for r in recs
                          if r.get("loss") is not None]
                run_s = sorted(r["dur"] for r in recs[1:])
            losses.append(out["final_loss"])
            backend, world = dist.get_backend(), dist.get_world_size()
            with torch.no_grad():
                init = list(draw().parameters())
                diff = moved = 0.0
                for p, q, p0 in zip(state.params.parameters(), ref, init):
                    diff = max(diff, (p.full_tensor().float() - q.float()
                                      ).abs().max().item())
                    moved = max(moved, (q.float() - p0.float()
                                        ).abs().max().item())
            del state, ref, init
        finally:
            dist.destroy_process_group()
    print(f"[mixtral_ep] mesh {out['mesh']}: backend {backend}, world "
          f"{world}; losses (CE) {[round(x, 4) for x in losses]}, aux "
          f"{out['aux_loss']:.5f}; one-device "
          f"{[round(x, 4) for x in ref_loss]}, aux {ref_aux[-1]:.5f}",
          flush=True)
    print(f"[mixtral_ep] launches {launches}", flush=True)
    check(backend == ("nccl" if cuda else "gloo") and world == 1,
          f"the recipe's mesh is a {backend} group of {world} processes")
    check(out["mesh"] == {"dp": 1, "ep": 1}, f"mesh {out['mesh']}")
    check(len(losses) == MXEP_STEPS and _finite(losses + [out["aux_loss"]]),
          f"losses {losses}")
    worst = max(abs(a - b) for a, b in zip(losses, ref_loss))
    aux_diff = abs(out["aux_loss"] - ref_aux[-1])
    check(worst <= LOSS_TOL and aux_diff <= LOSS_TOL,
          f"recipe losses off the one-device step's by {worst:.3e}, aux by "
          f"{aux_diff:.3e} (tol {LOSS_TOL})")
    check(out["aux_loss"] > 0, "aux loss not positive")
    check(diff <= LOSS_TOL, f"parameters off the one-device step's by "
          f"{diff:.3e} (tol {LOSS_TOL})")
    expect = _step_expect(launches, cfg.n_layers, MXEP_STEPS)
    check(launches == expect, f"launch counts {launches} != {expect}")
    steady = sorted(ref_s[1:])[len(ref_s[1:]) // 2]
    print(f"[mixtral_ep] vs one-device: largest loss |diff| {worst:.3e}, aux "
          f"|diff| {aux_diff:.3e} (tol {LOSS_TOL}); largest parameter "
          f"|diff| {diff:.3e} after {MXEP_STEPS} steps (largest move "
          f"{moved:.3e}, warmup 100 steps); recipe step "
          f"{run_s[len(run_s) // 2] * 1e3:.1f} ms (median of steps 2-"
          f"{MXEP_STEPS}; trainstats mean "
          f"{out['train_step_seconds'] * 1e3:.1f} ms), "
          f"{out['tokens_per_second']} tokens/s (wall, first step "
          f"included), train_tokens_per_sec {out['train_tokens_per_sec']}, "
          f"train_mfu {out['train_mfu']} (6N, no attention term: the "
          f"recipe's flops_per_token); one-device step {steady * 1e3:.1f} ms "
          f"(median of steps 2-{MXEP_STEPS}); peak memory {peak_gb:.2f} GB "
          f"({card})", flush=True)
    print(f"[mixtral_ep] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def phase_recipes(card, dev="cuda"):
    """The small recipes through their main(): resnet_ddp at resnet101 /
    224 / batch 32 (world 1), mnist under the benchmark recorder, and
    glue_imdb, each at its accuracy gate."""
    from skypilot_tpu_torch import callbacks
    from skypilot_tpu_torch.recipes import glue_imdb, mnist, resnet_ddp
    t_phase = time.perf_counter()
    try:
        res = resnet_ddp.main(["--steps", str(RESNET_STEPS),
                               "--batch-size", "32", "--device", dev])
        check(_finite([res["final_loss"]]), "resnet_ddp: non-finite loss")
        print(f"[recipes] resnet_ddp resnet101 224 x 224, batch 32, world "
              f"1: {res['examples_per_second']} examples/s, p50 iteration "
              f"{res['p50_iter_seconds'] * 1e3:.1f} ms (steps 3-"
              f"{RESNET_STEPS}), final loss {res['final_loss']:.4f}, cuDNN "
              f"TF32 {torch.backends.cudnn.allow_tf32} ({card})", flush=True)
        with tempfile.TemporaryDirectory(prefix="stpu-bench-") as tmp:
            old = os.environ.get(callbacks.ENV_LOG_DIR)
            os.environ[callbacks.ENV_LOG_DIR] = tmp
            try:
                mn = mnist.main(["--steps", str(MNIST_STEPS), "--device",
                                 dev])
            finally:
                callbacks._state = None
                if old is None:
                    os.environ.pop(callbacks.ENV_LOG_DIR)
                else:
                    os.environ[callbacks.ENV_LOG_DIR] = old
            summary_path = pathlib.Path(tmp) / callbacks.SUMMARY_NAME
            check(summary_path.is_file(), "mnist wrote no "
                  f"{callbacks.SUMMARY_NAME}")
            summary = json.loads(summary_path.read_text())
        check(summary["num_steps"] == MNIST_STEPS,
              f"benchmark summary {summary}")
        gl = glue_imdb.main(["--steps", str(GLUE_STEPS), "--device", dev])
    except SystemExit as e:
        raise PhaseError(f"[recipes] {e}") from e
    print(f"[recipes] mnist {MNIST_STEPS} steps: accuracy "
          f"{mn['test_accuracy']:.4f} (gate 0.8), "
          f"{summary['seconds_per_step'] * 1e3:.2f} ms a step (the "
          f"recorder's steady state); glue_imdb {GLUE_STEPS} steps: "
          f"accuracy {gl['test_accuracy']:.4f} (gate 0.75), "
          f"{gl['wall_seconds']} s ({card})", flush=True)
    check(mn["test_accuracy"] >= 0.8 and gl["test_accuracy"] >= 0.75,
          "a recipe's accuracy is below its gate")
    print(f"[recipes] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def _sse_generate(port, body, out, idx, on_frame=None):
    """One streamed /generate over HTTP: out[idx] = its status, send time
    and each SSE frame with its arrival time; ``on_frame(frames)`` runs
    after each frame arrives."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    t0 = time.perf_counter()
    conn.request("POST", "/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    buf, frames, times = b"", [], []
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            frames.append(frame.decode())
            times.append(time.perf_counter())
            if on_frame is not None:
                on_frame(frames)
    conn.close()
    out[idx] = {"status": resp.status, "t0": t0, "frames": frames,
                "times": times}


def _stream_tokens(label, res):
    """The stream's tokens and its stats record; fails unless it is 128
    token frames, then the stats frame, then [DONE]."""
    frames = res["frames"]
    check(res["status"] == 200, f"{label}: HTTP {res['status']}")
    check(len(frames) >= 2 and frames[-1] == "data: [DONE]"
          and frames[-2].startswith("event: stats\ndata: "),
          f"{label}: stream does not end in a stats frame and [DONE]")
    toks = [json.loads(f[len("data: "):])["token"] for f in frames[:-2]]
    check(len(toks) == SV_MAX_TOKENS,
          f"{label}: {len(toks)} tokens, not {SV_MAX_TOKENS}")
    return toks, json.loads(frames[-2].split("data: ", 1)[1])


def _serve_requests(cfg, seed):
    """(prompt, temperature, seed) of the eight requests (even ones
    greedy) and the ninth, sharing SV_PREFIX tokens with the longest."""
    gen = torch.Generator().manual_seed(seed)
    reqs = []
    for i, n in enumerate(SV_PROMPTS):
        prompt = torch.randint(1, cfg.vocab_size, (n,), generator=gen)
        reqs.append((prompt.tolist(), 0.0 if i % 2 == 0 else SV_TEMP,
                     100 + i))
    tail = torch.randint(1, cfg.vocab_size, (256,), generator=gen).tolist()
    return reqs, (reqs[-1][0][:SV_PREFIX] + tail, 0.0, 0)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def _serve_leg(fa, cfg, params, reqs, ninth, card, label, dev,
               ninth_out=None, **kw):
    """One replica through serve(): the eight concurrent streams, then
    the ninth alone. Returns the streams' tokens (the ninth's appended to
    ``ninth_out`` when given) and prints the leg's numbers beside the
    card."""
    from skypilot_tpu_torch.observability import metrics, stepstats
    from skypilot_tpu_torch.recipes import serve_llm
    hits = metrics.REGISTRY.counter("stpu_engine_prefix_cache_hits_total")
    ready = threading.Event()
    httpd = serve_llm.serve(cfg, params, 0, ready_event=ready,
                            engine_slots=SV_SLOTS, kv_paged=True,
                            kv_block_tokens=SV_BLOCK, device=dev, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        check(ready.wait(timeout=900), f"{label} replica never ready")
        engine = httpd.engine.engine
        geo = engine.kv_config()
        weight_gb = sum(p.numel() * p.element_size()
                        for p in engine._params.parameters()) / 1e9
        port = httpd.server_address[1]
        stepstats.reset()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        out = [None] * len(reqs)
        threads = [threading.Thread(target=_sse_generate, args=(
            port, {"prompt": p, "max_tokens": SV_MAX_TOKENS,
                   "temperature": t, "seed": s, "stream": True}, out, i))
            for i, (p, t, s) in enumerate(reqs)]
        t_start = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        t_end = time.perf_counter()
        steps8 = stepstats.steps_tail()
        hits_before = hits.get()
        last = [None]
        _sse_generate(port, {"prompt": ninth[0],
                             "max_tokens": SV_MAX_TOKENS, "stream": True},
                      last, 0)
        launches = dict(fa.LAUNCHES)
        hit_count = hits.get() - hits_before
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = stepstats.steps_tail()
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.engine.shutdown()
        httpd.engine.engine.release()
    streams = []
    for i, res in enumerate(out):
        check(res is not None, f"{label} request {i} never returned")
        toks, stats = _stream_tokens(f"{label} request {i}", res)
        streams.append(toks)
        ttft = res["times"][0] - res["t0"]
        total = res["times"][-1] - res["t0"]
        print(f"{label} request {i}: prompt {len(reqs[i][0])}, "
              f"{'greedy' if reqs[i][1] == 0 else f'T={reqs[i][1]}'}: "
              f"TTFT {ttft * 1e3:.1f} ms, {len(toks) / total:.1f} tokens/s "
              f"end to end, {(len(toks) - 1) / (res['times'][-3] - res['times'][0]):.1f} "
              f"tokens/s after the first ({card})", flush=True)
    toks9, stats9 = _stream_tokens(f"{label} request 9", last[0])
    if ninth_out is not None:
        ninth_out.append(toks9)
    agg = len(reqs) * SV_MAX_TOKENS / (t_end - t_start)
    print(f"{label} aggregate {agg:.1f} tokens/s over the eight streams "
          f"({t_end - t_start:.2f} s wall); peak memory {peak_gb:.2f} GB; "
          f"weights {weight_gb:.2f} GB, weight-read bound per decode step "
          f"{weight_gb * 1e9 / PEAK_BYTES_PER_S * 1e3:.2f} ms ({card})",
          flush=True)
    print(f"{label} ninth request (shares {SV_PREFIX} tokens with the "
          f"longest): cached {stats9['cached_prompt_tokens']} prompt "
          f"tokens, kv tier {stats9['kv_tier']}, TTFT "
          f"{stats9['ttft_s'] * 1e3:.1f} ms, prefix hits +{hit_count}",
          flush=True)
    check(hit_count >= 1 and stats9["cached_prompt_tokens"] >= SV_PREFIX,
          f"{label}: the ninth request missed the prefix cache")
    check(all(v == 0 for v in launches.values()),
          f"{label}: flash kernels launched during the engine's work "
          f"{launches} (serving attention is the split-KV torch path)")
    by_live = {}
    for rec in steps:
        if rec["phase"] == "decode":
            by_live.setdefault(rec["decode_tokens"], []).append(rec["dur"])
    chunk = [r["dur"] for r in steps if r["phase"] == "prefill"
             and r["prefill_tokens"] == SV_BLOCK]
    mixed = [r["dur"] for r in steps8 if r["phase"] == "mixed"]
    print(f"{label} decode step ms by live slots (median, steps): " +
          ", ".join(f"{n}: {_median(d) * 1e3:.2f} ({len(d)})"
                    for n, d in sorted(by_live.items())) +
          f"; {SV_BLOCK}-token prefill chunk alone {_median(chunk) * 1e3:.2f} "
          f"ms ({len(chunk)}); prefill chunk + decode step "
          f"{_median(mixed) * 1e3:.2f} ms ({len(mixed)}) ({card})",
          flush=True)
    return streams, geo


def _cache_path_logits(llama, decode_engine, cfg, params, seqs, geo, dev,
                       paged, fault=None, pins=None, kv_heads=None):
    """Each (prompt, tokens) of ``seqs`` teacher-forced through the
    engine's cache path at its geometry ``geo`` (kv_config()): the
    prompt in chunk-sized prefill chunks (the engine's _prefill_chunk /
    _paged_prefill_chunk), then the tokens but the last in batched T = 1
    steps over all streams, as the decode step runs them. Returns one
    f32 (len(tokens), vocab) per stream: row j predicts tokens[j].

    ``fault`` plants a fault, a control the gates must catch: "self"
    passes valid_len = position in the T = 1 steps, so a query misses its
    own key row; "shift" starts each step one position late, so the
    token's rope position and cache row are one past its place; the
    faults of ``_planted`` patch the port for the whole run. ``pins``
    (a ``_RoutingPins``) pins Mixtral's routing to its reference's picks
    at each token's own position, whatever the fault. ``kv_heads``: a tp
    rank's own (its cache holds only those)."""
    if _planted(fault) is not None:
        with _planting(fault):
            return _cache_path_logits(llama, decode_engine, cfg, params,
                                      seqs, geo, dev, paged, pins=pins)
    if pins is not None and not pins.active:
        with pins.replaying():
            return _cache_path_logits(llama, decode_engine, cfg, params,
                                      seqs, geo, dev, paged, fault, pins)
    chunk, window, block = geo["chunk"], geo.get("window"), geo["block"]
    b = len(seqs)
    if paged:
        per = [-(-(len(p) + len(t)) // chunk) for p, t in seqs]
        table = np.zeros((b, max(geo["table_len"], max(per))), np.int64)
        nxt = 1
        for i, n in enumerate(per):
            table[i, :n] = np.arange(nxt, nxt + n)
            nxt += n
        cache = llama.init_paged_cache(cfg, nxt, chunk,
                                       quantized=bool(geo["kv_quant"]),
                                       device=dev, kv_heads=kv_heads)
    else:
        cache = llama.init_cache(cfg, b, geo["max_seq"], dev,
                                 kv_heads=kv_heads)
    out = []
    with torch.inference_mode():
        for i, (prompt, _) in enumerate(seqs):
            for start in range(0, len(prompt), chunk):
                piece = prompt[start:start + chunk]
                buf = torch.zeros(chunk, dtype=torch.long, device=dev)
                buf[:len(piece)] = torch.tensor(piece, device=dev)
                valid = start + len(piece)
                if pins is not None:
                    pins.at([(i, start, len(piece))])
                if paged:
                    z = decode_engine._paged_prefill_chunk(
                        cfg, params, cache, buf, table[i], start, valid,
                        int(table[i, start // chunk]), window)
                else:
                    z = decode_engine._prefill_chunk(
                        cfg, params, cache, buf, i, start, valid, block)
            out.append([z])
        pos = np.array([len(p) for p, _ in seqs], np.int64)
        for j in range(len(seqs[0][1]) - 1):
            toks = torch.tensor([t[j] for _, t in seqs], device=dev)[:, None]
            start, valid = pos + j, None
            if pins is not None:
                pins.at([(i, int(pos[i]) + j, 1) for i in range(b)])
            if fault == "self":
                valid = start
            elif fault == "shift":
                start = start + 1
            if paged:
                z, _ = llama.forward_with_paged_cache(
                    cfg, params, toks, cache, table, start, valid_len=valid,
                    window=window)
            else:
                z, _ = llama.forward_with_cache(cfg, params, toks, cache,
                                                start, valid_len=valid,
                                                block=block)
            for i in range(b):
                out[i].append(z[i, 0])
    return [torch.stack(o) for o in out]


def _planted(fault):
    """(module, attribute, wrong function) of a fault planted by patching
    the port, or None: "embed" gathers the embeddings without gemma's
    sqrt(dim) multiplier (the serving embed's fault before it was
    repaired); "unnorm" leaves Mixtral's two gates unnormalised; "top1"
    routes each token to its first expert alone, at weight one."""
    from skypilot_tpu_torch.models import llama as llama_mod
    from skypilot_tpu_torch.models import mixtral as mixtral_mod
    real = mixtral_mod._top2_weights
    return {
        "embed": (llama_mod, "_decode_embed",
                  lambda c, p, toks: p.embed[toks]),
        "unnorm": (mixtral_mod, "_top2_weights",
                   lambda g: g * (real(g) > 0)),
        "top1": (mixtral_mod, "_top2_weights",
                 lambda g: torch.nn.functional.one_hot(
                     g.argmax(-1), g.shape[-1]).to(g.dtype)),
    }.get(fault)


@contextlib.contextmanager
def _planting(fault):
    """``_planted``'s fault patched into the port for the block (nothing
    for any other ``fault``)."""
    planted = _planted(fault)
    if planted is None:
        yield
        return
    module, name, wrong = planted
    real = getattr(module, name)
    setattr(module, name, wrong)
    try:
        yield
    finally:
        setattr(module, name, real)


class _RoutingPins:
    """Mixtral's routing pinned to a reference's picks, to read the cache
    paths' own arithmetic apart from routing flips. ``recording`` keeps,
    for each sequence run through a reference in its block, the two
    experts its gates pick at each (layer, position) (lax.top_k's picks:
    two first-max argmaxes, as ``_top2_dispatch`` and ``_top2_weights``
    take them). ``replaying`` wraps mixtral's ``_top2_weights`` (the
    port's, or a planted fault's): on a row whose own gates pick another
    pair, the gates outside the reference's pair are zeroed, so the
    wrapped function picks the reference's two and weighs them by the
    row's own gates; every other row goes through untouched. ``at`` names
    the rows of the next forward: (sequence, first position, real rows)
    per batch row. ``flips`` counts the pinned rows out of ``total``
    real (layer, token) picks; ``max_gap`` is the largest gate mass by
    which a row's own pair beat the reference's."""

    def __init__(self, mixtral, n_layers):
        self._m, self._n = mixtral, n_layers
        self.picks, self.rows, self.active = [], None, False
        self.calls = self.flips = self.total = 0
        self.max_gap = 0.0

    @staticmethod
    def pick(g):
        first = g.argmax(-1)
        second = g.scatter(-1, first[:, None], float("-inf")).argmax(-1)
        return torch.stack([first, second], -1)

    @contextlib.contextmanager
    def recording(self):
        real, layers = self._m.router_gates, []

        def spy(y, lp):
            g = real(y, lp)
            layers.append(self.pick(g))
            return g
        self._m.router_gates = spy
        try:
            yield
        finally:
            self._m.router_gates = real
        check(len(layers) == self._n, f"recorded {len(layers)} routings "
              f"for {self._n} layers")
        self.picks.append(torch.stack(layers))

    def at(self, rows):
        self.rows, self.calls = rows, 0

    @contextlib.contextmanager
    def replaying(self):
        real = self._m._top2_weights

        def pinned(g):
            layer = self.calls % self._n
            self.calls += 1
            own = self.pick(g)
            want = own.clone()
            t = g.shape[0] // len(self.rows)
            for r, (s, start, n) in enumerate(self.rows):
                want[r * t:r * t + n] = self.picks[s][layer, start:start + n]
            flip = (own.sort(-1).values != want.sort(-1).values).any(-1)
            n_flip = int(flip.sum())
            self.flips += n_flip
            self.total += sum(n for _, _, n in self.rows)
            if n_flip:
                gap = (g.gather(-1, own).sum(-1) -
                       g.gather(-1, want).sum(-1))[flip]
                self.max_gap = max(self.max_gap, float(gap.max()))
                e = g.shape[-1]
                keep = (torch.nn.functional.one_hot(want[:, 0], e) |
                        torch.nn.functional.one_hot(want[:, 1], e))
                g = torch.where(flip[:, None], g * keep, g)
            return real(g)

        self.calls = self.flips = self.total = 0
        self.max_gap = 0.0
        self._m._top2_weights, self.active = pinned, True
        try:
            yield
        finally:
            self._m._top2_weights, self.active = real, False


def _rel(a, b):
    """Norm-relative distance of logits a from the reference b, over
    every stream."""
    num = sum(float((x - y).double().norm() ** 2) for x, y in zip(a, b))
    den = sum(float(y.double().norm() ** 2) for y in b)
    return (num / den) ** 0.5


def _hold_cache_paths(label, llama, decode_engine, cfg, params, seqs, geo,
                      refs, dev, tol, faults=("self", "shift"), pins=None):
    """The dense and paged cache paths against the full forward's
    logits ``refs``: paged == dense bit for bit (the window is the dense
    tile), both within ``tol`` norm-relative, and each planted fault of
    ``faults`` past ``tol``; every run with its routing pinned by
    ``pins`` when given. Returns the paged logits."""
    dense = _cache_path_logits(llama, decode_engine, cfg, params, seqs, geo,
                               dev, paged=False, pins=pins)
    paged = _cache_path_logits(llama, decode_engine, cfg, params, seqs, geo,
                               dev, paged=True, pins=pins)
    check(all(torch.equal(a, b) for a, b in zip(paged, dense)),
          f"{label}: paged cache path logits differ from the dense path's "
          f"(window {geo['window']} = dense tile {geo['block']})")
    if pins is not None:
        print(f"{label}: routing pinned to the reference's picks; the "
              f"path's own gates picked another pair at {pins.flips} of "
              f"{pins.total} (layer, token) picks, by a gate mass of at "
              f"most {pins.max_gap:.3e}", flush=True)
    sound = _rel(paged, refs)
    faults = {f: _rel(_cache_path_logits(llama, decode_engine, cfg, params,
                                         seqs, geo, dev, paged=True,
                                         fault=f, pins=pins), refs)
              for f in faults}
    names = {"self": "own key masked", "shift": "positions shifted by one",
             "embed": "embed multiplier dropped",
             "unnorm": "gates left unnormalised", "top1": "top-1 routing"}
    print(f"{label}: dense and paged cache paths (chunk {geo['chunk']}, "
          f"window {geo['window']}) bit-equal; {sound:.3e} norm-relative "
          f"from the forward's logits (tol {tol:g})"
          + "".join(f"{', ' if i else '; planted faults: '}{names[f]} "
                    f"{r:.3e}" for i, (f, r) in enumerate(faults.items())),
          flush=True)
    check(sound <= tol, f"{label}: cache path logits {sound:.3e} from the "
          f"forward's, past {tol:g}")
    for f, r in faults.items():
        check(r > tol, f"{label}: the planted fault {f!r} reads {r:.3e}, "
              f"inside the tolerance {tol:g}: the gate cannot see it")
    return paged


def _teacher_forced(fa, llama, decode_engine, cfg, params, reqs, streams,
                    geo, dev, label="[serve]", tol=CACHE_REL_TOL):
    """The greedy streams through the model's forward (``llama``: the
    llama or gemma module; flash kernels) and through the engine's dense
    and paged cache paths: logits within ``tol``, planted faults past
    it, emitted tokens the forward's argmax except at near-ties."""
    fwd_cfg = dataclasses.replace(cfg, remat=False)
    ref_cfg = dataclasses.replace(fwd_cfg, attention_impl="reference")
    seqs = [(p, toks) for (p, temp, _), toks in zip(reqs, streams)
            if not temp]
    fa.reset_launches()
    full, ref_rels = [], []
    with torch.no_grad():
        for prompt, toks in seqs:
            seq = torch.tensor(prompt + toks, device=dev)[None]
            full.append(llama.forward(fwd_cfg, params, seq)[0,
                                                            len(prompt) - 1:-1])
        launches = dict(fa.LAUNCHES)
        cached = _hold_cache_paths(f"{label} teacher-forced greedy streams",
                                   llama, decode_engine, cfg, params, seqs,
                                   geo, full, dev, tol)
        check(dict(fa.LAUNCHES) == launches,
              f"the cache paths launched flash kernels {fa.LAUNCHES}")
        # Diagnostic, not a gate: the cache path against the forward
        # with the fp32 reference attention (the flash kernels round P
        # to bf16 before P V; the cache path keeps it in fp32).
        for (prompt, toks), c in zip(seqs, cached):
            seq = torch.tensor(prompt + toks, device=dev)[None]
            ref = llama.forward(ref_cfg, params, seq)[0, len(prompt) - 1:-1]
            ref_rels.append(float((c - ref).norm() / ref.norm()))
            del ref
    expect = dict.fromkeys(launches, 0)
    expect["flash_fwd"] = cfg.n_layers * len(seqs)
    check(launches == expect, f"teacher-forced launches {launches} != "
          f"{expect}")
    mismatches = _near_tie_tokens(seqs, full, cached, dev)
    print(f"{label} teacher-forced greedy streams (prompts "
          f"{[len(p) for p, _ in seqs]}): per stream "
          f"{[f'{_rel([c], [f]):.2e}' for c, f in zip(cached, full)]} "
          f"norm-relative from the forward's, "
          f"{[f'{x:.2e}' for x in ref_rels]} from its fp32 reference "
          f"attention's (not gated); launches {launches}; emitted != "
          f"forward argmax at {len(mismatches)} of "
          f"{len(seqs) * SV_MAX_TOKENS} tokens, each a near-tie "
          f"(prompt, token, gap, paths' max |logit diff|): "
          f"{[(n, i, round(g, 4), round(s, 4)) for n, i, g, s in mismatches]}",
          flush=True)
    return seqs, full


def _near_tie_tokens(seqs, full, cached, dev):
    """Each stream's emitted tokens against the argmax of the reference
    logits ``full``: where they differ, the gap between the two must lie
    within twice the largest |logit| difference between ``cached`` (the
    path that emitted them) and ``full``. Returns the (prompt length,
    token, gap, that difference) of each mismatch."""
    mismatches = []
    for (prompt, toks), f, c in zip(seqs, full, cached):
        scale = float((c - f).abs().max())
        emitted = torch.tensor(toks, device=dev)
        best = f.argmax(-1)
        for i in torch.nonzero(best != emitted).flatten().tolist():
            gap = float(f[i, best[i]] - f[i, emitted[i]])
            mismatches.append((len(prompt), i, gap, scale))
            check(gap <= 2 * scale,
                  f"prompt {len(prompt)} token {i}: emitted {toks[i]}, the "
                  f"forward's argmax {int(best[i])} by {gap:.4f}, past "
                  f"twice the paths' largest logit difference {scale:.4f}")
    return mismatches


def _first_divergence(llama, prng, cfg, params, prompt, temp, seed, a, b):
    """None when token lists a and b agree; else (index, gap): the two
    candidates' (gumbel-perturbed, when sampled) f32 logits apart at the
    first divergence, from a full forward on the shared prefix."""
    i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None:
        check(len(a) == len(b), "streams of different lengths")
        return None
    seq = torch.tensor(prompt + a[:i], device=params.embed.device)[None]
    with torch.no_grad():
        z = llama.forward(dataclasses.replace(cfg, remat=False), params,
                          seq)[0, -1]
        if temp:
            key = prng.fold_in(prng.fold_in(prng.key(0, seq.device), seed),
                               len(prompt) + i)
            z = z / temp + prng.gumbel(key, z.shape)
    return i, abs(float(z[a[i]] - z[b[i]]))


def _hold_equal(label, llama, prng, cfg, params, req, a, b):
    div = _first_divergence(llama, prng, cfg, params, *req, a, b)
    if div is None:
        print(f"[serve] {label}: equal ({len(a)} tokens)", flush=True)
        return
    i, gap = div
    print(f"[serve] {label}: first divergence at token {i}, logit gap "
          f"{gap:.2e} (near-tie bound {F32_NEAR_TIE})", flush=True)
    check(gap <= F32_NEAR_TIE, f"{label}: diverged at token {i} by {gap}")


def _exactness(llama, decode_engine, prng, dev):
    """f32 at the 8B width (4 layers), TF32 off: paged == dense ==
    decode (greedy), speculative on == off, and a seeded stream cut at
    token 16 and resumed == the uninterrupted one."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 matmuls are on")
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=SV_EXACT_LAYERS, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = llama.init(cfg, gen, dev)
    cpu = torch.Generator().manual_seed(8)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=cpu).tolist()
               for n in (40, 100, 200)]
    loop = torch.randint(1, cfg.vocab_size, (6,), generator=cpu).tolist()
    reqs = ([(p, 0.0, 0) for p in prompts] +
            [(prompts[1], SV_TEMP, 9), (loop * 8, 0.0, 0),
             (loop * 8, SV_TEMP, 3)])

    def run(**kw):
        eng = decode_engine.DecodeEngine(
            cfg, params, slots=4, max_seq=512, prefill_chunk=64,
            spec_ngram=2, device=dev, **kw).start()
        try:
            hs = [eng.submit(p, max_tokens=SV_EXACT_TOKENS, temperature=t,
                             seed=s) for p, t, s in reqs]
            return ([h.result(timeout=900) for h in hs],
                    sum(h.spec_drafted for h in hs), eng.kv_config())
        finally:
            eng.shutdown()
            eng.release()

    dense, _, _ = run(paged=False)
    paged, _, geo = run(paged=True)
    spec, drafted, _ = run(paged=True, spec_k=4)
    check(drafted > 0, "speculative decoding drafted nothing")
    for n, req in enumerate(reqs):
        _hold_equal(f"f32 request {n}: paged vs dense", llama, prng, cfg,
                    params, req, paged[n], dense[n])
        _hold_equal(f"f32 request {n}: spec_k 4 ({drafted} drafted in all) "
                    f"vs off", llama, prng, cfg, params, req, spec[n],
                    paged[n])
    with torch.no_grad():
        for n, req in enumerate(reqs[:3]):
            ref = llama.decode(cfg, params,
                               torch.tensor([req[0]], device=dev),
                               len(req[0]), SV_EXACT_TOKENS,
                               len(req[0]) + SV_EXACT_TOKENS)[0].tolist()
            _hold_equal(f"f32 request {n}: paged vs llama.decode", llama,
                        prng, cfg, params, req, paged[n], ref)
    prompt, temp, seed = reqs[3]
    eng = decode_engine.DecodeEngine(cfg, params, slots=4, max_seq=512,
                                     prefill_chunk=64, paged=True,
                                     device=dev).start()
    try:
        resumed = eng.submit(prompt, max_tokens=SV_EXACT_TOKENS - 16,
                             temperature=temp, seed=seed,
                             resume=paged[3][:16]).result(timeout=900)
    finally:
        eng.shutdown()
        eng.release()
    _hold_equal("f32 seeded stream cut at 16 and resumed vs uninterrupted",
                llama, prng, cfg, params, (prompt + paged[3][:16], temp,
                                           seed), resumed, paged[3][16:])
    seqs = [(reqs[n][0], paged[n]) for n in range(3)]
    with torch.no_grad():
        refs = [llama.forward(dataclasses.replace(cfg, remat=False), params,
                              torch.tensor([p + t], device=dev))[
                                  0, len(p) - 1:-1] for p, t in seqs]
    _hold_cache_paths("[serve] f32 teacher-forced greedy streams", llama,
                      decode_engine, cfg, params, seqs, geo, refs, dev,
                      F32_CACHE_REL_TOL)
    _spill_readmit(llama, decode_engine, prng, cfg, params, cpu, dev)
    return {"cfg": cfg, "seqs": seqs, "reqs": reqs, "streams": paged,
            "geo": geo, "refs": [r.float().cpu().numpy() for r in refs]}


def _spill_readmit(llama, decode_engine, prng, cfg, params, gen, dev):
    """The host tier on the card: one slot and a pool too small for two
    requests' blocks, so admitting B evicts A's cached prefix and spills
    it (clone on the compute stream, D2H on the side stream) while B's
    prefill rewrites those blocks; A again then re-admits them H2D. A's
    warm stream must equal its cold one."""
    a = (torch.randint(1, cfg.vocab_size, (SP_PROMPTS[0],),
                       generator=gen).tolist(), SV_TEMP, 11)
    b = torch.randint(1, cfg.vocab_size, (SP_PROMPTS[1],),
                      generator=gen).tolist()
    eng = decode_engine.DecodeEngine(
        cfg, params, slots=1, max_seq=512, prefill_chunk=64, paged=True,
        kv_pool_blocks=SP_POOL_BLOCKS, prefix_cache_mb=SP_HOST_MB,
        device=dev).start()
    try:
        def go(prompt, temp=0.0, seed=0):
            return eng.submit(prompt, max_tokens=SV_EXACT_TOKENS,
                              temperature=temp, seed=seed)
        cold = go(*a).result(timeout=900)
        go(b).result(timeout=900)
        deadline = time.monotonic() + 120
        while eng.spill_in_flight():
            check(time.monotonic() < deadline, "spill D2H never landed")
            time.sleep(0.01)
        spilled = eng.host_tier_stats()
        warm_req = go(*a)
        warm = warm_req.result(timeout=900)
        stats = eng.host_tier_stats()
    finally:
        eng.shutdown()
        eng.release()
    print(f"[serve] f32 host tier: {spilled['evict_spills']} blocks spilled "
          f"admitting B, {stats['readmitted_blocks']} re-admitted for A's "
          f"second run ({warm_req.cached_prompt_tokens} prompt tokens "
          f"cached, kv tier {warm_req.kv_tier}); host tier {stats}",
          flush=True)
    check(spilled["evict_spills"] > 0 and stats["readmitted_blocks"] > 0,
          f"the host tier neither spilled nor re-admitted: {stats}")
    _hold_equal("f32 seeded stream re-admitted from the host tier vs cold",
                llama, prng, cfg, params, a, warm, cold)


def phase_serve(fa, llama, card, dev="cuda"):
    """[serve]: the port's serve_llm at Llama-3-8B full width and depth
    (module docstring, phase 11)."""
    from skypilot_tpu_torch.observability import reqlog, stepstats
    from skypilot_tpu_torch.recipes import serve_llm
    from skypilot_tpu_torch.serve import decode_engine, prng
    reqlog.arm(sample=1.0)          # the stats frame before [DONE]
    stepstats.arm(ring=4096)
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device=dev).manual_seed(5)
    params = llama.init(cfg, gen, dev)
    reqs, ninth = _serve_requests(cfg, seed=6)
    print(f"[serve] llama3_8b, {cfg.n_layers} layers (full depth), "
          f"{cfg.num_params() / 1e9:.3f} B params, bf16; serve_llm with "
          f"{SV_SLOTS} engine slots, paged {SV_BLOCK}-token blocks, max_seq "
          f"{serve_llm.MAX_PROMPT_TOKENS + serve_llm.MAX_GEN_TOKENS}; prompts "
          f"{list(SV_PROMPTS)}, {SV_MAX_TOKENS} tokens each, even ones "
          f"greedy, odd ones T={SV_TEMP}", flush=True)
    ninth_tokens = []
    streams, geo = _serve_leg(fa, cfg, params, reqs, ninth, card,
                              "[serve bf16]", dev, ninth_out=ninth_tokens)
    torch.cuda.empty_cache()
    seqs, full = _teacher_forced(fa, llama, decode_engine, cfg, params,
                                 reqs, streams, geo, dev)
    full = [f.float().cpu().numpy() for f in full]
    torch.cuda.empty_cache()
    q_streams, _ = _serve_leg(fa, cfg, params, reqs, ninth, card,
                           "[serve int8]", dev, weight_quant=True,
                           kv_quant=True)
    greedy = [i for i, r in enumerate(reqs) if not r[1]]
    same = sum(a == b for i in greedy
               for a, b in zip(streams[i], q_streams[i]))
    print(f"[serve int8] greedy tokens equal to the bf16 leg's: {same} of "
          f"{len(greedy) * SV_MAX_TOKENS} (not a gate)", flush=True)
    torch.cuda.empty_cache()
    phase_lb(fa, cfg, params, reqs, card, dev)
    del params
    torch.cuda.empty_cache()
    f32 = _exactness(llama, decode_engine, prng, dev)
    stepstats.disarm()
    reqlog.disarm()
    # What [tp_serve] holds the tp-2 replica to: this one-card replica's
    # streams, its forward's logits on the greedy ones, the f32 leg's.
    return {"reqs": reqs, "ninth": ninth, "streams": streams,
            "ninth_tokens": ninth_tokens[0], "q_streams": q_streams, "seqs": seqs, "full": full,
            "geo": geo, "f32": f32}


def _data_frames(label, res, n_tokens):
    """The ``data:`` frames of one SSE response; fails unless it is 200,
    ends in [DONE] and carries ``n_tokens`` token frames."""
    check(res is not None and res["status"] == 200,
          f"{label}: no 200 response")
    data = [f for f in res["frames"] if f.startswith("data: ")]
    check(data and data[-1] == "data: [DONE]"
          and res["frames"][-1] == "data: [DONE]",
          f"{label}: the stream does not end in [DONE]")
    check(len(data) == n_tokens + 1,
          f"{label}: {len(data) - 1} token frames, not {n_tokens}")
    return data


def _scrape(target):
    from skypilot_tpu_torch.observability import promtext
    with urllib.request.urlopen(target + "/metrics", timeout=60) as resp:
        return promtext.parse(resp.read().decode())


def _lb_bytes(target, replica, reqs, card):
    """Leg (a): [serve]'s requests one at a time through the balancer and
    straight to the replica; the greedy ones' data frames equal."""
    from skypilot_tpu_torch.observability import promtext
    ports = {"lb": int(target.rsplit(":", 1)[1]),
             "direct": replica.server_address[1]}
    t0 = time.perf_counter()
    for i, (prompt, temp, seed) in enumerate(reqs):
        body = {"prompt": prompt, "max_tokens": LB_BYTES_TOKENS,
                "temperature": temp, "seed": seed, "stream": True}
        got = {}
        for name, port in ports.items():
            out = [None]
            _sse_generate(port, body, out, 0)
            got[name] = _data_frames(f"[lb] request {i} ({name})", out[0],
                                     LB_BYTES_TOKENS)
        same = got["lb"] == got["direct"]
        kind = "greedy" if temp == 0 else f"T={temp}"
        print(f"[lb] request {i} (prompt {len(prompt)}, {kind}): data "
              f"frames through the balancer "
              f"{'equal to' if same else 'DIFFER from'} the replica's "
              f"({LB_BYTES_TOKENS} tokens)", flush=True)
        check(same or temp != 0,
              f"[lb] greedy request {i}: the balancer's frames differ")
    fams = _scrape(target)
    ok = promtext.counter_total(fams, "stpu_lb_requests_total", code="200")
    check("stpu_engine_decode_tokens_total" in fams
          and "stpu_engine_ttft_seconds" in fams
          and "stpu_lb_request_duration_seconds" in fams
          and ok >= len(reqs),
          "[lb] the balancer's /metrics lacks the engine's or its own "
          "families")
    print(f"[lb] leg (a): {len(reqs)} requests byte-checked in "
          f"{time.perf_counter() - t0:.1f} s; /metrics: "
          f"{sum(n.startswith('stpu_engine_') for n in fams)} stpu_engine_* "
          f"and {sum(n.startswith('stpu_lb_') for n in fams)} stpu_lb_* "
          f"families, stpu_lb_requests_total{{code=\"200\"}} {ok:g} "
          f"({card})", flush=True)


def _lb_slo(target, spec, card):
    """Leg (b): the load generator through the balancer; every request
    must complete, the scraper must have read the merged metrics."""
    from skypilot_tpu_torch.benchmark import loadgen
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stpu-lb-slo-") as out:
        report = loadgen.run(target, spec, slo_ttft_s=LB_SLO_TTFT,
                             slo_tpot_s=LB_SLO_TPOT, scrape_interval=1.0,
                             out_dir=out, request_timeout=300.0)
    reqs, server = report["requests"], report["server"]
    ttft = report["latency_s"]["ttft"] or {}
    print(f"[lb] leg (b): loadgen chat mix, poisson {spec.qps:g} qps for "
          f"{spec.duration_s:g} s, max_tokens {spec.max_tokens}, seed "
          f"{spec.seed}: {reqs['scheduled']} scheduled, {reqs['ok']} ok; "
          f"slo_goodput {report['goodput']['fraction']} (TTFT <= "
          f"{LB_SLO_TTFT:g} s, TPOT <= {LB_SLO_TPOT:g} s), TTFT p50 "
          f"{ttft.get('p50')} s p99 {ttft.get('p99')} s, loadgen_tok_s "
          f"{report['tokens']['tok_s']}, achieved qps "
          f"{report['qps']['achieved']} (offered {report['qps']['offered']}"
          f"), schedule sha256 {report['schedule_sha256'][:16]}; server "
          f"engine TTFT {server.get('engine_ttft')}, {server['scrapes']} "
          f"scrapes; {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    check(reqs["scheduled"] > 0 and reqs["ok"] == reqs["scheduled"]
          and reqs["error"] == 0 and reqs["unfinished"] == 0,
          f"[lb] leg (b): not every request completed: {reqs}")
    # The engine's TTFT (observed at each first token) and the
    # balancer's own counter, read through one scrape of the balancer;
    # the balancer counts a request after its last byte, so the last may
    # land after the closing scrape.
    check(server["scrapes"] >= 2 and server["scrape_failures"] == 0
          and server.get("engine_ttft", {}).get("count", 0) >=
          reqs["scheduled"]
          and server.get("lb_requests_by_code", {}).get("200", 0) >= 1,
          f"[lb] leg (b): the scraper did not read the balancer's merged "
          f"metrics: {server}")


def _lb_kill(cfg, target, servers, card):
    """Leg (c): a greedy stream pinned to replica A; A torn down once
    LB_KILL_AFTER tokens reached the client; the balancer resumes it on
    B."""
    from skypilot_tpu_torch.observability import promtext
    from skypilot_tpu_torch.serve.load_balancing_policies import (
        PrefixAffinityPolicy)
    t0 = time.perf_counter()
    a, b = servers
    urls = [f"http://127.0.0.1:{h.server_address[1]}" for h in servers]
    gen = torch.Generator().manual_seed(7)
    for _ in range(64):
        body = {"prompt": torch.randint(1, cfg.vocab_size, (LB_KILL_PROMPT,),
                                        generator=gen).tolist(),
                "max_tokens": LB_KILL_TOKENS, "stream": True}
        probe = PrefixAffinityPolicy()
        probe.set_ready_replicas(urls)
        if probe.select_replica({"path": "/generate", "body": json.dumps(
                body).encode()}) == urls[0]:
            break
    else:
        raise PhaseError("[lb] no prompt routes to replica A")
    ref = [None]
    _sse_generate(b.server_address[1], body, ref, 0)
    ref = _data_frames("[lb] kill-free stream on B", ref[0], LB_KILL_TOKENS)
    resumes0 = promtext.counter_total(_scrape(target),
                                      "stpu_lb_stream_resumes_total",
                                      outcome="ok")
    asked, submit = [], b.engine.submit

    def spy(prompt, **kw):
        asked.append((kw.get("resume"), kw.get("max_tokens")))
        return submit(prompt, **kw)

    b.engine.submit = spy
    reached, seen = threading.Event(), []

    def on_frame(frames):
        if not reached.is_set() and len(frames) >= LB_KILL_AFTER:
            seen.extend(frames[:LB_KILL_AFTER])
            reached.set()

    out = [None]
    client = threading.Thread(target=_sse_generate, args=(
        int(target.rsplit(":", 1)[1]), body, out, 0, on_frame))
    try:
        client.start()
        check(reached.wait(timeout=600),
              f"[lb] leg (c): {LB_KILL_AFTER} tokens never arrived")
        t_kill = time.perf_counter()
        a.engine.shutdown()          # in-flight streams drop, no [DONE]
        a.shutdown()
        a.server_close()             # new connects are refused
        client.join(timeout=600)
    finally:
        b.engine.submit = submit
    check(not client.is_alive(), "[lb] leg (c): the stream never ended")
    data = _data_frames("[lb] leg (c) stream", out[0], LB_KILL_TOKENS)
    toks = [json.loads(f[len("data: "):])["token"] for f in data[:-1]]
    check(len(asked) == 1 and asked[0][0] is not None,
          f"[lb] leg (c): B was not asked to resume once: {asked}")
    emitted, rest = asked[0]
    k = len(emitted)
    check(k >= LB_KILL_AFTER and toks[:k] == emitted
          and data[:LB_KILL_AFTER] == seen
          and rest == LB_KILL_TOKENS - k,
          f"[lb] leg (c): the splice lost or repeated tokens: B resumed "
          f"after {k} tokens for {rest} more")
    # The balancer counts the resume after the spliced stream's last
    # byte: wait for the count, bounded.
    deadline = time.perf_counter() + 60
    while True:
        fams = _scrape(target)
        resumes = promtext.counter_total(
            fams, "stpu_lb_stream_resumes_total", outcome="ok")
        if resumes > resumes0 or time.perf_counter() > deadline:
            break
        time.sleep(0.05)
    check(resumes == resumes0 + 1,
          f"[lb] leg (c): stream resumes ok {resumes0:g} -> {resumes:g}")
    gap = promtext.histogram(fams, "stpu_lb_resume_gap_seconds")
    ref_toks = [json.loads(f[len("data: "):])["token"] for f in ref[:-1]]
    diff = [i for i in range(k, LB_KILL_TOKENS) if toks[i] != ref_toks[i]]
    print(f"[lb] leg (c): replica A torn down "
          f"{time.perf_counter() - t_kill:.2f} s before the stream's end, "
          f"after {LB_KILL_AFTER} of {LB_KILL_TOKENS} tokens reached the "
          f"client; B resumed at position {k} for {rest} tokens; the stream "
          f"completed with {len(toks)} token frames in [DONE]; resume gap "
          f"{gap.sum / max(gap.count, 1):.3f} s mean over {gap.count:g}; "
          f"stpu_lb_stream_resumes_total{{outcome=\"ok\"}} {resumes0:g} -> "
          f"{resumes:g}; A's {k} tokens equal to the kill-free stream's: "
          f"{toks[:k] == ref_toks[:k]}; B's tail equal to it: {not diff}"
          + (f" (first difference at token {diff[0]}, {len(diff)} differ)"
             if diff else "") + f" (not a gate); "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)


def phase_lb(fa, cfg, params, reqs, card, dev="cuda"):
    """[lb] legs (a)-(c) on [serve]'s bf16 params (module docstring,
    phase 16)."""
    from skypilot_tpu_torch.benchmark import decode_bench
    t0 = time.perf_counter()
    spec = decode_bench._slo_spec(cfg, LB_QPS, LB_DURATION, 0,
                                  LB_MAX_TOKENS)
    print(f"[lb] Llama-3-8B bf16, {cfg.n_layers} layers, serve_llm "
          f"replicas with {SV_SLOTS} slots and paged {SV_BLOCK}-token blocks "
          f"behind the port's load balancer (prefix_affinity)", flush=True)
    fa.reset_launches()
    with decode_bench._data_plane(cfg, params, dev, SV_SLOTS, 1,
                                  spec) as (target, servers):
        _lb_bytes(target, servers[0], reqs, card)
        _lb_slo(target, spec, card)
    torch.cuda.empty_cache()
    with decode_bench._data_plane(cfg, params, dev, SV_SLOTS, 2,
                                  spec) as (target, servers):
        _lb_kill(cfg, target, servers, card)
    launches = dict(fa.LAUNCHES)
    check(all(v == 0 for v in launches.values()),
          f"[lb] flash kernels launched on the serving path {launches}")
    print(f"[lb] legs (a)-(c) {time.perf_counter() - t0:.1f} s, no flash "
          f"kernel launched", flush=True)


def phase_lb_bench(card, dev="cuda"):
    """[lb]'s bench legs: decode_bench's measure_engine_slo and
    measure_engine_chaos for Llama at their default shape, once each."""
    from skypilot_tpu_torch.benchmark import decode_bench
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    slo = decode_bench.measure_engine_slo("llama", device=dev)
    print(f"[lb] measure_engine_slo: {json.dumps(slo)} ({card})",
          flush=True)
    chaos = decode_bench.measure_engine_chaos("llama", device=dev)
    print(f"[lb] measure_engine_chaos: {json.dumps(chaos)} ({card})",
          flush=True)
    check(slo["requests"] > 0 and chaos["requests"] > 0,
          "[lb] the bench legs scheduled nothing")
    print(f"[lb] bench legs {time.perf_counter() - t0:.1f} s", flush=True)


def _gemma_recipe(fa, trainer, records, label, fam, names, seq, batches,
                  steps, card, dev):
    """The Gemma LoRA recipe (recipes.gemma_lora.main) at Gemma-2B full
    width and depth, seq `seq`, `steps` steps with a save at the last, at
    the largest batch of `batches` that fits: launches exactly 2L/L/L of
    the width-256 kernels `names` of family `fam` per step and no other,
    the trained adapters lower the loss on the first batch, and one
    forward's loss within LOSS_TOL of the reference attention's."""
    from skypilot_tpu_torch.models import gemma
    from skypilot_tpu_torch.recipes import gemma_lora, llama_lora
    from skypilot_tpu_torch.train import checkpoint
    cfg = gemma.GemmaConfig.gemma_2b()
    check(seq <= cfg.max_seq_len and fa.family(seq, cfg.head_dim, True) == fam
          and fa.kernel_head_dim(cfg.head_dim) == 256,
          f"Gemma-2B's attention at seq {seq} does not take the width-256 "
          f"{fam} kernels")
    print(f"{label} gemma_2b, {cfg.n_layers} layers (full depth), "
          f"vocab {cfg.vocab_size}, {cfg.num_params() / 1e9:.3f} B params "
          f"frozen ({2 * cfg.num_params() / 1e9:.2f} GB bf16), head_dim "
          f"{cfg.head_dim}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV head, "
          f"rank-8 adapters on wq/wk/wv/wo, seq {seq}, {steps} steps, "
          f"remat {cfg.remat_policy}, {fam} kernels", flush=True)
    sigterm = signal.getsignal(signal.SIGTERM)  # the recipe installs its own
    with tempfile.TemporaryDirectory(prefix="stpu-gemma-lora-") as tmp:
        run = None
        for batch in batches:
            argv = ["--model", "2b", "--batch-size", str(batch),
                    "--seq-len", str(seq), "--steps", str(steps),
                    "--ckpt-every", str(steps)]
            ckpt = f"{tmp}/batch{batch}"
            try:
                torch.cuda.reset_peak_memory_stats()
                fa.reset_launches()
                with _trainstats_armed(f"{ckpt}-trainstats"):
                    run = _lora_run(gemma_lora, argv + [
                        "--checkpoint-dir", ckpt, "--device", dev])
                    _train_readings(label, run, cfg, seq, card,
                                    f"{ckpt}-trainstats")
                break
            except torch.cuda.OutOfMemoryError as exc:
                print(f"{label} batch {batch} x {seq} does not fit the "
                      f"card: {str(exc).split('. ')[0]}", flush=True)
            finally:
                signal.signal(signal.SIGTERM, sigterm)
            gc.collect()
            torch.cuda.empty_cache()
        check(run is not None, f"no batch of {batches} fits the card")
        launches = dict(fa.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cut = "" if batch == batches[0] else f" (cut from {batches[0]})"
        print(f"{label} batch {batch} x seq {seq}{cut}: {json.dumps(run)}",
              flush=True)
        print(f"{label} launches {launches}", flush=True)
        check(_finite([run["first_loss"], run["final_loss"]]),
              "non-finite loss")
        expect = _step_expect(launches, cfg.n_layers, steps, names)
        check(launches == expect, f"launch counts {launches} != {expect}")
        per_step = run["wall_seconds"] / steps
        print(f"{label} {per_step * 1e3:.0f} ms per step (wall over its "
              f"{steps} steps, the first and the step-{steps} save "
              f"included), {run['tokens_per_second']:.0f} tokens/s, peak "
              f"memory {peak_gb:.2f} GB", flush=True)
        for name in names:
            records[f"{name}@256"]["launches"] = launches[name]
            records[f"{name}@256"]["step_ms"] = per_step * 1e3
        args = llama_lora.build_arg_parser(list(gemma_lora.MODELS),
                                           "tiny").parse_args(argv)
        base, lora = llama_lora.init_model(gemma, cfg, args,
                                           torch.device(dev))
        llama_lora.load_lora(lora, checkpoint.restore_latest(
            ckpt, like={"lora": lora.stacked()}).tree["lora"])
    first = next(llama_lora.train_batches(cfg, args, 1))[0]
    tokens = torch.from_numpy(first).long().to(dev)
    params = llama_lora.merge_params(base, lora)
    with torch.no_grad():
        logits = gemma.forward(cfg, params, tokens)
        trained = float(trainer.cross_entropy_loss(logits[:, :-1],
                                                   tokens[:, 1:]))
        del logits
    print(f"{label} the first batch: loss {run['first_loss']:.5f} at step "
          f"1, {trained:.5f} with the step-{steps} adapters", flush=True)
    check(trained < run["first_loss"], "loss did not fall")
    _kernel_vs_reference(label, gemma.forward, cfg, params, tokens, trainer)


def phase_gemma_lora(fa, trainer, records, card, dev="cuda"):
    """[gemma_lora]: the recipe at examples/gemma_lora.yaml's seq 2048,
    where every attention call takes the width-256 resident kernels."""
    _gemma_recipe(fa, trainer, records, "[gemma_lora]", fa.RESIDENT,
                  RESIDENT_NAMES, GL_SEQ, GL_BATCHES, GL_STEPS, card, dev)


def phase_gemma_long(fa, trainer, records, card, dev="cuda"):
    """[gemma_long]: the recipe at Gemma-2B's own context (max_seq_len
    8192), where every attention call takes the width-256 triangular
    kernels."""
    _gemma_recipe(fa, trainer, records, "[gemma_long]", fa.TRIANGULAR,
                  TRI_NAMES, GLONG_SEQ, GLONG_BATCHES, GLONG_STEPS, card,
                  dev)


def phase_gemma_wide(fa, trainer, records):
    """[gemma_wide]: GW_STEPS adamw steps of Gemma-2B's widths at head_dim
    512 (GW_LAYERS layers, GW_BATCH x GW_SEQ) through make_train_step with
    [long]'s remat policy and chunked CE: the loss falls, launches exactly
    L/L/L of the width-512 triangular kernels a step and no other, and one
    forward's loss within LOSS_TOL of the reference attention's."""
    _gemma_wide_steps(fa, trainer, records, "[gemma_wide]", GW_HEAD_DIM,
                      GW_STEPS)


def phase_gemma_xwide(fa, trainer, records):
    """[gemma_xwide]: [gemma_wide] at head_dim GX_HEAD_DIM, GX_STEPS
    steps, through the width-1024 triangular clusters (4 CTAs an
    item)."""
    _gemma_wide_steps(fa, trainer, records, "[gemma_xwide]", GX_HEAD_DIM,
                      GX_STEPS)


def _gemma_wide_steps(fa, trainer, records, label, head_dim, steps):
    """`steps` adamw steps of Gemma-2B's widths at `head_dim` (GW_LAYERS
    layers, GW_BATCH x GW_SEQ), the gates of phase_gemma_wide; the
    triangular records at that width take the launches and step time."""
    from skypilot_tpu_torch.models import gemma
    cfg = dataclasses.replace(gemma.GemmaConfig(), n_layers=GW_LAYERS,
                              head_dim_=head_dim, max_seq_len=GW_SEQ,
                              remat_policy=LC_POLICY)
    width = fa.kernel_head_dim(cfg.head_dim)
    check(fa.family(GW_SEQ, cfg.head_dim, True) == fa.TRIANGULAR
          and width == head_dim,
          f"head_dim {cfg.head_dim} at seq {GW_SEQ} does not take the "
          f"width-{head_dim} triangular kernels")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = gemma.init(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (GW_BATCH, GW_SEQ),
                           device="cuda", generator=gen)
    batch = {"tokens": tokens}
    tx = trainer.make_optimizer(trainer.TrainConfig(warmup_steps=1,
                                                    total_steps=100))
    state = trainer.init_train_state(params, tx)
    step = trainer.make_train_step(
        lambda p, t: gemma.forward(cfg, p, t), tx,
        trunk_fn=lambda p, t: gemma.forward_trunk(cfg, p, t),
        head_fn=gemma.head_weights, with_grad_norm=False)
    print(f"{label} Gemma-2B widths, head_dim {cfg.head_dim} "
          f"({cfg.n_heads} heads / {cfg.n_kv_heads} KV head), {GW_LAYERS} "
          f"layers, {cfg.num_params() / 1e9:.3f} B params, batch "
          f"{GW_BATCH} x seq {GW_SEQ}, bf16, remat {cfg.remat_policy}, "
          f"chunked CE, adamw", flush=True)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    losses = [float(x) for x in losses]
    print(f"{label} losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"{label} launches {launches}", flush=True)
    check(_finite(losses), "non-finite loss")
    check(losses[-1] < losses[0], "loss did not fall")
    expect = dict.fromkeys(launches, 0)
    expect.update(dict.fromkeys(TRI_NAMES, GW_LAYERS * steps))
    check(launches == expect, f"launch counts {launches} != {expect} "
          f"(L width-{width} triangular forward, dq and dk/dv per step, no "
          "other)")
    steady = statistics.median(step_s[1:])
    print(f"{label} step {steady * 1e3:.1f} ms (median of steps 2-"
          f"{steps}; first {step_s[0] * 1e3:.1f} ms), "
          f"{GW_BATCH * GW_SEQ / steady:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    for name in TRI_NAMES:
        records[f"{name}@{width}"]["launches"] = launches[name]
        records[f"{name}@{width}"]["step_ms"] = steady * 1e3
    with torch.no_grad():
        out = {}
        for impl in ("kernel", "reference"):
            c = dataclasses.replace(cfg, attention_impl=impl, remat=False)
            hidden = gemma.forward_trunk(c, state.params, tokens)
            check(bool(torch.isfinite(hidden).all()),
                  f"non-finite hidden states from impl={impl}")
            out[impl] = float(trainer.chunked_cross_entropy_loss(
                hidden[:, :-1], gemma.head_weights(state.params),
                tokens[:, 1:]))
            del hidden
    diff = abs(out["kernel"] - out["reference"])
    print(f"{label} loss kernel {out['kernel']:.5f} reference "
          f"{out['reference']:.5f} |diff| {diff:.2e} (tol {LOSS_TOL})",
          flush=True)
    check(diff <= LOSS_TOL, "kernel forward disagrees with the reference")


def _gemma_exactness(decode_engine, prng, dev):
    """f32 at Gemma-2B's width cut to 4 layers, TF32 off: the engine's
    paged streams == its dense ones == gemma.decode (greedy), then the
    teacher-forced cache paths within F32_CACHE_REL_TOL of gemma.forward
    with three planted faults past it (own key, shift, and the serving
    embed without the multiplier). The forward and gemma.decode take the
    fp32 kernels at width 256."""
    from skypilot_tpu_torch.models import gemma
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 matmuls are on")
    cfg = dataclasses.replace(gemma.GemmaConfig.gemma_2b(),
                              n_layers=SV_EXACT_LAYERS, dtype=torch.float32)
    params = gemma.init(cfg, torch.Generator(device=dev).manual_seed(11),
                        dev)
    cpu = torch.Generator().manual_seed(12)
    reqs = [(torch.randint(1, cfg.vocab_size, (n,), generator=cpu).tolist(),
             0.0, 0) for n in (40, 100, 200)]

    def run(**kw):
        eng = decode_engine.DecodeEngine(
            cfg, params, slots=4, max_seq=512, prefill_chunk=64, device=dev,
            **kw).start()
        try:
            hs = [eng.submit(p, max_tokens=SV_EXACT_TOKENS) for p, _, _ in
                  reqs]
            return [h.result(timeout=900) for h in hs], eng.kv_config()
        finally:
            eng.shutdown()
            eng.release()

    dense, _ = run(paged=False)
    paged, geo = run(paged=True)
    with torch.no_grad():
        for n, req in enumerate(reqs):
            _hold_equal(f"gemma f32 request {n}: paged vs dense", gemma,
                        prng, cfg, params, req, paged[n], dense[n])
            ref = gemma.decode(cfg, params, torch.tensor([req[0]], device=dev),
                               len(req[0]), SV_EXACT_TOKENS,
                               len(req[0]) + SV_EXACT_TOKENS)[0].tolist()
            _hold_equal(f"gemma f32 request {n}: paged vs gemma.decode",
                        gemma, prng, cfg, params, req, paged[n], ref)
        seqs = [(reqs[n][0], paged[n]) for n in range(len(reqs))]
        refs = [gemma.forward(dataclasses.replace(cfg, remat=False), params,
                              torch.tensor([p + t], device=dev))[
                                  0, len(p) - 1:-1] for p, t in seqs]
    _hold_cache_paths("[gemma_serve] f32 teacher-forced greedy streams",
                      gemma, decode_engine, cfg, params, seqs, geo, refs, dev,
                      F32_CACHE_REL_TOL, faults=("self", "shift", "embed"))


def phase_gemma_serve(fa, card, dev="cuda"):
    """[gemma_serve]: [serve]'s bf16 leg on one Gemma-2B replica (full
    width and depth, random weights through gemma.init), the same nine
    requests and gates; then the f32 leg at 4 layers (_gemma_exactness).
    The int8 leg is left to the CPU tests."""
    from skypilot_tpu_torch.models import gemma
    from skypilot_tpu_torch.observability import reqlog, stepstats
    from skypilot_tpu_torch.recipes import serve_llm
    from skypilot_tpu_torch.serve import decode_engine, prng
    gc.collect()            # the engines and replicas of [serve]
    torch.cuda.empty_cache()
    reqlog.arm(sample=1.0)
    stepstats.arm(ring=4096)
    cfg = gemma.GemmaConfig.gemma_2b()
    params = gemma.init(cfg, torch.Generator(device=dev).manual_seed(9), dev)
    reqs, ninth = _serve_requests(cfg, seed=10)
    print(f"[gemma_serve] gemma_2b, {cfg.n_layers} layers (full depth), "
          f"{cfg.num_params() / 1e9:.3f} B params, bf16; serve_llm with "
          f"{SV_SLOTS} engine slots, paged {SV_BLOCK}-token blocks, max_seq "
          f"{serve_llm.MAX_PROMPT_TOKENS + serve_llm.MAX_GEN_TOKENS}; prompts "
          f"{list(SV_PROMPTS)}, {SV_MAX_TOKENS} tokens each, even ones "
          f"greedy, odd ones T={SV_TEMP}", flush=True)
    streams, geo = _serve_leg(fa, cfg, params, reqs, ninth, card,
                              "[gemma_serve bf16]", dev)
    torch.cuda.empty_cache()
    _teacher_forced(fa, gemma, decode_engine, cfg, params, reqs, streams,
                    geo, dev, label="[gemma_serve]", tol=GEMMA_CACHE_REL_TOL)
    del params
    torch.cuda.empty_cache()
    _gemma_exactness(decode_engine, prng, dev)
    stepstats.disarm()
    reqlog.disarm()


class _NoDropMixtral:
    """The mixtral module with ``forward`` returning the logits of its
    capacity forward at capacity_factor = n_experts / top_k, which makes
    the capacity C = T: no token is dropped, so the capacity path equals
    dense routing (tests/test_mixtral.py's premise). The reference of the
    teacher-forced checks and of ``_first_divergence``; every cache
    function is mixtral's own."""

    def __init__(self, mixtral):
        self._mixtral = mixtral

    def __getattr__(self, name):
        return getattr(self._mixtral, name)

    def forward(self, cfg, params, tokens):
        roomy = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k, remat=False)
        return self._mixtral.forward(roomy, params, tokens)[0]


def _whole_prefill(mixtral, cfg, params, seqs, dev, fault=None,
                   pins=None):
    """Each (prompt, tokens) as one fresh prefill of prompt + tokens[:-1]
    through the dense cache path: f32 (len(tokens), vocab), row j
    predicting tokens[j]. ``fault``: one of ``_planted``'s, patched in
    for the run; ``pins``: a ``_RoutingPins`` recording its picks."""
    out = []
    with _planting(fault), torch.inference_mode():
        for prompt, toks in seqs:
            seq = torch.tensor(prompt + toks[:-1], device=dev)[None]
            with pins.recording() if pins else contextlib.nullcontext():
                z, _ = mixtral.forward_with_cache(
                    cfg, params, seq,
                    mixtral.init_cache(cfg, 1, seq.shape[1], dev), 0)
            out.append(z[0, len(prompt) - 1:])
    return out


def _profile_decode(decode_engine, cfg, params, dev, label, card, **kw):
    """One engine's decode step with SV_SLOTS live slots at context
    MXS_PROFILE_CONTEXT, under torch.profiler: device kernels and copies
    a step, device busy time a step and the idle share of the window."""
    from torch.autograd import DeviceType
    eng = decode_engine.DecodeEngine(cfg, params, slots=SV_SLOTS,
                                     max_seq=1280, prefill_chunk=SV_BLOCK,
                                     paged=True, device=dev, **kw)
    try:
        gen = torch.Generator().manual_seed(13)
        for _ in range(SV_SLOTS):
            eng.submit(torch.randint(1, cfg.vocab_size,
                                     (MXS_PROFILE_CONTEXT - 1,),
                                     generator=gen).tolist(), max_tokens=16)
        eng._admit()
        while eng._prefill_one():
            pass
        for _ in range(2):
            eng._decode_step()
        n = 3
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA],
                acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                check(eng._decode_step() == SV_SLOTS,
                      f"{label}: a profiled step decoded a slot short")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        eng.shutdown()
        eng.release()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e6, c + 1)
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
    print(f"{label} one decode step, {SV_SLOTS} live slots at context "
          f"{MXS_PROFILE_CONTEXT} (torch.profiler, {n} steps): "
          f"{wall / n * 1e3:.1f} ms a step, device busy "
          f"{busy / n * 1e3:.1f} ms, idle share "
          f"{max(0.0, 1 - busy / wall):.3f}, "
          f"{sum(c for _, c in by_name.values()) / n:.0f} kernels and copies "
          f"a step; the most device time: " + "; ".join(
              f"{t / n * 1e3:.1f} ms in {c // n} x {name[:70]}"
              for name, (t, c) in top) + f" ({card})", flush=True)


def _mixtral_int8_leg(fa, mixtral, decode_engine, shim, card, dev):
    """[mixtral_serve] leg 1: the int8 tree at full width, depth
    MXS_INT8_LAYERS, built by serve_llm's own --model mixtral-8x7b
    --weight-quant 1 (a layer at a time) and served through serve_llm (SV_SLOTS slots,
    paged, the nine requests). On the greedy streams, the batched T = 1
    steps against a fresh prefill over each whole prefix: as served
    (within MIXTRAL_ROUTED_REL_TOL, the routing faults planted in the
    prefill past it, the emitted tokens its argmax but at near-ties), and
    with routing pinned to the prefill's picks (paged == dense bit for
    bit, within MIXTRAL_CACHE_REL_TOL, the own-key fault past it: the
    nearest in leg 2, whose pinned gate sees all four);
    one profiled decode step. Returns the greedy (prompt, tokens) and the
    geometry."""
    from skypilot_tpu_torch.recipes import serve_llm
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = serve_llm.MODELS["mixtral-8x7b"]
    serve_llm.MODELS["mixtral-8x7b"] = lambda: dataclasses.replace(
        full(), n_layers=MXS_INT8_LAYERS)
    try:
        cfg, tree = serve_llm._build_model(serve_llm._parser().parse_args(
            ["--model", "mixtral-8x7b", "--weight-quant", "1", "--seed",
             "14"]), torch.device(dev))
    finally:
        serve_llm.MODELS["mixtral-8x7b"] = full
    torch.cuda.synchronize()
    check(mixtral.params_quantized(tree), "serve_llm built a bf16 tree")
    nbytes = sum(p.numel() * p.element_size() for p in tree.parameters())
    print(f"[mixtral_serve] mixtral_8x7b, {cfg.n_layers} layers (depth "
          f"cut from 32), {cfg.num_params() / 1e9:.3f} B params "
          f"({2 * cfg.num_params() / 1e9:.1f} GB in bf16): int8 tree built "
          f"a layer at a time by serve_llm --model mixtral-8x7b "
          f"--weight-quant 1 in {time.perf_counter() - t0:.1f} s, "
          f"{nbytes / 1e9:.2f} GB, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB while building; "
          f"KV {2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2} B a "
          f"token; serve_llm with {SV_SLOTS} engine slots, paged "
          f"{SV_BLOCK}-token blocks; prompts {list(SV_PROMPTS)}, "
          f"{SV_MAX_TOKENS} tokens each, even ones greedy, odd ones "
          f"T={SV_TEMP}", flush=True)
    reqs, ninth = _serve_requests(cfg, seed=15)
    streams, geo = _serve_leg(fa, cfg, tree, reqs, ninth, card,
                              "[mixtral_serve int8]", dev, weight_quant=True)
    torch.cuda.empty_cache()
    seqs = [(p, toks) for (p, temp, _), toks in zip(reqs, streams)
            if not temp]
    label = "[mixtral_serve int8] greedy streams"
    pins = _RoutingPins(mixtral, cfg.n_layers)
    whole = _whole_prefill(mixtral, cfg, tree, seqs, dev, pins=pins)
    routed = _cache_path_logits(shim, decode_engine, cfg, tree, seqs, geo,
                                dev, paged=True)
    sound = _rel(routed, whole)
    # The controls: each routing fault planted in the whole prefill.
    faults = {f: _rel(routed, _whole_prefill(mixtral, cfg, tree, seqs, dev,
                                             fault=f))
              for f in ("unnorm", "top1")}
    mismatches = _near_tie_tokens(seqs, whole, routed, dev)
    print(f"{label}, batched T = 1 steps (paged) as served against a fresh "
          f"prefill over each whole prefix: {sound:.3e} norm-relative (tol "
          f"{MIXTRAL_ROUTED_REL_TOL:g}), per stream "
          f"{[f'{_rel([c], [w]):.2e}' for c, w in zip(routed, whole)]}; the "
          f"whole prefill with its gates left unnormalised "
          f"{faults['unnorm']:.3e}, with top-1 routing {faults['top1']:.3e}; "
          f"emitted != the whole prefill's argmax at {len(mismatches)} of "
          f"{len(seqs) * SV_MAX_TOKENS} tokens, each a near-tie (prompt, "
          f"token, gap, paths' max |logit diff|): "
          f"{[(n, i, round(g, 4), round(d, 4)) for n, i, g, d in mismatches]}",
          flush=True)
    check(sound <= MIXTRAL_ROUTED_REL_TOL, f"{label}: {sound:.3e} past "
          f"{MIXTRAL_ROUTED_REL_TOL:g}")
    for f, r in faults.items():
        check(r > MIXTRAL_ROUTED_REL_TOL, f"{label}: the planted fault {f!r} "
              f"reads {r:.3e}, inside {MIXTRAL_ROUTED_REL_TOL:g}")
    del routed
    _hold_cache_paths(
        f"{label}, batched T = 1 steps against a fresh prefill over each "
        f"whole prefix, routing pinned", shim, decode_engine, cfg, tree,
        seqs, geo, whole, dev, MIXTRAL_CACHE_REL_TOL, faults=("self",),
        pins=pins)
    del whole
    torch.cuda.empty_cache()
    _profile_decode(decode_engine, cfg, tree, dev, "[mixtral_serve int8]",
                    card, weight_quant=True)
    return seqs, geo


def _mixtral_bf16_leg(fa, mixtral, decode_engine, shim, seqs, geo, card,
                      dev):
    """[mixtral_serve] leg 2, bf16 at full width and MXS_BF16_LAYERS
    layers: the greedy streams teacher-forced through the paged cache
    path as served and through the dense and paged paths with routing
    pinned, against the no-drop forward (one sequence at a time: the
    dispatch tensor is (T, E, T)), four faults past the pinned gate; then
    the int8 cache path's (weights and KV) top-1 agreement with the bf16
    one's."""
    cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                              n_layers=MXS_BF16_LAYERS)
    params = mixtral.init(cfg, torch.Generator(device=dev).manual_seed(16),
                          dev)
    print(f"[mixtral_serve bf16] mixtral_8x7b width, {cfg.n_layers} layers, "
          f"{cfg.num_params() / 1e9:.3f} B params, bf16; reference "
          f"mixtral.forward at capacity_factor {cfg.n_experts / cfg.top_k:g} "
          f"(C = T, no token dropped)", flush=True)
    fa.reset_launches()
    pins = _RoutingPins(mixtral, cfg.n_layers)
    refs = []
    with torch.no_grad():
        for p, t in seqs:
            with pins.recording():
                refs.append(shim.forward(cfg, params, torch.tensor(
                    [p + t], device=dev))[0, len(p) - 1:-1])
    launches = dict(fa.LAUNCHES)
    expect = dict.fromkeys(launches, 0)
    expect["flash_fwd"] = cfg.n_layers * len(seqs)
    check(launches == expect, f"[mixtral_serve bf16] forward launches "
          f"{launches} != {expect}")
    label = "[mixtral_serve bf16] teacher-forced greedy streams"
    bf16 = _cache_path_logits(shim, decode_engine, cfg, params, seqs, geo,
                              dev, paged=True)
    sound = _rel(bf16, refs)
    print(f"{label}, paged cache path as served: {sound:.3e} norm-relative "
          f"from the forward's (tol {MIXTRAL_ROUTED_REL_TOL:g}), per stream "
          f"{[f'{_rel([c], [r]):.2e}' for c, r in zip(bf16, refs)]}; "
          f"forward launches {launches}", flush=True)
    check(sound <= MIXTRAL_ROUTED_REL_TOL, f"{label}: {sound:.3e} past "
          f"{MIXTRAL_ROUTED_REL_TOL:g}")
    _hold_cache_paths(f"{label}, routing pinned", shim, decode_engine, cfg,
                      params, seqs, geo, refs, dev, MIXTRAL_CACHE_REL_TOL,
                      faults=("self", "shift", "unnorm", "top1"), pins=pins)
    del refs
    q8 = _cache_path_logits(shim, decode_engine, cfg,
                            mixtral.quantize_params(cfg, params), seqs,
                            dict(geo, kv_quant=1), dev, paged=True)
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(q8, bf16))
    total = sum(len(t) for _, t in seqs)
    print(f"[mixtral_serve bf16] int8 weights and KV, paged cache path: "
          f"top-1 equal to the bf16 path's at {agree} of {total} "
          f"teacher-forced positions ({agree / total:.3f}, floor "
          f"{MXS_TOP1_FLOOR}); {_rel(q8, bf16):.3e} norm-relative apart "
          f"({card})", flush=True)
    check(agree / total >= MXS_TOP1_FLOOR,
          f"int8 top-1 agreement {agree / total:.3f} under {MXS_TOP1_FLOOR}")


def _mixtral_exactness(fa, mixtral, decode_engine, prng, shim, dev):
    """[mixtral_serve] leg 3, f32 at full width and MXS_F32_LAYERS layers,
    TF32 off: paged == dense == mixtral.decode on the greedy streams,
    speculative decoding on == off (greedy and seeded), and the
    teacher-forced cache paths within F32_CACHE_REL_TOL of the no-drop
    forward (fp32 kernels) with both routing faults past it."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 matmuls are on")
    cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                              n_layers=MXS_F32_LAYERS, dtype=torch.float32)
    params = mixtral.init(cfg, torch.Generator(device=dev).manual_seed(17),
                          dev)
    cpu = torch.Generator().manual_seed(18)
    # Prompt + tokens a multiple of 8, so every forward takes the kernels.
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=cpu).tolist()
               for n in (40, 96, 200)]
    loop = torch.randint(1, cfg.vocab_size, (6,), generator=cpu).tolist()
    reqs = ([(p, 0.0, 0) for p in prompts] +
            [(prompts[1], SV_TEMP, 9), (loop * 8, 0.0, 0),
             (loop * 8, SV_TEMP, 3)])
    print(f"[mixtral_serve f32] mixtral_8x7b width, {cfg.n_layers} layers, "
          f"{cfg.num_params() / 1e9:.3f} B params, f32", flush=True)

    def run(**kw):
        eng = decode_engine.DecodeEngine(
            cfg, params, slots=4, max_seq=512, prefill_chunk=64,
            spec_ngram=2, device=dev, **kw).start()
        try:
            hs = [eng.submit(p, max_tokens=SV_EXACT_TOKENS, temperature=t,
                             seed=s) for p, t, s in reqs]
            return ([h.result(timeout=900) for h in hs],
                    sum(h.spec_drafted for h in hs), eng.kv_config())
        finally:
            eng.shutdown()
            eng.release()

    dense, _, _ = run(paged=False)
    paged, _, geo = run(paged=True)
    spec, drafted, _ = run(paged=True, spec_k=4)
    check(drafted > 0, "speculative decoding drafted nothing")
    for n, req in enumerate(reqs):
        _hold_equal(f"mixtral f32 request {n}: paged vs dense", shim, prng,
                    cfg, params, req, paged[n], dense[n])
        _hold_equal(f"mixtral f32 request {n}: spec_k 4 ({drafted} drafted "
                    f"in all) vs off", shim, prng, cfg, params, req, spec[n],
                    paged[n])
    seqs = [(reqs[n][0], paged[n]) for n in range(len(prompts))]
    with torch.no_grad():
        for n, (prompt, toks) in enumerate(seqs):
            ref = mixtral.decode(cfg, params,
                                 torch.tensor([prompt], device=dev),
                                 len(prompt), SV_EXACT_TOKENS,
                                 len(prompt) + SV_EXACT_TOKENS)[0].tolist()
            _hold_equal(f"mixtral f32 request {n}: paged vs mixtral.decode",
                        shim, prng, cfg, params, reqs[n], toks, ref)
        fa.reset_launches()
        refs = [shim.forward(cfg, params, torch.tensor([p + t], device=dev))[
            0, len(p) - 1:-1] for p, t in seqs]
    launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    check(launches == {"flash_fwd_f32": cfg.n_layers * len(seqs)},
          f"[mixtral_serve f32] forward launches {launches}, not "
          f"{cfg.n_layers * len(seqs)} of flash_fwd_f32 alone")
    _hold_cache_paths("[mixtral_serve f32] teacher-forced greedy streams",
                      shim, decode_engine, cfg, params, seqs, geo, refs, dev,
                      F32_CACHE_REL_TOL, faults=("unnorm", "top1"))
    print(f"[mixtral_serve f32] forward launches {launches}", flush=True)


def phase_mixtral_serve(fa, card, dev="cuda"):
    """[mixtral_serve]: Mixtral's serving half at full width (module
    docstring, phase 15)."""
    from skypilot_tpu_torch.models import mixtral
    from skypilot_tpu_torch.observability import reqlog, stepstats
    from skypilot_tpu_torch.serve import decode_engine, prng
    gc.collect()
    torch.cuda.empty_cache()
    reqlog.arm(sample=1.0)
    stepstats.arm(ring=4096)
    shim = _NoDropMixtral(mixtral)
    legs = []
    t0 = time.perf_counter()
    seqs, geo = _mixtral_int8_leg(fa, mixtral, decode_engine, shim, card,
                                  dev)
    gc.collect()
    torch.cuda.empty_cache()
    legs.append(time.perf_counter() - t0)
    _mixtral_bf16_leg(fa, mixtral, decode_engine, shim, seqs, geo, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    legs.append(time.perf_counter() - t0 - sum(legs))
    _mixtral_exactness(fa, mixtral, decode_engine, prng, shim, dev)
    legs.append(time.perf_counter() - t0 - sum(legs))
    stepstats.disarm()
    reqlog.disarm()
    print(f"[mixtral_serve] {sum(legs):.1f} s: int8 leg {legs[0]:.1f} s, "
          f"bf16 leg {legs[1]:.1f} s, f32 leg {legs[2]:.1f} s", flush=True)


def phase_decode_bench(card, dev="cuda"):
    """[decode_bench]: the port's measurement core at the JAX bench's
    Mixtral shapes (decode_bench.build), once each: the fixed-batch
    decode and the paged engine under the mixed-length mix."""
    from skypilot_tpu_torch.benchmark import decode_bench
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fixed = decode_bench.measure_decode("mixtral", repeats=1, device=dev)
    print(f"[decode_bench] measure_decode: {json.dumps(fixed)} ({card})",
          flush=True)
    paged = decode_bench.measure_engine_paged("mixtral", device=dev)
    print(f"[decode_bench] measure_engine_paged: {json.dumps(paged)} "
          f"({card})", flush=True)
    check(fixed["tokens_per_sec"] > 0 and paged["generated_tokens"] > 0,
          "decode_bench measured nothing")
    print(f"[decode_bench] {time.perf_counter() - t0:.1f} s", flush=True)


def phase_tune(card, dev="cuda"):
    """[tune]: the port's engine sweep (tune/sweep.py) for Llama's paged
    mode at decode_bench.build("llama")'s shape, quick budgets, on the
    card: every probe's tokens/s, the winner beside the default. The
    manifest it writes must validate, name this card as its device, hold
    a winner that passes the parity gate on the card; read back through
    STPU_TUNE_MANIFEST, the engine's geometry takes the winner's chunk and
    window and the manifest's tag, while a decode_bench engine built
    beside it keeps the default constants."""
    from skypilot_tpu_torch.benchmark import decode_bench
    from skypilot_tpu_torch.serve import decode_engine
    from skypilot_tpu_torch.tune import manifest, parity, sweep
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    key = manifest.tuning_key("llama", TUNE_SLOTS)
    with tempfile.TemporaryDirectory(prefix="stpu-tune-") as tmp:
        out = pathlib.Path(tmp) / "manifest.json"
        doc = sweep.run_sweep(
            families=("llama",), modes=("paged",), quick=True,
            slots=TUNE_SLOTS, out_path=out, device=dev,
            log=lambda line: print(f"[tune] {line}", flush=True))
        sweep_s = time.perf_counter() - t0
        with open(out) as f:
            payload = manifest.validate(json.load(f))
        prov = payload["provenance"]
        entry = payload["entries"].get(key)
        print(f"[tune] manifest {doc['sha256'][:12]} ({card}): "
              f"{json.dumps(payload)}", flush=True)
        check(prov["device_kind"] == torch.cuda.get_device_name(0),
              f"manifest device_kind {prov['device_kind']!r}")
        check(entry is not None and entry["parity"] == "pass",
              f"no parity-gated winner for {key}")
        objective = entry["objective"][sweep._LEG_KEY["paged"]]
        print(f"[tune] winner chunk {entry['chunk']} window_blocks "
              f"{entry['window_blocks']}: {objective['tok_s']} tokens/s vs "
              f"the default's {objective['default_tok_s']} "
              f"({sweep.DEFAULTS['paged']}) ({card})", flush=True)
        parity.check_parity("llama", chunk=entry["chunk"],
                            window_blocks=entry["window_blocks"],
                            paged=True, device=dev)
        os.environ[manifest.ENV_MANIFEST] = str(out)
        try:
            geo = decode_engine.resolve_kv_geometry(
                slots=TUNE_SLOTS, max_seq=TUNE_MAX_SEQ, paged=True,
                family="llama")
            mdl, cfg = decode_bench.build("llama", tiny=True)
            params = mdl.init(cfg, torch.Generator(dev).manual_seed(0), dev)
            bench = decode_bench._engine(cfg, params, torch.device(dev),
                                         slots=TUNE_SLOTS, max_seq=256,
                                         paged=True)
            bench_kv = bench.kv_config()
            decode_bench._close(bench)
        finally:
            os.environ[manifest.ENV_MANIFEST] = "0"
    print(f"[tune] engine geometry from the manifest: {json.dumps(geo)}; "
          f"a decode_bench engine beside it: manifest "
          f"{bench_kv['manifest']!r}, chunk {bench_kv['chunk']}", flush=True)
    window = min(entry["window_blocks"] * entry["chunk"],
                 TUNE_MAX_SEQ // entry["chunk"] * entry["chunk"])
    check((geo["chunk"], geo["window"], geo["manifest"]) ==
          (entry["chunk"], window, doc["sha256"][:12]),
          "the engine did not take the manifest's constants")
    check(bench_kv["manifest"] == "default",
          "a decode_bench engine read the manifest")
    print(f"[tune] {time.perf_counter() - t0:.1f} s (sweep {sweep_s:.1f} s)",
          flush=True)


# ------------------------------------------------------------ [tp_serve]
# The tp phase: a tp-2 replica on the one card. NCCL refuses two ranks on
# one device, so the two ranks share cuda:0 over a gloo group (gloo carries
# CUDA tensors for all_reduce, all_gather and broadcast, the collectives
# of the tp path: group_reduce and the vocab-parallel embedding's
# sum, the logits' gather, the plans' broadcast on a gloo group of their own).
TP_DEGREE, TP_BACKEND = 2, "gloo"
# Leg (c): the request after the whole-gang restart, against its own run
# before the kill; leg (e): Mixtral at full width cut to this depth, each
# of four prompts of [serve]'s lengths greedy for this many tokens; leg (d):
# measure_engine_tp at Llama-3-8B width cut to this depth.
TP_FAILOVER_TOKENS = 16
# The planted fault's pass teacher-forces the first TP_FAULT_TOKENS of each
# stream (positions one late shows from the first step); leg (b) runs the
# greedy requests for TP_INT8_TOKENS tokens, against the same prefix of
# the one-card int8 streams.
TP_FAULT_TOKENS, TP_INT8_TOKENS = 32, 32
TP_MIXTRAL_LAYERS, TP_MIXTRAL_TOKENS = 2, 32
TP_BENCH_LAYERS = 4


def _tp_model(leg, mesh, rules):
    """A rank's (module, config, serving tree): the leg's model from its
    seed on the card, int8 when asked (the whole tree, then sharded)."""
    from skypilot_tpu_torch.models import llama, mixtral
    from skypilot_tpu_torch.serve import gang_replica
    mod = {"llama": llama, "mixtral": mixtral}[leg["family"]]
    cfg, dev = leg["cfg"], leg["device"]
    params = mod.init(cfg, torch.Generator(device=dev).manual_seed(
        leg["seed"]), dev)
    if leg.get("int8"):
        params = mod.quantize_params(cfg, params)
    return mod, cfg, gang_replica.shard_params(cfg, params, mesh, rules)


def _tp_leg_teacher(leg, mesh, rules, rank):
    """The greedy streams teacher-forced on a tp rank: the model's forward
    over its heads (flash_fwd on 16 query and 4 KV heads at Llama-3-8B),
    the paged cache path and the path with positions one late, each
    against the one-card forward's logits; rank 0's readings."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.serve import decode_engine, gang_replica
    _, cfg, tp = _tp_model(leg, mesh, rules)
    dev = leg["device"]
    kvh = gang_replica.local_kv_heads(cfg, TP_DEGREE)
    fwd_cfg = dataclasses.replace(cfg, remat=False)
    fa.reset_launches()
    fwd = []
    with torch.no_grad():
        for prompt, toks in leg["seqs"]:
            seq = torch.tensor([prompt + toks], device=dev)
            pos = torch.arange(seq.shape[1], device=dev)[None]
            x = llama._decode_embed(fwd_cfg, tp, seq)
            for view in tp.layers:
                x = llama.mlp_block(fwd_cfg, llama.attention_block(
                    fwd_cfg, x, view, pos), view)
            fwd.append(llama.lm_head(fwd_cfg, tp, x)[
                0, len(prompt) - 1:-1].float().cpu())
        launches = dict(fa.LAUNCHES)
        kw = dict(paged=True, kv_heads=kvh)
        sound = [z.float().cpu() for z in _cache_path_logits(
            llama, decode_engine, cfg, tp, leg["seqs"], leg["geo"], dev,
            **kw)]
        short = [(p, t[:TP_FAULT_TOKENS]) for p, t in leg["seqs"]]
        shift = [z.float().cpu() for z in _cache_path_logits(
            llama, decode_engine, cfg, tp, short, leg["geo"], dev,
            fault="shift", **kw)]
    if rank:
        return None
    refs = [torch.from_numpy(r) for r in leg["refs"]]
    return {"launches": launches, "fwd": _rel(fwd, refs),
            "sound": _rel(sound, refs),
            "shift": _rel(shift, [r[:TP_FAULT_TOKENS] for r in refs]),
            "per_stream": [_rel([c], [r]) for c, r in zip(sound, refs)],
            "maxdiff": [(c - r).abs().amax(-1).numpy()
                        for c, r in zip(sound, refs)]}


def _tp_leg_engine(leg, mesh, rules, rank):
    """The leg's requests through a tp engine (rank 0 schedules, rank 1
    serves its plans); rank 0's streams."""
    from skypilot_tpu_torch.serve import decode_engine
    _, cfg, tp = _tp_model(leg, mesh, rules)
    eng = decode_engine.DecodeEngine(
        cfg, tp, mesh=mesh, rules=rules, device=leg["device"],
        use_manifest=False, weight_quant=bool(leg.get("int8")),
        **leg["engine"])
    if rank:
        eng.work()
        eng.release()
        return None
    eng.start()
    t0 = time.perf_counter()
    try:
        hs = [eng.submit(p, max_tokens=n, temperature=t, seed=s)
              for p, t, s, n in leg["reqs"]]
        streams = [h.result(timeout=900) for h in hs]
    finally:
        eng.shutdown()
        eng.release()
    return {"streams": streams, "seconds": time.perf_counter() - t0,
            "kv": eng.kv_config()}


_TP_LEGS = {"teacher": _tp_leg_teacher, "engine": _tp_leg_engine}


def _tp_rank_main(work: pathlib.Path, rank: int, addr: str) -> int:
    """``chip_smoke.py tp-rank <dir> <rank> <addr>``: one rank of
    [tp_serve]'s legs (``<dir>/job.pkl``) on their device (the card's
    cuda:0 for both ranks); rank 0 writes ``<dir>/result.pkl``."""
    import pickle
    os.environ["STPU_TUNE_MANIFEST"] = "0"
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from skypilot_tpu_torch.serve import gang_replica
    job = pickle.loads((work / "job.pkl").read_bytes())
    torch.backends.cuda.matmul.allow_tf32 = False
    group = gang_replica.TpGroup(tp=TP_DEGREE, rank=rank, addr=addr,
                                 device=job[0]["device"],
                                 backend=TP_BACKEND)
    mesh, rules = gang_replica.build_mesh(gang_replica.ReplicaTopology(
        ici_axes={"tp": TP_DEGREE}), group)
    out = {}
    for leg in job:
        out[leg["name"]] = _TP_LEGS[leg["kind"]](leg, mesh, rules, rank)
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        (work / "result.pkl").write_bytes(pickle.dumps(out))
    group.close()
    return 0


def _tp_run_ranks(work, job, timeout=900):
    """[tp_serve]'s rank legs in two processes of this script on the
    card; rank 0's results."""
    import pickle
    from skypilot_tpu_torch.serve import gang_replica
    (work / "job.pkl").write_bytes(pickle.dumps(job))
    addr = gang_replica.free_addr()
    logs = [open(work / f"rank{r}.log", "wb") for r in range(TP_DEGREE)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "tp-rank", str(work),
         str(r), addr], stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if rcs != [0] * TP_DEGREE:
        for r in range(TP_DEGREE):
            tail = (work / f"rank{r}.log").read_text(errors="replace")
            print(f"[tp_serve] rank {r} log tail:\n{tail[-3000:]}",
                  file=sys.stderr, flush=True)
    check(rcs == [0] * TP_DEGREE, f"[tp_serve] rank processes exited {rcs}")
    return pickle.loads((work / "result.pkl").read_bytes())


def _sse_tokens(label, res):
    """The token frames of a streamed /generate ending in [DONE]."""
    check(res is not None and res["status"] == 200,
          f"{label}: HTTP {res and res['status']}")
    frames = [f for f in res["frames"] if f.startswith("data: ")]
    check(frames and frames[-1] == "data: [DONE]",
          f"{label}: stream does not end in [DONE]")
    return [json.loads(f[len("data: "):])["token"] for f in frames[:-1]]


def _tp_first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _tp_replica(ref, tf, card, dev, model):
    """Legs (a) and (c) through a tp-2 serve_llm replica: [serve]'s eight
    streams and the ninth against the one-card replica's, greedy ones
    parting only at a near-tie of the one-card forward's logits (gap
    within twice the tp cache path's largest logit difference there);
    then its tp rank SIGKILLed mid-stream: 503, the whole-gang restart,
    stpu_gang_restarts_total 1, 200, and a request's tokens equal to its
    run before the kill."""
    from skypilot_tpu_torch.recipes import serve_llm
    from skypilot_tpu_torch.serve import gang_replica
    port = int(gang_replica.free_addr().rsplit(":", 1)[1])
    base = f"http://127.0.0.1:{port}"
    env = {**os.environ, "STPU_STEPSTATS": "1"}
    cmd = [sys.executable, "-m", "skypilot_tpu_torch.recipes.serve_llm",
           "--model", model, "--seed", "5", "--port", str(port),
           "--tp", str(TP_DEGREE), "--device", dev, "--tp-backend",
           TP_BACKEND, "--engine-slots", str(SV_SLOTS), "--kv-paged", "1",
           "--kv-block-tokens", str(SV_BLOCK)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=pathlib.Path(__file__).resolve().parent,
                            env=env, stdout=subprocess.DEVNULL,
                            start_new_session=True)

    def health():
        try:
            with urllib.request.urlopen(base + "/health", timeout=5) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code
        except OSError:
            return None

    def wait(code, seconds):
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            if health() == code:
                return True
            check(proc.poll() is None, f"[tp_serve] the replica exited "
                  f"{proc.returncode}")
            time.sleep(0.1)
        return False

    try:
        check(wait(200, 600), "[tp_serve] the tp-2 replica never ready")
        up = time.perf_counter() - t0
        reqs = ref["reqs"]
        out = [None] * len(reqs)
        threads = [threading.Thread(target=_sse_generate, args=(
            port, {"prompt": p, "max_tokens": SV_MAX_TOKENS,
                   "temperature": t, "seed": s, "stream": True}, out, i))
            for i, (p, t, s) in enumerate(reqs)]
        t1 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t1
        with urllib.request.urlopen(base + "/perf", timeout=30) as r:
            perf = json.loads(r.read())
        last = [None]
        _sse_generate(port, {"prompt": ref["ninth"][0],
                             "max_tokens": SV_MAX_TOKENS, "stream": True},
                      last, 0)
        streams = [_sse_tokens(f"[tp_serve] request {i}", res)
                   for i, res in enumerate(out)]
        ninth = _sse_tokens("[tp_serve] request 9", last[0])
        dec = perf["phases"].get("decode", {})
        step_ms = dec.get("seconds", 0.0) / max(dec.get("steps", 1), 1) * 1e3
        print(f"[tp_serve] (a) tp-2 replica up in {up:.1f} s; eight streams "
              f"{len(reqs) * SV_MAX_TOKENS / wall:.1f} tokens/s aggregate "
              f"({wall:.2f} s); decode step {step_ms:.1f} ms mean over "
              f"{dec.get('steps', 0)} steps at mean occupancy "
              f"{perf['occupancy']['mean']} ([serve] one card 128.6-182.1 ms "
              f"at 8) ({card})", flush=True)
        greedy = [i for i, r in enumerate(reqs) if not r[1]]
        ties = []
        for g, i in enumerate(greedy):
            div = _tp_first_divergence(streams[i], ref["streams"][i])
            if div is None:
                continue
            full = ref["full"][g][div]
            gap = abs(float(full[ref["streams"][i][div]] -
                            full[streams[i][div]]))
            bound = 2 * float(tf["maxdiff"][g][div])
            ties.append((i, div, round(gap, 4), round(bound, 4)))
            check(gap <= bound, f"[tp_serve] greedy request {i} parts from "
                  f"one card at token {div} by a logit gap {gap:.4f}, past "
                  f"the near-tie bound {bound:.4f}")
        seeded_equal = sum(a == b for i, (_, t, _s) in enumerate(reqs) if t
                           for a, b in zip(streams[i], ref["streams"][i]))
        print(f"[tp_serve] (a) greedy streams equal to one card's but at "
              f"near-ties (request, token, gap, bound): {ties}; seeded "
              f"tokens equal {seeded_equal} of "
              f"{(len(reqs) - len(greedy)) * SV_MAX_TOKENS}; ninth equal "
              f"{ninth == ref['ninth_tokens']} (first divergence "
              f"{_tp_first_divergence(ninth, ref['ninth_tokens'])}, not "
              f"gated)", flush=True)
        # (c) failover.
        body = {"prompt": reqs[0][0], "max_tokens": TP_FAILOVER_TOKENS}
        before = json.loads(urllib.request.urlopen(urllib.request.Request(
            base + "/generate", data=json.dumps(body).encode()),
            timeout=300).read())["tokens"]
        with urllib.request.urlopen(base + "/gang", timeout=30) as r:
            members = json.loads(r.read())["members"]
        victim = [m["pid"] for m in members if m["role"] == "tp"][0]
        got = [0]
        seen = threading.Event()

        def on_frame(frames):
            got[0] = len(frames)
            if len(frames) >= 4:
                seen.set()

        def live_stream():
            try:
                _sse_generate(port, {"prompt": reqs[1][0],
                                     "max_tokens": SV_MAX_TOKENS,
                                     "stream": True}, [None], 0, on_frame)
            except (http.client.HTTPException, OSError):
                pass    # the cut itself: the stream died with the rank
        stream = threading.Thread(target=live_stream)
        stream.start()
        check(seen.wait(300), "[tp_serve] (c) the stream never started")
        t2 = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        check(wait(503, 60), "[tp_serve] (c) /health never answered 503")
        t503 = time.perf_counter() - t2
        check(wait(200, 600), "[tp_serve] (c) the gang never recovered")
        back = time.perf_counter() - t2
        stream.join(timeout=300)
        after = json.loads(urllib.request.urlopen(urllib.request.Request(
            base + "/generate", data=json.dumps(body).encode()),
            timeout=300).read())["tokens"]
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        restarts = [ln for ln in text.splitlines()
                    if ln.startswith("stpu_gang_restarts_total ")]
        print(f"[tp_serve] (c) tp rank SIGKILLed mid-stream (the stream "
              f"ended after {got[0]} frames): 503 after {t503:.2f} s, 200 "
              f"after {back:.1f} s (whole-gang restart), {restarts}; the "
              f"next request's tokens equal its run before the kill: "
              f"{after == before}", flush=True)
        check(restarts == ["stpu_gang_restarts_total 1"],
              f"[tp_serve] (c) restarts {restarts}")
        check(after == before, f"[tp_serve] (c) tokens after the restart "
              f"{after} != before {before}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    del serve_llm


def phase_tp_serve(fa, card, ref, dev="cuda", model="llama3-8b"):
    """[tp_serve]: the tensor-parallel replica at Llama-3-8B full width
    and depth on the one card (module docstring, phase 11b); ``model`` is
    serve_llm's name of [serve]'s config (seed 5)."""
    from skypilot_tpu_torch.benchmark import decode_bench
    from skypilot_tpu_torch.models import llama, mixtral
    from skypilot_tpu_torch.serve import decode_engine
    t0 = time.perf_counter()
    dev = "cuda:0" if dev == "cuda" else dev
    print(f"[tp_serve] tp {TP_DEGREE} over {TP_BACKEND}: one card, and NCCL "
          f"refuses two ranks on one device; both ranks on cuda:0, gloo "
          f"carrying their CUDA tensors (all_reduce, all_gather, "
          f"broadcast)", flush=True)
    # (e)'s one-card reference: Mixtral at full width, cut in depth.
    mx_cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                                 n_layers=TP_MIXTRAL_LAYERS)
    mx_reqs = [(p, 0.0, 0, TP_MIXTRAL_TOKENS)
               for p, _, _ in _serve_requests(mx_cfg, seed=22)[0][:4]]
    mx_engine = dict(slots=SV_SLOTS, max_seq=1280, prefill_chunk=SV_BLOCK,
                     paged=True)
    params = mixtral.init(mx_cfg, torch.Generator(device=dev).manual_seed(
        21), dev)
    eng = decode_engine.DecodeEngine(mx_cfg, params, device=dev,
                                     use_manifest=False, **mx_engine).start()
    try:
        hs = [eng.submit(p, max_tokens=n) for p, _, _, n in mx_reqs]
        mx_one = [h.result(timeout=900) for h in hs]
    finally:
        eng.shutdown()
        eng.release()
    del params
    torch.cuda.empty_cache()
    f32 = ref["f32"]
    cfg = llama.LlamaConfig.llama3_8b()
    job = [
        dict(name="teacher", kind="teacher", family="llama", cfg=cfg,
             seed=5, seqs=ref["seqs"], refs=ref["full"], geo=ref["geo"],
             device=dev),
        dict(name="f32_teacher", kind="teacher", family="llama",
             cfg=f32["cfg"], seed=7, seqs=f32["seqs"], refs=f32["refs"],
             geo=f32["geo"], device=dev),
        dict(name="f32", kind="engine", family="llama", cfg=f32["cfg"],
             seed=7, reqs=[(p, t, s, SV_EXACT_TOKENS)
                           for p, t, s in f32["reqs"]],
             engine=dict(slots=4, max_seq=512, prefill_chunk=64,
                         paged=True), device=dev),
        dict(name="int8", kind="engine", family="llama", cfg=cfg, seed=5,
             int8=True, reqs=[(p, t, s, TP_INT8_TOKENS)
                              for p, t, s in ref["reqs"] if not t],
             engine=dict(slots=SV_SLOTS, max_seq=1280,
                         prefill_chunk=SV_BLOCK, paged=True, kv_quant=True,
                         prefix_cache_mb=64), device=dev),
        dict(name="mixtral", kind="engine", family="mixtral", cfg=mx_cfg,
             seed=21, reqs=mx_reqs, engine=mx_engine, device=dev),
    ]
    work = pathlib.Path(tempfile.mkdtemp(prefix="stpu_tp_serve_"))
    try:
        t1 = time.perf_counter()
        res = _tp_run_ranks(work, job)
        ranks_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tf = res["teacher"]
    n_greedy = len(ref["seqs"])
    want = {name: 0 for name in tf["launches"]}
    want["flash_fwd"] = cfg.n_layers * n_greedy
    print(f"[tp_serve] (a) teacher-forced greedy streams on each rank's "
          f"{cfg.n_heads // TP_DEGREE} query and "
          f"{cfg.n_kv_heads // TP_DEGREE} KV heads: the tp forward "
          f"{tf['fwd']:.3e} from the one-card forward; the tp paged cache "
          f"path {tf['sound']:.3e} (per stream "
          f"{[f'{x:.2e}' for x in tf['per_stream']]}; tol "
          f"{CACHE_REL_TOL:g}), planted fault (positions one late, first "
          f"{TP_FAULT_TOKENS} tokens) {tf['shift']:.3e}; rank 0 launches {tf['launches']}", flush=True)
    check(tf["launches"] == want, f"[tp_serve] teacher-forced launches "
          f"{tf['launches']} != {want}")
    check(tf["sound"] <= CACHE_REL_TOL, f"[tp_serve] tp cache path "
          f"{tf['sound']:.3e} from the one-card forward, past "
          f"{CACHE_REL_TOL:g}")
    check(tf["shift"] > CACHE_REL_TOL, f"[tp_serve] the planted fault reads "
          f"{tf['shift']:.3e}, inside {CACHE_REL_TOL:g}")
    t32 = res["f32_teacher"]
    streams32 = res["f32"]["streams"]
    equal32 = streams32 == f32["streams"]
    print(f"[tp_serve] (a) f32 at {f32['cfg'].n_layers} layers: tp paged "
          f"cache path {t32['sound']:.3e} from the one-card forward (tol "
          f"{F32_CACHE_REL_TOL:g}), fault {t32['shift']:.3e}; tp engine "
          f"streams equal to one card's: {equal32} (first divergences "
          f"{[_tp_first_divergence(a, b) for a, b in zip(streams32, f32['streams'])]})",
          flush=True)
    check(t32["sound"] <= F32_CACHE_REL_TOL and
          t32["shift"] > F32_CACHE_REL_TOL,
          f"[tp_serve] f32 tp cache path {t32['sound']:.3e} / fault "
          f"{t32['shift']:.3e} against {F32_CACHE_REL_TOL:g}")
    check(equal32, "[tp_serve] f32 tp streams differ from one card's")
    greedy = [i for i, r in enumerate(ref["reqs"]) if not r[1]]
    q = res["int8"]["streams"]
    one_q = [ref["q_streams"][i][:TP_INT8_TOKENS] for i in greedy]
    same = sum(a == b for s, t in zip(q, one_q) for a, b in zip(s, t))
    print(f"[tp_serve] (b) int8 weights and KV at tp 2 (the tree quantized "
          f"whole, then sharded): the greedy requests' first "
          f"{TP_INT8_TOKENS} tokens equal to the one-card int8 leg's: {same} "
          f"of {len(greedy) * TP_INT8_TOKENS} (first divergences "
          f"{[_tp_first_divergence(s, t) for s, t in zip(q, one_q)]}; not "
          f"gated: bf16 near-ties); {res['int8']['seconds']:.1f} s ({card})",
          flush=True)
    mx = res["mixtral"]["streams"]
    print(f"[tp_serve] (e) Mixtral-8x7B width, {TP_MIXTRAL_LAYERS} layers, "
          f"bf16 at tp 2 (experts split on mlp): greedy streams equal to "
          f"one card's {sum(a == b for a, b in zip(mx, mx_one))} of "
          f"{len(mx)} (first divergences "
          f"{[_tp_first_divergence(a, b) for a, b in zip(mx, mx_one)]}; "
          f"not gated); rank legs {ranks_s:.1f} s", flush=True)
    check(all(len(s) == TP_MIXTRAL_TOKENS for s in mx),
          "[tp_serve] (e) incomplete Mixtral streams")
    _tp_replica(ref, tf, card, dev, model)
    bench_cfg = dataclasses.replace(cfg, n_layers=TP_BENCH_LAYERS)
    tp_bench = decode_bench.measure_engine_tp(
        "llama", tp=TP_DEGREE, device=dev, backend=TP_BACKEND,
        config=bench_cfg)
    one = decode_bench.measure_engine_ragged(
        "llama", n_requests=tp_bench["requests"], config=bench_cfg,
        device=dev)
    print(f"[tp_serve] (d) measure_engine_tp at Llama-3-8B width, "
          f"{TP_BENCH_LAYERS} layers: {json.dumps(tp_bench)}; one card, "
          f"measure_engine_ragged on the same model and mix: "
          f"{one['engine_ragged_tok_s']} tokens/s ({one['wall_seconds']} s) "
          f"({card})", flush=True)
    print(f"[tp_serve] {time.perf_counter() - t0:.1f} s", flush=True)


def _timed(phase, *args):
    """``phase(*args)``, its wall seconds printed as ``[timing]``."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        print(f"[timing] {phase.__name__} {time.perf_counter() - t0:.1f} s",
              flush=True)


def main() -> int:
    if sys.argv[1:2] == ["tp-rank"]:
        return _tp_rank_main(pathlib.Path(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4])
    if sys.argv[1:2] == ["ptp-rank"]:
        return _ptp_rank_main(pathlib.Path(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4])
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    repo = pathlib.Path(__file__).resolve().parent
    if not (repo / "skypilot_tpu_torch" / "csrc").is_dir():
        print(f"FAIL: no skypilot_tpu_torch/ beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    # Engines run the default constants unless a phase points this at the
    # manifest it wrote ([tune]): no ambient tuning manifest.
    os.environ["STPU_TUNE_MANIFEST"] = "0"
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import attention as attention_ops
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import trainer

    t0 = time.perf_counter()
    try:
        card = _timed(phase_device)
        attrs = _timed(phase_build, _build)
        CLOCKS.start()
        try:
            records = _timed(phase_kernels, fa)
            _timed(phase_kernels_wide, fa, records)
            _timed(phase_kernels_512, fa, records)
            _timed(phase_kernels_xwide, fa, records)
        finally:
            CLOCKS.stop()
        _timed(phase_ragged_op, fa, attention_ops)
        _timed(phase_f32_op, fa, attention_ops, records)
        _timed(phase_pad_op, fa, attention_ops)
        _timed(phase_wide_op, fa, attention_ops, records)
        _timed(phase_streamed, fa, attention_ops, records)
        torch.cuda.empty_cache()
        _timed(phase_slice, fa, llama, trainer, records)
        torch.cuda.empty_cache()
        _timed(phase_parallel, fa, llama, trainer, attention_ops)
        torch.cuda.empty_cache()
        lc_losses = _timed(phase_long_context, fa, llama, trainer, records)
        torch.cuda.empty_cache()
        _timed(phase_parallel_tp, fa, llama, trainer, card, lc_losses)
        torch.cuda.empty_cache()
        _timed(phase_tiny, fa, llama, trainer, records)
        torch.cuda.empty_cache()
        _timed(phase_adafactor, fa, llama, trainer)
        torch.cuda.empty_cache()
        _timed(phase_lora, fa, llama, trainer, card)
        torch.cuda.empty_cache()
        _timed(phase_mixtral, fa, llama, trainer)
        torch.cuda.empty_cache()
        _timed(phase_mixtral_ep, fa, trainer, card)
        torch.cuda.empty_cache()
        _timed(phase_recipes, card)
        torch.cuda.empty_cache()
        _timed(phase_gemma_lora, fa, trainer, records, card)
        torch.cuda.empty_cache()
        _timed(phase_gemma_long, fa, trainer, records, card)
        torch.cuda.empty_cache()
        _timed(phase_gemma_wide, fa, trainer, records)
        torch.cuda.empty_cache()
        _timed(phase_gemma_xwide, fa, trainer, records)
        torch.cuda.empty_cache()
        tp_ref = _timed(phase_serve, fa, llama, card)
        _timed(phase_lb_bench, card)
        torch.cuda.empty_cache()
        _timed(phase_tp_serve, fa, card, tp_ref)
        del tp_ref
        torch.cuda.empty_cache()
        _timed(phase_gemma_serve, fa, card)
        _timed(phase_mixtral_serve, fa, card)
        _timed(phase_decode_bench, card)
        _timed(phase_tune, card)
        check(len(records) == 48, f"{len(records)} kernel records, not 48")
    except (PhaseError, RuntimeError, ValueError, OSError,
            subprocess.SubprocessError) as exc:
        print(f"FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    summary = [(name, kernel, 128) for name, _, kernel in SM90_KERNELS]
    summary += [(f"{name}@{d}", kernel, d) for d in (256, 512, XW_WIDTH)
                for name, _, kernel in SM90_KERNELS]
    for key, kernel, d in summary:
        rec = records[key]
        rec["regs"], rec["smem_bytes"] = attrs[(kernel, d, "Bf16")]
        where = (f"its step {rec['step_ms']:.1f} ms" if "step_ms" in rec
                 else "per call of the op")
        clock = (f"SM {rec['sm_clock_mhz']:.0f} MHz" if rec["sm_clock_mhz"]
                 else "SM clock not sampled")
        lib = ("none" if rec["library_ms"] is None
               else f"{rec['library_ms']:.4f} ms")
        print(f"[summary] {rec['name']} (Hopper, D={d}: {rec['regs']} "
              f"registers at launch, {rec['smem_bytes']} B shared): "
              f"{rec['ms']:.4f} ms at {tuple(rec['shape'])} ({clock}), "
              f"bound {rec['bound_ms']:.4f} ms, SDPA {lib} "
              f"({rec['library_covers']}), f16 {rec['f16_ms']:.4f} ms; "
              f"{where}", flush=True)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
