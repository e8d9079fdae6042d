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
   wgmmas, in every instance (head_dim 64, 128 and 256; bf16 and f16) of
   the nine Hopper kernels (flash_fwd, flash_dq, flash_dkv, flash_fwd_tri,
   flash_dq_tri, flash_dkv_tri, flash_fwd_streamed, flash_dq_streamed,
   flash_dkv_streamed);
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
   beside SDPA's whole backward;
   then the public attention op through autograd, with exactly one
   launch of each kernel of its family: at a ragged S (200) against the
   plain versions; at head_dim 16, 96 and 192 (zero-padded to the
   kernels' 64, 128 and 256; 192 at S 384 and, triangular, at 4096, where
   the padded columns of the kernels' outputs must be exactly 0) against
   the plain versions at that head_dim; at width 256 past the resident
   budget ([wide op]) the triangular trio causal and the streamed trio
   non-causal against the plain versions, and head_dim 264 a ValueError
   naming it before any launch; and with f32 inputs (2 x 256, 4 heads, 2
   KV heads, head_dim 64, causal and not; 1 x 200 at head_dim 128; 1 x
   2048 and 1 x 4096 at head_dim 256, 8 heads over 1), through the fp32
   kernels (one launch each), against the fp32 plain versions at the JAX
   reference tests' elementwise bounds (and, printed, not held, the same
   inputs as f16 through the f16 kernels), then the fp32 kernels' time at
   the slice's shape and at width 256, beside the plain versions' and
   SDPA's in f32 (forward, whole backward);
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
6. long context: the same width at batch 1 x seq 8192, remat policy
   save_flash_offload_qkv, chunked cross entropy through
   make_train_step(trunk_fn=..., head_fn=...), 8 steps; the loss must
   fall, the launch counts must be exactly L/L/L triangular and no
   other per step, and one forward's loss through the kernels must match
   the reference attention's;
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
   wall time per step of B' and peak memory;
10. mixtral: Mixtral-8x7B widths (8 experts, top 2), depth cut to 2,
   batch 2 x seq 2048, adafactor, full remat, 6 steps on one batch: CE +
   aux must fall, the aux loss be finite and positive, launches exactly
   2L/L/L resident and no other, one forward's loss within LOSS_TOL of the
   reference attention's; prints the step and the share of token choices
   dropped by capacity at step 1;
11. serve: one Llama-3-8B replica (full width and depth, bf16, random
   weights) through the port's serve_llm.serve in-process, 8 engine
   slots, paged 64-token blocks, max_seq 1280: eight concurrent streamed
   /generate requests (prompts 32 to 1024 tokens, 128 tokens each, four
   greedy, four seeded at T=0.8), then a ninth sharing a 512-token
   prefix with the longest. Every stream must end in its stats frame and
   [DONE] after 128 tokens, the ninth must hit the prefix cache, and no
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
12. gemma_lora (run after mixtral, before serve): the Gemma LoRA recipe at
   Gemma-2B full width and depth, seq 2048, 4 steps, at the largest of
   batch 8, 7, 6, ... that fits the card (cut printed): launches exactly
   2L/L/L of the width-256 resident kernels per step and no other, the
   trained adapters lower the first batch's loss, one forward's loss
   within LOSS_TOL of the reference attention's; ms a step, tokens/s,
   peak memory;
13. gemma_long (right after gemma_lora): the same recipe at Gemma-2B's
   own context, seq 8192, full width and depth, 4 steps with a save at
   the last, at the largest of batch 8, 4, 2, 1 that fits (cut printed):
   launches exactly 2L/L/L of the width-256 triangular kernels per step
   and no other, the same loss gates; ms a step, tokens/s, peak memory;
14. gemma_serve: [serve]'s bf16 leg on a Gemma-2B replica (full width and
   depth, the same nine requests and gates; teacher-forced within
   GEMMA_CACHE_REL_TOL of gemma.forward, whose check launches the
   width-256 forward), then f32 at 4 layers: paged == dense ==
   gemma.decode, the cache paths within F32_CACHE_REL_TOL of
   gemma.forward (through the fp32 kernels at width 256) with three
   planted faults past it (the third: the serving embed without its
   sqrt(dim) multiplier);
15. a summary of the Hopper kernels (registers, shared memory, time
   beside bound and SDPA and the SM clock during it, their step's time);
   the kernels line ({"kernels": [...]}, eighteen records: the nine at
   head_dim 128 and the nine at 256), then the last line
   {"ok": true, "device": {...}}.

Needs a CUDA card, the CUDA toolkit and this file's checkout (it imports
the port from beside itself). Imports nothing of JAX.
"""
import contextlib
import ctypes
import dataclasses
import gc
import http.client
import io
import json
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

import numpy as np
import torch

# H100 SXM dense peaks: bf16 tensor cores and HBM3 (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
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
                 (1, 4096, 8, 1, 256, True))
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
TRI_WIDE_MAIN_SHAPE = (1, 8192, 8, 1, 256, True)
TRI_WIDE_CHECK_SHAPES = (TRI_WIDE_MAIN_SHAPE, (1, 4096, 16, 16, 256, True),
                         (1, 4136, 8, 1, 256, True),
                         (1, 4160, 8, 1, 256, True))
STR_WIDE_MAIN_SHAPE = (1, 4096, 8, 1, 256, False)
STR_WIDE_CHECK_SHAPES = (STR_WIDE_MAIN_SHAPE, (1, 4136, 8, 1, 256, False),
                         (1, 4136, 16, 16, 256, False))
# The op past the resident budget at width 256 ([wide op]): causal takes
# the triangular trio, non-causal the streamed one. Past width 256 no
# kernel exists: the op must refuse before any launch.
WIDE_OP_SHAPE = (1, 4096, 8, 1, 256, True)
REFUSED_HEAD_DIM = 264
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
HEAD_DIMS = (64, 128, 256)

N_LAYERS = 4
BATCH, SEQ = 2, 2048
TRAIN_STEPS = 8
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
# The mixtral phase: Mixtral-8x7B widths; depth cut from 32 to 2 layers
# (47 B parameters in bf16 do not fit one 80 GB card).
MX_LAYERS, MX_BATCH, MX_SEQ, MX_STEPS = 2, 2, 2048, 6

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
# The serve phase: one Llama-3-8B replica (full width and depth, bf16,
# random weights) through the port's serve_llm at its own max_seq
# (MAX_PROMPT_TOKENS + MAX_GEN_TOKENS = 1280), 8 engine slots, paged,
# 64-token blocks; eight concurrent streamed requests, four greedy and
# four seeded, then a ninth sharing a 512-token prefix with the longest.
SV_SLOTS, SV_BLOCK = 8, 64
SV_PROMPTS = (32, 64, 128, 256, 384, 512, 768, 1024)
SV_MAX_TOKENS, SV_TEMP, SV_PREFIX = 128, 0.8, 512
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
        for d in HEAD_DIMS:
            for elem, code in build.DTYPES.items():
                tag = ELEM_TAGS[elem]
                out = (ctypes.c_int * 5)()
                check(fn(d, code, out) == 0, "cudaFuncGetAttributes failed "
                      f"for {kernel}<{d}, {tag}>")
                regs, smem, threads, producer, consumer = out
                attrs[(kernel, d, tag)] = (regs, smem)
                print(f"[build] {kernel}<{d}, {tag}>: {regs} registers per "
                      f"thread at launch (setmaxnreg: producer {producer}, "
                      f"consumers {consumer}), {smem} bytes dynamic shared "
                      f"memory, {threads} threads", flush=True)
    phase_sass(build)
    return attrs


def phase_sass(build):
    """Every instance of the Hopper kernels (head_dim 64, 128 and 256;
    bf16 and f16) must hold wgmma (HGMMA) and TMA loads (UTMALDG) in its
    SASS, and its wgmmas must run asynchronously: ptxas serialises them
    (with a "Potential Performance Loss" note) by placing a wait
    (WARPGROUP.DEPBAR) after each one, so a kernel with as many waits as
    wgmmas fails."""
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
        want = {(str(d), tag) for d in HEAD_DIMS
                for tag in ELEM_TAGS.values()}
        check(found == want, f"{kernel}: instances {sorted(found)} in "
              f"{lib}'s SASS, expected {sorted(want)}")


def _ptxas_summary(log):
    """'kernel<D[, T]>: N registers, spills S/L bytes' from nvcc -Xptxas
    -v (the fp32 kernels have no element type)."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"(flash_(?:fwd|dq|dkv)(?:_tri|_streamed|_f32)?_kernel)"
                      r"ILi(\d+)E(?:NS_\d(Bf16|F16)E)?", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}" + (
                f", {m.group(3)}>" if m.group(3) else ">")
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


def _print_pair_vs_sdpa(fam, fns, records):
    """A family's backward pair's time at width 256 beside SDPA's whole
    backward (dq, dk, dv) on the same inputs, both from this run."""
    dq, dkv = fns.names[1:]
    dq_ms, dkv_ms = records[dq]["ms"], records[dkv]["ms"]
    lib = records[dq]["library_ms"]
    total = dq_ms + dkv_ms
    print(f"[kernels d256] {fam} backward pair: {dq} {dq_ms:.4f} + {dkv} "
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


def _print_launches(fa, fam, fns, shape):
    """Each kernel's launch at a width-256 shape: its items (CTAs), P (the
    parts of the GQA group every width-256 dk/dv splits across CTAs) and
    its dynamic shared memory (the kernel's build report); the resident
    and triangular dq's CTA shapes."""
    b, s, h, kvh, d, causal = shape
    parts = fa.dkv_parts(b, s, kvh, h // kvh, causal,
                         fa._sm_count(torch.device("cuda")))
    items = (b * h * -(-s // fa.FWD_TILE), b * h * -(-s // fa.BWD_TILE),
             b * kvh * -(-s // fa.WIDE_KV_TILE) * parts)
    source = {fa.RESIDENT: ("flash_fwd", "flash_bwd", "flash_bwd"),
              fa.TRIANGULAR: ("flash_tri",) * 3,
              fa.STREAMED: ("flash_streamed",) * 3}[fam]
    notes = []
    for name, src, n, p in zip(fns.names, source, items, (1, 1, parts)):
        out = (ctypes.c_int * 5)()
        check(getattr(fa._build.library(src), f"stpu_{name}_attrs")(
            d, fa._build.DTYPES["bf16"], out) == 0, f"{name} attrs failed")
        notes.append(f"{name} {n} items, P {p}, {out[1]} B shared")
    notes[0] += f" ({WIDE_FWD_DESIGN[fns.names[0]]})"
    if fam == fa.RESIDENT:
        notes[1] += f" ({WIDE_DQ_DESIGN})"
    elif fam == fa.TRIANGULAR:
        notes[1] += f" ({TRI_WIDE_DQ_DESIGN})"
    print(f"[kernels d256] {fam} {shape} launches: " + "; ".join(notes),
          flush=True)


def phase_wide_op(fa, attention_ops, records):
    """[wide op]: the public op past the resident budget at width 256,
    through autograd: causal, exactly one launch of each triangular
    kernel, non-causal one of each streamed kernel (their launches in the
    kernels line: per call of the op), each against its family's plain
    versions. Past width 256 no kernel exists: head_dim REFUSED_HEAD_DIM
    must raise a ValueError naming it, before any launch."""
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


def phase_f32_op(fa, attention_ops):
    """The public op with f32 inputs on the card: the fp32 kernels, one
    launch each, outputs and gradients in f32, within the JAX reference
    tests' elementwise bounds of the fp32 plain versions (matmuls in full
    fp32: TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for idx, shape in enumerate(F32_OP_SHAPES):
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
        for name, got, want, tol in zip(
                ("o", "dq", "dk", "dv"), (out, *grads), ref,
                (F32_OUT_TOL, F32_GRAD_TOL, F32_GRAD_TOL, F32_GRAD_TOL)):
            excess = ((got - want).abs() - tol * want.abs()).max().item()
            print(f"[f32 op] {shape} {name}: max |err| - rtol |ref| "
                  f"{excess:.3e} (atol {tol})", flush=True)
            check(excess <= tol, f"f32 {name} outside rtol = atol = {tol} "
                  f"at {shape}")
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
    # The fp32 kernels' time at the slice's attention shape and at width
    # 256 past the budget (not a path the port's bf16 models take: f32 is
    # the exact path, not the fast one), beside the fp32 plain versions'.
    for shape in (MAIN_SHAPE, F32_OP_SHAPES[-1]):
        q, k, v, do = _inputs(shape, 22, torch.float32)
        causal, scale = shape[-1], shape[4] ** -0.5
        o, lse = fa.flash_fwd_f32(q, k, v, causal, scale)
        _, delta = fa.flash_dq_f32(q, k, v, o, lse, do, causal, scale)
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
        lib_note = ("SDPA none" if lib[0] is None else
                    f"SDPA forward {lib[0]:.3f} ms, whole backward "
                    f"{lib[1]:.3f} ms")
        print(f"[f32 op] fp32 kernels at {shape}: forward {times[0]:.3f} "
              f"ms, dq {times[1]:.3f} ms, dk/dv {times[2]:.3f} ms; plain "
              f"forward {plain[0]:.3f} ms, backward {plain[1]:.3f} ms; "
              f"{lib_note}", flush=True)
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


def phase_tiny(fa, llama, trainer):
    """LlamaConfig.tiny() (head_dim 16: the kernels' 64, zero-padded) on the
    card, in bf16 and in f32: 8 steps each on one repeated batch, full
    remat; the loss must fall and every step must go through the resident
    kernels (bf16) or the fp32 kernels (f32), 2L/L/L."""
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


def _lora_run(llama_lora, argv):
    """The recipe's main() with its stdout kept: its metrics line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = llama_lora.main(argv)
    return metrics


def phase_lora(fa, llama, trainer):
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
        try:
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            argv_a = common + ["--steps", str(LORA_STEPS),
                               "--checkpoint-dir", dir_a]
            run_a = _lora_run(llama_lora, argv_a)
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


def _sse_generate(port, body, out, idx):
    """One streamed /generate over HTTP: out[idx] = its status, send time
    and each SSE frame with its arrival time."""
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


def _serve_leg(fa, cfg, params, reqs, ninth, card, label, dev, **kw):
    """One replica through serve(): the eight concurrent streams, then
    the ninth alone. Returns the streams' tokens and prints the leg's
    numbers beside the card."""
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
                       paged, fault=None):
    """Each (prompt, tokens) of ``seqs`` teacher-forced through the
    engine's cache path at its geometry ``geo`` (kv_config()): the
    prompt in chunk-sized prefill chunks (the engine's _prefill_chunk /
    _paged_prefill_chunk), then the tokens but the last in batched T = 1
    steps over all streams, as the decode step runs them. Returns one
    f32 (len(tokens), vocab) per stream: row j predicts tokens[j].

    ``fault`` plants an off-by-one in the T = 1 steps, a control the
    gates must catch: "self" passes valid_len = position, so a query
    misses its own key row; "shift" starts each step one position late,
    so the token's rope position and cache row are one past its place;
    "embed" gathers the embeddings without gemma's sqrt(dim) multiplier
    (the serving embed's fault before this was repaired)."""
    if fault == "embed":
        from skypilot_tpu_torch.models import llama as llama_mod
        real = llama_mod._decode_embed
        llama_mod._decode_embed = lambda c, p, toks: p.embed[toks]
        try:
            return _cache_path_logits(llama, decode_engine, cfg, params,
                                      seqs, geo, dev, paged)
        finally:
            llama_mod._decode_embed = real
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
                                       device=dev)
    else:
        cache = llama.init_cache(cfg, b, geo["max_seq"], dev)
    out = []
    with torch.inference_mode():
        for i, (prompt, _) in enumerate(seqs):
            for start in range(0, len(prompt), chunk):
                piece = prompt[start:start + chunk]
                buf = torch.zeros(chunk, dtype=torch.long, device=dev)
                buf[:len(piece)] = torch.tensor(piece, device=dev)
                valid = start + len(piece)
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


def _rel(a, b):
    """Norm-relative distance of logits a from the reference b, over
    every stream."""
    num = sum(float((x - y).double().norm() ** 2) for x, y in zip(a, b))
    den = sum(float(y.double().norm() ** 2) for y in b)
    return (num / den) ** 0.5


def _hold_cache_paths(label, llama, decode_engine, cfg, params, seqs, geo,
                      refs, dev, tol, faults=("self", "shift")):
    """The dense and paged cache paths against the full forward's
    logits ``refs``: paged == dense bit for bit (the window is the dense
    tile), both within ``tol`` norm-relative, and each planted fault of
    ``faults`` past ``tol``. Returns the paged logits."""
    dense = _cache_path_logits(llama, decode_engine, cfg, params, seqs, geo,
                               dev, paged=False)
    paged = _cache_path_logits(llama, decode_engine, cfg, params, seqs, geo,
                               dev, paged=True)
    check(all(torch.equal(a, b) for a, b in zip(paged, dense)),
          f"{label}: paged cache path logits differ from the dense path's "
          f"(window {geo['window']} = dense tile {geo['block']})")
    sound = _rel(paged, refs)
    faults = {f: _rel(_cache_path_logits(llama, decode_engine, cfg, params,
                                         seqs, geo, dev, paged=True,
                                         fault=f), refs)
              for f in faults}
    names = {"self": "own key masked", "shift": "positions shifted by one",
             "embed": "embed multiplier dropped"}
    print(f"{label}: dense and paged cache paths (chunk {geo['chunk']}, "
          f"window {geo['window']}) bit-equal; {sound:.3e} norm-relative "
          f"from the forward's logits (tol {tol:g}); planted faults: "
          + ", ".join(f"{names[f]} {r:.3e}" for f, r in faults.items()),
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
    streams, geo = _serve_leg(fa, cfg, params, reqs, ninth, card,
                              "[serve bf16]", dev)
    torch.cuda.empty_cache()
    _teacher_forced(fa, llama, decode_engine, cfg, params, reqs, streams,
                    geo, dev)
    torch.cuda.empty_cache()
    q_streams, _ = _serve_leg(fa, cfg, params, reqs, ninth, card,
                           "[serve int8]", dev, weight_quant=True,
                           kv_quant=True)
    greedy = [i for i, r in enumerate(reqs) if not r[1]]
    same = sum(a == b for i in greedy
               for a, b in zip(streams[i], q_streams[i]))
    print(f"[serve int8] greedy tokens equal to the bf16 leg's: {same} of "
          f"{len(greedy) * SV_MAX_TOKENS} (not a gate)", flush=True)
    del params
    torch.cuda.empty_cache()
    _exactness(llama, decode_engine, prng, dev)
    stepstats.disarm()
    reqlog.disarm()


def _gemma_recipe(fa, trainer, records, label, fam, names, seq, batches,
                  steps, dev):
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
                run = _lora_run(gemma_lora, argv + ["--checkpoint-dir", ckpt,
                                                    "--device", dev])
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


def phase_gemma_lora(fa, trainer, records, dev="cuda"):
    """[gemma_lora]: the recipe at examples/gemma_lora.yaml's seq 2048,
    where every attention call takes the width-256 resident kernels."""
    _gemma_recipe(fa, trainer, records, "[gemma_lora]", fa.RESIDENT,
                  RESIDENT_NAMES, GL_SEQ, GL_BATCHES, GL_STEPS, dev)


def phase_gemma_long(fa, trainer, records, dev="cuda"):
    """[gemma_long]: the recipe at Gemma-2B's own context (max_seq_len
    8192), where every attention call takes the width-256 triangular
    kernels."""
    _gemma_recipe(fa, trainer, records, "[gemma_long]", fa.TRIANGULAR,
                  TRI_NAMES, GLONG_SEQ, GLONG_BATCHES, GLONG_STEPS, dev)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    repo = pathlib.Path(__file__).resolve().parent
    if not (repo / "skypilot_tpu_torch" / "csrc").is_dir():
        print(f"FAIL: no skypilot_tpu_torch/ beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import attention as attention_ops
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import trainer

    t0 = time.perf_counter()
    try:
        card = phase_device()
        attrs = phase_build(_build)
        CLOCKS.start()
        try:
            records = phase_kernels(fa)
            phase_kernels_wide(fa, records)
        finally:
            CLOCKS.stop()
        phase_ragged_op(fa, attention_ops)
        phase_f32_op(fa, attention_ops)
        phase_pad_op(fa, attention_ops)
        phase_wide_op(fa, attention_ops, records)
        phase_streamed(fa, attention_ops, records)
        torch.cuda.empty_cache()
        phase_slice(fa, llama, trainer, records)
        torch.cuda.empty_cache()
        phase_long_context(fa, llama, trainer, records)
        phase_tiny(fa, llama, trainer)
        torch.cuda.empty_cache()
        phase_adafactor(fa, llama, trainer)
        torch.cuda.empty_cache()
        phase_lora(fa, llama, trainer)
        torch.cuda.empty_cache()
        phase_mixtral(fa, llama, trainer)
        torch.cuda.empty_cache()
        phase_gemma_lora(fa, trainer, records)
        torch.cuda.empty_cache()
        phase_gemma_long(fa, trainer, records)
        torch.cuda.empty_cache()
        phase_serve(fa, llama, card)
        torch.cuda.empty_cache()
        phase_gemma_serve(fa, card)
    except (PhaseError, RuntimeError, ValueError, OSError,
            subprocess.SubprocessError) as exc:
        print(f"FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    summary = [(name, kernel, 128) for name, _, kernel in SM90_KERNELS]
    summary += [(f"{name}@256", kernel, 256)
                for name, _, kernel in SM90_KERNELS]
    for key, kernel, d in summary:
        rec = records[key]
        rec["regs"], rec["smem_bytes"] = attrs[(kernel, d, "Bf16")]
        where = (f"its step {rec['step_ms']:.1f} ms" if "step_ms" in rec
                 else "per call of the non-causal op")
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
