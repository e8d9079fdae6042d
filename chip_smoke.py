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
   wgmmas, in every instance (head_dim 64 and 128, bf16 and f16) of the
   nine Hopper kernels (flash_fwd, flash_dq, flash_dkv, flash_fwd_tri,
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
   for the latter built in q chunks;
   then the public attention op through autograd, with exactly one
   launch of each resident kernel: at a ragged S (200) against the plain
   versions; at head_dim 16 and 96 (zero-padded to the kernels' 64 and
   128) against the plain versions at that head_dim; and with f32 inputs
   (2 x 256, 4 heads, 2 KV heads, head_dim 64, causal and not; and
   1 x 200 at head_dim 128), through
   the fp32 kernels (one launch each), against the fp32 plain versions at
   the JAX reference tests' elementwise bounds (and, printed, not held,
   the same inputs as f16 through the f16 kernels), then the fp32
   kernels' time at the slice's shape;
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
11. a summary of the nine Hopper kernels (registers, shared memory, time
   beside bound and SDPA and the SM clock during it, their step's time);
   the kernels line ({"kernels": [...]}, nine records), then the last
   line {"ok": true, "device": {...}}.

Needs a CUDA card, the CUDA toolkit and this file's checkout (it imports
the port from beside itself). Imports nothing of JAX.
"""
import contextlib
import ctypes
import dataclasses
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
# both causal modes, and a ragged S at head_dim 128.
F32_OP_SHAPES = ((2, 256, 4, 2, 64, True), (2, 256, 4, 2, 64, False),
                 (1, 200, 8, 2, 128, True))
# The public op at head_dims the kernels take only zero-padded: the tiny
# Llama's 16 and a 96.
PAD_OP_SHAPES = ((2, 256, 8, 4, 16, True), (1, 384, 8, 2, 96, True))
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
        print(f"[build] {name}.cu nvcc {rec['seconds']:.1f} s: "
              + "; ".join(_ptxas_summary(rec["ptxas"])), flush=True)
        for line in rec["ptxas"].splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"[build] {name}.cu: {line.strip()}", flush=True)
    attrs = {}
    for name, source, kernel in SM90_KERNELS:
        fn = getattr(build.library(source), f"stpu_{name}_attrs")
        for d in (64, 128):
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
    """Every instance of the Hopper kernels (head_dim 64 and 128, bf16 and
    f16) must hold wgmma (HGMMA) and TMA loads (UTMALDG) in its SASS, and
    its wgmmas must run asynchronously: ptxas serialises them (with a
    "Potential Performance Loss" note) by placing a wait
    (WARPGROUP.DEPBAR) after each one, so a kernel with as many waits as
    wgmmas fails."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = {}
    for _, source, kernel in SM90_KERNELS:
        lib = build.build_dir() / f"lib{source}.so"
        if source not in sass:
            out = subprocess.run([cuobjdump, "-sass", str(lib)],
                                 capture_output=True, text=True, timeout=300)
            check(out.returncode == 0, f"cuobjdump failed on {lib}: "
                  f"{out.stderr[-2000:]}")
            sass[source] = out.stdout
        found = set()
        for part in sass[source].split("Function : ")[1:]:
            name = part.split(None, 1)[0]
            m = re.search(kernel + r"ILi(\d+)ENS_\d(Bf16|F16)E", name)
            if not m:
                continue
            found.add(m.groups())
            hgmma, utmaldg = part.count("HGMMA"), part.count("UTMALDG")
            waits = part.count("WARPGROUP.DEPBAR")
            print(f"[sass] {kernel}<{m.group(1)}, {m.group(2)}>: {hgmma} "
                  f"HGMMA, {utmaldg} UTMALDG, {waits} wgmma waits",
                  flush=True)
            check(hgmma > 0 and utmaldg > 0,
                  f"{name} holds no wgmma or no TMA load")
            check(waits < hgmma, f"{name}: ptxas serialised its wgmmas")
        want = {(str(d), tag) for d in (64, 128) for tag in ELEM_TAGS.values()}
        check(found == want, f"{kernel}: instances {sorted(found)} in "
              f"{lib}'s SASS, expected {sorted(want)}")


def _ptxas_summary(log):
    """'kernel<D>: N registers, spills S/L bytes' from nvcc -Xptxas -v."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"(flash_(?:fwd|dq|dkv)(?:_tri|_streamed)?_kernel)"
                      r"ILi(\d+)ENS_\d(Bf16|F16)E", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"
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


RESIDENT_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")
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
    # The fp32 kernels' time at the slice's attention shape (not a path
    # the port's bf16 models take: f32 is the exact path, not the fast one).
    q, k, v, do = _inputs(MAIN_SHAPE, 22, torch.float32)
    causal, scale = MAIN_SHAPE[-1], MAIN_SHAPE[4] ** -0.5
    o, lse = fa.flash_fwd_f32(q, k, v, causal, scale)
    _, delta = fa.flash_dq_f32(q, k, v, o, lse, do, causal, scale)
    times = (time_ms(lambda: fa.flash_fwd_f32(q, k, v, causal, scale), 3,
                     warmup=1),
             time_ms(lambda: fa.flash_dq_f32(q, k, v, o, lse, do, causal,
                                             scale), 3, warmup=1),
             time_ms(lambda: fa.flash_dkv_f32(q, k, v, do, lse, delta,
                                              causal, scale), 3, warmup=1))
    print(f"[f32 op] fp32 kernels at {MAIN_SHAPE}: forward {times[0]:.3f} "
          f"ms, dq {times[1]:.3f} ms, dk/dv {times[2]:.3f} ms", flush=True)


def phase_pad_op(fa, attention_ops):
    """The public op at head_dims the kernels take zero-padded (16 -> 64,
    96 -> 128), bf16, through autograd: one launch of each resident kernel,
    outputs and gradients of the caller's head_dim, against the plain
    versions at that head_dim."""
    for idx, shape in enumerate(PAD_OP_SHAPES):
        b, s, h, kvh, d, causal = shape
        scale = d ** -0.5
        check(d not in fa.HEAD_DIMS, f"{shape} needs no padding")
        q, k, v, do = _inputs(shape, 30 + idx)
        fa.reset_launches()
        out, grads = _op_grads(attention_ops, q, k, v, causal, do)
        torch.cuda.synchronize()
        _expect_launches(fa, "[pad op]", shape, RESIDENT_NAMES)
        check(out.shape == q.shape and grads[1].shape == k.shape,
              "padded head_dim leaked out of the op")
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, o_p, lse_p, do,
                                              causal, scale)
        _hold("[pad op]", shape, (("o", (out, o_p), OUT_REL_TOL),
                                  ("dq", (grads[0], dq_p), GRAD_REL_TOL),
                                  ("dk", (grads[1], dk_p), GRAD_REL_TOL),
                                  ("dv", (grads[2], dv_p), GRAD_REL_TOL)))


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
    # Library yardstick: SDPA in its own (B, H, S, D) layout, GQA native.
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True)

    with torch.no_grad():
        lib_fwd = time_ms(sdpa, 20)
    out = sdpa()
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 20)
    del out
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
            # Medians of nvidia-smi's samples around the kernel's timing.
            "sm_clock_mhz": clocks[name] and clocks[name]["sm_mhz"],
            "power_w": clocks[name] and clocks[name]["power_w"],
        }
        print(f"[kernels] {name}: {kernel_ms[name]:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), "
              f"{flops / kernel_ms[name] / 1e9:.1f} TFLOP/s, plain "
              f"{records[name]['plain_ms']:.3f} ms, library "
              f"{records[name]['library_ms']:.4f} ms; "
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
    expect.update({n: 1 for n in ("flash_fwd_streamed", "flash_dq_streamed",
                                  "flash_dkv_streamed")})
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
    for name in ("flash_fwd_streamed", "flash_dq_streamed",
                 "flash_dkv_streamed"):
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
    expect.update({n: LC_LAYERS * TRAIN_STEPS for n in
                   ("flash_fwd_tri", "flash_dq_tri", "flash_dkv_tri")})
    check(launches == expect, f"launch counts {launches} != {expect} "
          "(L triangular forward, dq and dk/dv per step, no other)")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tok_s = LC_BATCH * LC_SEQ / steady
    tflops = cfg.flops_per_token(LC_SEQ) * tok_s / 1e12
    print(f"[long] step {steady * 1e3:.1f} ms (median of steps 2-"
          f"{TRAIN_STEPS}; first {step_s[0] * 1e3:.1f} ms), {tok_s:.0f} "
          f"tokens/s, {tflops:.1f} model TFLOP/s (6N + attention), peak "
          f"memory {peak_gb:.2f} GB", flush=True)
    for name in ("flash_fwd_tri", "flash_dq_tri", "flash_dkv_tri"):
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


def _resident_expect(launches, n_layers, steps):
    """2L resident forwards (full remat), L dq and L dk/dv per step, no
    other kernel."""
    expect = dict.fromkeys(launches, 0)
    expect.update({"flash_fwd": 2 * n_layers * steps,
                   "flash_dq": n_layers * steps,
                   "flash_dkv": n_layers * steps})
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
    expect = _resident_expect(launches, cfg.n_layers, TRAIN_STEPS)
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
        expect = _resident_expect(launches, cfg.n_layers,
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
    expect = _resident_expect(launches, cfg.n_layers, MX_STEPS)
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
        finally:
            CLOCKS.stop()
        phase_ragged_op(fa, attention_ops)
        phase_f32_op(fa, attention_ops)
        phase_pad_op(fa, attention_ops)
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
    except (PhaseError, RuntimeError, ValueError, OSError,
            subprocess.SubprocessError) as exc:
        print(f"FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    for name, _, kernel in SM90_KERNELS:
        rec = records[name]
        rec["regs"], rec["smem_bytes"] = attrs[(kernel, 128, "Bf16")]
        where = (f"its step {rec['step_ms']:.1f} ms" if "step_ms" in rec
                 else "per call of the non-causal op")
        clock = (f"SM {rec['sm_clock_mhz']:.0f} MHz" if rec["sm_clock_mhz"]
                 else "SM clock not sampled")
        print(f"[summary] {name} (Hopper, D=128: {rec['regs']} registers "
              f"at launch, {rec['smem_bytes']} B shared): {rec['ms']:.4f} "
              f"ms at {tuple(rec['shape'])} ({clock}), bound "
              f"{rec['bound_ms']:.4f} ms, SDPA {rec['library_ms']:.4f} ms "
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
