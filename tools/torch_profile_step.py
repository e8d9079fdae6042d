#!/usr/bin/env python3
"""Where the PyTorch port's training step spends its time, on one card.

    python3 tools/torch_profile_step.py            # the seq-2048 slice
    python3 tools/torch_profile_step.py --seq 8192 --batch 1 \
        --remat-policy save_flash_offload_qkv --chunked-ce   # long context
    python3 tools/torch_profile_step.py --batch 8 --layers 8 \
        --vocab 32768 --optimizer adafactor              # [adafactor]
    python3 tools/torch_profile_step.py --batch 8 --layers 32 --lora
                                                         # [lora]
    python3 tools/torch_profile_step.py --model mixtral --layers 2 \
        --optimizer adafactor                            # [mixtral]
    python3 tools/torch_profile_step.py --model gemma --layers 18 \
        --batch 6 --lora                                 # [gemma_lora]
    python3 tools/torch_profile_step.py --model gemma --layers 18 \
        --seq 8192 --batch 1 --lora                      # [gemma_long]
    python3 tools/torch_profile_step.py --decode         # [serve]'s step
    python3 tools/torch_profile_step.py --decode --weight-quant --kv-quant
    python3 tools/torch_profile_step.py --decode --model gemma
                                                         # [gemma_serve]

Builds the step chip_smoke.py drives (Llama-3-8B width, 4 layers, bf16,
adamw, flash kernels; by default batch 2 x seq 2048, full remat and the
unchunked loss; or the step of its adafactor, lora or mixtral phase),
warms up, then:

1. times the step's three phases (forward + loss, backward, optimizer)
   with a synchronised host clock, median of 5 steps;
2. profiles 2 steps with torch.profiler and prints the device time per
   step by kernel family, the device's idle share of the window, the top
   kernels, and the copy engine's time for host offload (the
   save_flash_offload_qkv policy's q/k/v round trip), which runs beside
   the kernels and is not counted as busy.

With ``--decode`` it profiles one decode step of the serving engine
instead, at [serve]'s geometry: Llama-3-8B at full depth (unless
``--layers``), 8 live slots (``--slots``) each ~1k tokens into its
context (``--context``), the paged pool of 64-token blocks, greedy; the
engine is driven step by step on this thread (prefill first, then decode
steps), and it prints the step's median ms, device time by family,
kernels and copies launched per step, and the device's idle share; then
where the step's host time goes: the CPU ops by self time per step (from
the same profile; the profiler's own cost inflates them, so the profiled
window is printed beside the unprofiled step), the host time outside any
op (Python and the engine's own code), and, without the profiler, the
host's cost of one small kernel launch and of one call of the split-KV
tile's einsum, gather and mask ops at the step's shapes.

Imports nothing of JAX. Needs a CUDA card and this file's checkout.
"""
import argparse
import collections
import dataclasses
import pathlib
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

REPO = pathlib.Path(__file__).resolve().parent.parent
N_LAYERS = 4

# Host offload copies: the copy engine, beside the kernels.
OFFLOAD = ("memcpy dtoh", "memcpy htod")
# Kernel-name fragments -> family, first match wins.
FAMILIES = (
    ("flash attention, triangular (port kernels)", ("_tri_kernel",)),
    ("flash attention, streamed (port kernels)", ("_streamed_kernel",)),
    ("flash attention, fp32 (port kernels)", ("_f32_kernel",)),
    ("flash attention, resident (port kernels)", ("flash_fwd", "flash_dq",
                                                  "flash_dkv")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                         "sm90_")),
    ("adamw (fused multi-tensor)", ("multi_tensor_apply", "fusedopti")),
    ("softmax / logsumexp / CE", ("softmax", "logsumexp", "log_softmax",
                                  "nll", "cross_entropy")),
    ("reductions (norms, grad norm)", ("reduce", "norm")),
    ("gather / scatter / embedding", ("index", "embedding", "gather",
                                      "scatter")),
    ("copies and casts", ("copy", "cast", "memcpy", "memset", "fill")),
    ("elementwise (rope, silu, clip, residual)", ("elementwise",
                                                   "vectorized", "unrolled",
                                                   "foreach")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--remat-policy", default="full")
    parser.add_argument("--chunked-ce", action="store_true",
                        help="forward_trunk + chunked_cross_entropy_loss "
                             "instead of full-sequence logits")
    parser.add_argument("--layers", type=int, default=None,
                        help=f"depth (default {N_LAYERS}; --decode: the "
                             "model's)")
    parser.add_argument("--vocab", type=int, default=None,
                        help="vocabulary (default: the model's)")
    parser.add_argument("--optimizer", default="adamw",
                        choices=("adamw", "adafactor"))
    parser.add_argument("--model", default="llama",
                        choices=("llama", "mixtral", "gemma"),
                        help="Llama-3-8B, Mixtral-8x7B or Gemma-2B widths")
    parser.add_argument("--lora", action="store_true",
                        help="the LoRA recipe's step: the base frozen, "
                             "rank-8 adapters on wq/wk/wv/wo, AdamW on "
                             "them (recipes.llama_lora)")
    parser.add_argument("--decode", action="store_true",
                        help="one serving decode step (module docstring)")
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--context", type=int, default=1024)
    parser.add_argument("--weight-quant", action="store_true")
    parser.add_argument("--kv-quant", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from skypilot_tpu_torch.models import gemma, llama, mixtral
    from skypilot_tpu_torch.recipes import llama_lora
    from skypilot_tpu_torch.train import trainer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[card] {smi.stdout.strip()}")
    if args.decode:
        return decode_step(args, gemma if args.model == "gemma" else llama)
    args.layers = args.layers or N_LAYERS
    if args.model == "mixtral":
        model = mixtral
        cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                                  n_layers=args.layers, max_seq_len=args.seq)
    elif args.model == "gemma":
        model = gemma
        cfg = dataclasses.replace(gemma.GemmaConfig.gemma_2b(),
                                  n_layers=args.layers, max_seq_len=args.seq,
                                  remat_policy=args.remat_policy)
    else:
        model = llama
        cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                                  n_layers=args.layers, max_seq_len=args.seq,
                                  remat_policy=args.remat_policy)
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab_size=args.vocab)
    print(f"[config] {args.model} width, {args.layers} layers, vocab "
          f"{cfg.vocab_size}, batch {args.batch} x seq {args.seq}, remat "
          f"{getattr(cfg, 'remat_policy', 'full')}, "
          f"{'chunked' if args.chunked_ce else 'full-logits'} loss, "
          f"{'LoRA, adamw on the adapters' if args.lora else args.optimizer}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                           device="cuda", generator=gen)
    if args.lora:
        params.requires_grad_(False)
        lora = llama_lora.init_lora(cfg, 8, gen)
        llama_lora.merge_params(params, lora)
        opt = llama_lora.make_adamw(lora, 1e-3)
        plist = list(lora.parameters())

        def update():
            opt.step()
    else:
        tx = trainer.make_optimizer(trainer.TrainConfig(
            warmup_steps=1, total_steps=100, optimizer=args.optimizer))
        state = trainer.init_train_state(params, tx)
        plist = list(params.parameters())

        def update():
            tx.update_(plist, [p.grad for p in plist], state.opt_state)

    def step(phases=None):
        # make_train_step's body, split where the phases are timed.
        for p in plist:
            p.grad = None
        t0 = sync_clock() if phases is not None else 0.0
        aux = 0.0
        if args.chunked_ce:
            hidden = llama.forward_trunk(cfg, params, tokens)
            loss = trainer.chunked_cross_entropy_loss(
                hidden[:, :-1], llama.head_weights(params), tokens[:, 1:])
        else:
            logits = model.forward(cfg, params, tokens)
            if isinstance(logits, tuple):
                logits, aux = logits
            loss = trainer.cross_entropy_loss(logits[:, :-1],
                                              tokens[:, 1:]) + aux
        t1 = sync_clock() if phases is not None else 0.0
        loss.backward()
        del loss
        t2 = sync_clock() if phases is not None else 0.0
        update()
        for p in plist:
            p.grad = None
        if phases is not None:
            t3 = sync_clock()
            phases.append((t1 - t0, t2 - t1, t3 - t2))

    for _ in range(2):
        step()
    phases = []
    for _ in range(5):
        step(phases)
    med = [sorted(col)[len(col) // 2] * 1e3 for col in zip(*phases)]
    print(f"[phases] forward+loss {med[0]:.1f} ms, backward (with remat "
          f"forward) {med[1]:.1f} ms, optimizer {med[2]:.1f} ms; sum "
          f"{sum(med):.1f} ms (median of 5 steps)")

    n_prof = 2
    with torch.profiler.profile(activities=ACTIVITIES,
                                acc_events=True) as prof:
        t0 = sync_clock()
        for _ in range(n_prof):
            step()
        wall = sync_clock() - t0
    return report(prof, wall, n_prof, "step")


ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]


def sync_clock():
    torch.cuda.synchronize()
    return time.perf_counter()


def report(prof, wall: float, n_prof: int, unit: str) -> int:
    """Device time per ``unit`` by kernel family and by kernel, the
    launches per ``unit``, and the device's idle share of the window."""
    by_family = collections.Counter()
    by_kernel = collections.Counter()
    offload = collections.Counter()
    launches = 0
    for evt in prof.events():
        # Kernels only: the CPU op that launched a kernel carries its time
        # again, and a user range on the device timeline (Optimizer.step)
        # spans kernels that are counted on their own.
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
            continue
        launches += 1
        us = evt.time_range.elapsed_us()
        low = evt.name.lower()
        if any(k in low for k in OFFLOAD):
            offload[evt.name] += us
            continue
        by_family[family(evt.name)] += us
        by_kernel[evt.name] += us
    busy = sum(by_family.values()) / 1e6
    if busy == 0:
        print("[profile] the profiler recorded no device time")
        return 1
    print(f"[profile] window {wall / n_prof * 1e3:.1f} ms/{unit}, device "
          f"busy {busy / n_prof * 1e3:.1f} ms/{unit}, idle share "
          f"{max(0.0, 1 - busy / wall):.3f}; {launches / n_prof:.0f} "
          f"kernels and copies on the device per {unit}")
    for fam, us in by_family.most_common():
        print(f"[profile] {us / n_prof / 1e3:9.2f} ms/{unit} "
              f"{us / 1e6 / busy:6.1%}  {fam}")
    for name, us in by_kernel.most_common(15):
        print(f"[kernel] {us / n_prof / 1e3:8.2f} ms/{unit}  {name[:110]}")
    for name, us in offload.most_common():
        print(f"[offload] {us / n_prof / 1e3:8.2f} ms/{unit}  {name} (copy "
              "engine, beside the kernels)")
    return 0


def decode_step(args, model) -> int:
    """The serving engine's decode step (module docstring): Llama-3-8B,
    or Gemma-2B with ``--model gemma``; ``model`` is that family's
    module."""
    from skypilot_tpu_torch.serve import decode_engine
    cfg = (model.GemmaConfig.gemma_2b() if args.model == "gemma"
           else model.LlamaConfig.llama3_8b())
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(cfg, gen)
    n_warm, n_time, n_prof = 3, 10, 3
    eng = decode_engine.DecodeEngine(
        cfg, params, slots=args.slots, max_seq=1280, prefill_chunk=64,
        paged=True, kv_quant=args.kv_quant, weight_quant=args.weight_quant)
    cpu = torch.Generator().manual_seed(1)
    for _ in range(args.slots):
        prompt = torch.randint(1, cfg.vocab_size, (args.context - 1,),
                               generator=cpu).tolist()
        eng.submit(prompt, max_tokens=n_warm + n_time + n_prof + 2)
    eng._admit()
    while eng._prefill_one():
        pass
    print(f"[config] {type(cfg).__name__} width, {cfg.n_layers} layers, "
          f"{args.slots} live slots at context ~{args.context}, paged "
          f"64-token blocks, greedy, weights "
          f"{'int8' if args.weight_quant else 'bf16'}, KV "
          f"{'int8' if args.kv_quant else 'bf16'}")
    for _ in range(n_warm):
        eng._decode_step()
    times = []
    for _ in range(n_time):
        t0 = sync_clock()
        decoded = eng._decode_step()
        times.append(sync_clock() - t0)
        if decoded != args.slots:
            print(f"FAIL: {decoded} slots decoded, not {args.slots}",
                  file=sys.stderr)
            return 1
    print(f"[decode] step {sorted(times)[n_time // 2] * 1e3:.2f} ms (median "
          f"of {n_time}; min {min(times) * 1e3:.2f}), {args.slots} tokens a "
          f"step")
    with torch.profiler.profile(activities=ACTIVITIES,
                                acc_events=True) as prof:
        t0 = sync_clock()
        for _ in range(n_prof):
            eng._decode_step()
        wall = sync_clock() - t0
    rc = report(prof, wall, n_prof, "decode step")
    host_report(prof, wall, n_prof, sorted(times)[n_time // 2])
    host_calls(cfg, args.slots)
    return rc


def host_report(prof, wall: float, n_prof: int, step_s: float) -> None:
    """CPU ops by self time per decode step, and the host time outside
    any op, from the profile."""
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    in_ops = sum(e.self_cpu_time_total for e in ops) / 1e6
    print(f"[host] profiled window {wall / n_prof * 1e3:.1f} ms/decode step "
          f"(unprofiled step {step_s * 1e3:.1f} ms): {in_ops / n_prof * 1e3:.1f}"
          f" ms inside CPU ops, {(wall - in_ops) / n_prof * 1e3:.1f} ms "
          f"outside any op (Python, the engine's code)")
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:15]:
        print(f"[host] {e.self_cpu_time_total / n_prof / 1e3:8.2f} ms/decode "
              f"step self, {e.count / n_prof:6.0f} calls, "
              f"{e.self_cpu_time_total / max(e.count, 1):6.1f} us/call  "
              f"{e.key[:60]}")


def host_calls(cfg, slots: int, n: int = 500) -> None:
    """Host microseconds per call, without the profiler: one small
    kernel launch, and the split-KV tile's ops at the decode step's
    shapes (llama._attn_tile, _paged_split_kv_attention, _tile_mask)."""
    dev = "cuda"
    kvh, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    w, bt = 256, 64
    x = torch.zeros(16, device=dev)
    qf = torch.randn(slots, 1, kvh, g, d, device=dev)
    kb = torch.randn(slots, w, kvh, d, device=dev)
    pool = torch.zeros(64, bt, kvh, d, dtype=torch.bfloat16, device=dev)
    phys = torch.randint(1, 64, (slots, w // bt), device=dev)
    pos = torch.full((slots, 1), 1000, device=dev)
    s_blk = torch.randn(slots, kvh, g, 1, w, device=dev)
    msk = torch.ones(slots, 1, w, dtype=torch.bool, device=dev)
    calls = (
        ("x.add_(1) (a small kernel)", lambda: x.add_(1)),
        ("einsum btkgd,bskd->bkgts", lambda: torch.einsum(
            "btkgd,bskd->bkgts", qf, kb)),
        ("pool[phys].float() (block gather)", lambda: pool[phys].float()),
        ("torch.where(mask, s, -1e30)", lambda: torch.where(
            msk[:, None, None], s_blk, -1e30)),
        ("arange + tile mask", lambda: (
            torch.arange(w, device=dev) <= pos[..., None])),
    )
    out = []
    for label, fn in calls:
        fn()
        t0 = sync_clock()
        for _ in range(n):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out.append(f"{label} {host / n * 1e6:.1f}")
    print(f"[host] host us per call, no profiler ({n} calls each): " +
          "; ".join(out))


if __name__ == "__main__":
    sys.exit(main())
