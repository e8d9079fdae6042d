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
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
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
    parser.add_argument("--layers", type=int, default=N_LAYERS)
    parser.add_argument("--vocab", type=int, default=None,
                        help="vocabulary (default: the model's)")
    parser.add_argument("--optimizer", default="adamw",
                        choices=("adamw", "adafactor"))
    parser.add_argument("--model", default="llama",
                        choices=("llama", "mixtral"),
                        help="Llama-3-8B or Mixtral-8x7B widths")
    parser.add_argument("--lora", action="store_true",
                        help="the LoRA recipe's step: the base frozen, "
                             "rank-8 adapters on wq/wk/wv/wo, AdamW on "
                             "them (recipes.llama_lora)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from skypilot_tpu_torch.models import llama, mixtral
    from skypilot_tpu_torch.recipes import llama_lora
    from skypilot_tpu_torch.train import trainer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[card] {smi.stdout.strip()}")
    if args.model == "mixtral":
        model = mixtral
        cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                                  n_layers=args.layers, max_seq_len=args.seq)
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

    def sync_clock():
        torch.cuda.synchronize()
        return time.perf_counter()

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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = sync_clock()
        for _ in range(n_prof):
            step()
        wall = sync_clock() - t0
    by_family = collections.Counter()
    by_kernel = collections.Counter()
    offload = collections.Counter()
    for evt in prof.events():
        # Kernels only: the CPU op that launched a kernel carries its time
        # again, and a user range on the device timeline (Optimizer.step)
        # spans kernels that are counted on their own.
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
            continue
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
    print(f"[profile] window {wall / n_prof * 1e3:.1f} ms/step, device busy "
          f"{busy / n_prof * 1e3:.1f} ms/step, idle share "
          f"{max(0.0, 1 - busy / wall):.3f}")
    for fam, us in by_family.most_common():
        print(f"[profile] {us / n_prof / 1e3:9.2f} ms/step "
              f"{us / 1e6 / busy:6.1%}  {fam}")
    for name, us in by_kernel.most_common(15):
        print(f"[kernel] {us / n_prof / 1e3:8.2f} ms/step  {name[:110]}")
    for name, us in offload.most_common():
        print(f"[offload] {us / n_prof / 1e3:8.2f} ms/step  {name} (copy "
              "engine, beside the kernels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
