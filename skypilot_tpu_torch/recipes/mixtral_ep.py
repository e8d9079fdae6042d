"""Mixtral-8x7B expert-parallel pretraining step: the port of the JAX
package's ``recipes/mixtral_ep.py``.

The mesh is {"dp": -1, "ep": ep} over every process (one per card), with
``DEFAULT_RULES``: each expert tensor is split over ``ep`` (``"expert":
EP``) and stays on its rank, the rest is replicated, and the batch is
split over dp. The step is ``make_train_step(..., mesh=, rules=)``;
``mixtral.forward`` on a mesh routes every rank's tokens as the whole
batch routes them (``models/mixtral.py`` ``_moe_mlp_sharded``), and the
loss is CE plus the router's aux loss.

    python -m skypilot_tpu_torch.recipes.mixtral_ep --device cpu \\
        --model tiny --steps 10

Without ``--device`` it runs on the card, and raises when there is none.
Several cards: ``torchrun --nproc-per-node <cards> -m
skypilot_tpu_torch.recipes.mixtral_ep ...`` under the SKYPILOT_* env
(``train.distributed.initialize_from_env``). Every process draws the same
weights and the same global batch from ``--seed`` (``--batch-size`` is the
global batch, as in JAX) and keeps the rows of its dp index; the ranks of
one ep group read the same rows.

Armed (``STPU_TRAINSTATS=1``), the loop records every step in
``observability/trainstats`` where the JAX recipe does, and the out dict
carries its ``train_*`` keys.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from skypilot_tpu_torch import resolve_device
from skypilot_tpu_torch.models import mixtral
from skypilot_tpu_torch.observability import trainstats
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.recipes import synthetic_data
from skypilot_tpu_torch.train import distributed, trainer


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=["tiny", "8x7b"], default="tiny")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8,
                   help="global batch (split over dp)")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--ep", type=int, default=-1,
                   help="expert-parallel axis size (-1: min(processes, "
                        "n_experts))")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with-grad-norm", action="store_true",
                   help="report grad_norm per step (an extra sweep over "
                        "every gradient, so benches leave it off)")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:<LOCAL_RANK>"
                        "), which must exist. 'cpu' runs the kernels' "
                        "plain versions.")
    return p


def batch_rows(mesh, batch_size: int) -> slice:
    """This process's rows of the global batch: its dp index's block."""
    dp = mesh_lib.axis_size(mesh, mesh_lib.DP)
    if batch_size % dp:
        raise SystemExit(f"--batch-size {batch_size} not divisible by "
                         f"dp={dp}")
    per = batch_size // dp
    i = mesh_lib.axis_index(mesh, mesh_lib.DP)
    return slice(i * per, (i + 1) * per)


def build(cfg: mixtral.MixtralConfig, args, device: torch.device, mesh,
          rules=mesh_lib.DEFAULT_RULES):
    """The placed train state and the sharded step: the weights drawn
    from ``--seed`` on every process, each keeping its shard."""
    gen_device = device if device.type == "cuda" else "cpu"
    params = mixtral.init(cfg, torch.Generator(gen_device).manual_seed(
        args.seed), device)
    tx = trainer.make_optimizer(trainer.TrainConfig(total_steps=args.steps))
    state = trainer.init_train_state(params, tx)
    state = trainer.place_state(state, trainer.state_shardings(
        mesh, rules, mixtral.param_specs(cfg), state), tx)
    # grad_norm defaults off: its extra sweep over every gradient is pure
    # MFU tax on the bench path.
    step = trainer.make_train_step(
        lambda p, t: mixtral.forward(cfg, p, t), tx,
        with_grad_norm=args.with_grad_norm, mesh=mesh, rules=rules)
    return state, step


def train_batches(cfg: mixtral.MixtralConfig, args):
    """The global batches of the run, (batch, seq) token arrays, the same
    on every process."""
    data = synthetic_data.lm_tokens(args.seed, 128, args.seq_len,
                                    cfg.vocab_size)
    return (tokens for (tokens,) in synthetic_data.batches(
        (data,), args.batch_size, args.seed, args.steps))


def main(argv=None) -> dict:
    args = build_arg_parser().parse_args(argv)
    cfg = (mixtral.MixtralConfig.mixtral_8x7b() if args.model == "8x7b"
           else mixtral.MixtralConfig.tiny())
    return run(args, cfg)[0]


def run(args, cfg: mixtral.MixtralConfig):
    """The training loop on ``cfg``: (the out dict, the final placed
    train state)."""
    device = resolve_device(args.device)
    ctx = distributed.initialize_from_env(device=device)
    world = ctx.world_size
    ep = args.ep if args.ep != -1 else min(world, cfg.n_experts)
    mesh = mesh_lib.make_mesh({"dp": -1, "ep": ep}, device=device)
    shape = {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    print(f"mixtral_ep: model={args.model} mesh={shape} device={device} "
          f"rank={ctx.rank}/{world}", flush=True)

    state, step = build(cfg, args, device, mesh)
    if trainstats.ENABLED:
        trainstats.configure(
            flops_per_token=cfg.flops_per_token(),
            peak_flops=trainstats.detect_peak_flops(device),
            host=ctx.rank, hosts=world, job="mixtral_ep")
    rows = batch_rows(mesh, args.batch_size)
    t0 = time.time()
    aux_loss = None
    losses = []
    # One-step-delayed metrics fetch: each iteration reads the previous
    # step's metrics, so logging never waits on the step just launched.
    delayed = trainer.DelayedFetch()
    tokens_per_step = args.batch_size * args.seq_len
    try:
        mark = time.perf_counter()
        for i, tokens in enumerate(train_batches(cfg, args)):
            data_wait = time.perf_counter() - mark
            step_t0 = time.perf_counter()
            state, metrics = step(state, {"tokens": torch.from_numpy(
                tokens[rows]).long().to(device)})
            dispatch_s = time.perf_counter() - step_t0
            fetched = grad_norm = None
            prev = delayed.rotate(metrics)
            if prev is not None:
                fetched = float(prev["loss"])
                losses.append(fetched)
                aux_loss = float(prev["aux_loss"])
                if "grad_norm" in prev:
                    grad_norm = float(prev["grad_norm"])
            device_s = None
            if trainstats.ENABLED and trainstats.sync_due():
                device_s = trainstats.sampled_sync(metrics["loss"])
            dur = time.perf_counter() - step_t0
            if trainstats.ENABLED:
                trainstats.record_step(
                    step=i + 1, dur=dur, tokens=tokens_per_step,
                    data_wait_s=data_wait, dispatch_s=dispatch_s,
                    device_s=device_s,
                    delayed=({"loss": fetched, "grad_norm": grad_norm}
                             if fetched is not None else None))
            mark = time.perf_counter()
        # The last fetch waits for the final step.
        final = delayed.drain()
        if final is not None:
            losses.append(float(final["loss"]))
            aux_loss = float(final["aux_loss"])
    except (Exception, KeyboardInterrupt) as e:
        if trainstats.ENABLED:
            trainstats.dump_flight("train_crash", error=repr(e))
        raise
    wall = time.time() - t0

    out = {
        "recipe": "mixtral_ep",
        "model": args.model,
        "mesh": shape,
        "steps": args.steps,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "aux_loss": aux_loss,
        "tokens_per_second": round(
            args.steps * args.batch_size * args.seq_len / wall, 1),
        "wall_seconds": round(wall, 2),
    }
    if trainstats.ENABLED:
        snap = trainstats.snapshot()
        out["train_mfu"] = snap["mfu"]
        out["train_goodput"] = snap["goodput"]
        out["train_step_seconds"] = snap["step_seconds_mean"]
        out["train_tokens_per_sec"] = snap["tokens_per_sec"]
        trainstats.flush()
    print(json.dumps(out), flush=True)
    return out, state


if __name__ == "__main__":
    main()
