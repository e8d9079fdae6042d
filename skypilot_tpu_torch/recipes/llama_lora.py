"""Llama-3.1 LoRA finetune with crash-consistent checkpoints: the port of
the JAX package's flagship recipe (``skypilot_tpu/recipes/llama_lora.py``).

Low-rank adapters on the attention projections (y @ A @ B inside
``llama.lora_dense``, never the full-rank delta), the base weights frozen
(``requires_grad=False``: no gradient is computed for them), and
checkpoints in the JAX package's format (``train/checkpoint.py``) every
``--ckpt-every`` steps. A preempted run resumes bit-identically: the full
train state (adapters, optimizer state, step, data position, RNG state)
round-trips as raw bytes and the data stream replays from the saved
position. On SIGTERM the loop finishes its step, saves, and exits 143.

    python -m skypilot_tpu_torch.recipes.llama_lora --device cpu \\
        --model tiny --steps 6 --checkpoint-dir /tmp/run1

Without ``--device`` it runs on the card, and raises when there is none.

Beside the JAX recipe: the optimizer is ``torch.optim.AdamW`` at optax
``adamw(lr)``'s defaults (its weight decay 1e-4 passed explicitly; torch's
default is 1e-2); the RNG leaf is a torch generator's state; the
``train_*`` keys of the JAX package's trainstats are not reported; and
multi-node runs (``SKYPILOT_NUM_NODES`` > 1) raise, the port having no
``torch.distributed`` set-up yet.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from skypilot_tpu_torch import callbacks, resolve_device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.recipes import synthetic_data
from skypilot_tpu_torch.train import checkpoint as checkpoint_lib
from skypilot_tpu_torch.train import trainer
from skypilot_tpu_torch.utils import fault_injection

LORA_TARGETS = ("wq", "wk", "wv", "wo")
# optax.adamw's defaults, which the JAX recipe takes (adamw(args.lr)).
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4
# The framework's node env contract (skypilot_tpu/agent/constants.py).
NODE_RANK_ENV = "SKYPILOT_NODE_RANK"
NUM_NODES_ENV = "SKYPILOT_NUM_NODES"


class LoraParams(nn.Module):
    """The adapter tree, one module per decoder layer holding its
    ``<name>_lora_a`` (in, r) and ``<name>_lora_b`` (r, out): the JAX
    tree's ``{"layers": {"<name>_lora_a": (L, in, r), ...}}`` split along
    its stacked axis."""

    def __init__(self, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(nn.Module() for _ in range(n_layers))

    def names(self) -> List[str]:
        return [n for n, _ in self.layers[0].named_parameters()]

    def stacked(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The JAX tree: each adapter stacked on a new layer axis."""
        return {"layers": {n: torch.stack([getattr(lp, n).detach()
                                           for lp in self.layers])
                           for n in self.names()}}


def lora_shapes(cfg, targets: Sequence[str] = LORA_TARGETS
                ) -> Dict[str, tuple]:
    """(in, out) of each target projection."""
    d, qd, kvd = cfg.dim, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d)}
    return {n: shapes[n] for n in targets}


@torch.no_grad()
def init_lora(cfg, rank: int, generator: torch.Generator,
              targets: Sequence[str] = LORA_TARGETS,
              device=None) -> LoraParams:
    """A ~ N(0, 1/in), B = 0 (the model starts exactly at the base), in
    the config dtype; the numbers differ from JAX's PRNG."""
    device = resolve_device(device)
    lora = LoraParams(cfg.n_layers)
    for name, (fan_in, fan_out) in lora_shapes(cfg, targets).items():
        a = torch.randn((cfg.n_layers, fan_in, rank), generator=generator,
                        device=generator.device, dtype=torch.float32)
        a = (a * fan_in ** -0.5).to(cfg.dtype).to(device)
        for lp, a_l in zip(lora.layers, a):
            setattr(lp, name + "_lora_a", nn.Parameter(a_l.clone()))
            setattr(lp, name + "_lora_b", nn.Parameter(torch.zeros(
                (rank, fan_out), dtype=cfg.dtype, device=device)))
    return lora


def merge_params(base: nn.Module, lora: LoraParams) -> nn.Module:
    """Register the adapters on the base's layers (the same tensors, not
    copies), where ``lora_dense`` finds them; returns ``base``."""
    for lp, ll in zip(base.layers, lora.layers):
        for name, p in ll.named_parameters():
            setattr(lp, name, p)
    return base


def num_params(tree: nn.Module) -> int:
    return sum(p.numel() for p in tree.parameters())


def make_adamw(lora: LoraParams, lr: float) -> torch.optim.AdamW:
    """optax.adamw(lr): its decoupled decay p * (1 - lr * wd), then
    lr * m_hat / (sqrt(v_hat) + eps), is torch's AdamW."""
    return torch.optim.AdamW(lora.parameters(), lr=lr, betas=ADAMW_BETAS,
                             eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY,
                             fused=True)


def adamw_state_tree(opt: torch.optim.AdamW, lora: LoraParams) -> list:
    """The optimizer state in optax.adamw's layout: a chain of one
    ScaleByAdamState (count int32, mu, nu) and two empty states, so the
    checkpoint keys are the JAX recipe's (``opt_state/0/0``,
    ``opt_state/0/1/layers/<name>``, ``opt_state/0/2/...``). Before the
    first step it is optax's init state: zeros."""
    mu, nu = {}, {}
    count = None
    for name in lora.names():
        ps = [getattr(lp, name) for lp in lora.layers]
        states = [opt.state.get(p) for p in ps]
        if states[0]:
            mu[name] = torch.stack([s["exp_avg"] for s in states])
            nu[name] = torch.stack([s["exp_avg_sq"] for s in states])
            count = states[0]["step"].to(torch.int32)
        else:
            mu[name] = torch.stack([torch.zeros_like(p) for p in ps])
            nu[name] = torch.stack([torch.zeros_like(p) for p in ps])
    if count is None:
        count = torch.zeros((), dtype=torch.int32)
    return [(count, {"layers": mu}, {"layers": nu})]


@torch.no_grad()
def load_lora(lora: LoraParams, tree: dict) -> None:
    for name, stacked in tree["layers"].items():
        for lp, t in zip(lora.layers, stacked):
            getattr(lp, name).copy_(t)


@torch.no_grad()
def load_adamw(opt: torch.optim.AdamW, lora: LoraParams,
               tree: list) -> None:
    count, mu, nu = tree[0]
    for name in lora.names():
        for i, lp in enumerate(lora.layers):
            p = getattr(lp, name)
            opt.state[p] = {
                # fused AdamW keeps its step as an f32 scalar beside p
                "step": count.to(device=p.device, dtype=torch.float32),
                "exp_avg": mu["layers"][name][i].to(p.device).clone(),
                "exp_avg_sq": nu["layers"][name][i].to(p.device).clone()}


def make_step_fn(model_lib, cfg, params: nn.Module, lora: LoraParams,
                 opt: torch.optim.AdamW):
    """The JAX recipe's ``step_fn``: next-token CE of ``params`` (the
    base with the adapters merged), gradients of the adapters only, one
    AdamW update; returns the loss, on the device."""
    plist = list(lora.parameters())

    def step_fn(tokens: torch.Tensor) -> torch.Tensor:
        for p in plist:
            p.grad = None
        logits = model_lib.forward(cfg, params, tokens)
        loss = trainer.cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
        del logits
        loss.backward()
        opt.step()
        for p in plist:
            p.grad = None
        return loss.detach()

    return step_fn


def build_arg_parser(model_choices, default_model) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=model_choices,
                   default=default_model)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--lora-rank", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:0), which "
                        "must exist. 'cpu' runs the kernels' plain "
                        "versions.")
    p.add_argument("--checkpoint-dir", type=str,
                   default=os.environ.get(checkpoint_lib.CKPT_DIR_ENV),
                   help="checkpoint root (train/checkpoint.py format); "
                        "defaults to "
                        f"${checkpoint_lib.CKPT_DIR_ENV}, which the "
                        "managed-jobs controller stamps per job.")
    p.add_argument("--ckpt-every", "--save-every", dest="ckpt_every",
                   type=int, default=10,
                   help="save a checkpoint every N steps (a preemption "
                        "replays at most N-1 steps)")
    p.add_argument("--ckpt-keep", type=int,
                   default=checkpoint_lib.DEFAULT_KEEP,
                   help="retention: newest checkpoints kept on disk")
    p.add_argument("--ckpt-sync", action="store_true",
                   help="write checkpoints synchronously on the step "
                        "path (default: async D2H + background write)")
    return p


def main(argv=None) -> dict:
    args = build_arg_parser(["tiny", "8b"], "tiny").parse_args(argv)
    cfg = (llama.LlamaConfig.llama3_8b() if args.model == "8b"
           else llama.LlamaConfig.tiny())
    return run_lora(llama, cfg, args, recipe_name="llama_lora")


def _node_rank() -> int:
    """This node's rank; more than one node raises (no torch.distributed
    set-up in the port yet), never runs a multi-node job as one
    process."""
    num_nodes = int(os.environ.get(NUM_NODES_ENV, "1"))
    if num_nodes > 1:
        raise NotImplementedError(
            f"{NUM_NODES_ENV}={num_nodes}: multi-node training is not "
            "ported yet; run one node")
    return int(os.environ.get(NODE_RANK_ENV, "0"))


def init_model(model_lib, cfg, args, device: torch.device):
    """The frozen base and the step-0 adapters, both from ``--seed``."""
    gen_device = device if device.type == "cuda" else "cpu"
    base = model_lib.init(cfg, torch.Generator(gen_device).manual_seed(
        args.seed), device)
    base.requires_grad_(False)
    lora = init_lora(cfg, args.lora_rank, torch.Generator(
        gen_device).manual_seed(args.seed + 1), device=device)
    return base, lora


def train_batches(cfg, args, steps: int, skip: int = 0, rank: int = 0):
    """The token batches of ``steps`` steps after ``skip`` completed ones:
    the same batch for a step whether or not the run was interrupted."""
    data = synthetic_data.lm_tokens(args.seed + rank, 256, args.seq_len,
                                    cfg.vocab_size)
    return synthetic_data.batches((data,), args.batch_size, args.seed,
                                  steps, skip=skip)


def run_lora(model_lib, cfg, args, recipe_name: str) -> dict:
    """LoRA finetune loop, generic over the dense model families."""
    rank = _node_rank()
    device = resolve_device(args.device)
    if args.seq_len > cfg.max_seq_len:
        raise SystemExit(f"--seq-len {args.seq_len} exceeds model max "
                         f"{cfg.max_seq_len}")
    print(f"{recipe_name}: model={args.model} device={device} "
          f"rank={rank}/1", flush=True)

    base, lora = init_model(model_lib, cfg, args, device)
    params = merge_params(base, lora)
    opt = make_adamw(lora, args.lr)
    start_step = 0
    data_start = 0
    # Carried in the checkpoint (full train-state contract) so a
    # stochastic op added later resumes mid-stream.
    train_rng = torch.Generator().manual_seed(args.seed + 2).get_state()

    def _state_tree(step: int):
        return {"lora": lora.stacked(),
                "opt_state": adamw_state_tree(opt, lora),
                "step": np.int64(step), "data_pos": np.int64(step),
                "rng": train_rng}

    saver = None
    if args.checkpoint_dir:
        ckpt_dir = os.path.abspath(os.path.expanduser(args.checkpoint_dir))
        saver = checkpoint_lib.Checkpointer(
            ckpt_dir, keep=args.ckpt_keep, async_save=not args.ckpt_sync)
        restored = checkpoint_lib.restore_latest(ckpt_dir,
                                                 like=_state_tree(0))
        if restored is not None:
            # Raw bytes, no dtype cast: the resume is bit-identical.
            load_lora(lora, restored.tree["lora"])
            load_adamw(opt, lora, restored.tree["opt_state"])
            train_rng = restored.tree["rng"]
            start_step = int(restored.tree["step"])
            # Its own leaf, not derived from step.
            data_start = int(restored.tree["data_pos"])
            print(f"{recipe_name}: resumed from step {start_step}",
                  flush=True)

    step_fn = make_step_fn(model_lib, cfg, params, lora, opt)
    grace = checkpoint_lib.GraceHandler.install()
    t0 = time.time()
    losses = []
    # One-step-delayed loss fetch: each iteration reads the previous
    # step's loss, so logging never waits on the step just launched.
    delayed = trainer.DelayedFetch()
    with callbacks.device_profile():
        for i, (tokens,) in enumerate(train_batches(
                cfg, args, args.steps - start_step, skip=data_start,
                rank=rank)):
            step = start_step + i + 1
            loss = step_fn(torch.from_numpy(tokens).long().to(device))
            prev = delayed.rotate(loss)
            if prev is not None:
                losses.append(float(prev))
            # Chaos seam: a deterministic mid-run crash or preemption
            # (STPU_FAULTS="train.step:kill:skip=K").
            if fault_injection.ENABLED:
                fault_injection.fire("train.step", step=step)
            # Read once: a SIGTERM between the save test and the exit
            # test must not skip the grace save.
            preempting = grace.triggered
            if saver is not None and (step % args.ckpt_every == 0
                                      or step == args.steps
                                      or preempting):
                saver.save(step, _state_tree(step))
            if preempting:
                if saver is not None:
                    saver.wait()  # the grace save must be durable
                print(json.dumps({
                    "recipe": recipe_name, "preempted": True,
                    "resumed_from": start_step, "stopped_at": step,
                    "last_ckpt_step": (saver.last_saved_step
                                       if saver is not None else None),
                }), flush=True)
                raise SystemExit(
                    checkpoint_lib.GraceHandler.GRACE_EXIT_CODE)
        # The last fetch logs the final loss and waits for its step.
        final = delayed.drain()
        if final is not None:
            losses.append(float(final))
    if saver is not None:
        saver.wait()

    wall = time.time() - t0
    steps_run = max(args.steps - start_step, 0)
    tokens_seen = steps_run * args.batch_size * args.seq_len
    metrics = {
        "recipe": recipe_name,
        "model": args.model,
        "lora_params": num_params(lora),
        "base_params": cfg.num_params(),
        "resumed_from": start_step,
        "last_ckpt_step": (saver.last_saved_step
                           if saver is not None else None),
        "steps": args.steps,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "tokens_per_second": round(tokens_seen / wall, 1) if wall else 0,
        "wall_seconds": round(wall, 2),
    }
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    main()
