"""Data-parallel ResNet: the port of the JAX package's
``recipes/resnet_ddp.py`` (the DDP benchmark's named config, resnet101 at
224 x 224), on ``torch.nn.parallel.DistributedDataParallel``.

    python -m skypilot_tpu_torch.recipes.resnet_ddp --device cpu --tiny \\
        --steps 30

Without ``--device`` it runs on the card, and raises when there is none.
Several processes: one per card under the SKYPILOT_* env
(``train.distributed.initialize_from_env``: NCCL on the cards, gloo with
``--device cpu``); DDP averages the gradients over the group every step,
so every rank ends with the same parameters (``param_digest``). Every
rank draws its own batch from ``seed + step * world + rank``: the port's
ranks are processes (one per card), where the JAX recipe counts nodes.

The model is flax's: ``GroupNorm(8)`` with eps 1e-6 (no batch
statistics to synchronise), ``"SAME"`` convolutions and max pool
(``recipes/layers.py``: the stride-2 ones pad asymmetrically, the pool
with -inf), plain SGD with momentum 0.9 (optax's ``trace`` is torch's
momentum buffer with dampening 0). Inputs are NHWC as in JAX and permuted
once to NCHW. Convolutions run on cuDNN with TF32 (torch's default,
``torch.backends.cudnn.allow_tf32``; the banner prints it), the final
``Dense`` in full f32 (torch's default for matmuls).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch import resolve_device
from skypilot_tpu_torch.observability import trainstats
from skypilot_tpu_torch.recipes import layers
from skypilot_tpu_torch.train import distributed

GN_GROUPS = 8
GN_EPS = 1e-6
RESNET101 = (3, 4, 23, 3)
TINY = dict(stage_sizes=(1, 1), width=8, n_classes=10)
TINY_IMAGE = 32


class ResNetBlock(nn.Module):
    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.conv0 = layers.SameConv2d(cin, features, 3, strides, bias=False)
        self.norm0 = nn.GroupNorm(GN_GROUPS, features, eps=GN_EPS)
        self.conv1 = layers.SameConv2d(features, features, 3, bias=False)
        self.norm1 = nn.GroupNorm(GN_GROUPS, features, eps=GN_EPS)
        # Flax projects the residual when its shape differs from the
        # block's output: a stride or a change of width.
        self.proj = (layers.SameConv2d(cin, features, 1, strides,
                                       bias=False)
                     if strides != 1 or cin != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm0(self.conv0(x)))
        y = self.norm1(self.conv1(y))
        residual = x if self.proj is None else self.proj(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """NHWC images (B, H, W, 3) -> (B, n_classes) logits."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 width: int = 64, n_classes: int = 1000):
        super().__init__()
        self.stem = layers.SameConv2d(3, width, 7, 2, bias=False)
        self.stem_norm = nn.GroupNorm(GN_GROUPS, width, eps=GN_EPS)
        blocks, cin = [], width
        for i, n_blocks in enumerate(stage_sizes):
            feats = width * (2 ** i)
            for j in range(n_blocks):
                blocks.append(ResNetBlock(cin, feats,
                                          2 if i > 0 and j == 0 else 1))
                cin = feats
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_norm(self.stem(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(layers.pad_same(x, 3, 2, float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))


def make_model(args, device: torch.device) -> ResNet:
    """The tiny ResNet or resnet101, drawn as flax draws it."""
    model = (ResNet(**TINY) if args.tiny
             else ResNet(stage_sizes=RESNET101, width=64))
    layers.flax_init_(model, torch.Generator().manual_seed(args.seed))
    return model.to(device)


def sample_batch(args, step: int, rank: int, world: int, n_classes: int):
    """Rank ``rank``'s NHWC batch of step ``step``: every rank draws the
    same dataset (seeded) and reads its own shard."""
    r = np.random.RandomState(args.seed + step * world + rank)
    x = r.randn(args.batch_size, args.image_size, args.image_size,
                3).astype(np.float32)
    y = r.randint(0, n_classes, size=(args.batch_size,)).astype(np.int32)
    return x, y


def param_digest(model: nn.Module) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-process batch size")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="small model/images for CPU tests")
    p.add_argument("--out-file", type=str, default=None,
                   help="write final metrics+param digest JSON here")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:<LOCAL_RANK>"
                        "), which must exist")
    return p


def run(args):
    """The training loop: (metrics, the trained model without its DDP
    wrapper)."""
    device = resolve_device(args.device)
    ctx = distributed.initialize_from_env(device=device)
    rank, world = ctx.rank, ctx.world_size
    if args.tiny:
        args.image_size = TINY_IMAGE
    n_classes = TINY["n_classes"] if args.tiny else 1000
    model = make_model(args, device)
    backend = torch.distributed.get_backend() if ctx.initialized else None
    print(f"resnet_ddp: rank={rank}/{world} device={device} "
          f"backend={backend} "
          f"cudnn_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    net = model
    if ctx.is_multiprocess:
        net = nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None)
    opt = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)

    if trainstats.ENABLED:
        trainstats.configure(peak_flops=trainstats.detect_peak_flops(device),
                             host=rank, hosts=world, job="resnet_ddp")
    iter_times = []
    loss = None
    try:
        for i in range(args.steps):
            data_t0 = time.perf_counter()
            x, y = sample_batch(args, i, rank, world, n_classes)
            data_wait = time.perf_counter() - data_t0
            t0 = time.perf_counter()
            logits = net(torch.from_numpy(x).to(device))
            loss = F.cross_entropy(logits,
                                   torch.from_numpy(y).long().to(device))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            # The DDP bench fences every iteration by design: iteration
            # times measure the full step, not its dispatch.
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dur = time.perf_counter() - t0
            iter_times.append(dur)
            if trainstats.ENABLED:
                trainstats.record_step(step=i + 1, dur=dur,
                                       tokens=args.batch_size,
                                       data_wait_s=data_wait)
    except (Exception, KeyboardInterrupt) as e:
        if trainstats.ENABLED:
            trainstats.dump_flight("train_crash", error=repr(e))
        raise

    world_batch = args.batch_size * world
    p50 = float(np.median(iter_times[2:] or iter_times))
    metrics = {
        "recipe": "resnet_ddp",
        "rank": rank,
        "num_nodes": ctx.num_nodes,
        "steps": args.steps,
        "final_loss": float(loss.detach()),
        "p50_iter_seconds": round(p50, 4),
        "examples_per_second": round(world_batch / p50, 1),
        "param_digest": param_digest(model),
    }
    if trainstats.ENABLED:
        snap = trainstats.snapshot()
        metrics["train_goodput"] = snap["goodput"]
        metrics["train_step_seconds"] = snap["step_seconds_mean"]
        trainstats.flush()
    print(json.dumps(metrics), flush=True)
    if args.out_file:
        with open(args.out_file, "w") as f:
            json.dump(metrics, f)
    return metrics, model


def main(argv=None) -> dict:
    return run(build_arg_parser().parse_args(argv))[0]


if __name__ == "__main__":
    main()
