"""MNIST: the minimum end-to-end recipe, the port of the JAX package's
``recipes/mnist.py`` (a small CNN on ``synthetic_data.mnist_like``).

    python -m skypilot_tpu_torch.recipes.mnist --device cpu --steps 300

Without ``--device`` it runs on the card, and raises when there is none.
The loop runs under the port's step recorder (``callbacks.init``,
``step_iterator``, ``flush``): under a benchmark harness that exported
``STPU_BENCHMARK_LOG_DIR`` it writes ``benchmark_summary.json`` there.

The CNN is flax's: ``"SAME"`` 3x3 convolutions (stride 1: one pixel each
side), ``VALID`` 2x2 average pools, and a ``Dense`` over the NHWC
flattening of the last feature map (the map is permuted to NHWC before
the flattening, so carried flax weights compute the same function).
``optax.adam`` is ``torch.optim.Adam`` at the same defaults (eps 1e-8).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch import callbacks, resolve_device
from skypilot_tpu_torch.recipes import layers, synthetic_data
from skypilot_tpu_torch.train import distributed


class CNN(nn.Module):
    """NHWC images (B, 28, 28, 1) -> (B, 10) logits."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(1, 16, 3, padding=1)
        self.conv1 = nn.Conv2d(16, 32, 3, padding=1)
        self.dense0 = nn.Linear(7 * 7 * 32, 128)
        self.dense1 = nn.Linear(128, 10)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.avg_pool2d(F.relu(self.conv0(x)), 2)
        x = F.avg_pool2d(F.relu(self.conv1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense1(F.relu(self.dense0(x)))


def make_model(seed: int, device: torch.device) -> CNN:
    """The CNN drawn as flax draws it (``layers.flax_init_``)."""
    model = CNN()
    layers.flax_init_(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def accuracy(model: nn.Module, x: np.ndarray, y: np.ndarray,
             device: torch.device) -> float:
    with torch.no_grad():
        logits = model(torch.from_numpy(x).to(device))
        hits = logits.argmax(dim=-1) == torch.from_numpy(y).to(device)
        return float(hits.float().mean())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default the card, which must exist")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    ctx = distributed.initialize_from_env(device=device)
    print(f"mnist: device={device} rank={ctx.rank}/{ctx.world_size}",
          flush=True)

    model = make_model(args.seed, device)
    images, labels = synthetic_data.mnist_like(args.seed, 8192)
    test_x, test_y = synthetic_data.mnist_like(args.seed + 1, 1024)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)

    callbacks.init(total_steps=args.steps)
    t0 = time.time()
    loss = None
    for x, y in callbacks.step_iterator(
            synthetic_data.batches((images, labels), args.batch_size,
                                   args.seed, args.steps)):
        logits = model(torch.from_numpy(x).to(device))
        loss = F.cross_entropy(logits, torch.from_numpy(y).long().to(device))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    final_loss = float(loss.detach()) if loss is not None else None
    callbacks.flush()

    acc = accuracy(model, test_x, test_y, device)
    metrics = {
        "recipe": "mnist",
        "steps": args.steps,
        "final_loss": final_loss,
        "test_accuracy": acc,
        "wall_seconds": round(time.time() - t0, 2),
    }
    print(json.dumps(metrics), flush=True)
    if args.steps >= 100 and acc < 0.8:
        raise SystemExit(f"mnist accuracy {acc:.3f} below 0.8: "
                         f"training did not converge")
    return metrics


if __name__ == "__main__":
    main()
