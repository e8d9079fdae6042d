"""Text classification: the port of the JAX package's
``recipes/glue_imdb.py`` (a small transformer encoder classifier over
``synthetic_data.imdb_like``).

    python -m skypilot_tpu_torch.recipes.glue_imdb --device cpu --steps 200

Without ``--device`` it runs on the card, and raises when there is none.

The modules keep flax's defaults where torch's differ: ``LayerNorm``'s
eps 1e-6 (torch: 1e-5); ``nn.gelu``'s tanh approximation;
``MultiHeadDotProductAttention``'s biased q/k/v projections onto
(heads, head_dim) and biased output projection from them, the query
scaled by head_dim ** -0.5, the weights in flax's layout ((dim, heads,
head_dim) and (heads, head_dim, dim)); and ``optax.adamw(3e-4)``'s weight
decay of 1e-4 (torch's ``AdamW`` default: 1e-2). The attention is plain
torch ops, as JAX's is plain XLA.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skypilot_tpu_torch import resolve_device
from skypilot_tpu_torch.recipes import layers, synthetic_data
from skypilot_tpu_torch.train import distributed

LN_EPS = 1e-6
WEIGHT_DECAY = 1e-4


class SelfAttention(nn.Module):
    """Flax's ``MultiHeadDotProductAttention(num_heads)`` on (x, x), no
    mask, no dropout."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        hd = dim // heads
        for name in ("query", "key", "value"):
            setattr(self, name + "_kernel", nn.Parameter(
                torch.empty(dim, heads, hd)))
            setattr(self, name + "_bias", nn.Parameter(
                torch.zeros(heads, hd)))
        self.out_kernel = nn.Parameter(torch.empty(heads, hd, dim))
        self.out_bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def proj(name):
            return (torch.einsum("bsd,dhk->bshk", x,
                                 getattr(self, name + "_kernel")) +
                    getattr(self, name + "_bias"))
        q, k, v = proj("query"), proj("key"), proj("value")
        q = q / (q.shape[-1] ** 0.5)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return torch.einsum("bshk,hkd->bsd", o, self.out_kernel) + \
            self.out_bias

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        dim, heads, hd = self.query_kernel.shape
        for name in ("query", "key", "value"):
            layers.lecun_normal_(getattr(self, name + "_kernel"), dim,
                                 generator)
        layers.lecun_normal_(self.out_kernel, heads * hd, generator)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SelfAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.dense0 = nn.Linear(dim, dim * 4)
        self.dense1 = nn.Linear(dim * 4, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm0(x))
        y = F.gelu(self.dense0(self.norm1(x)), approximate="tanh")
        return x + self.dense1(y)


class TextClassifier(nn.Module):
    """Token ids (B, S) -> (B, n_classes) logits; ``seq_len`` sizes the
    learned position table (flax sizes it from the init input)."""

    def __init__(self, seq_len: int, vocab_size: int = 1000, dim: int = 64,
                 heads: int = 4, n_layers: int = 2, n_classes: int = 2):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, dim)
        self.pos = nn.Parameter(torch.empty(seq_len, dim))
        self.blocks = nn.ModuleList(EncoderBlock(dim, heads)
                                    for _ in range(n_layers))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, n_classes)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens) + self.pos
        for block in self.blocks:
            x = block(x)
        return self.head(self.norm(x).mean(dim=1))


def make_model(seq_len: int, seed: int,
               device: torch.device) -> TextClassifier:
    """The classifier drawn as flax draws it: lecun normal kernels, zero
    biases, the embedding table normal with variance 1 / dim, positions
    normal(0.02)."""
    model = TextClassifier(seq_len)
    gen = torch.Generator().manual_seed(seed)
    layers.flax_init_(model, gen)
    with torch.no_grad():
        dim = model.embed.weight.shape[1]
        model.embed.weight.normal_(0.0, dim ** -0.5, generator=gen)
        model.pos.normal_(0.0, 0.02, generator=gen)
    for block in model.blocks:
        block.attn.init_(gen)
    return model.to(device)


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)``: decay 1e-4 on every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=lr, eps=1e-8,
                             weight_decay=WEIGHT_DECAY)


def accuracy(model: nn.Module, x: np.ndarray, y: np.ndarray,
             device: torch.device) -> float:
    with torch.no_grad():
        logits = model(torch.from_numpy(x).long().to(device))
        hits = logits.argmax(dim=-1) == torch.from_numpy(y).to(device)
        return float(hits.float().mean())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default the card, which must exist")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    distributed.initialize_from_env(device=device)
    model = make_model(args.seq_len, args.seed, device)
    tokens, labels = synthetic_data.imdb_like(args.seed, 4096,
                                              seq_len=args.seq_len)
    test_x, test_y = synthetic_data.imdb_like(args.seed + 1, 512,
                                              seq_len=args.seq_len)
    opt = make_optimizer(model, args.lr)

    t0 = time.time()
    loss = None
    for x, y in synthetic_data.batches((tokens, labels), args.batch_size,
                                       args.seed, args.steps):
        logits = model(torch.from_numpy(x).long().to(device))
        loss = F.cross_entropy(logits, torch.from_numpy(y).long().to(device))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    final_loss = float(loss.detach()) if loss is not None else None

    acc = accuracy(model, test_x, test_y, device)
    metrics = {
        "recipe": "glue_imdb",
        "steps": args.steps,
        "final_loss": final_loss,
        "test_accuracy": acc,
        "wall_seconds": round(time.time() - t0, 2),
    }
    print(json.dumps(metrics), flush=True)
    if args.steps >= 150 and acc < 0.75:
        raise SystemExit(f"glue_imdb accuracy {acc:.3f} below 0.75")
    return metrics


if __name__ == "__main__":
    main()
