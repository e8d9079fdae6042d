#!/usr/bin/env python3
"""How far attention gradients move when f32 inputs pass through 16-bit
kernels: a CPU error model, no card needed.

    python3 tools/flash_f16_error_model.py [--seeds 20] [--causal]

Computes attention (q (2, 256, 4, 64), k and v (2, 256, 2, 64), standard
normal, the JAX reference test's _make_qkv shape), its output and the
gradients of sum(o ** 2) in f64 as the reference, then again with f16
rounding applied at the places a 16-bit flash kernel rounds (in order,
cumulatively): the inputs q, k, v ("in"), P before P V in the forward
("pfwd"), the output o ("o"), dS before its products ("ds"), P before
P^T dO ("pbwd"), and the written o, dq, dk, dv ("out"); and with the
inputs alone rounded ("in only"). For each it prints the largest excess
max(|x - ref| - tol * |ref|) over the seeds and how many seeds break the
JAX reference tests' bounds, |x - ref| <= tol * (1 + |ref|) with tol 2e-3
for o and 5e-3 for the gradients. This is why f32 inputs take the port's
fp32 kernels (csrc/flash_f32.cu) and not the f16 ones.
"""
import argparse

import numpy as np
import torch

TOLS = (2e-3, 5e-3, 5e-3, 5e-3)        # o, dq, dk, dv
STEPS = ("in", "pfwd", "o", "ds", "pbwd", "out")


def _r16(x, on):
    return x.half().double() if on else x


def attention_grads(q, k, v, causal, rounded):
    """(o, dq, dk, dv) in f64, f16 rounding at the steps in `rounded`."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    scale = d ** -0.5
    kk, vv = (t.repeat_interleave(g, dim=2) for t in (k, v))
    q, kk, vv = (_r16(t, "in" in rounded) for t in (q, kk, vv))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                            -1e30)
    p = torch.exp(sc - torch.logsumexp(sc, -1, keepdim=True))
    o = _r16(torch.einsum("bhqk,bkhd->bqhd", _r16(p, "pfwd" in rounded),
                          vv), "o" in rounded)
    do = 2 * o
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vv)
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]
    ds = _r16(p * (dp - delta), "ds" in rounded)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kk) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", _r16(p, "pbwd" in rounded), do)
    dk, dv = (t.reshape(b, s, -1, g, d).sum(3) for t in (dk, dv))
    return [_r16(t, "out" in rounded) for t in (o, dq, dk, dv)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--causal", action=argparse.BooleanOptionalAction,
                    default=True)
    args = ap.parse_args()
    variants = [("+".join(STEPS[:i + 1]), set(STEPS[:i + 1]))
                for i in range(len(STEPS))] + [("in only", {"in"})]
    excess = {name: [] for name, _ in variants}
    for seed in range(args.seeds):
        gen = torch.Generator().manual_seed(seed)
        q = torch.randn(2, 256, 4, 64, generator=gen, dtype=torch.float64)
        k, v = (torch.randn(2, 256, 2, 64, generator=gen,
                            dtype=torch.float64) for _ in range(2))
        q, k, v = (t.float().double() for t in (q, k, v))  # f32 inputs
        ref = attention_grads(q, k, v, args.causal, set())
        for name, rounded in variants:
            got = attention_grads(q, k, v, args.causal, rounded)
            excess[name].append([((a - r).abs() - tol * r.abs()).max().item()
                                 for a, r, tol in zip(got, ref, TOLS)])
    print(f"causal={args.causal}, {args.seeds} seeds; largest "
          "max(|x - ref| - tol |ref|) for o, dq, dk, dv (bounds 2e-3, 5e-3)"
          "; seeds out of bounds")
    for name, rows in excess.items():
        a = np.array(rows)
        fails = int((a > np.array(TOLS)).any(axis=1).sum())
        print(f"{name:28s} " + " ".join(f"{x:.2e}" for x in a.max(axis=0))
              + f"  {fails}/{args.seeds}")


if __name__ == "__main__":
    main()
