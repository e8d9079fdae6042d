#!/usr/bin/env python3
"""The width-256 dk/dv of every family at every part count P, timed in
turns on one card.

    python3 tools/flash_dkv_variants.py
    python3 tools/flash_dkv_variants.py --rounds 3 --reps 20

csrc/flash_bwd_sm90.cuh's dkv_cta_wide splits each KV head's group of G
query heads in P parts across CTAs and sums the parts' fp32 partials in
part order; ops/flash_attention.py's dkv_parts picks P from the shape and
the card's SM count by a cost model (dkv_parts_cost: the work list's
makespan in tile steps, and the partials' traffic). At each shape of
SHAPES this script launches the port's own kernel (flash_dkv_tri or
flash_dkv_streamed, through the port's launch and buffers) at every P
dividing G up to MAX_PARTS, holds each against the plain backward (P = 1,
at S <= 8192) or against P = 1 (within GRAD_REL_TOL) and against itself
run twice (bit-identical), then times the Ps in turns (ascending, then
descending, each round), each timing beside nvidia-smi's SM clock and
power. Per shape it prints each P's median time beside the model's
makespan and traffic, the P the model picks and the fastest P (the
resident flash_dkv, on the same CTA since it left its two-sweep body, at
its main shape, Gemma-2B's 8 x 2048 causal, beside the triangular
instance there); then a
`READINGS` JSON line of every (family, shape, P, median ms, makespan,
traffic bytes) and the model's scale fitted to them (`fit`: median ms
= a x makespan + c x bytes by least squares; WIDE_STEP_BYTES is a / c),
with the shapes where the fitted model's pick is not the fastest P.
`--fit LOG` prints that fit from a saved run's READINGS line, with no
card. Imports nothing of JAX; needs a CUDA card, the CUDA toolkit and
this file's checkout.
"""
import argparse
import json
import pathlib
import statistics
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the checkout's, for its timer and checks)
from skypilot_tpu_torch.ops import flash_attention as fa  # noqa: E402

# (family, (B, S, H, KVH, D, causal)): the resident main shape, the two
# other main shapes, the op's causal [wide op] shape, shapes the rule
# sends to P = 1 (a batch of 8, S = 16384, non-causal 8192), a short
# causal S and a group of 4.
SHAPES = (
    (fa.RESIDENT, chip_smoke.WIDE_MAIN_SHAPE),
    (fa.TRIANGULAR, chip_smoke.TRI_WIDE_MAIN_SHAPE),
    (fa.TRIANGULAR, chip_smoke.WIDE_OP_SHAPE),
    (fa.TRIANGULAR, (8, 2048, 8, 1, 256, True)),
    (fa.TRIANGULAR, (2, 4096, 8, 1, 256, True)),
    (fa.TRIANGULAR, (1, 2048, 8, 1, 256, True)),
    (fa.TRIANGULAR, (1, 16384, 8, 1, 256, True)),
    (fa.TRIANGULAR, (1, 4096, 8, 2, 256, True)),
    (fa.STREAMED, chip_smoke.STR_WIDE_MAIN_SHAPE),
    (fa.STREAMED, (1, 4096, 8, 1, 256, True)),
    (fa.STREAMED, (1, 8192, 8, 1, 256, False)),
    (fa.STREAMED, (8, 2048, 8, 1, 256, False)),
)
_SOURCES = {fa.RESIDENT: "flash_bwd", fa.TRIANGULAR: "flash_tri",
            fa.STREAMED: "flash_streamed"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--fit", type=pathlib.Path,
                    help="a saved run's output: fit its READINGS, no card")
    args = ap.parse_args()
    if args.fit:
        line = next(ln for ln in args.fit.read_text().splitlines()
                    if ln.startswith("READINGS "))
        fit(json.loads(line.split(" ", 1)[1]))
        return 0
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.phase_device()
    sms = fa._sm_count(torch.device("cuda"))
    summary, readings = [], []
    chip_smoke.CLOCKS.start()
    try:
        for fam, shape in SHAPES:
            summary += _one_shape(fam, shape, sms, args, readings)
    finally:
        chip_smoke.CLOCKS.stop()
    for line in summary:
        print(line, flush=True)
    print("READINGS " + json.dumps(readings), flush=True)
    fit(readings)
    return 0


def fit(readings):
    """Least squares of the median times on (makespan, partials' bytes):
    the time of a tile step, the partials' rate, their ratio (the bytes
    a step's time moves: WIDE_STEP_BYTES), and at that ratio each shape
    whose least-cost P is not its fastest."""
    x = np.array([[mk, nb] for *_, mk, nb in readings], dtype=np.float64)
    y = np.array([r[3] for r in readings], dtype=np.float64)
    (a, c), *_ = np.linalg.lstsq(x, y, rcond=None)
    step_bytes = a / c
    print(f"[fit] {len(readings)} timings: {a * 1e3:.3f} us a tile step, "
          f"partials at {1e-9 / c:.3f} TB/s, {step_bytes:.4g} bytes a step "
          f"(WIDE_STEP_BYTES {fa.WIDE_STEP_BYTES:.4g}); residual rms "
          f"{np.sqrt(np.mean((x @ (a, c) - y) ** 2)) * 1e3:.1f} us",
          flush=True)
    by_shape = {}
    for fam, shape, parts, ms, mk, nb in readings:
        by_shape.setdefault((fam, tuple(shape)), {})[parts] = (
            ms, mk + nb / step_bytes)
    for (fam, shape), got in by_shape.items():
        pick = min(got, key=lambda p: (got[p][1], p))
        best = min(got, key=lambda p: got[p][0])
        if pick != best:
            lost = got[pick][0] / got[best][0] - 1
            print(f"[fit] {fam} {shape}: the fitted model picks P={pick} "
                  f"({got[pick][0]:.4f} ms), fastest P={best} "
                  f"({got[best][0]:.4f} ms; the pick {lost:.1%} slower)",
                  flush=True)


def _one_shape(fam, shape, sms, args, readings):
    b, s, h, kvh, d, causal = shape
    scale = d ** -0.5
    groups = h // kvh
    fns = chip_smoke.Family(fa, fam, causal, scale)
    q, k, v, do = chip_smoke._inputs(shape, 0)
    o, lse, _, delta, _, _ = fns.run(q, k, v, do)
    name, source = fns.names[2], _SOURCES[fam]
    flags = () if fam == fa.TRIANGULAR else (int(causal),)
    strides = fa._strides(q, k, v, do)

    def run(parts):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        work, ws, tickets = fa.dkv_wide_buffers(q, kvh, parts)
        fa._launch(name, source, [q, k, v, do, lse, delta, dk, dv, work, ws,
                                  tickets], strides, q, kvh,
                   fa._DTYPE_CODES[q.dtype], scale, *flags, parts)
        return dk, dv

    parts_all = [p for p in range(1, min(groups, fa.MAX_PARTS) + 1)
                 if groups % p == 0]
    ref = run(1)
    if s <= 8192:
        _, dk_p, dv_p = fns.bwd_plain(q, k, v, o, lse, do)
        chip_smoke._hold(f"[check] {fam} P=1 vs plain", shape, (
            ("dk", (ref[0], dk_p), chip_smoke.GRAD_REL_TOL),
            ("dv", (ref[1], dv_p), chip_smoke.GRAD_REL_TOL)))
        del dk_p, dv_p
    for parts in parts_all:
        got = run(parts)
        if parts > 1:
            chip_smoke._hold(f"[check] {fam} P={parts} vs P=1", shape, (
                ("dk", (got[0], ref[0]), chip_smoke.GRAD_REL_TOL),
                ("dv", (got[1], ref[1]), chip_smoke.GRAD_REL_TOL)))
        same = all(torch.equal(x, y) for x, y in zip(run(parts), got))
        print(f"[check] {fam} {shape} P={parts}: bit-identical twice {same}",
              flush=True)
        chip_smoke.check(same, f"P={parts} is not deterministic at {shape}")
    del ref, got
    torch.cuda.empty_cache()

    times = {p: [] for p in parts_all}
    for r in range(args.rounds):
        for parts in parts_all + parts_all[::-1]:
            t = chip_smoke.time_ms(lambda: run(parts), args.reps)
            times[parts].append(t)
            print(f"[time] {fam} {shape} round {r} P={parts}: {t:.4f} ms; "
                  f"{chip_smoke.clock_note(chip_smoke.CLOCKS.last())}",
                  flush=True)
    pick = fa.dkv_parts(b, s, kvh, groups, causal, sms)
    med = {p: statistics.median(ts) for p, ts in times.items()}
    out = []
    for parts, ts in times.items():
        makespan, traffic = fa.dkv_parts_cost(b, s, kvh, groups, causal, sms,
                                              parts)
        nbytes = traffic * fa.WIDE_STEP_BYTES
        readings.append([fam, list(shape), parts, med[parts], makespan,
                         nbytes])
        out.append(f"[summary] {fam} {shape} P={parts}: median "
                   f"{med[parts]:.4f} ms over {len(ts)} timings "
                   f"({min(ts):.4f}-{max(ts):.4f}); model makespan "
                   f"{makespan} steps, partials {nbytes / 1e6:.1f} MB")
    best = min(med, key=med.get)
    out.append(f"[summary] {fam} {shape}: dkv_parts picks P={pick} "
               f"({med[pick]:.4f} ms), fastest P={best} ({med[best]:.4f} "
               f"ms), {sms} SMs")
    return out


if __name__ == "__main__":
    sys.exit(main())
