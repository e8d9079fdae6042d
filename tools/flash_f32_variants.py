#!/usr/bin/env python3
"""The fp32 kernels' tilings and the dk/dv's GQA parts, timed in turns on
one card.

    python3 tools/flash_f32_variants.py
    python3 tools/flash_f32_variants.py --rounds 3 --reps 5

csrc/flash_f32.cu's flash_fwd_f32, flash_dq_f32 and flash_dkv_f32 take
their tiles from FwdTiles<D>, DqTiles<D> and DkvTiles<D> (resident rows,
rows of a streamed tile, columns of a slab, ring stages, a thread's
blocks). Each entry of VARIANTS rewrites one of those structs in a copy
of csrc/ under
build/f32_variants/NAME, which is built with the port's nvcc flags (every
variant at once) and run through the port's own wrappers, its library
and tile table swapped in. At each shape of chip_smoke.F32_TIMED_SHAPES
of the variant's width it is held against the plain forward or backward
(the JAX reference tests' fp32 bounds) and timed in turns with the
checkout's
tiles (base, variant, variant, base, each round), beside nvidia-smi's SM
clock. Then, at each timed shape with a GQA group, the checkout's dk/dv
at every P dividing the group, in turns, beside the P dkv_parts picks.
Prints each variant's ptxas registers and spills, one line a timing, and
a last `READINGS` JSON line. Imports nothing of JAX; needs a CUDA card,
the CUDA toolkit and this file's checkout.
"""
import argparse
import contextlib
import functools
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the checkout's, for its timer and inputs)
from skypilot_tpu_torch.ops import _build  # noqa: E402
from skypilot_tpu_torch.ops import flash_attention as fa  # noqa: E402

# (name, struct, head_dim, fields): the fields of FwdTiles<D>, DqTiles<D>
# or DkvTiles<D> that the variant sets (each timed at the
# F32_TIMED_SHAPES of its width). The forward's: 64 q rows a CTA (4x4 S
# and 4x8 output blocks) at 128, and in 128-column slabs at 256; 64 rows
# against 64-key tiles at 512.
VARIANTS = (
    ("fwd128_rows64", "FwdTiles", 128, {"kRows": 64, "kSM": 4, "kOM": 4}),
    ("fwd256_rows64", "FwdTiles", 256, {"kRows": 64, "kSlab": 128,
                                        "kSM": 4, "kOM": 4, "kON": 8}),
    ("fwd512_rows64", "FwdTiles", 512, {"kRows": 64, "kInner": 64,
                                        "kSM": 4, "kOM": 4}),
    ("dq128_4stages", "DqTiles", 128, {"kStages": 4}),
    ("dkv128_2stages", "DkvTiles", 128, {"kStages": 2}),
    ("dq256_slab64", "DqTiles", 256, {"kSlab": 64, "kStages": 4,
                                      "kON": 4}),
    ("dkv256_rows32", "DkvTiles", 256, {"kRows": 32, "kInner": 128,
                                        "kOM": 2}),
    ("dq512_inner64", "DqTiles", 512, {"kInner": 64, "kSlab": 128,
                                       "kSM": 2, "kOM": 4}),
    ("dkv512_3stages", "DkvTiles", 512, {"kStages": 3}),
)
GRAD_TOL = chip_smoke.F32_GRAD_TOL


def _variant_source(text, struct, d, fields):
    head = f"template <> struct {struct}<{d}> {{"
    start = text.index(head)
    end = text.index("};", start)
    body = text[start:end]
    for name, value in fields.items():
        body, n = re.subn(rf"\b{name} = \d+", f"{name} = {value}", body)
        assert n == 1, (struct, d, name)
    return text[:start] + body + text[end:]


def build_variants():
    """{name: (loaded library, ptxas summary)}, every variant built at
    once."""
    root = REPO / "build" / "f32_variants"
    procs = {}
    for name, struct, d, fields in VARIANTS:
        out = root / name
        if out.exists():
            shutil.rmtree(out)
        shutil.copytree(_build.CSRC, out)
        src = out / "flash_f32.cu"
        src.write_text(_variant_source(src.read_text(), struct, d, fields))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out), "-o",
               str(out / "libflash_f32.so"), str(src)]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = _build.load_library(out / "libflash_f32.so", "flash_f32")
        libs[name] = (lib, chip_smoke._ptxas_summary(log))
    return libs


class Swap:
    """The port's wrappers on a variant's library and tiles, within the
    block (its own cache of dkv_parts, which reads the tile table; the
    work lists' cache is keyed by their tiles)."""

    def __init__(self, lib, struct, d, fields):
        self.lib, self.d = lib, d
        self.table = {"FwdTiles": fa.F32_FWD_TILES,
                      "DqTiles": fa.F32_DQ_TILES,
                      "DkvTiles": fa.F32_DKV_TILES}[struct]
        rows, inner = self.table[d]
        self.tiles = (fields.get("kRows", rows), fields.get("kInner", inner))
        self.parts = functools.lru_cache(maxsize=None)(
            fa.dkv_parts.__wrapped__)

    def __enter__(self):
        self.saved = (_build._LIBS.get("flash_f32"), self.table[self.d],
                      fa.dkv_parts)
        _build._LIBS["flash_f32"] = self.lib
        self.table[self.d] = self.tiles
        fa.dkv_parts = self.parts

    def __exit__(self, *exc):
        (_build._LIBS["flash_f32"], self.table[self.d],
         fa.dkv_parts) = self.saved


class Parts:
    """dkv_parts pinned to ``parts`` within the block."""

    def __init__(self, parts):
        self.parts = parts

    def __enter__(self):
        self.saved = fa.dkv_parts
        fa.dkv_parts = lambda *args: self.parts

    def __exit__(self, *exc):
        fa.dkv_parts = self.saved


def _kernel(kind, q, k, v, o, lse, do, delta, causal, scale):
    if kind == "FwdTiles":
        return fa.flash_fwd_f32(q, k, v, causal, scale)
    if kind == "DqTiles":
        return fa.flash_dq_f32(q, k, v, o, lse, do, causal, scale)
    return fa.flash_dkv_f32(q, k, v, do, lse, delta, causal, scale)


def _in_turns(fns, rounds, reps):
    """{label: [ms, ...]} of fns timed A, B, ..., then reversed, each
    round."""
    out = {label: [] for label in fns}
    for r in range(rounds):
        order = list(fns) if r % 2 == 0 else list(reversed(fns))
        for label in order + order[::-1]:
            out[label].append(chip_smoke.time_ms(fns[label], reps,
                                                 warmup=1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    _build.library("flash_f32")
    libs = build_variants()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    for name, (_, ptxas) in libs.items():
        print(f"[ptxas] {name}: " + "; ".join(
            line for line in ptxas if "_f32_kernel" in line), flush=True)
    readings = []
    chip_smoke.CLOCKS.start()
    try:
        for shape in chip_smoke.F32_TIMED_SHAPES:
            b, s, h, kvh, d, causal = shape
            scale = d ** -0.5
            q, k, v, do = chip_smoke._inputs(shape, 22, torch.float32)
            o, lse = fa.flash_fwd_f32(q, k, v, causal, scale)
            _, delta = fa.flash_dq_f32(q, k, v, o, lse, do, causal, scale)
            ref = fa.flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
            ref_o = fa.flash_fwd_plain(q, k, v, causal, scale)
            for name, struct, vd, fields in VARIANTS:
                if vd != d:
                    continue
                swap = Swap(libs[name][0], struct, d, fields)
                with swap:
                    got = _kernel(struct, q, k, v, o, lse, do, delta,
                                  causal, scale)
                    torch.cuda.synchronize()
                want, tol = {"FwdTiles": (ref_o, chip_smoke.F32_OUT_TOL),
                             "DqTiles": (ref[:1], GRAD_TOL),
                             "DkvTiles": (ref[1:], GRAD_TOL)}[struct]
                got = got[:1] if struct == "DqTiles" else got
                excess = max(((g - w).abs() - tol * w.abs()).max().item()
                             for g, w in zip(got, want))
                if excess > tol:
                    print(f"[variant] {name} at {shape}: outside the fp32 "
                          f"bound ({excess:.3e})", flush=True)
                    continue

                def run(ctx, struct=struct):
                    with ctx:
                        _kernel(struct, q, k, v, o, lse, do, delta, causal,
                                scale)

                base = contextlib.nullcontext()
                times = _in_turns({"base": lambda: run(base),
                                   name: lambda swap=swap: run(swap)},
                                  args.rounds, args.reps)
                med = {label: statistics.median(ts)
                       for label, ts in times.items()}
                clk = chip_smoke.CLOCKS.last()
                print(f"[variant] {name} at {shape}: {med[name]:.4f} ms "
                      f"against base {med['base']:.4f} ms "
                      f"({med[name] / med['base']:.3f}x; turns "
                      f"{times}); {chip_smoke.clock_note(clk)}",
                      flush=True)
                readings.append({"variant": name, "shape": shape,
                                 "ms": med[name], "base_ms": med["base"]})
            groups = h // kvh
            if groups > 1:
                pick = fa.dkv_parts(b, s, kvh, groups, causal,
                                    fa._sm_count(q.device), d, True)
                fns = {}
                for p in range(1, min(groups, fa.MAX_PARTS) + 1):
                    if groups % p == 0:
                        fns[f"P={p}"] = (lambda p=p: run_parts(p))

                def run_parts(p):
                    with Parts(p):
                        fa.flash_dkv_f32(q, k, v, do, lse, delta, causal,
                                         scale)

                times = _in_turns(fns, args.rounds, args.reps)
                med = {label: statistics.median(ts)
                       for label, ts in times.items()}
                costs = {p: fa.dkv_parts_cost(
                    b, s, kvh, groups, causal, fa._sm_count(q.device),
                    int(p[2:]), d, True) for p in med}
                print(f"[parts] fp32 dk/dv at {shape}: " + ", ".join(
                    f"{p} {ms:.4f} ms (model {costs[p][0]:.0f} steps + "
                    f"{costs[p][1]:.1f})" for p, ms in med.items())
                    + f"; dkv_parts picks P={pick}, fastest "
                    f"{min(med, key=med.get)}", flush=True)
                readings.append({"parts": shape, "ms": med, "pick": pick})
            del q, k, v, do, o, lse, delta, ref, ref_o
    finally:
        chip_smoke.CLOCKS.stop()
    print("READINGS " + json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
