#!/usr/bin/env python3
"""The Hopper dq body's designs, timed in turns on one card.

    python3 tools/flash_dq_variants.py                  # head_dim 256
    python3 tools/flash_dq_variants.py --width 128 --causal --rounds 5
    git archive HEAD | tar -x -C build/parent     # the parent, gitignored
    python3 tools/flash_dq_variants.py --width 512 --parent build/parent

csrc/flash_bwd_sm90.cuh's dq_cta takes a softmax base, kRegA (how many of
a consumer's resident A operands it holds in registers for its whole
loop) and a CTA shape (DqShape: the rows of its K/V tiles and the ring's
stages). This script builds one instance per variant (nvcc into build/,
from the checkout's headers, one process per variant, all at once),
bf16.

At head_dim 256 (the default), at each family's width-256 main shape.
The designs (DqShape<kKv, kSlots, kVSlots, kUniform>):

  base      DqBase<256>: the 128-row CTA against one stage of a 64-row K
            and V tile (each load waits for both consumers to release the
            stage, so loads and products run in turn);
  w         DqWide: 32-row K/V tiles in three stages, two tiles' loads in
            flight under the products, S and dP as m64n32 with both
            operands in shared memory;
  k2v1      64-row K and V tiles on barriers of their own, two K slots
            and one V slot: S and dP as m64n64, V released after dP
            (its next load runs under dS K), K after dS K (the next K
            already resident);
  ...u      the same with the warpgroup index uniform (kUniform: lane
            0's, broadcast), so the descriptors sit in uniform registers:
            k2v1u is DqSplitKV, the kept flash_dq_tri at 256.

Groups, each timed in turns at its family's main shape:

  triangular, base 2, (1, 8192, 8, 1, 256) causal, first held against
            the plain backward at chip_smoke.py's TRI_WIDE_CHECK_SHAPES:
            tri (base: the parent's flash_dq_tri), tri_u, tri_w, tri_wu,
            tri_k2v1, tri_k2v1u;
  resident, natural exp, Gemma-2B's (8, 2048, 8, 1, 256) causal, also
            at 2 x 1000 non-causal and Gemma-7B's 16/16 heads at 200
            causal: one (base), one_u, kept (w: flash_dq), kept_u,
            res_k2v1u;
  streamed, BaseE2, (1, 4096, 8, 1, 256) non-causal: str (base:
            flash_dq_streamed), str_u, str_w, str_k2v1u.

The designs timed and removed from csrc/ (PERF.md; among them DqWide and
DqSplitKV with S's first k steps reading Q from registers) are not
here.

At head_dim 128 (--width 128), the seven instances of PR 8's choice of
kRegA, at (1, --seq, 32, 8, 128): a, b, c in BaseE with kRegA 0, 1, 2
(a: the resident flash_dq); a2, b2, c2 in BaseE2 (c2: the streamed
flash_dq_streamed); t in Base2 (the triangular flash_dq_tri's body).

For each it prints ptxas's registers, spills and "Potential Performance
Loss" notes and the SASS's HGMMA, UTMALDG and WARPGROUP.DEPBAR counts;
holds its dq against the family's plain version and itself run twice
(bit-identical); then times each group's variants in turns, forward and
reversed order each round, each timing beside nvidia-smi's SM clock and
power (chip_smoke.py's sampler), and prints each median beside the
bound.

At head_dim 512 (--width 512), the width-512 dq (dq_cta_512: a cluster
of two CTAs an item, each its 256-column chunk of Q, dO, K and V,
exchanging its partials of S and dP): the checkout's body ("base"), each
design of DESIGNS_512 (tools/designs_512.py: a copy of csrc/ with
constants set) and, with `--parent DIR`, that checkout's body as it is
("parent"), through the port's own wrappers at each family's width-512
main shape, each held against the plain backward's dq and against
itself run twice (bit-identical), then timed in turns; last a
`READINGS` JSON line. Imports nothing of JAX; needs a CUDA card, the
CUDA toolkit and this file's checkout.
"""
import argparse
import ctypes
import hashlib
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the checkout's, for its timer and checks)
import designs_512  # noqa: E402
from skypilot_tpu_torch.ops import _build  # noqa: E402
from skypilot_tpu_torch.ops import flash_attention as fa  # noqa: E402

# name: (head_dim, softmax base, kRegA, DqShape)
VARIANTS = {
    128: {"a": (128, "BaseE", 0, "DqBase<128>"),
          "b": (128, "BaseE", 1, "DqBase<128>"),
          "c": (128, "BaseE", 2, "DqBase<128>"),
          "a2": (128, "BaseE2", 0, "DqBase<128>"),
          "b2": (128, "BaseE2", 1, "DqBase<128>"),
          "c2": (128, "BaseE2", 2, "DqBase<128>"),
          "t": (128, "Base2", 0, "DqBase<128>")},
    256: {"one": (256, "BaseE", 0, "DqBase<256>"),
          "one_u": (256, "BaseE", 0, "DqShape<64, 1, 0, true>"),
          "kept": (256, "BaseE", 0, "DqWide"),
          "kept_u": (256, "BaseE", 0, "DqShape<32, 3, 0, true>"),
          "res_k2v1u": (256, "BaseE", 0, "DqSplitKV"),
          "tri": (256, "Base2", 0, "DqBase<256>"),
          "tri_u": (256, "Base2", 0, "DqShape<64, 1, 0, true>"),
          "tri_w": (256, "Base2", 0, "DqWide"),
          "tri_wu": (256, "Base2", 0, "DqShape<32, 3, 0, true>"),
          "tri_k2v1": (256, "Base2", 0, "DqShape<64, 2, 1>"),
          "tri_k2v1u": (256, "Base2", 0, "DqSplitKV"),
          "str": (256, "BaseE2", 0, "DqBase<256>"),
          "str_u": (256, "BaseE2", 0, "DqShape<64, 1, 0, true>"),
          "str_w": (256, "BaseE2", 0, "DqWide"),
          "str_k2v1u": (256, "BaseE2", 0, "DqSplitKV")},
}
# The groups timed in turns: (family whose forward and plain backward
# hold the variants, shape, variants, extra check shapes).
GROUPS = {
    256: ((fa.TRIANGULAR, chip_smoke.TRI_WIDE_MAIN_SHAPE,
           ("tri", "tri_u", "tri_w", "tri_wu", "tri_k2v1", "tri_k2v1u"),
           chip_smoke.TRI_WIDE_CHECK_SHAPES[1:]),
          (fa.RESIDENT, chip_smoke.WIDE_MAIN_SHAPE,
           ("one", "one_u", "kept", "kept_u", "res_k2v1u"),
           ((2, 1000, 8, 1, 256, False), (1, 200, 16, 16, 256, True))),
          (fa.STREAMED, chip_smoke.STR_WIDE_MAIN_SHAPE,
           ("str", "str_u", "str_w", "str_k2v1u"), ())),
}

# The width-512 dq's designs beside the checkout's (three K stages, one V
# stage; the remote arrival that frees the exchange buffers a release at
# CTA scope): "k2v2", two K stages and two V stages; "cluster_release",
# that arrival a release at cluster scope and its wait an acquire there.
# (Each consumer's A operand, Q_c or dO_c, held in registers for the
# whole loop spilled and ran 1.14-1.32x slower; it is gone from csrc/:
# PERF.md.)
_BWD = "flash_bwd_sm90.cuh"
DESIGNS_512 = {
    "k2v2": {_BWD: {"kDq512KSlots": "2", "kDq512VSlots": "2"}},
    "cluster_release": {
        "flash_fwd_sm90.cuh": [
            ("@p mbarrier.arrive.shared::cluster.b64",
             "@p mbarrier.arrive.release.cluster.shared::cluster.b64")],
        _BWD: [("      mbar_wait(x_free, j & 1);\n",
                "      mbar_wait_cluster(x_free, j & 1);\n")]},
    # Probe: no exchange between the CTAs (each sums its own partial with
    # whatever its buffer holds, never written or awaited): what the
    # exchange costs.
    "probe_noxch": {_BWD: [
        ("  mbar_expect_tx_if(x_full, L::kPart, tid == 0);\n"
         "  partial(x, 0);\n  send_part(x, x_dst, x_bar);\n",
         "  partial(x, 0);\n"),
        ("    mbar_wait_cluster(x_full, j & 1);\n#pragma unroll\n",
         "#pragma unroll\n"),
        ("    mbar_expect_tx_if(x_full, L::kPart, more && tid == 0);\n", ""),
        ("    if (more) {\n      mbar_wait(x_free, j & 1);\n"
         "      send_part(xn, x_dst, x_bar);\n    }\n", "")]},
}

_SOURCE = """#include "flash_bwd_sm90.cuh"

namespace stpu {{
namespace {{

__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
dq_variant_{name}(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const BwdParams p,
    const int* __restrict__ work) {{
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::dq_cta<{d}, Bf16, {base}, {reg_a}, sm90::{shape}>(tq, tdo, tk, tv,
                                                          p, work, smem);
}}

}}  // namespace
}}  // namespace stpu

extern "C" int stpu_dq_variant(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta,
    const void* work, const long long* strides, int B, int S, int H,
    int KVH, int D, int dtype, float scale, int causal, void* stream) {{
  using namespace stpu;
  if (D != {d} || dtype != Bf16::kDtype) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                                 nullptr, strides, S, H, KVH, scale, causal);
  return sm90::launch_dq<{d}, Bf16, sm90::{shape}>(
      dq_variant_{name}, p, B, static_cast<const int*>(work),
      static_cast<cudaStream_t>(stream));
}}
"""


def build(variants):
    """{name: (library, ptxas log, SASS text)}, each built under build/ by
    content, all nvcc processes at once."""
    root = _build.BUILD_ROOT / "dq_variants"
    procs = {}
    for name, (d, base, reg_a, shape) in variants.items():
        text = _SOURCE.format(name=name, d=d, base=base, reg_a=reg_a,
                              shape=shape)
        out = root / hashlib.sha256(
            (text + _build.build_dir().name).encode()).hexdigest()[:16]
        out.mkdir(parents=True, exist_ok=True)
        cu, lib = out / f"dq_{name}.cu", out / f"libdq_{name}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        dll = ctypes.CDLL(str(lib))
        dll.stpu_dq_variant.argtypes = _build.SIGNATURES["flash_streamed"][
            "stpu_flash_dq_streamed"]
        dll.stpu_dq_variant.restype = ctypes.c_int
        built[name] = (dll, log, sass)
    return built


def report(variants, built):
    """Per variant: ptxas's registers, spills and notes; SASS counts.
    Fails if a variant has no wgmma or TMA, or as many wgmma waits as
    wgmmas (ptxas serialised them). Returns {name: "N registers, spills
    S/L bytes, counts"} for the summary."""
    facts = {}
    for name, (dll, log, sass) in built.items():
        lines = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln or "Performance Loss" in ln]
        counts = {k: sass.count(k) for k in
                  ("HGMMA", "UTMALDG", "WARPGROUP.DEPBAR")}
        print(f"[build] variant {name} {variants[name]}: {counts}; "
              + " | ".join(lines), flush=True)
        chip_smoke.check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
                         and counts["WARPGROUP.DEPBAR"] < counts["HGMMA"],
                         f"variant {name}: no wgmma, no TMA, or serialised")
        regs = chip_smoke._ptxas_summary(log)
        facts[name] = (regs[0].split(": ", 1)[-1] if regs else "?") + (
            f", HGMMA {counts['HGMMA']}, UTMALDG {counts['UTMALDG']}, "
            f"waits {counts['WARPGROUP.DEPBAR']}")
    return facts


def _lse_for(base, fam, lse):
    """The lse a variant of `base` reads (base 2 for Base2, else natural
    log), from family `fam`'s forward (base 2 for the triangular one)."""
    want2, have2 = base == "Base2", fam == fa.TRIANGULAR
    if want2 == have2:
        return lse
    return lse * chip_smoke.LN2 if have2 else lse * fa.LOG2E


def _runner(variants, built, name, inputs, lse_fam):
    d, base, _, _ = variants[name]
    q, k, v, o, do, lse = inputs
    b, s, h, _ = q.shape
    kvh = k.shape[2]
    causal = lse_fam[1]
    stat = _lse_for(base, lse_fam[0], lse)
    work = fa.bwd_schedule("rows", b * h, s, q.device)
    strides = fa._strides(q, k, v, o, do)

    def run():
        dq = torch.empty_like(q)
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        err = built[name][0].stpu_dq_variant(
            *(t.data_ptr() for t in (q, k, v, o, do, stat, dq, delta, work)),
            strides, b, s, h, kvh, d, fa._DTYPE_CODES[q.dtype], d ** -0.5,
            int(causal), fa._stream(q))
        if err:
            raise RuntimeError(f"variant {name}: CUDA error {err}")
        return dq

    return run


def _check(variants, built, names, fam, shape, seed):
    """Each variant's dq against the family's plain dq at `shape`, and
    bit-identical twice; returns the inputs and runners."""
    b, s, h, kvh, d, causal = shape
    fns = chip_smoke.Family(fa, fam, causal, d ** -0.5)
    q, k, v, do = chip_smoke._inputs(shape, seed)
    o, lse = fns.fwd(q, k, v)
    dq_p, _, _ = fns.bwd_plain(q, k, v, o, lse, do)
    runs = {}
    for n in names:
        runs[n] = _runner(variants, built, n, (q, k, v, o, do, lse),
                          (fam, causal))
        dq = runs[n]()
        torch.cuda.synchronize()
        rel, max_abs, peak = chip_smoke._err(dq, dq_p)
        same = torch.equal(dq, runs[n]())
        print(f"[check] variant {n} at {shape}: dq rel {rel:.3e} (tol "
              f"{chip_smoke.GRAD_REL_TOL}) max_abs {max_abs:.3e} (cap "
              f"{chip_smoke.MAX_ABS_SHARE * peak:.3e}); bit-identical twice "
              f"{same}", flush=True)
        chip_smoke.check(rel <= chip_smoke.GRAD_REL_TOL
                         and max_abs <= chip_smoke.MAX_ABS_SHARE * peak
                         and same, f"variant {n} disagrees at {shape}")
    return runs


def _time(names, runs, shape, args, facts):
    b, s, h, kvh, d, causal = shape
    flops = 6 * d * b * h * (s * (s + 1) // 2 if causal else s * s)
    bound_ms, _ = chip_smoke._bound(flops, 0)
    times = {n: [] for n in names}
    clocks = {n: [] for n in names}
    for r in range(args.rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            t = chip_smoke.time_ms(runs[n], args.reps)
            clk = chip_smoke.CLOCKS.last()
            times[n].append(t)
            if clk is not None:
                clocks[n].append(clk["sm_mhz"])
            print(f"[time] {shape} round {r} variant {n}: {t:.4f} ms; "
                  f"{chip_smoke.clock_note(clk)}", flush=True)
    out = []
    for n, ts in times.items():
        med = statistics.median(ts)
        mhz = (f"SM {statistics.median(clocks[n]):.0f} MHz"
               if clocks[n] else "SM clock not sampled")
        out.append(f"[summary] variant {n} at {shape}: median {med:.4f} ms "
                   f"over {len(ts)} timings ({min(ts):.4f}-{max(ts):.4f}; "
                   f"{mhz}), {flops / med / 1e9:.1f} TFLOP/s, "
                   f"{bound_ms / med:.1%} of the {bound_ms:.4f} ms bound; "
                   f"{facts[n]}")
    return out


def width_512(args):
    """--width 512: the checkout's body, DESIGNS_512 and the parent's,
    checked, then timed in turns at each family's main shape."""
    _build.build_all()
    root = _build.BUILD_ROOT / "dq_variants_512"
    dirs = designs_512.design_dirs(DESIGNS_512, root, args.parent)
    libs = designs_512.build(
        dirs, root, sorted(set(designs_512.SOURCES.values())), "dq")
    readings = []
    chip_smoke.CLOCKS.start()
    try:
        for fam, shape in designs_512.SHAPES:
            b, s, h, kvh, d, causal = shape
            fns = chip_smoke.Family(fa, fam, causal, d ** -0.5)
            q, k, v, do = chip_smoke._inputs(shape, 0)
            o, lse = fns.fwd(q, k, v)
            dq_p, _, _ = fns.bwd_plain(q, k, v, o, lse, do)
            runs = designs_512.runs_for(libs, designs_512.SOURCES[fam])
            for name, swap in runs.items():
                if designs_512.is_probe(name):
                    continue
                with swap:
                    got, again = (fns.dq(q, k, v, o, lse, do),
                                  fns.dq(q, k, v, o, lse, do))
                    torch.cuda.synchronize()
                chip_smoke._hold(f"[design] {name} {fam} dq vs plain",
                                 shape, (("dq", (got[0], dq_p),
                                          chip_smoke.GRAD_REL_TOL),))
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                print(f"[design] {name} {fam} {shape}: dq and delta "
                      f"bit-identical twice {same}", flush=True)
                chip_smoke.check(same, f"{name} is not deterministic")
            del dq_p, got, again
            torch.cuda.empty_cache()
            pairs = s * (s + 1) // 2 if causal else s * s
            bound_ms, _ = chip_smoke._bound(6 * d * b * h * pairs, 0)
            rec = designs_512.turns(f"{fam} {shape} dq", runs,
                                    lambda: fns.dq(q, k, v, o, lse, do),
                                    args.rounds, args.reps, bound_ms)
            readings.append({"family": fam, "shape": list(shape), **rec})
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    finally:
        chip_smoke.CLOCKS.stop()
    print("READINGS " + json.dumps(readings), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, choices=(128, 256, 512),
                    default=256)
    ap.add_argument("--parent", type=pathlib.Path,
                    help="--width 512: a checkout whose body is timed too")
    ap.add_argument("--seq", type=int, default=8192, help="width 128 only")
    ap.add_argument("--batch", type=int, default=1, help="width 128 only")
    ap.add_argument("--causal", action="store_true", help="width 128 only")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="comma-separated variants (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.phase_device()
    if args.width == 512:
        return width_512(args)
    variants = VARIANTS[args.width]
    if args.only:
        variants = {n: variants[n] for n in args.only.split(",")}
    built = build(variants)
    facts = report(variants, built)
    if args.width == 128:
        groups = ((fa.STREAMED, (args.batch, args.seq, 32, 8, 128,
                                 args.causal), tuple(variants), ()),)
    else:
        groups = GROUPS[256]
    summary = []
    chip_smoke.CLOCKS.start()
    try:
        for seed, (fam, shape, names, extra) in enumerate(groups):
            names = tuple(n for n in names if n in facts)
            if not names:
                continue
            for shape_x in extra:
                _check(variants, built, names,
                       fa.family(shape_x[1], shape_x[4], shape_x[5]),
                       shape_x, 60 + seed)
                torch.cuda.empty_cache()
            runs = _check(variants, built, names, fam, shape, 50 + seed)
            summary += _time(list(names), runs, shape, args, facts)
            del runs
            torch.cuda.empty_cache()
    finally:
        chip_smoke.CLOCKS.stop()
    for line in summary:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
