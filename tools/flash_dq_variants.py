#!/usr/bin/env python3
"""The Hopper dq body's schedules of S = Q K^T and dP = dO V^T, timed in
turns on one card.

    python3 tools/flash_dq_variants.py                 # (1, 8192, 32, 8, 128)
    python3 tools/flash_dq_variants.py --causal --rounds 5

csrc/flash_bwd_sm90.cuh's dq_cta takes kRegA, how many of a consumer's
resident A operands it holds in registers for its whole loop, and a
softmax base. This script builds seven instances of it (nvcc into
build/, from the checkout's headers), bf16 at head_dim 128:

  a, b, c     BaseE (natural exp, __expf) with kRegA 0, 1, 2: both
              operands of S and dP read from shared memory (a: the
              resident flash_dq), Q held as wgmma A fragments (b), Q and
              dO held (c);
  a2, b2, c2  BaseE2 (the natural-log lse scaled into base 2 once per
              row, then ex2.approx.ftz) with kRegA 0, 1, 2 (c2: the
              streamed flash_dq_streamed);
  t           Base2 with kRegA 0 on lse * log2(e): the triangular
              flash_dq_tri's body, which a2 should match.

For each it prints ptxas's registers, spills and "Potential Performance
Loss" notes and the SASS's HGMMA, UTMALDG and WARPGROUP.DEPBAR counts;
holds its dq against the plain version (chip_smoke.py's tolerances) and
itself run twice (bit-identical); then times the four in turns, forward
and reversed order each round, each timing beside nvidia-smi's SM clock
and power (chip_smoke.py's sampler). Imports nothing of JAX; needs a CUDA
card, the CUDA toolkit and this file's checkout.
"""
import argparse
import ctypes
import hashlib
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the checkout's, for its timer and checks)
from skypilot_tpu_torch.ops import _build  # noqa: E402
from skypilot_tpu_torch.ops import flash_attention as fa  # noqa: E402

# name: (softmax base, kRegA)
VARIANTS = {"a": ("BaseE", 0), "b": ("BaseE", 1), "c": ("BaseE", 2),
            "a2": ("BaseE2", 0), "b2": ("BaseE2", 1), "c2": ("BaseE2", 2),
            "t": ("Base2", 0)}

_KERNEL = """
template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
dq_variant_{name}(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const BwdParams p,
    const int* __restrict__ work) {{
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::dq_cta<D, T, {base}, {reg_a}>(tq, tdo, tk, tv, p, work, smem);
}}
"""
_ENTRY = """
extern "C" int stpu_dq_variant_{name}(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta,
    const void* work, const long long* strides, int B, int S, int H,
    int KVH, int D, int dtype, float scale, int causal, void* stream) {{
  using namespace stpu;
  if (D != 128 || dtype != Bf16::kDtype) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                                 nullptr, strides, S, H, KVH, scale, causal);
  return sm90::launch_dq<128, Bf16>(dq_variant_{name}<128, Bf16>, p, B,
                                    static_cast<const int*>(work),
                                    static_cast<cudaStream_t>(stream));
}}
"""


def source() -> str:
    kernels = "".join(_KERNEL.format(name=n, base=b, reg_a=r)
                      for n, (b, r) in VARIANTS.items())
    entries = "".join(_ENTRY.format(name=n) for n in VARIANTS)
    return ('#include "flash_bwd_sm90.cuh"\n\nnamespace stpu {\nnamespace {\n'
            + kernels + "\n}  // namespace\n}  // namespace stpu\n" + entries)


def build():
    """(library, ptxas log, SASS text), built under build/ by content."""
    text = source()
    out = (_build.BUILD_ROOT / "dq_variants" /
           hashlib.sha256((text + _build.build_dir().name).encode())
           .hexdigest()[:16])
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "dq_variants.cu", out / "libdq_variants.so"
    cu.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    dll = ctypes.CDLL(str(lib))
    for n in VARIANTS:
        fn = getattr(dll, f"stpu_dq_variant_{n}")
        fn.argtypes = _build.SIGNATURES["flash_streamed"][
            "stpu_flash_dq_streamed"]
        fn.restype = ctypes.c_int
    return dll, proc.stdout + proc.stderr, sass


def report(log, sass):
    """Per variant: ptxas's lines, SASS counts."""
    for n in VARIANTS:
        name = re.compile(rf"dq_variant_{n}ILi128ENS_\d+Bf16E")
        lines, mine = [], False
        for line in log.splitlines():
            if "Compiling entry function" in line:
                mine = bool(name.search(line))
            if (mine and ("Used" in line or "spill" in line)) or (
                    "Performance Loss" in line and name.search(line)):
                lines.append(line.split(":", 1)[-1].strip())
        counts = {}
        for part in sass.split("Function : ")[1:]:
            if name.search(part.split(None, 1)[0]):
                counts = {k: part.count(k) for k in
                          ("HGMMA", "UTMALDG", "WARPGROUP.DEPBAR")}
        print(f"[build] variant {n} {VARIANTS[n]}: {counts}; "
              + " | ".join(lines), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    shape = (args.batch, args.seq, 32, 8, 128, args.causal)
    b, s, h, kvh, d, causal = shape
    scale = d ** -0.5
    chip_smoke.phase_device()
    dll, log, sass = build()
    report(log, sass)

    q, k, v, do = chip_smoke._inputs(shape, 0)
    o, lse = fa.flash_fwd_streamed(q, k, v, causal, scale)
    lse2 = lse * fa.LOG2E
    work = fa.bwd_schedule("rows", b * h, s, q.device)
    strides = fa._strides(q, k, v, o, do)

    def run(n):
        dq = torch.empty_like(q)
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        stat = lse2 if VARIANTS[n][0] == "Base2" else lse
        err = getattr(dll, f"stpu_dq_variant_{n}")(
            *(t.data_ptr() for t in (q, k, v, o, do, stat, dq, delta, work)),
            strides, b, s, h, kvh, d, fa._DTYPE_CODES[q.dtype], scale,
            int(causal), fa._stream(q))
        if err:
            raise RuntimeError(f"variant {n}: CUDA error {err}")
        return dq

    dq_p, _, _ = fa.flash_bwd_streamed_plain(q, k, v, o, lse, do, causal,
                                             scale)
    for n in VARIANTS:
        dq = run(n)
        torch.cuda.synchronize()
        rel, max_abs, peak = chip_smoke._err(dq, dq_p)
        same = torch.equal(dq, run(n))
        print(f"[check] variant {n} at {shape}: dq rel {rel:.3e} (tol "
              f"{chip_smoke.GRAD_REL_TOL}) max_abs {max_abs:.3e} (cap "
              f"{chip_smoke.MAX_ABS_SHARE * peak:.3e}); bit-identical twice "
              f"{same}", flush=True)
        chip_smoke.check(rel <= chip_smoke.GRAD_REL_TOL
                         and max_abs <= chip_smoke.MAX_ABS_SHARE * peak
                         and same, f"variant {n} disagrees")
    del dq_p

    flops = 6 * d * b * h * (s * (s + 1) // 2 if causal else s * s)
    bound_ms, _ = chip_smoke._bound(flops, 0)
    times = {n: [] for n in VARIANTS}
    order = list(VARIANTS)
    chip_smoke.CLOCKS.start()
    try:
        for r in range(args.rounds):
            for n in (order if r % 2 == 0 else order[::-1]):
                t = chip_smoke.time_ms(lambda: run(n), args.reps)
                times[n].append(t)
                print(f"[time] round {r} variant {n}: {t:.4f} ms; "
                      f"{chip_smoke.clock_note(chip_smoke.CLOCKS.last())}",
                      flush=True)
    finally:
        chip_smoke.CLOCKS.stop()
    for n, ts in times.items():
        med = statistics.median(ts)
        print(f"[summary] variant {n} {VARIANTS[n]} at {shape}: median "
              f"{med:.4f} ms over {len(ts)} timings ({min(ts):.4f}-"
              f"{max(ts):.4f}), {flops / med / 1e9:.1f} TFLOP/s, "
              f"{bound_ms / med:.1%} of the {bound_ms:.4f} ms bound",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
