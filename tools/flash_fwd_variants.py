#!/usr/bin/env python3
"""The width-256 Hopper forward's designs, timed in turns on one card.

    python3 tools/flash_fwd_variants.py
    python3 tools/flash_fwd_variants.py --only p,q --rounds 5

csrc/flash_fwd_sm90.cuh's fwd_cta_wide (the forward's CTA at head_dim
256: lockstep over a two-stage ring of 64-row K/V tiles) takes kQReg, the
k steps of S = Q K^T whose Q operand each consumer holds in registers
(the rest read Q from shared memory). This script builds one instance
per design (nvcc into build/, from the checkout's headers, one process
per instance, all at once), bf16, natural-log lse:

  p     kQReg 0: the parent's body, and still the streamed
        flash_fwd_streamed's and the triangular flash_fwd_tri's;
  q4    kQReg 4;
  q     kQReg = kWideQReg (8): the resident flash_fwd's;
  l1, l2   load only (this script's own CTA, nothing of it in csrc/): a
        producer walks the same Q and K/V tiles into the same ring, alone
        (l1) or in clusters of two CTAs of one KV group at one q tile
        that load each K/V tile once for both by TMA multicast (l2), and
        the consumers only wait for each stage and release it: what the
        K/V stream alone costs, and whether multicast shortens it.

The designs timed against these and removed from csrc/ (the overlapped
schedule, split K/V barriers and clusters of 2 and 4 at this width;
kQReg 6 and 12: PERF.md) are not here. At the width-256 main shapes of
the streamed family (7w: 1 x 4096, 8 heads over 1, non-causal), the
resident one (1w: 8 x 2048, causal) and the triangular one (4w: 1 x
8192, causal), each design is held against the plain forward (and at
ragged, MHA and odd-group check shapes), then all are timed in turns,
forward and reversed order each round, each timing beside nvidia-smi's
SM clock and power (chip_smoke.py's sampler). Each median is printed
beside the bound and the rate at which its K/V tiles leave L2 (every
CTA's tiles, over the cluster size). For each instance it also prints
ptxas's registers, spills and "Potential Performance Loss" notes and the
SASS's HGMMA, UTMALDG (and its forms) and WARPGROUP.DEPBAR counts.
Imports nothing of JAX; needs a CUDA card, the CUDA toolkit and this
file's checkout.
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

# Instances: the CTA call.
INSTANCES = {
    "P": "sm90::fwd_cta_wide<256, Bf16, true>(tq, tk, tv, p, work, smem)",
    "Q4": "sm90::fwd_cta_wide<256, Bf16, true, 4>(tq, tk, tv, p, work, smem)",
    "Q": "sm90::fwd_cta_wide<256, Bf16, true, sm90::kWideQReg>(tq, tk, tv, p, "
         "work, smem)",
    "LOAD": "load_only_cta(tq, tk, tv, p, work, smem)",
}
# Designs: (instance, cluster size).
DESIGNS = {"p": ("P", 1), "q4": ("Q4", 1), "q": ("Q", 1),
           "l1": ("LOAD", 1), "l2": ("LOAD", 2)}
SHAPES = (("7w", chip_smoke.STR_WIDE_MAIN_SHAPE),
          ("1w", chip_smoke.WIDE_MAIN_SHAPE),
          ("4w", chip_smoke.TRI_WIDE_MAIN_SHAPE))
# Held against the plain forward: ragged S both ways, MHA (a group of
# 1) and an odd group of 3.
CHECK_SHAPES = ((2, 1000, 8, 1, 256, False), (1, 4136, 8, 1, 256, True),
                (1, 200, 16, 16, 256, True), (2, 1000, 6, 2, 256, True))
KV_TILE = 64  # kBNWide

# The load-only CTA, in clusters of 1 or 2 (the launch's): the forward's
# shared-memory layout and ring; box c of K's and of V's four issued by
# rank c % 2 and multicast to both CTAs, each completing on its own full
# barrier, which expects the whole tile; each stage released to every
# CTA of the cluster (mapa, then a remote arrive); cluster barriers after
# the barriers' initialisation and before exit.
_LOAD_ONLY = r"""
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n"
      : : : "memory");
}

__device__ __forceinline__ void arrive_at(uint32_t bar, int cta) {
  asm volatile("{\n.reg .b32 a;\nmapa.shared::cluster.u32 a, %0, %1;\n"
               "mbarrier.arrive.shared::cluster.b64 _, [a];\n}\n"
               : : "r"(bar), "r"(cta) : "memory");
}

__device__ __forceinline__ void load_multicast(void* dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1,
                                               int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3, %4, %5}], "
      "[%6], %7;\n"
      : : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3), "r"(bar), "h"((uint16_t)3) : "memory");
}

__device__ __forceinline__ void load_only_cta(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const FwdParams& p, const int* __restrict__ work, unsigned char* smem) {
  using namespace sm90;
  using L = FwdSmem<256>;
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  uint32_t ctas, rank;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(ctas));
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int bh = work[2 * blockIdx.x], qt = work[2 * blockIdx.x + 1];
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KVH);
  const int n_all = ceil_div(p.S, kBNWide);
  const int n_kt = p.causal ? min(n_all, (qt + 1) * (kBM / kBNWide)) : n_all;
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * L::kBars, qbar = full0 + 16 * L::kBars;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kBars; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers * ctas);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  cluster_sync();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, L::kQ);
      for (int c = 0; c < 4; ++c)
        tma_load_4d(base + c * kBM * 128, &tq, qbar, c * 64, qt * kBM, h, b);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % kRing;
        if (j >= kRing) mbar_wait(empty0 + 8 * st, (j / kRing - 1) & 1);
        mbar_expect_tx(full0 + 8 * st, 2 * L::kTileKV);
        for (int c = (int)rank; c < 4; c += ctas) {
          const int off = st * L::kTileKV + c * kBNWide * 128;
          if (ctas == 1) {
            tma_load_4d(base + L::kK + off, &tk, full0 + 8 * st, c * 64,
                        j * kBNWide, kvh, b);
            tma_load_4d(base + L::kV + off, &tv, full0 + 8 * st, c * 64,
                        j * kBNWide, kvh, b);
          } else {
            load_multicast(base + L::kK + off, &tk, full0 + 8 * st, c * 64,
                           j * kBNWide, kvh, b);
            load_multicast(base + L::kV + off, &tv, full0 + 8 * st, c * 64,
                           j * kBNWide, kvh, b);
          }
        }
      }
    }
    cluster_sync();
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const bool first = threadIdx.x % 128 == 0;
    mbar_wait(qbar, 0);
    for (int j = 0; j < n_kt; ++j) {
      mbar_wait(full0 + 8 * (j % kRing), (j / kRing) & 1);
      if (first)
        for (uint32_t r = 0; r < ctas; ++r)
          arrive_at(empty0 + 8 * (j % kRing), r);
    }
    cluster_sync();
  }
}
"""

_SOURCE = """#include "flash_fwd_sm90.cuh"

namespace stpu {{
namespace {{
{extra}
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
fwd_variant_{name}(const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const FwdParams p,
    const int* __restrict__ work) {{
  extern __shared__ __align__(16) unsigned char smem[];
  {call};
}}

}}  // namespace
}}  // namespace stpu

extern "C" int stpu_fwd_variant(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* work, const long long* strides, int B, int S, int H,
    int KVH, int D, int dtype, float scale, int causal, int cluster,
    void* stream) {{
  using namespace stpu;
  if (D != 256 || dtype != Bf16::kDtype) return (int)cudaErrorInvalidValue;
  const FwdParams p =
      fwd_params(q, k, v, o, lse, strides, S, H, KVH, scale, causal);
  {launch}
}}
"""
# The csrc designs launch as the port does; the load-only CTA in
# clusters of `cluster`.
_LAUNCH_PORT = """if (cluster != 1) return (int)cudaErrorInvalidValue;
  return sm90::launch_fwd<256, Bf16>(fwd_variant_{name}, p, B,
                                     static_cast<const int*>(work),
                                     static_cast<cudaStream_t>(stream));"""
_LAUNCH_CLUSTER = """if ((H / KVH) % cluster)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = sm90::encode_rows<Bf16>(&tq, p.q, 256, S, H, B, p.q_ss, p.q_sh,
                                    p.q_sb, sm90::kBM);
  if (!err)
    err = sm90::encode_rows<Bf16>(&tk, p.k, 256, S, KVH, B, p.k_ss, p.k_sh,
                                  p.k_sb, sm90::kBNWide);
  if (!err)
    err = sm90::encode_rows<Bf16>(&tv, p.v, 256, S, KVH, B, p.v_ss, p.v_sh,
                                  p.v_sb, sm90::kBNWide);
  if (err) return err;
  const int smem = sm90::FwdSmem<256>::kBytes;
  const cudaError_t e = allow_smem(fwd_variant_{name}, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {{}};
  cfg.gridDim = dim3(B * H * ceil_div(S, sm90::kBM));
  cfg.blockDim = dim3(sm90::kFwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, fwd_variant_{name}, tq, tk, tv, p,
                                 static_cast<const int*>(work));"""


def build(instances):
    """{name: (library, ptxas log, SASS text)}, each built under build/ by
    content, all nvcc processes at once."""
    root = _build.BUILD_ROOT / "fwd_variants"
    procs = {}
    for name in instances:
        launch = _LAUNCH_CLUSTER if name == "LOAD" else _LAUNCH_PORT
        text = _SOURCE.format(
            name=name, call=INSTANCES[name], launch=launch.format(name=name),
            extra=_LOAD_ONLY if name == "LOAD" else "")
        out = root / hashlib.sha256(
            (text + _build.build_dir().name).encode()).hexdigest()[:16]
        out.mkdir(parents=True, exist_ok=True)
        cu, lib = out / f"fwd_{name}.cu", out / f"libfwd_{name}.so"
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
        # The forward's C signature with the cluster size after causal.
        dll.stpu_fwd_variant.argtypes = [ctypes.c_void_p] * 6 + \
            _build._SPLIT_TAIL
        dll.stpu_fwd_variant.restype = ctypes.c_int
        built[name] = (dll, log, sass)
    return built


def report(built):
    """Per instance: ptxas's registers, spills and notes; SASS counts."""
    for name, (dll, log, sass) in built.items():
        lines = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln or "Performance Loss" in ln
                 or "setmaxnreg" in ln]
        counts = {k: sass.count(k) for k in
                  ("HGMMA", "UTMALDG", "WARPGROUP.DEPBAR")}
        forms = sorted(set(re.findall(r"UTMALDG[.\w]*", sass)))
        print(f"[build] instance {name}: {counts}, TMA loads {forms}; "
              + " | ".join(lines), flush=True)
        if name != "LOAD":
            chip_smoke.check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
                             and counts["WARPGROUP.DEPBAR"]
                             < counts["HGMMA"],
                             f"instance {name}: no wgmma, no TMA, or "
                             "serialised")


def _cluster(design, h, kvh):
    """The design's cluster size, or 1 where it does not divide the GQA
    group (the wrapper's rule)."""
    c = DESIGNS[design][1]
    return c if (h // kvh) % c == 0 else 1


def _runner(built, design, q, k, v, causal):
    inst = DESIGNS[design][0]
    b, s, h, d = q.shape
    kvh = k.shape[2]
    cluster = _cluster(design, h, kvh)
    # tri_schedule's list keeps each q tile's items together in row
    # order, so blocks 2i and 2i + 1 are heads h, h + 1 (h even) of one KV
    # group where the group is even: a cluster's pair.
    work = fa.tri_schedule("rows", b * h, s, q.device, tile=fa.FWD_TILE,
                           inner=fa.FWD_TILE)
    strides = fa._strides(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)

    def run():
        err = built[inst][0].stpu_fwd_variant(
            *(t.data_ptr() for t in (q, k, v, o, lse, work)), strides, b, s,
            h, kvh, d, fa._DTYPE_CODES[q.dtype], d ** -0.5, int(causal),
            cluster, fa._stream(q))
        if err:
            raise RuntimeError(f"design {design}: CUDA error {err}")
        return o, lse

    return run


def _check(built, designs, shape, seed):
    """Each design's o and lse against the plain forward at `shape`;
    returns the runners (the load-only ones unchecked)."""
    b, s, h, kvh, d, causal = shape
    q, k, v, _ = chip_smoke._inputs(shape, seed)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, d ** -0.5)
    runs = {}
    for n in designs:
        runs[n] = _runner(built, n, q, k, v, causal)
        if DESIGNS[n][0] == "LOAD":
            runs[n]()
            continue
        o, lse = runs[n]()
        torch.cuda.synchronize()
        errs = [chip_smoke._err(o, o_p), chip_smoke._err(lse, lse_p)]
        print(f"[check] design {n} (cluster {_cluster(n, h, kvh)}) at "
              f"{shape}: " + "; ".join(
                  f"{x} rel {rel:.3e} max_abs {mx:.3e}" for x, (rel, mx, _)
                  in zip(("o", "lse"), errs)), flush=True)
        chip_smoke.check(all(rel <= chip_smoke.OUT_REL_TOL
                             and mx <= chip_smoke.MAX_ABS_SHARE * peak
                             for rel, mx, peak in errs),
                         f"design {n} disagrees at {shape}")
    torch.cuda.synchronize()
    return runs


def kv_bytes(shape, cluster):
    """The K/V bytes a launch reads from L2: each CTA's tiles (to its
    causal end), once per cluster."""
    b, s, h, kvh, d, causal = shape
    n_all = -(-s // KV_TILE)
    tiles = 0
    for qt in range(-(-s // fa.FWD_TILE)):
        tiles += (min(n_all, (qt + 1) * fa.FWD_TILE // KV_TILE) if causal
                  else n_all)
    return b * h * tiles * 2 * KV_TILE * d * 2 / cluster


def _time(label, designs, runs, shape, args):
    b, s, h, kvh, d, causal = shape
    flops = 4 * d * b * h * (s * (s + 1) // 2 if causal else s * s)
    nbytes = 2 * 2 * b * s * h * d + 2 * 2 * b * s * kvh * d + 4 * b * h * s
    bound_ms, bound_by = chip_smoke._bound(flops, nbytes)
    times = {n: [] for n in designs}
    for r in range(args.rounds):
        for n in (designs if r % 2 == 0 else designs[::-1]):
            t = chip_smoke.time_ms(runs[n], args.reps)
            times[n].append(t)
            print(f"[time] {label} {shape} round {r} design {n}: {t:.4f} "
                  f"ms; {chip_smoke.clock_note(chip_smoke.CLOCKS.last())}",
                  flush=True)
    out = []
    for n, ts in times.items():
        med = statistics.median(ts)
        c = _cluster(n, h, kvh)
        rate = kv_bytes(shape, c) / med / 1e9
        what = ("load only" if DESIGNS[n][0] == "LOAD" else
                f"{flops / med / 1e9:.1f} TFLOP/s, {bound_ms / med:.1%} of "
                f"the {bound_ms:.4f} ms bound ({bound_by})")
        out.append(f"[summary] {label} design {n} (cluster {c}) at {shape}: "
                   f"median {med:.4f} ms over {len(ts)} timings "
                   f"({min(ts):.4f}-{max(ts):.4f}), {what}; K/V from L2 "
                   f"{kv_bytes(shape, c) / 1e9:.3f} GB at {rate:.2f} TB/s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="comma-separated designs (default: all)")
    ap.add_argument("--shapes", default="7w,1w,4w",
                    help="comma-separated main shapes to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    designs = list(DESIGNS) if not args.only else args.only.split(",")
    chip_smoke.phase_device()
    built = build(sorted({DESIGNS[n][0] for n in designs}))
    report(built)
    summary = []
    chip_smoke.CLOCKS.start()
    try:
        for shape in CHECK_SHAPES:
            _check(built, designs, shape, 70)
            torch.cuda.empty_cache()
        for seed, (label, shape) in enumerate(SHAPES):
            if label not in args.shapes.split(","):
                continue
            runs = _check(built, designs, shape, 80 + seed)
            summary += _time(label, designs, runs, shape, args)
            del runs
            torch.cuda.empty_cache()
    finally:
        chip_smoke.CLOCKS.stop()
    for line in summary:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
