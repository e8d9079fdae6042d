// Flash attention in fp32 on Hopper (sm_90a): forward, dq and dk/dv for f32
// inputs, every family's shapes (any S that is a multiple of 8, head_dim 64,
// 128, 256, 512 or any multiple of 256 up to 2048, causal or not), natural
// exp and a natural-log lse.
//
// Replaces, for f32 inputs, skypilot_tpu/ops/pallas/flash_attention.py's
// kernels, whose dots take the input dtype: _fwd_kernel_resident :759,
// _fwd_kernel_tri :417 and _fwd_kernel :57 (the forward);
// _dq_kernel_resident :862, _dq_kernel_tri :543 and _dq_kernel :178 (dq);
// _dkv_kernel_resident :906, _dkv_kernel_tri :598 and _dkv_kernel :227
// (dk/dv). Each feeds f32 q, k, v, P and dS to jax.lax.dot_general; these
// are the same three functions, in fp32 throughout. The 16-bit kernels
// cannot stand in for them: rounding q, k and v to f16, with everything else
// exact, already puts causal gradients past the JAX reference tests' 5e-3
// (tools/flash_f16_error_model.py), and the f16 kernels' own rounding of P
// and dS adds to it.
//
// What bounds them: fp32 arithmetic outside the tensor cores (67 TFLOP/s on
// the card, against 989 for bf16 products). Every product is FFMA on the
// CUDA cores, exact to fp32 rounding: no tensor-core instruction, TF32 or
// split-TF32 scheme.
//
// Every kernel is built as an SGEMM is, for the FFMA rate: a CTA of 256
// threads keeps a tile of resident rows in shared memory (forward: Q of
// kRows q rows; dq: Q and dO of kRows q rows; dk/dv: K and V of kRows kv
// rows) and streams the other operand's tiles of kInner rows (forward and
// dq: K, V; dk/dv: Q, dO of each head of its part of the GQA group)
// through a ring of kStages slabs, kSlab columns each: one TMA box a slab,
// kSlab + 4 columns wide, so it lands as the padded rows the products read
// (the 4 extra columns fill the padding: the next slab's, or zeros past D;
// rows past S read as zeros), completing on the slot's mbarrier
// (sm90::mbar_*, sm90::tma_load_4d). The resident tiles, whose padded rows
// pass a box's 256 columns at D = 256 and 512, come once a CTA by one bulk
// copy (cp.async.bulk) a row.
// Every product is a register-blocked outer product: a thread owns a (kSM x
// kSN) block of S and dP (S^T, dP^T) and a (kOM x kON) block of each output
// slab, reading its operands from shared memory as float4 (rows padded to 4
// floats past a multiple of 32, P and dS rows to 8, so the four row groups
// and eight column groups of a warp's lanes meet distinct banks or one
// broadcast). Each product takes both operands row-major: S = Q K^T and dP =
// dO V^T reduce along the rows of both; o += P V, dq += dS K, dk += dS^T Q
// and dv += P^T dO read A along its rows and B down its columns, so no tile
// is stored transposed. P and dS are formed in the registers that computed
// S and dP, then staged in shared memory as the A operand of the output
// products; the outputs stay in registers across the whole stream.
// - The forward: a key tile's ring steps are the kSlab-wide slabs of K (S),
//   then of V (o). Between them the online softmax in base 2: each row's
//   tile maximum by three shuffles across the 8 lanes of a warp that share
//   it and, where kWarpsN warps share a row, through shared memory; m_new =
//   max(m, tile max), P = exp2(S * scale * log2(e) - m_new) and the row's
//   rescale alpha = exp2(m - m_new), staged in shared memory for the
//   threads that hold the row in o; each thread keeps its own part of the
//   row sum l (alpha is the row's, so the parts are summed once, at the
//   end, in a fixed order). The epilogue writes o / l and lse = (m +
//   log2(l)) ln(2), natural log, as the backward reads it. 4 D FLOPs a
//   (row, key) pair.
// - The backward: P = exp2(S * scale * log2(e) - lse * log2(e)) and dS = P
//   (dP - delta). A tile's ring steps: the kSlab-wide slabs of V (dP), then
//   of K (S; the last one also feeds the output product of its columns, so
//   a one-slab head_dim reads K once), then K again for the other column
//   slabs of dq (dq); dk/dv the same with dO and Q, then dO again for dv.
//   Per (row, key) pair that is 6 D FLOPs for dq and 8 D for dk/dv, S and
//   dP recomputed in each (one fused pass would need float atomics for
//   dq).
//
// Budget of a CTA (FwdTiles, DqTiles, DkvTiles; shared memory: the resident
// tiles, P (and dS), the ring, the rows' stats, the mbarriers, 128 bytes to
// align), every one 256 threads, one CTA an SM:
//   fwd    D=64: 64 q rows, 64-key tiles, one 64-column slab, 4 stages,
//          S 4x4 a thread (two warps a row), o 16 registers (106,408 B);
//          D=128: 128 q rows (each K/V slab serves twice 64 rows'
//          products; 0.87x the time of 64 rows on an H100 SXM,
//          tools/flash_f32_variants.py), S 8x4, one 128-column slab, 3
//          stages, o 64 (207,520 B);
//          D=256: 128 q rows (0.92x), S 8x4, four 64-column slabs, 3
//          stages, o 128 (223,904 B);
//          D=512: 32 q rows against 128-key tiles, S 4x4 (four warps a
//          row), eight 64-column slabs, 3 stages, o 64 (188,704 B).
//   dq     D=64: 64 q rows, 64-key tiles, one 64-column slab, 4 stages,
//          S 4x4 a thread, dq 16 registers (123,560 B);
//          D=128: the same in one 128-column slab, 3 stages, dq 32
//          (188,064 B);
//          D=256: two 128-column slabs, 2 stages, dq 64 (219,800 B);
//          D=512: 32 q rows (64 Q and dO rows would not fit) against
//          128-key tiles, S 4x4, eight 64-column slabs, 2 stages, dq 64
//          (219,544 B).
//   dk/dv  D=64: 64 kv rows, 64-row q tiles, one slab, 4 stages, dk and
//          dv 32 registers (141,992 B);
//          D=128: one 128-column slab, 3 stages, dk and dv 64
//          (206,496 B);
//          D=256: four 64-column slabs, 3 stages, dk and dv 128
//          (222,880 B);
//          D=512: 32 kv rows, S^T 2x4, eight 64-column slabs, 2 stages,
//          dk and dv 128 (185,752 B).
//   Past 512 the wide kernels (WideTiles, below): 64 rows against 64-row
//   tiles, four stages of a slot holding both operands' 64-column slabs,
//   S 4x4 and a 256-column chunk of the output 64 registers a thread (dk
//   and dv 128): 158,624 B (forward), 158,368 B (dq), 176,544 B (dk/dv).
//
// Work lists, built on the host (ops/flash_attention.py), longest first:
// the forward and dq walk (b * H + h, q tile) items, each over the key
// tiles up to its causal bound; dk/dv walks (b * KVH + kvh, kv tile, part)
// items, each over the q tiles from its causal start for each of the G / P
// query heads of its part of the group. Where B * KVH * S / kRows would
// leave the card part idle, P > 1 parts write fp32 partials to a
// workspace, and the last CTA of each kv tile to take its integer ticket
// sums them in part order: no float atomics, so every kernel is
// deterministic. Rows past S are zeros in shared memory and are masked out
// of P (key columns in the forward and dq, q columns in dk/dv); only rows <
// S are written. dq writes delta = rowsum(dO * O) for dk/dv, as the other
// families do.
#include "flash_common.cuh"
#include "flash_fwd_sm90.cuh"  // the mbarrier helpers (sm90::mbar_*)

namespace stpu {
namespace {

// The params' 16-bit pointers carry f32 tensors here (element strides of
// f32).
__device__ __forceinline__ const float* f32(const e16* p) {
  return reinterpret_cast<const float*>(p);
}
__device__ __forceinline__ float* f32(e16* p) {
  return reinterpret_cast<float*>(p);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ----------------------------------------------------------------------
// The forward, dq and dk/dv as register-blocked FFMA products over
// shared-memory tiles (see the note at the top).

constexpr int kThreads = 256;  // 8 warps, one CTA an SM
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemBytes = 232448;  // what a block may use
constexpr float kLn2 = 0.6931471805599453f;

// The forward's launch: the work list holds (b * H + h, q tile) pairs.
struct F32Fwd {
  FwdParams p;
  const int* work;
  int batch;
};

// dq's launch: the work list holds (b * H + h, q tile) pairs.
struct F32Dq {
  BwdParams p;
  const int* work;
  int batch;
};

// dk/dv's launch: the work list holds (b * KVH + kvh, kv tile, part)
// triples. With parts > 1 each part's fp32 partials go to ws, (2, parts,
// batch, S, KVH, D) (dv, then dk), and each kv tile has one ticket, zero
// at launch.
struct F32Dkv {
  BwdParams p;
  const int* work;
  float* ws;
  int* tickets;
  int parts;
  int batch;
};

// A CTA's tiles at head_dim D: resident rows, rows of a streamed tile,
// columns of a streamed slab, ring stages, a thread's block of S (S^T)
// and dP (kSM x kSN) and of each output slab (kOM x kON).
template <int D> struct FwdTiles;
template <> struct FwdTiles<64> {
  static constexpr int kRows = 64, kInner = 64, kSlab = 64, kStages = 4;
  static constexpr int kSM = 4, kSN = 4, kOM = 4, kON = 4;
};
template <> struct FwdTiles<128> {
  static constexpr int kRows = 128, kInner = 64, kSlab = 128, kStages = 3;
  static constexpr int kSM = 8, kSN = 4, kOM = 8, kON = 8;
};
template <> struct FwdTiles<256> {
  static constexpr int kRows = 128, kInner = 64, kSlab = 64, kStages = 3;
  static constexpr int kSM = 8, kSN = 4, kOM = 8, kON = 4;
};
template <> struct FwdTiles<512> {
  static constexpr int kRows = 32, kInner = 128, kSlab = 64, kStages = 3;
  static constexpr int kSM = 4, kSN = 4, kOM = 2, kON = 4;
};
template <int D> struct DqTiles;
template <> struct DqTiles<64> {
  static constexpr int kRows = 64, kInner = 64, kSlab = 64, kStages = 4;
  static constexpr int kSM = 4, kSN = 4, kOM = 4, kON = 4;
};
template <> struct DqTiles<128> {
  static constexpr int kRows = 64, kInner = 64, kSlab = 128, kStages = 3;
  static constexpr int kSM = 4, kSN = 4, kOM = 4, kON = 8;
};
template <> struct DqTiles<256> {
  static constexpr int kRows = 64, kInner = 64, kSlab = 128, kStages = 2;
  static constexpr int kSM = 4, kSN = 4, kOM = 4, kON = 8;
};
template <> struct DqTiles<512> {
  static constexpr int kRows = 32, kInner = 128, kSlab = 64, kStages = 2;
  static constexpr int kSM = 4, kSN = 4, kOM = 2, kON = 4;
};
template <int D> struct DkvTiles;
template <> struct DkvTiles<64> {
  static constexpr int kRows = 64, kInner = 64, kSlab = 64, kStages = 4;
  static constexpr int kSM = 4, kSN = 4, kOM = 4, kON = 4;
};
template <> struct DkvTiles<128> {
  static constexpr int kRows = 64, kInner = 64, kSlab = 128, kStages = 3;
  static constexpr int kSM = 4, kSN = 4, kOM = 4, kON = 8;
};
template <> struct DkvTiles<256> {
  static constexpr int kRows = 64, kInner = 64, kSlab = 64, kStages = 3;
  static constexpr int kSM = 4, kSN = 4, kOM = 4, kON = 4;
};
template <> struct DkvTiles<512> {
  static constexpr int kRows = 32, kInner = 64, kSlab = 64, kStages = 2;
  static constexpr int kSM = 2, kSN = 4, kOM = 2, kON = 4;
};

// Shared memory of a CTA, in floats from a 128-byte aligned base:
// kResTiles resident tiles (kRows rows of D + 4; the forward's Q, dq's Q
// and dO, dk/dv's K and V), kPTiles tiles of P or dS (kRows rows of
// kInner + 8), the ring's slabs (kInner rows of kSlab + 4), kStats floats
// a resident row (forward: the warps' row maxima and sums, the rows'
// rescale; dq: lse * log2(e) and delta; dk/dv: the ticket's flag); then
// kStages + 1 mbarriers (the slabs', the resident tiles').
template <class T, int D, int kPTiles, int kResTiles = 2, int kStats = 2>
struct TileSmem {
  static constexpr int kLdRes = D + 4, kLdP = T::kInner + 8;
  static constexpr int kLdSlab = T::kSlab + 4;
  static constexpr int kResTile = T::kRows * kLdRes;
  static constexpr int kPTile = T::kRows * kLdP;
  static constexpr int kSlabTile = T::kInner * kLdSlab;
  static constexpr int kP = kResTiles * kResTile;
  static constexpr int kRing = kP + kPTiles * kPTile;
  static constexpr int kStat = kRing + T::kStages * kSlabTile;
  static constexpr int kBar = kStat + kStats * T::kRows;  // 8-byte aligned
  static constexpr int kSlabBytes = 4 * kSlabTile;    // a whole TMA box
  // 128 bytes of slack to align the base: every TMA slot starts on a
  // 128-byte boundary.
  static constexpr int kBytes = 4 * kBar + 8 * (T::kStages + 1) + 128;
  static_assert(kRing % 32 == 0 && kSlabTile % 32 == 0,
                "128-byte aligned slots");
  static_assert(kLdSlab <= 256, "a TMA box spans at most 256 columns");
  static_assert(kBytes <= kMaxSmemBytes, "a CTA's tiles pass 227 KB");
  static_assert(D % T::kSlab == 0 && T::kStages >= 2, "slabs of a row");
};

// A thread's place in an M x N product of the CTA: the 8 warps tile it in
// (M / 4 TM) x (N / 8 TN) blocks, the lanes of a warp 4 x 8. Rows row0 +
// 4 i (i < TM); columns col0 + 8 j (j < TN) for S and dP, or col4 + 32 g
// + c (g < TN / 4, c < 4) for an output slab, read as float4.
template <int M, int N, int TM, int TN>
struct Frag {
  static constexpr int kWarpsN = N / (8 * TN);
  static_assert((M / (4 * TM)) * kWarpsN == kWarps && TN % 4 == 0,
                "8 warps tile the product");
  static __device__ __forceinline__ int row0() {
    return threadIdx.x / 32 / kWarpsN * 4 * TM + threadIdx.x % 32 / 8;
  }
  static __device__ __forceinline__ int col0() {
    return threadIdx.x / 32 % kWarpsN * 8 * TN + threadIdx.x % 8;
  }
  static __device__ __forceinline__ int col4() {
    return threadIdx.x / 32 % kWarpsN * 8 * TN + 4 * (threadIdx.x % 8);
  }
};

// One row of `bytes` from global src to shared dst by the bulk-copy engine,
// completing on mbarrier `bar`'s transaction count.
__device__ __forceinline__ void bulk_row(float* dst, const float* src,
                                         int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float lane_of(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

// Rows row0 .. row0 + n - 1 (all < S) of a (.., S, .., D) tensor (row
// stride gs) into shared rows of LD floats, one bulk copy a row from the
// lanes of warp 0, completing on `bar` (armed for their bytes by the
// caller).
template <int D, int LD>
__device__ __forceinline__ void copy_rows(float* s, const float* g,
                                          long long gs, int row0, int n,
                                          uint32_t bar) {
  for (int r = threadIdx.x % 32; r < n; r += 32)
    bulk_row(s + r * LD, g + (row0 + r) * gs, 4 * D, bar);
}

// Rows n .. R - 1 of a shared tile of R rows of C columns (LD floats a
// row), zeroed by the CTA: a resident tile's rows past S.
template <int R, int C, int LD>
__device__ __forceinline__ void zero_rows(float* s, int n) {
  for (int i = threadIdx.x; i < (R - n) * (C / 4); i += kThreads)
    *reinterpret_cast<float4*>(s + (n + i / (C / 4)) * LD +
                               4 * (i % (C / 4))) =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

// The kTiles (1 or 2) resident tiles (R rows of D columns from row0 of a
// and, with two, of b, back to back) by warp 0's bulk copies on `bar`,
// which it arms for their bytes; their rows past S are zeroed by the CTA.
template <int R, int D, int LD, int kTiles = 2>
__device__ __forceinline__ void load_resident(float* s, const float* a,
                                              long long as, const float* b,
                                              long long bs, int row0, int S,
                                              uint32_t bar) {
  const int n = min(R, S - row0);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) sm90::mbar_expect_tx(bar, 4 * kTiles * n * D);
    __syncwarp();
    copy_rows<D, LD>(s, a, as, row0, n, bar);
    if constexpr (kTiles == 2)
      copy_rows<D, LD>(s + R * LD, b, bs, row0, n, bar);
  }
  zero_rows<R, D, LD>(s, n);
  if constexpr (kTiles == 2) zero_rows<R, D, LD>(s + R * LD, n);
}

// The dynamic shared memory from its first 128-byte boundary (the layouts
// keep 128 bytes of slack for it).
__device__ __forceinline__ float* aligned_smem() {
  extern __shared__ float4 smem_f4[];
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem_f4);
  return reinterpret_cast<float*>(raw + ((128 - (smem_addr(raw) & 127)) &
                                         127));
}

// The CTA's kStages + 1 mbarriers at `bars`, one arrival a phase; the
// CTA meets before any is used.
template <int kStages>
__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) sm90::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// acc[i][j] += sum_{k < K} a[i][k] b[j][k], a's rows 4 apart (LDA floats
// each), b's rows 8 apart (LDB floats each): S = Q K^T, dP = dO V^T and
// their transposes.
template <int TM, int TN, int K, int LDA, int LDB>
__device__ __forceinline__ void fma_nt(float (&acc)[TM][TN],
                                       const float* a, const float* b) {
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 x[TM], y[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + i * 4 * LDA + k);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + j * 8 * LDB + k);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][4 g + c] += sum_{k < K} a[i][k] b[k][32 g + c], a's rows 4 apart
// (LDA floats each), b's rows LDB floats apart: dq += dS K, dk += dS^T Q,
// dv += P^T dO on one column slab.
template <int TM, int TN, int K, int LDA, int LDB>
__device__ __forceinline__ void fma_nn(float (&acc)[TM][TN],
                                       const float* a, const float* b) {
  constexpr int G = TN / 4;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 x[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + i * 4 * LDA + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 y[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        y[g] = *reinterpret_cast<const float4*>(b + (k + u) * LDB + 32 * g);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xi = lane_of(x[i], u);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[i][4 * g + 0] = fmaf(xi, y[g].x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(xi, y[g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(xi, y[g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(xi, y[g].w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// The ring: step g's slab sits in slot g % kStages, on mbarrier g %
// kStages. A step waits for its slab, meets the CTA (which has then
// finished step g - 1), and refills step g - 1's slot with the slab of
// step g + kStages - 1.
template <int kStages>
struct Ring {
  float* base;
  int slab_floats;
  uint32_t bars;
  template <class Fetch>
  __device__ __forceinline__ const float* step(int g, const Fetch& fetch) {
    sm90::mbar_wait(bars + 8 * (g % kStages), (g / kStages) & 1);
    __syncthreads();
    fetch(g + kStages - 1);
    return base + (g % kStages) * slab_floats;
  }
};

// Rows [r0, r0 + 4 TM) (4 apart from row0) of an output slab's block, a
// row's columns col4 + 32 g + c, times mul, to the rows < S of out (row
// stride ss).
template <int TM, int TN>
__device__ __forceinline__ void store_block(const float (&acc)[TM][TN],
                                            float mul, float* out,
                                            long long ss, int row0, int S) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + 4 * i;
    if (row >= S) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g)
      *reinterpret_cast<float4*>(out + row * ss + 32 * g) =
          make_float4(acc[i][4 * g] * mul, acc[i][4 * g + 1] * mul,
                      acc[i][4 * g + 2] * mul, acc[i][4 * g + 3] * mul);
  }
}

// Shared memory of the forward at head_dim D: Q, P, the ring, and
// kWarpsN + 1 floats a row (the warps' row maxima, then sums; the rows'
// rescale of o, then 1 / l).
template <int D>
using FwdSmem = TileSmem<FwdTiles<D>, D, 1, 1,
                         Frag<FwdTiles<D>::kRows, FwdTiles<D>::kInner,
                              FwdTiles<D>::kSM, FwdTiles<D>::kSN>::kWarpsN +
                             1>;

// o and the natural-log lse: block i is item i of the work list, (b * H +
// h, q tile of kRows rows), walking the kInner-key tiles up to its causal
// bound; tk and tv map K and V in boxes of kInner rows x kSlab + 4
// columns.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const F32Fwd a) {
  using T = FwdTiles<D>;
  using L = FwdSmem<D>;
  using SF = Frag<T::kRows, T::kInner, T::kSM, T::kSN>;
  using OF = Frag<T::kRows, T::kSlab, T::kOM, T::kON>;
  constexpr int kN = D / T::kSlab;  // column slabs a row
  constexpr int kSteps = 2 * kN;    // ring steps a key tile
  constexpr int kWN = SF::kWarpsN;  // warps that share a row of S
  float* sm = aligned_smem();
  const FwdParams& p = a.p;
  const int bh = a.work[2 * blockIdx.x], qt = a.work[2 * blockIdx.x + 1];
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KVH);
  const int q0 = qt * T::kRows;
  const int n_all = ceil_div(p.S, T::kInner);
  const int n_kt = p.causal
                       ? min(n_all, (q0 + T::kRows - 1) / T::kInner + 1)
                       : n_all;
  const int total = n_kt * kSteps;
  const uint32_t bars = smem_addr(sm + L::kBar);
  init_bars<T::kStages>(bars);
  // Step w of a key tile: K slab w (w < kN), then V slab w - kN.
  const auto fetch = [&](int g) {
    if (g >= total || threadIdx.x != 0) return;
    const int t = g / kSteps, w = g % kSteps;
    const uint32_t bar = bars + 8 * (g % T::kStages);
    sm90::mbar_expect_tx(bar, L::kSlabBytes);
    sm90::tma_load_4d(sm + L::kRing + (g % T::kStages) * L::kSlabTile,
                      w < kN ? &tk : &tv, bar, (w % kN) * T::kSlab,
                      t * T::kInner, kvh, b);
  };
  load_resident<T::kRows, D, L::kLdRes, 1>(
      sm, f32(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, nullptr, 0, q0, p.S,
      bars + 8 * T::kStages);
#pragma unroll
  for (int g = 0; g < T::kStages - 1; ++g) fetch(g);
  sm90::mbar_wait(bars + 8 * T::kStages, 0);
  const int sr = SF::row0(), sc = SF::col0();
  const int orow = OF::row0(), ocol = OF::col4();
  const int wn = threadIdx.x / 32 % kWN, lane = threadIdx.x % 32;
  const bool row_leader = wn == 0 && lane % 8 == 0;
  const float* qs = sm + sr * L::kLdRes;
  float* pb = sm + L::kP;
  float* red = sm + L::kStat;            // kWN x kRows
  float* rescale = red + kWN * T::kRows;  // kRows
  const float c2 = p.scale * BaseE2::kScoreMul;
  Ring<T::kStages> ring{sm + L::kRing, L::kSlabTile, bars};
  // The row's running maximum (base 2, the same in every thread of the
  // row) and this thread's part of its sum.
  float m[T::kSM], l[T::kSM];
#pragma unroll
  for (int i = 0; i < T::kSM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float acc[kN][T::kOM][T::kON];
#pragma unroll
  for (int w = 0; w < kN; ++w)
#pragma unroll
    for (int i = 0; i < T::kOM; ++i)
#pragma unroll
      for (int j = 0; j < T::kON; ++j) acc[w][i][j] = 0.f;
  for (int t = 0; t < n_kt; ++t) {
    float s[T::kSM][T::kSN];
#pragma unroll
    for (int i = 0; i < T::kSM; ++i)
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) s[i][j] = 0.f;
    const int g0 = t * kSteps;
#pragma unroll
    for (int w = 0; w < kN; ++w) {
      const float* k = ring.step(g0 + w, fetch);
      fma_nt<T::kSM, T::kSN, T::kSlab, L::kLdRes, L::kLdSlab>(
          s, qs + w * T::kSlab, k + sc * L::kLdSlab);
    }
    // The tile's scores in base 2, masked (key columns at or past S, and
    // above the diagonal when causal), and each row's maximum.
    float mx[T::kSM];
#pragma unroll
    for (int i = 0; i < T::kSM; ++i) {
      const int qpos = q0 + sr + 4 * i;
      mx[i] = -INFINITY;
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) {
        const int kpos = t * T::kInner + sc + 8 * j;
        const bool keep = kpos < p.S && !(p.causal && kpos > qpos);
        s[i][j] = keep ? s[i][j] * c2 : -INFINITY;
        mx[i] = fmaxf(mx[i], s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
    }
    if constexpr (kWN > 1) {
      if (lane % 8 == 0)
#pragma unroll
        for (int i = 0; i < T::kSM; ++i)
          red[wn * T::kRows + sr + 4 * i] = mx[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < T::kSM; ++i)
#pragma unroll
        for (int u = 0; u < kWN; ++u)
          mx[i] = fmaxf(mx[i], red[u * T::kRows + sr + 4 * i]);
    }
    // P and the rows' rescale, for the products below (the next ring
    // step's barrier publishes them). Every row has a key below S in tile
    // 0 (key 0), so m is finite from then on.
#pragma unroll
    for (int i = 0; i < T::kSM; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      const float alpha = BaseE2::exp(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) {
        const float pr = BaseE2::exp(s[i][j] - m_new);
        pb[(sr + 4 * i) * L::kLdP + sc + 8 * j] = pr;
        sum += pr;
      }
      l[i] = fmaf(l[i], alpha, sum);
      if (row_leader) rescale[sr + 4 * i] = alpha;
    }
#pragma unroll
    for (int w = 0; w < kN; ++w) {
      const float* v = ring.step(g0 + kN + w, fetch);
      if (w == 0) {
#pragma unroll
        for (int i = 0; i < T::kOM; ++i) {
          const float alpha = rescale[orow + 4 * i];
#pragma unroll
          for (int u = 0; u < kN; ++u)
#pragma unroll
            for (int j = 0; j < T::kON; ++j) acc[u][i][j] *= alpha;
        }
      }
      fma_nn<T::kOM, T::kON, T::kInner, L::kLdP, L::kLdSlab>(
          acc[w], pb + orow * L::kLdP, v + ocol);
    }
  }
  // Each row's sum over its threads (the lanes, then the warps, in a
  // fixed order), 1 / l for o and the natural-log lse.
#pragma unroll
  for (int i = 0; i < T::kSM; ++i)
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
  __syncthreads();  // every read of red and rescale is done
  if constexpr (kWN > 1) {
    if (lane % 8 == 0)
#pragma unroll
      for (int i = 0; i < T::kSM; ++i)
        red[wn * T::kRows + sr + 4 * i] = l[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < T::kSM; ++i) {
      l[i] = red[sr + 4 * i];
#pragma unroll
      for (int u = 1; u < kWN; ++u) l[i] += red[u * T::kRows + sr + 4 * i];
    }
  }
  const long long stat = ((long long)b * p.H + h) * p.S;
  if (row_leader) {
#pragma unroll
    for (int i = 0; i < T::kSM; ++i) {
      const int row = q0 + sr + 4 * i;
      rescale[sr + 4 * i] = 1.f / l[i];
      if (row < p.S) p.lse[stat + row] = (m[i] + log2f(l[i])) * kLn2;
    }
  }
  __syncthreads();
  float* og = f32(p.o) + ((long long)b * p.S * p.H + h) * D;
  const long long ss = (long long)p.H * D;
#pragma unroll
  for (int i = 0; i < T::kOM; ++i) {
    const float inv = rescale[orow + 4 * i];
#pragma unroll
    for (int w = 0; w < kN; ++w)
#pragma unroll
      for (int j = 0; j < T::kON; ++j) acc[w][i][j] *= inv;
  }
#pragma unroll
  for (int w = 0; w < kN; ++w)
    store_block(acc[w], 1.f, og + w * T::kSlab + ocol, ss, q0 + orow, p.S);
}

// dq and delta: block i is item i of the work list, (b * H + h, q tile of
// kRows rows), walking the kInner-key tiles up to its causal bound; tk and
// tv map K and V in boxes of kInner rows x kSlab + 4 columns.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_f32_kernel(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const F32Dq a) {
  using T = DqTiles<D>;
  using L = TileSmem<T, D, 1>;
  using SF = Frag<T::kRows, T::kInner, T::kSM, T::kSN>;
  using OF = Frag<T::kRows, T::kSlab, T::kOM, T::kON>;
  constexpr int kN = D / T::kSlab;     // column slabs a row
  constexpr int kSteps = 3 * kN - 1;   // ring steps a key tile
  float* sm = aligned_smem();
  const BwdParams& p = a.p;
  const int bh = a.work[2 * blockIdx.x], qt = a.work[2 * blockIdx.x + 1];
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KVH);
  const int q0 = qt * T::kRows;
  const float* qg = f32(p.q) + b * p.q_sb + h * p.q_sh;
  const float* og = f32(p.o) + b * p.o_sb + h * p.o_sh;
  const float* dog = f32(p.dout) + b * p.do_sb + h * p.do_sh;
  const int n_all = ceil_div(p.S, T::kInner);
  const int n_kt = p.causal
                       ? min(n_all, (q0 + T::kRows - 1) / T::kInner + 1)
                       : n_all;
  const int total = n_kt * kSteps;
  const uint32_t bars = smem_addr(sm + L::kBar);
  init_bars<T::kStages>(bars);
  // Step w of a key tile: V slab w (w < kN), K slab w - kN, then K slabs
  // kN - 2 .. 0.
  const auto fetch = [&](int g) {
    if (g >= total || threadIdx.x != 0) return;
    const int t = g / kSteps, w = g % kSteps;
    const int slab = w < kN ? w : w < 2 * kN ? w - kN : 3 * kN - 2 - w;
    const uint32_t bar = bars + 8 * (g % T::kStages);
    sm90::mbar_expect_tx(bar, L::kSlabBytes);
    sm90::tma_load_4d(sm + L::kRing + (g % T::kStages) * L::kSlabTile,
                      w < kN ? &tv : &tk, bar, slab * T::kSlab,
                      t * T::kInner, kvh, b);
  };
  load_resident<T::kRows, D, L::kLdRes>(sm, qg, p.q_ss, dog, p.do_ss, q0,
                                        p.S, bars + 8 * T::kStages);
#pragma unroll
  for (int g = 0; g < T::kStages - 1; ++g) fetch(g);
  sm90::mbar_wait(bars + 8 * T::kStages, 0);
  __syncthreads();
  // delta = rowsum(dO * O), a warp a row; lse into base 2 (BaseE2).
  const long long stat = ((long long)b * p.H + h) * p.S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < T::kRows; r += kWarps) {
    const int row = q0 + r;
    float s = 0.f;
    if (row < p.S) {
      for (int c = 4 * lane; c < D; c += 128) {
        const float4 o =
            __ldg(reinterpret_cast<const float4*>(og + row * p.o_ss + c));
        const float4 d = *reinterpret_cast<const float4*>(
            sm + L::kResTile + r * L::kLdRes + c);
        s = fmaf(d.x, o.x, s);
        s = fmaf(d.y, o.y, s);
        s = fmaf(d.z, o.z, s);
        s = fmaf(d.w, o.w, s);
      }
    }
    s = warp_sum(s);
    if (lane == 0) {
      sm[L::kStat + r] =
          row < p.S ? p.lse[stat + row] * BaseE2::kLseMul : 0.f;
      sm[L::kStat + T::kRows + r] = s;
      if (row < p.S) p.delta[stat + row] = s;
    }
  }
  __syncthreads();
  const int sr = SF::row0(), sc = SF::col0();
  const int orow = OF::row0(), ocol = OF::col4();
  float lse2[T::kSM], dlt[T::kSM];
#pragma unroll
  for (int i = 0; i < T::kSM; ++i) {
    lse2[i] = sm[L::kStat + sr + 4 * i];
    dlt[i] = sm[L::kStat + T::kRows + sr + 4 * i];
  }
  const float* qs = sm + sr * L::kLdRes;
  const float* dos = qs + L::kResTile;
  float* ds = sm + L::kP;
  const float c2 = p.scale * BaseE2::kScoreMul;
  Ring<T::kStages> ring{sm + L::kRing, L::kSlabTile, bars};
  float acc[kN][T::kOM][T::kON];
#pragma unroll
  for (int w = 0; w < kN; ++w)
#pragma unroll
    for (int i = 0; i < T::kOM; ++i)
#pragma unroll
      for (int j = 0; j < T::kON; ++j) acc[w][i][j] = 0.f;
  for (int t = 0; t < n_kt; ++t) {
    float s[T::kSM][T::kSN], dp[T::kSM][T::kSN];
#pragma unroll
    for (int i = 0; i < T::kSM; ++i)
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) s[i][j] = dp[i][j] = 0.f;
    const int g0 = t * kSteps;
#pragma unroll
    for (int w = 0; w < kN; ++w) {
      const float* v = ring.step(g0 + w, fetch);
      fma_nt<T::kSM, T::kSN, T::kSlab, L::kLdRes, L::kLdSlab>(
          dp, dos + w * T::kSlab, v + sc * L::kLdSlab);
    }
#pragma unroll
    for (int w = 0; w < kN; ++w) {
      const float* k = ring.step(g0 + kN + w, fetch);
      fma_nt<T::kSM, T::kSN, T::kSlab, L::kLdRes, L::kLdSlab>(
          s, qs + w * T::kSlab, k + sc * L::kLdSlab);
      if (w == kN - 1) {
        // dS of the tile, masked: key columns at or past S, and above the
        // diagonal when causal.
#pragma unroll
        for (int i = 0; i < T::kSM; ++i) {
          const int qpos = q0 + sr + 4 * i;
#pragma unroll
          for (int j = 0; j < T::kSN; ++j) {
            const int kpos = t * T::kInner + sc + 8 * j;
            const bool keep = kpos < p.S && !(p.causal && kpos > qpos);
            const float pr =
                keep ? BaseE2::exp(fmaf(s[i][j], c2, -lse2[i])) : 0.f;
            ds[(sr + 4 * i) * L::kLdP + sc + 8 * j] = pr * (dp[i][j] - dlt[i]);
          }
        }
        __syncthreads();
        fma_nn<T::kOM, T::kON, T::kInner, L::kLdP, L::kLdSlab>(
            acc[kN - 1], ds + orow * L::kLdP, k + ocol);
      }
    }
#pragma unroll
    for (int w = 0; w < kN - 1; ++w) {
      const float* k = ring.step(g0 + 2 * kN + w, fetch);
      fma_nn<T::kOM, T::kON, T::kInner, L::kLdP, L::kLdSlab>(
          acc[kN - 2 - w], ds + orow * L::kLdP, k + ocol);
    }
  }
  float* dqg = f32(p.dq) + ((long long)b * p.S * p.H + h) * D;
  const long long ss = (long long)p.H * D;
#pragma unroll
  for (int w = 0; w < kN; ++w)
    store_block(acc[w], p.scale, dqg + w * T::kSlab + ocol, ss, q0 + orow,
                p.S);
}

// The rows < S of a kv tile's dk or dv (which: 0 dv, 1 dk) summed over
// the parts' fp32 partials in part order, times mul, into out.
template <int D, int kRows>
__device__ __forceinline__ void sum_parts(const F32Dkv& a, int which,
                                          float mul, float* out,
                                          long long off, long long ss,
                                          int row0) {
  const long long plane = (long long)a.batch * a.p.S * ss;
  const float* ws = a.ws + which * a.parts * plane + off;
  constexpr int kRowChunks = D / 4;
  for (int c = threadIdx.x; c < kRows * kRowChunks; c += kThreads) {
    const int row = row0 + c / kRowChunks;
    if (row >= a.p.S) continue;
    const long long at = row * ss + 4 * (c % kRowChunks);
    float4 s = __ldcg(reinterpret_cast<const float4*>(ws + at));
    for (int pp = 1; pp < a.parts; ++pp) {
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(ws + pp * plane + at));
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    *reinterpret_cast<float4*>(out + off + at) =
        make_float4(s.x * mul, s.y * mul, s.z * mul, s.w * mul);
  }
}

// dk and dv: block i is item i of the work list, (b * KVH + kvh, kv tile
// of kRows rows, part), walking, for each of the part's G / parts query
// heads, the kInner-row q tiles from its causal start; tq and tdo map Q
// and dO in boxes of kInner rows x kSlab + 4 columns.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_f32_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const F32Dkv a) {
  using T = DkvTiles<D>;
  using L = TileSmem<T, D, 2>;
  using SF = Frag<T::kRows, T::kInner, T::kSM, T::kSN>;
  using OF = Frag<T::kRows, T::kSlab, T::kOM, T::kON>;
  constexpr int kN = D / T::kSlab;
  constexpr int kSteps = 4 * kN - 1;  // ring steps a q tile
  float* sm = aligned_smem();
  const BwdParams& p = a.p;
  const int* item = a.work + 3 * blockIdx.x;
  const int bkv = item[0], kt = item[1], part = item[2];
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  const int heads = p.H / p.KVH / a.parts;
  const int h0 = kvh * (p.H / p.KVH) + part * heads;
  const int k0 = kt * T::kRows;
  // Causal: q tiles from the one that holds row k0.
  const int i0 = p.causal ? k0 / T::kInner : 0;
  const int n_qt = ceil_div(p.S, T::kInner) - i0;
  const int total = heads * n_qt * kSteps;
  const float* kg = f32(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = f32(p.v) + b * p.v_sb + kvh * p.v_sh;
  const uint32_t bars = smem_addr(sm + L::kBar);
  init_bars<T::kStages>(bars);
  // Step w of a q tile: dO slab w (w < kN), Q slab w - kN, Q slabs
  // kN - 2 .. 0, then dO slabs 0 .. kN - 1.
  const auto fetch = [&](int g) {
    if (g >= total || threadIdx.x != 0) return;
    const int t = g / kSteps, w = g % kSteps;
    const int h = h0 + t / n_qt, qt = i0 + t % n_qt;
    const bool is_do = w < kN || w >= 3 * kN - 1;
    const int slab = w < kN            ? w
                     : w < 2 * kN      ? w - kN
                     : w < 3 * kN - 1  ? 3 * kN - 2 - w
                                       : w - (3 * kN - 1);
    const uint32_t bar = bars + 8 * (g % T::kStages);
    sm90::mbar_expect_tx(bar, L::kSlabBytes);
    sm90::tma_load_4d(sm + L::kRing + (g % T::kStages) * L::kSlabTile,
                      is_do ? &tdo : &tq, bar, slab * T::kSlab,
                      qt * T::kInner, h, b);
  };
  load_resident<T::kRows, D, L::kLdRes>(sm, kg, p.k_ss, vg, p.v_ss, k0,
                                        p.S, bars + 8 * T::kStages);
#pragma unroll
  for (int g = 0; g < T::kStages - 1; ++g) fetch(g);
  sm90::mbar_wait(bars + 8 * T::kStages, 0);
  const int sr = SF::row0(), sc = SF::col0();
  const int orow = OF::row0(), ocol = OF::col4();
  const float* ks = sm + sr * L::kLdRes;
  const float* vs = ks + L::kResTile;
  float* pt = sm + L::kP;
  float* dst = pt + L::kPTile;
  const float c2 = p.scale * BaseE2::kScoreMul;
  Ring<T::kStages> ring{sm + L::kRing, L::kSlabTile, bars};
  float dk[kN][T::kOM][T::kON], dv[kN][T::kOM][T::kON];
#pragma unroll
  for (int w = 0; w < kN; ++w)
#pragma unroll
    for (int i = 0; i < T::kOM; ++i)
#pragma unroll
      for (int j = 0; j < T::kON; ++j) dk[w][i][j] = dv[w][i][j] = 0.f;
  for (int t = 0; t < heads * n_qt; ++t) {
    const int h = h0 + t / n_qt, qt = i0 + t % n_qt;
    const long long stat = ((long long)b * p.H + h) * p.S;
    float lse2[T::kSN], dlt[T::kSN];
#pragma unroll
    for (int j = 0; j < T::kSN; ++j) {
      const int qpos = qt * T::kInner + sc + 8 * j;
      lse2[j] =
          qpos < p.S ? __ldg(p.lse + stat + qpos) * BaseE2::kLseMul : 0.f;
      dlt[j] = qpos < p.S ? __ldg(p.delta + stat + qpos) : 0.f;
    }
    float s[T::kSM][T::kSN], dp[T::kSM][T::kSN];
#pragma unroll
    for (int i = 0; i < T::kSM; ++i)
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) s[i][j] = dp[i][j] = 0.f;
    const int g0 = t * kSteps;
#pragma unroll
    for (int w = 0; w < kN; ++w) {
      const float* d = ring.step(g0 + w, fetch);
      fma_nt<T::kSM, T::kSN, T::kSlab, L::kLdRes, L::kLdSlab>(
          dp, vs + w * T::kSlab, d + sc * L::kLdSlab);
    }
#pragma unroll
    for (int w = 0; w < kN; ++w) {
      const float* q = ring.step(g0 + kN + w, fetch);
      fma_nt<T::kSM, T::kSN, T::kSlab, L::kLdRes, L::kLdSlab>(
          s, ks + w * T::kSlab, q + sc * L::kLdSlab);
      if (w == kN - 1) {
        // P^T and dS^T of the tile, masked: q columns at or past S, and
        // those before the kv row when causal.
#pragma unroll
        for (int i = 0; i < T::kSM; ++i) {
          const int kpos = k0 + sr + 4 * i;
#pragma unroll
          for (int j = 0; j < T::kSN; ++j) {
            const int qpos = qt * T::kInner + sc + 8 * j;
            const bool keep = qpos < p.S && !(p.causal && kpos > qpos);
            const float pr =
                keep ? BaseE2::exp(fmaf(s[i][j], c2, -lse2[j])) : 0.f;
            const int at = (sr + 4 * i) * L::kLdP + sc + 8 * j;
            pt[at] = pr;
            dst[at] = pr * (dp[i][j] - dlt[j]);
          }
        }
        __syncthreads();
        fma_nn<T::kOM, T::kON, T::kInner, L::kLdP, L::kLdSlab>(
            dk[kN - 1], dst + orow * L::kLdP, q + ocol);
      }
    }
#pragma unroll
    for (int w = 0; w < kN - 1; ++w) {
      const float* q = ring.step(g0 + 2 * kN + w, fetch);
      fma_nn<T::kOM, T::kON, T::kInner, L::kLdP, L::kLdSlab>(
          dk[kN - 2 - w], dst + orow * L::kLdP, q + ocol);
    }
#pragma unroll
    for (int w = 0; w < kN; ++w) {
      const float* d = ring.step(g0 + 3 * kN - 1 + w, fetch);
      fma_nn<T::kOM, T::kON, T::kInner, L::kLdP, L::kLdSlab>(
          dv[w], pt + orow * L::kLdP, d + ocol);
    }
  }
  const long long ss = (long long)p.KVH * D;
  const long long off = ((long long)b * p.S * p.KVH + kvh) * D;
  const int row0 = k0 + orow;
  if (a.parts == 1) {
#pragma unroll
    for (int w = 0; w < kN; ++w) {
      const int c = w * T::kSlab + ocol;
      store_block(dv[w], 1.f, f32(p.dv) + off + c, ss, row0, p.S);
      store_block(dk[w], p.scale, f32(p.dk) + off + c, ss, row0, p.S);
    }
    return;
  }
  // This part's partials, then the kv tile's ticket: the CTA that takes
  // the last one sums every part, its own read back, in part order.
  const long long plane = (long long)a.batch * p.S * ss;
#pragma unroll
  for (int w = 0; w < kN; ++w) {
    const int c = w * T::kSlab + ocol;
    store_block(dv[w], 1.f, a.ws + part * plane + off + c, ss, row0, p.S);
    store_block(dk[w], 1.f, a.ws + (a.parts + part) * plane + off + c, ss,
                row0, p.S);
  }
  __threadfence();
  __syncthreads();
  volatile int* last = reinterpret_cast<int*>(sm + L::kStat);
  if (threadIdx.x == 0)
    *last = atomicAdd(a.tickets + bkv * ceil_div(p.S, T::kRows) + kt, 1) ==
            a.parts - 1;
  __syncthreads();
  if (*last) {
    __threadfence();
    sum_parts<D, T::kRows>(a, 0, 1.f, f32(p.dv), off, ss, k0);
    sum_parts<D, T::kRows>(a, 1, p.scale, f32(p.dk), off, ss, k0);
  }
}

// ----------------------------------------------------------------------
// Past head_dim 512 (768 ... 2048, every multiple of kWideChunk): a
// resident tile of 64 rows of D fp32 columns would pass the block's shared
// memory on its own, and a row's output (o, dq, dk, dv) the registers. So
// the output is split in n = D / kWideChunk column chunks, one CTA each
// (block i: chunk i % n of work item i / n; no cluster), and nothing is
// resident: each step of the ring brings a slab of both operands of S
// (dP, S^T, dP^T), the resident side's kRows rows and the streamed side's
// kInner rows of kSlab columns (two TMA boxes on one barrier), so the
// chunk's CTA forms S over all D columns itself, then a slab of the
// streamed operand's chunk for each output slab. Every chunk's CTA of an
// item forms the same S, m, l and P bit for bit (the same sums in the
// same order): (n + 1) / 2 times the forward's minimal FLOPs, n + 2 / 3
// times dq's and (n + 1) / 2 times dk/dv's (at 1024: 2.5x, 4.3x, 2.5x).
struct WideTiles {
  static constexpr int kRows = 64, kInner = 64, kSlab = 64, kStages = 4;
  static constexpr int kSM = 4, kSN = 4, kOM = 4, kON = 4;
};
constexpr int kWideChunk = 256;
constexpr int kWideOut = kWideChunk / WideTiles::kSlab;  // output slabs
static_assert(kWideChunk == sm90::kChunk,
              "the Hopper kernels' widths past 512 (sm90::cluster_width)");

// Shared memory of the wide kernels, in floats from a 128-byte aligned
// base: kPTiles tiles of P or dS (kRows rows of kInner + 8), the ring's
// slots (each the resident side's kRows rows, then the streamed side's
// kInner rows, of kSlab + 4), kStats floats a resident row; then kStages
// mbarriers.
template <int kPTiles, int kStats>
struct WideSmem {
  using T = WideTiles;
  static constexpr int kLdP = T::kInner + 8, kLdSlab = T::kSlab + 4;
  static constexpr int kPTile = T::kRows * kLdP;
  static constexpr int kA = T::kRows * kLdSlab;  // a slot's first part
  static constexpr int kSlot = kA + T::kInner * kLdSlab;
  static constexpr int kP = 0;
  static constexpr int kRing = kP + kPTiles * kPTile;
  static constexpr int kStat = kRing + T::kStages * kSlot;
  static constexpr int kBar = kStat + kStats * T::kRows;  // 8-byte aligned
  static constexpr int kBoxBytes = 4 * T::kRows * kLdSlab;  // a TMA box
  static constexpr int kBytes = 4 * kBar + 8 * T::kStages + 128;
  static_assert(T::kRows == T::kInner, "both sides' boxes of one shape");
  static_assert(kRing % 32 == 0 && kSlot % 32 == 0 && kA % 32 == 0,
                "128-byte aligned slots");
  static_assert(kBytes <= kMaxSmemBytes, "a CTA's tiles pass 227 KB");
  static_assert(kWideChunk % T::kSlab == 0, "slabs of a chunk");
};

// The wide kernels' ring: step g's slot on mbarrier g % kStages, filled by
// fetch(g); a step waits for its slot, meets the CTA and refills the
// previous step's slot (Ring's).
using WideRing = Ring<WideTiles::kStages>;
// Their fragments of S (dP, S^T, dP^T) and of an output slab, and their
// shared memory: the forward's P and the warps' row maxima and sums and
// the rows' rescale; dq's dS, lse and delta; dk/dv's P^T and dS^T and the
// ticket's flag.
using WideSF = Frag<WideTiles::kRows, WideTiles::kInner, WideTiles::kSM,
                    WideTiles::kSN>;
using WideOF = Frag<WideTiles::kRows, WideTiles::kSlab, WideTiles::kOM,
                    WideTiles::kON>;
using FwdWideSmem = WideSmem<1, WideSF::kWarpsN + 1>;
using DqWideSmem = WideSmem<1, 2>;
using DkvWideSmem = WideSmem<2, 1>;

// The forward past 512: o's chunk and (chunk 0) the natural-log lse. Per
// key tile, steps 0 .. ns - 1 bring slab w of Q (the item's q rows) and of
// K; steps ns .. ns + kWideOut - 1 slab u of V's chunk. The online softmax
// is flash_fwd_f32_kernel's.
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const F32Fwd a) {
  using T = WideTiles;
  using SF = WideSF;
  using OF = WideOF;
  using L = FwdWideSmem;
  constexpr int kWN = SF::kWarpsN;  // warps that share a row of S
  float* sm = aligned_smem();
  const FwdParams& p = a.p;
  const int n = p.D / kWideChunk, ns = p.D / T::kSlab;
  const int item = blockIdx.x / n, chunk = blockIdx.x % n;
  const int bh = a.work[2 * item], qt = a.work[2 * item + 1];
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KVH);
  const int q0 = qt * T::kRows;
  const int n_all = ceil_div(p.S, T::kInner);
  const int n_kt = p.causal
                       ? min(n_all, (q0 + T::kRows - 1) / T::kInner + 1)
                       : n_all;
  const int steps = ns + kWideOut;  // ring steps a key tile
  const int total = n_kt * steps;
  const uint32_t bars = smem_addr(sm + L::kBar);
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::kStages; ++i) sm90::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const auto fetch = [&](int g) {
    if (g >= total || threadIdx.x != 0) return;
    const int t = g / steps, w = g % steps;
    const uint32_t bar = bars + 8 * (g % T::kStages);
    float* slot = sm + L::kRing + (g % T::kStages) * L::kSlot;
    if (w < ns) {
      sm90::mbar_expect_tx(bar, 2 * L::kBoxBytes);
      sm90::tma_load_4d(slot, &tq, bar, w * T::kSlab, q0, h, b);
      sm90::tma_load_4d(slot + L::kA, &tk, bar, w * T::kSlab, t * T::kInner,
                        kvh, b);
    } else {
      sm90::mbar_expect_tx(bar, L::kBoxBytes);
      sm90::tma_load_4d(slot + L::kA, &tv, bar,
                        chunk * kWideChunk + (w - ns) * T::kSlab,
                        t * T::kInner, kvh, b);
    }
  };
#pragma unroll
  for (int g = 0; g < T::kStages - 1; ++g) fetch(g);
  const int sr = SF::row0(), sc = SF::col0();
  const int orow = OF::row0(), ocol = OF::col4();
  const int wn = threadIdx.x / 32 % kWN, lane = threadIdx.x % 32;
  const bool row_leader = wn == 0 && lane % 8 == 0;
  float* pb = sm + L::kP;
  float* red = sm + L::kStat;             // kWN x kRows
  float* rescale = red + kWN * T::kRows;  // kRows
  const float c2 = p.scale * BaseE2::kScoreMul;
  WideRing ring{sm + L::kRing, L::kSlot, bars};
  float m[T::kSM], l[T::kSM];
#pragma unroll
  for (int i = 0; i < T::kSM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float acc[kWideOut][T::kOM][T::kON];
#pragma unroll
  for (int w = 0; w < kWideOut; ++w)
#pragma unroll
    for (int i = 0; i < T::kOM; ++i)
#pragma unroll
      for (int j = 0; j < T::kON; ++j) acc[w][i][j] = 0.f;
  for (int t = 0; t < n_kt; ++t) {
    float s[T::kSM][T::kSN];
#pragma unroll
    for (int i = 0; i < T::kSM; ++i)
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) s[i][j] = 0.f;
    const int g0 = t * steps;
    for (int w = 0; w < ns; ++w) {
      const float* slot = ring.step(g0 + w, fetch);
      fma_nt<T::kSM, T::kSN, T::kSlab, L::kLdSlab, L::kLdSlab>(
          s, slot + sr * L::kLdSlab, slot + L::kA + sc * L::kLdSlab);
    }
    // The tile's scores in base 2, masked (key columns at or past S, and
    // above the diagonal when causal), and each row's maximum.
    float mx[T::kSM];
#pragma unroll
    for (int i = 0; i < T::kSM; ++i) {
      const int qpos = q0 + sr + 4 * i;
      mx[i] = -INFINITY;
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) {
        const int kpos = t * T::kInner + sc + 8 * j;
        const bool keep = kpos < p.S && !(p.causal && kpos > qpos);
        s[i][j] = keep ? s[i][j] * c2 : -INFINITY;
        mx[i] = fmaxf(mx[i], s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
    }
    if (lane % 8 == 0)
#pragma unroll
      for (int i = 0; i < T::kSM; ++i) red[wn * T::kRows + sr + 4 * i] = mx[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < T::kSM; ++i)
#pragma unroll
      for (int u = 0; u < kWN; ++u)
        mx[i] = fmaxf(mx[i], red[u * T::kRows + sr + 4 * i]);
    // P and the rows' rescale, for the products below (the next ring
    // step's barrier publishes them).
#pragma unroll
    for (int i = 0; i < T::kSM; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      const float alpha = BaseE2::exp(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) {
        const float pr = BaseE2::exp(s[i][j] - m_new);
        pb[(sr + 4 * i) * L::kLdP + sc + 8 * j] = pr;
        sum += pr;
      }
      l[i] = fmaf(l[i], alpha, sum);
      if (row_leader) rescale[sr + 4 * i] = alpha;
    }
#pragma unroll
    for (int w = 0; w < kWideOut; ++w) {
      const float* v = ring.step(g0 + ns + w, fetch) + L::kA;
      if (w == 0) {
#pragma unroll
        for (int i = 0; i < T::kOM; ++i) {
          const float alpha = rescale[orow + 4 * i];
#pragma unroll
          for (int u = 0; u < kWideOut; ++u)
#pragma unroll
            for (int j = 0; j < T::kON; ++j) acc[u][i][j] *= alpha;
        }
      }
      fma_nn<T::kOM, T::kON, T::kInner, L::kLdP, L::kLdSlab>(
          acc[w], pb + orow * L::kLdP, v + ocol);
    }
  }
  // Each row's sum over its threads (the lanes, then the warps, in a
  // fixed order), 1 / l for o and the natural-log lse.
#pragma unroll
  for (int i = 0; i < T::kSM; ++i)
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
  __syncthreads();  // every read of red and rescale is done
  if (lane % 8 == 0)
#pragma unroll
    for (int i = 0; i < T::kSM; ++i) red[wn * T::kRows + sr + 4 * i] = l[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::kSM; ++i) {
    l[i] = red[sr + 4 * i];
#pragma unroll
    for (int u = 1; u < kWN; ++u) l[i] += red[u * T::kRows + sr + 4 * i];
  }
  const long long stat = ((long long)b * p.H + h) * p.S;
  if (row_leader) {
#pragma unroll
    for (int i = 0; i < T::kSM; ++i) {
      const int row = q0 + sr + 4 * i;
      rescale[sr + 4 * i] = 1.f / l[i];
      if (chunk == 0 && row < p.S)
        p.lse[stat + row] = (m[i] + log2f(l[i])) * kLn2;
    }
  }
  __syncthreads();
  float* og = f32(p.o) + ((long long)b * p.S * p.H + h) * p.D +
              chunk * kWideChunk;
  const long long ss = (long long)p.H * p.D;
#pragma unroll
  for (int i = 0; i < T::kOM; ++i) {
    const float inv = rescale[orow + 4 * i];
#pragma unroll
    for (int w = 0; w < kWideOut; ++w)
#pragma unroll
      for (int j = 0; j < T::kON; ++j) acc[w][i][j] *= inv;
  }
#pragma unroll
  for (int w = 0; w < kWideOut; ++w)
    store_block(acc[w], 1.f, og + w * T::kSlab + ocol, ss, q0 + orow, p.S);
}

// dq past 512: dq's chunk and (chunk 0) delta = rowsum(dO * O), a warp a
// row over all D columns from global memory. Per key tile, steps 0 .. ns -
// 1 bring slab w of dO and of V (dP), ns .. 2 ns - 1 slab w of Q and of K
// (S); dS = P (dP - delta) into shared memory; then kWideOut steps slab u
// of K's chunk (dq += dS K).
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_f32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const F32Dq a) {
  using T = WideTiles;
  using L = DqWideSmem;
  using SF = WideSF;
  using OF = WideOF;
  float* sm = aligned_smem();
  const BwdParams& p = a.p;
  const int n = p.D / kWideChunk, ns = p.D / T::kSlab;
  const int item = blockIdx.x / n, chunk = blockIdx.x % n;
  const int bh = a.work[2 * item], qt = a.work[2 * item + 1];
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KVH);
  const int q0 = qt * T::kRows;
  const int n_all = ceil_div(p.S, T::kInner);
  const int n_kt = p.causal
                       ? min(n_all, (q0 + T::kRows - 1) / T::kInner + 1)
                       : n_all;
  const int steps = 2 * ns + kWideOut;
  const int total = n_kt * steps;
  const uint32_t bars = smem_addr(sm + L::kBar);
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::kStages; ++i) sm90::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const auto fetch = [&](int g) {
    if (g >= total || threadIdx.x != 0) return;
    const int t = g / steps, w = g % steps;
    const uint32_t bar = bars + 8 * (g % T::kStages);
    float* slot = sm + L::kRing + (g % T::kStages) * L::kSlot;
    if (w < 2 * ns) {
      const bool dp = w < ns;
      const int col = (dp ? w : w - ns) * T::kSlab;
      sm90::mbar_expect_tx(bar, 2 * L::kBoxBytes);
      sm90::tma_load_4d(slot, dp ? &tdo : &tq, bar, col, q0, h, b);
      sm90::tma_load_4d(slot + L::kA, dp ? &tv : &tk, bar, col,
                        t * T::kInner, kvh, b);
    } else {
      sm90::mbar_expect_tx(bar, L::kBoxBytes);
      sm90::tma_load_4d(slot + L::kA, &tk, bar,
                        chunk * kWideChunk + (w - 2 * ns) * T::kSlab,
                        t * T::kInner, kvh, b);
    }
  };
#pragma unroll
  for (int g = 0; g < T::kStages - 1; ++g) fetch(g);
  // delta = rowsum(dO * O), a warp a row; lse into base 2 (BaseE2).
  const long long stat = ((long long)b * p.H + h) * p.S;
  const float* og = f32(p.o) + b * p.o_sb + h * p.o_sh;
  const float* dog = f32(p.dout) + b * p.do_sb + h * p.do_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < T::kRows; r += kWarps) {
    const int row = q0 + r;
    float s = 0.f;
    if (row < p.S) {
      for (int c = 4 * lane; c < p.D; c += 128) {
        const float4 o =
            __ldg(reinterpret_cast<const float4*>(og + row * p.o_ss + c));
        const float4 d =
            __ldg(reinterpret_cast<const float4*>(dog + row * p.do_ss + c));
        s = fmaf(d.x, o.x, s);
        s = fmaf(d.y, o.y, s);
        s = fmaf(d.z, o.z, s);
        s = fmaf(d.w, o.w, s);
      }
    }
    s = warp_sum(s);
    if (lane == 0) {
      sm[L::kStat + r] =
          row < p.S ? p.lse[stat + row] * BaseE2::kLseMul : 0.f;
      sm[L::kStat + T::kRows + r] = s;
      if (chunk == 0 && row < p.S) p.delta[stat + row] = s;
    }
  }
  __syncthreads();
  const int sr = SF::row0(), sc = SF::col0();
  const int orow = OF::row0(), ocol = OF::col4();
  float lse2[T::kSM], dlt[T::kSM];
#pragma unroll
  for (int i = 0; i < T::kSM; ++i) {
    lse2[i] = sm[L::kStat + sr + 4 * i];
    dlt[i] = sm[L::kStat + T::kRows + sr + 4 * i];
  }
  float* ds = sm + L::kP;
  const float c2 = p.scale * BaseE2::kScoreMul;
  WideRing ring{sm + L::kRing, L::kSlot, bars};
  float acc[kWideOut][T::kOM][T::kON];
#pragma unroll
  for (int w = 0; w < kWideOut; ++w)
#pragma unroll
    for (int i = 0; i < T::kOM; ++i)
#pragma unroll
      for (int j = 0; j < T::kON; ++j) acc[w][i][j] = 0.f;
  for (int t = 0; t < n_kt; ++t) {
    float s[T::kSM][T::kSN], dp[T::kSM][T::kSN];
#pragma unroll
    for (int i = 0; i < T::kSM; ++i)
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) s[i][j] = dp[i][j] = 0.f;
    const int g0 = t * steps;
    for (int w = 0; w < ns; ++w) {
      const float* slot = ring.step(g0 + w, fetch);
      fma_nt<T::kSM, T::kSN, T::kSlab, L::kLdSlab, L::kLdSlab>(
          dp, slot + sr * L::kLdSlab, slot + L::kA + sc * L::kLdSlab);
    }
    for (int w = 0; w < ns; ++w) {
      const float* slot = ring.step(g0 + ns + w, fetch);
      fma_nt<T::kSM, T::kSN, T::kSlab, L::kLdSlab, L::kLdSlab>(
          s, slot + sr * L::kLdSlab, slot + L::kA + sc * L::kLdSlab);
    }
    // dS of the tile, masked: key columns at or past S, and above the
    // diagonal when causal (the next ring step's barrier publishes it).
#pragma unroll
    for (int i = 0; i < T::kSM; ++i) {
      const int qpos = q0 + sr + 4 * i;
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) {
        const int kpos = t * T::kInner + sc + 8 * j;
        const bool keep = kpos < p.S && !(p.causal && kpos > qpos);
        const float pr =
            keep ? BaseE2::exp(fmaf(s[i][j], c2, -lse2[i])) : 0.f;
        ds[(sr + 4 * i) * L::kLdP + sc + 8 * j] = pr * (dp[i][j] - dlt[i]);
      }
    }
#pragma unroll
    for (int w = 0; w < kWideOut; ++w) {
      const float* k = ring.step(g0 + 2 * ns + w, fetch) + L::kA;
      fma_nn<T::kOM, T::kON, T::kInner, L::kLdP, L::kLdSlab>(
          acc[w], ds + orow * L::kLdP, k + ocol);
    }
  }
  float* dqg = f32(p.dq) + ((long long)b * p.S * p.H + h) * p.D +
               chunk * kWideChunk;
  const long long ss = (long long)p.H * p.D;
#pragma unroll
  for (int w = 0; w < kWideOut; ++w)
    store_block(acc[w], p.scale, dqg + w * T::kSlab + ocol, ss, q0 + orow,
                p.S);
}

// dk/dv past 512: the chunk of dk and dv of a kv tile, for each of its
// part's G / parts heads over its q tiles from the causal start. Per q
// tile, steps 0 .. ns - 1 bring slab w of V (the kv rows) and of dO (dP^T),
// ns .. 2 ns - 1 slab w of K and of Q (S^T); P^T and dS^T into shared
// memory; then kWideOut steps slab u of Q's chunk (dk += dS^T Q) and
// kWideOut of dO's (dv += P^T dO). The GQA parts are flash_dkv_f32_kernel's,
// ticketed per kv tile and chunk.
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_f32_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const F32Dkv a) {
  using T = WideTiles;
  using L = DkvWideSmem;
  using SF = WideSF;
  using OF = WideOF;
  float* sm = aligned_smem();
  const BwdParams& p = a.p;
  const int n = p.D / kWideChunk, ns = p.D / T::kSlab;
  const int* item = a.work + 3 * (blockIdx.x / n);
  const int chunk = blockIdx.x % n;
  const int bkv = item[0], kt = item[1], part = item[2];
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  const int heads = p.H / p.KVH / a.parts;
  const int h0 = kvh * (p.H / p.KVH) + part * heads;
  const int k0 = kt * T::kRows;
  // Causal: q tiles from the one that holds row k0.
  const int i0 = p.causal ? k0 / T::kInner : 0;
  const int n_qt = ceil_div(p.S, T::kInner) - i0;
  const int steps = 2 * ns + 2 * kWideOut;
  const int total = heads * n_qt * steps;
  const uint32_t bars = smem_addr(sm + L::kBar);
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::kStages; ++i) sm90::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const auto fetch = [&](int g) {
    if (g >= total || threadIdx.x != 0) return;
    const int t = g / steps, w = g % steps;
    const int h = h0 + t / n_qt, qrow = (i0 + t % n_qt) * T::kInner;
    const uint32_t bar = bars + 8 * (g % T::kStages);
    float* slot = sm + L::kRing + (g % T::kStages) * L::kSlot;
    if (w < 2 * ns) {
      const bool dp = w < ns;
      const int col = (dp ? w : w - ns) * T::kSlab;
      sm90::mbar_expect_tx(bar, 2 * L::kBoxBytes);
      sm90::tma_load_4d(slot, dp ? &tv : &tk, bar, col, k0, kvh, b);
      sm90::tma_load_4d(slot + L::kA, dp ? &tdo : &tq, bar, col, qrow, h, b);
    } else {
      const bool dk = w < 2 * ns + kWideOut;
      const int u = w - 2 * ns - (dk ? 0 : kWideOut);
      sm90::mbar_expect_tx(bar, L::kBoxBytes);
      sm90::tma_load_4d(slot + L::kA, dk ? &tq : &tdo, bar,
                        chunk * kWideChunk + u * T::kSlab, qrow, h, b);
    }
  };
#pragma unroll
  for (int g = 0; g < T::kStages - 1; ++g) fetch(g);
  const int sr = SF::row0(), sc = SF::col0();
  const int orow = OF::row0(), ocol = OF::col4();
  float* pt = sm + L::kP;
  float* dst = pt + L::kPTile;
  const float c2 = p.scale * BaseE2::kScoreMul;
  WideRing ring{sm + L::kRing, L::kSlot, bars};
  float dk[kWideOut][T::kOM][T::kON], dv[kWideOut][T::kOM][T::kON];
#pragma unroll
  for (int w = 0; w < kWideOut; ++w)
#pragma unroll
    for (int i = 0; i < T::kOM; ++i)
#pragma unroll
      for (int j = 0; j < T::kON; ++j) dk[w][i][j] = dv[w][i][j] = 0.f;
  for (int t = 0; t < heads * n_qt; ++t) {
    const int h = h0 + t / n_qt, qt = i0 + t % n_qt;
    const long long stat = ((long long)b * p.H + h) * p.S;
    float lse2[T::kSN], dlt[T::kSN];
#pragma unroll
    for (int j = 0; j < T::kSN; ++j) {
      const int qpos = qt * T::kInner + sc + 8 * j;
      lse2[j] =
          qpos < p.S ? __ldg(p.lse + stat + qpos) * BaseE2::kLseMul : 0.f;
      dlt[j] = qpos < p.S ? __ldg(p.delta + stat + qpos) : 0.f;
    }
    float s[T::kSM][T::kSN], dp[T::kSM][T::kSN];
#pragma unroll
    for (int i = 0; i < T::kSM; ++i)
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) s[i][j] = dp[i][j] = 0.f;
    const int g0 = t * steps;
    for (int w = 0; w < ns; ++w) {
      const float* slot = ring.step(g0 + w, fetch);
      fma_nt<T::kSM, T::kSN, T::kSlab, L::kLdSlab, L::kLdSlab>(
          dp, slot + sr * L::kLdSlab, slot + L::kA + sc * L::kLdSlab);
    }
    for (int w = 0; w < ns; ++w) {
      const float* slot = ring.step(g0 + ns + w, fetch);
      fma_nt<T::kSM, T::kSN, T::kSlab, L::kLdSlab, L::kLdSlab>(
          s, slot + sr * L::kLdSlab, slot + L::kA + sc * L::kLdSlab);
    }
    // P^T and dS^T of the tile, masked: q columns at or past S, and those
    // before the kv row when causal.
#pragma unroll
    for (int i = 0; i < T::kSM; ++i) {
      const int kpos = k0 + sr + 4 * i;
#pragma unroll
      for (int j = 0; j < T::kSN; ++j) {
        const int qpos = qt * T::kInner + sc + 8 * j;
        const bool keep = qpos < p.S && !(p.causal && kpos > qpos);
        const float pr =
            keep ? BaseE2::exp(fmaf(s[i][j], c2, -lse2[j])) : 0.f;
        const int at = (sr + 4 * i) * L::kLdP + sc + 8 * j;
        pt[at] = pr;
        dst[at] = pr * (dp[i][j] - dlt[j]);
      }
    }
#pragma unroll
    for (int w = 0; w < kWideOut; ++w) {
      const float* q = ring.step(g0 + 2 * ns + w, fetch) + L::kA;
      fma_nn<T::kOM, T::kON, T::kInner, L::kLdP, L::kLdSlab>(
          dk[w], dst + orow * L::kLdP, q + ocol);
    }
#pragma unroll
    for (int w = 0; w < kWideOut; ++w) {
      const float* d = ring.step(g0 + 2 * ns + kWideOut + w, fetch) + L::kA;
      fma_nn<T::kOM, T::kON, T::kInner, L::kLdP, L::kLdSlab>(
          dv[w], pt + orow * L::kLdP, d + ocol);
    }
  }
  const long long ss = (long long)p.KVH * p.D;
  const long long off =
      ((long long)b * p.S * p.KVH + kvh) * p.D + chunk * kWideChunk;
  const int row0 = k0 + orow;
  if (a.parts == 1) {
#pragma unroll
    for (int w = 0; w < kWideOut; ++w) {
      const int c = w * T::kSlab + ocol;
      store_block(dv[w], 1.f, f32(p.dv) + off + c, ss, row0, p.S);
      store_block(dk[w], p.scale, f32(p.dk) + off + c, ss, row0, p.S);
    }
    return;
  }
  // This part's partials of the chunk, then the (kv tile, chunk)'s ticket:
  // the CTA that takes the last one sums every part, its own read back,
  // in part order.
  const long long plane = (long long)a.batch * p.S * ss;
#pragma unroll
  for (int w = 0; w < kWideOut; ++w) {
    const int c = w * T::kSlab + ocol;
    store_block(dv[w], 1.f, a.ws + part * plane + off + c, ss, row0, p.S);
    store_block(dk[w], 1.f, a.ws + (a.parts + part) * plane + off + c, ss,
                row0, p.S);
  }
  __threadfence();
  __syncthreads();
  volatile int* last = reinterpret_cast<int*>(sm + L::kStat);
  if (threadIdx.x == 0)
    *last = atomicAdd(a.tickets +
                          (bkv * ceil_div(p.S, T::kRows) + kt) * n + chunk,
                      1) == a.parts - 1;
  __syncthreads();
  if (*last) {
    __threadfence();
    sum_parts<kWideChunk, T::kRows>(a, 0, 1.f, f32(p.dv), off, ss, k0);
    sum_parts<kWideChunk, T::kRows>(a, 1, p.scale, f32(p.dk), off, ss, k0);
  }
}

// A map of a (B, S, heads, D) fp32 tensor at ptr with element strides
// (sb, ss, sh, 1), as dimensions (D, S, heads, B) innermost first: boxes of
// `cols` columns x `rows` rows of one head, unswizzled, so a box lands as
// `rows` rows of `cols` floats; columns and rows past the tensor's read as
// zeros.
inline int encode_f32_rows(CUtensorMap* map, const void* ptr, int D, int S,
                           int heads, int B, long long ss, long long sh,
                           long long sb, int cols, int rows) {
  const sm90::TensorMapEncodeTiled encode = sm90::tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 4, (cuuint64_t)sh * 4,
                                 (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : sm90::kTensorMapError + (int)r;
}

// Launches a kernel that streams K and V against resident q rows (the
// forward, dq) with tiles T and kBytes of shared memory: `rows` (B * H)
// rows of work items, ceil(S / kRows) each, one CTA an item, with K's and
// V's maps.
template <class T, int kBytes, int D, class A>
int launch_kv(void (*kernel)(CUtensorMap, CUtensorMap, A), int rows, int S,
              cudaStream_t stream, const A& a) {
  const auto& p = a.p;
  CUtensorMap tk, tv;
  int err = encode_f32_rows(&tk, p.k, D, S, p.KVH, a.batch, p.k_ss, p.k_sh,
                            p.k_sb, T::kSlab + 4, T::kInner);
  if (!err)
    err = encode_f32_rows(&tv, p.v, D, S, p.KVH, a.batch, p.v_ss, p.v_sh,
                          p.v_sb, T::kSlab + 4, T::kInner);
  if (!err) err = (int)allow_smem(kernel, kBytes);
  if (err) return err;
  kernel<<<rows * ceil_div(S, T::kRows), kThreads, kBytes, stream>>>(
      tk, tv, a);
  return (int)cudaGetLastError();
}

// The fp32 forward at head_dim D (FwdTiles).
template <int D>
int launch_f32(void (*kernel)(CUtensorMap, CUtensorMap, F32Fwd), int rows,
               int S, cudaStream_t stream, const F32Fwd& a) {
  return launch_kv<FwdTiles<D>, FwdSmem<D>::kBytes, D>(kernel, rows, S,
                                                       stream, a);
}

// The fp32 dq at head_dim D (DqTiles).
template <int D>
int launch_f32(void (*kernel)(CUtensorMap, CUtensorMap, F32Dq), int rows,
               int S, cudaStream_t stream, const F32Dq& a) {
  return launch_kv<DqTiles<D>, TileSmem<DqTiles<D>, D, 1>::kBytes, D>(
      kernel, rows, S, stream, a);
}

// Launches the fp32 dk/dv at head_dim D: `rows` (B * KVH * parts) rows of
// work items, ceil(S / kRows) each, one CTA an item, with Q's and dO's
// maps.
template <int D>
int launch_f32(void (*kernel)(CUtensorMap, CUtensorMap, F32Dkv), int rows,
               int S, cudaStream_t stream, const F32Dkv& a) {
  using T = DkvTiles<D>;
  constexpr int kBytes = TileSmem<T, D, 2>::kBytes;
  const BwdParams& p = a.p;
  CUtensorMap tq, tdo;
  int err = encode_f32_rows(&tq, p.q, D, S, p.H, a.batch, p.q_ss, p.q_sh,
                            p.q_sb, T::kSlab + 4, T::kInner);
  if (!err)
    err = encode_f32_rows(&tdo, p.dout, D, S, p.H, a.batch, p.do_ss,
                          p.do_sh, p.do_sb, T::kSlab + 4, T::kInner);
  if (!err) err = (int)allow_smem(kernel, kBytes);
  if (err) return err;
  kernel<<<rows * ceil_div(S, T::kRows), kThreads, kBytes, stream>>>(
      tq, tdo, a);
  return (int)cudaGetLastError();
}

// A map of a wide kernel (past head_dim 512): the (B, S, heads, p.D) fp32
// tensor at ptr with element strides (sb, ss, sh, 1) in boxes of kRows
// rows x kSlab + 4 columns.
template <class P>
int encode_wide(CUtensorMap* map, const void* ptr, int heads, long long sb,
                long long ss, long long sh, const P& p, int batch) {
  return encode_f32_rows(map, ptr, p.D, p.S, heads, batch, ss, sh, sb,
                         WideTiles::kSlab + 4, WideTiles::kRows);
}

// The blocks of a wide kernel's launch: `rows` rows of work items,
// ceil(S / kRows) each, D / kWideChunk CTAs an item.
template <class P>
int wide_blocks(int rows, const P& p) {
  return rows * ceil_div(p.S, WideTiles::kRows) * (p.D / kWideChunk);
}

// The fp32 forward past 512 over `rows` (B * H) rows of work items.
int launch_fwd_f32_wide(int rows, cudaStream_t stream, const F32Fwd& a) {
  const FwdParams& p = a.p;
  constexpr int kBytes = FwdWideSmem::kBytes;
  CUtensorMap tq, tk, tv;
  int err = encode_wide(&tq, p.q, p.H, p.q_sb, p.q_ss, p.q_sh, p, a.batch);
  if (!err)
    err = encode_wide(&tk, p.k, p.KVH, p.k_sb, p.k_ss, p.k_sh, p, a.batch);
  if (!err)
    err = encode_wide(&tv, p.v, p.KVH, p.v_sb, p.v_ss, p.v_sh, p, a.batch);
  if (!err) err = (int)allow_smem(flash_fwd_f32_wide_kernel, kBytes);
  if (err) return err;
  flash_fwd_f32_wide_kernel<<<wide_blocks(rows, p), kThreads, kBytes,
                              stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// The maps of the backward past 512 (Q and dO, K and V), then its launch.
template <class A>
int launch_bwd_f32_wide(void (*kernel)(CUtensorMap, CUtensorMap,
                                       CUtensorMap, CUtensorMap, A),
                        int bytes, int rows, cudaStream_t stream,
                        const A& a) {
  const BwdParams& p = a.p;
  CUtensorMap tq, tdo, tk, tv;
  int err = encode_wide(&tq, p.q, p.H, p.q_sb, p.q_ss, p.q_sh, p, a.batch);
  if (!err)
    err = encode_wide(&tdo, p.dout, p.H, p.do_sb, p.do_ss, p.do_sh, p,
                      a.batch);
  if (!err)
    err = encode_wide(&tk, p.k, p.KVH, p.k_sb, p.k_ss, p.k_sh, p, a.batch);
  if (!err)
    err = encode_wide(&tv, p.v, p.KVH, p.v_sb, p.v_ss, p.v_sh, p, a.batch);
  if (!err) err = (int)allow_smem(kernel, bytes);
  if (err) return err;
  kernel<<<wide_blocks(rows, p), kThreads, bytes, stream>>>(tq, tdo, tk, tv,
                                                            a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace stpu

// Launches KERNEL<64>, KERNEL<128>, KERNEL<256> or KERNEL<512> over ROWS
// rows of blocks.
#define STPU_F32_BY_D(HEAD_DIM, KERNEL, ROWS, STREAM, P)                    \
  do {                                                                      \
    if ((HEAD_DIM) == 64)                                                   \
      return launch_f32<64>(KERNEL<64>, (ROWS), S, (STREAM), (P));          \
    if ((HEAD_DIM) == 128)                                                  \
      return launch_f32<128>(KERNEL<128>, (ROWS), S, (STREAM), (P));        \
    if ((HEAD_DIM) == 256)                                                  \
      return launch_f32<256>(KERNEL<256>, (ROWS), S, (STREAM), (P));        \
    if ((HEAD_DIM) == 512)                                                  \
      return launch_f32<512>(KERNEL<512>, (ROWS), S, (STREAM), (P));        \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

// strides: (batch, seq, head) in elements for q, k, v. work: the
// forward's list, ceil(S / kRows) (b * H + h, q tile) pairs a row, longest
// first. o (B, S, H, D) and lse (B, H, S), natural log, are written
// contiguous, fp32.
extern "C" int stpu_flash_fwd_f32(const void* q, const void* k,
                                  const void* v, void* o, void* lse,
                                  const void* work, const long long* strides,
                                  int B, int S, int H, int KVH, int D,
                                  float scale, int causal, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const F32Fwd a = {
      fwd_params(q, k, v, o, lse, strides, S, H, KVH, scale, causal, D),
      static_cast<const int*>(work), B};
  if (sm90::cluster_width(D))
    return launch_fwd_f32_wide(B * H, static_cast<cudaStream_t>(stream), a);
  STPU_F32_BY_D(D, flash_fwd_f32_kernel, B * H,
                static_cast<cudaStream_t>(stream), a);
}

// strides: q, k, v, o, dO. work: dq's list, ceil(S / kRows) (b * H + h,
// q tile) pairs a row, longest first. dq (B, S, H, D) and delta (B, H, S)
// are written contiguous, fp32.
extern "C" int stpu_flash_dq_f32(const void* q, const void* k,
                                 const void* v, const void* o,
                                 const void* dout, const void* lse, void* dq,
                                 void* delta, const void* work,
                                 const long long* strides, int B, int S,
                                 int H, int KVH, int D, float scale,
                                 int causal, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const F32Dq a = {bwd_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                              nullptr, strides, S, H, KVH, scale, causal, D),
                   static_cast<const int*>(work), B};
  if (sm90::cluster_width(D))
    return launch_bwd_f32_wide(flash_dq_f32_wide_kernel, DqWideSmem::kBytes,
                               B * H, static_cast<cudaStream_t>(stream), a);
  STPU_F32_BY_D(D, flash_dq_f32_kernel, B * H,
                static_cast<cudaStream_t>(stream), a);
}

// strides: q, k, v, dO. work: dk/dv's list, ceil(S / kRows) (b * KVH +
// kvh, kv tile, part) triples a row and part, longest first; with parts >
// 1, ws (2, parts, B, S, KVH, D) fp32 and tickets, one int a kv tile,
// zeroed (else null). dk and dv (B, S, KVH, D) are written contiguous,
// fp32.
extern "C" int stpu_flash_dkv_f32(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, const void* work,
                                  void* ws, void* tickets,
                                  const long long* strides, int B, int S,
                                  int H, int KVH, int D, float scale,
                                  int causal, int parts, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH || parts < 1 || (H / KVH) % parts)
    return (int)cudaErrorInvalidValue;
  const F32Dkv a = {bwd_params(q, k, v, nullptr, dout, lse, delta, nullptr,
                               dk, dv, strides, S, H, KVH, scale, causal, D),
                    static_cast<const int*>(work), static_cast<float*>(ws),
                    static_cast<int*>(tickets), parts, B};
  if (sm90::cluster_width(D))
    return launch_bwd_f32_wide(flash_dkv_f32_wide_kernel,
                               DkvWideSmem::kBytes, B * KVH * parts,
                               static_cast<cudaStream_t>(stream), a);
  STPU_F32_BY_D(D, flash_dkv_f32_kernel, B * KVH * parts,
                static_cast<cudaStream_t>(stream), a);
}
