// The Hopper-native flash-attention backward (sm_90a): wgmma + TMA, warp
// specialised, on the forward's machinery (flash_fwd_sm90.cuh: mbarriers,
// TMA loads, setmaxnreg, the wgmma helpers, encode_rows). Two bodies, the
// split backward of the TPU kernels:
//
// - dq_cta: dq = scale * sum_k dS K, dS = P * (dP - delta), P =
//   exp(sm * q k^T - lse), dP = dO V^T; it also computes delta =
//   rowsum(dO * O) and writes it for dk/dv.
// - dkv_cta: dv = sum P^T dO and dk = scale * sum dS^T Q, summed over the
//   GQA group of query heads h / (H / KVH) == kvh in registers: no
//   atomics, deterministic.
//
// Both are templates over D (64, 128), the element type T (bf16, f16:
// the inputs', P's and dS's before their products, and the outputs') and
// the softmax base (Base2: exp2 with a base-2 lse, sm = scale * log2(e)
// folded into the one FFMA each score takes; BaseE: natural exp and lse;
// BaseE2, dq only: a natural-log lse scaled into base 2 once per row,
// then exp2 as Base2);
// the mask is the runtime TileMask (causal, and key columns at or past S).
// flash_tri.cu instantiates them in base 2, causal, as flash_dq_tri_kernel
// and flash_dkv_tri_kernel; flash_bwd.cu in natural exp, with the runtime
// causal flag, as flash_dq_kernel and flash_dkv_kernel (the resident
// family); flash_streamed.cu instantiates both once more, as flash_bwd.cu
// does, as flash_dq_streamed_kernel (in BaseE2, with Q and dO held in
// registers, kRegA = 2) and flash_dkv_streamed_kernel: every backward
// kernel of the 16-bit path is one of these two bodies.
//
// What bounds them: the tensor cores (at S 8192, D 128 ~S*D/2 flops per
// byte they must move, far past the ~295 flop/byte ridge). Design:
//
// - One CTA per 128-row tile of the resident operand (dq: q rows of one
//   (b, h); dk/dv: kv rows of one (b, kv head)), walking a host-built
//   longest-first work list (ops/flash_attention.py: tri_schedule; a
//   non-causal launch walks the same list, whose items then cost the
//   same). 384
//   threads: a producer warpgroup (setmaxnreg 40; one thread issues every
//   TMA load) and two consumer warpgroups (setmaxnreg 232) of 64 resident
//   rows each, as in the forward.
// - dq: the producer loads Q and dO (128 rows) once, then 64-row K and V
//   tiles into a ring of kBwdRing stages (full and empty mbarrier per
//   stage). Per tile each consumer runs S = Q K^T and dP = dO V^T as
//   wgmma m64n64k16, dS on the accumulator fragments, then dq += dS K
//   with dS as the register A operand and K read MN-major (tnspB = 1):
//   the forward's P V with K in V's place. S and dP read both operands
//   from shared memory (K-major), or, with kRegA, Q (1) or Q and dO (2)
//   from registers, loaded once from the swizzled tile (ldmatrix) into
//   A fragments: an m64n64k16 with both operands in shared memory reads
//   4 KB per 131 kFLOP, 128 B a clock at the tensor cores' peak, all
//   that shared memory gives an SM; with A in registers it reads half.
// - dk/dv: the producer loads K and V (128 rows) once, then, for each
//   query head of the group and each 64-row q tile from the causal start
//   (0 when not causal), Q, dO and the tile's lse and delta into the
//   ring. Per tile each
//   consumer runs S^T = K Q^T and dP^T = V dO^T (m64n64, shared memory,
//   K-major), P^T and dS^T on the fragments (their C layout is the A
//   fragment of the next products), then dv += P^T dO and dk += dS^T Q
//   with dO and Q read MN-major from the same stage.
// - Registers: dq holds dq (D / 2 fp32 a thread), S and dP (32 each) and
//   dS packed (16), plus with kRegA the A fragments of Q and dO (D / 4
//   each): 208 at D = 128 with both, under the consumers' 232; dk/dv
//   holds dk and dv (2 x D / 2) beside S^T and dP^T (2 x 32): 192
//   accumulator registers at D = 128.
// - Not done: a persistent grid; overlapping one tile's elementwise work
//   with the same consumer's next products (dk/dv would hold dk, dv, P^T,
//   dS^T, S^T and dP^T in flight, 224 registers a thread at D = 128:
//   ptxas serialises every wgmma for want of registers, at 232 and at
//   240). Running the two consumers half a tile apart on the forward's
//   ping-pong barriers (each tile's two batches of products in turn) was
//   correct, causal included, and no faster than lockstep (PERF.md).
//
// Traps, and what the code does about each:
// - Unequal tiles make the two consumers' causal bounds differ. dq, q
//   tile qt, 64-row KV tiles: consumer 0 (rows 128 qt + 0..63) ends on KV
//   tile 2 qt, its diagonal; consumer 1 on 2 qt + 1. dk/dv, KV tile kt,
//   64-row q tiles: q tile 2 kt is consumer 0's diagonal and lies wholly
//   above consumer 1's rows, so consumer 1 skips it (in every head of the
//   group) and masks 2 kt + 1. Each consumer decides its own MASK tile.
//   A consumer that skips a stage still waits for it to be full and then
//   arrives on its empty barrier: without the arrival the ring hangs, and
//   an arrival before the stage is full could complete the previous
//   phase early and let the producer overwrite a tile the other consumer
//   still reads.
// - Rows past S: TMA zero-fills Q, dO, K and V there. lse and delta past S
//   are finite: dq reads lse with a row < S predicate (else 0) and
//   computes delta 0 there; dk/dv loads them through a tensor map over
//   (S, B * H) that zero-fills. With q = dO = 0 such a column gives P = 1,
//   dP = 0, dS = 0: it adds exactly 0 to dk and dv, in either causal mode.
//   lse and delta are (B, H, S) fp32, so a bulk copy of a ragged last tile
//   would read the next head's values: the map's S dimension stops it.
//   Key columns past S: dq's non-causal loop masks its ragged last KV tile
//   (masked_tile), a causal one its diagonal (zero K rows would add 0 to dq
//   anyway; the mask keeps exp(-lse) out of dS). Both epilogues store only
//   rows < S.
// - A full barrier's transaction count is the whole boxes', rows past S
//   included.
// - Shared memory at D = 128: dq 2 x 32 KB (Q, dO) + kBwdRing x 32 KB
//   (64-row K and V) + 512 B delta; dk/dv 2 x 32 KB (K, V) + kBwdRing x
//   (32 KB + 512 B) (Q, dO, lse, delta): 129.6 KB each at 2 stages, under
//   227 KB. Every swizzled tile starts on a 1024-byte boundary. Plain
//   reads and writes of a swizzled tile (dq's delta, both epilogues)
//   apply the 128-byte swizzle: 16-byte chunk c of row R lies at chunk
//   c ^ (R % 8).
// - The forward's traps hold here too: wgmma.fence before each batch,
//   wait_group 0 and the "+f" register fence before accumulators are
//   read, tensor maps by value as __grid_constant__ parameters, two
//   64-column boxes per 128-wide row.
#pragma once

#include "flash_fwd_sm90.cuh"

namespace stpu {
namespace sm90 {

// The forward's roles (kFwdThreads; setmaxnreg kProducerRegs and
// kConsumerRegs) and its resident tile, so swz and store_rows serve both.
constexpr int kBwdRows = 128;  // resident rows per CTA: two consumers of 64
constexpr int kBwdTile = 64;   // rows of a streamed tile (dq: K/V, dk/dv: q)
constexpr int kBwdRing = 2;    // streamed stages in shared memory
static_assert(kBwdRows == kBM, "the forward's resident tile");
static_assert(kBwdRows % kBwdTile == 0,
              "a resident tile is whole streamed tiles");

// dq's shared memory from a 1024-byte aligned base: Q and dO (kBwdRows x
// D), kBwdRing K and V tiles (kBwdTile x D), each tile D / 64 boxes of
// rows x 128 bytes, 128-byte swizzled; delta of the 128 rows; mbarriers
// full[kBwdRing], empty[kBwdRing], q.
template <int D>
struct DqSmem {
  static constexpr int kRowsTile = kBwdRows * D * 2;
  static constexpr int kTile = kBwdTile * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kRowsTile;
  static constexpr int kK = 2 * kRowsTile;
  static constexpr int kV = kK + kBwdRing * kTile;
  static constexpr int kDelta = kV + kBwdRing * kTile;
  static constexpr int kBar = kDelta + kBwdRows * 4;
  static constexpr int kBytes = kBar + (2 * kBwdRing + 1) * 8 + 1024;
};

// dk/dv's: K and V (kBwdRows x D); kBwdRing Q and dO tiles (kBwdTile x
// D); kBwdRing lse and delta rows (kBwdTile fp32); mbarriers full, empty,
// kv.
template <int D>
struct DkvSmem {
  static constexpr int kRowsTile = kBwdRows * D * 2;
  static constexpr int kTile = kBwdTile * D * 2;
  static constexpr int kStat = kBwdTile * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kRowsTile;
  static constexpr int kQ = 2 * kRowsTile;
  static constexpr int kDO = kQ + kBwdRing * kTile;
  static constexpr int kLse = kDO + kBwdRing * kTile;
  static constexpr int kDelta = kLse + kBwdRing * kStat;
  static constexpr int kBar = kDelta + kBwdRing * kStat;
  static constexpr int kBytes = kBar + (2 * kBwdRing + 1) * 8 + 1024;
};

// TMA: the box at (c0, c1), innermost first (the fp32 lse / delta rows).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(c1), "r"(bar)
      : "memory");
}

// d (m64n64, fp32) = A B, or d += A B when scale_d is nonzero; A and B
// (T) are read from shared memory through descriptors, both K-major.
template <class T>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32],
                                               uint64_t desc_a,
                                               uint64_t desc_b,
                                               int scale_d) {
#define STPU_WGMMA(TY)                                                      \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "        \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
  if constexpr (T::kHalf)
    STPU_WGMMA("f16");
  else
    STPU_WGMMA("bf16");
#undef STPU_WGMMA
}

// d (64 x 64 fp32) = A B^T over D: A, 64 rows at desc_a, and B, 64 rows at
// desc_b, both K-major tiles of D / 64 boxes, a_box and b_box bytes apart.
template <int D, class T>
__device__ __forceinline__ void mma_nt(float (&d)[32], uint64_t desc_a,
                                       int a_box, uint64_t desc_b,
                                       int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in_box = (kk % 4) * 32;  // bytes into the 64-col box
    wgmma_m64n64_ss<T>(d, desc_a + (((kk / 4) * a_box + in_box) >> 4),
                    desc_b + (((kk / 4) * b_box + in_box) >> 4), kk);
  }
}

// The same with A, this warpgroup's 64 rows, held in registers (a[kk] for
// k step kk, as load_a_frags leaves them): only B is read from shared
// memory, K-major (tnspB = 0).
template <int D, class T>
__device__ __forceinline__ void mma_rs_nt(float (&d)[32],
                                          const uint32_t (&a)[D / 16][4],
                                          uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64_rs<T, /*kTnspB=*/0>(
        d, a[kk], desc_b + (((kk / 4) * kBwdTile * 128 + (kk % 4) * 32) >> 4));
}

// The wgmma A fragments of rows R0..R0 + 15 of a kBwdRows-row swizzled
// tile over D, one k step of 16 columns each: the mma.m16n8k16 A layout,
// which ldmatrix.x4 gives when lane l points at row R0 + l % 16, chunk
// 2 kk + l / 16 (eight rows of a matrix, eight distinct swizzled chunks:
// no bank conflicts).
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4],
                                             const unsigned char* tile,
                                             int R0) {
  const int l = threadIdx.x % 32;
  const e16* t = reinterpret_cast<const e16*>(tile);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(a[kk], t + swz(R0 + l % 16, 2 * kk + l / 16));
}

// d (64 x D fp32) += A B: A, 64 x kBwdTile of T from registers (a[kk] for
// k step kk); B, a kBwdTile x D tile read MN-major at desc_b (LBO = the
// box stride, kBwdTile * 128 bytes).
template <int D, class T>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2],
                                       const uint32_t (&a)[kBwdTile / 16][4],
                                       uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < kBwdTile / 16; ++kk)
    wgmma_pv<D, T>(d, a[kk], desc_b + ((kk * 16 * 128) >> 4));
}

// Sum of the products of 8 pairs of T.
template <class T>
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = T::unpack(x[i]), fy = T::unpack(y[i]);
    s = fmaf(fx.x, fy.x, fmaf(fx.y, fy.y, s));
  }
  return s;
}

// ---------------------------------------------------------------------- dq

// The producer's one thread: Q and dO, then the K/V ring.
template <int D>
__device__ __forceinline__ void dq_producer(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const BwdParams& p, unsigned char* base, int b,
    int h, int qt, int n_kt) {
  using L = DqSmem<D>;
  const int kvh = h / (p.H / p.KVH);
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * kBwdRing, qbar = full0 + 16 * kBwdRing;
  mbar_expect_tx(qbar, 2 * L::kRowsTile);
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c) {
    const int off = c * kBwdRows * 128;
    tma_load_4d(base + L::kQ + off, &tq, qbar, c * kBoxCols, qt * kBwdRows,
                h, b);
    tma_load_4d(base + L::kDO + off, &tdo, qbar, c * kBoxCols,
                qt * kBwdRows, h, b);
  }
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kBwdRing;
    if (j >= kBwdRing) mbar_wait(empty0 + 8 * st, (j / kBwdRing - 1) & 1);
    const uint32_t full = full0 + 8 * st;
    mbar_expect_tx(full, 2 * L::kTile);
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c) {
      const int off = st * L::kTile + c * kBwdTile * 128;
      tma_load_4d(base + L::kK + off, &tk, full, c * kBoxCols, j * kBwdTile,
                  kvh, b);
      tma_load_4d(base + L::kV + off, &tv, full, c * kBoxCols, j * kBwdTile,
                  kvh, b);
    }
  }
}

// dS = P * (dP - delta) of one 64 x 64 tile, P = exp(sm * s - lse), into
// the A fragments of dS K's four 16-deep k steps, rounded to T. MASK drops
// (row, key) pairs by `mask`.
template <class T, class Base, bool MASK>
__device__ __forceinline__ void ds_tile(const float (&s)[32],
                                        const float (&dp)[32],
                                        uint32_t (&da)[kBwdTile / 16][4],
                                        float sm, const float (&lse)[2],
                                        const float (&dlt)[2], int row0,
                                        int k_start, TileMask mask) {
  const int t = threadIdx.x % 4;
  const float kDrop = -__int_as_float(0x7f800000);  // -inf: exp gives 0
#pragma unroll
  for (int i = 0; i < kBwdTile / 8; ++i) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1;
      float x = fmaf(s[4 * i + e], sm, -lse[hf]);
      if (MASK && mask.drop(row0 + 8 * hf, k_start + i * 8 + 2 * t + (e & 1)))
        x = kDrop;
      ds[e] = Base::exp(x) * (dp[4 * i + e] - dlt[hf]);
    }
    da[i / 2][(i % 2) * 2] = T::pack(ds[0], ds[1]);
    da[i / 2][(i % 2) * 2 + 1] = T::pack(ds[2], ds[3]);
  }
}

// A consumer warpgroup: delta for its 64 q rows, then dq over the K/V
// tiles up to its causal bound, then the epilogue. kRegA: how many of its
// resident A operands, Q then dO, it holds in registers for the whole loop
// (S = Q K^T and dP = dO V^T then read only K or V from shared memory);
// 0 reads both from shared memory at every tile.
template <int D, class T, class Base, int kRegA>
__device__ __forceinline__ void dq_consumer(const BwdParams& p,
                                            unsigned char* base, int b,
                                            int h, int qt, int n_kt) {
  using L = DqSmem<D>;
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int q_start = qt * kBwdRows;
  const int R0 = cw * 64 + warp * 16 + lane / 4;  // and R0 + 8
  const int row0 = q_start + R0;
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * kBwdRing, qbar = full0 + 16 * kBwdRing;
  const float sm = p.scale * Base::kScoreMul;
  const TileMask mask = {p.S, p.causal};
  const long long stat = ((long long)b * p.H + h) * p.S;
  // Causal: this consumer's rows end on KV tile `diag`, which it masks;
  // consumer 0 skips the CTA's last tile (2 qt + 1), wholly above its
  // rows. Rows past S are never stored: lse 0 keeps them finite.
  const int diag = qt * (kBwdRows / kBwdTile) + cw;
  const int j_last = p.causal ? min(diag, n_kt - 1) : n_kt - 1;
  const int j_mask = p.causal ? diag : masked_tile(0, p.S, kBwdTile, n_kt);
  float lse_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    lse_r[hf] = row0 + 8 * hf < p.S
                    ? p.lse[stat + row0 + 8 * hf] * Base::kLseMul
                    : 0.f;

  // delta = rowsum(dO * O): two threads a row, O from global memory, dO
  // from the swizzled tile; 0 past S.
  mbar_wait(qbar, 0);
  float* sDelta = reinterpret_cast<float*>(base + L::kDelta);
  {
    const e16* sdO = reinterpret_cast<const e16*>(base + L::kDO);
    const int R = cw * 64 + tid / 2, half = tid % 2, row = q_start + R;
    float sum = 0.f;
    if (row < p.S) {
      const e16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int ch = half * (D / 16) + c;
        sum += dot8<T>(*reinterpret_cast<const uint4*>(orow + ch * 8),
                    *reinterpret_cast<const uint4*>(sdO + swz(R, ch)));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      sDelta[R] = sum;
      if (row < p.S) p.delta[stat + row] = sum;
    }
  }
  warpgroup_sync(1 + cw);
  const float dlt_r[2] = {sDelta[R0], sDelta[R0 + 8]};

  // This warp's 16 rows of Q (and dO) as A fragments (unused arrays when
  // kRegA leaves them in shared memory).
  [[maybe_unused]] uint32_t qa[kRegA >= 1 ? D / 16 : 1][4];
  [[maybe_unused]] uint32_t doa[kRegA >= 2 ? D / 16 : 1][4];
  if constexpr (kRegA >= 1)
    load_a_frags<D>(qa, base + L::kQ, cw * 64 + warp * 16);
  if constexpr (kRegA >= 2)
    load_a_frags<D>(doa, base + L::kDO, cw * 64 + warp * 16);

  // Descriptors: this consumer's Q and dO rows (A), stage 0's K and V (B,
  // K-major), and K again MN-major for dS K.
  const uint64_t d_q = smem_desc(base + L::kQ + cw * 64 * 128, 16, 1024);
  const uint64_t d_do = smem_desc(base + L::kDO + cw * 64 * 128, 16, 1024);
  const uint64_t d_k = smem_desc(base + L::kK, 16, 1024);
  const uint64_t d_v = smem_desc(base + L::kV, 16, 1024);
  const uint64_t d_kmn = smem_desc(base + L::kK, kBwdTile * 128, 1024);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kBwdRing;
    mbar_wait(full0 + 8 * st, (j / kBwdRing) & 1);
    if (j <= j_last) {
      const uint32_t tile = (st * L::kTile) >> 4;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      if constexpr (kRegA >= 1)
        mma_rs_nt<D, T>(s, qa, d_k + tile);
      else
        mma_nt<D, T>(s, d_q, kBwdRows * 128, d_k + tile, kBwdTile * 128);
      if constexpr (kRegA >= 2)
        mma_rs_nt<D, T>(dp, doa, d_v + tile);
      else
        mma_nt<D, T>(dp, d_do, kBwdRows * 128, d_v + tile, kBwdTile * 128);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      uint32_t da[kBwdTile / 16][4];
      if (j == j_mask)
        ds_tile<T, Base, true>(s, dp, da, sm, lse_r, dlt_r, row0,
                               j * kBwdTile, mask);
      else
        ds_tile<T, Base, false>(s, dp, da, sm, lse_r, dlt_r, row0,
                                j * kBwdTile, mask);
      wgmma_fence();
      mma_rs<D, T>(acc, da, d_kmn + tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    if (tid == 0) mbar_arrive(empty0 + 8 * st);  // K and V of st consumed
  }

  // dq * scale through this consumer's own rows of Q (its last product has
  // read them).
  const float mul[2] = {p.scale, p.scale};
  store_rows<D, T>(acc, mul, reinterpret_cast<e16*>(base + L::kQ),
                p.dq + ((long long)b * p.S * p.H + h) * D, (long long)p.H * D,
                q_start, p.S);
}

// One CTA of dq: work item blockIdx.x is (b * H + h, 128-row q tile).
template <int D, class T, class Base, int kRegA = 0>
__device__ __forceinline__ void dq_cta(const CUtensorMap& tq,
                                       const CUtensorMap& tdo,
                                       const CUtensorMap& tk,
                                       const CUtensorMap& tv,
                                       const BwdParams& p,
                                       const int* __restrict__ work,
                                       unsigned char* smem) {
  using L = DqSmem<D>;
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const int bh = work[2 * blockIdx.x], qt = work[2 * blockIdx.x + 1];
  const int b = bh / p.H, h = bh % p.H;
  const int n_all = ceil_div(p.S, kBwdTile);
  const int n_kt =
      p.causal ? min(n_all, (qt + 1) * (kBwdRows / kBwdTile)) : n_all;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(base + L::kBar);
    for (int i = 0; i < kBwdRing; ++i) {
      mbar_init(bars + 8 * i, 1);                        // full: producer
      mbar_init(bars + 8 * (kBwdRing + i), kConsumers);  // empty: consumers
    }
    mbar_init(bars + 16 * kBwdRing, 1);                  // q and dO
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      dq_producer<D>(tq, tdo, tk, tv, p, base, b, h, qt, n_kt);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dq_consumer<D, T, Base, kRegA>(p, base, b, h, qt, n_kt);
  }
}

// ------------------------------------------------------------------- dk/dv

// The producer's one thread: K and V, then for each query head of the
// group its q tiles from i0 (Q, dO, lse, delta) into the ring.
template <int D>
__device__ __forceinline__ void dkv_producer(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tlse, const CUtensorMap& tdlt,
    const BwdParams& p, unsigned char* base, int b, int kvh, int kt, int i0,
    int n_qt) {
  using L = DkvSmem<D>;
  const int groups = p.H / p.KVH;
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * kBwdRing, kvbar = full0 + 16 * kBwdRing;
  mbar_expect_tx(kvbar, 2 * L::kRowsTile);
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c) {
    const int off = c * kBwdRows * 128;
    tma_load_4d(base + L::kK + off, &tk, kvbar, c * kBoxCols, kt * kBwdRows,
                kvh, b);
    tma_load_4d(base + L::kV + off, &tv, kvbar, c * kBoxCols, kt * kBwdRows,
                kvh, b);
  }
  int n = 0;
  for (int gi = 0; gi < groups; ++gi) {
    const int h = kvh * groups + gi;
    for (int i = i0; i < n_qt; ++i, ++n) {
      const int st = n % kBwdRing;
      if (n >= kBwdRing) mbar_wait(empty0 + 8 * st, (n / kBwdRing - 1) & 1);
      const uint32_t full = full0 + 8 * st;
      mbar_expect_tx(full, 2 * L::kTile + 2 * L::kStat);
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c) {
        const int off = st * L::kTile + c * kBwdTile * 128;
        tma_load_4d(base + L::kQ + off, &tq, full, c * kBoxCols,
                    i * kBwdTile, h, b);
        tma_load_4d(base + L::kDO + off, &tdo, full, c * kBoxCols,
                    i * kBwdTile, h, b);
      }
      tma_load_2d(base + L::kLse + st * L::kStat, &tlse, full, i * kBwdTile,
                  b * p.H + h);
      tma_load_2d(base + L::kDelta + st * L::kStat, &tdlt, full,
                  i * kBwdTile, b * p.H + h);
    }
  }
}

// P^T = exp(sm * s^T - lse[q]) and dS^T = P^T * (dP^T - delta[q]) of one
// 64 (kv) x 64 (q) tile, into the A fragments of P^T dO and dS^T Q,
// rounded to T. MASK drops the causal pairs q < k.
template <class T, class Base, bool MASK>
__device__ __forceinline__ void dst_tile(const float (&s)[32],
                                         const float (&dp)[32],
                                         uint32_t (&pa)[kBwdTile / 16][4],
                                         uint32_t (&da)[kBwdTile / 16][4],
                                         const float* lse, const float* dlt,
                                         float sm, int krow0, int q_start) {
  const int t = threadIdx.x % 4;
  const float kDrop = -__int_as_float(0x7f800000);  // -inf: exp gives 0
#pragma unroll
  for (int i = 0; i < kBwdTile / 8; ++i) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse + i * 8 + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(dlt + i * 8 + 2 * t);
    float pr[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lv = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
      float x = fmaf(s[4 * i + e], sm, -lv);
      if (MASK && q_start + i * 8 + 2 * t + (e & 1) < krow0 + 8 * (e >> 1))
        x = kDrop;
      pr[e] = Base::exp(x);
      ds[e] = pr[e] * (dp[4 * i + e] - dl);
    }
    pa[i / 2][(i % 2) * 2] = T::pack(pr[0], pr[1]);
    pa[i / 2][(i % 2) * 2 + 1] = T::pack(pr[2], pr[3]);
    da[i / 2][(i % 2) * 2] = T::pack(ds[0], ds[1]);
    da[i / 2][(i % 2) * 2 + 1] = T::pack(ds[2], ds[3]);
  }
}

// A consumer warpgroup: dk and dv of its 64 kv rows over every q tile of
// the group's heads from its causal start, then the epilogue.
template <int D, class T, class Base>
__device__ __forceinline__ void dkv_consumer(const BwdParams& p,
                                             unsigned char* base, int b,
                                             int kvh, int kt, int i0,
                                             int n_qt) {
  using L = DkvSmem<D>;
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int k_start = kt * kBwdRows;
  const int R0 = cw * 64 + warp * 16 + lane / 4;  // and R0 + 8
  const int krow0 = k_start + R0;
  const int groups = p.H / p.KVH;
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * kBwdRing, kvbar = full0 + 16 * kBwdRing;
  const float sm = p.scale * Base::kScoreMul;
  // Causal: q tile i0 + cw is this consumer's diagonal, which it masks;
  // consumer 1 skips tile i0, wholly above its rows. Non-causal: every
  // tile, none masked (q rows past S add exactly 0).
  const int i_first = p.causal ? i0 + cw : 0;
  const int i_mask = p.causal ? i0 + cw : -1;

  // Descriptors: this consumer's K and V rows (A), stage 0's Q and dO (B,
  // K-major), and Q and dO again MN-major for dS^T Q and P^T dO.
  const uint64_t d_k = smem_desc(base + L::kK + cw * 64 * 128, 16, 1024);
  const uint64_t d_v = smem_desc(base + L::kV + cw * 64 * 128, 16, 1024);
  const uint64_t d_q = smem_desc(base + L::kQ, 16, 1024);
  const uint64_t d_do = smem_desc(base + L::kDO, 16, 1024);
  const uint64_t d_qmn = smem_desc(base + L::kQ, kBwdTile * 128, 1024);
  const uint64_t d_domn = smem_desc(base + L::kDO, kBwdTile * 128, 1024);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kvbar, 0);
  int n = 0;
  for (int gi = 0; gi < groups; ++gi) {
    for (int i = i0; i < n_qt; ++i, ++n) {
      const int st = n % kBwdRing;
      mbar_wait(full0 + 8 * st, (n / kBwdRing) & 1);
      if (i >= i_first) {
        const uint32_t tile = (st * L::kTile) >> 4;
        float s[32], dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
        wgmma_fence();
        mma_nt<D, T>(s, d_k, kBwdRows * 128, d_q + tile, kBwdTile * 128);
        mma_nt<D, T>(dp, d_v, kBwdRows * 128, d_do + tile, kBwdTile * 128);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);
        const float* lse =
            reinterpret_cast<const float*>(base + L::kLse + st * L::kStat);
        const float* dlt =
            reinterpret_cast<const float*>(base + L::kDelta + st * L::kStat);
        uint32_t pa[kBwdTile / 16][4], da[kBwdTile / 16][4];
        if (i == i_mask)
          dst_tile<T, Base, true>(s, dp, pa, da, lse, dlt, sm, krow0,
                                  i * kBwdTile);
        else
          dst_tile<T, Base, false>(s, dp, pa, da, lse, dlt, sm, krow0,
                                   i * kBwdTile);
        wgmma_fence();
        mma_rs<D, T>(dv, pa, d_domn + tile);
        mma_rs<D, T>(dk, da, d_qmn + tile);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
      }
      if (tid == 0) mbar_arrive(empty0 + 8 * st);  // Q, dO, lse, delta read
    }
  }

  // dk * scale and dv through this consumer's own rows of K and V (only
  // its own products read them).
  const long long off = ((long long)b * p.S * p.KVH + kvh) * D;
  const long long ss = (long long)p.KVH * D;
  const float dk_mul[2] = {p.scale, p.scale}, dv_mul[2] = {1.f, 1.f};
  store_rows<D, T>(dk, dk_mul, reinterpret_cast<e16*>(base + L::kK),
                   p.dk + off, ss, k_start, p.S);
  store_rows<D, T>(dv, dv_mul, reinterpret_cast<e16*>(base + L::kV),
                   p.dv + off, ss, k_start, p.S);
}

// One CTA of dk/dv: work item blockIdx.x is (b * KVH + kvh, 128-row kv
// tile).
template <int D, class T, class Base>
__device__ __forceinline__ void dkv_cta(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tlse, const CUtensorMap& tdlt,
    const BwdParams& p, const int* __restrict__ work, unsigned char* smem) {
  static_assert(Base::kLseMul == 1.f, "dk/dv reads lse as the base's own");
  using L = DkvSmem<D>;
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const int bkv = work[2 * blockIdx.x], kt = work[2 * blockIdx.x + 1];
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  const int n_qt = ceil_div(p.S, kBwdTile);
  // Causal: q tiles from the kv tile's first row (i0 < n_qt: kt's rows
  // start before S).
  const int i0 = p.causal ? kt * (kBwdRows / kBwdTile) : 0;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(base + L::kBar);
    for (int i = 0; i < kBwdRing; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (kBwdRing + i), kConsumers);
    }
    mbar_init(bars + 16 * kBwdRing, 1);  // K and V
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      dkv_producer<D>(tq, tdo, tk, tv, tlse, tdlt, p, base, b, kvh, kt, i0,
                      n_qt);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dkv_consumer<D, T, Base>(p, base, b, kvh, kt, i0, n_qt);
  }
}

// ----------------------------------------------------------------- host

// A map of the (B * H, S) fp32 rows of lse or delta, as dimensions (S,
// B * H): boxes of kBwdTile values of one row, unswizzled. Values at or
// past S read as zeros.
inline int encode_stats(CUtensorMap* map, const void* ptr, int S, int rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)S, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)S * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBwdTile, 1};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// Encodes dq's four maps and launches `kernel` (an instance of dq_cta)
// over the B * H * ceil(S / 128) items of `work`.
template <int D, class T, class Kernel>
inline int launch_dq(Kernel kernel, const BwdParams& p, int B,
                     const int* work, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  int err = encode_rows<T>(&tq, p.q, D, p.S, p.H, B, p.q_ss, p.q_sh, p.q_sb,
                           kBwdRows);
  if (!err)
    err = encode_rows<T>(&tdo, p.dout, D, p.S, p.H, B, p.do_ss, p.do_sh,
                         p.do_sb, kBwdRows);
  if (!err)
    err = encode_rows<T>(&tk, p.k, D, p.S, p.KVH, B, p.k_ss, p.k_sh, p.k_sb,
                         kBwdTile);
  if (!err)
    err = encode_rows<T>(&tv, p.v, D, p.S, p.KVH, B, p.v_ss, p.v_sh, p.v_sb,
                         kBwdTile);
  if (err) return err;
  const cudaError_t e = allow_smem(kernel, DqSmem<D>::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int items = B * p.H * ceil_div(p.S, kBwdRows);
  kernel<<<items, kFwdThreads, DqSmem<D>::kBytes, stream>>>(tq, tdo, tk, tv,
                                                            p, work);
  return (int)cudaGetLastError();
}

// Encodes dk/dv's six maps and launches `kernel` (an instance of dkv_cta)
// over the B * KVH * ceil(S / 128) items of `work`.
template <int D, class T, class Kernel>
inline int launch_dkv(Kernel kernel, const BwdParams& p, int B,
                      const int* work, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tlse, tdlt;
  int err = encode_rows<T>(&tq, p.q, D, p.S, p.H, B, p.q_ss, p.q_sh, p.q_sb,
                           kBwdTile);
  if (!err)
    err = encode_rows<T>(&tdo, p.dout, D, p.S, p.H, B, p.do_ss, p.do_sh,
                         p.do_sb, kBwdTile);
  if (!err)
    err = encode_rows<T>(&tk, p.k, D, p.S, p.KVH, B, p.k_ss, p.k_sh, p.k_sb,
                         kBwdRows);
  if (!err)
    err = encode_rows<T>(&tv, p.v, D, p.S, p.KVH, B, p.v_ss, p.v_sh, p.v_sb,
                         kBwdRows);
  if (!err) err = encode_stats(&tlse, p.lse, p.S, B * p.H);
  if (!err) err = encode_stats(&tdlt, p.delta, p.S, B * p.H);
  if (err) return err;
  const cudaError_t e = allow_smem(kernel, DkvSmem<D>::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int items = B * p.KVH * ceil_div(p.S, kBwdRows);
  kernel<<<items, kFwdThreads, DkvSmem<D>::kBytes, stream>>>(
      tq, tdo, tk, tv, tlse, tdlt, p, work);
  return (int)cudaGetLastError();
}

template <int D, class T, class Kernel>
inline int dq_attrs(Kernel kernel, int* out) {
  return kernel_attrs(kernel, DqSmem<D>::kBytes, kFwdThreads,
                      kProducerRegs, kConsumerRegs, out);
}

template <int D, class T, class Kernel>
inline int dkv_attrs(Kernel kernel, int* out) {
  return kernel_attrs(kernel, DkvSmem<D>::kBytes, kFwdThreads,
                      kProducerRegs, kConsumerRegs, out);
}

}  // namespace sm90
}  // namespace stpu
