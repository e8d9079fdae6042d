// Shared pieces of the flash-attention kernels: for every kernel the
// 16-bit element types, parameters, softmax bases and mask; for the one
// mma.sync kernel left, the streamed dq (flash_streamed.cu), its tile
// shape, global->shared tile loads staged through cp.async, ldmatrix, the
// mma.sync m16n8k16 tensor-core product with fp32 accumulation, its tile
// step as a template over the element type and the softmax base, delta,
// and its epilogue. Every other 16-bit kernel is Hopper-native (wgmma +
// TMA): the forwards are flash_fwd_sm90.cuh, the dq and dk/dv kernels
// flash_bwd_sm90.cuh.
//
// The resident and streamed families work in natural exp with a
// natural-log lse; the triangular family works in exp2 with a base-2 lse,
// as the TPU's long-context kernels do. The streamed dq's loop keeps the
// next tile's cp.async copy in flight while the current tile's products
// run, stops at the causal bound and masks only the tile that straddles
// the diagonal: the step is a template over MASK, and interior tiles run
// the instance with no compare or select.
//
// Ragged sequence tails: S need only be a multiple of 8, so a sequence has
// ceil(S / 64) tiles and the last may be partial. Rows at or past S load
// as zeros, the last KV tile of a non-causal loop runs the MASK instance
// with key columns at or past S dropped (causal loops drop them with the
// diagonal), and every store is predicated on row < S.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 or .f16): lane =
// 4*g + t.
//   A (16x16, row-major): a0 = (row g,   k 2t..2t+1), a1 = (row g+8, k 2t..),
//                         a2 = (row g,   k 2t+8..),   a3 = (row g+8, k 2t+8..)
//   B (16x8, k x n):      b0 = (k 2t..2t+1, col g),   b1 = (k 2t+8.., col g)
//   C (16x8, fp32):       c0,c1 = (row g, cols 2t, 2t+1), c2,c3 = (row g+8, ..)
// Two neighbouring C tiles (16 columns) hold exactly the A fragment of one
// 16-deep k step, which lets P (or dS) feed the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stpu {

// The two element types every kernel has an instance of: bf16 or f16
// inputs and outputs, fp32 accumulation. Tiles, global loads, TMA copies
// and ldmatrix move 16-bit words (e16) whatever the type; the type sets
// the tensor-core product's type string (kHalf), the pack of two fp32
// values into one 32-bit register (the round to the type of P and dS
// before their product, and of each epilogue's output) and the unpack of
// two values back to fp32. The C entries take the type as an int: kDtype.
typedef uint16_t e16;

struct Bf16 {
  static constexpr bool kHalf = false;
  static constexpr int kDtype = 0;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  }
};

struct F16 {
  static constexpr bool kHalf = true;
  static constexpr int kDtype = 1;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  }
};

constexpr int kThreads = 128;          // 4 warps; each owns 16 rows of a tile
constexpr int kTile = 64;              // q and kv rows per tile of dq
// Elements of padding per shared row: rows stay 16-byte aligned and the 8 row
// addresses of one ldmatrix fall in 8 different 4-bank groups.
constexpr int kPad = 8;
constexpr float kNegInf = -1e30f;      // the JAX package's mask value

__host__ __device__ constexpr int row_elems(int d) { return d + kPad; }

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Staged copies (the streamed dq): 16-byte cp.async.cg copies from
// global to shared memory that bypass L1 and use no registers for the data.
// A thread's copies since its last commit form one group; wait_all returns
// once every group of this thread has landed, and a __syncthreads() after
// it makes all threads' copies visible to the block. kStages tiles of a
// stream are resident at once: the one being computed on and the next.
constexpr int kStages = 2;

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(s)), "l"(g)
               : "memory");
}

// The same with a source size: when valid is false nothing is read
// (src-size 0) and the 16 bytes are zero-filled; g must still be an
// address inside the tensor.
__device__ __forceinline__ void cp_async16_zfill(void* s, const void* g,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(s)), "l"(g), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy ROWS rows of D elements (16-byte chunks) from global, row stride
// `gstride` elements, into a shared tile with rows of row_elems(D), as
// cp.async: nothing is read until a wait. Rows at or past `valid` (the
// rows left before S) are zero-filled from row 0's address. Every tile but
// a ragged last one is whole: it takes the unpredicated loop (the branch
// is uniform across the block).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(e16* s, const e16* g,
                                                long long gstride,
                                                int valid) {
  constexpr int kChunks = D / 8;
  if (valid >= ROWS) {
    for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
      const int r = c / kChunks, cc = c % kChunks;
      cp_async16(s + r * row_elems(D) + cc * 8, g + r * gstride + cc * 8);
    }
    return;
  }
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const bool ok = r < valid;
    cp_async16_zfill(s + r * row_elems(D) + cc * 8,
                     g + (ok ? r : 0) * gstride + cc * 8, ok);
  }
}

// Four 8x8 16-bit matrices; lane l gives the address of row l%8 of matrix l/8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const e16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const e16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b, 16x8x16, T (bf16 or f16) inputs, fp32 accumulate.
template <class T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
#define STPU_MMA(TY)                                                       \
  asm volatile(                                                            \
      "mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "           \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"            \
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (T::kHalf)
    STPU_MMA("f16");
  else
    STPU_MMA("bf16");
#undef STPU_MMA
}

// A fragment of rows [r0, r0+16) x k [k0, k0+16) of a row-major shared tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const e16* s,
                                       int r0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, s + (r0 + (l % 16)) * row_elems(D) + k0 + (l / 16) * 8);
}

// B fragments of two n-tiles [n0, n0+16) x k [k0, k0+16) when the shared
// tile is stored n-major (row n holds the k values: K for q k^T, V for
// dO v^T). b[0], b[1] feed n-tile n0; b[2], b[3] feed n0+8.
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const e16* s,
                                          int n0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(b, s + (n0 + (l % 8) + (l / 16) * 8) * row_elems(D) + k0 +
                 ((l / 8) % 2) * 8);
}

// The same when the shared tile is stored k-major (row k holds the n
// values: K for dS k).
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const e16* s,
                                          int k0, int n0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_t(b, s + (k0 + (l % 16)) * row_elems(D) + n0 + (l / 16) * 8);
}

// Sum and max over the 4 lanes (t = 0..3) that share a row of a C tile.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// Large dynamic shared memory must be allowed per kernel before launch.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// ------------------------------------------------------- softmax bases
// Scores are scale * q k^T * kScoreMul; P = exp(scores - stat) in the base;
// the lse is written as m + log(l) in the base. The score scale rides the
// one multiply each score takes anyway, so exp2's log2(e) costs nothing.

struct BaseE {  // resident and streamed families: natural exp and lse
  static constexpr float kScoreMul = 1.f;
  static __device__ __forceinline__ float exp(float x) { return __expf(x); }
  static __device__ __forceinline__ float log(float x) { return logf(x); }
};

struct Base2 {  // triangular family: exp2, base-2 lse
  static constexpr float kScoreMul = 1.4426950408889634f;  // log2(e)
  static __device__ __forceinline__ float exp(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
  }
  static __device__ __forceinline__ float log(float x) { return log2f(x); }
};

// What a MASK step drops: key columns at or past S (the ragged last tile)
// and, when causal, columns past the query row. The KV tile a q tile's
// loop masks is the diagonal one when causal, the last one when S leaves
// it partial, and none otherwise (-1).
struct TileMask {
  int S;
  int causal;
  __device__ __forceinline__ bool drop(int qpos, int kpos) const {
    return kpos >= S || (causal && qpos < kpos);
  }
};

__host__ __device__ inline int masked_tile(int causal, int S, int tile,
                                           int n_kt) {
  return (causal || S % tile) ? n_kt - 1 : -1;
}

// ------------------------------------------------------------ parameters

struct FwdParams {
  const e16* q;
  const e16* k;
  const e16* v;
  e16* o;
  float* lse;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int S, H, KVH;
  float scale;
  int causal;
};

struct BwdParams {
  const e16* q;
  const e16* k;
  const e16* v;
  const e16* o;
  const e16* dout;
  const float* lse;
  float* delta;
  e16* dq;
  e16* dk;
  e16* dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int S, H, KVH;
  float scale;
  int causal;
};

// strides: (batch, seq, head) in elements for q, k, v. o is written
// contiguous (B, S, H, D) and lse (B, H, S) fp32.
inline FwdParams fwd_params(const void* q, const void* k, const void* v,
                            void* o, void* lse, const long long* st, int S,
                            int H, int KVH, float scale, int causal) {
  FwdParams p;
  p.q = static_cast<const e16*>(q);
  p.k = static_cast<const e16*>(k);
  p.v = static_cast<const e16*>(v);
  p.o = static_cast<e16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.S = S; p.H = H; p.KVH = KVH;
  p.scale = scale;
  p.causal = causal;
  return p;
}

// strides: (batch, seq, head) for q, k, v, then o (dq only), then dO.
// dq, dk, dv are written contiguous and delta (B, H, S) fp32.
inline BwdParams bwd_params(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            void* dk, void* dv, const long long* st, int S,
                            int H, int KVH, float scale, int causal) {
  BwdParams p = {};
  p.q = static_cast<const e16*>(q);
  p.k = static_cast<const e16*>(k);
  p.v = static_cast<const e16*>(v);
  p.o = static_cast<const e16*>(o);
  p.dout = static_cast<const e16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  p.dq = static_cast<e16*>(dq);
  p.dk = static_cast<e16*>(dk);
  p.dv = static_cast<e16*>(dv);
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  const long long* d = st + 9;
  if (o != nullptr) {
    p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
    d = st + 12;
  }
  p.do_sb = d[0]; p.do_ss = d[1]; p.do_sh = d[2];
  p.S = S; p.H = H; p.KVH = KVH;
  p.scale = scale;
  p.causal = causal;
  return p;
}

// --------------------------------------------------------------------- dq
// One KV step of a 64-row q tile of one (b, h), the streamed dq's body: q
// and dO sit in shared memory, each warp owns 16 rows and keeps its dq in
// fp32 registers while the kernel loops over K/V tiles up to the causal
// bound; dq is written once. The kernel also computes delta =
// rowsum(dO * O) for its rows and writes it for the dk/dv kernel, so that
// kernel never reads O.

template <int D, class T, class Base, bool MASK>
__device__ __forceinline__ void dq_step(const e16* sQ, const e16* sdO,
                                        const e16* sK, const e16* sV,
                                        int q_start, int k_start,
                                        TileMask mask, float sm,
                                        const float (&lse_r)[2],
                                        const float (&dlt_r)[2],
                                        float (&dq)[D / 8][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wrow = warp * 16;
  float s[kTile / 8][4], dp[kTile / 8][4];
  zero(s);
  zero(dp);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t qa[4], da[4];
    load_a<D>(qa, sQ, wrow, ks * 16);
    load_a<D>(da, sdO, wrow, ks * 16);
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      uint32_t bk[4], bv[4];
      load_b_nk<D>(bk, sK, np * 16, ks * 16);
      load_b_nk<D>(bv, sV, np * 16, ks * 16);
      mma<T>(s[2 * np], qa, bk[0], bk[1]);
      mma<T>(s[2 * np + 1], qa, bk[2], bk[3]);
      mma<T>(dp[2 * np], da, bv[0], bv[1]);
      mma<T>(dp[2 * np + 1], da, bv[2], bv[3]);
    }
  }

  // dS = P * (dP - delta), P = exp(scores - lse), into A fragments.
  uint32_t dsf[kTile / 16][4];
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[i][e] * sm;
      if (MASK) {
        const int qpos = q_start + wrow + g + (e >= 2 ? 8 : 0);
        const int kpos = k_start + i * 8 + 2 * t + (e & 1);
        if (mask.drop(qpos, kpos)) x = kNegInf;
      }
      const float pr = Base::exp(x - lse_r[e >> 1]);
      ds[e] = pr * (dp[i][e] - dlt_r[e >> 1]);
    }
    dsf[i / 2][(i % 2) * 2] = T::pack(ds[0], ds[1]);
    dsf[i / 2][(i % 2) * 2 + 1] = T::pack(ds[2], ds[3]);
  }
  // dq += dS k: k is the (kv x d) = (k x n) operand, stored k-major.
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bfr[4];
      load_b_kn<D>(bfr, sK, kk * 16, dn * 16);
      mma<T>(dq[2 * dn], dsf[kk], bfr[0], bfr[1]);
      mma<T>(dq[2 * dn + 1], dsf[kk], bfr[2], bfr[3]);
    }
  }
}

// delta = rowsum(dO * O) in fp32 for the 64 rows of a q tile, O read from
// global memory at og and dO from shared memory: two lanes per row, D/2
// columns each. Written to sDelta and, for the dk/dv kernel, to p.delta;
// rows at or past `valid` read nothing and get 0 in sDelta only.
template <int D, class T>
__device__ __forceinline__ void tile_delta(const BwdParams& p, const e16* og,
                                           const e16* sdO, float* sDelta,
                                           long long stat, int valid) {
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;
  const bool ok = r < valid;
  float sum = 0.f;
  if (ok) {
    const uint32_t* orow =
        reinterpret_cast<const uint32_t*>(og + r * p.o_ss + half * (D / 2));
    const uint32_t* drow = reinterpret_cast<const uint32_t*>(
        sdO + r * row_elems(D) + half * (D / 2));
#pragma unroll 8
    for (int c = 0; c < D / 4; ++c) {
      const float2 x = T::unpack(orow[c]), y = T::unpack(drow[c]);
      sum = fmaf(x.y, y.y, fmaf(x.x, y.x, sum));
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (half == 0) {
    sDelta[r] = sum;
    if (ok) p.delta[stat + r] = sum;
  }
}

// The dq epilogue for this warp's 16 rows of the q tile. dS is the gradient
// of the natural-unit logit in both bases, so dq takes the plain logit
// scale.
template <int D, class T>
__device__ __forceinline__ void store_dq(const BwdParams& p, int b, int h,
                                         int q_start,
                                         const float (&dq)[D / 8][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q_start + warp * 16 + g;
  const bool ok0 = row0 < p.S, ok1 = row0 + 8 < p.S;
  e16* dqg = p.dq + ((long long)b * p.S * p.H + h) * D;
  const long long dq_ss = (long long)p.H * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (ok0)
      *reinterpret_cast<uint32_t*>(dqg + row0 * dq_ss + col) =
          T::pack(dq[i][0] * p.scale, dq[i][1] * p.scale);
    if (ok1)
      *reinterpret_cast<uint32_t*>(dqg + (row0 + 8) * dq_ss + col) =
          T::pack(dq[i][2] * p.scale, dq[i][3] * p.scale);
  }
}

// Launches KERNEL<D, T> for the runtime head_dim HEAD_DIM (64, 128) and
// element type DTYPE (T::kDtype), with its dynamic shared memory allowed
// first; returns from the calling C entry with the launch's error code.
#define STPU_LAUNCH_ONE(D_, T_, KERNEL, SMEM, GRID, STREAM, ...)            \
  do {                                                                       \
    const cudaError_t err_ = allow_smem(KERNEL<D_, T_>, SMEM<D_>());         \
    if (err_ != cudaSuccess) return (int)err_;                               \
    KERNEL<D_, T_><<<GRID, kThreads, SMEM<D_>(), STREAM>>>(__VA_ARGS__);     \
    return (int)cudaGetLastError();                                          \
  } while (0)

#define STPU_LAUNCH_BY_D(HEAD_DIM, DTYPE, KERNEL, SMEM, GRID, STREAM, ...)   \
  do {                                                                       \
    const bool half_ = (DTYPE) == F16::kDtype;                               \
    if (!half_ && (DTYPE) != Bf16::kDtype) return (int)cudaErrorInvalidValue; \
    if ((HEAD_DIM) == 64) {                                                  \
      if (half_) STPU_LAUNCH_ONE(64, F16, KERNEL, SMEM, GRID, STREAM,        \
                                 __VA_ARGS__);                               \
      STPU_LAUNCH_ONE(64, Bf16, KERNEL, SMEM, GRID, STREAM, __VA_ARGS__);    \
    }                                                                        \
    if ((HEAD_DIM) == 128) {                                                 \
      if (half_) STPU_LAUNCH_ONE(128, F16, KERNEL, SMEM, GRID, STREAM,       \
                                 __VA_ARGS__);                               \
      STPU_LAUNCH_ONE(128, Bf16, KERNEL, SMEM, GRID, STREAM, __VA_ARGS__);   \
    }                                                                        \
    return (int)cudaErrorInvalidValue;                                       \
  } while (0)

}  // namespace stpu
