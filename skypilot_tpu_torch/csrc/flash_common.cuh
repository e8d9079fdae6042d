// Shared pieces of the flash-attention kernels: the 16-bit element types,
// parameters, softmax bases and mask, the ldmatrix load and the quad
// reductions. Every 16-bit kernel is Hopper-native (wgmma + TMA): the
// three forwards are flash_fwd_sm90.cuh, every dq and dk/dv
// flash_bwd_sm90.cuh; flash_f32.cu holds the fp32 kernels.
//
// The resident and streamed families work in natural exp with a
// natural-log lse; the triangular family works in exp2 with a base-2 lse,
// as the TPU's long-context kernels do. S need only be a multiple of 8:
// the last tile of a sequence may be partial, and the tile a loop masks
// (masked_tile) drops its key columns at or past S.
//
// Register fragments of one warp's 16 rows (PTX ISA, mma.m16n8k16 with
// .bf16 or .f16; a wgmma's register A operand and its accumulator hold
// each warp's rows in these layouts): lane = 4*g + t.
//   A (16x16, row-major): a0 = (row g,   k 2t..2t+1), a1 = (row g+8, k 2t..),
//                         a2 = (row g,   k 2t+8..),   a3 = (row g+8, k 2t+8..)
//   C (16x8, fp32):       c0,c1 = (row g, cols 2t, 2t+1), c2,c3 = (row g+8, ..)
// Two neighbouring C tiles (16 columns) hold exactly the A fragment of one
// 16-deep k step, which lets P (or dS) feed the next product from
// registers.
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

constexpr float kNegInf = -1e30f;  // the JAX package's mask value

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 16-bit matrices; lane l gives the address of row l%8 of matrix l/8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const e16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// Large dynamic shared memory must be allowed per kernel before launch.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// ------------------------------------------------------- softmax bases
// The backward bodies' P = exp(scale * q k^T * kScoreMul - lse * kLseMul)
// in the base's exp, from the lse the forward wrote (natural log, or base
// 2 for the triangular family). The score scale rides the one FFMA each
// score takes anyway, so exp2's log2(e) costs nothing; a natural-log lse
// read into base 2 is scaled once per row.

struct BaseE {  // resident and streamed dk/dv: natural exp and lse
  static constexpr float kScoreMul = 1.f;
  static constexpr float kLseMul = 1.f;
  static __device__ __forceinline__ float exp(float x) { return __expf(x); }
};

struct Base2 {  // triangular family: exp2, base-2 lse
  static constexpr float kScoreMul = 1.4426950408889634f;  // log2(e)
  static constexpr float kLseMul = 1.f;
  static __device__ __forceinline__ float exp(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
  }
};

// The streamed dq: the natural-log lse taken into base 2 and Base2's exp,
// one FFMA and one MUFU.EX2 a score. BaseE's __expf is ex2.approx without
// ftz on x * log2(e), which ptxas wraps in a range test and two predicated
// multiplies: the dq body took 1.3-1.4x as long in BaseE as in BaseE2
// on an H100 at (1, 8192, 32, 8, 128), non-causal, bf16
// (tools/flash_dq_variants.py).
struct BaseE2 : Base2 {
  static constexpr float kLseMul = Base2::kScoreMul;
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

}  // namespace stpu
