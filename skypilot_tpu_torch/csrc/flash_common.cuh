// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile shapes, global->shared tile loads, ldmatrix and the bf16 mma.sync
// m16n8k16 tensor-core product with fp32 accumulation.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4*g + t.
//   A (16x16, row-major): a0 = (row g,   k 2t..2t+1), a1 = (row g+8, k 2t..),
//                         a2 = (row g,   k 2t+8..),   a3 = (row g+8, k 2t+8..)
//   B (16x8, k x n):      b0 = (k 2t..2t+1, col g),   b1 = (k 2t+8.., col g)
//   C (16x8, fp32):       c0,c1 = (row g, cols 2t, 2t+1), c2,c3 = (row g+8, ..)
// Two neighbouring C tiles (16 columns) hold exactly the A fragment of one
// 16-deep k step, which lets P (or dS) feed the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stpu {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;          // 4 warps; each owns 16 rows of a tile
constexpr int kTile = 64;              // q and kv rows per tile (fwd, dq, dkv)
// bf16 padding per shared row: rows stay 16-byte aligned and the 8 row
// addresses of one ldmatrix fall in 8 different 4-bank groups.
constexpr int kPad = 8;
constexpr float kNegInf = -1e30f;      // the JAX package's mask value

__host__ __device__ constexpr int row_elems(int d) { return d + kPad; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `rows` rows of D bf16 (16-byte chunks) from global, row stride
// `gstride` elements, into a shared tile with rows of row_elems(D).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long gstride) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    *reinterpret_cast<uint4*>(s + r * row_elems(D) + cc * 8) =
        *reinterpret_cast<const uint4*>(g + r * gstride + cc * 8);
  }
}

// Four 8x8 bf16 matrices; lane l gives the address of row l%8 of matrix l/8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b, 16x8x16, bf16 inputs, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of rows [r0, r0+16) x k [k0, k0+16) of a row-major shared tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int r0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, s + (r0 + (l % 16)) * row_elems(D) + k0 + (l / 16) * 8);
}

// B fragments of two n-tiles [n0, n0+16) x k [k0, k0+16) when the shared
// tile is stored n-major (row n holds the k values: K for q k^T, V for
// dO v^T). b[0], b[1] feed n-tile n0; b[2], b[3] feed n0+8.
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* s,
                                          int n0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(b, s + (n0 + (l % 8) + (l / 16) * 8) * row_elems(D) + k0 +
                 ((l / 8) % 2) * 8);
}

// The same when the shared tile is stored k-major (row k holds the n
// values: V for P v, K for dS k, dO and q in the dk/dv products).
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* s,
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

// Large dynamic shared memory must be allowed per kernel before launch.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace stpu
