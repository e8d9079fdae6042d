// Flash-attention backward for Hopper (sm_90a), the resident family: the dq
// kernel and the dk/dv kernel, from the saved (q, k, v, o, lse) and the
// output cotangent dO.
//
// flash_dq replaces skypilot_tpu/ops/pallas/flash_attention.py:
// _dq_kernel_resident; flash_dkv replaces _dkv_kernel_resident (both
// launched by _flash_bwd_resident). With P = exp(scale q k^T - lse),
// dP = dO v^T, delta = rowsum(dO * O) and dS = P * (dP - delta):
//   dq = scale * dS k,   dv = sum_g P^T dO,   dk = scale * sum_g dS^T q,
// where the sums run over the G = H / KVH query heads of a KV head.
//
// What bounds them: like the forward, ~2*S*D flops per byte moved at the
// training shapes, so the tensor cores. dq does 3 products per tile pair
// (q k^T, dO v^T, dS k) and dk/dv 4 (k q^T, v dO^T, P^T dO, dS^T q).
//
// Design (the tile bodies are dq_tile and dkv_tile in flash_common.cuh).
// flash_dq: one block of 4 warps per (q tile of 64 rows, b*h), longest
// causal rows first; it keeps dq in fp32 registers over the K/V loop and
// writes delta for flash_dkv, so that kernel never reads O. flash_dkv: one
// block per (kv tile of 64 rows, b*KVH), heaviest (first) kv tiles first;
// it sums the GQA group in registers, no atomics, which is the TPU
// design's point carried over.
#include "flash_common.cuh"

namespace stpu {
namespace {

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // longest causal rows first
  const int qt = ceil_div(p.S, kTile) - 1 - blockIdx.x;
  dq_tile<D, BaseE>(p, blockIdx.y / p.H, blockIdx.y % p.H, qt, smem);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // kv tile 0 has the most q rows: first.
  dkv_tile<D, BaseE>(p, blockIdx.y / p.KVH, blockIdx.y % p.KVH, blockIdx.x,
                     smem);
}

}  // namespace
}  // namespace stpu

// strides: (batch, seq, head) in elements for q, k, v, o, dO. dq and delta
// are written contiguous: (B, S, H, D) bf16 and (B, H, S) fp32.
extern "C" int stpu_flash_dq(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const void* lse, void* dq, void* delta,
                             const long long* strides, int B, int S, int H,
                             int KVH, int D, float scale, int causal,
                             void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                                 nullptr, strides, S, H, KVH, scale, causal);
  const dim3 grid(ceil_div(S, kTile), B * H);
  STPU_LAUNCH_BY_D(D, flash_dq_kernel, dq_smem_bytes, grid,
                   static_cast<cudaStream_t>(stream), p);
}

// strides: (batch, seq, head) in elements for q, k, v, dO. dk and dv are
// written contiguous (B, S, KVH, D) bf16.
extern "C" int stpu_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              const long long* strides, int B, int S, int H,
                              int KVH, int D, float scale, int causal,
                              void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, nullptr, dout, lse, delta, nullptr,
                                 dk, dv, strides, S, H, KVH, scale, causal);
  const dim3 grid(ceil_div(S, kTile), B * KVH);
  STPU_LAUNCH_BY_D(D, flash_dkv_kernel, dkv_smem_bytes, grid,
                   static_cast<cudaStream_t>(stream), p);
}
