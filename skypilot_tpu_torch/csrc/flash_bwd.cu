// Flash-attention backward for Hopper (sm_90a), the resident family: the
// dq kernel and the dk/dv kernel, from the saved (q, k, v, o, lse) and the
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
// training shapes (S 2048, D 128), far past the card's ~295 flop/byte
// ridge, so the tensor cores. dq does 3 products per tile pair (q k^T,
// dO v^T, dS k) and dk/dv 4 (k q^T, v dO^T, P^T dO, dS^T q).
//
// Design: both are the Hopper-native backward bodies of flash_bwd_sm90.cuh
// (wgmma + TMA, one producer and two consumer warpgroups, a 128-row
// resident tile per CTA against a TMA ring of 64-row tiles; P and dS fed
// to the next product from registers; the GQA group of dk/dv summed in
// registers, no atomics, so both are deterministic), the same bodies the
// triangular family instantiates in base 2. Here they run in natural exp
// and read the resident forward's natural-log lse as it is, and the
// runtime causal flag gives one instance for both modes: a causal loop
// stops at the diagonal and masks it, a non-causal one walks every tile
// and masks only a ragged last KV tile (dq; dk/dv's q rows past S add
// exactly 0). flash_dq writes delta for flash_dkv, so that kernel never
// reads O. Each walks a host-built work list (ops/flash_attention.py:
// tri_schedule), one CTA per item: dq's items are (b*h, 128-row q tile),
// dk/dv's (b*KVH, 128-row kv tile), longest causal item first.
#include "flash_bwd_sm90.cuh"

namespace stpu {
namespace {

template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const BwdParams p,
                const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::dq_cta<D, T, BaseE>(tq, tdo, tk, tv, p, work, smem);
}

template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tlse,
                 const __grid_constant__ CUtensorMap tdlt, const BwdParams p,
                 const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::dkv_cta<D, T, BaseE>(tq, tdo, tk, tv, tlse, tdlt, p, work, smem);
}

}  // namespace
}  // namespace stpu

// work: B*H*ceil(S/128) (b*h, 128-row q tile) int32 pairs. dtype: the
// element type of q, k, v, o, dO and dq (Bf16::kDtype, F16::kDtype).
// strides: (batch, seq, head) in elements for q, k, v, o, dO. dq (B, S, H,
// D) and delta (B, H, S) fp32 are written contiguous; lse is natural-log.
extern "C" int stpu_flash_dq(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const void* lse, void* dq, void* delta,
                             const void* work, const long long* strides,
                             int B, int S, int H, int KVH, int D, int dtype,
                             float scale, int causal, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                                 nullptr, strides, S, H, KVH, scale, causal);
  STPU_SM90_BY_D(D, dtype, launch_dq, flash_dq_kernel, p, B,
                 static_cast<const int*>(work),
                 static_cast<cudaStream_t>(stream));
}

// work: B*KVH*ceil(S/128) (b*KVH, 128-row kv tile) int32 pairs. strides:
// (batch, seq, head) in elements for q, k, v, dO. dk and dv are written
// contiguous (B, S, KVH, D), of the inputs' type; lse and delta (B, H, S)
// fp32 are read through tensor maps.
extern "C" int stpu_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              const void* work, const long long* strides,
                              int B, int S, int H, int KVH, int D, int dtype,
                              float scale, int causal, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, nullptr, dout, lse, delta, nullptr,
                                 dk, dv, strides, S, H, KVH, scale, causal);
  STPU_SM90_BY_D(D, dtype, launch_dkv, flash_dkv_kernel, p, B,
                 static_cast<const int*>(work),
                 static_cast<cudaStream_t>(stream));
}

// The build reports of the (head_dim D, element type dtype) instances
// (sm90::kernel_attrs): five ints each, registers at launch, dynamic shared
// memory, threads, producer and consumer registers.
extern "C" int stpu_flash_dq_attrs(int D, int dtype, int* out) {
  STPU_SM90_BY_D(D, dtype, dq_attrs, stpu::flash_dq_kernel, out);
}

extern "C" int stpu_flash_dkv_attrs(int D, int dtype, int* out) {
  STPU_SM90_BY_D(D, dtype, dkv_attrs, stpu::flash_dkv_kernel, out);
}
