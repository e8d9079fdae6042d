// Flash-attention forward for Hopper (sm_90a), bf16 or f16 in and out,
// fp32 softmax: the resident family.
//
// Replaces skypilot_tpu/ops/pallas/flash_attention.py:_fwd_kernel_resident
// (launched by _flash_fwd_resident). Computes, for each (b, h) and q tile,
// o = softmax(scale * q k^T, causal) v and lse = m + log(l) (natural log),
// with query head h reading KV head h / (H / KVH).
//
// What bounds it: at the training shapes (S 2048, D 128) it does ~2*S*D
// flops per byte of q/k/v/o, far above the card's ~295 flop/byte ridge, so
// the tensor cores bound it. Design: the Hopper-native forward of
// flash_fwd_sm90.cuh (one producer warpgroup issuing TMA loads into a K/V
// ring, two consumer warpgroups running wgmma), whose softmax works in
// exp2; this instance writes its base-2 lse times ln 2, the natural-log lse
// that flash_dq and flash_dkv read. The TPU grid's sequential "arbitrary"
// axis becomes each consumer's loop over K/V tiles up to the causal bound.
// One CTA per item of a host-built longest-first work list of 128-row q
// tiles (ops/flash_attention.py: tri_schedule), so the causal tail does
// not idle the card.
#include "flash_fwd_sm90.cuh"

namespace stpu {
namespace {

template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const FwdParams p,
                 const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::fwd_cta<D, T, /*kNaturalLse=*/true>(tq, tk, tv, p, work, smem);
}

}  // namespace
}  // namespace stpu

// work: B*H*ceil(S/128) (b*h, q tile) int32 pairs. dtype: the element type
// of q, k, v and o (Bf16::kDtype, F16::kDtype). strides: (batch, seq, head)
// in elements for q, k, v. o is written contiguous (B, S, H, D) and lse
// (B, H, S) fp32.
extern "C" int stpu_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* work,
                              const long long* strides, int B, int S, int H,
                              int KVH, int D, int dtype, float scale,
                              int causal, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const FwdParams p =
      fwd_params(q, k, v, o, lse, strides, S, H, KVH, scale, causal);
  STPU_SM90_BY_D(D, dtype, launch_fwd, flash_fwd_kernel, p, B,
                 static_cast<const int*>(work),
                 static_cast<cudaStream_t>(stream));
}

// The build report of the (head_dim D, element type dtype) instance
// (sm90::kernel_attrs): five ints, registers at launch, dynamic shared
// memory, threads, producer and consumer registers.
extern "C" int stpu_flash_fwd_attrs(int D, int dtype, int* out) {
  STPU_SM90_BY_D(D, dtype, fwd_attrs, stpu::flash_fwd_kernel, out);
}
