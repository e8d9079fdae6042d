// Flash attention for long causal sequences on Hopper (sm_90a): the
// triangular family, forward, dq and dk/dv.
//
// Replaces skypilot_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_tri_kernel  <- _fwd_kernel_tri (launched by _flash_fwd_tri),
//   flash_dq_tri_kernel   <- _dq_kernel_tri  (launched by _flash_bwd_tri),
//   flash_dkv_tri_kernel  <- _dkv_kernel_tri (launched by _flash_bwd_tri).
// The JAX dispatcher sends causal attention here once 3*S*D*4 bytes pass
// its resident budget (S*D > 524,288, so S > 4096 at head_dim 128). The
// functions are the triangular family's own: the softmax runs in exp2 with
// scale*log2(e) folded into the one multiply each score takes (the TPU
// kernel pre-scales q instead), and lse is written in base 2, (B, H, S)
// fp32; dq and dk come out with the plain logit scale, which is the TPU
// kernels' scale and 1/log2(e) undo of the pre-scaled q. dq also writes
// delta = rowsum(dO * O) for dk/dv (the TPU kernels recompute it in both).
//
// What bounds them: at S 8192, D 128 each kernel does ~S*D/2 flops per
// byte it must move, far past the card's ~295 flop/byte ridge, so the
// tensor cores. The forward is the Hopper-native body of
// flash_fwd_sm90.cuh (wgmma + TMA, warp specialised), writing its base-2
// lse as it is. dq and dk/dv run the resident family's tile bodies
// (flash_common.cuh: mma.sync m16n8k16 from ldmatrix fragments, P and dS
// fed from registers, the GQA group of dk/dv summed in registers without
// atomics), instanced in base 2.
//
// Schedule: the TPU kernels walk scalar-prefetched maps of the lower-
// triangle block pairs (_tri_maps_row, _tri_maps_col). Here the host builds
// the counterpart once per shape (ops/flash_attention.py: tri_schedule), an
// int32 list of (b*h, tile) items sorted by how many tile pairs each one
// computes, longest first, across every head; block i takes item i. Blocks
// are dispatched in index order, so the list acts as one longest-first
// queue over the whole launch and the short causal rows fill the last wave.
// Inside an item the loop stops at the diagonal, so no fully masked tile is
// loaded, and only the straddling tile runs the masked step. The forward's
// list counts 128-row q tiles, dq's 64-row q tiles, dk/dv's 64-row kv
// tiles.
#include "flash_fwd_sm90.cuh"

namespace stpu {
namespace {

template <int D>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_fwd_tri_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const FwdParams p, const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::fwd_cta<D, /*kNaturalLse=*/false>(tq, tk, tv, p, work, smem);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_tri_kernel(const BwdParams p, const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = work[2 * blockIdx.x], qt = work[2 * blockIdx.x + 1];
  dq_tile<D, Base2>(p, bh / p.H, bh % p.H, qt, smem);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_tri_kernel(const BwdParams p, const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bkv = work[2 * blockIdx.x], kt = work[2 * blockIdx.x + 1];
  dkv_tile<D, Base2>(p, bkv / p.KVH, bkv % p.KVH, kt, smem);
}

}  // namespace
}  // namespace stpu

// work: B*H*ceil(S/128) (b*h, q tile) int32 pairs. strides: (batch, seq,
// head) in elements for q, k, v. o is written contiguous (B, S, H, D) bf16
// and lse (B, H, S) fp32, base 2.
extern "C" int stpu_flash_fwd_tri(const void* q, const void* k,
                                  const void* v, void* o, void* lse,
                                  const void* work, const long long* strides,
                                  int B, int S, int H, int KVH, int D,
                                  float scale, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const FwdParams p = fwd_params(q, k, v, o, lse, strides, S, H, KVH, scale,
                                 /*causal=*/1);
  STPU_LAUNCH_FWD_SM90(D, flash_fwd_tri_kernel, p, B,
                       static_cast<const int*>(work),
                       static_cast<cudaStream_t>(stream));
}

// Registers per thread at launch and dynamic shared memory of the head_dim
// D instance of the forward.
extern "C" int stpu_flash_fwd_tri_attrs(int D, int* regs, int* smem) {
  STPU_FWD_SM90_ATTRS(D, stpu::flash_fwd_tri_kernel, regs, smem);
}

// work: B*H*ceil(S/64) (b*h, q tile) int32 pairs. strides: q, k, v, o, dO.
// dq (B, S, H, D) bf16 and delta (B, H, S) fp32 are written contiguous;
// lse is base 2.
extern "C" int stpu_flash_dq_tri(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* dq, void* delta,
                                 const void* work, const long long* strides,
                                 int B, int S, int H, int KVH, int D,
                                 float scale, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                                 nullptr, strides, S, H, KVH, scale, 1);
  const int* w = static_cast<const int*>(work);
  const dim3 grid(B * H * ceil_div(S, kTile));
  STPU_LAUNCH_BY_D(D, flash_dq_tri_kernel, dq_smem_bytes, grid,
                   static_cast<cudaStream_t>(stream), p, w);
}

// work: B*KVH*ceil(S/64) (b*KVH, kv tile) int32 pairs. strides: q, k, v,
// dO.
// dk and dv are written contiguous (B, S, KVH, D) bf16.
extern "C" int stpu_flash_dkv_tri(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, const void* work,
                                  const long long* strides, int B, int S,
                                  int H, int KVH, int D, float scale,
                                  void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, nullptr, dout, lse, delta, nullptr,
                                 dk, dv, strides, S, H, KVH, scale, 1);
  const int* w = static_cast<const int*>(work);
  const dim3 grid(B * KVH * ceil_div(S, kTile));
  STPU_LAUNCH_BY_D(D, flash_dkv_tri_kernel, dkv_smem_bytes, grid,
                   static_cast<cudaStream_t>(stream), p, w);
}
