// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax: the
// resident family.
//
// Replaces skypilot_tpu/ops/pallas/flash_attention.py:_fwd_kernel_resident
// (launched by _flash_fwd_resident). Computes, for each (b, h) and q tile,
// o = softmax(scale * q k^T, causal) v and lse = m + log(l) (natural log),
// with query head h reading KV head h / (H / KVH).
//
// What bounds it: at the training shapes (S 2048, D 128) it does ~2*S*D
// flops per byte of q/k/v/o, far above the card's ~295 flop/byte ridge, so
// the tensor cores bound it. Design: one block of 4 warps per (q tile of 64
// rows, b*h), running fwd_tile (flash_common.cuh): the TPU grid's
// sequential "arbitrary" axis becomes the block's loop over K/V tiles up to
// the causal bound, q k^T and P v run on the tensor cores with mma.sync
// m16n8k16, and P feeds the second product straight from the registers
// that hold the scores, cast to bf16 as the JAX kernel does. Only the
// diagonal tile is masked. q tiles are scheduled longest-first so the
// causal tail does not idle the card. No cp.async pipelining, wgmma or TMA
// yet: those are the next steps.
#include "flash_common.cuh"

namespace stpu {
namespace {

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qt = p.S / kTile - 1 - blockIdx.x;  // longest causal rows first
  fwd_tile<D, BaseE>(p, blockIdx.y / p.H, blockIdx.y % p.H, qt, smem);
}

}  // namespace
}  // namespace stpu

// strides: (batch, seq, head) in elements for q, k, v. o is written
// contiguous (B, S, H, D) and lse (B, H, S) fp32.
extern "C" int stpu_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const long long* strides,
                              int B, int S, int H, int KVH, int D,
                              float scale, int causal, void* stream) {
  using namespace stpu;
  if (S % kTile || H % KVH) return (int)cudaErrorInvalidValue;
  const FwdParams p =
      fwd_params(q, k, v, o, lse, strides, S, H, KVH, scale, causal);
  const dim3 grid(S / kTile, B * H);
  STPU_LAUNCH_BY_D(D, flash_fwd_kernel, fwd_smem_bytes, grid,
                   static_cast<cudaStream_t>(stream), p);
}
