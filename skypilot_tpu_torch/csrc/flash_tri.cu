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
// tensor cores. All three are Hopper-native (wgmma + TMA, warp
// specialised): the forward is the body of flash_fwd_sm90.cuh, writing
// its base-2 lse as it is; dq and dk/dv are the bodies of
// flash_bwd_sm90.cuh (one CTA per 128-row tile of the resident operand, a
// TMA ring of 64-row tiles of the streamed one, P and dS fed to the next
// product from registers, the GQA group of dk/dv summed in registers
// without atomics), instanced in base 2. Each kernel has a bf16 and an
// f16 instance at head_dim 64, 128 and 256 (Gemma's, on the bodies' wide
// paths; the JAX dispatcher sends Gemma here past S 2048), and 512 (on
// the cluster bodies fwd_cta_512, dq_cta_512, dkv_cta_512: two CTAs an
// item, each holding one 256-column chunk of every operand, 64-row
// streamed tiles, the two exchanging their partials of S and dP (S^T and
// dP^T) through distributed shared memory; flash_fwd_sm90.cuh,
// flash_bwd_sm90.cuh), and one instance for every multiple of 256 up to
// 2048 past it (fwd_cta_x, dq_cta_x, dkv_cta_x: clusters of head_dim /
// 256 CTAs, every rank reading the others' partials in rank order):
// - the forward: 64-row K/V tiles, Q in shared memory;
// - dq: DqSplitKV (flash_bwd_sm90.cuh), 64-row K tiles in two stages and
//   V in one on barriers of their own, so V's next load runs under dS K
//   and K's next tile is resident a tile ahead; S and dP as m64n64, the
//   warpgroup index uniform so the descriptors sit in uniform registers
//   and nothing spills. In turns at Gemma-2B's 1 x 8192 (H100 SXM, 700
//   W; PERF.md) it runs 0.546 ms against the one-stage ring's
//   0.861 (this kernel's body before; it spills 60 B) and DqWide's 0.758
//   (32-row tiles in three stages, S and dP as m64n32 with both operands
//   in shared memory, held by its 128 B a clock), and DqWide with Q from
//   registers for S's first 4 or 8 k steps at 0.760-0.761;
// - dk/dv: dkv_cta_wide, one 64-row kv tile per CTA, dv and dk in
//   separate consumers, the GQA group split in P parts across CTAs and
//   summed in part order by the last to finish.
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
// and dq's lists count 128-row q tiles (dq's pairs against the 64-row KV
// tiles it walks at every width), dk/dv's 128-row kv tiles (pairs against
// 64-row q tiles), and at head_dim 256 (kv tile, part) items of 64-row kv
// tiles (dkv_wide_schedule); at 512 dq's list counts 64-row q tiles
// against 64-row KV tiles (dq_schedule) and dk/dv keeps the width-256
// items, each item a cluster of two CTAs.
#include "flash_bwd_sm90.cuh"

namespace stpu {
namespace {

template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_fwd_tri_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const FwdParams p, const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::fwd_cta<D, T, /*kNaturalLse=*/false>(tq, tk, tv, p, work, smem);
}

template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_dq_tri_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const BwdParams p, const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (D == sm90::kClusterD)
    sm90::dq_cta_x<T, Base2>(tq, tdo, tk, tv, p, work, smem);
  else if constexpr (D > 256)
    sm90::dq_cta_512<D, T, Base2>(tq, tdo, tk, tv, p, work, smem);
  else
    sm90::dq_cta<D, T, Base2, 0, sm90::DqTri<D>>(tq, tdo, tk, tv, p, work,
                                                 smem);
}

template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_dkv_tri_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tlse,
                     const __grid_constant__ CUtensorMap tdlt,
                     const BwdParams p, const int* __restrict__ work,
                     const sm90::DkvSplit split) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (D == sm90::kClusterD)
    sm90::dkv_cta_x<T, Base2>(tq, tdo, tk, tv, tlse, tdlt, p, work, split,
                              smem);
  else if constexpr (D > 256)
    sm90::dkv_cta_512<D, T, Base2>(tq, tdo, tk, tv, tlse, tdlt, p, work,
                                    split, smem);
  else if constexpr (D > 128)
    sm90::dkv_cta_wide<D, T, Base2>(tq, tdo, tk, tv, tlse, tdlt, p, work,
                                     split, smem);
  else
    sm90::dkv_cta<D, T, Base2>(tq, tdo, tk, tv, tlse, tdlt, p, work, smem);
}

}  // namespace
}  // namespace stpu

// work: B*H*ceil(S/128) (b*h, q tile) int32 pairs (at head_dim 512 two
// CTAs an item, one per 256-column chunk of o). dtype: the element type
// of q, k, v and o (Bf16::kDtype, F16::kDtype). strides: (batch, seq, head)
// in elements for q, k, v. o is written contiguous (B, S, H, D) and lse
// (B, H, S) fp32, base 2.
extern "C" int stpu_flash_fwd_tri(const void* q, const void* k,
                                  const void* v, void* o, void* lse,
                                  const void* work, const long long* strides,
                                  int B, int S, int H, int KVH, int D,
                                  int dtype, float scale, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const FwdParams p = fwd_params(q, k, v, o, lse, strides, S, H, KVH, scale,
                                 /*causal=*/1, D);
  STPU_SM90_BY_D(D, dtype, launch_fwd, flash_fwd_tri_kernel, p, B,
                 static_cast<const int*>(work),
                 static_cast<cudaStream_t>(stream));
}

// work: B*H*ceil(S/128) (b*h, 128-row q tile) int32 pairs (at head_dim
// 512 B*H*ceil(S/64), 64-row tiles, two CTAs an item). strides: q, k,
// v, o, dO. dq (B, S, H, D), of the inputs' type, and delta (B, H, S) fp32
// are written contiguous; lse is base 2.
extern "C" int stpu_flash_dq_tri(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* dq, void* delta,
                                 const void* work, const long long* strides,
                                 int B, int S, int H, int KVH, int D,
                                 int dtype, float scale, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                                 nullptr, strides, S, H, KVH, scale, 1, D);
  STPU_SM90_BY_D(D, dtype, launch_dq_tri, flash_dq_tri_kernel, p, B,
                 static_cast<const int*>(work),
                 static_cast<cudaStream_t>(stream));
}

// work: at head_dim 64 and 128, B*KVH*ceil(S/128) (b*KVH, 128-row kv tile)
// int32 pairs and parts 1; at 256, B*KVH*ceil(S/64)*parts (b*KVH, 64-row kv
// tile, part) triples, parts dividing H / KVH, and with parts > 1 an fp32
// workspace ws of (2, parts, B, S, KVH, D) and 2*B*KVH*ceil(S/64) int32
// tickets, zero (dkv_cta_wide); at 512 the same items, a cluster of two
// CTAs each, and 4*B*KVH*ceil(S/64) tickets (dkv_cta_512). strides: q,
// k, v, dO. dk and dv are written contiguous (B, S, KVH, D), of the
// inputs' type.
extern "C" int stpu_flash_dkv_tri(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, const void* work,
                                  void* ws, void* tickets,
                                  const long long* strides, int B, int S,
                                  int H, int KVH, int D, int dtype,
                                  float scale, int parts, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, nullptr, dout, lse, delta, nullptr,
                                 dk, dv, strides, S, H, KVH, scale, 1, D);
  const sm90::DkvSplit split = {static_cast<float*>(ws),
                                static_cast<int*>(tickets), parts, B};
  STPU_SM90_BY_D(D, dtype, launch_dkv_split, flash_dkv_tri_kernel, p, B,
                 static_cast<const int*>(work), split,
                 static_cast<cudaStream_t>(stream));
}

// The build reports of the (head_dim D, element type dtype) instances
// (sm90::kernel_attrs): five ints each, registers at launch, dynamic shared
// memory, threads, producer and consumer registers.
extern "C" int stpu_flash_fwd_tri_attrs(int D, int dtype, int* out) {
  STPU_SM90_BY_D(D, dtype, fwd_attrs, stpu::flash_fwd_tri_kernel, out);
}

extern "C" int stpu_flash_dq_tri_attrs(int D, int dtype, int* out) {
  STPU_SM90_BY_D(D, dtype, dq_tri_attrs, stpu::flash_dq_tri_kernel, out);
}

extern "C" int stpu_flash_dkv_tri_attrs(int D, int dtype, int* out) {
  STPU_SM90_BY_D(D, dtype, dkv_attrs, stpu::flash_dkv_tri_kernel, out);
}
