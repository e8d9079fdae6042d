// Flash attention for long non-causal sequences on Hopper (sm_90a): the
// streamed family, forward, dq and dk/dv.
//
// Replaces skypilot_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_streamed_kernel <- _fwd_kernel (launched by _flash_fwd_streamed),
//   flash_dq_streamed_kernel  <- _dq_kernel  (launched by _flash_bwd_streamed),
//   flash_dkv_streamed_kernel <- _dkv_kernel (launched by _flash_bwd_streamed).
// The JAX dispatcher sends non-causal attention here once 3*S*D*4 bytes pass
// its resident budget (S*D > 524,288, so S > 4096 at head_dim 128). The
// functions are the TPU kernels': natural exp, lse = m + log(l) in natural
// log, (B, H, S) fp32; the causal flag is honoured as there, with the causal
// KV (or q) range cut to the diagonal and only the straddling tile masked.
// delta = rowsum(dO * O) follows the port's convention: the dq kernel
// computes it once per q tile and writes it, and the dk/dv kernel reads it
// (the TPU dk/dv kernel recomputes it from o and dO at every step; the two
// give the same function, and this way dk/dv never reads O).
//
// What bounds them: at (1, 8192, 32, 8, 128) non-causal each kernel does
// 5,500 to 11,000 flops per byte it must move (the order of S), far past
// the card's ~295 flop/byte ridge, so the tensor cores (bounds 1.11, 1.67
// and 2.22 ms by operations for forward, dq and dk/dv).
//
// On the TPU the streamed family differs from the resident one by how it
// stages the KV (or q/dO) stream through VMEM; on Hopper every body
// streams that operand through a shared-memory ring whatever S is, so all
// three kernels are instances of the Hopper bodies (wgmma + TMA, one producer
// and two consumer warpgroups, a host-built work list; every bf16 and f16
// instance at head_dim 64, 128, 256 and 512), reading and writing a
// natural-log lse with the runtime causal flag, as flash_fwd.cu's and
// flash_bwd.cu's, each with what its long loops (64 or 128 tiles a CTA at S
// 8192) take:
//
// - the forward, flash_fwd_sm90.cuh's fwd_cta with the overlapped
//   schedule (kOverlap: each consumer's softmax under its own P V; the
//   two consumers in ping-pong on top measured no faster and were
//   dropped); at head_dim 256 the wide body in lockstep with Q in
//   shared memory (the overlapped schedule there, clusters of two CTAs
//   sharing each K/V load, and the resident forward's kWideQReg k steps
//   of S with Q in registers measured no faster at (1, 4096, 8, 1, 256)
//   non-causal: PERF.md);
// - dq, flash_bwd_sm90.cuh's dq_cta with each consumer's 64 rows of Q
//   and dO held as wgmma A fragments in registers for the whole loop
//   (kRegA = 2: S = Q K^T and dP = dO V^T read only their K or V tile
//   from shared memory, half of what two shared-memory operands take)
//   and the natural-log lse taken into base 2 once per row (BaseE2: one
//   FFMA and one ex2 a score, where natural exp takes a multiply, a range
//   test and two predicated multiplies more); at head_dim 256 Q and dO
//   stay in shared memory (kRegA = 0: their fragments would take 128
//   registers beside dq's 128);
// - dk/dv, dkv_cta as the resident instance runs it, in lockstep (its
//   consumers offset half a tile measured no faster); at head_dim 256
//   dkv_cta_wide, as the triangular family's, in natural exp;
// - at head_dim 512 the cluster bodies of every family (fwd_cta_512,
//   dq_cta_512 in BaseE2, dkv_cta_512 in natural exp), and past it, one
//   instance for every multiple of 256 up to 2048, fwd_cta_x, dq_cta_x in
//   BaseE2 and dkv_cta_x in natural exp.
#include "flash_bwd_sm90.cuh"

namespace stpu {
namespace {

template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_fwd_streamed_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const FwdParams p, const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::fwd_cta<D, T, /*kNaturalLse=*/true, /*kOverlap=*/(D <= 128)>(
      tq, tk, tv, p, work, smem);
}

template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_dq_streamed_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const BwdParams p, const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (D == sm90::kClusterD)
    sm90::dq_cta_x<T, BaseE2>(tq, tdo, tk, tv, p, work, smem);
  else if constexpr (D > 256)
    sm90::dq_cta_512<D, T, BaseE2>(tq, tdo, tk, tv, p, work, smem);
  else
    sm90::dq_cta<D, T, BaseE2, /*kRegA=*/(D > 128 ? 0 : 2)>(tq, tdo, tk, tv,
                                                            p, work, smem);
}

template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_dkv_streamed_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tlse,
                          const __grid_constant__ CUtensorMap tdlt,
                          const BwdParams p, const int* __restrict__ work,
                          const sm90::DkvSplit split) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (D == sm90::kClusterD)
    sm90::dkv_cta_x<T, BaseE>(tq, tdo, tk, tv, tlse, tdlt, p, work, split,
                              smem);
  else if constexpr (D > 256)
    sm90::dkv_cta_512<D, T, BaseE>(tq, tdo, tk, tv, tlse, tdlt, p, work,
                                    split, smem);
  else if constexpr (D > 128)
    sm90::dkv_cta_wide<D, T, BaseE>(tq, tdo, tk, tv, tlse, tdlt, p, work,
                                     split, smem);
  else
    sm90::dkv_cta<D, T, BaseE>(tq, tdo, tk, tv, tlse, tdlt, p, work, smem);
}

}  // namespace
}  // namespace stpu

// work: B*H*ceil(S/128) (b*h, q tile) int32 pairs (at head_dim 512 two
// CTAs an item, one per 256-column chunk of o). dtype: the element type
// of q, k, v and o (Bf16::kDtype, F16::kDtype). strides: (batch, seq, head)
// in elements for q, k, v. o is written contiguous (B, S, H, D) and lse
// (B, H, S) fp32, natural log.
extern "C" int stpu_flash_fwd_streamed(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       const void* work,
                                       const long long* strides, int B, int S,
                                       int H, int KVH, int D, int dtype,
                                       float scale, int causal,
                                       void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const FwdParams p =
      fwd_params(q, k, v, o, lse, strides, S, H, KVH, scale, causal, D);
  STPU_SM90_BY_D(D, dtype, launch_fwd, flash_fwd_streamed_kernel, p, B,
                 static_cast<const int*>(work),
                 static_cast<cudaStream_t>(stream), /*overlap=*/true);
}

// work: B*H*ceil(S/128) (b*h, 128-row q tile) int32 pairs (at head_dim
// 512 B*H*ceil(S/64), 64-row tiles, two CTAs an item). strides: q, k,
// v, o, dO. dq (B, S, H, D), of the inputs' type, and delta (B, H, S) fp32
// are written contiguous; lse is natural-log.
extern "C" int stpu_flash_dq_streamed(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq, void* delta, const void* work,
                                      const long long* strides, int B, int S,
                                      int H, int KVH, int D, int dtype,
                                      float scale, int causal,
                                      void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                                 nullptr, strides, S, H, KVH, scale, causal, D);
  STPU_SM90_BY_D(D, dtype, launch_dq, flash_dq_streamed_kernel, p, B,
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
// inputs' type; lse and delta (B, H, S) fp32 are read through tensor
// maps.
extern "C" int stpu_flash_dkv_streamed(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, const void* work,
                                       void* ws, void* tickets,
                                       const long long* strides, int B, int S,
                                       int H, int KVH, int D, int dtype,
                                       float scale, int causal, int parts,
                                       void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, nullptr, dout, lse, delta, nullptr,
                                 dk, dv, strides, S, H, KVH, scale, causal, D);
  const sm90::DkvSplit split = {static_cast<float*>(ws),
                                static_cast<int*>(tickets), parts, B};
  STPU_SM90_BY_D(D, dtype, launch_dkv_split, flash_dkv_streamed_kernel, p, B,
                 static_cast<const int*>(work), split,
                 static_cast<cudaStream_t>(stream));
}

// The build reports of the Hopper instances at (head_dim D, element type
// dtype) (sm90::kernel_attrs): five ints, registers at launch, dynamic
// shared memory, threads, producer and consumer registers.
extern "C" int stpu_flash_fwd_streamed_attrs(int D, int dtype, int* out) {
  STPU_SM90_BY_D(D, dtype, fwd_attrs, stpu::flash_fwd_streamed_kernel, out,
                 /*overlap=*/true);
}

extern "C" int stpu_flash_dq_streamed_attrs(int D, int dtype, int* out) {
  STPU_SM90_BY_D(D, dtype, dq_attrs, stpu::flash_dq_streamed_kernel, out);
}

extern "C" int stpu_flash_dkv_streamed_attrs(int D, int dtype, int* out) {
  STPU_SM90_BY_D(D, dtype, dkv_attrs, stpu::flash_dkv_streamed_kernel, out);
}
