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
// streams that operand through a shared-memory ring whatever S is. So:
//
// - The forward and dk/dv are the Hopper bodies (wgmma + TMA, one producer
//   and two consumer warpgroups, a host-built work list; every bf16 and
//   f16 instance at head_dim 64 and 128): flash_fwd_sm90.cuh's fwd_cta in
//   natural log, as flash_fwd.cu's, and flash_bwd_sm90.cuh's dkv_cta in
//   natural exp, as flash_bwd.cu's. For its long non-causal loops (64 K/V
//   tiles a CTA) the forward takes the schedule the resident and
//   triangular instances leave off: each consumer's softmax overlaps its
//   own P V (fwd_cta's kOverlap; the two consumers in ping-pong on top
//   measured no faster and were dropped). dk/dv is the resident instance's
//   body as it is, in lockstep (its consumers offset half a tile measured
//   no faster).
// - dq keeps its mma.sync body (flash_common.cuh's dq_step: m16n8k16 from
//   ldmatrix fragments, 64-row q tiles, 4 warps), its K/V tiles staged by
//   a two-stage cp.async ring: at the top of step j one barrier makes tile
//   j visible and frees the stage tile j-1 used; the block then issues the
//   copy of tile j+1 into that stage and runs tile j's products while it
//   is in flight. 104 KB of shared memory at D = 128, two blocks per SM.
#include "flash_bwd_sm90.cuh"

namespace stpu {
namespace {

// Elements of one shared tile of `rows` rows.
template <int D>
__host__ __device__ constexpr int tile_elems(int rows) {
  return rows * row_elems(D);
}

template <int D>
constexpr int dq_streamed_smem_bytes() {
  return (2 + 2 * kStages) * tile_elems<D>(kTile) * (int)sizeof(e16) +
         kTile * (int)sizeof(float);
}

// Issue the copies of K/V tile j (rows j*64..) into ring stage j % kStages.
// Rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void issue_kv(const e16* kg, const e16* vg,
                                         long long k_ss, long long v_ss,
                                         int S, int j, e16* sK, e16* sV) {
  const int st = j % kStages;
  const int r0 = j * kTile;
  load_tile_async<D, kTile>(sK + st * tile_elems<D>(kTile),
                            kg + (long long)r0 * k_ss, k_ss, S - r0);
  load_tile_async<D, kTile>(sV + st * tile_elems<D>(kTile),
                            vg + (long long)r0 * v_ss, v_ss, S - r0);
  cp_async_commit();
}

template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_fwd_streamed_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const FwdParams p, const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::fwd_cta<D, T, /*kNaturalLse=*/true, /*kOverlap=*/true>(tq, tk, tv, p,
                                                               work, smem);
}

template <int D, class T>
__global__ void __launch_bounds__(kThreads)
flash_dq_streamed_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTE = tile_elems<D>(kTile);
  e16* sQ = reinterpret_cast<e16*>(smem);
  e16* sdO = sQ + kTE;
  e16* sK = sdO + kTE;            // kStages K tiles, then
  e16* sV = sK + kStages * kTE;   // kStages V tiles
  float* sDelta = reinterpret_cast<float*>(sV + kStages * kTE);

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  // longest causal rows first
  const int qt = ceil_div(p.S, kTile) - 1 - blockIdx.x;
  const int q_start = qt * kTile;
  const int valid = p.S - q_start;
  const int wrow = (threadIdx.x / 32) * 16, g = (threadIdx.x % 32) / 4;
  const e16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const e16* vg = p.v + b * p.v_sb + kvh * p.v_sh;
  const long long stat = ((long long)b * p.H + h) * p.S + q_start;

  // Prologue: q, dO and K/V tile 0 in one group; then delta from O.
  load_tile_async<D, kTile>(sQ, p.q + b * p.q_sb + h * p.q_sh +
                                    q_start * p.q_ss, p.q_ss, valid);
  load_tile_async<D, kTile>(sdO, p.dout + b * p.do_sb + h * p.do_sh +
                                     q_start * p.do_ss, p.do_ss, valid);
  issue_kv<D>(kg, vg, p.k_ss, p.v_ss, p.S, 0, sK, sV);
  cp_async_wait_all();
  __syncthreads();
  tile_delta<D, T>(p, p.o + b * p.o_sb + h * p.o_sh + q_start * p.o_ss,
                   sdO, sDelta, stat, valid);
  __syncthreads();

  // Rows past S are never stored; any finite lse keeps them finite.
  const float lse_r[2] = {wrow + g < valid ? p.lse[stat + wrow + g] : 0.f,
                          wrow + g + 8 < valid ? p.lse[stat + wrow + g + 8]
                                               : 0.f};
  const float dlt_r[2] = {sDelta[wrow + g], sDelta[wrow + g + 8]};
  const float sm = p.scale * BaseE::kScoreMul;
  const TileMask mask = {p.S, p.causal};

  float dq[D / 8][4];
  zero(dq);

  const int n_kt = p.causal ? qt + 1 : ceil_div(p.S, kTile);
  const int j_mask = masked_tile(p.causal, p.S, kTile, n_kt);
  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_kt)
      issue_kv<D>(kg, vg, p.k_ss, p.v_ss, p.S, j + 1, sK, sV);
    const e16* k_t = sK + (j % kStages) * kTE;
    const e16* v_t = sV + (j % kStages) * kTE;
    if (j == j_mask)
      dq_step<D, T, BaseE, true>(sQ, sdO, k_t, v_t, q_start, j * kTile,
                                 mask, sm, lse_r, dlt_r, dq);
    else
      dq_step<D, T, BaseE, false>(sQ, sdO, k_t, v_t, q_start, j * kTile,
                                  mask, sm, lse_r, dlt_r, dq);
  }
  store_dq<D, T>(p, b, h, q_start, dq);
}

template <int D, class T>
__global__ void __launch_bounds__(sm90::kFwdThreads, 1)
flash_dkv_streamed_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tlse,
                          const __grid_constant__ CUtensorMap tdlt,
                          const BwdParams p, const int* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  sm90::dkv_cta<D, T, BaseE>(tq, tdo, tk, tv, tlse, tdlt, p, work, smem);
}

}  // namespace
}  // namespace stpu

// work: B*H*ceil(S/128) (b*h, q tile) int32 pairs. dtype: the element type
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
      fwd_params(q, k, v, o, lse, strides, S, H, KVH, scale, causal);
  STPU_SM90_BY_D(D, dtype, launch_fwd, flash_fwd_streamed_kernel, p, B,
                 static_cast<const int*>(work),
                 static_cast<cudaStream_t>(stream), /*overlap=*/true);
}

// strides: q, k, v, o, dO. dq (B, S, H, D), of the inputs' type, and
// delta (B, H, S) fp32 are written contiguous; lse and delta are 16-byte
// aligned.
extern "C" int stpu_flash_dq_streamed(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq, void* delta,
                                      const long long* strides, int B, int S,
                                      int H, int KVH, int D, int dtype,
                                      float scale, int causal,
                                      void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                                 nullptr, strides, S, H, KVH, scale, causal);
  const dim3 grid(ceil_div(S, kTile), B * H);
  STPU_LAUNCH_BY_D(D, dtype, flash_dq_streamed_kernel,
                   dq_streamed_smem_bytes, grid,
                   static_cast<cudaStream_t>(stream), p);
}

// work: B*KVH*ceil(S/128) (b*KVH, 128-row kv tile) int32 pairs. strides:
// q, k, v, dO. dk and dv are written contiguous (B, S, KVH, D), of the
// inputs' type; lse and delta (B, H, S) fp32 are read through tensor maps.
extern "C" int stpu_flash_dkv_streamed(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, const void* work,
                                       const long long* strides, int B, int S,
                                       int H, int KVH, int D, int dtype,
                                       float scale, int causal,
                                       void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, nullptr, dout, lse, delta, nullptr,
                                 dk, dv, strides, S, H, KVH, scale, causal);
  STPU_SM90_BY_D(D, dtype, launch_dkv, flash_dkv_streamed_kernel, p, B,
                 static_cast<const int*>(work),
                 static_cast<cudaStream_t>(stream));
}

// The build reports of the Hopper instances at (head_dim D, element type
// dtype) (sm90::kernel_attrs): five ints, registers at launch, dynamic
// shared memory, threads, producer and consumer registers.
extern "C" int stpu_flash_fwd_streamed_attrs(int D, int dtype, int* out) {
  STPU_SM90_BY_D(D, dtype, fwd_attrs, stpu::flash_fwd_streamed_kernel, out,
                 /*overlap=*/true);
}

extern "C" int stpu_flash_dkv_streamed_attrs(int D, int dtype, int* out) {
  STPU_SM90_BY_D(D, dtype, dkv_attrs, stpu::flash_dkv_streamed_kernel, out);
}
