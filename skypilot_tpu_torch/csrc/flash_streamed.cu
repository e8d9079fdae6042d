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
// and 2.22 ms by operations for forward, dq and dk/dv). The tile steps are
// flash_common.cuh's (mma.sync m16n8k16 from ldmatrix fragments, P and dS
// fed from registers, the GQA group of dk/dv summed in registers without
// atomics), with a bf16 and an f16 instance each.
//
// What the TPU family adds over its resident one is how the KV stream is
// staged: the KV axis is a sequential grid axis and Pallas double-buffers
// each (block_k, d) fetch behind the previous step's compute. Here the
// stream is a ring of kStages (2) tiles in shared memory filled by
// cp.async: at the top of step j one barrier makes tile j visible and frees
// the stage tile j-1 used; the block then issues the copy of tile j+1 into
// that stage and runs tile j's products while it is in flight, so each
// tile's load latency hides behind the previous tile's mma work instead of
// stalling all four warps between two barriers. The forward and dq stream
// 64-row K/V tiles past a q tile held in shared memory (and, for the
// forward, in registers); dk/dv holds its 64-row K/V tile and streams the
// 32-row q/dO tiles of every query head of its group, with their lse and
// delta. Shared memory at D = 128: 87 KB (forward), 104 KB (dq), 70 KB
// (dk/dv), two blocks per SM. TMA and wgmma are later steps.
#include "flash_common.cuh"

namespace stpu {
namespace {

// Elements of one shared tile of `rows` rows.
template <int D>
__host__ __device__ constexpr int tile_elems(int rows) {
  return rows * row_elems(D);
}

template <int D>
constexpr int fwd_streamed_smem_bytes() {
  return (1 + 2 * kStages) * tile_elems<D>(kTile) * (int)sizeof(e16);
}

template <int D>
constexpr int dq_streamed_smem_bytes() {
  return (2 + 2 * kStages) * tile_elems<D>(kTile) * (int)sizeof(e16) +
         kTile * (int)sizeof(float);
}

template <int D>
constexpr int dkv_streamed_smem_bytes() {
  return (2 * tile_elems<D>(kTile) + 2 * kStages * tile_elems<D>(kDkvQ)) *
             (int)sizeof(e16) +
         2 * kStages * kDkvQ * (int)sizeof(float);
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
__global__ void __launch_bounds__(kThreads)
flash_fwd_streamed_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTE = tile_elems<D>(kTile);
  e16* sQ = reinterpret_cast<e16*>(smem);
  e16* sK = sQ + kTE;             // kStages K tiles, then
  e16* sV = sK + kStages * kTE;   // kStages V tiles

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  // longest causal rows first
  const int qt = ceil_div(p.S, kTile) - 1 - blockIdx.x;
  const int q_start = qt * kTile;
  const int wrow = (threadIdx.x / 32) * 16;
  const e16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const e16* vg = p.v + b * p.v_sb + kvh * p.v_sh;

  // Prologue: q and K/V tile 0 in one group.
  load_tile_async<D, kTile>(sQ, p.q + b * p.q_sb + h * p.q_sh +
                                    q_start * p.q_ss, p.q_ss,
                            p.S - q_start);
  issue_kv<D>(kg, vg, p.k_ss, p.v_ss, p.S, 0, sK, sV);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a<D>(qf[ks], sQ, wrow, ks * 16);

  float acc[D / 8][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf};  // rows g and g+8
  float l[2] = {0.f, 0.f};          // this lane's partial row sums
  const float sm = p.scale * BaseE::kScoreMul;
  const TileMask mask = {p.S, p.causal};

  const int n_kt = p.causal ? qt + 1 : ceil_div(p.S, kTile);
  const int j_mask = masked_tile(p.causal, p.S, kTile, n_kt);
  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait_all();  // this thread's copies of tile j have landed
    __syncthreads();      // everyone's have, and tile j-1 is consumed
    if (j + 1 < n_kt)
      issue_kv<D>(kg, vg, p.k_ss, p.v_ss, p.S, j + 1, sK, sV);
    const e16* k_t = sK + (j % kStages) * kTE;
    const e16* v_t = sV + (j % kStages) * kTE;
    if (j == j_mask)
      fwd_step<D, T, BaseE, true>(k_t, v_t, q_start, j * kTile, mask, sm,
                                  qf, acc, m, l);
    else
      fwd_step<D, T, BaseE, false>(k_t, v_t, q_start, j * kTile, mask, sm,
                                   qf, acc, m, l);
  }
  store_o_lse<D, T, BaseE>(p, b, h, q_start, acc, m, l);
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

// The dk/dv stream: item `it` is query head kvh * G + it / per_head of the
// group and q tile i0 + it % per_head. Issue its 32 q and dO rows and
// their lse and delta (32 floats each: 8 threads of 16 bytes apiece) into
// ring stage it % kStages. WHOLE: S is a multiple of the q tile, so no
// row lies past it and the copies take no row predicate. Otherwise rows
// past S load as zeros, with lse kPastLse and delta 0 (S is a multiple of
// 8, so each 4-row chunk of the statistics lies wholly before S or wholly
// past it): such rows add exactly 0 to dk and dv.
template <int D, bool WHOLE>
__device__ __forceinline__ void issue_q_item(const BwdParams& p, int b,
                                             int kvh, int it, int i0,
                                             int per_head, e16* sQ,
                                             e16* sdO, float* sLse,
                                             float* sDelta) {
  constexpr int kQE = tile_elems<D>(kDkvQ);
  constexpr int kStatChunks = kDkvQ / 4;
  const int st = it % kStages;
  const int h = kvh * (p.H / p.KVH) + it / per_head;
  const int q_start = (i0 + it % per_head) * kDkvQ;
  const int valid = WHOLE ? kDkvQ : p.S - q_start;
  load_tile_async<D, kDkvQ>(sQ + st * kQE, p.q + b * p.q_sb + h * p.q_sh +
                                               q_start * p.q_ss, p.q_ss,
                            valid);
  load_tile_async<D, kDkvQ>(sdO + st * kQE, p.dout + b * p.do_sb +
                                                h * p.do_sh +
                                                q_start * p.do_ss, p.do_ss,
                            valid);
  if (threadIdx.x < 2 * kStatChunks) {
    const int c = threadIdx.x % kStatChunks;
    const bool lse_half = threadIdx.x < kStatChunks;
    float* dst = (lse_half ? sLse : sDelta) + st * kDkvQ + 4 * c;
    if (4 * c < valid) {
      const long long at = ((long long)b * p.H + h) * p.S + q_start + 4 * c;
      cp_async16(dst, (lse_half ? p.lse : p.delta) + at);
    } else {
      // This stage's previous item is consumed (the caller's barrier);
      // the next barrier makes the store visible with the copies.
      const float x = lse_half ? kPastLse : 0.f;
      *reinterpret_cast<float4*>(dst) = make_float4(x, x, x, x);
    }
  }
  cp_async_commit();
}

// The dk/dv kernel's body, as one instance for S a multiple of the q tile
// and one for a ragged S (the kernel picks once per launch): the item loop
// with a row predicate on its copies ran 5-7% slower (PERF.md).
template <int D, class T, bool WHOLE>
__device__ __forceinline__ void dkv_streamed(const BwdParams& p,
                                             unsigned char* smem) {
  constexpr int kTE = tile_elems<D>(kTile), kQE = tile_elems<D>(kDkvQ);
  e16* sK = reinterpret_cast<e16*>(smem);
  e16* sV = sK + kTE;
  e16* sQ = sV + kTE;             // kStages q tiles, then
  e16* sdO = sQ + kStages * kQE;  // kStages dO tiles, then
  float* sLse = reinterpret_cast<float*>(sdO + kStages * kQE);
  float* sDelta = sLse + kStages * kDkvQ;  // kStages rows of 32 floats each

  const int b = blockIdx.y / p.KVH, kvh = blockIdx.y % p.KVH;
  const int k_start = blockIdx.x * kTile;  // kv tile 0 has the most q rows
  const float sm = p.scale * BaseE::kScoreMul;

  // Causal: q tiles start at the kv tile's first row, and the two 32-row
  // q tiles that overlap the 64-row kv tile straddle the diagonal.
  const int i0 = p.causal ? k_start / kDkvQ : 0;
  const int i_free = p.causal ? i0 + kTile / kDkvQ : 0;
  const int per_head = ceil_div(p.S, kDkvQ) - i0;
  const int n_items = (p.H / p.KVH) * per_head;

  // Prologue: the block's K/V tile and item 0 in one group.
  load_tile_async<D, kTile>(sK, p.k + b * p.k_sb + kvh * p.k_sh +
                                    k_start * p.k_ss, p.k_ss,
                            p.S - k_start);
  load_tile_async<D, kTile>(sV, p.v + b * p.v_sb + kvh * p.v_sh +
                                    k_start * p.v_ss, p.v_ss,
                            p.S - k_start);
  issue_q_item<D, WHOLE>(p, b, kvh, 0, i0, per_head, sQ, sdO, sLse, sDelta);

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < n_items; ++it) {
    cp_async_wait_all();  // this thread's copies of item it have landed
    __syncthreads();      // everyone's have, and item it-1 is consumed
    if (it + 1 < n_items)
      issue_q_item<D, WHOLE>(p, b, kvh, it + 1, i0, per_head, sQ, sdO, sLse,
                             sDelta);
    const int st = it % kStages;
    const int i = i0 + it % per_head;
    if (i < i_free)
      dkv_step<D, T, BaseE, true>(sK, sV, sQ + st * kQE, sdO + st * kQE,
                                  sLse + st * kDkvQ, sDelta + st * kDkvQ,
                                  i * kDkvQ, k_start, sm, dk, dv);
    else
      dkv_step<D, T, BaseE, false>(sK, sV, sQ + st * kQE, sdO + st * kQE,
                                   sLse + st * kDkvQ, sDelta + st * kDkvQ,
                                   i * kDkvQ, k_start, sm, dk, dv);
  }
  store_dkv<D, T>(p, b, kvh, k_start, dk, dv);
}

template <int D, class T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_streamed_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (p.S % kDkvQ == 0)
    dkv_streamed<D, T, true>(p, smem);
  else
    dkv_streamed<D, T, false>(p, smem);
}

}  // namespace
}  // namespace stpu

// dtype: the element type of q, k, v and o (Bf16::kDtype, F16::kDtype).
// strides: (batch, seq, head) in elements for q, k, v. o is written
// contiguous (B, S, H, D) and lse (B, H, S) fp32, natural log.
extern "C" int stpu_flash_fwd_streamed(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       const long long* strides, int B, int S,
                                       int H, int KVH, int D, int dtype,
                                       float scale, int causal,
                                       void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const FwdParams p =
      fwd_params(q, k, v, o, lse, strides, S, H, KVH, scale, causal);
  const dim3 grid(ceil_div(S, kTile), B * H);
  STPU_LAUNCH_BY_D(D, dtype, flash_fwd_streamed_kernel,
                   fwd_streamed_smem_bytes, grid,
                   static_cast<cudaStream_t>(stream), p);
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

// strides: q, k, v, dO. dk and dv are written contiguous (B, S, KVH, D),
// of the inputs' type; lse and delta (B, H, S) fp32 are read through
// 16-byte copies.
extern "C" int stpu_flash_dkv_streamed(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv,
                                       const long long* strides, int B, int S,
                                       int H, int KVH, int D, int dtype,
                                       float scale, int causal,
                                       void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, nullptr, dout, lse, delta, nullptr,
                                 dk, dv, strides, S, H, KVH, scale, causal);
  const dim3 grid(ceil_div(S, kTile), B * KVH);
  STPU_LAUNCH_BY_D(D, dtype, flash_dkv_streamed_kernel,
                   dkv_streamed_smem_bytes, grid,
                   static_cast<cudaStream_t>(stream), p);
}
