// Flash attention in fp32 on Hopper (sm_90a): forward, dq and dk/dv for
// f32 inputs, every family's shapes (any S that is a multiple of 8,
// head_dim 64 or 128, causal or not), natural exp and a natural-log lse.
//
// Replaces, for f32 inputs, skypilot_tpu/ops/pallas/flash_attention.py's
// kernels, whose dots take the input dtype (_fwd_kernel_resident,
// _dq_kernel_resident and _dkv_kernel_resident feed f32 q, k, v, P and dS
// to jax.lax.dot_general): the same three functions, in fp32 throughout.
// The 16-bit kernels cannot stand in for them: rounding q, k and v to f16,
// with everything else exact, already puts causal gradients past the JAX
// reference tests' 5e-3 (tools/flash_f16_error_model.py), and the f16
// kernels' own rounding of P and dS adds to it.
//
// What bounds them: fp32 arithmetic outside the tensor cores (67 TFLOP/s
// on the card, against 989 for bf16 products), and, as written, L2 reads
// of the K/V (or q/dO) rows. They are the exact path, not the fast one:
// bf16 and f16 inputs take the Hopper kernels. Design, for plainness: one
// warp owns kF32Rows rows (q rows for the forward and dq, kv rows of one KV
// head for dk/dv) and keeps them and their sums in registers, each lane D
// / 32 columns; it walks the other operand one row at a time up to the
// causal bound, reading it from global memory (coalesced: a row is D
// contiguous floats), each dot product a warp sum. No tiles, so a ragged S
// needs no mask, and no atomics: dk/dv sums the GQA group in registers,
// and every kernel is deterministic. dq writes delta = rowsum(dO * O) for
// dk/dv, as the other families do.
#include "flash_common.cuh"

namespace stpu {
namespace {

constexpr int kF32Rows = 4;                  // rows a warp owns
constexpr int kF32Warps = 4;                 // warps a block
constexpr int kF32Block = 32 * kF32Warps;
constexpr int kF32BlockRows = kF32Rows * kF32Warps;

// The params' 16-bit pointers carry f32 tensors here (element strides of
// f32).
__device__ __forceinline__ const float* f32(const e16* p) {
  return reinterpret_cast<const float*>(p);
}
__device__ __forceinline__ float* f32(e16* p) {
  return reinterpret_cast<float*>(p);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// This lane's C = D / 32 columns of row `row` of a (B, S, heads, D) tensor
// at g (the (b, head) row 0), row stride ss.
template <int C>
__device__ __forceinline__ void load_row(float (&x)[C], const float* g,
                                         long long ss, int row) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = __ldg(g + row * ss + lane + 32 * c);
}

template <int C>
__device__ __forceinline__ float dot(const float (&x)[C],
                                     const float (&y)[C]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s = fmaf(x[c], y[c], s);
  return warp_sum(s);
}

// Forward: block (blockIdx.x, b * H + h), warp rows row0 .. row0 + 3.
template <int D>
__global__ void __launch_bounds__(kF32Block)
flash_fwd_f32_kernel(const FwdParams p) {
  constexpr int C = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int row0 = blockIdx.x * kF32BlockRows + warp * kF32Rows;
  if (row0 >= p.S) return;
  const float* qg = f32(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = f32(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = f32(p.v) + b * p.v_sb + kvh * p.v_sh;
  float q[kF32Rows][C], o[kF32Rows][C], m[kF32Rows], l[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    load_row<C>(q[r], qg, p.q_ss, min(row0 + r, p.S - 1));
#pragma unroll
    for (int c = 0; c < C; ++c) o[r][c] = 0.f;
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  const int n_keys = p.causal ? min(p.S, row0 + kF32Rows) : p.S;
  for (int j = 0; j < n_keys; ++j) {
    float kj[C], vj[C];
    load_row<C>(kj, kg, p.k_ss, j);
    load_row<C>(vj, vg, p.v_ss, j);
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      if (p.causal && j > row0 + r) continue;  // uniform across the warp
      const float s = dot<C>(q[r], kj) * p.scale;
      const float m_new = fmaxf(m[r], s);
      const float alpha = expf(m[r] - m_new), pj = expf(s - m_new);
      l[r] = fmaf(l[r], alpha, pj);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) o[r][c] = fmaf(o[r][c], alpha, pj * vj[c]);
    }
  }
  float* og = f32(p.o) + ((long long)b * p.S * p.H + h) * D;
  float* lg = p.lse + ((long long)b * p.H + h) * p.S;
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int row = row0 + r;
    if (row >= p.S) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < C; ++c)
      og[(long long)row * p.H * D + lane + 32 * c] = o[r][c] * inv;
    if (lane == 0) lg[row] = m[r] + logf(l[r]);
  }
}

// dq and delta: block (blockIdx.x, b * H + h), warp rows row0 .. row0 + 3.
template <int D>
__global__ void __launch_bounds__(kF32Block)
flash_dq_f32_kernel(const BwdParams p) {
  constexpr int C = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int row0 = blockIdx.x * kF32BlockRows + warp * kF32Rows;
  if (row0 >= p.S) return;
  const float* qg = f32(p.q) + b * p.q_sb + h * p.q_sh;
  const float* og = f32(p.o) + b * p.o_sb + h * p.o_sh;
  const float* dog = f32(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kg = f32(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = f32(p.v) + b * p.v_sb + kvh * p.v_sh;
  const long long stat = ((long long)b * p.H + h) * p.S;
  float q[kF32Rows][C], dO[kF32Rows][C], dq[kF32Rows][C];
  float lse[kF32Rows], dlt[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int row = min(row0 + r, p.S - 1);
    float o[C];
    load_row<C>(q[r], qg, p.q_ss, row);
    load_row<C>(dO[r], dog, p.do_ss, row);
    load_row<C>(o, og, p.o_ss, row);
    dlt[r] = dot<C>(dO[r], o);
    lse[r] = p.lse[stat + row];
#pragma unroll
    for (int c = 0; c < C; ++c) dq[r][c] = 0.f;
    if (lane == 0 && row0 + r < p.S) p.delta[stat + row] = dlt[r];
  }
  const int n_keys = p.causal ? min(p.S, row0 + kF32Rows) : p.S;
  for (int j = 0; j < n_keys; ++j) {
    float kj[C], vj[C];
    load_row<C>(kj, kg, p.k_ss, j);
    load_row<C>(vj, vg, p.v_ss, j);
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      if (p.causal && j > row0 + r) continue;
      const float pr = expf(dot<C>(q[r], kj) * p.scale - lse[r]);
      const float ds = pr * (dot<C>(dO[r], vj) - dlt[r]);
#pragma unroll
      for (int c = 0; c < C; ++c) dq[r][c] = fmaf(ds, kj[c], dq[r][c]);
    }
  }
  float* dqg = f32(p.dq) + ((long long)b * p.S * p.H + h) * D;
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int row = row0 + r;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dqg[(long long)row * p.H * D + lane + 32 * c] = dq[r][c] * p.scale;
  }
}

// dk and dv: block (blockIdx.x, b * KVH + kvh), warp kv rows row0 ..
// row0 + 3, summed over the G query heads of the group.
template <int D>
__global__ void __launch_bounds__(kF32Block)
flash_dkv_f32_kernel(const BwdParams p) {
  constexpr int C = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / p.KVH, kvh = blockIdx.y % p.KVH;
  const int groups = p.H / p.KVH;
  const int row0 = blockIdx.x * kF32BlockRows + warp * kF32Rows;
  if (row0 >= p.S) return;
  const float* kg = f32(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = f32(p.v) + b * p.v_sb + kvh * p.v_sh;
  float k[kF32Rows][C], v[kF32Rows][C], dk[kF32Rows][C], dv[kF32Rows][C];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int row = min(row0 + r, p.S - 1);
    load_row<C>(k[r], kg, p.k_ss, row);
    load_row<C>(v[r], vg, p.v_ss, row);
#pragma unroll
    for (int c = 0; c < C; ++c) dk[r][c] = dv[r][c] = 0.f;
  }
  for (int gi = 0; gi < groups; ++gi) {
    const int h = kvh * groups + gi;
    const float* qg = f32(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dog = f32(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long stat = ((long long)b * p.H + h) * p.S;
    for (int i = p.causal ? row0 : 0; i < p.S; ++i) {
      float qi[C], doi[C];
      load_row<C>(qi, qg, p.q_ss, i);
      load_row<C>(doi, dog, p.do_ss, i);
      const float lse = p.lse[stat + i], dlt = p.delta[stat + i];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        if (row0 + r >= p.S || (p.causal && i < row0 + r)) continue;
        const float pr = expf(dot<C>(qi, k[r]) * p.scale - lse);
        const float ds = pr * (dot<C>(doi, v[r]) - dlt);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv[r][c] = fmaf(pr, doi[c], dv[r][c]);
          dk[r][c] = fmaf(ds, qi[c], dk[r][c]);
        }
      }
    }
  }
  const long long base = ((long long)b * p.S * p.KVH + kvh) * D;
  const long long ss = (long long)p.KVH * D;
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int row = row0 + r;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      f32(p.dk)[base + row * ss + lane + 32 * c] = dk[r][c] * p.scale;
      f32(p.dv)[base + row * ss + lane + 32 * c] = dv[r][c];
    }
  }
}

}  // namespace
}  // namespace stpu

// Launches KERNEL<64> or KERNEL<128> over (ceil(S / 16), ROWS) blocks.
#define STPU_F32_BY_D(HEAD_DIM, KERNEL, ROWS, STREAM, P)                    \
  do {                                                                      \
    const dim3 grid(ceil_div(S, kF32BlockRows), (ROWS));                    \
    if ((HEAD_DIM) == 64)                                                   \
      KERNEL<64><<<grid, kF32Block, 0, (STREAM)>>>(P);                      \
    else if ((HEAD_DIM) == 128)                                             \
      KERNEL<128><<<grid, kF32Block, 0, (STREAM)>>>(P);                     \
    else                                                                    \
      return (int)cudaErrorInvalidValue;                                    \
    return (int)cudaGetLastError();                                         \
  } while (0)

// strides: (batch, seq, head) in elements for q, k, v. o (B, S, H, D) and
// lse (B, H, S), natural log, are written contiguous, fp32.
extern "C" int stpu_flash_fwd_f32(const void* q, const void* k,
                                  const void* v, void* o, void* lse,
                                  const long long* strides, int B, int S,
                                  int H, int KVH, int D, float scale,
                                  int causal, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const FwdParams p =
      fwd_params(q, k, v, o, lse, strides, S, H, KVH, scale, causal);
  STPU_F32_BY_D(D, flash_fwd_f32_kernel, B * H,
                static_cast<cudaStream_t>(stream), p);
}

// strides: q, k, v, o, dO. dq (B, S, H, D) and delta (B, H, S) are written
// contiguous, fp32.
extern "C" int stpu_flash_dq_f32(const void* q, const void* k,
                                 const void* v, const void* o,
                                 const void* dout, const void* lse, void* dq,
                                 void* delta, const long long* strides,
                                 int B, int S, int H, int KVH, int D,
                                 float scale, int causal, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                                 nullptr, strides, S, H, KVH, scale, causal);
  STPU_F32_BY_D(D, flash_dq_f32_kernel, B * H,
                static_cast<cudaStream_t>(stream), p);
}

// strides: q, k, v, dO. dk and dv (B, S, KVH, D) are written contiguous,
// fp32.
extern "C" int stpu_flash_dkv_f32(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv,
                                  const long long* strides, int B, int S,
                                  int H, int KVH, int D, float scale,
                                  int causal, void* stream) {
  using namespace stpu;
  if (S % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(q, k, v, nullptr, dout, lse, delta, nullptr,
                                 dk, dv, strides, S, H, KVH, scale, causal);
  STPU_F32_BY_D(D, flash_dkv_f32_kernel, B * KVH,
                static_cast<cudaStream_t>(stream), p);
}
