// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces skypilot_tpu/ops/pallas/flash_attention.py:_fwd_kernel_resident
// (launched by _flash_fwd_resident). Computes, for each (b, h) and q tile,
// o = softmax(scale * q k^T, causal) v and lse = m + log(l) (natural log),
// with query head h reading KV head h / (H / KVH).
//
// What bounds it: at the training shapes (S 2048, D 128) it does ~2*S*D
// flops per byte of q/k/v/o, far above the card's ~295 flop/byte ridge, so
// the tensor cores bound it. Design: one block of 4 warps per (q tile of 64
// rows, b*h); each warp owns 16 q rows and keeps their q fragments, the
// running (max, sum) and the fp32 output in registers. The kernel loops
// over 64-row K/V tiles staged in shared memory up to the causal bound (the
// TPU grid's sequential "arbitrary" axis becomes this loop), runs q k^T and
// P v on the tensor cores with mma.sync m16n8k16, and feeds P to the second
// product straight from the registers that hold the scores, cast to bf16 as
// the JAX kernel does. Only the diagonal tile is masked. q tiles are
// scheduled longest-first so the causal tail does not idle the card. No
// cp.async pipelining, wgmma or TMA yet: those are the next steps.
#include "flash_common.cuh"

namespace stpu {
namespace {

struct FwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int S, H, KVH;
  float scale;
  int causal;
};

template <int D>
constexpr int fwd_smem_bytes() {
  return 3 * kTile * row_elems(D) * (int)sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTile * row_elems(D);
  bf16* sV = sK + kTile * row_elems(D);

  const int n_qt = p.S / kTile;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_start = qt * kTile;
  const int wrow = warp * 16;  // this warp's first row in the tile

  const bf16* qg = p.q + b * p.q_sb + h * p.q_sh + q_start * p.q_ss;
  const bf16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + kvh * p.v_sh;

  load_tile<D, kTile>(sQ, qg, p.q_ss);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a<D>(qf[ks], sQ, wrow, ks * 16);

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g+8
  float l[2] = {0.f, 0.f};          // this lane's partial row sums

  const int n_kt = p.causal ? qt + 1 : n_qt;
  for (int j = 0; j < n_kt; ++j) {
    const int k_start = j * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kTile>(sK, kg + k_start * p.k_ss, p.k_ss);
    load_tile<D, kTile>(sV, vg + k_start * p.v_ss, p.v_ss);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t bfr[4];
        load_b_nk<D>(bfr, sK, np * 16, ks * 16);
        mma(s[2 * np], qf[ks], bfr[0], bfr[1]);
        mma(s[2 * np + 1], qf[ks], bfr[2], bfr[3]);
      }
    }

    const bool diag = p.causal && (k_start + kTile > q_start);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * p.scale;
        if (diag) {
          const int qpos = q_start + wrow + g + (e >= 2 ? 8 : 0);
          const int kpos = k_start + i * 8 + 2 * t + (e & 1);
          if (qpos < kpos) x = kNegInf;
        }
        s[i][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // P = exp(s - m), packed straight into A fragments for P v.
    uint32_t pf[kTile / 16][4];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const float p0 = __expf(s[i][0] - m[0]), p1 = __expf(s[i][1] - m[0]);
      const float p2 = __expf(s[i][2] - m[1]), p3 = __expf(s[i][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[i / 2][(i % 2) * 2] = pack_bf16(p0, p1);
      pf[i / 2][(i % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bfr[4];
        load_b_kn<D>(bfr, sV, kk * 16, dn * 16);
        mma(acc[2 * dn], pf[kk], bfr[0], bfr[1]);
        mma(acc[2 * dn + 1], pf[kk], bfr[2], bfr[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / l[r];
  }
  const int row0 = q_start + wrow + g;
  bf16* og = p.o + ((long long)b * p.S * p.H + h) * D;
  const long long o_ss = (long long)p.H * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(og + row0 * o_ss + col) =
        pack_bf16(acc[i][0] * inv[0], acc[i][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(og + (row0 + 8) * o_ss + col) =
        pack_bf16(acc[i][2] * inv[1], acc[i][3] * inv[1]);
  }
  if (t == 0) {
    float* lg = p.lse + ((long long)b * p.H + h) * p.S;
    lg[row0] = m[0] + logf(l[0]);
    lg[row0 + 8] = m[1] + logf(l[1]);
  }
}

template <int D>
cudaError_t launch_fwd(const FwdParams& p, int B, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.S / kTile, B * p.H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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
  FwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.S = S; p.H = H; p.KVH = KVH;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % kTile || H % KVH) return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)launch_fwd<64>(p, B, st);
  if (D == 128) return (int)launch_fwd<128>(p, B, st);
  return (int)cudaErrorInvalidValue;
}
