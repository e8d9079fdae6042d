// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, from the saved (q, k, v, o, lse) and the output cotangent dO.
//
// flash_dq replaces skypilot_tpu/ops/pallas/flash_attention.py:
// _dq_kernel_resident; flash_dkv replaces _dkv_kernel_resident (both
// launched by _flash_bwd_resident). With P = exp(scale q k^T - lse),
// dP = dO v^T, delta = rowsum(dO * O) and dS = P * (dP - delta):
//   dq = scale * dS k,   dv = sum_g P^T dO,   dk = scale * sum_g dS^T q,
// where the sums run over the G = H / KVH query heads of a KV head.
//
// What bounds them: like the forward, ~2*S*D flops per byte moved at the
// training shapes, so the tensor cores. dq does 3 products per tile pair
// (q k^T, dO v^T, dS k) and dk/dv 4 (k q^T, v dO^T, P^T dO, dS^T q).
//
// Design. flash_dq: one block of 4 warps per (q tile of 64 rows, b*h);
// q and dO sit in shared memory, each warp owns 16 rows and keeps its dq
// in fp32 registers while it loops over 64-row K/V tiles up to the causal
// bound; dq is written once. It also computes delta for its rows and
// writes it to memory for flash_dkv, so that kernel never reads O.
// flash_dkv: one block per (kv tile of 64 rows, b*KVH), heaviest (first)
// kv tiles scheduled first. Its K and V tiles stay in shared memory; each
// warp owns 16 kv rows and keeps their dk and dv in fp32 registers (D/2
// floats per lane each) while it loops over the G query heads of its
// group and, for each, over 32-row q/dO tiles from the causal start. The GQA
// group-sum therefore happens in registers: no atomics and no per-query-
// head gradient in device memory, which is the TPU design's point carried
// over. The kernel computes S^T = k q^T directly, so P^T and dS^T come out
// in the C-fragment layout that feeds P^T dO and dS^T q from registers.
// The 32-row q tile keeps the score registers (2 x 16 per lane) beside the
// 2 x 64 accumulator registers at D = 128.
#include "flash_common.cuh"

namespace stpu {
namespace {

constexpr int kDkvQ = 32;  // q rows per inner tile of flash_dkv

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;
  float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int S, H, KVH;
  float scale;
  int causal;
};

template <int D>
constexpr int dq_smem_bytes() {
  return 4 * kTile * row_elems(D) * (int)sizeof(bf16) +
         kTile * (int)sizeof(float);
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kTile + 2 * kDkvQ) * row_elems(D) * (int)sizeof(bf16) +
         2 * kDkvQ * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kTile * row_elems(D);
  bf16* sK = sdO + kTile * row_elems(D);
  bf16* sV = sK + kTile * row_elems(D);
  float* sDelta = reinterpret_cast<float*>(sV + kTile * row_elems(D));

  const int n_qt = p.S / kTile;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_start = qt * kTile;
  const int wrow = warp * 16;

  const bf16* qg = p.q + b * p.q_sb + h * p.q_sh + q_start * p.q_ss;
  const bf16* dog = p.dout + b * p.do_sb + h * p.do_sh + q_start * p.do_ss;
  const bf16* og = p.o + b * p.o_sb + h * p.o_sh + q_start * p.o_ss;
  const bf16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + kvh * p.v_sh;
  const long long stat = ((long long)b * p.H + h) * p.S + q_start;

  load_tile<D, kTile>(sQ, qg, p.q_ss);
  load_tile<D, kTile>(sdO, dog, p.do_ss);
  __syncthreads();

  // delta = rowsum(dO * O) in fp32: two lanes per row, D/2 columns each.
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    const bf16* orow = og + r * p.o_ss + half * (D / 2);
    const bf16* drow = sdO + r * row_elems(D) + half * (D / 2);
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c)
      sum += __bfloat162float(orow[c]) * __bfloat162float(drow[c]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      sDelta[r] = sum;
      p.delta[stat + r] = sum;
    }
  }
  __syncthreads();

  const float lse_r[2] = {p.lse[stat + wrow + g], p.lse[stat + wrow + g + 8]};
  const float dlt_r[2] = {sDelta[wrow + g], sDelta[wrow + g + 8]};

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  const int n_kt = p.causal ? qt + 1 : n_qt;
  for (int j = 0; j < n_kt; ++j) {
    const int k_start = j * kTile;
    __syncthreads();
    load_tile<D, kTile>(sK, kg + k_start * p.k_ss, p.k_ss);
    load_tile<D, kTile>(sV, vg + k_start * p.v_ss, p.v_ss);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t qa[4], da[4];
      load_a<D>(qa, sQ, wrow, ks * 16);
      load_a<D>(da, sdO, wrow, ks * 16);
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nk<D>(bk, sK, np * 16, ks * 16);
        load_b_nk<D>(bv, sV, np * 16, ks * 16);
        mma(s[2 * np], qa, bk[0], bk[1]);
        mma(s[2 * np + 1], qa, bk[2], bk[3]);
        mma(dp[2 * np], da, bv[0], bv[1]);
        mma(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }

    // dS = P * (dP - delta), P = exp(scale s - lse), into A fragments.
    const bool diag = p.causal && (k_start + kTile > q_start);
    uint32_t dsf[kTile / 16][4];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * p.scale;
        if (diag) {
          const int qpos = q_start + wrow + g + (e >= 2 ? 8 : 0);
          const int kpos = k_start + i * 8 + 2 * t + (e & 1);
          if (qpos < kpos) x = kNegInf;
        }
        const float pr = __expf(x - lse_r[e >> 1]);
        ds[e] = pr * (dp[i][e] - dlt_r[e >> 1]);
      }
      dsf[i / 2][(i % 2) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[i / 2][(i % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dq += dS k: k is the (kv x d) = (k x n) operand, stored k-major.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bfr[4];
        load_b_kn<D>(bfr, sK, kk * 16, dn * 16);
        mma(dq[2 * dn], dsf[kk], bfr[0], bfr[1]);
        mma(dq[2 * dn + 1], dsf[kk], bfr[2], bfr[3]);
      }
    }
  }

  const int row0 = q_start + wrow + g;
  bf16* dqg = p.dq + ((long long)b * p.S * p.H + h) * D;
  const long long dq_ss = (long long)p.H * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dqg + row0 * dq_ss + col) =
        pack_bf16(dq[i][0] * p.scale, dq[i][1] * p.scale);
    *reinterpret_cast<uint32_t*>(dqg + (row0 + 8) * dq_ss + col) =
        pack_bf16(dq[i][2] * p.scale, dq[i][3] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile * row_elems(D);
  bf16* sQ = sV + kTile * row_elems(D);
  bf16* sdO = sQ + kDkvQ * row_elems(D);
  float* sLse = reinterpret_cast<float*>(sdO + kDkvQ * row_elems(D));
  float* sDelta = sLse + kDkvQ;

  const int kt = blockIdx.x;  // kv tile 0 has the most q rows: first
  const int b = blockIdx.y / p.KVH, kvh = blockIdx.y % p.KVH;
  const int groups = p.H / p.KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k_start = kt * kTile;
  const int wrow = warp * 16;

  load_tile<D, kTile>(sK, p.k + b * p.k_sb + kvh * p.k_sh + k_start * p.k_ss,
                      p.k_ss);
  load_tile<D, kTile>(sV, p.v + b * p.v_sb + kvh * p.v_sh + k_start * p.v_ss,
                      p.v_ss);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  const int n_qt = p.S / kDkvQ;
  const int i0 = p.causal ? k_start / kDkvQ : 0;
  for (int gi = 0; gi < groups; ++gi) {
    const int h = kvh * groups + gi;
    const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* dog = p.dout + b * p.do_sb + h * p.do_sh;
    const long long stat = ((long long)b * p.H + h) * p.S;
    for (int i = i0; i < n_qt; ++i) {
      const int q_start = i * kDkvQ;
      __syncthreads();  // previous q tile fully consumed
      load_tile<D, kDkvQ>(sQ, qg + q_start * p.q_ss, p.q_ss);
      load_tile<D, kDkvQ>(sdO, dog + q_start * p.do_ss, p.do_ss);
      if (threadIdx.x < kDkvQ) {
        sLse[threadIdx.x] = p.lse[stat + q_start + threadIdx.x];
        sDelta[threadIdx.x] = p.delta[stat + q_start + threadIdx.x];
      }
      __syncthreads();

      // S^T = k q^T (kv rows x q cols): k rows are A, q (n x k) is B.
      float st[kDkvQ / 8][4];
#pragma unroll
      for (int c = 0; c < kDkvQ / 8; ++c)
        st[c][0] = st[c][1] = st[c][2] = st[c][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t ka[4];
        load_a<D>(ka, sK, wrow, ks * 16);
#pragma unroll
        for (int np = 0; np < kDkvQ / 16; ++np) {
          uint32_t bq[4];
          load_b_nk<D>(bq, sQ, np * 16, ks * 16);
          mma(st[2 * np], ka, bq[0], bq[1]);
          mma(st[2 * np + 1], ka, bq[2], bq[3]);
        }
      }
      // P^T = exp(scale S^T - lse[q]), kept in fp32 for dS and packed for
      // the dv product.
      const bool diag = p.causal && (q_start < k_start + kTile);
      uint32_t pf[kDkvQ / 16][4];
#pragma unroll
      for (int c = 0; c < kDkvQ / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qcol = c * 8 + 2 * t + (e & 1);
          float x = st[c][e] * p.scale;
          if (diag) {
            const int kpos = k_start + wrow + g + (e >= 2 ? 8 : 0);
            if (q_start + qcol < kpos) x = kNegInf;
          }
          st[c][e] = __expf(x - sLse[qcol]);
        }
        pf[c / 2][(c % 2) * 2] = pack_bf16(st[c][0], st[c][1]);
        pf[c / 2][(c % 2) * 2 + 1] = pack_bf16(st[c][2], st[c][3]);
      }
      // dv += P^T dO: dO is the (q x d) = (k x n) operand, stored k-major.
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk) {
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bfr[4];
          load_b_kn<D>(bfr, sdO, kk * 16, dn * 16);
          mma(dv[2 * dn], pf[kk], bfr[0], bfr[1]);
          mma(dv[2 * dn + 1], pf[kk], bfr[2], bfr[3]);
        }
      }
      // dP^T = v dO^T.
      float dpt[kDkvQ / 8][4];
#pragma unroll
      for (int c = 0; c < kDkvQ / 8; ++c)
        dpt[c][0] = dpt[c][1] = dpt[c][2] = dpt[c][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t va[4];
        load_a<D>(va, sV, wrow, ks * 16);
#pragma unroll
        for (int np = 0; np < kDkvQ / 16; ++np) {
          uint32_t bd[4];
          load_b_nk<D>(bd, sdO, np * 16, ks * 16);
          mma(dpt[2 * np], va, bd[0], bd[1]);
          mma(dpt[2 * np + 1], va, bd[2], bd[3]);
        }
      }
      // dS^T = P^T * (dP^T - delta[q]); dk += dS^T q.
      uint32_t dsf[kDkvQ / 16][4];
#pragma unroll
      for (int c = 0; c < kDkvQ / 8; ++c) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qcol = c * 8 + 2 * t + (e & 1);
          ds[e] = st[c][e] * (dpt[c][e] - sDelta[qcol]);
        }
        dsf[c / 2][(c % 2) * 2] = pack_bf16(ds[0], ds[1]);
        dsf[c / 2][(c % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk) {
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bfr[4];
          load_b_kn<D>(bfr, sQ, kk * 16, dn * 16);
          mma(dk[2 * dn], dsf[kk], bfr[0], bfr[1]);
          mma(dk[2 * dn + 1], dsf[kk], bfr[2], bfr[3]);
        }
      }
    }
  }

  const int row0 = k_start + wrow + g;
  const long long ss = (long long)p.KVH * D;
  const long long base = ((long long)b * p.S * p.KVH + kvh) * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(p.dk + base + row0 * ss + col) =
        pack_bf16(dk[i][0] * p.scale, dk[i][1] * p.scale);
    *reinterpret_cast<uint32_t*>(p.dk + base + (row0 + 8) * ss + col) =
        pack_bf16(dk[i][2] * p.scale, dk[i][3] * p.scale);
    *reinterpret_cast<uint32_t*>(p.dv + base + row0 * ss + col) =
        pack_bf16(dv[i][0], dv[i][1]);
    *reinterpret_cast<uint32_t*>(p.dv + base + (row0 + 8) * ss + col) =
        pack_bf16(dv[i][2], dv[i][3]);
  }
}

void set_common(BwdParams& p, int S, int H, int KVH, float scale,
                int causal) {
  p.S = S; p.H = H; p.KVH = KVH;
  p.scale = scale;
  p.causal = causal;
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.S / kTile, B * p.H);
  flash_dq_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.S / kTile, B * p.KVH);
  flash_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace stpu

// strides: (batch, seq, head) in elements for q, k, v, o, dO. dq and delta
// are written contiguous: (B, S, H, D) bf16 and (B, H, S) fp32.
extern "C" int stpu_flash_dq(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const void* lse, void* dq, void* delta,
                             const long long* strides, int B, int S, int H,
                             int KVH, int D, float scale, int causal,
                             void* stream) {
  using namespace stpu;
  BwdParams p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<bf16*>(dq);
  p.delta = static_cast<float*>(delta);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.do_sb = strides[12]; p.do_ss = strides[13]; p.do_sh = strides[14];
  set_common(p, S, H, KVH, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % kTile || H % KVH) return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)launch_dq<64>(p, B, st);
  if (D == 128) return (int)launch_dq<128>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

// strides: (batch, seq, head) in elements for q, k, v, dO. dk and dv are
// written contiguous (B, S, KVH, D) bf16.
extern "C" int stpu_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              const long long* strides, int B, int S, int H,
                              int KVH, int D, float scale, int causal,
                              void* stream) {
  using namespace stpu;
  BwdParams p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.do_sb = strides[9]; p.do_ss = strides[10]; p.do_sh = strides[11];
  set_common(p, S, H, KVH, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % kTile || H % KVH) return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)launch_dkv<64>(p, B, st);
  if (D == 128) return (int)launch_dkv<128>(p, B, st);
  return (int)cudaErrorInvalidValue;
}
