// The Hopper-native flash-attention forward (sm_90a): wgmma + TMA, warp
// specialised. One body, instantiated by flash_fwd.cu (the resident
// family, natural-log lse), flash_tri.cu (the triangular family, base-2
// lse) and flash_streamed.cu (the streamed family, natural-log lse, with
// the overlapped schedule below), each at head_dim 64 and 128
// and element type bf16 and f16 (T, the inputs' and outputs' type; the
// softmax and the sums stay fp32). The function is the TPU forward's: o =
// softmax(scale * q k^T, causal) v and lse = m + log(l), query head h
// reading KV head h / (H / KVH).
//
// What bounds it: the tensor cores. At the main shapes it does ~S*D/2 (or
// more) flops per byte it must move, far past the card's ~295 flop/byte
// ridge. Design, for that bound:
//
// - One CTA computes one 128-row q tile of one (b, h): 384 threads, one
//   producer warpgroup and two consumer warpgroups of 64 q rows each.
//   setmaxnreg gives the producer 40 registers and each consumer 232
//   (40 + 2 * 232 = 3 * 168, the launch's allotment).
// - Producer: one thread issues TMA loads (cp.async.bulk.tensor, completing
//   on an mbarrier's transaction count): Q once, then K and V tiles of 128
//   rows into a ring of kRing (2) stages, each stage with a full and an
//   empty mbarrier. The tensor maps are (D, S, heads, B) views of the
//   strided (B, S, heads, D) tensors, so rows at or past S load as zeros.
// - Consumers: S = Q K^T runs as wgmma m64n128k16 with both operands read
//   from shared memory through descriptors (K-major). The online softmax
//   runs in exp2 on the accumulator fragments, scale*log2(e) folded into
//   the one FFMA each score takes. P, cast to T, is the register A
//   operand of O += P V (wgmma m64nDk16), V read from shared memory
//   MN-major. After that product has completed, one thread per consumer
//   arrives on the stage's empty barrier. In lockstep (kOverlap false: the
//   resident and triangular instances) the two consumers run that loop
//   independently and wait on the same barriers, so their softmaxes tend
//   to coincide while the tensor cores idle.
// - The overlapped schedule (kOverlap: the streamed instance;
//   FlashAttention-3's section 3.2), for long loops: each consumer issues
//   S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, and runs tile j's softmax
//   while P V is still in flight (o is rescaled by tile j's alpha just
//   before the next P V, and P_j is packed once P V has read P_{j-1}'s
//   registers). K and V then have their own full and empty barriers:
//   stage j of K is released with stage j - 1 of V, after that P V, and
//   the producer loads K_{j+1} ahead of V_j. Registers: o (D / 2), S (64)
//   and the packed P (32) a thread, 160 at D = 128. Ping-pong of the two
//   consumers on named barriers (section 3.1) on top of it measured no
//   faster at the streamed main shape and was dropped (PERF.md).
// - What ptxas needs to keep a product in flight across the softmax (else
//   it waits for it early, or serialises every wgmma of the kernel, and
//   says so only as a "Potential Performance Loss" note): no branch on a
//   thread's own values (if (tid == 0) mbar_arrive) and no mbarrier
//   arrival between the issue and the wait, hence arrivals predicated
//   inside the instruction (mbar_arrive_if) and after the wait; no path
//   on which the product is still in flight where its registers are read,
//   hence tile 0's S peeled out of the loop; and the P registers fenced
//   after the wait, so none is reused before it.
// - Masking: only the KV tile that straddles the diagonal (causal) or S
//   (the ragged last tile, non-causal) runs the MASK instance; a causal
//   loop stops at the diagonal, so fully masked tiles are never loaded.
// - Epilogue: o / l goes through the consumer's own 64 rows of Q in shared
//   memory (its last product has read them) and out in 16-byte stores
//   predicated on row < S; lse = m + log2(l), times ln 2 for the natural-
//   log family.
//
// Traps, and what the code does about each:
// - With SWIZZLE_128B a TMA box is at most 128 bytes wide: 64 elements. At
//   D = 128 a tile is loaded as two 64-column boxes, stored one after the
//   other (rows x 128 bytes each); a K-major descriptor steps 32 bytes per
//   16-deep k step inside a box and jumps a box every 4 steps, with SBO =
//   1024 bytes (8 rows of 128 bytes) between 8-row core-matrix groups.
// - V is the B operand of P V with N = D contiguous: MN-major, so tnspB =
//   1 (allowed for bf16 and f16). Its descriptor has SBO = 1024 bytes
//   between the 8-row k groups and LBO = the distance between the two
//   64-column boxes along N; a 16-deep k step is 16 rows = 2048 bytes.
// - The m64nN accumulator of S holds, per thread, rows warp*16 + lane/4
//   (+8) and columns 8i + 2(lane%4) (+1): two neighbouring 8-column chunks
//   are exactly the A-register fragment of one 16-deep k step of P V, so P
//   needs no shuffles, and the MASK instance computes (row, col) from the
//   same layout.
// - mbarrier waits compare parity: use n of a stage waits for parity
//   n & 1 on its full barrier, and the producer's refill of use n waits
//   for release n - 1 of the empty barrier.
// - wgmma.fence comes before every batch of wgmma (its registers were just
//   written), wgmma.wait_group 0 before the accumulators are read, and an
//   empty asm with "+f" on every accumulator register after the wait keeps
//   the compiler from moving their reads above it.
// - Tensor maps are encoded on the host (cuTensorMapEncodeTiled, found
//   through the runtime's driver entry point, so nothing new is linked)
//   and passed by value as __grid_constant__ kernel parameters: a map
//   passed by pointer to host memory faults (error 715). Every swizzled
//   tile starts on a 1024-byte boundary.
#pragma once

#include <cuda.h>

#include "flash_common.cuh"

namespace stpu {
namespace sm90 {

constexpr int kBM = 128;       // q rows per CTA: two consumers of 64
constexpr int kBN = 128;       // kv rows per K/V tile
constexpr int kRing = 2;       // K/V stages in shared memory
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kFwdThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBoxCols = 64;   // columns of one 128-byte swizzled box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Error codes above this are cuTensorMapEncodeTiled's CUresult + this.
constexpr int kTensorMapError = 10000;
static_assert(kBM == kBN, "a causal q tile's loop ends at its own index");

// Shared memory in bytes from a 1024-byte aligned base: Q (kBM x D), kRing
// K tiles, kRing V tiles (kBN x D), each stored as D / 64 boxes of rows x
// 128 bytes in the 128-byte swizzle; then kBars full mbarriers, kBars
// empty ones and q: a K/V stage has one of each (kBars = kRing), or, for
// the overlapped schedule (kSplit), K and V have their own (kBars = 2 *
// kRing, K's stages first). kBytes adds the slack for aligning the base.
template <int D, bool kSplit = false>
struct FwdSmem {
  static constexpr int kQ = kBM * D * 2;
  static constexpr int kTileKV = kBN * D * 2;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kRing * kTileKV;
  static constexpr int kBar = kV + kRing * kTileKV;
  static constexpr int kBars = kSplit ? 2 * kRing : kRing;
  static constexpr int kBytes = kBar + (2 * kBars + 1) * 8 + 1024;
};

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(bar), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :
               : "r"(bar)
               : "memory");
}

// One arrival from each thread whose `pred` holds, predicated inside the
// instruction: no branch, so no divergent path that ptxas would have to
// wait for a wgmma in flight in (it serialises every wgmma then).
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :
      : "r"(bar), "r"((int)pred)
      : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0, c1, c2, c3), innermost first, into shared memory at
// dst, completing on the mbarrier's transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" : : "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" : : "n"(N));
}

// A barrier over the 128 threads of one consumer warpgroup (ids 1, 2).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" : : "r"(id) : "memory");
}

// ------------------------------------------------------------------ wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" : : : "memory");
}

// Returns once at most the newest committed group is still in flight.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" : : : "memory");
}

// After wgmma_wait_all: the accumulators are final here, not earlier.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) : : "memory");
}

// After a wait: the A fragments the waited-for wgmma read stay allocated,
// and unwritten, until here. Without it ptxas may give their registers to
// work placed between the issue and the wait, and then has to wait for
// the wgmma before that work.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      asm volatile("" : "+r"(r[i][k]) : : "memory");
}

// A shared-memory matrix descriptor for the 128-byte swizzle (layout type
// 1 in bits 62-63): start address, leading and stride byte offsets, each
// in 16-byte units. Adding (bytes >> 4) moves the start address.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (m64n128, fp32) = A B, or d += A B when scale_d is nonzero; A and B
// (T: bf16 or f16) are read from shared memory through descriptors, both
// K-major. The product's type string is T's: one asm body, two instances.
template <class T>
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64],
                                                uint64_t desc_a,
                                                uint64_t desc_b,
                                                int scale_d) {
#define STPU_WGMMA(TY)                                                      \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "        \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "        \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "        \
      "%60, %61, %62, %63"                                                  \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
  if constexpr (T::kHalf)
    STPU_WGMMA("f16");
  else
    STPU_WGMMA("bf16");
#undef STPU_WGMMA
}

// d (m64n64, fp32) += A B: A, 64 x 16 of T, from registers (the
// mma.m16n8k16 A fragment of each warp's 16 rows); B from shared memory
// through a descriptor, MN-major (kTnspB = 1, tnspB) or K-major (0).
template <class T, int kTnspB = 1>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
#define STPU_WGMMA(TY)                                                      \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "        \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),    \
        "n"(kTnspB))
  if constexpr (T::kHalf)
    STPU_WGMMA("f16");
  else
    STPU_WGMMA("bf16");
#undef STPU_WGMMA
}

// d (m64n128, fp32) += A B: A, 64 x 16 of T, from registers (the
// mma.m16n8k16 A fragment of each warp's 16 rows); B from shared memory
// through a descriptor, MN-major (tnspB = 1).
template <class T>
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
#define STPU_WGMMA(TY)                                                      \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "        \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "        \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "        \
      "%60, %61, %62, %63"                                                  \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
  if constexpr (T::kHalf)
    STPU_WGMMA("f16");
  else
    STPU_WGMMA("bf16");
#undef STPU_WGMMA
}

template <int D, class T>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 64)
    wgmma_m64n64_rs<T>(o, a, desc_v);
  else
    wgmma_m64n128_rs<T>(o, a, desc_v);
}

// Element offset of 16-byte chunk ch (8 elements) of row R in a kBM-row
// tile stored as TMA's 128-byte swizzle left it (D / 64 boxes of kBM x 128
// bytes): box ch / 8, chunk ch % 8 at (ch % 8) ^ (R % 8).
__device__ __forceinline__ int swz(int R, int ch) {
  return (ch / 8) * kBM * kBoxCols + R * kBoxCols + ((ch % 8) ^ (R % 8)) * 8;
}

// A consumer warpgroup's epilogue: its accumulator fragment (rows R0, R0 +
// 8 of the CTA's kBM; row r times mul[r]), rounded to T, into its own 64
// rows of the swizzled tile (conflict-free both ways), then, after the
// warpgroup's barrier, out to global memory at g (the CTA's row 0, row
// stride ss) in 16-byte stores predicated on row < S. Only this
// warpgroup's products may read those rows of the tile.
template <int D, class T>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           const float (&mul)[2],
                                           e16* tile, e16* g,
                                           long long ss, int row_start,
                                           int S) {
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int t = tid % 4, R0 = cw * 64 + (tid / 32) * 16 + (tid % 32) / 4;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int R = R0 + 8 * hf;
      *reinterpret_cast<uint32_t*>(tile + swz(R, i) + 2 * t) = T::pack(
          acc[4 * i + 2 * hf] * mul[hf], acc[4 * i + 2 * hf + 1] * mul[hf]);
    }
  }
  warpgroup_sync(1 + cw);
  constexpr int kChunks = D / 8;
  for (int c = tid; c < 64 * kChunks; c += 128) {
    const int R = cw * 64 + c / kChunks, ch = c % kChunks;
    if (row_start + R < S)
      *reinterpret_cast<uint4*>(g + (row_start + R) * ss + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + swz(R, ch));
  }
}

// ------------------------------------------------------------ the forward

// The producer's one thread: Q, then the K/V ring.
template <int D>
__device__ __forceinline__ void fwd_producer(const CUtensorMap& tq,
                                             const CUtensorMap& tk,
                                             const CUtensorMap& tv,
                                             const FwdParams& p,
                                             unsigned char* base, int b,
                                             int h, int qt, int n_kt) {
  using L = FwdSmem<D>;
  const int kvh = h / (p.H / p.KVH);
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * kRing, qbar = full0 + 16 * kRing;
  mbar_expect_tx(qbar, L::kQ);
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c)
    tma_load_4d(base + c * kBM * 128, &tq, qbar, c * kBoxCols, qt * kBM, h,
                b);
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kRing;
    if (j >= kRing) mbar_wait(empty0 + 8 * st, (j / kRing - 1) & 1);
    const uint32_t full = full0 + 8 * st;
    mbar_expect_tx(full, 2 * L::kTileKV);
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c) {
      const int off = st * L::kTileKV + c * kBN * 128;
      tma_load_4d(base + L::kK + off, &tk, full, c * kBoxCols, j * kBN, kvh,
                  b);
      tma_load_4d(base + L::kV + off, &tv, full, c * kBoxCols, j * kBN, kvh,
                  b);
    }
  }
}

// The producer's one thread for the overlapped schedule: Q, then K and V
// tiles on their own barriers (full0 + 8 * st for K, full0 + 8 * (kRing +
// st) for V, the empty ones alike), K_{j+1} ahead of V_j: a consumer needs
// K_{j+1} a P V before V_j.
template <int D>
__device__ __forceinline__ void fwd_producer_split(const CUtensorMap& tq,
                                                   const CUtensorMap& tk,
                                                   const CUtensorMap& tv,
                                                   const FwdParams& p,
                                                   unsigned char* base,
                                                   int b, int h, int qt,
                                                   int n_kt) {
  using L = FwdSmem<D, true>;
  const int kvh = h / (p.H / p.KVH);
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * L::kBars;
  const uint32_t qbar = full0 + 16 * L::kBars;
  mbar_expect_tx(qbar, L::kQ);
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c)
    tma_load_4d(base + c * kBM * 128, &tq, qbar, c * kBoxCols, qt * kBM, h,
                b);
  // Tile j of operand x (0: K, 1: V) into its stage.
  auto load = [&](int x, int j) {
    const int st = j % kRing, bar = 8 * (x * kRing + st);
    if (j >= kRing) mbar_wait(empty0 + bar, (j / kRing - 1) & 1);
    mbar_expect_tx(full0 + bar, L::kTileKV);
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c)
      tma_load_4d(base + (x ? L::kV : L::kK) + st * L::kTileKV +
                      c * kBN * 128,
                  x ? &tv : &tk, full0 + bar, c * kBoxCols, j * kBN, kvh, b);
  };
  load(0, 0);
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) load(0, j + 1);
    load(1, j);
  }
}

// The running max of one S tile (base 2): drops the masked pairs (MASK),
// updates the running max m of this thread's two rows and scales their
// running sums l by alpha = exp2(m_old - m_new).
template <bool MASK>
__device__ __forceinline__ void online_max(float (&s)[kBN / 2],
                                           float (&m)[2], float (&l)[2],
                                           float (&alpha)[2], float sm,
                                           int row0, int k_start,
                                           TileMask mask) {
  const int t = threadIdx.x % 4;
  const float kDrop = -__int_as_float(0x7f800000);  // -inf: exp2 gives 0
  float mx[2] = {kDrop, kDrop};
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && mask.drop(row0 + (e >> 1) * 8,
                            k_start + i * 8 + 2 * t + (e & 1)))
        s[4 * i + e] = kDrop;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // m starts at the finite kNegInf, so a row with nothing kept yet has
    // alpha = 1 and P = 0, never NaN.
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * sm);
    alpha[r] = Base2::exp(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
}

template <int D>
__device__ __forceinline__ void rescale_o(float (&o)[D / 2],
                                          const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o[4 * i] *= alpha[0];
    o[4 * i + 1] *= alpha[0];
    o[4 * i + 2] *= alpha[1];
    o[4 * i + 3] *= alpha[1];
  }
}

// The online softmax of one S tile (base 2): updates the running max and
// sum of this thread's two rows, rescales o, and packs P into the A
// fragments of P V's eight 16-deep k steps, rounded to T.
template <int D, class T, bool MASK>
__device__ __forceinline__ void softmax_step(float (&s)[kBN / 2],
                                             float (&o)[D / 2],
                                             float (&m)[2], float (&l)[2],
                                             uint32_t (&pa)[kBN / 16][4],
                                             float sm, int row0, int k_start,
                                             TileMask mask) {
  float alpha[2];
  online_max<MASK>(s, m, l, alpha, sm, row0, k_start, mask);
  rescale_o<D>(o, alpha);
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const float p0 = Base2::exp(fmaf(s[4 * i], sm, -m[0]));
    const float p1 = Base2::exp(fmaf(s[4 * i + 1], sm, -m[0]));
    const float p2 = Base2::exp(fmaf(s[4 * i + 2], sm, -m[1]));
    const float p3 = Base2::exp(fmaf(s[4 * i + 3], sm, -m[1]));
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    pa[i / 2][(i % 2) * 2] = T::pack(p0, p1);
    pa[i / 2][(i % 2) * 2 + 1] = T::pack(p2, p3);
  }
}

// The overlapped schedule's softmax of one S tile: s becomes P in fp32.
// o is rescaled by alpha and P packed (pack_p) later, once the P V in
// flight, which reads the previous P's registers and accumulates into o,
// has completed.
template <bool MASK>
__device__ __forceinline__ void softmax_scores(float (&s)[kBN / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float sm,
                                               int row0, int k_start,
                                               TileMask mask) {
  online_max<MASK>(s, m, l, alpha, sm, row0, k_start, mask);
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * i + e] = Base2::exp(fmaf(s[4 * i + e], sm, -m[e >> 1]));
    l[0] += s[4 * i] + s[4 * i + 1];
    l[1] += s[4 * i + 2] + s[4 * i + 3];
  }
}

// P (fp32 fragments of S's layout) into the A fragments of P V, rounded
// to T.
template <class T>
__device__ __forceinline__ void pack_p(const float (&s)[kBN / 2],
                                       uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    pa[i / 2][(i % 2) * 2] = T::pack(s[4 * i], s[4 * i + 1]);
    pa[i / 2][(i % 2) * 2 + 1] = T::pack(s[4 * i + 2], s[4 * i + 3]);
  }
}

// Issues S = Q K^T against the K tile at byte offset `tile` (uncommitted):
// dq at k step 0 of the consumer's Q rows, dk at stage 0's K.
template <int D, class T>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint64_t dq,
                                         uint64_t dk, int tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in_box = (kk % 4) * 32;  // bytes into the 64-col box
    wgmma_m64n128_ss<T>(s, dq + (((kk / 4) * kBM * 128 + in_box) >> 4),
                        dk + ((tile + (kk / 4) * kBN * 128 + in_box) >> 4),
                        kk);
  }
}

// Issues o += P V against the V tile at byte offset `tile` (uncommitted).
template <int D, class T>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBN / 16][4],
                                         uint64_t dv, int tile) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_pv<D, T>(o, pa[kk], dv + ((tile + kk * 16 * 128) >> 4));
}

// A consumer's epilogue: o / l out through its own rows of the Q tile
// (its last product has read them), lse = m + log2(l) (times ln 2 when
// kNaturalLse) for rows < S, by the lanes whose t (lane % 4) is 0.
template <int D, class T, bool kNaturalLse>
__device__ __forceinline__ void fwd_epilogue(const FwdParams& p,
                                             unsigned char* base, int b,
                                             int h, int q_start, int row0,
                                             int t, const float (&o)[D / 2],
                                             const float (&m)[2],
                                             float (&l)[2]) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / l[r];
  }
  store_rows<D, T>(o, inv, reinterpret_cast<e16*>(base),
                p.o + ((long long)b * p.S * p.H + h) * D, (long long)p.H * D,
                q_start, p.S);
  if (t == 0) {
    float* lg = p.lse + ((long long)b * p.H + h) * p.S;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + 8 * hf;
      const float x = m[hf] + log2f(l[hf]);
      if (row < p.S) lg[row] = kNaturalLse ? x * kLn2 : x;
    }
  }
}

// A consumer warpgroup in lockstep: 64 q rows of the CTA's tile through
// every K/V tile, then the epilogue.
template <int D, class T, bool kNaturalLse>
__device__ __forceinline__ void fwd_consumer(const FwdParams& p,
                                             unsigned char* base, int b,
                                             int h, int qt, int n_kt,
                                             int j_mask) {
  using L = FwdSmem<D>;
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_start = qt * kBM;
  const int row0 = q_start + cw * 64 + warp * 16 + g;  // and row0 + 8
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * kRing, qbar = full0 + 16 * kRing;
  const float sm = p.scale * kLog2e;
  const TileMask mask = {p.S, p.causal};

  // Descriptors at k step 0 of this consumer's Q rows, stage 0's K and V.
  const uint64_t dq = smem_desc(base + cw * 64 * 128, 16, 1024);
  const uint64_t dk = smem_desc(base + L::kK, 16, 1024);
  const uint64_t dv = smem_desc(base + L::kV, kBN * 128, 1024);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kRing;
    mbar_wait(full0 + 8 * st, (j / kRing) & 1);

    float s[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
    wgmma_fence();
    issue_qk<D, T>(s, dq, dk, st * L::kTileKV);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    uint32_t pa[kBN / 16][4];
    if (j == j_mask)
      softmax_step<D, T, true>(s, o, m, l, pa, sm, row0, j * kBN, mask);
    else
      softmax_step<D, T, false>(s, o, m, l, pa, sm, row0, j * kBN, mask);

    wgmma_fence();
    issue_pv<D, T>(o, pa, dv, st * L::kTileKV);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (tid == 0) mbar_arrive(empty0 + 8 * st);  // K and V of st consumed
  }
  fwd_epilogue<D, T, kNaturalLse>(p, base, b, h, q_start, row0, t, o, m,
                                  l);
}

// A consumer warpgroup in the overlapped schedule: iteration j issues S_j
// and then P_{j-1} V_{j-1}, waits for S_j alone and runs tile j's softmax
// while P V runs; then waits for P V, releases K_j and V_{j-1}, packs P_j.
// Tile 0's S goes alone before the loop, the last tile's P V after it.
// Between a product's issue and its wait nothing reads its registers on
// any path and nothing arrives on an mbarrier or branches on a thread's
// own values: ptxas would wait for the product there, or serialise every
// wgmma of the kernel.
template <int D, class T, bool kNaturalLse>
__device__ __forceinline__ void fwd_consumer_overlap(const FwdParams& p,
                                                     unsigned char* base,
                                                     int b, int h, int qt,
                                                     int n_kt, int j_mask) {
  using L = FwdSmem<D, true>;
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_start = qt * kBM;
  const int row0 = q_start + cw * 64 + warp * 16 + g;  // and row0 + 8
  // K's barriers at + 8 * st, V's at + 8 * (kRing + st).
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * L::kBars;
  const uint32_t qbar = full0 + 16 * L::kBars;
  const float sm = p.scale * kLog2e;
  const TileMask mask = {p.S, p.causal};
  const uint64_t dq = smem_desc(base + cw * 64 * 128, 16, 1024);
  const uint64_t dk = smem_desc(base + L::kK, 16, 1024);
  const uint64_t dv = smem_desc(base + L::kV, kBN * 128, 1024);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float s[kBN / 2];
  uint32_t pa[kBN / 16][4];  // P_{j-1}, read by the P V in flight
  // S_j issued after its K tile has landed.
  auto issue_s = [&](int j) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
    mbar_wait(full0 + 8 * (j % kRing), (j / kRing) & 1);
    wgmma_fence();
    issue_qk<D, T>(s, dq, dk, (j % kRing) * L::kTileKV);
    wgmma_commit();
  };
  auto softmax = [&](int j) {
    if (j == j_mask)
      softmax_scores<true>(s, m, l, alpha, sm, row0, j * kBN, mask);
    else
      softmax_scores<false>(s, m, l, alpha, sm, row0, j * kBN, mask);
  };

  mbar_wait(qbar, 0);
  issue_s(0);
  wgmma_wait_all();
  fence_regs(s);
  softmax(0);
  mbar_arrive_if(empty0, tid == 0);  // K_0 read
  pack_p<T>(s, pa);
  for (int j = 1; j < n_kt; ++j) {
    const int sp = (j - 1) % kRing;  // V_{j-1}'s stage
    rescale_o<D>(o, alpha);
    mbar_wait(full0 + 8 * (kRing + sp), ((j - 1) / kRing) & 1);
    issue_s(j);
    issue_pv<D, T>(o, pa, dv, sp * L::kTileKV);
    wgmma_commit();
    wgmma_wait_one();
    fence_regs(s);
    softmax(j);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive_if(empty0 + 8 * (j % kRing), tid == 0);  // K_j read
    mbar_arrive_if(empty0 + 8 * (kRing + sp), tid == 0);  // V_{j-1} read
    fence_regs(s);  // P_j packed only after P V has read pa
    pack_p<T>(s, pa);
  }
  const int sl = (n_kt - 1) % kRing;
  rescale_o<D>(o, alpha);
  mbar_wait(full0 + 8 * (kRing + sl), ((n_kt - 1) / kRing) & 1);
  wgmma_fence();
  issue_pv<D, T>(o, pa, dv, sl * L::kTileKV);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  fwd_epilogue<D, T, kNaturalLse>(p, base, b, h, q_start, row0, t, o, m,
                                  l);
}

// One CTA of the forward: work item blockIdx.x is (b * H + h, q tile);
// kOverlap picks the overlapped schedule over lockstep.
template <int D, class T, bool kNaturalLse, bool kOverlap = false>
__device__ __forceinline__ void fwd_cta(const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const FwdParams& p,
                                        const int* __restrict__ work,
                                        unsigned char* smem) {
  using L = FwdSmem<D, kOverlap>;
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const int bh = work[2 * blockIdx.x], qt = work[2 * blockIdx.x + 1];
  const int b = bh / p.H, h = bh % p.H;
  const int n_kt = p.causal ? qt + 1 : ceil_div(p.S, kBN);
  const int j_mask = masked_tile(p.causal, p.S, kBN, n_kt);
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(base + L::kBar);
    for (int i = 0; i < L::kBars; ++i) {
      mbar_init(bars + 8 * i, 1);                        // full: producer
      mbar_init(bars + 8 * (L::kBars + i), kConsumers);  // empty: consumers
    }
    mbar_init(bars + 16 * L::kBars, 1);                  // q
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  __syncthreads();
  // One if/else for the whole kernel: the roles never reconverge, so
  // ptxas can honour setmaxnreg.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      if constexpr (kOverlap)
        fwd_producer_split<D>(tq, tk, tv, p, base, b, h, qt, n_kt);
      else
        fwd_producer<D>(tq, tk, tv, p, base, b, h, qt, n_kt);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    if constexpr (kOverlap)
      fwd_consumer_overlap<D, T, kNaturalLse>(p, base, b, h, qt, n_kt,
                                              j_mask);
    else
      fwd_consumer<D, T, kNaturalLse>(p, base, b, h, qt, n_kt, j_mask);
  }
}

// ----------------------------------------------------------------- host

typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(ptr);
  }
  return fn;
}

// The TMA element type of T.
template <class T>
constexpr CUtensorMapDataType map_type() {
  return T::kHalf ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A map of a (B, S, heads, D) tensor of T with element strides (sb, ss,
// sh, 1), as dimensions (D, S, heads, B) innermost first: boxes of 64
// columns x `rows` rows of one head, 128-byte swizzled. S is its own
// dimension, so rows at or past it read as zeros.
template <class T>
inline int encode_rows(CUtensorMap* map, const void* ptr, int D, int S,
                       int heads, int B, long long ss, long long sh,
                       long long sb, int rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, map_type<T>(), 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// Encodes the three maps and launches `kernel` (an instance of this
// forward, with the overlapped schedule when `overlap`) over the B * H *
// ceil(S / 128) items of `work`.
template <int D, class T, class Kernel>
inline int launch_fwd(Kernel kernel, const FwdParams& p, int B,
                      const int* work, cudaStream_t stream,
                      bool overlap = false) {
  const int smem = overlap ? FwdSmem<D, true>::kBytes : FwdSmem<D>::kBytes;
  CUtensorMap tq, tk, tv;
  int err = encode_rows<T>(&tq, p.q, D, p.S, p.H, B, p.q_ss, p.q_sh, p.q_sb,
                           kBM);
  if (!err)
    err = encode_rows<T>(&tk, p.k, D, p.S, p.KVH, B, p.k_ss, p.k_sh, p.k_sb,
                         kBN);
  if (!err)
    err = encode_rows<T>(&tv, p.v, D, p.S, p.KVH, B, p.v_ss, p.v_sh, p.v_sb,
                         kBN);
  if (err) return err;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int items = B * p.H * ceil_div(p.S, kBM);
  kernel<<<items, kFwdThreads, smem, stream>>>(tq, tk, tv, p, work);
  return (int)cudaGetLastError();
}

// The build report of one kernel instance: out = {registers per thread at
// launch, dynamic shared memory bytes, threads, producer and consumer
// registers after setmaxnreg}.
template <class Kernel>
inline int kernel_attrs(Kernel kernel, int smem, int threads, int producer,
                        int consumer, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  out[0] = a.numRegs;
  out[1] = smem;
  out[2] = threads;
  out[3] = producer;
  out[4] = consumer;
  return (int)e;
}

template <int D, class T, class Kernel>
inline int fwd_attrs(Kernel kernel, int* out, bool overlap = false) {
  return kernel_attrs(kernel,
                      overlap ? FwdSmem<D, true>::kBytes : FwdSmem<D>::kBytes,
                      kFwdThreads, kProducerRegs, kConsumerRegs, out);
}

}  // namespace sm90
}  // namespace stpu

// Returns from the calling C entry with FN<D, T>(KERNEL<D, T>, ...) for the
// runtime head_dim (64, 128) and element type (T::kDtype): the instances
// of one Hopper kernel, launched (launch_fwd, launch_dq, launch_dkv) or
// reported (fwd_attrs, dq_attrs, dkv_attrs).
#define STPU_SM90_ONE(D_, T_, FN, KERNEL, ...) \
  return stpu::sm90::FN<D_, stpu::T_>(KERNEL<D_, stpu::T_>, __VA_ARGS__)

#define STPU_SM90_BY_D(HEAD_DIM, DTYPE, FN, KERNEL, ...)                  \
  do {                                                                    \
    const bool half_ = (DTYPE) == stpu::F16::kDtype;                      \
    if (!half_ && (DTYPE) != stpu::Bf16::kDtype)                          \
      return (int)cudaErrorInvalidValue;                                  \
    if ((HEAD_DIM) == 64) {                                               \
      if (half_) STPU_SM90_ONE(64, F16, FN, KERNEL, __VA_ARGS__);         \
      STPU_SM90_ONE(64, Bf16, FN, KERNEL, __VA_ARGS__);                   \
    }                                                                     \
    if ((HEAD_DIM) == 128) {                                              \
      if (half_) STPU_SM90_ONE(128, F16, FN, KERNEL, __VA_ARGS__);        \
      STPU_SM90_ONE(128, Bf16, FN, KERNEL, __VA_ARGS__);                  \
    }                                                                     \
    return (int)cudaErrorInvalidValue;                                    \
  } while (0)
