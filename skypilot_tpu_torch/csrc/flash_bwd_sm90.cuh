// The Hopper-native flash-attention backward (sm_90a): wgmma + TMA, warp
// specialised, on the forward's machinery (flash_fwd_sm90.cuh: mbarriers,
// TMA loads, setmaxnreg, the wgmma helpers, encode_rows). Two bodies, the
// split backward of the TPU kernels:
//
// - dq_cta: dq = scale * sum_k dS K, dS = P * (dP - delta), P =
//   exp(sm * q k^T - lse), dP = dO V^T; it also computes delta =
//   rowsum(dO * O) and writes it for dk/dv.
// - dkv_cta: dv = sum P^T dO and dk = scale * sum dS^T Q, summed over the
//   GQA group of query heads h / (H / KVH) == kvh in registers: no
//   atomics, deterministic. dkv_cta_wide is its head_dim-256 body in every
//   family (below), the group split across CTAs and summed in a fixed
//   order.
//
// Both are templates over D (64, 128, 256, 512, and kClusterD for every
// width past 512), the element type T (bf16,
// f16: the inputs', P's and dS's before their products, and the outputs') and
// the softmax base (Base2: exp2 with a base-2 lse, sm = scale * log2(e)
// folded into the one FFMA each score takes; BaseE: natural exp and lse;
// BaseE2, dq only: a natural-log lse scaled into base 2 once per row,
// then exp2 as Base2);
// the mask is the runtime TileMask (causal, and key columns at or past S).
// flash_tri.cu instantiates them in base 2, causal, as flash_dq_tri_kernel
// (its CTA shape DqTri: DqSplitKV at head_dim 256) and
// flash_dkv_tri_kernel; flash_bwd.cu in natural exp, with the runtime
// causal flag, as flash_dq_kernel (its CTA shape DqResident: DqWide at
// head_dim 256) and flash_dkv_kernel (the resident
// family); flash_streamed.cu instantiates both once more, as flash_bwd.cu
// does, as flash_dq_streamed_kernel (in BaseE2, with Q and dO held in
// registers, kRegA = 2) and flash_dkv_streamed_kernel: every backward
// kernel of the 16-bit path is one of these two bodies.
//
// What bounds them: the tensor cores (at S 8192, D 128 ~S*D/2 flops per
// byte they must move, far past the ~295 flop/byte ridge). Design:
//
// - One CTA per 128-row tile of the resident operand (dq: q rows of one
//   (b, h); dk/dv: kv rows of one (b, kv head)), walking a host-built
//   longest-first work list (ops/flash_attention.py: tri_schedule; a
//   non-causal launch walks the same list, whose items then cost the
//   same). 384
//   threads: a producer warpgroup (setmaxnreg 40; one thread issues every
//   TMA load) and two consumer warpgroups (setmaxnreg 232) of 64 resident
//   rows each, as in the forward.
// - dq: the producer loads Q and dO (128 rows) once, then 64-row K and V
//   tiles into a ring of kBwdRing stages (full and empty mbarrier per
//   stage). Per tile each consumer runs S = Q K^T and dP = dO V^T as
//   wgmma m64n64k16, dS on the accumulator fragments, then dq += dS K
//   with dS as the register A operand and K read MN-major (tnspB = 1):
//   the forward's P V with K in V's place. S and dP read both operands
//   from shared memory (K-major), or, with kRegA, Q (1) or Q and dO (2)
//   from registers, loaded once from the swizzled tile (ldmatrix) into
//   A fragments: an m64n64k16 with both operands in shared memory reads
//   4 KB per 131 kFLOP, 128 B a clock at the tensor cores' peak, all
//   that shared memory gives an SM; with A in registers it reads half.
// - dk/dv: the producer loads K and V (128 rows) once, then, for each
//   query head of the group and each 64-row q tile from the causal start
//   (0 when not causal), Q, dO and the tile's lse and delta into the
//   ring. Per tile each
//   consumer runs S^T = K Q^T and dP^T = V dO^T (m64n64, shared memory,
//   K-major), P^T and dS^T on the fragments (their C layout is the A
//   fragment of the next products), then dv += P^T dO and dk += dS^T Q
//   with dO and Q read MN-major from the same stage.
// - Registers: dq holds dq (D / 2 fp32 a thread), S and dP (32 each) and
//   dS packed (16), plus with kRegA the A fragments of Q and dO (D / 4
//   each): 208 at D = 128 with both, under the consumers' 232; dk/dv
//   holds dk and dv (2 x D / 2) beside S^T and dP^T (2 x 32): 192
//   accumulator registers at D = 128.
// - Head_dim 256 (Gemma's; every family, in every base). dq: the 128-row
//   resident pair takes 128 KB, and a 64-row K or V tile 32 KB. Each
//   consumer holds dq (128 registers) beside S and dP; what binds is the
//   shared memory's 128 B a clock as much as the tensor cores (an m64n64
//   with both operands there reads 4 KB per 131 kFLOP, exactly that
//   rate), and the registers.
//   - The triangular dq runs DqSplitKV: 64-row K tiles in two stages
//     and V in one, each on full and empty barriers of its own (230,968
//     B). A consumer waits for K_j and V_j, runs S and dP as
//     m64n64, releases V_j, computes dS, runs dS K and releases K_j: the
//     producer's load of V_{j+1} runs under dS K, and K_{j+1} has been
//     resident since tile j - 1 ended. S and dP at m64n64 keep shared
//     memory and the tensor cores in balance (3,072 clocks each a 64-row
//     tile for the CTA).
//     V is waited for before S is issued: a wait between S's and dP's
//     issue makes ptxas serialise every wgmma (C7520). Registers: dq
//     (128) + S, dP (32 each) + dS (16) = 208, with the warpgroup index
//     uniform (kUniform) so the descriptors sit in uniform registers;
//     without it this shape spills 132 B (68 at 240 registers) and runs
//     1.5 times slower.
//   - The streamed dq keeps one stage of a 64-row K and V tile (DqBase,
//     bwd_ring; 193 KB): the producer's next load waits for both
//     consumers to release the last, so loads and products run in turn,
//     and at 232 registers it spills 60 B.
//   - The resident dq runs DqWide: 32-row K/V tiles in three 32 KB stages
//     (226 KB), the next two tiles' loads in flight under a tile's
//     products; S and dP become m64n32 (16 registers each, no spills)
//     with both operands in shared memory: 3 KB per 65.5 kFLOP, 1.5 times
//     what m64n64 asks a clock. Each consumer's 64 rows meet the diagonal
//     in two 32-row tiles, both masked.
//   Timed in turns at the triangular 1 x 8192 (tools/flash_dq_variants.py,
//   H100 SXM at 700 W; PERF.md): DqSplitKV 0.546 ms; DqWide
//   0.758, 0.657 with kUniform; DqBase 0.861, 0.784 with kUniform;
//   DqSplitKV without kUniform 0.811. kUniform is why the resident and
//   streamed shapes are levers too (PERF.md). Timed and gone: DqWide with
//   S's first 4 or 8 k steps reading Q from registers (0.760-0.761),
//   DqSplitKV with its first 4 (ptxas serialises every wgmma for want
//   of registers, C7512), the consumers at 240 registers and the
//   producer at 24 (the spills stay), K and V of 64 rows in three slots
//   of their own (216 B of spills), a 64-row q tile shared by both
//   consumers exchanging P and dP through shared memory, the next tile's
//   S and dP issued before this tile's dS (168 B of spills), tile j's dS
//   K waited for with tile j + 1's S and dP, and consumer 1 started
//   behind consumer 0 (both no faster).
//   dk and dv together (256 fp32 a thread) do not fit one consumer, so
//   every dk/dv at 256 runs dkv_cta_wide, a CTA of its own:
//   - one 64-row kv tile of one (b, kv head) per CTA, with dv and dk in
//     separate consumer warpgroups over the same rows: consumer 0 runs
//     S^T = K Q^T, P^T, dv += P^T dO (176 registers), consumer 1 S^T,
//     dP^T = V dO^T, dS^T, dk += dS^T Q (208). Both read the same ring
//     stage, so each Q/dO tile is loaded once per item; five products
//     per tile pair (S^T in both). Causal, both consumers own the same
//     rows: they share the diagonal q tile (kt), mask it alike and skip
//     nothing;
//   - K and V take 64 KB, so the ring has two stages of Q, dO, lse and
//     delta (2 x 64.5 KB; 193 KB in all): the producer's next TMA load
//     is in flight while the consumers run their products;
//   - the GQA group split across CTAs: work item (b * KVH + kvh, kv
//     tile, part) walks heads [part * G / P, (part + 1) * G / P) of the
//     group of G = H / KVH. P (a divisor of G) comes from the host
//     (ops/flash_attention.py: dkv_parts, the shape and the card's SM
//     count). P = 1 writes dk and dv in T as before. P > 1: each item
//     writes its fp32 partials from registers into a workspace (2, P, B,
//     S, KVH, D) (dv then dk, rows < S), takes an integer ticket per kv
//     tile and output, and the last item to arrive sums the P partials in
//     part order (all read back through L2, 16-byte chunks, every part's
//     load issued before the sums), times scale for dk, rounds to T and
//     writes them: one launch, no float atomics, and the same sum in the
//     same order whichever item arrives last, so deterministic.
// - Head_dim 512 (every family, in every base): a consumer cannot hold a
//   64-row block of dq, dk or dv (256 fp32 a thread), so both bodies run
//   clusters of two CTAs, CTA c holding chunk c (kChunk = 256 columns) of
//   every operand, each reduction over the 512 columns split between the
//   two: each CTA computes its partials over its chunk (m64n64, 256 deep),
//   sends them as fp32 wgmma fragments into the other's shared memory
//   (st.async, completing on an mbarrier there, which its reader arms for
//   the bytes) and adds the other's: one IEEE sum of two terms, the same
//   in both CTAs, so everything formed from it agrees bit for bit and the
//   backward stays deterministic.
//   - dq_cta_512: an item of kDq512Rows (64) q rows, CTA c holding Q_c and
//     dO_c (32 KB each), 64-row K_c tiles in three stages and V_c in one,
//     on barriers of their own. Consumer 0 computes S_c = Q_c K_c^T,
//     consumer 1 dP_c = dO_c V_c^T; each sends its partial to its
//     counterpart and adds the one received, in place in the exchange
//     buffer, so after one barrier of the two consumers each reads the
//     other's sum: both hold S and dP, form dS (the same in both) and run
//     their 128-column half of dq_c += dS K_c (m64n128k16, K_c MN-major).
//     Three products' worth of work a tile pair, the minimal, against the
//     parent body's 1.67 times (one consumer a chunk, each recomputing S
//     and dP over all 512 columns as m64n32). The exchange runs a tile
//     ahead (tile j + 1's partial computed before tile j's is awaited),
//     so each crosses under this CTA's products, and the remote arrival
//     that frees a buffer is a release at CTA scope
//     (mbar_arrive_remote_if). delta spans the 512 columns: each CTA forms
//     its chunk's partial (O from global memory, dO_c from shared memory)
//     and sends it to the other, delta = part 0 + part 1 in both; rank 0's
//     consumer 0 writes it (dk/dv reads it). The triangular and streamed
//     families run it; the resident one keeps dq_cta_chunked_512, a CTA an
//     item (below).
//     231,012 B.
//   - dkv_cta_512: a cluster of two CTAs a 64-row kv tile (block i is
//     rank i % 2, chunk i % 2 of dkv_wide_schedule's item i / 2), CTA c
//     holding chunk c of K, V (32 KB each), Q and dO (two stages of a
//     kDkv512QRows (64)-row tile, 32 KB each). The reduction of S^T and
//     dP^T over the 512 columns is split between the two: consumer 0
//     computes S^T_c = K_c Q_c^T, consumer 1 S^T_c and dP^T_c = V_c
//     dO_c^T (m64n64), consumer 0 sends S^T_c and consumer 1 dP^T_c, as
//     fp32 fragments, to the other CTA's shared memory (st.async,
//     completing on an mbarrier there), and each forms S^T = S^T_c +
//     S^T_other (dP^T likewise): one IEEE sum of two terms, the same in
//     both CTAs and consumers, so P^T and dS^T agree bit for bit and the
//     backward stays deterministic. Then dv_c += P^T dO_c (consumer 0)
//     and dk_c += dS^T Q_c (consumer 1): five products a tile pair,
//     against four minimal and the parent body's eight (one CTA a chunk,
//     S^T in both consumers and dP^T over all 512 columns, m64n32, one
//     stage of 32-row tiles). One exchange stage (two partials, 32 KB),
//     written again once all four consumers have read it (x_free, remote
//     arrivals). 231,504 B. Timed in turns on an H100 SXM
//     (tools/flash_dkv_variants.py --width 512; PERF.md): 1.65-1.95x the
//     parent's speed at the three families' main shapes; with 32-row
//     tiles (m64n32) 1.24-1.36x slower, which also holds for the same
//     body with consumer 0's S^T handed to consumer 1 instead of
//     recomputed (three stages; a 64-row copy would pass 227 KB). The
//     GQA split, its workspace (2, P, B, S, KVH, 512) and the
//     last-arrival sum are dkv_cta_wide's, ticketed per kv tile and
//     chunk.
// - Past head_dim 512 (768 ... 2048; the kClusterD instances, width p.D):
//   dq_cta_x and dkv_cta_x run an item of the width-512 lists as a cluster
//   of n = width / kChunk CTAs, CTA c holding chunk c of every operand,
//   with the forward's pulled exchange (flash_fwd_sm90.cuh, fwd_cta_x): a
//   consumer puts its partial in a slot of its own CTA and publishes it to
//   every rank, every rank reads the n slots in rank order, and a slot is
//   rewritten once all n have read it, so every rank forms the same sums.
//   dq (every family, the resident one too): consumer 0 puts S_c, consumer
//   1 dP_c; each sums its kind over the ranks and leaves the sum for the
//   other in this CTA's shared memory (two barriers of the consumers a
//   tile; K in two stages, V in one, the sums in the third K stage's
//   room), delta's partials pulled once an item; each consumer a
//   128-column half of dq_c. dk/dv: consumer 0 puts S^T_c and consumer 1
//   dP^T_c (four products a tile pair, none recomputed), consumer 0 pulls
//   S^T, consumer 1 S^T and dP^T (a quarter of the tile at a time, so it
//   does not spill); dkv_cta_512's shared memory and GQA parts, ticketed
//   per kv tile and chunk. Both one tile at a time.
// - Not done: a persistent grid; overlapping one tile's elementwise work
//   with the same consumer's next products (dk/dv would hold dk, dv, P^T,
//   dS^T, S^T and dP^T in flight, 224 registers a thread at D = 128:
//   ptxas serialises every wgmma for want of registers, at 232 and at
//   240; the width-256 dq spills and runs 2.6 times slower). Running the
//   two consumers half a tile apart on the forward's ping-pong barriers
//   (each tile's two batches of products in turn) was correct, causal
//   included, and no faster than lockstep (PERF.md). A cluster of two
//   CTAs over two heads of a KV group, one K/V load multicast to both
//   (for the width-256 forward it measured no faster: its multicast
//   writes every byte into each CTA's shared memory all the same).
//
// Traps, and what the code does about each:
// - Unequal tiles make the two consumers' causal bounds differ. dq, q
//   tile qt, 64-row KV tiles: consumer 0 (rows 128 qt + 0..63) ends on KV
//   tile 2 qt, its diagonal; consumer 1 on 2 qt + 1 (32-row tiles: on 4
//   qt + 1 and 4 qt + 3, each masking its last two). dk/dv, KV tile kt,
//   64-row q tiles: q tile 2 kt is consumer 0's diagonal and lies wholly
//   above consumer 1's rows, so consumer 1 skips it (in every head of the
//   group) and masks 2 kt + 1. Each consumer decides its own MASK tile.
//   A consumer that skips a stage still waits for it to be full and then
//   arrives on its empty barrier: without the arrival the ring hangs, and
//   an arrival before the stage is full could complete the previous
//   phase early and let the producer overwrite a tile the other consumer
//   still reads.
// - Rows past S: TMA zero-fills Q, dO, K and V there. lse and delta past S
//   are finite: dq reads lse with a row < S predicate (else 0) and
//   computes delta 0 there; dk/dv loads them through a tensor map over
//   (S, B * H) that zero-fills. With q = dO = 0 such a column gives P = 1,
//   dP = 0, dS = 0: it adds exactly 0 to dk and dv, in either causal mode.
//   lse and delta are (B, H, S) fp32, so a bulk copy of a ragged last tile
//   would read the next head's values: the map's S dimension stops it.
//   Key columns past S: dq's non-causal loop masks its ragged last KV tile
//   (masked_tile), a causal one its diagonal (zero K rows would add 0 to dq
//   anyway; the mask keeps exp(-lse) out of dS). Both epilogues store only
//   rows < S.
// - A full barrier's transaction count is the whole boxes', rows past S
//   included.
// - The ticket of dkv_cta_wide: every thread of a consumer stores its
//   partial, fences (__threadfence), meets the others at the warpgroup's
//   barrier, and only then does one thread add 1 to the tile's counter;
//   the item that reads P - 1 reads the other parts through L2
//   (ld.global.cg), never through L1, which may hold no stale line of
//   them but is not coherent. Counters start at 0 (zeroed by the wrapper
//   each call), so no launch depends on the previous one's.
// - Shared memory at D = 128: dq 2 x 32 KB (Q, dO) + kBwdRing x 32 KB
//   (64-row K and V) + 512 B delta; dk/dv 2 x 32 KB (K, V) + kBwdRing x
//   (32 KB + 512 B) (Q, dO, lse, delta): 129.6 KB each at 2 stages, under
//   227 KB (kMaxSmem; DqSmem asserts it). Every swizzled tile starts on
//   a 1024-byte boundary. Plain reads and writes of a swizzled tile (dq's
//   delta, both epilogues) apply the 128-byte swizzle: 16-byte chunk c of
//   row R lies at chunk c ^ (R % 8).
// - The forward's traps hold here too: wgmma.fence before each batch,
//   wait_group 0 and the "+f" register fence before accumulators are
//   read, tensor maps by value as __grid_constant__ parameters, two
//   64-column boxes per 128-wide row.
#pragma once

#include <type_traits>

#include "flash_fwd_sm90.cuh"

namespace stpu {
namespace sm90 {

// The forward's roles (kFwdThreads; setmaxnreg kProducerRegs and
// kConsumerRegs) and its resident tile, so swz and store_rows serve both.
constexpr int kBwdRows = 128;  // resident rows per CTA: two consumers of 64
constexpr int kBwdTile = 64;   // rows of a streamed tile (dq: K/V, dk/dv: q)
constexpr int kBwdRing = 2;    // streamed stages in shared memory
static_assert(kBwdRows == kBM, "the forward's resident tile");
static_assert(kBwdRows % kBwdTile == 0,
              "a resident tile is whole streamed tiles");
// kv rows per CTA of dkv_cta_wide (one consumer's 64, held by both).
constexpr int kWideRows = 64;
static_assert(kWideRows == kBwdTile,
              "dkv_cta_wide's diagonal q tile has its kv tile's index");

// The GQA split of dkv_cta_wide: P = parts items per kv tile (at most
// kMaxParts), each over G / P heads of the group; with P > 1 their fp32
// partials go to ws, (2, P, batch, S, KVH, D) (dv, then dk), and each kv
// tile has two counters in tickets (dv, dk), zero at launch. Unused (P =
// 1) by every other dk/dv.
constexpr int kMaxParts = 8;
struct DkvSplit {
  float* ws;
  int* tickets;
  int parts;
  int batch;
};

// Streamed stages at head_dim D: kBwdRing, and one at D = 256, where the
// 128-row resident pair alone takes 128 KB and a stage 64 KB.
template <int D>
constexpr int bwd_ring() {
  return D > 128 ? 1 : kBwdRing;
}

// The shape of a dq CTA's K/V ring, against the 128 resident q rows (a
// 64-row half for each consumer): kSlots stages of a kKv-row K and V tile
// each, on one full and one empty barrier a stage; or, with kVSlots > 0,
// kSlots K tiles and kVSlots V tiles, each on barriers of its own (a
// consumer releases V once dP is done, K once dS K is). kUniform: each
// consumer takes its warpgroup index from lane 0
// (__shfl_sync), so ptxas knows it warp-uniform and builds the shared-
// memory descriptors derived from it in uniform registers; without it
// they take general registers, and the 64-row tiles at head_dim 256 spill.
template <int kKvN, int kSlotsN, int kVSlotsN = 0, bool kUniformN = false>
struct DqShape {
  static constexpr int kKv = kKvN, kSlots = kSlotsN, kVSlots = kVSlotsN;
  static constexpr bool kUniform = kUniformN;
};

// Every dq but the resident one at head_dim 256: bwd_ring<D>() stages of
// a 64-row K and V tile.
template <int D>
using DqBase = DqShape<kBwdTile, bwd_ring<D>()>;

// The resident dq at head_dim 256: 32-row K/V tiles in three 32 KB stages
// beside the 128 KB of Q and dO, so two tiles' loads are in flight under
// the products (S and dP become m64n32 with both operands in shared
// memory).
using DqWide = DqShape<32, 3>;

// The resident dq's shape (flash_bwd.cu): DqWide at head_dim 256.
template <int D>
using DqResident = std::conditional_t<(D > 128), DqWide, DqBase<D>>;

// The triangular dq at head_dim 256: 64-row K tiles in two stages and V
// in one, each on barriers of its own, the warpgroup index uniform (S
// and dP as m64n64, the next K resident a tile ahead, the next V loaded
// under dS K).
using DqSplitKV = DqShape<kBwdTile, 2, 1, true>;

// The triangular dq's shape (flash_tri.cu): DqSplitKV at head_dim 256.
template <int D>
using DqTri = std::conditional_t<(D > 128), DqSplitKV, DqBase<D>>;

// The most dynamic shared memory a block may use.
constexpr int kMaxSmem = 232448;

// dq's shared memory from a 1024-byte aligned base: Q and dO (kBwdRows x
// D); kSlots K tiles, then kVStages V tiles (kKv x D), each tile D / 64
// boxes of rows x 128 bytes, 128-byte swizzled; delta of the 128 rows;
// mbarriers full[kBars], empty[kBars], q (with split K and V barriers
// each array holds K's kSlots, then V's kVSlots).
template <int D, class Sh = DqBase<D>>
struct DqSmem {
  static constexpr bool kSplit = Sh::kVSlots > 0;
  static constexpr int kVStages = kSplit ? Sh::kVSlots : Sh::kSlots;
  static constexpr int kBars = kSplit ? Sh::kSlots + Sh::kVSlots : Sh::kSlots;
  static constexpr int kRowsTile = kBwdRows * D * 2;
  static constexpr int kTile = Sh::kKv * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kRowsTile;
  static constexpr int kK = 2 * kRowsTile;
  static constexpr int kV = kK + Sh::kSlots * kTile;
  static constexpr int kDelta = kV + kVStages * kTile;
  static constexpr int kBar = kDelta + kBwdRows * 4;
  static constexpr int kBytes = kBar + (2 * kBars + 1) * 8 + 1024;
  static_assert(kBytes <= kMaxSmem, "past the 227 KB a block may use");
};

// dk/dv's at head_dim 64 and 128 (dkv_cta_wide has its own): K and V
// (kBwdRows x D); kRing Q and dO tiles (kBwdTile x D); kRing lse and delta
// rows (kBwdTile fp32); mbarriers full, empty, kv.
template <int D>
struct DkvSmem {
  static_assert(D <= 128, "head_dim 256 runs dkv_cta_wide");
  static constexpr int kRing = kBwdRing;
  static constexpr int kRowsTile = kBwdRows * D * 2;
  static constexpr int kTile = kBwdTile * D * 2;
  static constexpr int kStat = kBwdTile * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kRowsTile;
  static constexpr int kQ = 2 * kRowsTile;
  static constexpr int kDO = kQ + kRing * kTile;
  static constexpr int kLse = kDO + kRing * kTile;
  static constexpr int kDelta = kLse + kRing * kStat;
  static constexpr int kBar = kDelta + kRing * kStat;
  static constexpr int kBytes = kBar + (2 * kRing + 1) * 8 + 1024;
};

// TMA: the box at (c0, c1), innermost first (the fp32 lse / delta rows).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
        "r"(c1), "r"(bar)
      : "memory");
}

// The same with A, this warpgroup's 64 rows, held in registers (a[kk] for
// k step kk, as load_a_frags leaves them): only B is read from shared
// memory, K-major (tnspB = 0).
template <int D, class T>
__device__ __forceinline__ void mma_rs_nt(float (&d)[32],
                                          const uint32_t (&a)[D / 16][4],
                                          uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64_rs<T, /*kTnspB=*/0>(
        d, a[kk], desc_b + (((kk / 4) * kBwdTile * 128 + (kk % 4) * 32) >> 4));
}

// d (64 x D fp32) += A B: A, 64 x N of T from registers (a[kk] for k
// step kk); B, an N x D tile read MN-major at desc_b (LBO = the box
// stride, N * 128 bytes).
template <int D, class T, int N = kBwdTile>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2],
                                       const uint32_t (&a)[N / 16][4],
                                       uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_pv<D, T>(d, a[kk], desc_b + ((kk * 16 * 128) >> 4));
}

// Sum of the products of 8 pairs of T.
template <class T>
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = T::unpack(x[i]), fy = T::unpack(y[i]);
    s = fmaf(fx.x, fy.x, fmaf(fx.y, fy.y, s));
  }
  return s;
}

// ---------------------------------------------------------------------- dq

// The producer's one thread: Q and dO, then the K/V ring of shape Sh.
template <int D, class Sh>
__device__ __forceinline__ void dq_producer(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const BwdParams& p, unsigned char* base, int b,
    int h, int qt, int n_kt) {
  using L = DqSmem<D, Sh>;
  const int kvh = h / (p.H / p.KVH);
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * L::kBars;
  const uint32_t qbar = full0 + 16 * L::kBars;
  mbar_expect_tx(qbar, 2 * L::kRowsTile);
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c) {
    const int off = c * kBwdRows * 128;
    tma_load_4d(base + L::kQ + off, &tq, qbar, c * kBoxCols, qt * kBwdRows,
                h, b);
    tma_load_4d(base + L::kDO + off, &tdo, qbar, c * kBoxCols,
                qt * kBwdRows, h, b);
  }
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % Sh::kSlots;
    if (j >= Sh::kSlots) mbar_wait(empty0 + 8 * st, (j / Sh::kSlots - 1) & 1);
    const uint32_t full = full0 + 8 * st;
    if constexpr (L::kSplit) {
      // K_j, then V_j once V_{j - kVSlots} is released (after its dP).
      mbar_expect_tx(full, L::kTile);
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c)
        tma_load_4d(base + L::kK + st * L::kTile + c * Sh::kKv * 128, &tk,
                    full, c * kBoxCols, j * Sh::kKv, kvh, b);
      const int sv = j % L::kVStages;
      const uint32_t vbar = 8 * (Sh::kSlots + sv);
      if (j >= L::kVStages)
        mbar_wait(empty0 + vbar, (j / L::kVStages - 1) & 1);
      mbar_expect_tx(full0 + vbar, L::kTile);
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c)
        tma_load_4d(base + L::kV + sv * L::kTile + c * Sh::kKv * 128, &tv,
                    full0 + vbar, c * kBoxCols, j * Sh::kKv, kvh, b);
    } else {
      mbar_expect_tx(full, 2 * L::kTile);
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c) {
        const int off = st * L::kTile + c * Sh::kKv * 128;
        tma_load_4d(base + L::kK + off, &tk, full, c * kBoxCols,
                    j * Sh::kKv, kvh, b);
        tma_load_4d(base + L::kV + off, &tv, full, c * kBoxCols,
                    j * Sh::kKv, kvh, b);
      }
    }
  }
}

// dS = P * (dP - delta) of one 64 x N tile, P = exp(sm * s - lse), into
// the A fragments of dS K's N / 16 16-deep k steps, rounded to T. MASK
// drops (row, key) pairs by `mask`.
template <class T, class Base, bool MASK, int N = kBwdTile>
__device__ __forceinline__ void ds_tile(const float (&s)[N / 2],
                                        const float (&dp)[N / 2],
                                        uint32_t (&da)[N / 16][4],
                                        float sm, const float (&lse)[2],
                                        const float (&dlt)[2], int row0,
                                        int k_start, TileMask mask) {
  const int t = threadIdx.x % 4;
  const float kDrop = -__int_as_float(0x7f800000);  // -inf: exp gives 0
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1;
      float x = fmaf(s[4 * i + e], sm, -lse[hf]);
      if (MASK && mask.drop(row0 + 8 * hf, k_start + i * 8 + 2 * t + (e & 1)))
        x = kDrop;
      ds[e] = Base::exp(x) * (dp[4 * i + e] - dlt[hf]);
    }
    da[i / 2][(i % 2) * 2] = T::pack(ds[0], ds[1]);
    da[i / 2][(i % 2) * 2 + 1] = T::pack(ds[2], ds[3]);
  }
}

// A consumer warpgroup of a kBwdRows-row CTA: delta for its 64 q rows,
// then dq over the K/V tiles up to its causal bound, then the epilogue.
// kRegA: how many of its resident A operands, Q then dO, it holds in
// registers for the whole loop (S = Q K^T and dP = dO V^T then read only
// K or V from shared memory); 0 reads both from shared memory at every
// tile.
template <int D, class T, class Base, int kRegA, class Sh>
__device__ __forceinline__ void dq_consumer(const BwdParams& p,
                                            unsigned char* base, int b,
                                            int h, int qt, int n_kt) {
  using L = DqSmem<D, Sh>;
  constexpr int kKv = Sh::kKv;
  static_assert(kRegA == 0 || kKv == kBwdTile, "register A against 64 keys");
  int cw = threadIdx.x / 128 - 1;
  if constexpr (Sh::kUniform) cw = __shfl_sync(0xffffffffu, cw, 0);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int q_start = qt * kBwdRows;
  const int R0 = cw * 64 + warp * 16 + lane / 4;  // and R0 + 8
  const int row0 = q_start + R0;
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * L::kBars;
  const uint32_t qbar = full0 + 16 * L::kBars;
  const float sm = p.scale * Base::kScoreMul;
  const TileMask mask = {p.S, p.causal};
  const long long stat = ((long long)b * p.H + h) * p.S;
  // Causal: this consumer's rows meet the diagonal in KV tiles diag ..
  // j_last (one 64-row tile, two 32-row ones), which it masks; consumer 0
  // skips the CTA's tiles past its rows. Rows past S are never stored:
  // lse 0 keeps them finite.
  const int diag = qt * (kBwdRows / kKv) + cw * (64 / kKv);
  const int j_last =
      p.causal ? min(diag + 64 / kKv - 1, n_kt - 1) : n_kt - 1;
  const int j_mask = p.causal ? diag : masked_tile(0, p.S, kKv, n_kt);
  float lse_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    lse_r[hf] = row0 + 8 * hf < p.S
                    ? p.lse[stat + row0 + 8 * hf] * Base::kLseMul
                    : 0.f;

  // delta = rowsum(dO * O): two threads a row, O from global memory, dO
  // from the swizzled tile; 0 past S.
  mbar_wait(qbar, 0);
  float* sDelta = reinterpret_cast<float*>(base + L::kDelta);
  {
    const e16* sdO = reinterpret_cast<const e16*>(base + L::kDO);
    const int R = cw * 64 + tid / 2, half = tid % 2, row = q_start + R;
    float sum = 0.f;
    if (row < p.S) {
      const e16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int ch = half * (D / 16) + c;
        sum += dot8<T>(*reinterpret_cast<const uint4*>(orow + ch * 8),
                    *reinterpret_cast<const uint4*>(sdO + swz(R, ch)));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      sDelta[R] = sum;
      if (row < p.S) p.delta[stat + row] = sum;
    }
  }
  warpgroup_sync(1 + cw);
  const float dlt_r[2] = {sDelta[R0], sDelta[R0 + 8]};

  // This warp's 16 rows of Q (and dO) as A fragments (unused arrays when
  // kRegA leaves them in shared memory).
  [[maybe_unused]] uint32_t qa[kRegA >= 1 ? D / 16 : 1][4];
  [[maybe_unused]] uint32_t doa[kRegA >= 2 ? D / 16 : 1][4];
  if constexpr (kRegA >= 1)
    load_a_frags(qa, base + L::kQ, cw * 64 + warp * 16);
  if constexpr (kRegA >= 2)
    load_a_frags(doa, base + L::kDO, cw * 64 + warp * 16);

  // Descriptors: this consumer's Q and dO rows (A), the ring's first K
  // and V (B, K-major), and K again MN-major for dS K.
  const uint64_t d_q = smem_desc(base + L::kQ + cw * 64 * 128, 16, 1024);
  const uint64_t d_do = smem_desc(base + L::kDO + cw * 64 * 128, 16, 1024);
  const uint64_t d_k = smem_desc(base + L::kK, 16, 1024);
  const uint64_t d_v = smem_desc(base + L::kV, 16, 1024);
  const uint64_t d_kmn = smem_desc(base + L::kK, kKv * 128, 1024);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % Sh::kSlots;
    // Split barriers: V_j's stage and the offset of its full and empty
    // barriers (K's are st's).
    [[maybe_unused]] const int sv = j % L::kVStages;
    [[maybe_unused]] const uint32_t vbar = 8 * (Sh::kSlots + sv);
    mbar_wait(full0 + 8 * st, (j / Sh::kSlots) & 1);
    // V too, before S is issued: a wait between S's and dP's issue makes
    // ptxas serialise every wgmma (C7520).
    if constexpr (L::kSplit) mbar_wait(full0 + vbar, (j / L::kVStages) & 1);
    if (j <= j_last) {
      const uint32_t tile = (st * L::kTile) >> 4;
      float s[kKv / 2], dp[kKv / 2];
#pragma unroll
      for (int i = 0; i < kKv / 2; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      if constexpr (kRegA >= 1)
        mma_rs_nt<D, T>(s, qa, d_k + tile);
      else
        mma_nt_n<D, T, kKv>(s, d_q, kBwdRows * 128, d_k + tile, kKv * 128);
      if constexpr (L::kSplit) {
        mma_nt_n<D, T, kKv>(dp, d_do, kBwdRows * 128,
                            d_v + ((sv * L::kTile) >> 4), kKv * 128);
      } else if constexpr (kRegA >= 2) {
        mma_rs_nt<D, T>(dp, doa, d_v + tile);
      } else {
        mma_nt_n<D, T, kKv>(dp, d_do, kBwdRows * 128, d_v + tile,
                            kKv * 128);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      if constexpr (L::kSplit)
        mbar_arrive_if(empty0 + vbar, tid == 0);  // V_j read
      // Causally the tiles from the diagonal one on take the masked step
      // (64 / kKv of them: the loop stops after them); otherwise only a
      // ragged last tile.
      uint32_t da[kKv / 16][4];
      if ((kKv < 64 && p.causal) ? j >= j_mask : j == j_mask)
        ds_tile<T, Base, true, kKv>(s, dp, da, sm, lse_r, dlt_r, row0,
                                    j * kKv, mask);
      else
        ds_tile<T, Base, false, kKv>(s, dp, da, sm, lse_r, dlt_r, row0,
                                     j * kKv, mask);
      wgmma_fence();
      mma_rs<D, T, kKv>(acc, da, d_kmn + tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    } else if constexpr (L::kSplit) {
      if (tid == 0) mbar_arrive(empty0 + vbar);
    }
    if (tid == 0) mbar_arrive(empty0 + 8 * st);  // K (and V) of st consumed
  }

  // dq * scale through this consumer's own rows of Q (its last product has
  // read them).
  const float mul[2] = {p.scale, p.scale};
  store_rows<D, T>(acc, mul, reinterpret_cast<e16*>(base + L::kQ),
                p.dq + ((long long)b * p.S * p.H + h) * D, (long long)p.H * D,
                q_start, p.S);
}

// One CTA of dq: work item blockIdx.x is (b * H + h, 128-row q tile).
template <int D, class T, class Base, int kRegA = 0, class Sh = DqBase<D>>
__device__ __forceinline__ void dq_cta(const CUtensorMap& tq,
                                       const CUtensorMap& tdo,
                                       const CUtensorMap& tk,
                                       const CUtensorMap& tv,
                                       const BwdParams& p,
                                       const int* __restrict__ work,
                                       unsigned char* smem) {
  using L = DqSmem<D, Sh>;
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const int bh = work[2 * blockIdx.x], qt = work[2 * blockIdx.x + 1];
  const int b = bh / p.H, h = bh % p.H;
  const int n_all = ceil_div(p.S, Sh::kKv);
  const int n_kt =
      p.causal ? min(n_all, (qt + 1) * (kBwdRows / Sh::kKv)) : n_all;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(base + L::kBar);
    for (int i = 0; i < L::kBars; ++i) {
      mbar_init(bars + 8 * i, 1);                        // full: producer
      mbar_init(bars + 8 * (L::kBars + i), kConsumers);  // empty
    }
    mbar_init(bars + 16 * L::kBars, 1);                  // q and dO
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      dq_producer<D, Sh>(tq, tdo, tk, tv, p, base, b, h, qt, n_kt);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dq_consumer<D, T, Base, kRegA, Sh>(p, base, b, h, qt, n_kt);
  }
}

// ------------------------------------------------------------------- dk/dv

// The producer's one thread: K and V, then for each query head of the
// group its q tiles from i0 (Q, dO, lse, delta) into the ring.
template <int D>
__device__ __forceinline__ void dkv_producer(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tlse, const CUtensorMap& tdlt,
    const BwdParams& p, unsigned char* base, int b, int kvh, int kt, int i0,
    int n_qt) {
  using L = DkvSmem<D>;
  const int groups = p.H / p.KVH;
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * L::kRing, kvbar = full0 + 16 * L::kRing;
  mbar_expect_tx(kvbar, 2 * L::kRowsTile);
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c) {
    const int off = c * kBwdRows * 128;
    tma_load_4d(base + L::kK + off, &tk, kvbar, c * kBoxCols, kt * kBwdRows,
                kvh, b);
    tma_load_4d(base + L::kV + off, &tv, kvbar, c * kBoxCols, kt * kBwdRows,
                kvh, b);
  }
  int n = 0;
  for (int gi = 0; gi < groups; ++gi) {
    const int h = kvh * groups + gi;
    for (int i = i0; i < n_qt; ++i, ++n) {
      const int st = n % L::kRing;
      if (n >= L::kRing) mbar_wait(empty0 + 8 * st, (n / L::kRing - 1) & 1);
      const uint32_t full = full0 + 8 * st;
      mbar_expect_tx(full, 2 * L::kTile + 2 * L::kStat);
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c) {
        const int off = st * L::kTile + c * kBwdTile * 128;
        tma_load_4d(base + L::kQ + off, &tq, full, c * kBoxCols,
                    i * kBwdTile, h, b);
        tma_load_4d(base + L::kDO + off, &tdo, full, c * kBoxCols,
                    i * kBwdTile, h, b);
      }
      tma_load_2d(base + L::kLse + st * L::kStat, &tlse, full, i * kBwdTile,
                  b * p.H + h);
      tma_load_2d(base + L::kDelta + st * L::kStat, &tdlt, full,
                  i * kBwdTile, b * p.H + h);
    }
  }
}

// P^T = exp(sm * s^T - lse[q]) and dS^T = P^T * (dP^T - delta[q]) of one
// 64 (kv) x 64 (q) tile, into the A fragments of P^T dO and dS^T Q,
// rounded to T. MASK drops the causal pairs q < k.
template <class T, class Base, bool MASK>
__device__ __forceinline__ void dst_tile(const float (&s)[32],
                                         const float (&dp)[32],
                                         uint32_t (&pa)[kBwdTile / 16][4],
                                         uint32_t (&da)[kBwdTile / 16][4],
                                         const float* lse, const float* dlt,
                                         float sm, int krow0, int q_start) {
  const int t = threadIdx.x % 4;
  const float kDrop = -__int_as_float(0x7f800000);  // -inf: exp gives 0
#pragma unroll
  for (int i = 0; i < kBwdTile / 8; ++i) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse + i * 8 + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(dlt + i * 8 + 2 * t);
    float pr[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lv = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
      float x = fmaf(s[4 * i + e], sm, -lv);
      if (MASK && q_start + i * 8 + 2 * t + (e & 1) < krow0 + 8 * (e >> 1))
        x = kDrop;
      pr[e] = Base::exp(x);
      ds[e] = pr[e] * (dp[4 * i + e] - dl);
    }
    pa[i / 2][(i % 2) * 2] = T::pack(pr[0], pr[1]);
    pa[i / 2][(i % 2) * 2 + 1] = T::pack(pr[2], pr[3]);
    da[i / 2][(i % 2) * 2] = T::pack(ds[0], ds[1]);
    da[i / 2][(i % 2) * 2 + 1] = T::pack(ds[2], ds[3]);
  }
}

// A consumer warpgroup: dk and dv of its 64 kv rows over every q tile of
// the group's heads from its causal start, then the epilogue.
template <int D, class T, class Base>
__device__ __forceinline__ void dkv_consumer(const BwdParams& p,
                                             unsigned char* base, int b,
                                             int kvh, int kt, int i0,
                                             int n_qt) {
  using L = DkvSmem<D>;
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int k_start = kt * kBwdRows;
  const int R0 = cw * 64 + warp * 16 + lane / 4;  // and R0 + 8
  const int krow0 = k_start + R0;
  const int groups = p.H / p.KVH;
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * L::kRing, kvbar = full0 + 16 * L::kRing;
  const float sm = p.scale * Base::kScoreMul;
  // Causal: q tile i0 + cw is this consumer's diagonal, which it masks;
  // consumer 1 skips tile i0, wholly above its rows. Non-causal: every
  // tile, none masked (q rows past S add exactly 0).
  const int i_first = p.causal ? i0 + cw : 0;
  const int i_mask = p.causal ? i0 + cw : -1;

  // Descriptors: this consumer's K and V rows (A), stage 0's Q and dO (B,
  // K-major), and Q and dO again MN-major for dS^T Q and P^T dO.
  const uint64_t d_k = smem_desc(base + L::kK + cw * 64 * 128, 16, 1024);
  const uint64_t d_v = smem_desc(base + L::kV + cw * 64 * 128, 16, 1024);
  const uint64_t d_q = smem_desc(base + L::kQ, 16, 1024);
  const uint64_t d_do = smem_desc(base + L::kDO, 16, 1024);
  const uint64_t d_qmn = smem_desc(base + L::kQ, kBwdTile * 128, 1024);
  const uint64_t d_domn = smem_desc(base + L::kDO, kBwdTile * 128, 1024);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kvbar, 0);
  int n = 0;
  for (int gi = 0; gi < groups; ++gi) {
    for (int i = i0; i < n_qt; ++i, ++n) {
      const int st = n % L::kRing;
      mbar_wait(full0 + 8 * st, (n / L::kRing) & 1);
      if (i >= i_first) {
        const uint32_t tile = (st * L::kTile) >> 4;
        float s[32], dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
        wgmma_fence();
        mma_nt<D, T>(s, d_k, kBwdRows * 128, d_q + tile, kBwdTile * 128);
        mma_nt<D, T>(dp, d_v, kBwdRows * 128, d_do + tile, kBwdTile * 128);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);
        const float* lse =
            reinterpret_cast<const float*>(base + L::kLse + st * L::kStat);
        const float* dlt =
            reinterpret_cast<const float*>(base + L::kDelta + st * L::kStat);
        uint32_t pa[kBwdTile / 16][4], da[kBwdTile / 16][4];
        if (i == i_mask)
          dst_tile<T, Base, true>(s, dp, pa, da, lse, dlt, sm, krow0,
                                  i * kBwdTile);
        else
          dst_tile<T, Base, false>(s, dp, pa, da, lse, dlt, sm, krow0,
                                   i * kBwdTile);
        wgmma_fence();
        mma_rs<D, T>(dv, pa, d_domn + tile);
        mma_rs<D, T>(dk, da, d_qmn + tile);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
      }
      if (tid == 0) mbar_arrive(empty0 + 8 * st);  // Q, dO, lse, delta read
    }
  }

  // dk * scale and dv through this consumer's own rows of K and V (only
  // its own products read them).
  const long long off = ((long long)b * p.S * p.KVH + kvh) * D;
  const long long ss = (long long)p.KVH * D;
  const float dk_mul[2] = {p.scale, p.scale}, dv_mul[2] = {1.f, 1.f};
  store_rows<D, T>(dk, dk_mul, reinterpret_cast<e16*>(base + L::kK),
                   p.dk + off, ss, k_start, p.S);
  store_rows<D, T>(dv, dv_mul, reinterpret_cast<e16*>(base + L::kV),
                   p.dv + off, ss, k_start, p.S);
}

// P^T = exp(sm * s^T - lse[q]) of one 64 (kv) x 64 (q) tile into the A
// fragments of P^T dO, rounded to T (dst_tile without dS^T: dkv_cta_wide's
// dv consumer). MASK drops the causal pairs q < k.
template <class T, class Base, bool MASK>
__device__ __forceinline__ void pt_tile(const float (&s)[32],
                                        uint32_t (&pa)[kBwdTile / 16][4],
                                        const float* lse, float sm,
                                        int krow0, int q_start) {
  const int t = threadIdx.x % 4;
  const float kDrop = -__int_as_float(0x7f800000);  // -inf: exp gives 0
#pragma unroll
  for (int i = 0; i < kBwdTile / 8; ++i) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse + i * 8 + 2 * t);
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fmaf(s[4 * i + e], sm, (e & 1) ? -l2.y : -l2.x);
      if (MASK && q_start + i * 8 + 2 * t + (e & 1) < krow0 + 8 * (e >> 1))
        x = kDrop;
      pr[e] = Base::exp(x);
    }
    pa[i / 2][(i % 2) * 2] = T::pack(pr[0], pr[1]);
    pa[i / 2][(i % 2) * 2 + 1] = T::pack(pr[2], pr[3]);
  }
}

// One CTA of dk/dv: work item blockIdx.x is (b * KVH + kvh, 128-row kv
// tile).
template <int D, class T, class Base>
__device__ __forceinline__ void dkv_cta(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tlse, const CUtensorMap& tdlt,
    const BwdParams& p, const int* __restrict__ work, unsigned char* smem) {
  static_assert(Base::kLseMul == 1.f, "dk/dv reads lse as the base's own");
  using L = DkvSmem<D>;
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const int bkv = work[2 * blockIdx.x], kt = work[2 * blockIdx.x + 1];
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  const int n_qt = ceil_div(p.S, kBwdTile);
  // Causal: q tiles from the kv tile's first row (i0 < n_qt: kt's rows
  // start before S).
  const int i0 = p.causal ? kt * (kBwdRows / kBwdTile) : 0;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(base + L::kBar);
    for (int i = 0; i < L::kRing; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (L::kRing + i), kConsumers);
    }
    mbar_init(bars + 16 * L::kRing, 1);  // K and V
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      dkv_producer<D>(tq, tdo, tk, tv, tlse, tdlt, p, base, b, kvh, kt, i0,
                      n_qt);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dkv_consumer<D, T, Base>(p, base, b, kvh, kt, i0, n_qt);
  }
}

// ------------------------------------------------- dk/dv at head_dim 256

// dkv_cta_wide's shared memory: K and V (kWideRows x D); kRing Q and dO
// tiles (kBwdTile x D); kRing lse and delta rows; two last-arrival flags
// (dv, dk); mbarriers full, empty, kv. 193 KB at D = 256.
template <int D>
struct DkvWideSmem {
  static constexpr int kRing = kBwdRing;
  static constexpr int kTile = kBwdTile * D * 2;
  static constexpr int kRowsTile = kWideRows * D * 2;
  static constexpr int kStat = kBwdTile * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kRowsTile;
  static constexpr int kQ = 2 * kRowsTile;
  static constexpr int kDO = kQ + kRing * kTile;
  static constexpr int kLse = kDO + kRing * kTile;
  static constexpr int kDelta = kLse + kRing * kStat;
  static constexpr int kFlag = kDelta + kRing * kStat;
  static constexpr int kBar = kFlag + 16;
  static constexpr int kBytes = kBar + (2 * kRing + 1) * 8 + 1024;
};

// The producer's one thread: K and V (kWideRows), then for each of the
// item's `heads` query heads from h0 its q tiles from i0 (Q, dO, lse,
// delta) into the two-stage ring, each tile once for both consumers.
template <int D>
__device__ __forceinline__ void dkv_wide_producer(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tlse, const CUtensorMap& tdlt,
    const BwdParams& p, unsigned char* base, int b, int kvh, int kt, int h0,
    int heads, int i0, int n_qt) {
  using L = DkvWideSmem<D>;
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * L::kRing, kvbar = full0 + 16 * L::kRing;
  mbar_expect_tx(kvbar, 2 * L::kRowsTile);
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c) {
    const int off = c * kWideRows * 128;
    tma_load_4d(base + L::kK + off, &tk, kvbar, c * kBoxCols, kt * kWideRows,
                kvh, b);
    tma_load_4d(base + L::kV + off, &tv, kvbar, c * kBoxCols, kt * kWideRows,
                kvh, b);
  }
  int n = 0;
  for (int h = h0; h < h0 + heads; ++h) {
    for (int i = i0; i < n_qt; ++i, ++n) {
      const int st = n % L::kRing;
      if (n >= L::kRing) mbar_wait(empty0 + 8 * st, (n / L::kRing - 1) & 1);
      const uint32_t full = full0 + 8 * st;
      mbar_expect_tx(full, 2 * L::kTile + 2 * L::kStat);
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c) {
        const int off = st * L::kTile + c * kBwdTile * 128;
        tma_load_4d(base + L::kQ + off, &tq, full, c * kBoxCols,
                    i * kBwdTile, h, b);
        tma_load_4d(base + L::kDO + off, &tdo, full, c * kBoxCols,
                    i * kBwdTile, h, b);
      }
      tma_load_2d(base + L::kLse + st * L::kStat, &tlse, full, i * kBwdTile,
                  b * p.H + h);
      tma_load_2d(base + L::kDelta + st * L::kStat, &tdlt, full,
                  i * kBwdTile, b * p.H + h);
    }
  }
}

// One consumer of dkv_cta_wide over the item's q tiles: kDk false is
// consumer 0, S^T = K Q^T, P^T and acc = dv += P^T dO; kDk true is
// consumer 1, S^T and dP^T = V dO^T, dS^T and acc = dk += dS^T Q (dk
// unscaled). Both hold the CTA's kWideRows kv rows (this warp's 16 at
// krow0, krow0 + 8) and read every stage; causal, both mask q tile i0
// (the diagonal: kt) and skip none.
template <int D, class T, class Base, bool kDk>
__device__ __forceinline__ void dkv_wide_consumer(float (&acc)[D / 2],
                                                  const BwdParams& p,
                                                  unsigned char* base,
                                                  int kt, int heads, int i0,
                                                  int n_qt) {
  using L = DkvWideSmem<D>;
  const int tid = threadIdx.x % 128;
  const int krow0 = kt * kWideRows + (tid / 32) * 16 + (tid % 32) / 4;
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * L::kRing, kvbar = full0 + 16 * L::kRing;
  const float sm = p.scale * Base::kScoreMul;
  const int i_mask = p.causal ? i0 : -1;
  const uint64_t d_k = smem_desc(base + L::kK, 16, 1024);
  const uint64_t d_v = smem_desc(base + L::kV, 16, 1024);
  const uint64_t d_q = smem_desc(base + L::kQ, 16, 1024);
  const uint64_t d_do = smem_desc(base + L::kDO, 16, 1024);
  // dk += dS^T Q reads Q MN-major, dv += P^T dO reads dO so.
  const uint64_t d_bmn = smem_desc(base + (kDk ? L::kQ : L::kDO),
                                   kBwdTile * 128, 1024);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(kvbar, 0);
  int n = 0;
  for (int g = 0; g < heads; ++g) {
    for (int i = i0; i < n_qt; ++i, ++n) {
      const int st = n % L::kRing;
      mbar_wait(full0 + 8 * st, (n / L::kRing) & 1);
      const uint32_t tile = (st * L::kTile) >> 4;
      const float* lse =
          reinterpret_cast<const float*>(base + L::kLse + st * L::kStat);
      const float* dlt =
          reinterpret_cast<const float*>(base + L::kDelta + st * L::kStat);
      float s[32];
      uint32_t a[kBwdTile / 16][4];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
      if constexpr (kDk) {
        float dp[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) dp[e] = 0.f;
        wgmma_fence();
        mma_nt<D, T>(s, d_k, kWideRows * 128, d_q + tile, kBwdTile * 128);
        mma_nt<D, T>(dp, d_v, kWideRows * 128, d_do + tile, kBwdTile * 128);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);
        // P^T, packed beside dS^T, is not read: dead code for ptxas.
        uint32_t unused[kBwdTile / 16][4];
        if (i == i_mask)
          dst_tile<T, Base, true>(s, dp, unused, a, lse, dlt, sm, krow0,
                                  i * kBwdTile);
        else
          dst_tile<T, Base, false>(s, dp, unused, a, lse, dlt, sm, krow0,
                                   i * kBwdTile);
      } else {
        wgmma_fence();
        mma_nt<D, T>(s, d_k, kWideRows * 128, d_q + tile, kBwdTile * 128);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        if (i == i_mask)
          pt_tile<T, Base, true>(s, a, lse, sm, krow0, i * kBwdTile);
        else
          pt_tile<T, Base, false>(s, a, lse, sm, krow0, i * kBwdTile);
      }
      wgmma_fence();
      mma_rs<D, T>(acc, a, d_bmn + tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(empty0 + 8 * st);  // Q, dO, lse, delta read
    }
  }
}

// A consumer's accumulator (its rows row_start + (tid / 32) * 16 + (tid %
// 32) / 4, + 8) times mul, straight to global memory at g (row stride
// ss, rows < S): rounded to T in 4-byte stores, or, kF32, as fp32 pairs
// in 8-byte stores.
template <int D, class T, bool kF32>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 2],
                                          float mul, void* g, long long ss,
                                          int row_start, int S) {
  const int tid = threadIdx.x % 128;
  const int t = tid % 4, R0 = (tid / 32) * 16 + (tid % 32) / 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_start + R0 + 8 * hf;
    if (row < S) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float x = acc[4 * i + 2 * hf] * mul;
        const float y = acc[4 * i + 2 * hf + 1] * mul;
        const long long at = row * ss + 8 * i + 2 * t;
        if constexpr (kF32)
          *reinterpret_cast<float2*>(static_cast<float*>(g) + at) =
              make_float2(x, y);
        else
          *reinterpret_cast<uint32_t*>(static_cast<e16*>(g) + at) =
              T::pack(x, y);
      }
    }
  }
}

// The last item of a kv tile to arrive, one consumer's 128 threads: out =
// mul * (part 0 + part 1 + ... + part P - 1), in that order, rounded to T,
// rows < S. Every part (its own too) is read from ws (part stride
// `plane`) through L2 in 16-byte chunks, row-major, each thread's up to
// kMaxParts loads of a chunk issued before its sums.
template <int D, class T>
__device__ __forceinline__ void sum_parts(float mul,
                                          const float* __restrict__ ws,
                                          long long plane, int parts,
                                          e16* __restrict__ g, long long ss,
                                          int row_start, int S) {
  constexpr int kRowChunks = D / 4;
#pragma unroll 2
  for (int c = threadIdx.x % 128; c < kWideRows * kRowChunks; c += 128) {
    const int row = row_start + c / kRowChunks;
    if (row < S) {
      const long long at = row * ss + (c % kRowChunks) * 4;
      float4 x[kMaxParts];
#pragma unroll
      for (int pp = 0; pp < kMaxParts; ++pp)
        if (pp < parts)
          x[pp] = __ldcg(reinterpret_cast<const float4*>(ws + pp * plane +
                                                         at));
      float4 s = x[0];
#pragma unroll
      for (int pp = 1; pp < kMaxParts; ++pp) {
        if (pp < parts) {
          s.x += x[pp].x;
          s.y += x[pp].y;
          s.z += x[pp].z;
          s.w += x[pp].w;
        }
      }
      *reinterpret_cast<uint2*>(g + at) =
          make_uint2(T::pack(s.x * mul, s.y * mul),
                     T::pack(s.z * mul, s.w * mul));
    }
  }
}

// A consumer's epilogue (which: 0 dv, 1 dk): P = 1 writes out (the
// (b, kvh) plane at row 0) in T; P > 1 writes this part's fp32 partial,
// takes the kv tile's ticket and, last to arrive, sums the parts into out.
template <int D, class T>
__device__ __forceinline__ void dkv_wide_store(
    const float (&acc)[D / 2], float mul, e16* out, const BwdParams& p,
    const DkvSplit& split, unsigned char* base, int which, long long off,
    int bkv, int kt, int part) {
  const long long ss = (long long)p.KVH * D;
  const int row0 = kt * kWideRows;
  if (split.parts == 1) {
    store_acc<D, T, false>(acc, mul, out + off, ss, row0, p.S);
    return;
  }
  const long long plane = (long long)split.batch * p.S * ss;
  float* ws = split.ws + which * split.parts * plane + off;
  store_acc<D, T, true>(acc, 1.f, ws + part * plane, ss, row0, p.S);
  __threadfence();
  warpgroup_sync(1 + which);
  volatile int* last =
      reinterpret_cast<int*>(base + DkvWideSmem<D>::kFlag) + which;
  if (threadIdx.x % 128 == 0) {
    const int tile = bkv * ceil_div(p.S, kWideRows) + kt;
    *last = atomicAdd(split.tickets + 2 * tile + which, 1) ==
            split.parts - 1;
  }
  warpgroup_sync(1 + which);
  if (*last) {
    __threadfence();
    sum_parts<D, T>(mul, ws, plane, split.parts, out + off, ss, row0, p.S);
  }
}

// One CTA of the head_dim-256 dk/dv of the triangular and streamed
// families: work item blockIdx.x is (b * KVH + kvh, kWideRows-row kv tile,
// part of the GQA group).
template <int D, class T, class Base>
__device__ __forceinline__ void dkv_cta_wide(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tlse, const CUtensorMap& tdlt,
    const BwdParams& p, const int* __restrict__ work, const DkvSplit& split,
    unsigned char* smem) {
  static_assert(Base::kLseMul == 1.f, "dk/dv reads lse as the base's own");
  using L = DkvWideSmem<D>;
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const int* item = work + 3 * blockIdx.x;
  const int bkv = item[0], kt = item[1], part = item[2];
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  const int heads = p.H / p.KVH / split.parts;
  const int h0 = kvh * (p.H / p.KVH) + part * heads;
  const int n_qt = ceil_div(p.S, kBwdTile);
  // Causal: q tiles from the diagonal one, kt (kt's rows start before S).
  const int i0 = p.causal ? kt : 0;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(base + L::kBar);
    for (int i = 0; i < L::kRing; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (L::kRing + i), kConsumers);
    }
    mbar_init(bars + 16 * L::kRing, 1);  // K and V
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      dkv_wide_producer<D>(tq, tdo, tk, tv, tlse, tdlt, p, base, b, kvh, kt,
                           h0, heads, i0, n_qt);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const long long off = ((long long)b * p.S * p.KVH + kvh) * D;
  float acc[D / 2];
  if (threadIdx.x < 256) {
    dkv_wide_consumer<D, T, Base, false>(acc, p, base, kt, heads, i0, n_qt);
    dkv_wide_store<D, T>(acc, 1.f, p.dv, p, split, base, 0, off, bkv, kt,
                         part);
  } else {
    dkv_wide_consumer<D, T, Base, true>(acc, p, base, kt, heads, i0, n_qt);
    dkv_wide_store<D, T>(acc, p.scale, p.dk, p, split, base, 1, off, bkv,
                         kt, part);
  }
}

// ------------------------------------------------ dq and dk/dv at head_dim 512

// 16-byte chunk ch of row R of a kRows-row tile stored as TMA's 128-byte
// swizzle left it (D / 64 boxes of kRows x 128 bytes), in elements: swz
// for tiles of other than kBM rows.
template <int kRows>
__device__ __forceinline__ int swz_rows(int R, int ch) {
  return (ch / 8) * kRows * kBoxCols + R * kBoxCols + ((ch % 8) ^ (R % 8)) * 8;
}

// The dq cluster at head_dim 512: two CTAs an item of kDq512Rows q rows,
// CTA c (its rank) holding chunk c of Q and dO (kDq512Rows x kChunk, 32 KB
// each); kDq512KSlots stages of chunk c of a kKv512-row K tile and
// kDq512VSlots of V (32 KB each), on barriers of their own (K_j is read
// from tile j - 1's partial of S to tile j's dS K: three stages keep K_{j
// + 2}'s load in flight meanwhile); the exchange (the other CTA's
// partials of S, then dP: m64 x kKv512 fp32 fragments each); the two
// chunks' partials of delta; mbarriers k_full[KS], k_empty[KS],
// v_full[VS], v_empty[VS], q, delta, x_full[2] (S's, dP's), x_free.
// 231,016 B.
constexpr int kDq512Rows = 64;
constexpr int kDq512KSlots = 3;
constexpr int kDq512VSlots = 1;
template <int D>
struct DqSmem512 {
  static constexpr int kKS = kDq512KSlots, kVS = kDq512VSlots;
  static constexpr int kRowsTile = kDq512Rows * kChunk * 2;
  static constexpr int kTile = kKv512 * kChunk * 2;
  static constexpr int kPart = 64 * kKv512 * 4;
  static constexpr int kQ = 0;
  static constexpr int kDO = kRowsTile;
  static constexpr int kK = 2 * kRowsTile;
  static constexpr int kV = kK + kKS * kTile;
  static constexpr int kXch = kV + kVS * kTile;
  static constexpr int kDelta = kXch + 2 * kPart;
  static constexpr int kBar = kDelta + 2 * kDq512Rows * 4;
  static constexpr int kKFull = 0, kKEmpty = 8 * kKS, kVFull = 16 * kKS;
  static constexpr int kVEmpty = kVFull + 8 * kVS, kQBar = kVEmpty + 8 * kVS;
  static constexpr int kDlt = kQBar + 8, kXFull = kDlt + 8;
  static constexpr int kXFree = kXFull + 16;
  static constexpr int kBytes = kBar + kXFree + 8 + 1024;
  static_assert(D == 2 * kChunk, "a chunk a CTA of the cluster");
  static_assert(kDq512Rows == kKv512, "a q tile's loop ends at its index");
  static_assert(kBytes <= kMaxSmem, "past the 227 KB a block may use");
};

// Both consumer warpgroups (named barrier 3; 1 and 2 are each one's own).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" : : : "memory");
}

// The producer's one thread of the dq CTA of rank `chunk` (shared memory
// L: DqSmem512, or dq_cta_x's DqSmemX): its chunk of Q and dO, then of K_j
// into its stage (once K_{j - KS} is released by both consumers) and of
// V_j into its (once V_{j - VS} is, by consumer 1).
template <int D, class L = DqSmem512<D>>
__device__ __forceinline__ void dq_producer_512(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const BwdParams& p, unsigned char* base, int b,
    int h, int qt, int n_kt, int chunk) {
  constexpr int kBoxes = kChunk / kBoxCols;
  const int kvh = h / (p.H / p.KVH), col0 = chunk * kChunk;
  const uint32_t bars = smem_addr(base + L::kBar);
  const uint32_t qbar = bars + L::kQBar;
  mbar_expect_tx(qbar, 2 * L::kRowsTile);
#pragma unroll
  for (int c = 0; c < kBoxes; ++c) {
    const int off = c * kDq512Rows * 128;
    tma_load_4d(base + L::kQ + off, &tq, qbar, col0 + c * kBoxCols,
                qt * kDq512Rows, h, b);
    tma_load_4d(base + L::kDO + off, &tdo, qbar, col0 + c * kBoxCols,
                qt * kDq512Rows, h, b);
  }
  for (int j = 0; j < n_kt; ++j) {
    const int ks = j % L::kKS, vs = j % L::kVS;
    if (j >= L::kKS)
      mbar_wait(bars + L::kKEmpty + 8 * ks, (j / L::kKS - 1) & 1);
    mbar_expect_tx(bars + L::kKFull + 8 * ks, L::kTile);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
      tma_load_4d(base + L::kK + ks * L::kTile + c * kKv512 * 128, &tk,
                  bars + L::kKFull + 8 * ks, col0 + c * kBoxCols,
                  j * kKv512, kvh, b);
    if (j >= L::kVS)
      mbar_wait(bars + L::kVEmpty + 8 * vs, (j / L::kVS - 1) & 1);
    mbar_expect_tx(bars + L::kVFull + 8 * vs, L::kTile);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
      tma_load_4d(base + L::kV + vs * L::kTile + c * kKv512 * 128, &tv,
                  bars + L::kVFull + 8 * vs, col0 + c * kBoxCols,
                  j * kKv512, kvh, b);
  }
}

// One consumer warpgroup of the width-512 dq's CTA of rank `chunk` (kDp
// false: consumer 0, S; true: consumer 1, dP), on the item's 64 q rows.
// delta = rowsum(dO * O), once the first partial is sent: each consumer
// takes 32 rows of its CTA's chunk (four threads a row, O from global
// memory, dO from its tile), keeps the partial and sends it to the other
// CTA (st.async onto its delta barrier); delta = part 0 + part 1 in both.
// Per K/V tile j:
// consumer 0's partial S_c = Q_c K_c^T, consumer 1's dP_c = dO_c V_c^T
// (m64n64, 256 deep), each sent to its counterpart in the other CTA, which
// sends its own here (x_full); each adds the one received to its own and
// writes the sum back in place, and after both consumers have
// (consumers_sync) reads the other's: both hold S_j and dP_j, bit-equal in
// both CTAs, and arrive on the other CTA's x_free (its writers send the
// next partials only after that). Each forms dS = P (dP - delta) and runs
// its 128-column half of dq_c += dS K_c (m64n128k16, K_c read MN-major from
// the half's two boxes). The exchange runs a tile ahead: the partial of
// tile j + 1 is computed before tile j's is awaited and sent after it, so
// each crosses to the other CTA under this one's products, and no wait
// falls between a product's issue and its wait. Causal, the loop ends on
// the diagonal tile, which both mask. dq (64), the two kinds of tile j
// and this consumer's of tile j + 1 (32 each) and dS (16) a thread (Q_c or
// dO_c held in registers too, 64 more, spills and ran 1.1-1.3 times
// slower: PERF.md).
template <int D, class T, class Base, bool kDp>
__device__ __forceinline__ void dq_consumer_512(const BwdParams& p,
                                                unsigned char* base, int b,
                                                int h, int qt, int n_kt,
                                                uint32_t chunk) {
  using L = DqSmem512<D>;
  constexpr int kF = kKv512 / 2, kPartF = L::kPart / 4, kHalf = kChunk / 2;
  constexpr int kW = kDp ? 1 : 0;
  const int tid = threadIdx.x % 128;
  const int R0 = (tid / 32) * 16 + (tid % 32) / 4;  // and R0 + 8
  const int q_start = qt * kDq512Rows, row0 = q_start + R0;
  const uint32_t bars = smem_addr(base + L::kBar);
  const uint32_t other = chunk ^ 1;
  const float sm = p.scale * Base::kScoreMul;
  const TileMask mask = {p.S, p.causal};
  const long long stat = ((long long)b * p.H + h) * p.S;
  const int j_mask = p.causal ? qt : masked_tile(0, p.S, kKv512, n_kt);
  float lse_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    lse_r[hf] = row0 + 8 * hf < p.S
                    ? p.lse[stat + row0 + 8 * hf] * Base::kLseMul
                    : 0.f;

  // This consumer's A (Q_c or dO_c) and B (K_c or V_c) K-major, and its
  // half of K_c MN-major for dS K.
  const uint64_t d_a = smem_desc(base + (kDp ? L::kDO : L::kQ), 16, 1024);
  const uint64_t d_b = smem_desc(base + (kDp ? L::kV : L::kK), 16, 1024);
  const uint64_t d_kmn =
      smem_desc(base + L::kK + kW * (kHalf / kBoxCols) * kKv512 * 128,
                kKv512 * 128, 1024);
  // delta's partial over this CTA's chunk (rows 32 kW .. + 31, 0 past
  // S) goes to the other CTA after the first partial of S or dP: its
  // loads of O run while that partial crosses.
  float* sDelta = reinterpret_cast<float*>(base + L::kDelta);
  const uint32_t dlt_bar = bars + L::kDlt;
  mbar_expect_tx_if(dlt_bar, kDq512Rows * 4, !kDp && tid == 0);
  mbar_wait(bars + L::kQBar, 0);
  // The exchange: this consumer's kind (S or dP) as the other CTA sent
  // it, and the other consumer's.
  float* x_mine = reinterpret_cast<float*>(base + L::kXch) + kW * kPartF;
  const float* x_theirs =
      reinterpret_cast<const float*>(base + L::kXch) + (1 - kW) * kPartF;
  const uint32_t x_full = bars + L::kXFull + 8 * kW;
  const uint32_t x_free = bars + L::kXFree;
  const uint32_t x_dst = map_rank(smem_addr(x_mine), other);
  const uint32_t x_bar = map_rank(x_full, other);
  // This CTA's partial of this consumer's kind of tile j into x (K_j or
  // V_j waited for; V_j released after it).
  auto partial = [&](float (&x)[kF], int j) {
    const int slot = kDp ? j % L::kVS : j % L::kKS;
    const int ring = kDp ? L::kVS : L::kKS;
    mbar_wait(bars + (kDp ? L::kVFull : L::kKFull) + 8 * slot,
              (j / ring) & 1);
    const uint32_t tile = (slot * L::kTile) >> 4;
#pragma unroll
    for (int i = 0; i < kF; ++i) x[i] = 0.f;
    wgmma_fence();
    mma_nt<kChunk, T>(x, d_a, kDq512Rows * 128, d_b + tile, kKv512 * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);
    if constexpr (kDp) mbar_arrive_if(bars + L::kVEmpty + 8 * slot, tid == 0);
  };

  float acc[kHalf / 2];
#pragma unroll
  for (int i = 0; i < kHalf / 2; ++i) acc[i] = 0.f;
  float x[kF], xn[kF], y[kF];
  mbar_expect_tx_if(x_full, L::kPart, tid == 0);
  partial(x, 0);
  send_part(x, x_dst, x_bar);
  {
    const e16* sdO = reinterpret_cast<const e16*>(base + L::kDO);
    const int R = kW * 32 + tid / 4, quarter = tid % 4, row = q_start + R;
    float sum = 0.f;
    if (row < p.S) {
      const e16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss +
                        chunk * kChunk;
#pragma unroll
      for (int c = 0; c < kChunk / 32; ++c) {
        const int ch = quarter * (kChunk / 32) + c;
        sum += dot8<T>(*reinterpret_cast<const uint4*>(orow + ch * 8),
                       *reinterpret_cast<const uint4*>(
                           sdO + swz_rows<kDq512Rows>(R, ch)));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (quarter == 0) {
      float* at = sDelta + chunk * kDq512Rows + R;
      *at = sum;
      st_async(map_rank(smem_addr(at), other), sum,
               map_rank(dlt_bar, other));
    }
  }
  consumers_sync();
  mbar_wait_cluster(dlt_bar, 0);
  float dlt_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    dlt_r[hf] = sDelta[R0 + 8 * hf] + sDelta[kDq512Rows + R0 + 8 * hf];
  if (chunk == 0 && !kDp && tid % 4 == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (row0 + 8 * hf < p.S) p.delta[stat + row0 + 8 * hf] = dlt_r[hf];
  }

  for (int j = 0; j < n_kt; ++j) {
    const bool more = j + 1 < n_kt;
    if (more) partial(xn, j + 1);
    // x = this CTA's partial + the other's, written back for the other
    // consumer; y = the other consumer's sum.
    mbar_wait_cluster(x_full, j & 1);
#pragma unroll
    for (int e4 = 0; e4 < kF / 4; ++e4) {
      float4* at = reinterpret_cast<float4*>(x_mine + 4 * (e4 * 128 + tid));
      const float4 r = *at;
      x[4 * e4] += r.x;
      x[4 * e4 + 1] += r.y;
      x[4 * e4 + 2] += r.z;
      x[4 * e4 + 3] += r.w;
      *at = make_float4(x[4 * e4], x[4 * e4 + 1], x[4 * e4 + 2],
                        x[4 * e4 + 3]);
    }
    mbar_expect_tx_if(x_full, L::kPart, more && tid == 0);
    consumers_sync();
#pragma unroll
    for (int e4 = 0; e4 < kF / 4; ++e4) {
      const float4 r =
          *reinterpret_cast<const float4*>(x_theirs + 4 * (e4 * 128 + tid));
      y[4 * e4] = r.x;
      y[4 * e4 + 1] = r.y;
      y[4 * e4 + 2] = r.z;
      y[4 * e4 + 3] = r.w;
    }
    // Both of this CTA's buffers read here: free for the other CTA.
    warpgroup_sync(1 + kW);
    mbar_arrive_remote_if(map_rank(x_free, other), tid == 0);
    if (more) {
      mbar_wait(x_free, j & 1);
      send_part(xn, x_dst, x_bar);
    }
    const int ks = j % L::kKS;
    if constexpr (kDp) mbar_wait(bars + L::kKFull + 8 * ks, (j / L::kKS) & 1);
    uint32_t da[kKv512 / 16][4];
    const float(&s)[kF] = kDp ? y : x;
    const float(&dp)[kF] = kDp ? x : y;
    if (j == j_mask)
      ds_tile<T, Base, true, kKv512>(s, dp, da, sm, lse_r, dlt_r, row0,
                                     j * kKv512, mask);
    else
      ds_tile<T, Base, false, kKv512>(s, dp, da, sm, lse_r, dlt_r, row0,
                                      j * kKv512, mask);
    wgmma_fence();
    mma_rs<kHalf, T, kKv512>(acc, da, d_kmn + ((ks * L::kTile) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive_if(bars + L::kKEmpty + 8 * ks, tid == 0);  // K_j read
#pragma unroll
    for (int i = 0; i < kF; ++i) x[i] = xn[i];
  }
  store_acc<kHalf, T, false>(
      acc, p.scale,
      p.dq + ((long long)b * p.S * p.H + h) * D + chunk * kChunk + kW * kHalf,
      (long long)p.H * D, q_start, p.S);
}

// One CTA of the width-512 dq, launched in clusters of C = out_chunks
// CTAs: block i is rank i % C, chunk i % C of work item i / C, (b * H +
// h, kDq512Rows-row q tile).
template <int D, class T, class Base>
__device__ __forceinline__ void dq_cta_512(const CUtensorMap& tq,
                                           const CUtensorMap& tdo,
                                           const CUtensorMap& tk,
                                           const CUtensorMap& tv,
                                           const BwdParams& p,
                                           const int* __restrict__ work,
                                           unsigned char* smem) {
  using L = DqSmem512<D>;
  constexpr int kC = out_chunks<D>();
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const uint32_t chunk = cluster_rank();
  const int item = blockIdx.x / kC;
  const int bh = work[2 * item], qt = work[2 * item + 1];
  const int b = bh / p.H, h = bh % p.H;
  const int n_all = ceil_div(p.S, kKv512);
  const int n_kt = p.causal ? min(n_all, qt + 1) : n_all;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(base + L::kBar);
    for (int i = 0; i < L::kKS; ++i) {
      mbar_init(bars + L::kKFull + 8 * i, 1);
      mbar_init(bars + L::kKEmpty + 8 * i, kConsumers);
    }
    for (int i = 0; i < L::kVS; ++i) {
      mbar_init(bars + L::kVFull + 8 * i, 1);
      mbar_init(bars + L::kVEmpty + 8 * i, 1);  // consumer 1's dP
    }
    mbar_init(bars + L::kQBar, 1);
    // delta: consumer 0's expect_tx (the other CTA's bytes); x_full: each
    // consumer's; x_free: both consumers of the other CTA.
    mbar_init(bars + L::kDlt, 1);
    mbar_init(bars + L::kXFull, 1);
    mbar_init(bars + L::kXFull + 8, 1);
    mbar_init(bars + L::kXFree, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  // Every barrier of both CTAs is initialised before any remote arrival.
  cluster_sync();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      dq_producer_512<D>(tq, tdo, tk, tv, p, base, b, h, qt, n_kt, chunk);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    if (threadIdx.x < 256)
      dq_consumer_512<D, T, Base, false>(p, base, b, h, qt, n_kt, chunk);
    else
      dq_consumer_512<D, T, Base, true>(p, base, b, h, qt, n_kt, chunk);
  }
  // Neither CTA leaves while the other may still write its shared memory
  // or arrive on its barriers.
  cluster_sync();
}

// The resident family's dq at head_dim 512 (flash_bwd.cu), the body of
// the width-512 dq before the cluster (dq_cta_512): at the resident main
// shape, Gemma-7B-like items of 64 q rows in 8 x 1024, two CTAs an item
// each paying the prologue (Q, dO, the first K/V tiles, delta and its
// exchange) measured 1.11 times slower than this one CTA an item, which
// keeps it (tools/flash_dq_variants.py --width 512; PERF.md). kDq512Rows q
// rows of Q and dO (64 KB each), held by both consumers, consumer c
// computing dq's chunk c, S and dP recomputed by each over all 512
// columns (1.67 times dq's minimal FLOPs); K tiles of kDqChunkedKv rows in
// kDqChunkedKSlots stages and V tiles in one, each on barriers of their
// own (DqSplitKV's ring at half the rows and twice the width); delta of
// the rows once per consumer; mbarriers full[3], empty[3] (K's stages,
// then V's), q. 230,968 B.
constexpr int kDqChunkedKv = 32;
constexpr int kDqChunkedKSlots = 2;
template <int D>
struct DqSmemChunked512 {
  static constexpr int kRowsTile = kDq512Rows * D * 2;
  static constexpr int kTile = kDqChunkedKv * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kRowsTile;
  static constexpr int kK = 2 * kRowsTile;
  static constexpr int kV = kK + kDqChunkedKSlots * kTile;
  static constexpr int kDelta = kV + kTile;
  static constexpr int kBars = kDqChunkedKSlots + 1;
  static constexpr int kBar = kDelta + kConsumers * kDq512Rows * 4;
  static constexpr int kBytes = kBar + (2 * kBars + 1) * 8 + 1024;
  static_assert(kBytes <= kMaxSmem, "past the 227 KB a block may use");
};

// The producer's one thread: Q and dO, then K_j into its stage (once K_{j
// - 2} is released) and V_j into the one V stage (once V_{j - 1} is: after
// both consumers' dP).
template <int D>
__device__ __forceinline__ void dq_producer_chunked_512(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const BwdParams& p, unsigned char* base, int b,
    int h, int qt, int n_kt) {
  using L = DqSmemChunked512<D>;
  const int kvh = h / (p.H / p.KVH);
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * L::kBars;
  const uint32_t qbar = full0 + 16 * L::kBars;
  const uint32_t vbar = 8 * kDqChunkedKSlots;
  mbar_expect_tx(qbar, 2 * L::kRowsTile);
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c) {
    const int off = c * kDq512Rows * 128;
    tma_load_4d(base + L::kQ + off, &tq, qbar, c * kBoxCols,
                qt * kDq512Rows, h, b);
    tma_load_4d(base + L::kDO + off, &tdo, qbar, c * kBoxCols,
                qt * kDq512Rows, h, b);
  }
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kDqChunkedKSlots;
    if (j >= kDqChunkedKSlots)
      mbar_wait(empty0 + 8 * st, (j / kDqChunkedKSlots - 1) & 1);
    mbar_expect_tx(full0 + 8 * st, L::kTile);
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c)
      tma_load_4d(base + L::kK + st * L::kTile + c * kDqChunkedKv * 128, &tk,
                  full0 + 8 * st, c * kBoxCols, j * kDqChunkedKv, kvh, b);
    if (j >= 1) mbar_wait(empty0 + vbar, (j - 1) & 1);
    mbar_expect_tx(full0 + vbar, L::kTile);
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c)
      tma_load_4d(base + L::kV + c * kDqChunkedKv * 128, &tv, full0 + vbar,
                  c * kBoxCols, j * kDqChunkedKv, kvh, b);
  }
}

// A consumer warpgroup of the width-512 dq: chunk cw (its warpgroup index,
// taken from lane 0 so the descriptors derived from it sit in uniform
// registers) of dq for the CTA's 64 q rows. Each consumer computes delta
// of the rows (consumer 0 writes it), then per K/V tile S = Q K^T and dP =
// dO V^T over all D columns as m64n32 (both operands from shared memory),
// releases V, dS, and dq_cw += dS K[:, chunk] (two m64n256k16, K read
// MN-major from its chunk's boxes), and releases K. Causal, both consumers
// own the same rows: the loop ends on the CTA's last diagonal tile and
// masks the two diagonal ones. dq (128), S and dP (16 each) and dS (8) a
// thread.
template <int D, class T, class Base>
__device__ __forceinline__ void dq_consumer_chunked_512(const BwdParams& p,
                                                unsigned char* base, int b,
                                                int h, int qt, int n_kt) {
  using L = DqSmemChunked512<D>;
  constexpr int kKv = kDqChunkedKv;
  const int cw = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128 - 1, 0);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int q_start = qt * kDq512Rows;
  const int R0 = warp * 16 + lane / 4;  // and R0 + 8
  const int row0 = q_start + R0;
  const uint32_t full0 = smem_addr(base + L::kBar);
  const uint32_t empty0 = full0 + 8 * L::kBars;
  const uint32_t qbar = full0 + 16 * L::kBars;
  const uint32_t vbar = 8 * kDqChunkedKSlots;
  const float sm = p.scale * Base::kScoreMul;
  const TileMask mask = {p.S, p.causal};
  const long long stat = ((long long)b * p.H + h) * p.S;
  const int j_mask =
      p.causal ? qt * (kDq512Rows / kKv) : masked_tile(0, p.S, kKv, n_kt);
  float lse_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    lse_r[hf] = row0 + 8 * hf < p.S
                    ? p.lse[stat + row0 + 8 * hf] * Base::kLseMul
                    : 0.f;

  // delta = rowsum(dO * O): two threads a row, O from global memory, dO
  // from the swizzled tile; 0 past S.
  mbar_wait(qbar, 0);
  float* sDelta =
      reinterpret_cast<float*>(base + L::kDelta) + cw * kDq512Rows;
  {
    const e16* sdO = reinterpret_cast<const e16*>(base + L::kDO);
    const int R = tid / 2, half = tid % 2, row = q_start + R;
    float sum = 0.f;
    if (row < p.S) {
      const e16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
#pragma unroll 4
      for (int c = 0; c < D / 16; ++c) {
        const int ch = half * (D / 16) + c;
        sum += dot8<T>(
            *reinterpret_cast<const uint4*>(orow + ch * 8),
            *reinterpret_cast<const uint4*>(sdO +
                                            swz_rows<kDq512Rows>(R, ch)));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      sDelta[R] = sum;
      if (cw == 0 && row < p.S) p.delta[stat + row] = sum;
    }
  }
  warpgroup_sync(1 + cw);
  const float dlt_r[2] = {sDelta[R0], sDelta[R0 + 8]};

  const uint64_t d_q = smem_desc(base + L::kQ, 16, 1024);
  const uint64_t d_do = smem_desc(base + L::kDO, 16, 1024);
  const uint64_t d_k = smem_desc(base + L::kK, 16, 1024);
  const uint64_t d_v = smem_desc(base + L::kV, 16, 1024);
  // This consumer's chunk of K (boxes cw * kChunk / 64 on), MN-major.
  const uint64_t d_kmn = smem_desc(
      base + L::kK + cw * (kChunk / kBoxCols) * kKv * 128, kKv * 128, 1024);

  float acc[kChunk / 2];
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kDqChunkedKSlots;
    mbar_wait(full0 + 8 * st, (j / kDqChunkedKSlots) & 1);
    // V too, before S is issued (DqSplitKV's trap, C7520).
    mbar_wait(full0 + vbar, j & 1);
    const uint32_t tile = (st * L::kTile) >> 4;
    float s[kKv / 2], dp[kKv / 2];
#pragma unroll
    for (int i = 0; i < kKv / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    mma_nt_n<D, T, kKv>(s, d_q, kDq512Rows * 128, d_k + tile, kKv * 128);
    mma_nt_n<D, T, kKv>(dp, d_do, kDq512Rows * 128, d_v, kKv * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    mbar_arrive_if(empty0 + vbar, tid == 0);  // V_j read
    uint32_t da[kKv / 16][4];
    if (p.causal ? j >= j_mask : j == j_mask)
      ds_tile<T, Base, true, kKv>(s, dp, da, sm, lse_r, dlt_r, row0,
                                  j * kKv, mask);
    else
      ds_tile<T, Base, false, kKv>(s, dp, da, sm, lse_r, dlt_r, row0,
                                   j * kKv, mask);
    wgmma_fence();
    mma_rs<kChunk, T, kKv>(acc, da, d_kmn + tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(empty0 + 8 * st);  // K_j read
  }
  store_acc<kChunk, T, false>(
      acc, p.scale, p.dq + ((long long)b * p.S * p.H + h) * D + cw * kChunk,
      (long long)p.H * D, q_start, p.S);
}

// One CTA of the width-512 dq: work item blockIdx.x is (b * H + h,
// kDq512Rows-row q tile).
template <int D, class T, class Base>
__device__ __forceinline__ void dq_cta_chunked_512(const CUtensorMap& tq,
                                           const CUtensorMap& tdo,
                                           const CUtensorMap& tk,
                                           const CUtensorMap& tv,
                                           const BwdParams& p,
                                           const int* __restrict__ work,
                                           unsigned char* smem) {
  static_assert(out_chunks<D>() == kConsumers, "a consumer a chunk");
  using L = DqSmemChunked512<D>;
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const int bh = work[2 * blockIdx.x], qt = work[2 * blockIdx.x + 1];
  const int b = bh / p.H, h = bh % p.H;
  const int n_all = ceil_div(p.S, kDqChunkedKv);
  const int n_kt =
      p.causal ? min(n_all, (qt + 1) * (kDq512Rows / kDqChunkedKv)) : n_all;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(base + L::kBar);
    for (int i = 0; i < L::kBars; ++i) {
      mbar_init(bars + 8 * i, 1);                        // full: producer
      mbar_init(bars + 8 * (L::kBars + i), kConsumers);  // empty
    }
    mbar_init(bars + 16 * L::kBars, 1);                  // q and dO
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      dq_producer_chunked_512<D>(tq, tdo, tk, tv, p, base, b, h, qt, n_kt);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dq_consumer_chunked_512<D, T, Base>(p, base, b, h, qt, n_kt);
  }
}


// The dk/dv cluster at head_dim 512: two CTAs a 64-row kv tile, CTA c
// (its rank in the cluster) holding column chunk c of everything, against
// q tiles of kDkv512QRows rows. Its shared memory: K and V of the tile's
// chunk (kWideRows x kChunk, 32 KB each); kDkv512Ring stages of a q
// tile's chunk of Q and dO with the tile's lse and delta; kDkv512Exchange
// stages of the exchange (S^T and dP^T from the other CTA: one
// warpgroup's m64 x kDkv512QRows fp32 fragments each); two last-arrival
// flags; mbarriers full[kRing], empty[kRing], kv, s_full[kX],
// dp_full[kX], x_free[kX].
constexpr int kDkv512QRows = 64;
constexpr int kDkv512Ring = 2;
constexpr int kDkv512Exchange = 1;
template <int D>
struct DkvSmem512 {
  static constexpr int kRing = kDkv512Ring;
  static constexpr int kX = kDkv512Exchange;
  static constexpr int kN = kDkv512QRows;
  static constexpr int kTile = kN * kChunk * 2;
  static constexpr int kRowsTile = kWideRows * kChunk * 2;
  static constexpr int kStat = kN * 4;
  static constexpr int kPart = 128 * (kN / 2) * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kRowsTile;
  static constexpr int kQ = 2 * kRowsTile;
  static constexpr int kDO = kQ + kRing * kTile;
  static constexpr int kLse = kDO + kRing * kTile;
  static constexpr int kDelta = kLse + kRing * kStat;
  static constexpr int kXch = kDelta + kRing * kStat;
  static constexpr int kFlag = kXch + kX * 2 * kPart;
  static constexpr int kBar = kFlag + 16;
  static constexpr int kFull = 0, kEmpty = 8 * kRing, kKv = 16 * kRing;
  static constexpr int kSFull = kKv + 8, kDpFull = kSFull + 8 * kX;
  static constexpr int kFree = kDpFull + 8 * kX;
  static constexpr int kBytes = kBar + kFree + 8 * kX + 1024;
  static_assert(D == 2 * kChunk || D == kClusterD,
                "a chunk a CTA of the cluster");
  static_assert(kWideRows % kN == 0, "q tiles meet the kv tile's diagonal");
  static_assert(kBytes <= kMaxSmem, "past the 227 KB a block may use");
};

// The producer's one thread: K and V of the tile's chunk, then for each of
// the item's `heads` query heads from h0 its kDkv512QRows-row q tiles
// from i0 (the chunk of Q and dO, and lse, delta), each once for both
// consumers.
template <int D>
__device__ __forceinline__ void dkv_producer_512(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tlse, const CUtensorMap& tdlt,
    const BwdParams& p, unsigned char* base, int b, int kvh, int kt,
    int chunk, int h0, int heads, int i0, int n_qt) {
  using L = DkvSmem512<D>;
  constexpr int kBoxes = kChunk / kBoxCols;
  const int col0 = chunk * kChunk;
  const uint32_t bars = smem_addr(base + L::kBar);
  const uint32_t full0 = bars + L::kFull, empty0 = bars + L::kEmpty;
  const uint32_t kvbar = bars + L::kKv;
  mbar_expect_tx(kvbar, 2 * L::kRowsTile);
#pragma unroll
  for (int c = 0; c < kBoxes; ++c) {
    const int off = c * kWideRows * 128;
    tma_load_4d(base + L::kK + off, &tk, kvbar, col0 + c * kBoxCols,
                kt * kWideRows, kvh, b);
    tma_load_4d(base + L::kV + off, &tv, kvbar, col0 + c * kBoxCols,
                kt * kWideRows, kvh, b);
  }
  int n = 0;
  for (int h = h0; h < h0 + heads; ++h) {
    for (int i = i0; i < n_qt; ++i, ++n) {
      const int st = n % L::kRing;
      if (n >= L::kRing) mbar_wait(empty0 + 8 * st, (n / L::kRing - 1) & 1);
      const uint32_t full = full0 + 8 * st;
      mbar_expect_tx(full, 2 * L::kTile + 2 * L::kStat);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        const int off = st * L::kTile + c * L::kN * 128;
        tma_load_4d(base + L::kQ + off, &tq, full, col0 + c * kBoxCols,
                    i * L::kN, h, b);
        tma_load_4d(base + L::kDO + off, &tdo, full, col0 + c * kBoxCols,
                    i * L::kN, h, b);
      }
      tma_load_2d(base + L::kLse + st * L::kStat, &tlse, full, i * L::kN,
                  b * p.H + h);
      tma_load_2d(base + L::kDelta + st * L::kStat, &tdlt, full,
                  i * L::kN, b * p.H + h);
    }
  }
}

// P^T = exp(sm * s^T - lse[q]) (kDS false) or dS^T = P^T * (dP^T -
// delta[q]) (kDS true) of one 64 (kv) x N (q) tile, into the A fragments
// of the next product, rounded to T. MASK drops the causal pairs q < k.
// Only 8-column groups kI0 .. kI0 + kNI - 1 (all by default).
template <class T, class Base, bool MASK, bool kDS, int N, int kI0 = 0,
          int kNI = N / 8>
__device__ __forceinline__ void pds_tile(const float (&s)[N / 2],
                                         const float (&dp)[N / 2],
                                         uint32_t (&a)[N / 16][4],
                                         const float* lse, const float* dlt,
                                         float sm, int krow0, int q_start) {
  const int t = threadIdx.x % 4;
  const float kDrop = -__int_as_float(0x7f800000);  // -inf: exp gives 0
#pragma unroll
  for (int i = kI0; i < kI0 + kNI; ++i) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse + i * 8 + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(dlt + i * 8 + 2 * t);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fmaf(s[4 * i + e], sm, (e & 1) ? -l2.y : -l2.x);
      if (MASK && q_start + i * 8 + 2 * t + (e & 1) < krow0 + 8 * (e >> 1))
        x = kDrop;
      v[e] = Base::exp(x);
      if constexpr (kDS) v[e] *= dp[4 * i + e] - ((e & 1) ? d2.y : d2.x);
    }
    a[i / 2][(i % 2) * 2] = T::pack(v[0], v[1]);
    a[i / 2][(i % 2) * 2 + 1] = T::pack(v[2], v[3]);
  }
}

// One consumer of dkv_cta_512 over the item's q tiles, on the CTA's
// kWideRows kv rows and its chunk of columns (rank `chunk` of the
// cluster). Per q tile, consumer 0 runs S^T_c = K_c Q_c^T, consumer 1
// S^T_c and dP^T_c = V_c dO_c^T (m64 x kDkv512QRows over the chunk's 256
// columns); consumer 0 sends S^T_c, consumer 1 dP^T_c to the other CTA
// (st.async, completing on its s_full or dp_full); then S^T = S^T_c +
// S^T_other and dP^T likewise (one IEEE sum of two terms, the same in
// both CTAs and both consumers, so P^T and dS^T agree bit for bit), and
// consumer 0 runs P^T and acc = dv[:, chunk] += P^T dO_c, consumer 1
// dS^T and acc = dk[:, chunk] += dS^T Q_c (unscaled): five products a
// tile pair where four are minimal. An exchange stage is written again
// only once all four consumers of the cluster have read it (x_free).
// Causal, both mask the q tiles that meet the 64 kv rows' diagonal.
template <int D, class T, class Base, bool kDk>
__device__ __forceinline__ void dkv_consumer_512(float (&acc)[kChunk / 2],
                                                 const BwdParams& p,
                                                 unsigned char* base, int kt,
                                                 uint32_t chunk, int heads,
                                                 int i0, int n_qt) {
  using L = DkvSmem512<D>;
  constexpr int kN = L::kN;
  constexpr int kF = kN / 2;  // a thread's share of an m64 x kN product
  constexpr int kPartF = L::kPart / 4;
  const int tid = threadIdx.x % 128;
  const int krow0 = kt * kWideRows + (tid / 32) * 16 + (tid % 32) / 4;
  const uint32_t bars = smem_addr(base + L::kBar);
  const uint32_t full0 = bars + L::kFull, empty0 = bars + L::kEmpty;
  const uint32_t s_full0 = bars + L::kSFull, dp_full0 = bars + L::kDpFull;
  const uint32_t free0 = bars + L::kFree;
  const uint32_t other = chunk ^ 1;
  const float sm = p.scale * Base::kScoreMul;
  const int i_end_mask = p.causal ? i0 + kWideRows / kN : -1;
  // S^T and dP^T read K, V, Q and dO K-major.
  const uint64_t d_k = smem_desc(base + L::kK, 16, 1024);
  const uint64_t d_v = smem_desc(base + L::kV, 16, 1024);
  const uint64_t d_q = smem_desc(base + L::kQ, 16, 1024);
  const uint64_t d_do = smem_desc(base + L::kDO, 16, 1024);
  // dk += dS^T Q reads Q's chunk MN-major, dv += P^T dO reads dO's so.
  const uint64_t d_bmn =
      smem_desc(base + (kDk ? L::kQ : L::kDO), kN * 128, 1024);
  float* xch = reinterpret_cast<float*>(base + L::kXch);
  const int nq = n_qt - i0, total = heads * nq;
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) acc[i] = 0.f;
  mbar_wait(bars + L::kKv, 0);
  for (int n = 0; n < total; ++n) {
    const int i = i0 + n % nq, st = n % L::kRing, x = n % L::kX;
    const uint32_t tile = (st * L::kTile) >> 4;
    mbar_wait(full0 + 8 * st, (n / L::kRing) & 1);
    float s[kF], dp[kF];
#pragma unroll
    for (int e = 0; e < kF; ++e) s[e] = dp[e] = 0.f;
    wgmma_fence();
    mma_nt_n<kChunk, T, kN>(s, d_k, kWideRows * 128, d_q + tile, kN * 128);
    if constexpr (kDk)
      mma_nt_n<kChunk, T, kN>(dp, d_v, kWideRows * 128, d_do + tile,
                              kN * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    if constexpr (kDk) fence_regs(dp);
    // Stage x of the exchange: the other CTA's S^T, then its dP^T;
    // fragment element 4 e4 + c of thread tid at 4 (e4 * 128 + tid) + c.
    float* xs = xch + x * 2 * kPartF;
    // Consumer 0 sends S^T_c, consumer 1 dP^T_c, once stage x is free in
    // both CTAs; each arms its own barrier of stage x for the other CTA's
    // kPart bytes.
    if (n >= L::kX) mbar_wait_cluster(free0 + 8 * x, (n / L::kX - 1) & 1);
    {
      const float(&out)[kF] = kDk ? dp : s;
      const uint32_t bar = (kDk ? dp_full0 : s_full0) + 8 * x;
      if (tid == 0) mbar_expect_tx(bar, L::kPart);
      const uint32_t dst =
          map_rank(smem_addr(xs + (kDk ? kPartF : 0)), other) + 16 * tid;
      const uint32_t rbar = map_rank(bar, other);
#pragma unroll
      for (int e4 = 0; e4 < kF / 4; ++e4)
        st_async(dst + e4 * 128 * 16, out[4 * e4], out[4 * e4 + 1],
                 out[4 * e4 + 2], out[4 * e4 + 3], rbar);
    }
    // S^T (and dP^T) of the tile: this CTA's partial plus the other's.
    mbar_wait_cluster(s_full0 + 8 * x, (n / L::kX) & 1);
    if constexpr (kDk) mbar_wait_cluster(dp_full0 + 8 * x, (n / L::kX) & 1);
#pragma unroll
    for (int e4 = 0; e4 < kF / 4; ++e4) {
      const float4 r =
          *reinterpret_cast<const float4*>(xs + 4 * (e4 * 128 + tid));
      s[4 * e4] += r.x;
      s[4 * e4 + 1] += r.y;
      s[4 * e4 + 2] += r.z;
      s[4 * e4 + 3] += r.w;
      if constexpr (kDk) {
        const float4 d = *reinterpret_cast<const float4*>(
            xs + kPartF + 4 * (e4 * 128 + tid));
        dp[4 * e4] += d.x;
        dp[4 * e4 + 1] += d.y;
        dp[4 * e4 + 2] += d.z;
        dp[4 * e4 + 3] += d.w;
      }
    }
    // Stage x read here: free for the writers of both CTAs.
    warpgroup_sync(1 + kDk);
    if (tid == 0) {
      mbar_arrive(free0 + 8 * x);
      mbar_arrive_remote(map_rank(free0 + 8 * x, other));
    }
    uint32_t a[kN / 16][4];
    const float* lse =
        reinterpret_cast<const float*>(base + L::kLse + st * L::kStat);
    const float* dlt =
        reinterpret_cast<const float*>(base + L::kDelta + st * L::kStat);
    if (i < i_end_mask)
      pds_tile<T, Base, true, kDk, kN>(s, dp, a, lse, dlt, sm, krow0,
                                       i * kN);
    else
      pds_tile<T, Base, false, kDk, kN>(s, dp, a, lse, dlt, sm, krow0,
                                        i * kN);
    wgmma_fence();
    mma_rs<kChunk, T, kN>(acc, a, d_bmn + tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(empty0 + 8 * st);  // Q, dO, lse, delta read
  }
}

// A consumer's epilogue at head_dim 512 and past it (which: 0 dv, 1 dk;
// `width` the kernel width), for its chunk's columns: dkv_wide_store's,
// with each (kv tile, chunk) ticketed on its own counters.
template <int D, class T>
__device__ __forceinline__ void dkv_store_512(
    const float (&acc)[kChunk / 2], float mul, e16* out, const BwdParams& p,
    const DkvSplit& split, unsigned char* base, int which, long long off,
    int bkv, int kt, int chunk, int part, int width = D) {
  const long long ss = (long long)p.KVH * width;
  const int row0 = kt * kWideRows;
  off += chunk * kChunk;
  if (split.parts == 1) {
    store_acc<kChunk, T, false>(acc, mul, out + off, ss, row0, p.S);
    return;
  }
  const long long plane = (long long)split.batch * p.S * ss;
  float* ws = split.ws + which * split.parts * plane + off;
  store_acc<kChunk, T, true>(acc, 1.f, ws + part * plane, ss, row0, p.S);
  __threadfence();
  warpgroup_sync(1 + which);
  volatile int* last =
      reinterpret_cast<int*>(base + DkvSmem512<D>::kFlag) + which;
  if (threadIdx.x % 128 == 0) {
    const int tile =
        (bkv * ceil_div(p.S, kWideRows) + kt) * (width / kChunk) + chunk;
    *last = atomicAdd(split.tickets + 2 * tile + which, 1) ==
            split.parts - 1;
  }
  warpgroup_sync(1 + which);
  if (*last) {
    __threadfence();
    sum_parts<kChunk, T>(mul, ws, plane, split.parts, out + off, ss, row0,
                         p.S);
  }
}

// One CTA of every dk/dv at head_dim 512, launched in clusters of C =
// out_chunks CTAs: block i is rank i % C, chunk i % C of work item i / C
// of dkv_wide_schedule's list, (b * KVH + kvh, kWideRows-row kv tile,
// part of the GQA group).
template <int D, class T, class Base>
__device__ __forceinline__ void dkv_cta_512(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tlse, const CUtensorMap& tdlt,
    const BwdParams& p, const int* __restrict__ work, const DkvSplit& split,
    unsigned char* smem) {
  static_assert(Base::kLseMul == 1.f, "dk/dv reads lse as the base's own");
  using L = DkvSmem512<D>;
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  constexpr int kC = out_chunks<D>();
  const uint32_t chunk = cluster_rank();
  const int* item = work + 3 * (blockIdx.x / kC);
  const int bkv = item[0], kt = item[1], part = item[2];
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  const int heads = p.H / p.KVH / split.parts;
  const int h0 = kvh * (p.H / p.KVH) + part * heads;
  const int n_qt = ceil_div(p.S, L::kN);
  // Causal: q tiles from the kv tile's first row (kt's rows start before
  // S).
  const int i0 = p.causal ? kt * (kWideRows / L::kN) : 0;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(base + L::kBar);
    for (int i = 0; i < L::kRing; ++i) {
      mbar_init(bars + L::kFull + 8 * i, 1);
      mbar_init(bars + L::kEmpty + 8 * i, kConsumers);
    }
    mbar_init(bars + L::kKv, 1);  // K and V
    for (int x = 0; x < L::kX; ++x) {
      // S^T: consumer 0's expect_tx (the other CTA's bytes); dP^T:
      // consumer 1's; free: both consumers of both CTAs.
      mbar_init(bars + L::kSFull + 8 * x, 1);
      mbar_init(bars + L::kDpFull + 8 * x, 1);
      mbar_init(bars + L::kFree + 8 * x, 2 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  // Every barrier of both CTAs is initialised before any remote arrival.
  cluster_sync();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      dkv_producer_512<D>(tq, tdo, tk, tv, tlse, tdlt, p, base, b, kvh, kt,
                          chunk, h0, heads, i0, n_qt);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const long long off = ((long long)b * p.S * p.KVH + kvh) * D;
    float acc[kChunk / 2];
    if (threadIdx.x < 256) {
      dkv_consumer_512<D, T, Base, false>(acc, p, base, kt, chunk, heads,
                                          i0, n_qt);
      dkv_store_512<D, T>(acc, 1.f, p.dv, p, split, base, 0, off, bkv, kt,
                          chunk, part);
    } else {
      dkv_consumer_512<D, T, Base, true>(acc, p, base, kt, chunk, heads, i0,
                                         n_qt);
      dkv_store_512<D, T>(acc, p.scale, p.dk, p, split, base, 1, off, bkv,
                          kt, chunk, part);
    }
  }
  // Neither CTA leaves while the other may still write its shared memory
  // or arrive on its barriers.
  cluster_sync();
}

// ---------------------------------------- dq and dk/dv past head_dim 512

// dq_cta_x's shared memory (the kClusterD instance: a cluster of n =
// width / kChunk CTAs an item of kDq512Rows q rows, CTA c holding chunk c
// of every operand): Q_c and dO_c (kDq512Rows x kChunk, 32 KB each);
// kDqXKSlots stages of chunk c of a kKv512-row K tile and one of V (32 KB
// each); this CTA's slots, its partial of S (consumer 0's) and of dP
// (consumer 1's), m64 x kKv512 fp32 fragments each, which every rank
// reads; the sums of S and dP, each consumer's gathered for the other;
// this chunk's partial of delta; mbarriers k_full[KS], k_empty[KS],
// v_full, v_empty, q, delta, x_full[2] (S's, dP's), x_free[2]. 230,752 B.
constexpr int kDqXKSlots = 2;
struct DqSmemX {
  static constexpr int kKS = kDqXKSlots, kVS = 1;
  static constexpr int kRowsTile = kDq512Rows * kChunk * 2;
  static constexpr int kTile = kKv512 * kChunk * 2;
  static constexpr int kPart = 64 * kKv512 * 4;
  static constexpr int kQ = 0;
  static constexpr int kDO = kRowsTile;
  static constexpr int kK = 2 * kRowsTile;
  static constexpr int kV = kK + kKS * kTile;
  static constexpr int kXch = kV + kVS * kTile;
  static constexpr int kSum = kXch + 2 * kPart;
  static constexpr int kDelta = kSum + 2 * kPart;
  static constexpr int kBar = kDelta + kDq512Rows * 4;
  static constexpr int kKFull = 0, kKEmpty = 8 * kKS, kVFull = 16 * kKS;
  static constexpr int kVEmpty = kVFull + 8 * kVS, kQBar = kVEmpty + 8 * kVS;
  static constexpr int kDlt = kQBar + 8, kXFull = kDlt + 8;
  static constexpr int kXFree = kXFull + 16;
  static constexpr int kBytes = kBar + kXFree + 16 + 1024;
  static_assert(kDq512Rows == kKv512, "a q tile's loop ends at its index");
  static_assert(kBytes <= kMaxSmem, "past the 227 KB a block may use");
};

// One consumer warpgroup of dq_cta_x's CTA of rank `chunk` in a cluster of
// n (kDp false: consumer 0, S; true: consumer 1, dP), on the item's 64 q
// rows. delta = rowsum(dO * O): each consumer takes 32 rows of its CTA's
// chunk (four threads a row, O from global memory, dO from its tile) into
// the CTA's partial, published to every rank; delta = the n ranks'
// partials in rank order. Per K/V tile j, in lockstep with the other
// ranks: consumer 0's partial S_c = Q_c K_c^T, consumer 1's dP_c = dO_c
// V_c^T (m64n64, 256 deep; V_j released after it), into this CTA's slot
// of its kind once every rank has read the last (x_free) and published
// (x_full); each gathers its kind's n partials in rank order and leaves
// the sum for the other consumer (consumers_sync), then reads the other's:
// both hold S_j and dP_j, bit-equal in every rank, form dS = P (dP -
// delta) and run their 128-column half of dq_c += dS K_c (m64n128k16, K_c
// read MN-major from the half's two boxes). Causal, the loop ends on the
// diagonal tile, which both mask.
template <class T, class Base, bool kDp>
__device__ __forceinline__ void dq_consumer_x(const BwdParams& p,
                                              unsigned char* base, int b,
                                              int h, int qt, int n_kt,
                                              uint32_t chunk, int n) {
  using L = DqSmemX;
  constexpr int kF = kKv512 / 2, kPartF = L::kPart / 4, kHalf = kChunk / 2;
  constexpr int kW = kDp ? 1 : 0;
  const int tid = threadIdx.x % 128;
  const int R0 = (tid / 32) * 16 + (tid % 32) / 4;  // and R0 + 8
  const int q_start = qt * kDq512Rows, row0 = q_start + R0;
  const uint32_t bars = smem_addr(base + L::kBar);
  const float sm = p.scale * Base::kScoreMul;
  const TileMask mask = {p.S, p.causal};
  const long long stat = ((long long)b * p.H + h) * p.S;
  const int j_mask = p.causal ? qt : masked_tile(0, p.S, kKv512, n_kt);
  float lse_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    lse_r[hf] = row0 + 8 * hf < p.S
                    ? p.lse[stat + row0 + 8 * hf] * Base::kLseMul
                    : 0.f;

  // This consumer's A (Q_c or dO_c) and B (K_c or V_c) K-major, and its
  // half of K_c MN-major for dS K.
  const uint64_t d_a = smem_desc(base + (kDp ? L::kDO : L::kQ), 16, 1024);
  const uint64_t d_b = smem_desc(base + (kDp ? L::kV : L::kK), 16, 1024);
  const uint64_t d_kmn =
      smem_desc(base + L::kK + kW * (kHalf / kBoxCols) * kKv512 * 128,
                kKv512 * 128, 1024);
  float* slot = reinterpret_cast<float*>(base + L::kXch) + kW * kPartF;
  float* sum_mine = reinterpret_cast<float*>(base + L::kSum) + kW * kPartF;
  const float* sum_theirs =
      reinterpret_cast<const float*>(base + L::kSum) + (1 - kW) * kPartF;
  const uint32_t x_full = bars + L::kXFull + 8 * kW;
  const uint32_t x_free = bars + L::kXFree + 8 * kW;
  mbar_wait(bars + L::kQBar, 0);
  // delta's partial over this CTA's chunk (rows 32 kW .. + 31, 0 past S).
  float* sDelta = reinterpret_cast<float*>(base + L::kDelta);
  {
    const e16* sdO = reinterpret_cast<const e16*>(base + L::kDO);
    const int R = kW * 32 + tid / 4, quarter = tid % 4, row = q_start + R;
    float sum = 0.f;
    if (row < p.S) {
      const e16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss +
                        chunk * kChunk;
#pragma unroll
      for (int c = 0; c < kChunk / 32; ++c) {
        const int ch = quarter * (kChunk / 32) + c;
        sum += dot8<T>(*reinterpret_cast<const uint4*>(orow + ch * 8),
                       *reinterpret_cast<const uint4*>(
                           sdO + swz_rows<kDq512Rows>(R, ch)));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (quarter == 0) sDelta[R] = sum;
  }
  warpgroup_sync(1 + kW);
  arrive_ranks<true>(bars + L::kDlt, n);
  mbar_wait_cluster(bars + L::kDlt, 0);
  float dlt_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const uint32_t at = smem_addr(sDelta + R0 + 8 * hf);
    float x = ld_cluster_f32(map_rank(at, 0));
    for (int r = 1; r < n; ++r) x += ld_cluster_f32(map_rank(at, r));
    dlt_r[hf] = x;
  }
  if (chunk == 0 && !kDp && tid % 4 == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (row0 + 8 * hf < p.S) p.delta[stat + row0 + 8 * hf] = dlt_r[hf];
  }

  float acc[kHalf / 2];
#pragma unroll
  for (int i = 0; i < kHalf / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < n_kt; ++j) {
    // This CTA's partial of this consumer's kind of tile j (K_j or V_j
    // waited for; V_j released after it).
    const int ring = kDp ? L::kVS : L::kKS, st = j % ring;
    mbar_wait(bars + (kDp ? L::kVFull : L::kKFull) + 8 * st, (j / ring) & 1);
    float x[kF], y[kF];
#pragma unroll
    for (int i = 0; i < kF; ++i) x[i] = 0.f;
    wgmma_fence();
    mma_nt<kChunk, T>(x, d_a, kDq512Rows * 128,
                      d_b + ((st * L::kTile) >> 4), kKv512 * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);
    if constexpr (kDp) mbar_arrive_if(bars + L::kVEmpty + 8 * st, tid == 0);
    if (j > 0) mbar_wait(x_free, (j - 1) & 1);
    put_part(x, slot);
    warpgroup_sync(1 + kW);
    arrive_ranks<true>(x_full, n);
    // This kind summed over the n ranks; the other kind from the other
    // consumer.
    mbar_wait_cluster(x_full, j & 1);
    gather_parts(x, smem_addr(slot), n);
    warpgroup_sync(1 + kW);
    arrive_ranks<false>(x_free, n);
    put_part(x, sum_mine);
    consumers_sync();
#pragma unroll
    for (int e4 = 0; e4 < kF / 4; ++e4) {
      const float4 r =
          *reinterpret_cast<const float4*>(sum_theirs + 4 * (e4 * 128 + tid));
      y[4 * e4] = r.x;
      y[4 * e4 + 1] = r.y;
      y[4 * e4 + 2] = r.z;
      y[4 * e4 + 3] = r.w;
    }
    // Both sums read before either consumer writes the next tile's.
    consumers_sync();
    const int ks = j % L::kKS;
    if constexpr (kDp) mbar_wait(bars + L::kKFull + 8 * ks, (j / L::kKS) & 1);
    uint32_t da[kKv512 / 16][4];
    const float(&s)[kF] = kDp ? y : x;
    const float(&dp)[kF] = kDp ? x : y;
    if (j == j_mask)
      ds_tile<T, Base, true, kKv512>(s, dp, da, sm, lse_r, dlt_r, row0,
                                     j * kKv512, mask);
    else
      ds_tile<T, Base, false, kKv512>(s, dp, da, sm, lse_r, dlt_r, row0,
                                      j * kKv512, mask);
    wgmma_fence();
    mma_rs<kHalf, T, kKv512>(acc, da, d_kmn + ((ks * L::kTile) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive_if(bars + L::kKEmpty + 8 * ks, tid == 0);  // K_j read
  }
  store_acc<kHalf, T, false>(
      acc, p.scale,
      p.dq + ((long long)b * p.S * p.H + h) * p.D + chunk * kChunk +
          kW * kHalf,
      (long long)p.H * p.D, q_start, p.S);
}

// One CTA of every dq past head_dim 512 (the kClusterD instance of each
// family, the resident one included), launched in clusters of n = p.D /
// kChunk CTAs: block i is rank i % n, chunk i % n of work item i / n, (b
// * H + h, kDq512Rows-row q tile).
template <class T, class Base>
__device__ __forceinline__ void dq_cta_x(const CUtensorMap& tq,
                                         const CUtensorMap& tdo,
                                         const CUtensorMap& tk,
                                         const CUtensorMap& tv,
                                         const BwdParams& p,
                                         const int* __restrict__ work,
                                         unsigned char* smem) {
  using L = DqSmemX;
  const int n = p.D / kChunk;
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const uint32_t chunk = cluster_rank();
  const int item = blockIdx.x / n;
  const int bh = work[2 * item], qt = work[2 * item + 1];
  const int b = bh / p.H, h = bh % p.H;
  const int n_all = ceil_div(p.S, kKv512);
  const int n_kt = p.causal ? min(n_all, qt + 1) : n_all;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(base + L::kBar);
    for (int i = 0; i < L::kKS; ++i) {
      mbar_init(bars + L::kKFull + 8 * i, 1);
      mbar_init(bars + L::kKEmpty + 8 * i, kConsumers);
    }
    mbar_init(bars + L::kVFull, 1);
    mbar_init(bars + L::kVEmpty, 1);  // consumer 1's dP
    mbar_init(bars + L::kQBar, 1);
    // delta: both consumers of each rank; x_full (S's, dP's): its kind's
    // consumer of each rank, once its partial is in place; x_free: the
    // same, once it has read this CTA's.
    mbar_init(bars + L::kDlt, kConsumers * n);
    for (int c = 0; c < kConsumers; ++c) {
      mbar_init(bars + L::kXFull + 8 * c, n);
      mbar_init(bars + L::kXFree + 8 * c, n);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  // Every barrier of every rank is initialised before any remote arrival.
  cluster_sync();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      dq_producer_512<kClusterD, L>(tq, tdo, tk, tv, p, base, b, h, qt,
                                    n_kt, chunk);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    if (threadIdx.x < 256)
      dq_consumer_x<T, Base, false>(p, base, b, h, qt, n_kt, chunk, n);
    else
      dq_consumer_x<T, Base, true>(p, base, b, h, qt, n_kt, chunk, n);
  }
  // No CTA leaves while another may still read its shared memory or
  // arrive on its barriers.
  cluster_sync();
}

// dkv_cta_x's shared memory: dkv_cta_512's (DkvSmem512), its exchange
// buffer now this CTA's slots (its partial of S^T from consumer 0, of
// dP^T from consumer 1, which every rank reads), and a second free
// barrier: S^T's slot is read by both consumers of every rank, dP^T's by
// consumer 1 alone. 231,512 B.
struct DkvSmemX : DkvSmem512<kClusterD> {
  static_assert(kX == 1, "one stage of slots");
  static constexpr int kDpFree = kFree + 8;
  static constexpr int kBytes = DkvSmem512<kClusterD>::kBytes + 8;
  static_assert(kBytes <= kMaxSmem, "past the 227 KB a block may use");
};

// One consumer of dkv_cta_x over the item's q tiles, on the CTA's
// kWideRows kv rows and its chunk of columns, in lockstep with the other
// ranks. Per q tile: consumer 0's partial S^T_c = K_c Q_c^T, consumer 1's
// dP^T_c = V_c dO_c^T (m64 x kDkv512QRows over the chunk's 256 columns),
// each into this CTA's slot of its kind once every reader has read the
// last (its free barrier), and published (s_full, dp_full); then S^T (both
// consumers) and dP^T (consumer 1) = the n ranks' partials in rank order,
// the same in every rank and consumer, so P^T and dS^T agree bit for bit;
// consumer 0 runs P^T and acc = dv[:, chunk] += P^T dO_c, consumer 1 dS^T
// and acc = dk[:, chunk] += dS^T Q_c (unscaled): four products a tile
// pair, the minimal. Causal, both mask the q tiles that meet the 64 kv
// rows' diagonal.
template <class T, class Base, bool kDk>
__device__ __forceinline__ void dkv_consumer_x(float (&acc)[kChunk / 2],
                                               const BwdParams& p,
                                               unsigned char* base, int kt,
                                               int heads, int i0, int n_qt,
                                               int n) {
  using L = DkvSmemX;
  constexpr int kN = L::kN;
  constexpr int kF = kN / 2;  // a thread's share of an m64 x kN product
  constexpr int kPartF = L::kPart / 4;
  const int tid = threadIdx.x % 128;
  const int krow0 = kt * kWideRows + (tid / 32) * 16 + (tid % 32) / 4;
  const uint32_t bars = smem_addr(base + L::kBar);
  const uint32_t full0 = bars + L::kFull, empty0 = bars + L::kEmpty;
  const uint32_t s_full = bars + L::kSFull, dp_full = bars + L::kDpFull;
  const uint32_t s_free = bars + L::kFree, dp_free = bars + L::kDpFree;
  const float sm = p.scale * Base::kScoreMul;
  const int i_end_mask = p.causal ? i0 + kWideRows / kN : -1;
  const uint64_t d_k = smem_desc(base + L::kK, 16, 1024);
  const uint64_t d_v = smem_desc(base + L::kV, 16, 1024);
  const uint64_t d_q = smem_desc(base + L::kQ, 16, 1024);
  const uint64_t d_do = smem_desc(base + L::kDO, 16, 1024);
  // dk += dS^T Q reads Q's chunk MN-major, dv += P^T dO reads dO's so.
  const uint64_t d_bmn =
      smem_desc(base + (kDk ? L::kQ : L::kDO), kN * 128, 1024);
  float* xs = reinterpret_cast<float*>(base + L::kXch);
  float* xd = xs + kPartF;
  const int nq = n_qt - i0, total = heads * nq;
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) acc[i] = 0.f;
  mbar_wait(bars + L::kKv, 0);
  for (int t = 0; t < total; ++t) {
    const int i = i0 + t % nq, st = t % L::kRing;
    const uint32_t tile = (st * L::kTile) >> 4;
    mbar_wait(full0 + 8 * st, (t / L::kRing) & 1);
    float s[kF], dp[kF];
    float(&mine)[kF] = kDk ? dp : s;
#pragma unroll
    for (int e = 0; e < kF; ++e) mine[e] = 0.f;
    wgmma_fence();
    if constexpr (kDk)
      mma_nt_n<kChunk, T, kN>(dp, d_v, kWideRows * 128, d_do + tile,
                              kN * 128);
    else
      mma_nt_n<kChunk, T, kN>(s, d_k, kWideRows * 128, d_q + tile,
                              kN * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(mine);
    if (t > 0) mbar_wait(kDk ? dp_free : s_free, (t - 1) & 1);
    put_part(mine, kDk ? xd : xs);
    warpgroup_sync(1 + kDk);
    arrive_ranks<true>(kDk ? dp_full : s_full, n);
    // S^T (and dP^T) of the tile: the n ranks' partials in rank order,
    // pulled and turned into P^T (dS^T) a part of the tile at a time:
    // consumer 1 holds dk (128) beside a quarter of S^T and dP^T (8 each;
    // whole, or by halves, they spill at 232 registers), consumer 0 dv
    // beside half of S^T.
    mbar_wait_cluster(s_full, t & 1);
    if constexpr (kDk) mbar_wait_cluster(dp_full, t & 1);
    uint32_t a[kN / 16][4];
    const float* lse =
        reinterpret_cast<const float*>(base + L::kLse + st * L::kStat);
    const float* dlt =
        reinterpret_cast<const float*>(base + L::kDelta + st * L::kStat);
    constexpr int kParts = kDk ? 4 : 2, kG = kN / 8 / kParts;
    const auto part = [&](auto h) {
      constexpr int kH = decltype(h)::value;
      if constexpr (kH < kParts) {
        gather_parts<kH * kG, kG>(s, smem_addr(xs), n);
        if constexpr (kDk) gather_parts<kH * kG, kG>(dp, smem_addr(xd), n);
        if (i < i_end_mask)
          pds_tile<T, Base, true, kDk, kN, kH * kG, kG>(s, dp, a, lse, dlt,
                                                        sm, krow0, i * kN);
        else
          pds_tile<T, Base, false, kDk, kN, kH * kG, kG>(s, dp, a, lse, dlt,
                                                         sm, krow0, i * kN);
      }
    };
    part(std::integral_constant<int, 0>());
    part(std::integral_constant<int, 1>());
    part(std::integral_constant<int, 2>());
    part(std::integral_constant<int, 3>());
    warpgroup_sync(1 + kDk);
    arrive_ranks<false>(s_free, n);
    if constexpr (kDk) arrive_ranks<false>(dp_free, n);
    wgmma_fence();
    mma_rs<kChunk, T, kN>(acc, a, d_bmn + tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive_if(empty0 + 8 * st, tid == 0);  // Q, dO, lse, delta read
  }
}

// One CTA of every dk/dv past head_dim 512 (the kClusterD instance),
// launched in clusters of n = p.D / kChunk CTAs: block i is rank i % n,
// chunk i % n of work item i / n of dkv_wide_schedule's list, (b * KVH +
// kvh, kWideRows-row kv tile, part of the GQA group). The GQA parts are
// dkv_cta_512's, ticketed per kv tile and chunk.
template <class T, class Base>
__device__ __forceinline__ void dkv_cta_x(
    const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tlse, const CUtensorMap& tdlt,
    const BwdParams& p, const int* __restrict__ work, const DkvSplit& split,
    unsigned char* smem) {
  static_assert(Base::kLseMul == 1.f, "dk/dv reads lse as the base's own");
  using L = DkvSmemX;
  const int n = p.D / kChunk;
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const uint32_t chunk = cluster_rank();
  const int* item = work + 3 * (blockIdx.x / n);
  const int bkv = item[0], kt = item[1], part = item[2];
  const int b = bkv / p.KVH, kvh = bkv % p.KVH;
  const int heads = p.H / p.KVH / split.parts;
  const int h0 = kvh * (p.H / p.KVH) + part * heads;
  const int n_qt = ceil_div(p.S, L::kN);
  // Causal: q tiles from the kv tile's first row (kt's rows start before
  // S).
  const int i0 = p.causal ? kt * (kWideRows / L::kN) : 0;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_addr(base + L::kBar);
    for (int i = 0; i < L::kRing; ++i) {
      mbar_init(bars + L::kFull + 8 * i, 1);
      mbar_init(bars + L::kEmpty + 8 * i, kConsumers);
    }
    mbar_init(bars + L::kKv, 1);  // K and V
    // s_full, dp_full: consumer 0 (S^T), consumer 1 (dP^T) of each rank;
    // s_free: both consumers of each rank, dp_free: consumer 1 of each.
    mbar_init(bars + L::kSFull, n);
    mbar_init(bars + L::kDpFull, n);
    mbar_init(bars + L::kFree, kConsumers * n);
    mbar_init(bars + L::kDpFree, n);
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  // Every barrier of every rank is initialised before any remote arrival.
  // The consumers take kConsumerRegs512 (240), the producer
  // kProducerRegs512: at 232 the dk consumer spills a few bytes.
  cluster_sync();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs512>();
    if (threadIdx.x == 0)
      dkv_producer_512<kClusterD>(tq, tdo, tk, tv, tlse, tdlt, p, base, b,
                                  kvh, kt, chunk, h0, heads, i0, n_qt);
  } else {
    setmaxnreg_inc<kConsumerRegs512>();
    const long long off = ((long long)b * p.S * p.KVH + kvh) * p.D;
    float acc[kChunk / 2];
    if (threadIdx.x < 256) {
      dkv_consumer_x<T, Base, false>(acc, p, base, kt, heads, i0, n_qt, n);
      dkv_store_512<kClusterD, T>(acc, 1.f, p.dv, p, split, base, 0, off,
                                  bkv, kt, chunk, part, p.D);
    } else {
      dkv_consumer_x<T, Base, true>(acc, p, base, kt, heads, i0, n_qt, n);
      dkv_store_512<kClusterD, T>(acc, p.scale, p.dk, p, split, base, 1, off,
                                  bkv, kt, chunk, part, p.D);
    }
  }
  // No CTA leaves while another may still read its shared memory or
  // arrive on its barriers.
  cluster_sync();
}

// ----------------------------------------------------------------- host

// A map of the (B * H, S) fp32 rows of lse or delta, as dimensions (S,
// B * H): boxes of box_len values of one row, unswizzled. Values at or past
// S read as zeros.
inline int encode_stats(CUtensorMap* map, const void* ptr, int S, int rows,
                        int box_len = kBwdTile) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)S, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)S * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_len, 1};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// Encodes dq's four maps (Q and dO in boxes of `rows`, K and V of
// `kv_rows`) and launches `kernel` with `smem` bytes over the B * H *
// ceil(S / rows) items of `work`, in clusters of `cluster` CTAs an item
// when it is past 1.
template <class T, class Kernel>
inline int launch_dq_rows(Kernel kernel, const BwdParams& p, int B, int D,
                          int rows, int kv_rows, int smem, const int* work,
                          cudaStream_t stream, int cluster = 1) {
  CUtensorMap tq, tdo, tk, tv;
  int err = encode_rows<T>(&tq, p.q, D, p.S, p.H, B, p.q_ss, p.q_sh, p.q_sb,
                           rows);
  if (!err)
    err = encode_rows<T>(&tdo, p.dout, D, p.S, p.H, B, p.do_ss, p.do_sh,
                         p.do_sb, rows);
  if (!err)
    err = encode_rows<T>(&tk, p.k, D, p.S, p.KVH, B, p.k_ss, p.k_sh, p.k_sb,
                         kv_rows);
  if (!err)
    err = encode_rows<T>(&tv, p.v, D, p.S, p.KVH, B, p.v_ss, p.v_sh, p.v_sb,
                         kv_rows);
  if (err) return err;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int items = B * p.H * ceil_div(p.S, rows);
  if (cluster > 1)
    return launch_clusters(kernel, items * cluster, cluster, smem, stream,
                           tq, tdo, tk, tv, p, work);
  kernel<<<items, kFwdThreads, smem, stream>>>(tq, tdo, tk, tv, p, work);
  return (int)cudaGetLastError();
}

// Launches `kernel` (an instance of dq_cta of shape Sh over the B * H *
// ceil(S / 128) items of `work`; at head_dim 512 of dq_cta_512 over B * H
// * ceil(S / 64), a cluster of out_chunks CTAs each; the kClusterD
// instance, dq_cta_x, over the same items at width p.D, a cluster of p.D
// / kChunk CTAs each).
template <int D, class T, class Sh = DqBase<D>, class Kernel>
inline int launch_dq(Kernel kernel, const BwdParams& p, int B,
                     const int* work, cudaStream_t stream) {
  if constexpr (D == kClusterD)
    return launch_dq_rows<T>(kernel, p, B, p.D, kDq512Rows, kKv512,
                             DqSmemX::kBytes, work, stream, p.D / kChunk);
  else if constexpr (D > 256)
    return launch_dq_rows<T>(kernel, p, B, D, kDq512Rows, kKv512,
                             DqSmem512<D>::kBytes, work, stream,
                             out_chunks<D>());
  else
    return launch_dq_rows<T>(kernel, p, B, D, kBwdRows, Sh::kKv,
                             DqSmem<D, Sh>::kBytes, work, stream);
}

// Encodes dk/dv's six maps and launches `kernel` (an instance of dkv_cta)
// over the B * KVH * ceil(S / 128) items of `work`; the kernel takes
// `split` after the work list (unused at these widths: P = 1).
template <int D, class T, class Kernel>
inline int launch_dkv(Kernel kernel, const BwdParams& p, int B,
                      const int* work, const DkvSplit& split,
                      cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tlse, tdlt;
  int err = encode_rows<T>(&tq, p.q, D, p.S, p.H, B, p.q_ss, p.q_sh, p.q_sb,
                           kBwdTile);
  if (!err)
    err = encode_rows<T>(&tdo, p.dout, D, p.S, p.H, B, p.do_ss, p.do_sh,
                         p.do_sb, kBwdTile);
  if (!err)
    err = encode_rows<T>(&tk, p.k, D, p.S, p.KVH, B, p.k_ss, p.k_sh, p.k_sb,
                         kBwdRows);
  if (!err)
    err = encode_rows<T>(&tv, p.v, D, p.S, p.KVH, B, p.v_ss, p.v_sh, p.v_sb,
                         kBwdRows);
  if (!err) err = encode_stats(&tlse, p.lse, p.S, B * p.H);
  if (!err) err = encode_stats(&tdlt, p.delta, p.S, B * p.H);
  if (err) return err;
  const cudaError_t e = allow_smem(kernel, DkvSmem<D>::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int items = B * p.KVH * ceil_div(p.S, kBwdRows);
  kernel<<<items, kFwdThreads, DkvSmem<D>::kBytes, stream>>>(
      tq, tdo, tk, tv, tlse, tdlt, p, work, split);
  return (int)cudaGetLastError();
}

// Encodes dkv_cta_wide's six maps (K and V in kWideRows-row boxes, Q, dO,
// lse and delta in kBwdTile-row ones) and launches `kernel` over the B *
// KVH * ceil(S / 64) * P items of `work`; at head_dim 512 dkv_cta_512's
// (Q, dO, lse and delta in kDkv512QRows-row ones), out_chunks CTAs an
// item, each item a cluster; the kClusterD instance dkv_cta_x's, p.D /
// kChunk CTAs an item at width p.D.
template <int D, class T, class Kernel>
inline int launch_dkv_wide(Kernel kernel, const BwdParams& p, int B,
                           const int* work, const DkvSplit& split,
                           cudaStream_t stream) {
  constexpr int kQRows = D > 256 ? kDkv512QRows : kBwdTile;
  int smem;
  if constexpr (D == kClusterD)
    smem = DkvSmemX::kBytes;
  else if constexpr (D > 256)
    smem = DkvSmem512<D>::kBytes;
  else
    smem = DkvWideSmem<D>::kBytes;
  const int width = D == kClusterD ? p.D : D;
  CUtensorMap tq, tdo, tk, tv, tlse, tdlt;
  int err = encode_rows<T>(&tq, p.q, width, p.S, p.H, B, p.q_ss, p.q_sh,
                           p.q_sb, kQRows);
  if (!err)
    err = encode_rows<T>(&tdo, p.dout, width, p.S, p.H, B, p.do_ss, p.do_sh,
                         p.do_sb, kQRows);
  if (!err)
    err = encode_rows<T>(&tk, p.k, width, p.S, p.KVH, B, p.k_ss, p.k_sh,
                         p.k_sb, kWideRows);
  if (!err)
    err = encode_rows<T>(&tv, p.v, width, p.S, p.KVH, B, p.v_ss, p.v_sh,
                         p.v_sb, kWideRows);
  if (!err) err = encode_stats(&tlse, p.lse, p.S, B * p.H, kQRows);
  if (!err) err = encode_stats(&tdlt, p.delta, p.S, B * p.H, kQRows);
  if (err) return err;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int n = D > 256 ? width / kChunk : 1;
  const int items = B * p.KVH * ceil_div(p.S, kWideRows) * split.parts * n;
  if constexpr (D > 256) {
    // A cluster of the n CTAs of each item.
    return launch_clusters(kernel, items, n, smem, stream, tq, tdo, tk, tv,
                           tlse, tdlt, p, work, split);
  } else {
    kernel<<<items, kFwdThreads, smem, stream>>>(tq, tdo, tk, tv, tlse,
                                                 tdlt, p, work, split);
    return (int)cudaGetLastError();
  }
}

// Every dk/dv: dkv_cta's launch at head_dim 64 and 128 (P must be 1),
// dkv_cta_wide's at 256, dkv_cta_512's at 512, dkv_cta_x's past it. P
// must divide H / KVH.
template <int D, class T, class Kernel>
inline int launch_dkv_split(Kernel kernel, const BwdParams& p, int B,
                            const int* work, const DkvSplit& split,
                            cudaStream_t stream) {
  if (split.parts < 1 || split.parts > kMaxParts ||
      (p.H / p.KVH) % split.parts ||
      (D <= 128 && split.parts != 1) || (split.parts > 1 &&
                                         (!split.ws || !split.tickets)))
    return (int)cudaErrorInvalidValue;
  if constexpr (D > 128)
    return launch_dkv_wide<D, T>(kernel, p, B, work, split, stream);
  else
    return launch_dkv<D, T>(kernel, p, B, work, split, stream);
}

template <int D, class T, class Sh = DqBase<D>, class Kernel>
inline int dq_attrs(Kernel kernel, int* out) {
  int smem;
  if constexpr (D == kClusterD)
    smem = DqSmemX::kBytes;
  else if constexpr (D > 256)
    smem = DqSmem512<D>::kBytes;
  else
    smem = DqSmem<D, Sh>::kBytes;
  return kernel_attrs(kernel, smem, kFwdThreads, kProducerRegs,
                      kConsumerRegs, out);
}

// The resident dq: DqResident's CTA, at head_dim 512 dq_cta_chunked_512
// (one CTA an item, no cluster), past it dq_cta_x as every family's.
template <int D, class T, class Kernel>
inline int launch_dq_resident(Kernel kernel, const BwdParams& p, int B,
                              const int* work, cudaStream_t stream) {
  if constexpr (D == kClusterD)
    return launch_dq<D, T>(kernel, p, B, work, stream);
  else if constexpr (D > 256)
    return launch_dq_rows<T>(kernel, p, B, D, kDq512Rows, kDqChunkedKv,
                             DqSmemChunked512<D>::kBytes, work, stream);
  else
    return launch_dq<D, T, DqResident<D>>(kernel, p, B, work, stream);
}

template <int D, class T, class Kernel>
inline int dq_resident_attrs(Kernel kernel, int* out) {
  if constexpr (D == kClusterD)
    return dq_attrs<D, T>(kernel, out);
  else if constexpr (D > 256)
    return kernel_attrs(kernel, DqSmemChunked512<D>::kBytes, kFwdThreads,
                        kProducerRegs, kConsumerRegs, out);
  else
    return dq_attrs<D, T, DqResident<D>>(kernel, out);
}

template <int D, class T, class Kernel>
inline int launch_dq_tri(Kernel kernel, const BwdParams& p, int B,
                         const int* work, cudaStream_t stream) {
  return launch_dq<D, T, DqTri<D>>(kernel, p, B, work, stream);
}

template <int D, class T, class Kernel>
inline int dq_tri_attrs(Kernel kernel, int* out) {
  return dq_attrs<D, T, DqTri<D>>(kernel, out);
}

// Every dk/dv's (dkv_cta_wide's shared memory at head_dim 256,
// dkv_cta_512's at 512, dkv_cta_x's past it).
template <int D, class T, class Kernel>
inline int dkv_attrs(Kernel kernel, int* out) {
  int smem;
  if constexpr (D == kClusterD)
    smem = DkvSmemX::kBytes;
  else if constexpr (D > 256)
    smem = DkvSmem512<D>::kBytes;
  else if constexpr (D > 128)
    smem = DkvWideSmem<D>::kBytes;
  else
    smem = DkvSmem<D>::kBytes;
  const bool x = D == kClusterD;
  return kernel_attrs(kernel, smem, kFwdThreads,
                      x ? kProducerRegs512 : kProducerRegs,
                      x ? kConsumerRegs512 : kConsumerRegs, out);
}

}  // namespace sm90
}  // namespace stpu
