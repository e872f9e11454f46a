// The bf16 tensor-core flash-attention kernel and its combine pass, shared
// by chunk_prefill.cu (a contiguous cache), paged_chunk_prefill.cu (a
// shared page pool, bf16 or int8) and mha_forward.cu (the training
// forward).  The sources differ only in where a key's K/V row lives and how
// it reaches the bf16 tile, so the kernel is a template on a row source:
//   ContigKV          a cache (B, Skv, KV, dh) read in place by strides;
//   PagedKV<E, S>     a pool (n_pages, ps, KV, dh) read through the
//                     slot's row of a (n_slots, n_p) page table; E =
//                     int8_t adds each row's f32 scale, S says how int8
//                     rows are staged;
// and on a query side (QM):
//   ChunkQ   q and out (B, C, H, dh) contiguous (the model's layout); key
//            j is visible to chunk row c iff j <= q_offset + c (and j <
//            Skv: a row past the cache, the padding of a last chunk, sees
//            all Skv).  q_offset and the slot are int32 scalars in device
//            memory, read once by each block, so one captured CUDA graph
//            serves every (slot, offset): q's batch row b reads the
//            source's row slot + b (the cache stripe, or the page-table
//            row);
//   FlatQ    mha_forward's flat layout: q and out (B, H, C, dh) with B the
//            kv rows, H the group and KV = 1 (query row bh reads kv row bh
//            / group); key j visible to row c as key_visible() says
//            (causal or full attention with q_offset, a sliding window);
//            also the f32 row LSE (B, H, C), natural log, m + log(l), and
//            kNegInf for a row that sees no key (its output is 0).  A
//            block's keys start at its first row's window edge; the
//            window's lower edge is masked like the causal one, only on
//            the tiles that cross it.  Under the causal mask the row
//            blocks launch longest (last) first.
//
// Design: flash attention on tensor cores, mma.sync m16n8k16 (bf16 x bf16
// -> f32).  A block owns 128 chunk rows of one query head (64 at dh 256);
// each of its 4 warps owns 32 rows as two 16-row m-tiles, so every K and V
// fragment read from shared memory feeds two products.
//   - S = Q K^T: the Q tile's A fragments come from shared memory by
//     ldmatrix (held in registers across the key loop where they fit, 16
//     rows of dh <= 128; otherwise re-read each tile); the B fragments come
//     from the row-major K tile by ldmatrix.
//   - The online softmax runs on the accumulator fragments: a row lives in
//     the 4 lanes of a quad, so its max is reduced by two __shfl_xor_sync;
//     the scale multiplies the f32 score after the product (Q is not
//     pre-scaled, so the bf16 products are exact), folded into one FMA
//     with the max in log2 units before ex2.  A masked score is -inf, so
//     its probability is exactly 0.  l sums the f32 probabilities per lane
//     (one quad reduction at the end); only the P V operand is rounded to
//     bf16.
//   - O += P V: the A fragments are the S accumulators converted to bf16
//     in registers (no trip through shared memory); the B fragments come
//     from the row-major V tile by ldmatrix.trans, as matmul_tiled.cu reads
//     W.
//   - 64-key K/V tiles fill a 2-stage ring of 16-byte cp.async copies (the
//     next tile loads while one is used; one __syncthreads a tile), rows
//     padded by 16 bytes for conflict-free ldmatrix; a dh that is not a
//     multiple of 16 (<= 256) is zero-filled in shared memory up to 64, 128
//     or 256 (mha_forward.cu: 96 too, whose 208-byte rows are still
//     conflict-free; the products stop at dh either way).  The causal
//     mask runs only on the tiles that cross the block's first row's
//     diagonal.  104 KB of shared memory and 254 registers a thread: two
//     blocks an SM.
//   - At C = 256 on qwen2-7b there are 2 x 28 = 56 such blocks for 132
//     SMs, so chunk_tc_plan splits each block's key range over up to 4
//     blocks (from static shapes and the SM count only; 4 here): each
//     writes its f32 partial (m, l, O) to a workspace the wrapper
//     allocates, and a second kernel combines them in split order.  No sum
//     crosses blocks in any other way, so a relaunch is bit-identical.
//
// Paged rows (PagedKV): before a tile's rows are copied, its page ids are
// in shared memory, one page-table read a page: they ride the previous
// tile's cp.async group as 4-byte copies (the first tile's are read
// before the loop), so resolving a key's row, page_table[b, pos / ps] then
// row pos % ps, costs no wait on device memory.  Any page size works: a
// 64-key tile spans at most 64 / ps + 1 pages.  A key past the block's
// causal edge is never read, so the null page that pads a short table
// never reaches an output.  The fp pool's rows are copied into the bf16
// tiles exactly as a contiguous cache's, and the same launch on a pool
// holding a contiguous cache under identity pages gives chunk_prefill's
// bits.
//
// int8 pools: the int8 values go into the bf16 tiles exactly (-127..127
// fit bf16's 8-bit significand); each key's f32 K scale multiplies its
// score column after Q K^T, and its V scale multiplies P's column before P
// is rounded for P V (l sums the unscaled P).  The scales are staged per
// tile beside the page ids.  Two ways to stage the int8 rows (KVStage),
// timed against each other by scripts/torch_kernel_sweep.py (PERF.md):
//   kRing8   16-byte cp.async copies into a 2-stage ring of int8 tiles, one
//            tile ahead; each tile is widened to the one bf16 K/V tile
//            before its products (a second __syncthreads a tile).  The
//            int8 ring takes the shared memory of the second bf16 stage,
//            so two blocks still fit an SM;
//   kRegs8   plain 16-byte loads of the next tile's int8 rows into
//            registers, issued before the current tile's products and
//            written to the other bf16 stage after them (32 registers a
//            thread at dh 128).
#pragma once

#include "common.cuh"

#include <algorithm>
#include <cmath>

namespace famous {

using bf16 = __nv_bfloat16;

constexpr int kTcMaxSplits = 4;

// The query side of a launch (see the header): ChunkQ, or FlatQ with
// mha_forward's masks, LSE output and block order (reverse: the last row
// block first).
struct ChunkQ {
  static constexpr bool kFlat = false;
  const int* q_offset;  // the chunk's first position
  const int* slot;      // the source row of q's batch row 0; null: 0
};
struct FlatQ {
  static constexpr bool kFlat = true;
  int causal, window, reverse;
  float* lse;
};

// A tile geometry: WARPS warps of MT x 16 chunk rows a block, K/V tiles of
// BK keys in a ring of STAGES, and whether a block's rows are (chunk row,
// query head) pairs of one kv head (PACK).
template <int WARPS_, int MT_, int BK_, int STAGES_, bool PACK_>
struct TcTiles {
  static constexpr int WARPS = WARPS_, MT = MT_, BK = BK_, STAGES = STAGES_;
  static constexpr bool PACK = PACK_;
  static constexpr int BQ = 16 * MT * WARPS, NT = 32 * WARPS;
};

// The serving geometry at a padded head dim DP (PERF.md's sweep): 4 warps
// of 32 rows, 64-key tiles, 2 stages; at DP = 256 the warps own 16 rows,
// since 32 rows of f32 accumulators would not fit in registers.
template <int DP>
using ServeTiles = TcTiles<4, DP <= 128 ? 2 : 1, 64, 2, false>;

// the padded head dim of the bf16 kernel
inline int chunk_dp(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }

// The chunk rows a block owns: rows i in [0, BQ) of block x of head (or
// kv head, PACK) y.  Without PACK row i is chunk row x * BQ + i of query
// head y; with PACK it is pair p = x * BQ + i of kv head y, chunk row
// p / group, query head y * group + p % group.
template <int BQ, bool PACK>
struct ChunkRows {
  int x, y, C, group;
  __device__ int chunk_row(int i) const { return PACK ? (x * BQ + i) / group : x * BQ + i; }
  __device__ int head(int i) const { return PACK ? y * group + (x * BQ + i) % group : y; }
  __device__ bool valid(int i) const { return x * BQ + i < (PACK ? C * group : C); }
  // the last chunk row any valid row of the block holds
  __device__ int last_row() const {
    return PACK ? (min(C * group, (x + 1) * BQ) - 1) / group : min(C, (x + 1) * BQ) - 1;
  }
};

// ---------------------------------------------------------------------------
// row sources
// ---------------------------------------------------------------------------

// How K/V rows reach the bf16 tiles: copied (bf16 rows), or int8 rows
// staged in an int8 ring or in registers and widened (see the header).
enum class KVStage { kCopy, kRing8, kRegs8 };

// A contiguous bf16 cache read in place by strides, dh contiguous.
struct ContigKV {
  static constexpr bool kPaged = false, kScaled = false;
  static constexpr KVStage kStage = KVStage::kCopy;
  using Elem = bf16;
  const bf16* k;
  const bf16* v;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int Skv;
  // 16-byte rows for cp.async: 16-byte aligned bases and strides
  bool vec_ok(int dh) const {
    return dh % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(v) % 16 == 0 && k_sb % 8 == 0 && k_ss % 8 == 0 &&
           k_sh % 8 == 0 && v_sb % 8 == 0 && v_ss % 8 == 0 && v_sh % 8 == 0;
  }
};

// A shared pool (n_pages, ps, KV, dh), contiguous, read through the slot's
// row of a (B, n_p) page table; int8 pools carry f32 (n_pages, ps, KV) row
// scales.  The keys end at n_p * ps.
template <typename E, KVStage S>
struct PagedKV {
  static constexpr bool kPaged = true, kScaled = std::is_same<E, int8_t>::value;
  static constexpr KVStage kStage = S;
  static_assert(kScaled == (S != KVStage::kCopy), "int8 pools are staged, bf16 pools copied");
  using Elem = E;
  const E* k;
  const E* v;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  int ps, n_p, n_pages, Skv;
  bool vec_ok(int dh) const {
    constexpr int epc = 16 / sizeof(E);  // elements per 16-byte chunk
    return dh % epc == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(v) % 16 == 0;
  }
};

// Shared memory of a launch: the Q tile and the bf16 K/V stages (rows of
// DP + 8 elements); paged sources add two tiles' page ids, int8 pools two
// tiles' K and V scales and, kRing8, two int8 K/V tiles (rows of DP bytes)
// in place of the second bf16 stage.
template <int DP, typename G, typename Rows>
struct TcSmem {
  static constexpr int LD = DP + 8, BK = G::BK;
  static constexpr int KV_STAGES = Rows::kStage == KVStage::kRing8 ? 1 : G::STAGES;
  static constexpr int IDS = (BK + 1 + 3) & ~3;  // page ids of a tile, padded to 16 bytes
  static constexpr size_t Q = (size_t)G::BQ * LD * sizeof(bf16);
  static constexpr size_t KV = (size_t)KV_STAGES * 2 * BK * LD * sizeof(bf16);
  static constexpr size_t PIDS = Rows::kPaged ? 2 * IDS * sizeof(int) : 0;
  static constexpr size_t SCALES = Rows::kScaled ? 2 * 2 * BK * sizeof(float) : 0;
  static constexpr size_t I8 = Rows::kStage == KVStage::kRing8 ? 2 * 2 * (size_t)BK * DP : 0;
  static constexpr size_t bytes = Q + KV + PIDS + SCALES + I8;
};

// Four int8 values (one word) widened exactly to two bf16x2 words, on the
// integer and f32 pipes rather than the slower conversion unit: w ^ 0x80
// turns each byte into x + 128, 0x4B0000uu is the f32 2^23 + x + 128, so
// subtracting 2^23 + 128 leaves x, whose bf16 is the f32's upper half (x
// has at most 8 significant bits).
__device__ __forceinline__ void widen4(unsigned w, unsigned& lo, unsigned& hi) {
  w ^= 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// sixteen int8 values widened to bf16 into two 16-byte chunks at dst
__device__ __forceinline__ void widen16(const uint4& x, bf16* dst) {
  uint4 lo, hi;
  widen4(x.x, lo.x, lo.y);
  widen4(x.y, lo.z, lo.w);
  widen4(x.z, hi.x, hi.y);
  widen4(x.w, hi.z, hi.w);
  *reinterpret_cast<uint4*>(dst) = lo;
  *reinterpret_cast<uint4*>(dst + 8) = hi;
}

// Block (x, y, b * splits + z) (FlatQ: ((b * splits + z) * H + y, x)).
// part == nullptr: the block owns its whole key range and writes bf16 out
// (FlatQ: and the LSE); else it owns split z of the range's tiles and
// writes its f32 partial: O to part[(z * RT + row) * dh + d], m (log2
// units) to part[splits * RT * dh + z * RT + row], l after those, RT =
// B * C * H rows in out's order.
template <int DP, typename G, typename Rows, typename QM>
__global__ void __launch_bounds__(G::NT)
chunk_prefill_tc_kernel(const bf16* __restrict__ q, const Rows src, const QM qm,
                        bf16* __restrict__ out, float* __restrict__ part, int B, int C, int H,
                        int KV, int dh, int flat_q_offset, float scale, int splits,
                        int vec) {
  using E = typename Rows::Elem;
  using SM = TcSmem<DP, G, Rows>;
  constexpr int BQ = G::BQ, MT = G::MT, NT = G::NT, BK = G::BK, ST = G::STAGES, LD = DP + 8;
  constexpr int NS = BK / 8;      // 8-key score tiles of a K tile
  constexpr int ND = DP / 8;      // 8-column output tiles
  constexpr int T = BK * LD;      // elements of one K or V tile
  constexpr bool kQRegs = MT * DP <= 128;  // Q's A fragments stay in registers
  constexpr int CPR = DP / 8, RPP = NT / CPR;  // 16-byte bf16 chunks a row; rows a pass
  constexpr bool kRing8 = Rows::kStage == KVStage::kRing8;
  constexpr bool kRegs8 = Rows::kStage == KVStage::kRegs8;
  constexpr int CPR8 = DP / 16, RPP8 = NT / CPR8;  // the same for int8 rows
  constexpr int NR8 = kRegs8 ? 2 * BK / RPP8 : 1;  // int8 chunks a thread holds (K, V)
  // whole rows a pass of 16-byte chunks (else threads from RPP * CPR on
  // idle, as at a padded dh of 96: 12 chunks a row, 10 rows of 128 threads)
  constexpr bool kExact = NT % CPR == 0 && BQ % RPP == 0 && BK % RPP == 0;
  static_assert(NS % 2 == 0, "tile shape");
  static_assert(!Rows::kPaged || (ST == 2 && NT >= 2 * BK && kExact && BK % RPP8 == 0),
                "paged rows: whole rows a pass, a 2-stage ring, a thread per key scale");
  static_assert(!QM::kFlat || (!Rows::kPaged && !G::PACK), "FlatQ: a contiguous source");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* kv_s = q_s + BQ * LD;  // stage s: K at kv_s + 2 s T, V at + T
  int* ids_s = reinterpret_cast<int*>(tc_smem + SM::Q + SM::KV);  // 2 x IDS page ids
  float* sc_s = reinterpret_cast<float*>(tc_smem + SM::Q + SM::KV + SM::PIDS);  // 2 x (K, V) x BK
  int8_t* i8_s = reinterpret_cast<int8_t*>(tc_smem + SM::Q + SM::KV + SM::PIDS + SM::SCALES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma group id, thread in group
  const int group = H / KV;
  int bx = blockIdx.x, by = blockIdx.y, bz = blockIdx.z;
  if constexpr (QM::kFlat) {
    by = blockIdx.x % H, bz = blockIdx.x / H;
    bx = qm.reverse ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  }
  const int b = bz / splits, z = bz % splits;
  // ChunkQ reads its offset and slot from device memory; sb: the source
  // row (cache stripe or page-table row) of q's batch row b
  const int q_offset = [&] {
    if constexpr (QM::kFlat) return flat_q_offset;
    else return __ldg(qm.q_offset);
  }();
  const int sb = [&] {
    if constexpr (QM::kFlat) return b;
    else return b + (qm.slot != nullptr ? __ldg(qm.slot) : 0);
  }();
  const ChunkRows<BQ, G::PACK> rows{bx, by, C, group};
  const int hk = G::PACK ? by : by / group;
  const bool causal = [&] {
    if constexpr (QM::kFlat) return qm.causal != 0;
    else return true;
  }();
  const int window = [&] {
    if constexpr (QM::kFlat) return qm.window;
    else return 0;
  }();

  // the block's keys [kbeg, kend) end at its last row's diagonal (causal)
  // and start at its first row's window edge (tile tb); split z owns tiles
  // [t_lo, t_hi) of them
  const int Skv = src.Skv;
  const int kend = causal ? min(Skv, q_offset + rows.last_row() + 1) : Skv;
  int t_lo, t_hi;
  if constexpr (QM::kFlat) {
    const int tb = window > 0 ? max(0, q_offset + rows.chunk_row(0) - window + 1) / BK : 0;
    const int nt = max(tb, (kend + BK - 1) / BK);
    const int tps = (nt - tb + splits - 1) / splits;
    t_lo = min(nt, tb + z * tps), t_hi = min(nt, t_lo + tps);
  } else {
    const int nt = (kend + BK - 1) / BK;
    const int tps = (nt + splits - 1) / splits;
    t_lo = min(nt, z * tps), t_hi = min(nt, t_lo + tps);
  }
  // tiles past the first row's last key, or before the last row's first
  // key, need the mask
  const int diag_from = causal ? min(q_offset + rows.chunk_row(0), Skv - 1) : Skv - 1;
  const int lo_to = window > 0 ? q_offset + rows.last_row() - window + 1 : 0;

  // 16-byte chunk (tid % CPR) of rows tid / CPR + RPP i: the vec path's
  // share of a tile; columns past dh and rows past the end are zero-filled
  const int lc = (tid % CPR) * 8, lr = kExact || tid < RPP * CPR ? tid / CPR : BQ + BK;
  const bool lc_ok = lc < dh;
  const int lc8 = (tid % CPR8) * 16, lr8 = tid / CPR8;  // int8 rows
  const bool lc8_ok = lc8 < dh;
  uint4 r8[NR8];  // kRegs8: the next tile's int8 chunks, K then V

  // Paged: the pool row of key pos, its page id taken from the ids of a
  // tile whose first page is `first` (slot `slot`); an id outside [0,
  // n_pages) reads the null page 0.  A power-of-two page size (the
  // serving default, 16) divides by a shift.
  const int ps_shift = [&] {
    if constexpr (Rows::kPaged) return (src.ps & (src.ps - 1)) == 0 ? __ffs(src.ps) - 1 : -1;
    else return -1;
  }();
  auto page_of = [&](int pos) {
    if constexpr (Rows::kPaged) return ps_shift >= 0 ? pos >> ps_shift : pos / src.ps;
    else return 0;
  };
  auto pool_row_of = [&](int slot, int first, int pos) -> long long {
    if constexpr (Rows::kPaged) {
      const int pi = page_of(pos);
      int page = ids_s[slot * SM::IDS + pi - first];
      if (page < 0 || page >= src.n_pages) page = 0;
      return ((long long)page * src.ps + (pos - pi * src.ps)) * KV + hk;
    } else {
      return 0;
    }
  };
  // Paged: copy tile u's page ids to slot `slot` (cp.async, in the
  // caller's commit group); only the pages of keys below kend
  auto load_ids = [&](int slot, int u) {
    if constexpr (Rows::kPaged) {
      const int k0 = u * BK, first = page_of(k0);
      const int n = page_of(min(k0 + BK, kend) - 1) - first + 1;
      const int* pt = src.page_table + (long long)sb * src.n_p + first;
      if (tid < n) cp_async4(ids_s + slot * SM::IDS + tid, pt + tid, 4);
    }
  };

  // Issue tile t's K/V rows into stage `stage` (kRing8: the int8 ring's
  // stage; kRegs8: registers, or the bf16 stage on the element path);
  // paged sources also copy its scales and the next tile's page ids.
  auto load_kv = [&](int stage, int t) {
    const int k0 = t * BK;
    bf16* kt = kv_s + 2 * stage * T;
    bf16* vt = kt + T;
    if constexpr (!Rows::kPaged) {
      const bf16* kb = src.k + sb * src.k_sb + hk * src.k_sh;
      const bf16* vb = src.v + sb * src.v_sb + hk * src.v_sh;
      if (vec) {
#pragma unroll
        for (int i = 0; i < (BK + RPP - 1) / RPP; ++i) {
          const int r = lr + i * RPP;
          if (!kExact && r >= BK) break;
          const bool ok = lc_ok && k0 + r < kend;
          cp_async16(kt + r * LD + lc, ok ? kb + (k0 + r) * src.k_ss + lc : kb, ok ? 16 : 0);
          cp_async16(vt + r * LD + lc, ok ? vb + (k0 + r) * src.v_ss + lc : vb, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < BK * DP; i += NT) {
          const int r = i / DP, c = i % DP;
          const bool ok = c < dh && k0 + r < kend;
          kt[r * LD + c] = ok ? kb[(k0 + r) * src.k_ss + c] : __float2bfloat16(0.f);
          vt[r * LD + c] = ok ? vb[(k0 + r) * src.v_ss + c] : __float2bfloat16(0.f);
        }
      }
    } else {
      const int slot = stage;  // ids and scales of tile t live in slot t - t_lo mod 2
      const int first = page_of(k0);
      if (vec) {
        if constexpr (Rows::kStage == KVStage::kCopy) {
#pragma unroll
          for (int i = 0; i < BK / RPP; ++i) {
            const int r = lr + i * RPP, pos = k0 + r;
            const bool ok = lc_ok && pos < kend;
            const long long rw = ok ? pool_row_of(slot, first, pos) * dh + lc : 0;
            cp_async16(kt + r * LD + lc, src.k + rw, ok ? 16 : 0);
            cp_async16(vt + r * LD + lc, src.v + rw, ok ? 16 : 0);
          }
        } else {
          int8_t* k8 = i8_s + 2 * slot * BK * DP;
#pragma unroll
          for (int i = 0; i < BK / RPP8; ++i) {
            const int r = lr8 + i * RPP8, pos = k0 + r;
            const bool ok = lc8_ok && pos < kend;
            const long long rw = ok ? pool_row_of(slot, first, pos) * dh + lc8 : 0;
            if constexpr (kRing8) {
              cp_async16(k8 + r * DP + lc8, src.k + rw, ok ? 16 : 0);
              cp_async16(k8 + (BK + r) * DP + lc8, src.v + rw, ok ? 16 : 0);
            } else {
              const uint4 zero = make_uint4(0, 0, 0, 0);
              r8[i] = ok ? *reinterpret_cast<const uint4*>(src.k + rw) : zero;
              r8[BK / RPP8 + i] = ok ? *reinterpret_cast<const uint4*>(src.v + rw) : zero;
            }
          }
        }
      } else {
        // element by element (a dh that is not whole 16-byte chunks):
        // kRing8 into the int8 ring, the others into the bf16 stage
        for (int i = tid; i < BK * DP; i += NT) {
          const int r = i / DP, c = i % DP, pos = k0 + r;
          const bool ok = c < dh && pos < kend;
          const long long rw = ok ? pool_row_of(slot, first, pos) * dh + c : 0;
          if constexpr (kRing8) {
            int8_t* k8 = i8_s + 2 * slot * BK * DP;
            k8[r * DP + c] = ok ? src.k[rw] : E(0);
            k8[(BK + r) * DP + c] = ok ? src.v[rw] : E(0);
          } else {
            kt[r * LD + c] = __float2bfloat16(ok ? to_f(src.k[rw]) : 0.f);
            vt[r * LD + c] = __float2bfloat16(ok ? to_f(src.v[rw]) : 0.f);
          }
        }
      }
      if constexpr (Rows::kScaled) {
        // thread j < BK: key j's K scale; BK <= j < 2 BK: its V scale
        if (tid < 2 * BK) {
          const int j = tid % BK, pos = k0 + j;
          const bool ok = pos < kend;
          const float* sp = tid < BK ? src.k_scale : src.v_scale;
          cp_async4(sc_s + slot * 2 * BK + tid, ok ? sp + pool_row_of(slot, first, pos) : sp,
                    ok ? 4 : 0);
        }
      }
      if (t + 1 < t_hi) load_ids(slot ^ 1, t + 1);
    }
  };
  // kRegs8: write the int8 chunks held in registers to bf16 stage `stage`
  auto store_regs = [&](int stage) {
    if constexpr (kRegs8) {
      if (!vec) return;  // the element path wrote the stage directly
      bf16* kt = kv_s + 2 * stage * T;
#pragma unroll
      for (int i = 0; i < BK / RPP8; ++i) {
        const int r = lr8 + i * RPP8;
        widen16(r8[i], kt + r * LD + lc8);
        widen16(r8[BK / RPP8 + i], kt + T + r * LD + lc8);
      }
    }
  };
  // kRing8: widen int8 ring stage `slot` into the one bf16 K/V tile (K rows
  // then V rows, 2 BK rows of LD)
  auto widen_ring = [&](int slot) {
    if constexpr (kRing8) {
      const int8_t* k8 = i8_s + 2 * slot * BK * DP;
      for (int c = tid; c < 2 * BK * CPR8; c += NT) {
        const int r = c / CPR8, cc = (c % CPR8) * 16;
        widen16(*reinterpret_cast<const uint4*>(k8 + r * DP + cc), kv_s + r * LD + cc);
      }
    }
  };
  // block row i's row of q and out: (b, c, h), FlatQ (b, h, c)
  auto out_row = [&](int i) -> long long {
    if constexpr (QM::kFlat) return ((long long)b * H + rows.head(i)) * C + rows.chunk_row(i);
    else return ((long long)b * C + rows.chunk_row(i)) * H + rows.head(i);
  };
  auto q_row = [&](int i) { return q + out_row(i) * dh; };

  // Paged: the first tile's page ids, read before anything is copied
  if constexpr (Rows::kPaged) {
    if (t_lo < t_hi) {
      const int k0 = t_lo * BK, first = page_of(k0);
      const int n = page_of(min(k0 + BK, kend) - 1) - first + 1;
      if (tid < n) ids_s[tid] = src.page_table[(long long)sb * src.n_p + first + tid];
    }
    __syncthreads();
  }

  // Q and the first STAGES - 1 tiles, one commit group each (Q with the first)
  if (vec) {
#pragma unroll
    for (int i = 0; i < (BQ + RPP - 1) / RPP; ++i) {
      const int r = lr + i * RPP;
      if (!kExact && r >= BQ) break;
      const bool ok = lc_ok && rows.valid(r);
      cp_async16(q_s + r * LD + lc, ok ? q_row(r) + lc : q, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < BQ * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      q_s[r * LD + c] = c < dh && rows.valid(r) ? q_row(r)[c] : __float2bfloat16(0.f);
    }
  }
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (t_lo + s < t_hi) load_kv(s, t_lo + s);
    cp_async_commit();
  }
  if (t_lo < t_hi) store_regs(0);

  // this lane's rows: (m-tile mt, h) is block row warp * 16 MT + 16 mt + g + 8 h
  // and its visible keys [lo, lim] (FlatQ: lo from the window)
  const int w0 = warp * 16 * MT;
  int lim[MT][2], lo[QM::kFlat ? MT : 1][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = q_offset + rows.chunk_row(w0 + 16 * mt + g + 8 * h);
      lim[mt][h] = causal ? min(qp, Skv - 1) : Skv - 1;
      if constexpr (QM::kFlat) lo[mt][h] = window > 0 ? qp - window + 1 : 0;
    }
  const float sl = scale * kLog2e;  // scores in log2 units
  float o[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = kNegInf, l[mt][0] = l[mt][1] = 0.f;
  unsigned qf[kQRegs ? MT * DP / 16 : 1][4];
  auto q_frag = [&](unsigned (&a)[4], int mt, int ks) {
    ldmatrix_x4(a, q_s + (w0 + 16 * mt + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
  };

  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo;
    cp_async_wait<ST - 2>();  // tile t (and Q) have landed
    __syncthreads();          // ... for every warp; tile t - 1's stage is free
    widen_ring(i % 2);
    if (t + ST - 1 < t_hi) load_kv((i + ST - 1) % ST, t + ST - 1);
    cp_async_commit();
    if constexpr (kRing8) __syncthreads();  // the widened tile
    const bf16* k_t = kv_s + 2 * (kRing8 ? 0 : i % ST) * T;
    const bf16* v_t = k_t + T;
    const float* ksc = sc_s + (i % 2) * 2 * BK;  // int8 pools: tile t's K scales, then V's
    const float* vsc = ksc + BK;
    if constexpr (kQRegs) {
      if (i == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int ks = 0; ks < DP / 16; ++ks) q_frag(qf[mt * (DP / 16) + ks], mt, ks);
      }
    }

    // S = Q K^T over the 16-deep slices of dh that hold data; each K
    // fragment feeds the warp's MT m-tiles
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      if (ks * 16 >= dh) break;
      unsigned kf[NS][2];
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        // matrices: (keys 8j.., d 0-7), (8j.., d 8-15), (8j+8.., d 0-7),
        // (8j+8.., d 8-15): the b0 / b1 of key tiles j and j + 1
        unsigned r[4];
        ldmatrix_x4(r, k_t + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                           ((lane >> 3) & 1) * 8);
        kf[j][0] = r[0], kf[j][1] = r[1], kf[j + 1][0] = r[2], kf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[mt * (DP / 16) + ks][e];
        } else {
          q_frag(a, mt, ks);
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) mma_bf16(s[mt][j], a, kf[j][0], kf[j][1]);
      }
    }
    // int8 pools: each key's K scale onto its score column
    if constexpr (Rows::kScaled) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 kx = *reinterpret_cast<const float2*>(ksc + 8 * j + 2 * tq);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          s[mt][j][0] *= kx.x, s[mt][j][1] *= kx.y;
          s[mt][j][2] *= kx.x, s[mt][j][3] *= kx.y;
        }
      }
    }

    // online softmax; accumulator element e of key tile j is row g (+8 for
    // e >= 2) of its m-tile, key t * BK + 8j + 2 tq (+1 for odd e); a
    // masked score is -inf, so its probability is exactly 0 even while its
    // row has seen no key (m stays at the finite -1e30)
    const int k0 = t * BK;
    const bool diag = k0 + BK - 1 > diag_from || (QM::kFlat && k0 < lo_to);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (diag) {
            const int kp = k0 + 8 * j + 2 * tq + (e & 1);
            bool off = kp > lim[mt][e >> 1];
            if constexpr (QM::kFlat) off = off || kp < lo[mt][e >> 1];
            if (off) s[mt][j][e] = -INFINITY;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[mt][h], mx[h] * sl);
        const float corr = ex2(m[mt][h] - m_new);
        m[mt][h] = m_new;
        l[mt][h] *= corr;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[mt][n][2 * h] *= corr;
          o[mt][n][2 * h + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[mt][j][e], sl, -m[mt][e >> 1]));
          s[mt][j][e] = p;
          l[mt][e >> 1] += p;
        }
    }

    // O += P V: P's A fragments from the accumulators, rounded to bf16
    // (int8 pools: each key's V scale onto P's column first); each V
    // fragment feeds the warp's MT m-tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float2 v0 = make_float2(1.f, 1.f), v1 = v0;
      if constexpr (Rows::kScaled) {
        v0 = *reinterpret_cast<const float2*>(vsc + 16 * kk + 2 * tq);
        v1 = *reinterpret_cast<const float2*>(vsc + 16 * kk + 8 + 2 * tq);
      }
      unsigned pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float(&s0)[4] = s[mt][2 * kk];
        const float(&s1)[4] = s[mt][2 * kk + 1];
        if constexpr (Rows::kScaled) {
          pa[mt][0] = pack_bf16(s0[0] * v0.x, s0[1] * v0.y);
          pa[mt][1] = pack_bf16(s0[2] * v0.x, s0[3] * v0.y);
          pa[mt][2] = pack_bf16(s1[0] * v1.x, s1[1] * v1.y);
          pa[mt][3] = pack_bf16(s1[2] * v1.x, s1[3] * v1.y);
        } else {
          pa[mt][0] = pack_bf16(s0[0], s0[1]);
          pa[mt][1] = pack_bf16(s0[2], s0[3]);
          pa[mt][2] = pack_bf16(s1[0], s1[1]);
          pa[mt][3] = pack_bf16(s1[2], s1[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        if (n * 8 >= dh) break;
        unsigned r[4];
        ldmatrix_x4_trans(r, v_t + (kk * 16 + (lane & 15)) * LD + n * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][n], pa[mt], r[0], r[1]);
          mma_bf16(o[mt][n + 1], pa[mt], r[2], r[3]);
        }
      }
    }
    // kRegs8: the next tile, loaded before the products, to its bf16 stage
    if (t + 1 < t_hi) store_regs((i + 1) % 2);
  }
  cp_async_wait<0>();

  const long long RT = (long long)B * C * H;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[mt][h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      const int i = w0 + 16 * mt + g + 8 * h;
      if (!rows.valid(i)) continue;
      const long long row = out_row(i);
      // columns col and col + 1 of each 8-column tile; pairs go as one
      // store where dh is even (so the pair is aligned)
      if (part) {
        float* po = part + ((long long)z * RT + row) * dh;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int col = n * 8 + 2 * tq;
          const float x0 = o[mt][n][2 * h], x1 = o[mt][n][2 * h + 1];
          if (col + 1 < dh && dh % 2 == 0) {
            *reinterpret_cast<float2*>(po + col) = make_float2(x0, x1);
          } else {
            if (col < dh) po[col] = x0;
            if (col + 1 < dh) po[col + 1] = x1;
          }
        }
        if (tq == 0) {
          part[splits * RT * dh + z * RT + row] = m[mt][h];
          part[splits * RT * (dh + 1) + z * RT + row] = lh;
        }
      } else {
        if constexpr (QM::kFlat)
          if (tq == 0) qm.lse[row] = lh > 0.f ? m[mt][h] * kLn2 + logf(lh) : kNegInf;
        const float inv = 1.f / fmaxf(lh, 1e-30f);
        bf16* po = out + row * dh;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int col = n * 8 + 2 * tq;
          const float x0 = o[mt][n][2 * h] * inv, x1 = o[mt][n][2 * h + 1] * inv;
          if (col + 1 < dh && dh % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(po + col) = __floats2bfloat162_rn(x0, x1);
          } else {
            if (col < dh) po[col] = __float2bfloat16(x0);
            if (col + 1 < dh) po[col + 1] = __float2bfloat16(x1);
          }
        }
      }
    }
}

// The second pass of a split launch: out = sum_z w_z O_z / max(sum_z w_z
// l_z, 1e-30), w_z = 2^(m_z - max m), the splits summed in order z = 0,
// 1, ... (fixed, so deterministic); with lse (FlatQ) also the row's LSE,
// max m ln 2 + log(l) (kNegInf where l = 0).  A warp per row: every lane
// forms the row's weights, then the lanes stride over its dh columns.
// Rows and QM only name the instantiation, so a profile tells the
// contiguous, paged and flat passes apart.
constexpr int kCombineWarps = 8;

template <typename Rows, typename QM>
__global__ void __launch_bounds__(32 * kCombineWarps)
chunk_prefill_combine_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                             float* __restrict__ lse, long long RT, int dh, int splits) {
  const long long row = (long long)blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (row >= RT) return;
  const int lane = threadIdx.x & 31;
  const float* ms = part + splits * RT * dh;
  const float* ls = ms + splits * RT;
  float w[kTcMaxSplits];
  float M = kNegInf, l = 0.f;
#pragma unroll
  for (int z = 0; z < kTcMaxSplits; ++z)
    if (z < splits) M = fmaxf(M, ms[z * RT + row]);
#pragma unroll
  for (int z = 0; z < kTcMaxSplits; ++z) {
    w[z] = z < splits ? exp2f(ms[z * RT + row] - M) : 0.f;
    if (z < splits) l += w[z] * ls[z * RT + row];
  }
  if (lse != nullptr && lane == 0) lse[row] = l > 0.f ? M * kLn2 + logf(l) : kNegInf;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = lane; d < dh; d += 32) {
    float a = 0.f;
#pragma unroll
    for (int z = 0; z < kTcMaxSplits; ++z)
      if (z < splits) a += w[z] * part[(z * RT + row) * dh + d];
    out[row * dh + d] = __float2bfloat16(a * inv);
  }
}

// A tile geometry's launch on a row source and query side, both passes
// (the second when splits > 1).  vec: q 16-byte aligned with dh % 8 == 0
// and the source's rows whole 16-byte chunks (src.vec_ok).  q_offset is
// FlatQ's; ChunkQ's is in device memory (qm.q_offset).
template <int DP, typename G, typename Rows, typename QM>
static cudaError_t launch_tc(const bf16* q, const Rows& src, const QM& qm, bf16* out,
                             float* part, int splits, int B, int C, int H, int KV, int dh,
                             int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = TcSmem<DP, G, Rows>::bytes;
  auto kernel = chunk_prefill_tc_kernel<DP, G, Rows, QM>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int vec = dh % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 && src.vec_ok(dh);
  const int rows = G::PACK ? C * (H / KV) : C;
  const int nx = (rows + G::BQ - 1) / G::BQ;
  const dim3 grid = QM::kFlat ? dim3(H * B * splits, nx)
                              : dim3(nx, G::PACK ? KV : H, B * splits);
  // each split's (O, m, l) for every (slot, chunk row, head)
  const Cover rows_c{rows, G::BQ}, heads_c{(long long)H * B * splits, 1};
  record_launch(kernel, "chunk_prefill_tc_kernel", grid, G::NT, smem,
                QM::kFlat ? heads_c : rows_c,
                QM::kFlat ? rows_c : Cover{G::PACK ? KV : H, 1},
                QM::kFlat ? Cover{} : Cover{(long long)B * splits, 1},
                splits > 1 ? (long long)splits * B * C * H * (dh + 2) : 0);
  kernel<<<grid, G::NT, smem, stream>>>(q, src, qm, out, splits > 1 ? part : nullptr, B, C, H,
                                        KV, dh, q_offset, scale, splits, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long RT = (long long)B * C * H;
  const long long blocks = (RT + kCombineWarps - 1) / kCombineWarps;
  float* lse = nullptr;
  if constexpr (QM::kFlat) lse = qm.lse;
  record_launch(chunk_prefill_combine_kernel<Rows, QM>, "chunk_prefill_combine_kernel",
                dim3(static_cast<unsigned>(blocks)), 32 * kCombineWarps, 0, {RT, kCombineWarps});
  chunk_prefill_combine_kernel<Rows, QM>
      <<<static_cast<unsigned>(blocks), 32 * kCombineWarps, 0, stream>>>(part, out, lse, RT,
                                                                         dh, splits);
  return cudaGetLastError();
}

// The chunk kernels' launch (ChunkQ: q_offset and slot in device memory)
template <int DP, typename G, typename Rows>
static cudaError_t launch_chunk_tc(const bf16* q, const Rows& src, const ChunkQ& qm, bf16* out,
                                   float* part, int splits, int B, int C, int H, int KV, int dh,
                                   float scale, cudaStream_t stream) {
  return launch_tc<DP, G, Rows, ChunkQ>(q, src, qm, out, part, splits, B, C, H, KV, dh, 0,
                                        scale, stream);
}

// The serving geometry at the padded head dim 64, 128 or 256
template <typename Rows>
static cudaError_t launch_chunk_serve(const bf16* q, const Rows& src, const ChunkQ& qm,
                                      bf16* out, float* part, int splits, int B, int C, int H,
                                      int KV, int dh, float scale, cudaStream_t stream) {
  if (chunk_dp(dh) == 64)
    return launch_chunk_tc<64, ServeTiles<64>>(q, src, qm, out, part, splits, B, C, H, KV, dh,
                                               scale, stream);
  if (chunk_dp(dh) == 128)
    return launch_chunk_tc<128, ServeTiles<128>>(q, src, qm, out, part, splits, B, C, H, KV,
                                                 dh, scale, stream);
  return launch_chunk_tc<256, ServeTiles<256>>(q, src, qm, out, part, splits, B, C, H, KV, dh,
                                               scale, stream);
}

// The key-range split count of the serving geometry, from static shapes
// and the SM count only: as many splits (at most 4) as keep the blocks of
// one launch within two per SM, each split at least 4 tiles of Skv deep.
// *ws_elems: the f32 workspace of the split partials (splits x B x C x H x
// (dh + 2); 0 for one split), which the wrapper allocates.
inline int chunk_tc_plan(int B, int C, int H, int dh, int Skv, int sms, long long* ws_elems) {
  const int bq = chunk_dp(dh) <= 128 ? ServeTiles<128>::BQ : ServeTiles<256>::BQ;
  const long long blocks = (long long)B * H * ((C + bq - 1) / bq);
  int splits = static_cast<int>(std::min<long long>(kTcMaxSplits, 2LL * sms / blocks));
  splits = std::max(1, std::min(splits, (Skv + 63) / 64 / 4));
  *ws_elems = splits > 1 ? (long long)splits * B * C * H * (dh + 2) : 0;
  return splits;
}

}  // namespace famous
