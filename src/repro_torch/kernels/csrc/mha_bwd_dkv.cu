// mha_bwd_dkv: the key and value gradients of the flash backward, summed
// over each kv head's group of query heads, recomputing the probabilities
// from the forward's saved row log-sum-exp.
//
//   q, dout      (BH, Sq, dh)    contiguous, BH = BKV * group
//   k, v         (BKV, Skv, dh)  contiguous
//   lse, delta   (BH, Sq)        f32; delta = sum_d dO * O (computed by the wrapper)
//   dk, dv       (BKV, Skv, dh)  f32
//
//   P  = exp(scale * Q K^T - lse)  on the mask, 0 off it
//   dv = sum over the group's heads of P^T dO
//   dk = scale * sum over the group's heads of (P * (dO V^T - delta))^T Q
//
// Replaces: src/repro/kernels/attention/mha.py, mha_backward's second
// pallas_call (the Pallas kernel _mha_bwd_dkv_kernel).  There the grid is
// (BH, Skv/block_k, Sq/block_q) with the query axis sequential, carrying
// dk/dv accumulators in VMEM; the kernel writes per-query-head f32 dk/dv
// of shape (BH, Skv, dh) and the wrapper sums them over the group.  Here a
// block owns a tile of keys of one kv head and loops over the group's
// query heads and over the query tiles that can see those keys (the causal
// edge starts the loop, the window ends it), with both accumulators in
// registers: the same sum without the group-times-larger intermediate.
// The arithmetic is the TPU kernel's: the product is scaled, P is
// recomputed as 0 off the mask, and dk is scaled once on the way out.
//
// What bounds it on an H100: operations (8 * BH * Sq * Skv * dh FLOP,
// halved when causal: 60 GFLOP for qwen2-7b at S=2048, 61 us at the bf16
// tensor-core peak; 91 us counting the two extra products of the hi/lo
// split below) far more than bytes.
//
// Design, bf16: FlashAttention-2's dK/dV loop on tensor cores (mma.sync
// m16n8k16, bf16 x bf16 -> f32).  A block owns 64 keys of one kv head,
// 16 a warp; their K and V tiles stay in shared memory for the whole loop.
// The group's (query head, 64-row query tile) work items stream through a
// 2-stage ring of 16-byte cp.async copies: Q, dO and their lse and delta
// rows, the next item loading while one is used.  Per item each warp
// computes S^T = K Q^T and dP^T = V dO^T (K and V fragments by ldmatrix,
// Q and dO as B fragments by ldmatrix), then P^T = 2^(scale log2(e) S^T -
// log2(e) lse) and dS^T = P^T (dP^T - delta) in the accumulator layout,
// keys as rows, where they become A fragments in registers with no trip
// through shared memory; then dV += P^T dO and dK += dS^T Q, with dO and Q
// as B fragments by ldmatrix.trans.  The mask runs only on items whose
// tile crosses an edge (causal, window, Sq, Skv).
//
// Precision: the gate is f32 math on the same bf16 inputs at 1e-4.  Q, K,
// V and dO are exact in bf16, so S^T and dP^T take one product each; P^T
// and dS^T are f32 values, and rounding them to bf16 once misses the gate
// by up to 107x at qwen2-7b's shape (PERF.md).  So each goes in as a hi +
// lo pair of bf16 operands (hi = bf16(x), lo = bf16(x - hi); split_bf16 in
// common.cuh) and takes two products into the same f32 accumulator: six
// tensor-core products an item where a plain bf16 design takes four.
//
// Work split: 64-key blocks give qwen2-7b only 4 x 32 = 128 blocks for
// 132 SMs, and under the causal mask the block holding key 0 has 32 times
// the items of the last; and a long run of items loses accuracy in the
// tensor cores' f32 accumulator (dkv_tc_plan).  So
// famous_mha_bwd_dkv_plan splits each key block's items (head-major, then
// query tiles) into `splits` consecutive runs, from static shapes and the
// SM count only; each run writes its f32 (dk, dv) partial to a workspace
// the wrapper allocates, and a second pass sums them in run order and
// scales dk.  No sum crosses blocks in any
// other way, so a relaunch is bit-identical.  Key blocks launch in order,
// the longest (first, under the causal mask) first.  The geometry, the
// split rule and the hi/lo products were chosen by
// scripts/torch_kernel_sweep.py (PERF.md).
//
// Design, bf16 above dh 128 (recurrentgemma-2b's 256; DkvWide): the same
// algebra, items, runs and split passes, in a geometry that fits.  Two
// 64-key x 256 f32 accumulators are 128 KB of registers, 256 a thread at
// one warp to a 16-key strip.  So two warps share each strip: each
// computes S^T and dP^T for half the item's rows over the whole head dim,
// writes P^T and dS^T as hi + lo pairs of bf16 tiles to shared memory,
// and after a barrier each takes the strip's four tiles over all the
// rows as A fragments by ldmatrix and accumulates half of dk's and dv's
// columns (128 registers).  64 keys a block, 64-row items in one stage
// (169 KB, one block an SM; two stages would pass 227 KB).  dh is padded
// to 256 with zero columns.  recurrentgemma-2b has one kv head, so its
// key blocks alone (21 at 1292 tokens, 64 at 4096) leave most of the 132
// SMs idle: the plan splits the items into up to 16 runs there
// (dkv_tc_plan).  scripts/torch_kernel_sweep.py (mha256) chose the
// geometry and the split rule among 64 / 32 keys, 64 / 32 rows, two /
// four warps a strip and one / two stages (PERF.md).
//
// f32: the CUDA-core kernel of the first port, in full f32 FMAs (no TF32):
// 32 keys a block, staged Q, dO, K and V tiles, the group's heads looped
// inside the block, in one run (no split), at every dh: its
// instantiation for dh <= 256 takes 140 KB of shared memory at 256, so
// one block an SM.  bf16 never reaches it.
#include "common.cuh"

#include <algorithm>

namespace famous {

constexpr int kKvBQ = 32;       // query rows per tile
constexpr int kKvBK = 32;       // keys per block
constexpr int kKvThreads = 256;
constexpr int kKvLanesPerRow = kKvThreads / kKvBK;   // 8 threads per key row

__host__ __device__ inline size_t dkv_smem_floats(int dh) {
  return 2 * (size_t)kKvBK * (dh + 1)      // K and V tiles (padded rows)
         + 2 * (size_t)kKvBQ * dh          // Q and dO tiles
         + 2 * (size_t)kKvBQ * (kKvBK + 1) // P and dS
         + 2 * (size_t)kKvBQ;              // lse, delta
}

// MaxDh: the largest head dim of the instantiation (kMhaTcMaxDh, or
// kMhaMaxDh above it); each thread holds MaxDh / 8 columns of dk and dv.
// At MaxDh 128 two blocks per SM (shared memory allows three) leave 128
// registers a thread: the two accumulators and the unrolled P/dS reads fit
// without spilling, where the default allocation capped at 64 and spilled.
// At 256 shared memory allows one block, and the 64 accumulators get up to
// 255 registers.
template <typename T, int MaxDh>
__global__ void __launch_bounds__(kKvThreads, MaxDh <= kMhaTcMaxDh ? 2 : 1)
mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int Sq, int Skv, int dh, int group, int causal,
                   int window, int q_offset, float scale) {
  constexpr int kKvDPT = MaxDh / kKvLanesPerRow;  // head-dim entries per thread
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * kKvBK, bkv = blockIdx.y;
  float* k_s = smem;
  float* v_s = k_s + kKvBK * (dh + 1);
  float* q_s = v_s + kKvBK * (dh + 1);
  float* o_s = q_s + kKvBQ * dh;               // dO
  float* p_s = o_s + kKvBQ * dh;
  float* ds_s = p_s + kKvBQ * (kKvBK + 1);
  float* lse_s = ds_s + kKvBQ * (kKvBK + 1);
  float* dl_s = lse_s + kKvBQ;
  const int tid = threadIdx.x;

  const long long kbase = (long long)bkv * Skv + k0;
  for (int i = tid; i < kKvBK * dh; i += kKvThreads) {
    const int j = i / dh, d = i % dh;
    const bool in = k0 + j < Skv;
    k_s[j * (dh + 1) + d] = in ? to_f(k[kbase * dh + i]) : 0.f;
    v_s[j * (dh + 1) + d] = in ? to_f(v[kbase * dh + i]) : 0.f;
  }
  const int row = tid / kKvLanesPerRow, dlane = tid % kKvLanesPerRow;  // row = key
  float dk_acc[kKvDPT], dv_acc[kKvDPT];
#pragma unroll
  for (int i = 0; i < kKvDPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // query rows that can see one of the block's keys: [qbeg, qend)
  const int kmax = min(Skv, k0 + kKvBK) - 1;
  const int qbeg = causal ? max(0, k0 - q_offset) : 0;
  const int qend = window > 0 ? min(Sq, kmax + window - q_offset) : Sq;

  for (int g = 0; g < group; ++g) {
    const long long hbase = (long long)(bkv * group + g) * Sq;
    for (int q0 = qbeg; q0 < qend; q0 += kKvBQ) {
      __syncthreads();  // the previous tile's P, dS, Q and dO are consumed
      for (int i = tid; i < kKvBQ * dh; i += kKvThreads) {
        const bool in = q0 + i / dh < Sq;
        q_s[i] = in ? to_f(q[(hbase + q0) * dh + i]) : 0.f;
        o_s[i] = in ? to_f(dout[(hbase + q0) * dh + i]) : 0.f;
      }
      if (tid < kKvBQ) {
        const bool in = q0 + tid < Sq;
        lse_s[tid] = in ? lse[hbase + q0 + tid] : 0.f;
        dl_s[tid] = in ? delta[hbase + q0 + tid] : 0.f;
      }
      __syncthreads();
      // P and dS for (query r, key j); a warp shares one query row, lane = key
      for (int i = tid; i < kKvBQ * kKvBK; i += kKvThreads) {
        const int r = i / kKvBK, j = i % kKvBK, qi = q0 + r, pos = k0 + j;
        const float* qr = q_s + r * dh;
        const float* orow = o_s + r * dh;
        const float* kr = k_s + j * (dh + 1);
        const float* vr = v_s + j * (dh + 1);
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < dh; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(orow[d], vr[d], dp);
        }
        const bool ok = qi < Sq && pos < Skv &&
                        key_visible(q_offset + qi, pos, causal, window);
        const float p = ok ? expf(s * scale - lse_s[r]) : 0.f;
        p_s[r * (kKvBK + 1) + j] = p;
        ds_s[r * (kKvBK + 1) + j] = p * (dp - dl_s[r]);
      }
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q; 8 threads per key, head-dim entries strided by 8
#pragma unroll
      for (int i = 0; i < kKvDPT; ++i) {
        const int d = dlane + i * kKvLanesPerRow;
        if (d >= dh) break;
        float a = dv_acc[i], b = dk_acc[i];
#pragma unroll 8
        for (int r = 0; r < kKvBQ; ++r) {
          a = fmaf(p_s[r * (kKvBK + 1) + row], o_s[r * dh + d], a);
          b = fmaf(ds_s[r * (kKvBK + 1) + row], q_s[r * dh + d], b);
        }
        dv_acc[i] = a;
        dk_acc[i] = b;
      }
    }
  }

  if (k0 + row < Skv) {
    float* ok_ = dk + (kbase + row) * dh;
    float* ov = dv + (kbase + row) * dh;
#pragma unroll
    for (int i = 0; i < kKvDPT; ++i) {
      const int d = dlane + i * kKvLanesPerRow;
      if (d >= dh) break;
      ok_[d] = dk_acc[i] * scale;
      ov[d] = dv_acc[i];
    }
  }
}

template <typename T, int MaxDh>
static cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, float* dk, float* dv,
                              int BKV, int group, int Sq, int Skv, int dh, int causal,
                              int window, int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats(dh) * sizeof(float);
  cudaError_t e = allow_smem(mha_bwd_dkv_kernel<T, MaxDh>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Skv + kKvBK - 1) / kKvBK, BKV);
  record_launch(mha_bwd_dkv_kernel<T, MaxDh>, "mha_bwd_dkv_kernel", grid, kKvThreads, smem,
                {Skv, kKvBK}, {BKV, 1});
  mha_bwd_dkv_kernel<T, MaxDh><<<grid, kKvThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dk, dv, Sq, Skv, dh, group, causal, window,
      q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// A geometry: BK keys a block (16 a warp), BQ query rows an item, head
// dim padded to DP, P^T and dS^T as hi + lo pairs (HILO) or rounded once
// (the sweep's timing variant, which fails the gate).  Shared memory: K
// and V resident, then 2 stages of (Q, dO) tiles and (lse, delta) rows;
// rows of DP + 8 elements for conflict-free ldmatrix.
template <int DP_, int BK_, int BQ_, bool HILO_>
struct DkvTiles {
  static constexpr int DP = DP_, BK = BK_, BQ = BQ_, NT = 2 * BK, LD = DP + 8;
  static constexpr bool HILO = HILO_;
  static constexpr size_t KV = 2 * (size_t)BK * LD * sizeof(bf16);
  static constexpr size_t QO = 2 * 2 * (size_t)BQ * LD * sizeof(bf16);
  static constexpr size_t bytes = KV + QO + 2 * 2 * (size_t)BQ * sizeof(float);
};

// Block (bkv * splits + z, key block y).  part == nullptr: one run, dk
// and dv written scaled; else run z's f32 partials go to part[z * N + i]
// (dk) and part[(splits + z) * N + i] (dv), N = BKV * Skv * dh.
template <typename G>
__global__ void __launch_bounds__(G::NT, G::NT == 128 ? 2 : 1)
mha_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part,
                      int BKV, int group, int Sq, int Skv, int dh, int causal, int window,
                      int q_offset, float scale, int splits, int vec) {
  constexpr int DP = G::DP, BK = G::BK, BQ = G::BQ, NT = G::NT, LD = G::LD;
  constexpr int NQ = BQ / 8;   // 8-query tiles of S^T and dP^T
  constexpr int ND = DP / 8;   // 8-column tiles of dK and dV
  constexpr int CPR = DP / 8;  // 16-byte chunks of a row
  static_assert((BK * CPR) % NT == 0 && (BQ * CPR) % NT == 0 && NQ % 2 == 0 && ND % 2 == 0,
                "tile shape");
  static_assert(2 * BQ <= NT, "a thread per lse or delta value");
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(dkv_smem);
  bf16* v_s = k_s + BK * LD;
  bf16* ring = v_s + BK * LD;  // stage s: Q at ring + 2 s BQ LD, dO after it
  float* rows_s = reinterpret_cast<float*>(dkv_smem + G::KV + G::QO);  // stage s: lse, delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma group id, thread in group
  const int bkv = blockIdx.x / splits, z = blockIdx.x % splits;
  const int kb0 = blockIdx.y * BK, w0 = warp * 16;
  const long long kvrow = (long long)bkv * Skv;

  // the query rows that see one of the block's keys, [qbeg, qend), in
  // tiles [qt_lo, qt_lo + nqt) of each of the group's heads; items (head,
  // tile) head-major, run z owning [i_lo, i_hi)
  const int kmax = min(Skv, kb0 + BK) - 1;
  const int qbeg = causal ? max(0, kb0 - q_offset) : 0;
  const int qend = window > 0 ? min(Sq, kmax + window - q_offset) : Sq;
  const int qt_lo = qbeg / BQ, nqt = max(0, (qend + BQ - 1) / BQ - qt_lo);
  const int items = group * nqt, ips = (items + splits - 1) / splits;
  const int i_lo = min(items, z * ips), i_hi = min(items, i_lo + ips);

  auto load_tile = [&](bf16* dst, const bf16* src, long long row0, int R, int valid) {
    load_rows_bf16<DP, LD, NT>(dst, src, row0, R, valid, dh, vec);
  };
  auto q0_of = [&](int it) { return (qt_lo + it % nqt) * BQ; };
  auto load_item = [&](int stage, int it) {
    const int q0 = q0_of(it);
    const long long row0 = (long long)(bkv * group + it / nqt) * Sq + q0;
    bf16* qt = ring + stage * 2 * BQ * LD;
    load_tile(qt, q, row0, BQ, Sq - q0);
    load_tile(qt + BQ * LD, dout, row0, BQ, Sq - q0);
    if (tid < 2 * BQ) {
      const int j = tid % BQ;
      const float* src = tid < BQ ? lse : delta;
      const bool ok = q0 + j < Sq;
      cp_async4(rows_s + stage * 2 * BQ + tid, ok ? src + row0 + j : src, ok ? 4 : 0);
    }
  };

  // K, V and the first item: one commit group
  load_tile(k_s, k, kvrow + kb0, BK, Skv - kb0);
  load_tile(v_s, v, kvrow + kb0, BK, Skv - kb0);
  if (i_lo < i_hi) load_item(0, i_lo);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float sl = scale * kLog2e;  // scores in log2 units
  const int kr0 = kb0 + w0 + g;     // this lane's keys: kr0, kr0 + 8

  for (int it = i_lo; it < i_hi; ++it) {
    const int st = (it - i_lo) & 1;
    cp_async_wait<0>();  // item it (and K, V) have landed
    __syncthreads();     // ... for every warp; item it - 1's stage is free
    if (it + 1 < i_hi) load_item(st ^ 1, it + 1);
    cp_async_commit();
    const bf16* qt = ring + st * 2 * BQ * LD;
    const bf16* ot = qt + BQ * LD;
    const float* lt = rows_s + st * 2 * BQ;
    const float* dt = lt + BQ;
    const int q0 = q0_of(it);

    // S^T = K Q^T and dP^T = V dO^T over the 16-deep slices of dh that
    // hold data: the warp's 16 keys against the item's BQ query rows
    float sa[NQ][4], pa[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      if (ks * 16 >= dh) break;
      unsigned ak[4], av[4];
      ldmatrix_x4(ak, k_s + (w0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4(av, v_s + (w0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        // matrices: (rows 8j.., d 0-7), (8j.., d 8-15), (8j+8.., d 0-7),
        // (8j+8.., d 8-15): the b0 / b1 of query tiles j and j + 1
        const int off = (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                        ((lane >> 3) & 1) * 8;
        unsigned r[4];
        ldmatrix_x4(r, qt + off);
        mma_bf16(sa[j], ak, r[0], r[1]);
        mma_bf16(sa[j + 1], ak, r[2], r[3]);
        ldmatrix_x4(r, ot + off);
        mma_bf16(pa[j], av, r[0], r[1]);
        mma_bf16(pa[j + 1], av, r[2], r[3]);
      }
    }

    // P^T and dS^T in place; element e of query tile j is key kr0 (+8 for
    // e >= 2), query q0 + 8j + 2tq (+1 for odd e).  Off the mask P is 0
    // (an empty row's lse of -1e30 never reaches a visible key).
    const bool edge = q0 + BQ > Sq || kb0 + BK > Skv || (causal && kb0 + BK - 1 > q_offset + q0) ||
                      (window > 0 && kb0 <= q_offset + q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int qc = 8 * j + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + qc);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
        float p = ex2(fmaf(sa[j][e], sl, -lv * kLog2e));
        if (edge) {
          const int kp = kr0 + 8 * (e >> 1), qi = q0 + qc + (e & 1);
          if (qi >= Sq || kp >= Skv || !key_visible(q_offset + qi, kp, causal, window)) p = 0.f;
        }
        sa[j][e] = p;
        pa[j][e] = p * (pa[j][e] - dl);
      }
    }

    // dV += P^T dO and dK += dS^T Q: A fragments from the accumulators
    // (16 queries = query tiles 2kk, 2kk + 1), each a hi + lo pair; B
    // fragments of dO and Q by ldmatrix.trans, each feeding both halves
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      unsigned ph[4], pl[4], dh_[4], dl_[4];
      split_bf16(sa[2 * kk][0], sa[2 * kk][1], ph[0], pl[0]);
      split_bf16(sa[2 * kk][2], sa[2 * kk][3], ph[1], pl[1]);
      split_bf16(sa[2 * kk + 1][0], sa[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(sa[2 * kk + 1][2], sa[2 * kk + 1][3], ph[3], pl[3]);
      split_bf16(pa[2 * kk][0], pa[2 * kk][1], dh_[0], dl_[0]);
      split_bf16(pa[2 * kk][2], pa[2 * kk][3], dh_[1], dl_[1]);
      split_bf16(pa[2 * kk + 1][0], pa[2 * kk + 1][1], dh_[2], dl_[2]);
      split_bf16(pa[2 * kk + 1][2], pa[2 * kk + 1][3], dh_[3], dl_[3]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        if (n * 8 >= dh) break;
        const int off = (kk * 16 + (lane & 15)) * LD + n * 8 + (lane >> 4) * 8;
        unsigned r[4];
        ldmatrix_x4_trans(r, ot + off);
        mma_bf16(dva[n], ph, r[0], r[1]);
        mma_bf16(dva[n + 1], ph, r[2], r[3]);
        if constexpr (G::HILO) {
          mma_bf16(dva[n], pl, r[0], r[1]);
          mma_bf16(dva[n + 1], pl, r[2], r[3]);
        }
        ldmatrix_x4_trans(r, qt + off);
        mma_bf16(dka[n], dh_, r[0], r[1]);
        mma_bf16(dka[n + 1], dh_, r[2], r[3]);
        if constexpr (G::HILO) {
          mma_bf16(dka[n], dl_, r[0], r[1]);
          mma_bf16(dka[n + 1], dl_, r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // rows kr0 (+8), columns 8n + 2tq (+1); pairs as one store where dh is
  // even (so the pair is aligned)
  const long long N = (long long)BKV * Skv * dh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kr0 + 8 * h;
    if (key >= Skv) continue;
    const long long at = (kvrow + key) * dh;
    float* pk = part ? part + z * N + at : dk + at;
    float* pv = part ? part + (splits + z) * N + at : dv + at;
    const float sk = part ? 1.f : scale;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * tq;
      const float k0 = dka[n][2 * h] * sk, k1 = dka[n][2 * h + 1] * sk;
      const float v0 = dva[n][2 * h], v1 = dva[n][2 * h + 1];
      if (col + 1 < dh && dh % 2 == 0) {
        *reinterpret_cast<float2*>(pk + col) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(pv + col) = make_float2(v0, v1);
      } else {
        if (col < dh) pk[col] = k0, pv[col] = v0;
        if (col + 1 < dh) pk[col + 1] = k1, pv[col + 1] = v1;
      }
    }
  }
}

// The second pass of a split launch: dk = scale * sum_z dk_z, dv = sum_z
// dv_z, the runs summed in order z = 0, 1, ... (fixed, so deterministic).
__global__ void __launch_bounds__(256)
mha_bwd_dkv_combine_kernel(const float* __restrict__ part, float* __restrict__ dk,
                           float* __restrict__ dv, long long N, int splits, float scale) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < N; i += 256LL * gridDim.x) {
    float a = 0.f, b = 0.f;
    for (int z = 0; z < splits; ++z) {
      a += part[z * N + i];
      b += part[(splits + z) * N + i];
    }
    dk[i] = a * scale;
    dv[i] = b;
  }
}

// One geometry's launch, both passes (the second when splits > 1)
template <typename G>
static cudaError_t launch_dkv_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                                 const float* lse, const float* delta, float* dk, float* dv,
                                 float* part, int splits, int BKV, int group, int Sq, int Skv,
                                 int dh, int causal, int window, int q_offset, float scale,
                                 cudaStream_t stream) {
  auto kernel = mha_bwd_dkv_tc_kernel<G>;
  cudaError_t e = allow_smem(kernel, G::bytes);
  if (e != cudaSuccess) return e;
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = dh % 8 == 0 && al(q) && al(k) && al(v) && al(dout);
  const dim3 grid(BKV * splits, (Skv + G::BK - 1) / G::BK);
  // each split's dk and dv partials over (BKV, Skv, dh)
  record_launch(kernel, "mha_bwd_dkv_tc_kernel", grid, G::NT, G::bytes,
                {(long long)BKV * splits, 1}, {Skv, G::BK}, {},
                splits > 1 ? 2LL * splits * BKV * Skv * dh : 0);
  kernel<<<grid, G::NT, G::bytes, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                            splits > 1 ? part : nullptr, BKV, group, Sq, Skv, dh,
                                            causal, window, q_offset, scale, splits, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long N = (long long)BKV * Skv * dh;
  const long long blocks = std::min<long long>((N + 255) / 256, 8192);
  record_launch(mha_bwd_dkv_combine_kernel, "mha_bwd_dkv_combine_kernel",
                dim3(static_cast<unsigned>(blocks)), 256, 0, {N, 256, true});
  mha_bwd_dkv_combine_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(part, dk, dv, N,
                                                                               splits, scale);
  return cudaGetLastError();
}

// The geometry at the padded head dim: 64 keys a block, 64-row items
template <int DP>
using DkvServe = DkvTiles<DP, 64, 64, true>;

static cudaError_t launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                                   const float* lse, const float* delta, float* dk, float* dv,
                                   float* part, int splits, int BKV, int group, int Sq, int Skv,
                                   int dh, int causal, int window, int q_offset, float scale,
                                   cudaStream_t s) {
  switch (mha_tc_dp(dh)) {
    case 64:
      return launch_dkv_tc<DkvServe<64>>(q, k, v, dout, lse, delta, dk, dv, part, splits, BKV,
                                         group, Sq, Skv, dh, causal, window, q_offset, scale, s);
    case 96:
      return launch_dkv_tc<DkvServe<96>>(q, k, v, dout, lse, delta, dk, dv, part, splits, BKV,
                                         group, Sq, Skv, dh, causal, window, q_offset, scale, s);
    default:
      return launch_dkv_tc<DkvServe<128>>(q, k, v, dout, lse, delta, dk, dv, part, splits, BKV,
                                          group, Sq, Skv, dh, causal, window, q_offset, scale, s);
  }
}

// ---------------------------------------------------------------------------
// bf16 above dh 128: tensor cores, the head dim split across warps
// ---------------------------------------------------------------------------

// A geometry above kMhaTcMaxDh, dh padded to kMhaMaxDh: BK keys a block,
// BQ query rows an item, WC warps to each 16-key strip, ST ring stages of
// (Q, dO) tiles.  In an item, warp (strip, c) computes S^T and dP^T for
// its strip's keys and the item's rows [c QW, (c + 1) QW), and then dK
// and dV for its strip's keys and the columns [c CW, (c + 1) CW): 128
// accumulators a thread at WC = 2, where one warp a strip would need 256.
// Shared memory: K and V resident, ST stages of (Q, dO) tiles (rows of
// DP + 8 elements) and (lse, delta) rows, then P^T and dS^T as hi and lo
// (BK, BQ) bf16 tiles (rows of BQ + 8), through which the warps of a strip
// trade their rows' products.  MINB: the blocks an SM that shared memory
// allows (1 or 2), for __launch_bounds__.
template <int BK_, int BQ_, int WC_, int ST_>
struct DkvWide {
  static constexpr int DP = kMhaMaxDh, BK = BK_, BQ = BQ_, WC = WC_, ST = ST_;
  static constexpr int NT = BK / 16 * WC * 32, LD = DP + 8, LDP = BQ + 8;
  static constexpr int QW = BQ / WC, CW = DP / WC;
  static constexpr size_t KV = 2 * (size_t)BK * LD * sizeof(bf16);
  static constexpr size_t QO = ST * 2 * (size_t)BQ * LD * sizeof(bf16);
  static constexpr size_t ROWS = ST * 2 * (size_t)BQ * sizeof(float);
  static constexpr size_t bytes = KV + QO + ROWS + 4 * (size_t)BK * LDP * sizeof(bf16);
  static constexpr int MINB = 2 * (bytes + 1024) <= 233472 ? 2 : 1;
};

// Block (bkv * splits + z, key block y); the items, runs, masks and
// partials are mha_bwd_dkv_tc_kernel's.
template <typename G>
__global__ void __launch_bounds__(G::NT, G::MINB)
mha_bwd_dkv_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part,
                        int BKV, int group, int Sq, int Skv, int dh, int causal, int window,
                        int q_offset, float scale, int splits, int vec) {
  constexpr int DP = G::DP, BK = G::BK, BQ = G::BQ, WC = G::WC, ST = G::ST, NT = G::NT;
  constexpr int LD = G::LD, LDP = G::LDP, QW = G::QW, CW = G::CW;
  constexpr int NQ = QW / 8;   // 8-query tiles of S^T and dP^T a warp
  constexpr int ND = CW / 8;   // 8-column tiles of dK and dV a warp
  static_assert(NQ % 2 == 0 && ND % 2 == 0 && BK % 16 == 0 && BQ % 16 == 0, "tile shape");
  static_assert(ST == 1 || ST == 2, "ring stages");
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(dkv_smem);
  bf16* v_s = k_s + BK * LD;
  bf16* ring = v_s + BK * LD;  // stage s: Q at ring + 2 s BQ LD, dO after it
  float* rows_s = reinterpret_cast<float*>(dkv_smem + G::KV + G::QO);  // stage s: lse, delta
  bf16* p_hi = reinterpret_cast<bf16*>(dkv_smem + G::KV + G::QO + G::ROWS);
  bf16* p_lo = p_hi + BK * LDP;
  bf16* d_hi = p_lo + BK * LDP;
  bf16* d_lo = d_hi + BK * LDP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma group id, thread in group
  const int w0 = warp / WC * 16, c = warp % WC;
  const int qc0 = c * QW, dc = c * CW;     // the warp's rows of an item, its columns
  const int bkv = blockIdx.x / splits, z = blockIdx.x % splits;
  const int kb0 = blockIdx.y * BK;
  const long long kvrow = (long long)bkv * Skv;

  const int kmax = min(Skv, kb0 + BK) - 1;
  const int qbeg = causal ? max(0, kb0 - q_offset) : 0;
  const int qend = window > 0 ? min(Sq, kmax + window - q_offset) : Sq;
  const int qt_lo = qbeg / BQ, nqt = max(0, (qend + BQ - 1) / BQ - qt_lo);
  const int items = group * nqt, ips = (items + splits - 1) / splits;
  const int i_lo = min(items, z * ips), i_hi = min(items, i_lo + ips);

  auto load_tile = [&](bf16* dst, const bf16* src, long long row0, int R, int valid) {
    load_rows_bf16<DP, LD, NT>(dst, src, row0, R, valid, dh, vec);
  };
  auto q0_of = [&](int it) { return (qt_lo + it % nqt) * BQ; };
  auto load_item = [&](int stage, int it) {
    const int q0 = q0_of(it);
    const long long row0 = (long long)(bkv * group + it / nqt) * Sq + q0;
    bf16* qt = ring + stage * 2 * BQ * LD;
    load_tile(qt, q, row0, BQ, Sq - q0);
    load_tile(qt + BQ * LD, dout, row0, BQ, Sq - q0);
    for (int i = tid; i < 2 * BQ; i += NT) {
      const int j = i % BQ;
      const float* src = i < BQ ? lse : delta;
      const bool ok = q0 + j < Sq;
      cp_async4(rows_s + stage * 2 * BQ + i, ok ? src + row0 + j : src, ok ? 4 : 0);
    }
  };

  load_tile(k_s, k, kvrow + kb0, BK, Skv - kb0);
  load_tile(v_s, v, kvrow + kb0, BK, Skv - kb0);
  if (i_lo < i_hi) load_item(0, i_lo);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float sl = scale * kLog2e;
  const int kr0 = kb0 + w0 + g;     // this lane's keys: kr0, kr0 + 8

  for (int it = i_lo; it < i_hi; ++it) {
    const int st = ST == 2 ? (it - i_lo) & 1 : 0;
    cp_async_wait<0>();  // item it (and K, V) have landed
    __syncthreads();     // ... for every warp; item it - 1's stage and products are free
    if constexpr (ST == 2) {
      if (it + 1 < i_hi) load_item(st ^ 1, it + 1);
      cp_async_commit();
    }
    const bf16* qt = ring + st * 2 * BQ * LD;
    const bf16* ot = qt + BQ * LD;
    const float* lt = rows_s + st * 2 * BQ;
    const float* dt = lt + BQ;
    const int q0 = q0_of(it);

    // S^T = K Q^T and dP^T = V dO^T: the strip's 16 keys against the
    // warp's QW rows of the item
    float sa[NQ][4], pa[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      if (ks * 16 >= dh) break;
      unsigned ak[4], av[4];
      ldmatrix_x4(ak, k_s + (w0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4(av, v_s + (w0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        const int off = (qc0 + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                        ((lane >> 3) & 1) * 8;
        unsigned r[4];
        ldmatrix_x4(r, qt + off);
        mma_bf16(sa[j], ak, r[0], r[1]);
        mma_bf16(sa[j + 1], ak, r[2], r[3]);
        ldmatrix_x4(r, ot + off);
        mma_bf16(pa[j], av, r[0], r[1]);
        mma_bf16(pa[j + 1], av, r[2], r[3]);
      }
    }

    // P^T and dS^T; element e of query tile j is key kr0 (+8 for e >= 2),
    // query q0 + qc0 + 8j + 2tq (+1 for odd e); both go to shared memory
    // as hi + lo pairs
    const bool edge = q0 + BQ > Sq || kb0 + BK > Skv || (causal && kb0 + BK - 1 > q_offset + q0) ||
                      (window > 0 && kb0 <= q_offset + q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int qc = qc0 + 8 * j + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + qc);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
        float p = ex2(fmaf(sa[j][e], sl, -lv * kLog2e));
        if (edge) {
          const int kp = kr0 + 8 * (e >> 1), qi = q0 + qc + (e & 1);
          if (qi >= Sq || kp >= Skv || !key_visible(q_offset + qi, kp, causal, window)) p = 0.f;
        }
        sa[j][e] = p;
        pa[j][e] = p * (pa[j][e] - dl);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned hi, lo;
        const int at = (w0 + g + 8 * h) * LDP + qc;
        split_bf16(sa[j][2 * h], sa[j][2 * h + 1], hi, lo);
        *reinterpret_cast<unsigned*>(p_hi + at) = hi;
        *reinterpret_cast<unsigned*>(p_lo + at) = lo;
        split_bf16(pa[j][2 * h], pa[j][2 * h + 1], hi, lo);
        *reinterpret_cast<unsigned*>(d_hi + at) = hi;
        *reinterpret_cast<unsigned*>(d_lo + at) = lo;
      }
    }
    __syncthreads();  // the strip's P^T and dS^T over all BQ rows

    // dV[:, dc, dc + CW) += P^T dO and dK[:, dc, dc + CW) += dS^T Q: A
    // fragments (hi and lo) by ldmatrix, B fragments of dO and Q by
    // ldmatrix.trans, each feeding both halves
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      unsigned ph[4], pl[4], dh_[4], dl_[4];
      const int at = (w0 + (lane & 15)) * LDP + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(ph, p_hi + at);
      ldmatrix_x4(pl, p_lo + at);
      ldmatrix_x4(dh_, d_hi + at);
      ldmatrix_x4(dl_, d_lo + at);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        if (dc + n * 8 >= dh) break;
        const int off = (kk * 16 + (lane & 15)) * LD + dc + n * 8 + (lane >> 4) * 8;
        unsigned r[4];
        ldmatrix_x4_trans(r, ot + off);
        mma_bf16(dva[n], ph, r[0], r[1]);
        mma_bf16(dva[n + 1], ph, r[2], r[3]);
        mma_bf16(dva[n], pl, r[0], r[1]);
        mma_bf16(dva[n + 1], pl, r[2], r[3]);
        ldmatrix_x4_trans(r, qt + off);
        mma_bf16(dka[n], dh_, r[0], r[1]);
        mma_bf16(dka[n + 1], dh_, r[2], r[3]);
        mma_bf16(dka[n], dl_, r[0], r[1]);
        mma_bf16(dka[n + 1], dl_, r[2], r[3]);
      }
    }
    if constexpr (ST == 1) {
      __syncthreads();  // every warp is done with item it
      if (it + 1 < i_hi) load_item(0, it + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  const long long N = (long long)BKV * Skv * dh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kr0 + 8 * h;
    if (key >= Skv) continue;
    const long long at = (kvrow + key) * dh;
    float* pk = part ? part + z * N + at : dk + at;
    float* pv = part ? part + (splits + z) * N + at : dv + at;
    const float sk = part ? 1.f : scale;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = dc + n * 8 + 2 * tq;
      const float k0 = dka[n][2 * h] * sk, k1 = dka[n][2 * h + 1] * sk;
      const float v0 = dva[n][2 * h], v1 = dva[n][2 * h + 1];
      if (col + 1 < dh && dh % 2 == 0) {
        *reinterpret_cast<float2*>(pk + col) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(pv + col) = make_float2(v0, v1);
      } else {
        if (col < dh) pk[col] = k0, pv[col] = v0;
        if (col + 1 < dh) pk[col + 1] = k1, pv[col + 1] = v1;
      }
    }
  }
}

// One wide geometry's launch, both passes (the second when splits > 1)
template <typename G>
static cudaError_t launch_dkv_wide(const bf16* q, const bf16* k, const bf16* v,
                                   const bf16* dout, const float* lse, const float* delta,
                                   float* dk, float* dv, float* part, int splits, int BKV,
                                   int group, int Sq, int Skv, int dh, int causal, int window,
                                   int q_offset, float scale, cudaStream_t stream) {
  auto kernel = mha_bwd_dkv_wide_kernel<G>;
  cudaError_t e = allow_smem(kernel, G::bytes);
  if (e != cudaSuccess) return e;
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = dh % 8 == 0 && al(q) && al(k) && al(v) && al(dout);
  const dim3 grid(BKV * splits, (Skv + G::BK - 1) / G::BK);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  record_launch(kernel, "mha_bwd_dkv_wide_kernel", grid, G::NT, G::bytes,
                {(long long)BKV * splits, 1}, {Skv, G::BK}, {},
                splits > 1 ? 2LL * splits * BKV * Skv * dh : 0);
  kernel<<<grid, G::NT, G::bytes, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                            splits > 1 ? part : nullptr, BKV, group, Sq, Skv, dh,
                                            causal, window, q_offset, scale, splits, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long N = (long long)BKV * Skv * dh;
  const long long blocks = std::min<long long>((N + 255) / 256, 8192);
  record_launch(mha_bwd_dkv_combine_kernel, "mha_bwd_dkv_combine_kernel",
                dim3(static_cast<unsigned>(blocks)), 256, 0, {N, 256, true});
  mha_bwd_dkv_combine_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(part, dk, dv, N,
                                                                               splits, scale);
  return cudaGetLastError();
}

// The geometry above dh 128: 64 keys a block (two warps to a 16-key
// strip), 64-row items in one stage (169 KB of shared memory, one block
// an SM)
using DkvWideServe = DkvWide<64, 64, 2, 1>;

// The split count of a bf16 geometry of BK-key blocks over BQ-row items,
// from static shapes and the SM count only: the larger of two needs.
//  - Accuracy: runs of at most kDkvRunRows query rows (64 items of 64
//    rows at dh <= 128), at every shape.  The tensor cores' f32
//    accumulation loses more than an IEEE f32 sum (truncated adds), so a
//    run's error grows with its length: at qwen2-7b's shape one run of
//    224 items missed the 1e-4 gate (4.9e-4), two runs gave 2.3e-4 and
//    four 1.3e-4 of absolute error (PERF.md); the second pass sums the
//    runs in IEEE f32.  A key block's items are at most group x ceil(Sq /
//    BQ) (the block that every query sees), so that many over the cap
//    bounds every block's runs.
//  - Occupancy: where the key blocks (BKV x Skv / BK) number fewer than
//    `fill`, as many splits as bring them to about `fill`, at most `cap`:
//    at dh <= 128 four an SM (two waves of two), at most
//    kDkvOccupancySplits; above it kDkvWideFill an SM (the wide geometry
//    holds one), at most kDkvWideOccupancySplits, which a single kv head
//    needs (recurrentgemma-2b: 21 key blocks at 1292 tokens).
// *ws_elems: the f32 workspace of the partials (2 x splits x BKV x Skv x
// dh; 0 for one split).  ref.dkv_splits restates it.
constexpr int kDkvRunRows = 4096, kDkvOccupancySplits = 8;
constexpr int kDkvWideFill = 2, kDkvWideOccupancySplits = 16;

inline int dkv_split_rule(int BKV, int group, int Sq, int Skv, int dh, int BK, int BQ,
                          long long fill, int cap, long long* ws_elems) {
  const long long blocks = (long long)BKV * ((Skv + BK - 1) / BK);
  const long long items = (long long)group * ((Sq + BQ - 1) / BQ);
  const int run_items = kDkvRunRows / BQ;
  long long splits = (items + run_items - 1) / run_items;
  if (blocks < fill) splits = std::max(splits, std::min<long long>(cap, fill / blocks));
  splits = std::max(1LL, std::min<long long>(splits, items));
  *ws_elems = splits > 1 ? 2LL * splits * BKV * Skv * dh : 0;
  return static_cast<int>(splits);
}

inline int dkv_tc_plan(int BKV, int group, int Sq, int Skv, int dh, int sms,
                       long long* ws_elems) {
  if (dh > kMhaTcMaxDh)
    return dkv_split_rule(BKV, group, Sq, Skv, dh, DkvWideServe::BK, DkvWideServe::BQ,
                          (long long)kDkvWideFill * sms, kDkvWideOccupancySplits, ws_elems);
  return dkv_split_rule(BKV, group, Sq, Skv, dh, 64, 64, 4LL * sms, kDkvOccupancySplits,
                        ws_elems);
}

}  // namespace famous

// The split count of the bf16 kernels (dkv_tc_plan), 1 for f32.  *ws_elems: the f32 workspace of the partials (0 for one split), which
// the wrapper allocates.
extern "C" int famous_mha_bwd_dkv_plan(int dtype, int BH, int BKV, int Sq, int Skv, int dh,
                                       int sms, long long* ws_elems) {
  using namespace famous;
  *ws_elems = 0;
  if (dtype != kBF16 || dh <= 0 || dh > kMhaMaxDh || BKV <= 0 || BH % BKV != 0 || Skv <= 0)
    return 1;
  return dkv_tc_plan(BKV, BH / BKV, Sq, Skv, dh, sms, ws_elems);
}

// part: the workspace of famous_mha_bwd_dkv_plan when splits > 1, else
// null.
extern "C" int famous_mha_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  float* dk, float* dv, void* part, int splits, int BH, int BKV,
                                  int Sq, int Skv, int dh, int causal, int window, int q_offset,
                                  float scale, void* stream) {
  using namespace famous;
  if (BKV <= 0 || BH % BKV != 0 || BKV > 65535 || dh <= 0 || dh > kMhaMaxDh || splits < 1 ||
      (long long)BKV * splits > 0x7fffffffLL ||
      (splits > 1 && (part == nullptr || dtype != kBF16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Skv <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = BH / BKV;
  cudaError_t e;
  if (dtype == kF32 && dh <= kMhaTcMaxDh)
    e = launch_dkv<float, kMhaTcMaxDh>(q, k, v, dout, lse, delta, dk, dv, BKV, group, Sq, Skv,
                                       dh, causal, window, q_offset, scale, s);
  else if (dtype == kF32)
    e = launch_dkv<float, kMhaMaxDh>(q, k, v, dout, lse, delta, dk, dv, BKV, group, Sq, Skv, dh,
                                     causal, window, q_offset, scale, s);
  else if (dtype == kBF16 && dh > kMhaTcMaxDh)
    e = launch_dkv_wide<DkvWideServe>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                                      lse, delta, dk, dv, static_cast<float*>(part), splits, BKV,
                                      group, Sq, Skv, dh, causal, window, q_offset, scale, s);
  else if (dtype == kBF16)
    e = launch_dkv_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
                        dk, dv, static_cast<float*>(part), splits, BKV, group, Sq, Skv, dh,
                        causal, window, q_offset, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
