// mha_bwd_dq: the query gradient of the flash backward, recomputing the
// probabilities from the forward's saved row log-sum-exp.
//
//   q, dout      (BH, Sq, dh)    contiguous, BH = BKV * group
//   k, v         (BKV, Skv, dh)  contiguous; query row bh reads kv row bh / group
//   lse, delta   (BH, Sq)        f32; delta = sum_d dO * O (computed by the wrapper)
//   dq           (BH, Sq, dh)    f32
//
//   P  = exp(scale * Q K^T - lse)  on the mask, 0 off it
//   dS = P * (dO V^T - delta)
//   dq = scale * dS K
//
// Replaces: src/repro/kernels/attention/mha.py, mha_backward's first
// pallas_call (the Pallas kernel _mha_bwd_dq_kernel).  There the grid is
// (BH, Sq/block_q, Skv/block_k) with the key axis sequential, carrying the
// f32 dq accumulator in VMEM across key tiles.  Here a block owns a tile
// of query rows of one head and loops over the key tiles its rows can see
// (the forward's causal and window bounds), with the accumulator in
// registers; ragged edges are masked.  The arithmetic is the TPU kernel's:
// q is not pre-scaled, the product is scaled, P is recomputed as 0 off the
// mask (so a row with no visible key gets dq = 0), and dq is scaled once
// on the way out.
//
// What bounds it on an H100: operations (6 * BH * Sq * Skv * dh FLOP,
// halved when causal: 45 GFLOP for qwen2-7b at S=2048, 46 us at the bf16
// tensor-core peak; 61 us counting the second dS K product of the hi/lo
// split below) far more than bytes (q, k, v, dO, lse, delta read and dq
// written once).
//
// Design, bf16: FlashAttention-2's dQ loop on tensor cores (mma.sync
// m16n8k16, bf16 x bf16 -> f32).  A block owns 64 query rows of one query
// head, 16 a warp; their Q and dO tiles stay in shared memory and their
// lse and delta values in registers for the whole loop.  64-key K and V
// tiles of the kv head stream through a 2-stage ring of 16-byte cp.async
// copies (the next tile loads while one is used; one __syncthreads a
// tile).  Per tile each warp computes S = Q K^T and dP = dO V^T (Q and dO
// fragments by ldmatrix, K and V as B fragments by ldmatrix from their
// row-major tiles), then P = 2^(scale log2(e) S - log2(e) lse) and dS = P
// (dP - delta) in the accumulator layout, where they become A fragments in
// registers with no trip through shared memory; then dQ += dS K, with K as
// B fragments by ldmatrix.trans.  The mask runs only on tiles that cross
// an edge (causal, window, Skv).  Row blocks launch longest (last, under
// the causal mask) first.  dh 96 (famous-bert) runs natively, as in the
// forward and dk/dv.
//
// Precision: the gate is f32 math on the same bf16 inputs at 1e-4.  Q, K,
// V and dO are exact in bf16, so S and dP take one product each; dS is an
// f32 value, and rounding it to bf16 once misses the gate (as dS^T does in
// mha_bwd_dkv.cu), so it goes in as a hi + lo pair of bf16 operands
// (split_bf16 in common.cuh): two products into the same f32 accumulator.
// The tensor cores' f32 accumulation is not IEEE (truncated adds), so its
// error grows with the length of a run: dq_tc_plan caps a block's run at
// kDqRunKeys keys (mha_bwd_dkv.cu's 64 items of 64 rows), splitting the key
// range of longer rows into ordered runs.
//
// Work split: famous_mha_bwd_dq_plan cuts each row block's key tiles into
// `splits` consecutive runs, from static shapes and the SM count only: as
// many as the run cap needs, and more where the row blocks alone fill less
// than one wave of two blocks an SM.  Each run writes its f32 partial to a
// workspace the wrapper allocates, and a second pass sums them in run
// order in IEEE f32 and scales.  No sum crosses blocks in any other way,
// so a relaunch is bit-identical.  The geometry, the split rule and the
// hi/lo products were chosen by scripts/torch_kernel_sweep.py (PERF.md).
//
// Design, bf16 above dh 128 (recurrentgemma-2b's 256; DqWide): the same
// algebra, runs and split passes, in a geometry that fits.  One warp to a
// 16-row strip would hold 128 dq accumulators a thread at dh 256 besides S
// and dP, and 2-stage 64-key K and V rings beside the Q and dO tiles
// would pass the 227 KB of shared memory a block may have.  So two warps
// share each strip: each computes S and dP for half the tile's keys over
// the whole head dim, writes its dS as a hi + lo pair of bf16 tiles to
// shared memory, and after a barrier each takes the strip's dS over all
// the keys as A fragments by ldmatrix and accumulates half of dq's
// columns (64 registers).  64 rows a block, 32-key tiles in one stage:
// 109 KB, so two blocks an SM, each hiding the other's loads and
// barriers.  dh is padded to 256 with zero columns (dh 200 runs too).
// scripts/torch_kernel_sweep.py (mha256) chose the geometry and its
// split rule among 64 / 32 rows, 64 / 32 keys, two / four warps a strip
// and one / two stages (PERF.md).
//
// f32: the CUDA-core kernel of the first port, in full f32 FMAs (no TF32):
// 32 rows a block, 32-key tiles of Q, dO, K and V staged in shared memory,
// in one run (no split), at every dh: its instantiation for dh <= 256
// takes 136 KB of shared memory at 256, one block an SM.  bf16 never
// reaches it.
#include "common.cuh"

#include <algorithm>

namespace famous {

constexpr int kDqBQ = 32;       // query rows per block
constexpr int kDqBK = 32;       // keys per tile
constexpr int kDqThreads = 256;
constexpr int kDqLanesPerRow = kDqThreads / kDqBQ;   // 8 threads per row in dS @ K

__host__ __device__ inline size_t dq_smem_floats(int dh) {
  return 2 * (size_t)kDqBQ * dh            // Q and dO tiles
         + 2 * (size_t)kDqBK * (dh + 1)    // K and V tiles (padded rows)
         + (size_t)kDqBQ * (kDqBK + 1)     // dS
         + 2 * (size_t)kDqBQ;              // lse, delta
}

// MaxDh: the largest head dim of the instantiation (kMhaTcMaxDh, or
// kMhaMaxDh above it); each thread holds MaxDh / 8 dq columns.
template <typename T, int MaxDh>
__global__ void __launch_bounds__(kDqThreads)
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Skv,
                  int dh, int group, int causal, int window, int q_offset, float scale) {
  constexpr int kDqDPT = MaxDh / kDqLanesPerRow;  // head-dim entries per thread
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kDqBQ, bh = blockIdx.y;
  const int bkv = bh / group;
  float* q_s = smem;
  float* o_s = q_s + kDqBQ * dh;              // dO
  float* k_s = o_s + kDqBQ * dh;
  float* v_s = k_s + kDqBK * (dh + 1);
  float* ds_s = v_s + kDqBK * (dh + 1);
  float* lse_s = ds_s + kDqBQ * (kDqBK + 1);
  float* dl_s = lse_s + kDqBQ;
  const int tid = threadIdx.x;

  const long long rbase = (long long)bh * Sq + q0;
  for (int i = tid; i < kDqBQ * dh; i += kDqThreads) {
    const bool in = q0 + i / dh < Sq;
    q_s[i] = in ? to_f(q[rbase * dh + i]) : 0.f;
    o_s[i] = in ? to_f(dout[rbase * dh + i]) : 0.f;
  }
  if (tid < kDqBQ) {
    const bool in = q0 + tid < Sq;
    lse_s[tid] = in ? lse[rbase + tid] : 0.f;
    dl_s[tid] = in ? delta[rbase + tid] : 0.f;
  }
  const int row = tid / kDqLanesPerRow, dlane = tid % kDqLanesPerRow;
  float acc[kDqDPT];
#pragma unroll
  for (int i = 0; i < kDqDPT; ++i) acc[i] = 0.f;

  const int qlo = q_offset + q0, qhi = q_offset + min(Sq, q0 + kDqBQ) - 1;
  const int kend = causal ? min(Skv, qhi + 1) : Skv;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  const T* kb = k + (long long)bkv * Skv * dh;
  const T* vb = v + (long long)bkv * Skv * dh;
  __syncthreads();

  for (int k0 = kbeg; k0 < kend; k0 += kDqBK) {
    for (int i = tid; i < kDqBK * dh; i += kDqThreads) {
      const int j = i / dh, d = i % dh, pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < kend) {
        kx = to_f(kb[(long long)pos * dh + d]);
        vx = to_f(vb[(long long)pos * dh + d]);
      }
      k_s[j * (dh + 1) + d] = kx;
      v_s[j * (dh + 1) + d] = vx;
    }
    __syncthreads();
    // S and dP = dO V^T together; a warp shares one row, lane = key
    for (int i = tid; i < kDqBQ * kDqBK; i += kDqThreads) {
      const int r = i / kDqBK, j = i % kDqBK, pos = k0 + j;
      const float* qr = q_s + r * dh;
      const float* orow = o_s + r * dh;
      const float* kr = k_s + j * (dh + 1);
      const float* vr = v_s + j * (dh + 1);
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < dh; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(orow[d], vr[d], dp);
      }
      const bool ok = q0 + r < Sq && pos < kend && key_visible(qlo + r, pos, causal, window);
      const float p = ok ? expf(s * scale - lse_s[r]) : 0.f;
      ds_s[r * (kDqBK + 1) + j] = p * (dp - dl_s[r]);
    }
    __syncthreads();
    // dq += dS @ K; 8 threads per row, head-dim entries strided by 8
    {
      const float* dr = ds_s + row * (kDqBK + 1);
#pragma unroll
      for (int i = 0; i < kDqDPT; ++i) {
        const int d = dlane + i * kDqLanesPerRow;
        if (d >= dh) break;
        float a = acc[i];
#pragma unroll 8
        for (int j = 0; j < kDqBK; ++j) a = fmaf(dr[j], k_s[j * (dh + 1) + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  if (q0 + row < Sq) {
    float* o = dq + (rbase + row) * dh;
#pragma unroll
    for (int i = 0; i < kDqDPT; ++i) {
      const int d = dlane + i * kDqLanesPerRow;
      if (d >= dh) break;
      o[d] = acc[i] * scale;
    }
  }
}

template <typename T, int MaxDh>
static cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, float* dq, int BH,
                             int group, int Sq, int Skv, int dh, int causal, int window,
                             int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_floats(dh) * sizeof(float);
  cudaError_t e = allow_smem(mha_bwd_dq_kernel<T, MaxDh>, smem);
  if (e != cudaSuccess) return e;
  if (BH > 65535) return cudaErrorInvalidValue;
  dim3 grid((Sq + kDqBQ - 1) / kDqBQ, BH);
  record_launch(mha_bwd_dq_kernel<T, MaxDh>, "mha_bwd_dq_kernel", grid, kDqThreads, smem,
                {Sq, kDqBQ}, {BH, 1});
  mha_bwd_dq_kernel<T, MaxDh><<<grid, kDqThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq, Sq, Skv, dh, group, causal, window,
      q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// A geometry: BQ query rows a block (16 a warp), BK keys a tile, head dim
// padded to DP, dS as a hi + lo pair (HILO) or rounded once (the sweep's
// timing variant, which fails the gate).  Shared memory: the Q and dO
// tiles, then 2 stages of (K, V) tiles; rows of DP + 8 elements for
// conflict-free ldmatrix.
template <int DP_, int BQ_, int BK_, bool HILO_>
struct DqTiles {
  static constexpr int DP = DP_, BQ = BQ_, BK = BK_, NT = 2 * BQ, LD = DP + 8, ST = 2;
  static constexpr bool HILO = HILO_;
  static constexpr size_t bytes = (2 * (size_t)BQ + ST * 2 * (size_t)BK) * LD * sizeof(bf16);
};

// Block (bh * splits + z, row block y).  part == nullptr: one run, dq
// written scaled; else run z's f32 partial goes to part[z * N + i], N =
// BH * Sq * dh.
template <typename G>
__global__ void __launch_bounds__(G::NT, G::NT == 128 ? 2 : 1)
mha_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, float* __restrict__ part, int BH, int group, int Sq,
                     int Skv, int dh, int causal, int window, int q_offset, float scale,
                     int splits, int vec) {
  constexpr int DP = G::DP, BQ = G::BQ, BK = G::BK, NT = G::NT, LD = G::LD, ST = G::ST;
  constexpr int NS = BK / 8;   // 8-key tiles of S and dP
  constexpr int ND = DP / 8;   // 8-column tiles of dQ
  constexpr int T = BK * LD;   // elements of one K or V tile
  static_assert(NS % 2 == 0 && ND % 2 == 0 && BQ % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char dq_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(dq_smem);
  bf16* o_s = q_s + BQ * LD;   // dO
  bf16* kv_s = o_s + BQ * LD;  // stage s: K at kv_s + 2 s T, V at + T

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma group id, thread in group
  const int bh = blockIdx.x / splits, z = blockIdx.x % splits;
  const int bkv = bh / group;
  // under the causal mask the last row block sees the most keys: it goes first
  const int yb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = yb * BQ, w0 = warp * 16;
  const int last = min(Sq, q0 + BQ) - 1;

  // the keys the block's rows can see, [kbeg, kend), in tiles [tb, nt);
  // run z owns tiles [t_lo, t_hi)
  const int kend = causal ? min(Skv, q_offset + last + 1) : Skv;
  const int tb = window > 0 ? max(0, q_offset + q0 - window + 1) / BK : 0;
  const int nt = max(tb, (kend + BK - 1) / BK);
  const int tps = (nt - tb + splits - 1) / splits;
  const int t_lo = min(nt, tb + z * tps), t_hi = min(nt, t_lo + tps);
  // tiles past the first row's last key, or before the last row's first
  // key, need the mask
  const int diag_from = causal ? min(q_offset + q0, Skv - 1) : Skv - 1;
  const int lo_to = window > 0 ? q_offset + last - window + 1 : 0;

  auto load_tile = [&](bf16* dst, const bf16* src, long long row0, int R, int valid) {
    load_rows_bf16<DP, LD, NT>(dst, src, row0, R, valid, dh, vec);
  };
  const long long kvrow = (long long)bkv * Skv, qrow = (long long)bh * Sq + q0;
  auto load_kv = [&](int stage, int t) {
    bf16* kt = kv_s + 2 * stage * T;
    load_tile(kt, k, kvrow + t * BK, BK, kend - t * BK);
    load_tile(kt + T, v, kvrow + t * BK, BK, kend - t * BK);
  };

  // Q, dO and the first tile: one commit group
  load_tile(q_s, q, qrow, BQ, Sq - q0);
  load_tile(o_s, dout, qrow, BQ, Sq - q0);
  if (t_lo < t_hi) load_kv(0, t_lo);
  cp_async_commit();

  // this lane's rows q0 + w0 + g (+8): their lse (log2 units), delta and
  // visible keys [lo, lim]
  float l2[2], dl[2];
  int lim[2], lo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + w0 + g + 8 * h, qp = q_offset + qi;
    const bool in = qi < Sq;
    l2[h] = in ? lse[qrow - q0 + qi] * kLog2e : 0.f;
    dl[h] = in ? delta[qrow - q0 + qi] : 0.f;
    lim[h] = causal ? min(qp, Skv - 1) : Skv - 1;
    lo[h] = window > 0 ? qp - window + 1 : 0;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float sl = scale * kLog2e;  // scores in log2 units

  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo;
    cp_async_wait<ST - 2>();  // tile t (and Q, dO) have landed
    __syncthreads();          // ... for every warp; tile t - 1's stage is free
    if (t + 1 < t_hi) load_kv((i + 1) % ST, t + 1);
    cp_async_commit();
    const bf16* k_t = kv_s + 2 * (i % ST) * T;
    const bf16* v_t = k_t + T;

    // S = Q K^T and dP = dO V^T over the 16-deep slices of dh that hold
    // data: the warp's 16 rows against the tile's BK keys
    float sa[NS][4], pa[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      if (ks * 16 >= dh) break;
      unsigned aq[4], ao[4];
      ldmatrix_x4(aq, q_s + (w0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4(ao, o_s + (w0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        // matrices: (keys 8j.., d 0-7), (8j.., d 8-15), (8j+8.., d 0-7),
        // (8j+8.., d 8-15): the b0 / b1 of key tiles j and j + 1
        const int off = (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                        ((lane >> 3) & 1) * 8;
        unsigned r[4];
        ldmatrix_x4(r, k_t + off);
        mma_bf16(sa[j], aq, r[0], r[1]);
        mma_bf16(sa[j + 1], aq, r[2], r[3]);
        ldmatrix_x4(r, v_t + off);
        mma_bf16(pa[j], ao, r[0], r[1]);
        mma_bf16(pa[j + 1], ao, r[2], r[3]);
      }
    }

    // P and dS in place; element e of key tile j is row w0 + g (+8 for e
    // >= 2), key t BK + 8j + 2tq (+1 for odd e).  Off the mask P is 0 (an
    // empty row's lse of -1e30 meets only masked keys).
    const int k0 = t * BK;
    const bool edge = k0 + BK - 1 > diag_from || k0 < lo_to;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = ex2(fmaf(sa[j][e], sl, -l2[h]));
        if (edge) {
          const int kp = k0 + 8 * j + 2 * tq + (e & 1);
          if (kp > lim[h] || kp < lo[h]) p = 0.f;
        }
        pa[j][e] = p * (pa[j][e] - dl[h]);
      }

    // dQ += dS K: A fragments from the dS accumulators (16 keys = key tiles
    // 2kk, 2kk + 1), a hi + lo pair; B fragments of K by ldmatrix.trans,
    // each feeding both halves
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned hi[4], lo_[4];
      split_bf16(pa[2 * kk][0], pa[2 * kk][1], hi[0], lo_[0]);
      split_bf16(pa[2 * kk][2], pa[2 * kk][3], hi[1], lo_[1]);
      split_bf16(pa[2 * kk + 1][0], pa[2 * kk + 1][1], hi[2], lo_[2]);
      split_bf16(pa[2 * kk + 1][2], pa[2 * kk + 1][3], hi[3], lo_[3]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        if (n * 8 >= dh) break;
        unsigned r[4];
        ldmatrix_x4_trans(r, k_t + (kk * 16 + (lane & 15)) * LD + n * 8 + (lane >> 4) * 8);
        mma_bf16(acc[n], hi, r[0], r[1]);
        mma_bf16(acc[n + 1], hi, r[2], r[3]);
        if constexpr (G::HILO) {
          mma_bf16(acc[n], lo_, r[0], r[1]);
          mma_bf16(acc[n + 1], lo_, r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // rows w0 + g (+8), columns 8n + 2tq (+1); pairs as one store where dh
  // is even (so the pair is aligned)
  const long long N = (long long)BH * Sq * dh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + w0 + g + 8 * h;
    if (qi >= Sq) continue;
    const long long at = (qrow - q0 + qi) * dh;
    float* po = part ? part + z * N + at : dq + at;
    const float sc = part ? 1.f : scale;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * tq;
      const float x0 = acc[n][2 * h] * sc, x1 = acc[n][2 * h + 1] * sc;
      if (col + 1 < dh && dh % 2 == 0) {
        *reinterpret_cast<float2*>(po + col) = make_float2(x0, x1);
      } else {
        if (col < dh) po[col] = x0;
        if (col + 1 < dh) po[col + 1] = x1;
      }
    }
  }
}

// The second pass of a split launch: dq = scale * sum_z dq_z, the runs
// summed in order z = 0, 1, ... (fixed, so deterministic).
__global__ void __launch_bounds__(256)
mha_bwd_dq_combine_kernel(const float* __restrict__ part, float* __restrict__ dq, long long N,
                          int splits, float scale) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < N; i += 256LL * gridDim.x) {
    float a = 0.f;
    for (int z = 0; z < splits; ++z) a += part[z * N + i];
    dq[i] = a * scale;
  }
}

// One geometry's launch, both passes (the second when splits > 1)
template <typename G>
static cudaError_t launch_dq_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                                const float* lse, const float* delta, float* dq, float* part,
                                int splits, int BH, int group, int Sq, int Skv, int dh,
                                int causal, int window, int q_offset, float scale,
                                cudaStream_t stream) {
  auto kernel = mha_bwd_dq_tc_kernel<G>;
  cudaError_t e = allow_smem(kernel, G::bytes);
  if (e != cudaSuccess) return e;
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = dh % 8 == 0 && al(q) && al(k) && al(v) && al(dout);
  const dim3 grid(BH * splits, (Sq + G::BQ - 1) / G::BQ);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  // each split's dq partial over (BH, Sq, dh)
  record_launch(kernel, "mha_bwd_dq_tc_kernel", grid, G::NT, G::bytes, {(long long)BH * splits, 1},
                {Sq, G::BQ}, {}, splits > 1 ? (long long)splits * BH * Sq * dh : 0);
  kernel<<<grid, G::NT, G::bytes, stream>>>(q, k, v, dout, lse, delta, dq,
                                            splits > 1 ? part : nullptr, BH, group, Sq, Skv, dh,
                                            causal, window, q_offset, scale, splits, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long N = (long long)BH * Sq * dh;
  const long long blocks = std::min<long long>((N + 255) / 256, 8192);
  record_launch(mha_bwd_dq_combine_kernel, "mha_bwd_dq_combine_kernel",
                dim3(static_cast<unsigned>(blocks)), 256, 0, {N, 256, true});
  mha_bwd_dq_combine_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(part, dq, N,
                                                                              splits, scale);
  return cudaGetLastError();
}

// The geometry at the padded head dim: 64 rows a block, 64-key tiles
template <int DP>
using DqServe = DqTiles<DP, 64, 64, true>;

static cudaError_t launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                                  const float* lse, const float* delta, float* dq, float* part,
                                  int splits, int BH, int group, int Sq, int Skv, int dh,
                                  int causal, int window, int q_offset, float scale,
                                  cudaStream_t s) {
  switch (mha_tc_dp(dh)) {
    case 64:
      return launch_dq_tc<DqServe<64>>(q, k, v, dout, lse, delta, dq, part, splits, BH, group,
                                       Sq, Skv, dh, causal, window, q_offset, scale, s);
    case 96:
      return launch_dq_tc<DqServe<96>>(q, k, v, dout, lse, delta, dq, part, splits, BH, group,
                                       Sq, Skv, dh, causal, window, q_offset, scale, s);
    default:
      return launch_dq_tc<DqServe<128>>(q, k, v, dout, lse, delta, dq, part, splits, BH, group,
                                        Sq, Skv, dh, causal, window, q_offset, scale, s);
  }
}

// ---------------------------------------------------------------------------
// bf16 above dh 128: tensor cores, the head dim split across warps
// ---------------------------------------------------------------------------

// A geometry above kMhaTcMaxDh, dh padded to kMhaMaxDh: BQ query rows a
// block, BK keys a tile, WC warps to each 16-row strip, ST stages of (K,
// V) tiles.  In a tile, warp (strip, c) computes S and dP for its strip's
// rows and keys [c KW, (c + 1) KW) and then dQ for its strip's rows and
// the dq columns [c CW, (c + 1) CW): 64 dq accumulators a thread at WC =
// 2, where one warp a strip would need 128 besides S and dP.  Shared
// memory: the Q and dO tiles, ST stages of (K, V) tiles (rows of DP + 8
// elements), then dS as a hi and a lo (BQ, BK) bf16 tile (rows of BK +
// 8), through which the warps of a strip trade their keys' dS.  MINB:
// the blocks an SM that shared memory allows (1 or 2), for
// __launch_bounds__.
template <int BQ_, int BK_, int WC_, int ST_>
struct DqWide {
  static constexpr int DP = kMhaMaxDh, BQ = BQ_, BK = BK_, WC = WC_, ST = ST_;
  static constexpr int NT = BQ / 16 * WC * 32, LD = DP + 8, LDS = BK + 8;
  static constexpr int KW = BK / WC, CW = DP / WC;
  static constexpr size_t bytes =
      ((2 * (size_t)BQ + ST * 2 * (size_t)BK) * LD + 2 * (size_t)BQ * LDS) * sizeof(bf16);
  static constexpr int MINB = 2 * (bytes + 1024) <= 233472 ? 2 : 1;
};

// Block (bh * splits + z, row block y); the runs, masks, partials and the
// order of the row blocks are mha_bwd_dq_tc_kernel's.
template <typename G>
__global__ void __launch_bounds__(G::NT, G::MINB)
mha_bwd_dq_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, float* __restrict__ part, int BH, int group,
                       int Sq, int Skv, int dh, int causal, int window, int q_offset,
                       float scale, int splits, int vec) {
  constexpr int DP = G::DP, BQ = G::BQ, BK = G::BK, WC = G::WC, ST = G::ST, NT = G::NT;
  constexpr int LD = G::LD, LDS = G::LDS, KW = G::KW, CW = G::CW;
  constexpr int NS = KW / 8;   // 8-key tiles of S and dP a warp
  constexpr int ND = CW / 8;   // 8-column tiles of dQ a warp
  constexpr int T = BK * LD;   // elements of one K or V tile
  static_assert(NS % 2 == 0 && ND % 2 == 0 && BQ % 16 == 0 && BK % 16 == 0, "tile shape");
  static_assert(ST == 1 || ST == 2, "ring stages");
  extern __shared__ __align__(16) unsigned char dq_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(dq_smem);
  bf16* o_s = q_s + BQ * LD;       // dO
  bf16* kv_s = o_s + BQ * LD;      // stage s: K at kv_s + 2 s T, V at + T
  bf16* ds_hi = kv_s + ST * 2 * T;
  bf16* ds_lo = ds_hi + BQ * LDS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma group id, thread in group
  const int w0 = warp / WC * 16, c = warp % WC;
  const int kc = c * KW, dc = c * CW;      // the warp's keys of a tile, its dq columns
  const int bh = blockIdx.x / splits, z = blockIdx.x % splits;
  const int bkv = bh / group;
  const int yb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = yb * BQ;
  const int last = min(Sq, q0 + BQ) - 1;

  const int kend = causal ? min(Skv, q_offset + last + 1) : Skv;
  const int tb = window > 0 ? max(0, q_offset + q0 - window + 1) / BK : 0;
  const int nt = max(tb, (kend + BK - 1) / BK);
  const int tps = (nt - tb + splits - 1) / splits;
  const int t_lo = min(nt, tb + z * tps), t_hi = min(nt, t_lo + tps);
  const int diag_from = causal ? min(q_offset + q0, Skv - 1) : Skv - 1;
  const int lo_to = window > 0 ? q_offset + last - window + 1 : 0;

  auto load_tile = [&](bf16* dst, const bf16* src, long long row0, int R, int valid) {
    load_rows_bf16<DP, LD, NT>(dst, src, row0, R, valid, dh, vec);
  };
  const long long kvrow = (long long)bkv * Skv, qrow = (long long)bh * Sq + q0;
  auto load_kv = [&](int stage, int t) {
    bf16* kt = kv_s + 2 * stage * T;
    load_tile(kt, k, kvrow + t * BK, BK, kend - t * BK);
    load_tile(kt + T, v, kvrow + t * BK, BK, kend - t * BK);
  };

  load_tile(q_s, q, qrow, BQ, Sq - q0);
  load_tile(o_s, dout, qrow, BQ, Sq - q0);
  if (t_lo < t_hi) load_kv(0, t_lo);
  cp_async_commit();

  float l2[2], dl[2];
  int lim[2], lo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + w0 + g + 8 * h, qp = q_offset + qi;
    const bool in = qi < Sq;
    l2[h] = in ? lse[qrow - q0 + qi] * kLog2e : 0.f;
    dl[h] = in ? delta[qrow - q0 + qi] : 0.f;
    lim[h] = causal ? min(qp, Skv - 1) : Skv - 1;
    lo[h] = window > 0 ? qp - window + 1 : 0;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float sl = scale * kLog2e;

  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo;
    cp_async_wait<0>();  // tile t (and Q, dO) have landed
    __syncthreads();     // ... for every warp; tile t - 1's stage and dS are free
    if constexpr (ST == 2) {
      if (t + 1 < t_hi) load_kv((i + 1) % 2, t + 1);
      cp_async_commit();
    }
    const bf16* k_t = kv_s + 2 * (ST == 2 ? i % 2 : 0) * T;
    const bf16* v_t = k_t + T;

    // S = Q K^T and dP = dO V^T: the strip's 16 rows against the warp's
    // KW keys of the tile
    float sa[NS][4], pa[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      if (ks * 16 >= dh) break;
      unsigned aq[4], ao[4];
      ldmatrix_x4(aq, q_s + (w0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4(ao, o_s + (w0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        const int off = (kc + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                        ((lane >> 3) & 1) * 8;
        unsigned r[4];
        ldmatrix_x4(r, k_t + off);
        mma_bf16(sa[j], aq, r[0], r[1]);
        mma_bf16(sa[j + 1], aq, r[2], r[3]);
        ldmatrix_x4(r, v_t + off);
        mma_bf16(pa[j], ao, r[0], r[1]);
        mma_bf16(pa[j + 1], ao, r[2], r[3]);
      }
    }

    // P and dS; element e of key tile j is row w0 + g (+8 for e >= 2),
    // key t BK + kc + 8j + 2tq (+1 for odd e); dS goes to shared memory as
    // a hi + lo pair
    const int k0 = t * BK;
    const bool edge = k0 + BK - 1 > diag_from || k0 < lo_to;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = ex2(fmaf(sa[j][e], sl, -l2[h]));
        if (edge) {
          const int kp = k0 + kc + 8 * j + 2 * tq + (e & 1);
          if (kp > lim[h] || kp < lo[h]) p = 0.f;
        }
        pa[j][e] = p * (pa[j][e] - dl[h]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned hi, lo_;
        split_bf16(pa[j][2 * h], pa[j][2 * h + 1], hi, lo_);
        const int at = (w0 + g + 8 * h) * LDS + kc + 8 * j + 2 * tq;
        *reinterpret_cast<unsigned*>(ds_hi + at) = hi;
        *reinterpret_cast<unsigned*>(ds_lo + at) = lo_;
      }
    }
    __syncthreads();  // the strip's dS over all BK keys

    // dQ[:, dc, dc + CW) += dS K: A fragments of dS (hi and lo) by
    // ldmatrix, B fragments of K by ldmatrix.trans, each feeding both
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned hi[4], lo_[4];
      const int at = (w0 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(hi, ds_hi + at);
      ldmatrix_x4(lo_, ds_lo + at);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        if (dc + n * 8 >= dh) break;
        unsigned r[4];
        ldmatrix_x4_trans(r, k_t + (kk * 16 + (lane & 15)) * LD + dc + n * 8 + (lane >> 4) * 8);
        mma_bf16(acc[n], hi, r[0], r[1]);
        mma_bf16(acc[n + 1], hi, r[2], r[3]);
        mma_bf16(acc[n], lo_, r[0], r[1]);
        mma_bf16(acc[n + 1], lo_, r[2], r[3]);
      }
    }
    if constexpr (ST == 1) {
      __syncthreads();  // every warp is done with tile t
      if (t + 1 < t_hi) load_kv(0, t + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  const long long N = (long long)BH * Sq * dh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + w0 + g + 8 * h;
    if (qi >= Sq) continue;
    const long long at = (qrow - q0 + qi) * dh;
    float* po = part ? part + z * N + at : dq + at;
    const float sc = part ? 1.f : scale;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = dc + n * 8 + 2 * tq;
      const float x0 = acc[n][2 * h] * sc, x1 = acc[n][2 * h + 1] * sc;
      if (col + 1 < dh && dh % 2 == 0) {
        *reinterpret_cast<float2*>(po + col) = make_float2(x0, x1);
      } else {
        if (col < dh) po[col] = x0;
        if (col + 1 < dh) po[col + 1] = x1;
      }
    }
  }
}

// One wide geometry's launch, both passes (the second when splits > 1)
template <typename G>
static cudaError_t launch_dq_wide(const bf16* q, const bf16* k, const bf16* v,
                                  const bf16* dout, const float* lse, const float* delta,
                                  float* dq, float* part, int splits, int BH, int group, int Sq,
                                  int Skv, int dh, int causal, int window, int q_offset,
                                  float scale, cudaStream_t stream) {
  auto kernel = mha_bwd_dq_wide_kernel<G>;
  cudaError_t e = allow_smem(kernel, G::bytes);
  if (e != cudaSuccess) return e;
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = dh % 8 == 0 && al(q) && al(k) && al(v) && al(dout);
  const dim3 grid(BH * splits, (Sq + G::BQ - 1) / G::BQ);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  record_launch(kernel, "mha_bwd_dq_wide_kernel", grid, G::NT, G::bytes,
                {(long long)BH * splits, 1}, {Sq, G::BQ}, {},
                splits > 1 ? (long long)splits * BH * Sq * dh : 0);
  kernel<<<grid, G::NT, G::bytes, stream>>>(q, k, v, dout, lse, delta, dq,
                                            splits > 1 ? part : nullptr, BH, group, Sq, Skv, dh,
                                            causal, window, q_offset, scale, splits, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long N = (long long)BH * Sq * dh;
  const long long blocks = std::min<long long>((N + 255) / 256, 8192);
  record_launch(mha_bwd_dq_combine_kernel, "mha_bwd_dq_combine_kernel",
                dim3(static_cast<unsigned>(blocks)), 256, 0, {N, 256, true});
  mha_bwd_dq_combine_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(part, dq, N,
                                                                              splits, scale);
  return cudaGetLastError();
}

// The geometry above dh 128: 64 rows a block (two warps to a 16-row
// strip), 32-key tiles in one stage, 109 KB of shared memory, so two
// blocks an SM (each hides the other's loads)
using DqWideServe = DqWide<64, 32, 2, 1>;

// The split count of a bf16 geometry of BQ-row blocks over BK-key tiles,
// from static shapes and the SM count only: the larger of two needs.
//  - Accuracy: runs of at most kDqRunKeys keys.  A row block's keys lie in
//    the key tiles [0, ceil(Skv / BK)), so that many tiles over the run
//    cap's tiles bounds every block's runs.  The cap is dk/dv's run of
//    64 items of 64 rows (4096 summed products), which held the gate
//    where one of 224 items missed it (mha_bwd_dkv.cu's plan; PERF.md).
//  - Occupancy: where the row blocks (BH x Sq / BQ) number fewer than
//    `fill`, as many splits as bring them to about `fill`, at most `cap`:
//    at dh <= 128 one wave of two blocks an SM, at most
//    kDqOccupancySplits; above it kDqWideFill blocks an SM (two waves of
//    the wide geometry's two), at most kDqWideOccupancySplits.
// *ws_elems: the f32 workspace of the partials (splits x BH x Sq x dh; 0
// for one split).  ref.dq_splits restates it.
constexpr int kDqRunKeys = 4096, kDqOccupancySplits = 8;
constexpr int kDqWideFill = 4, kDqWideOccupancySplits = 8;

inline int dq_split_rule(int BH, int Sq, int Skv, int dh, int BQ, int BK, long long fill, int cap,
                         long long* ws_elems) {
  const long long blocks = (long long)BH * ((Sq + BQ - 1) / BQ);
  const int tiles = (Skv + BK - 1) / BK;
  long long splits = (tiles + kDqRunKeys / BK - 1) / (kDqRunKeys / BK);
  if (blocks < fill) splits = std::max(splits, std::min<long long>(cap, fill / blocks));
  splits = std::max(1LL, std::min<long long>(splits, tiles));
  *ws_elems = splits > 1 ? splits * BH * Sq * dh : 0;
  return static_cast<int>(splits);
}

inline int dq_tc_plan(int BH, int Sq, int Skv, int dh, int sms, long long* ws_elems) {
  if (dh > kMhaTcMaxDh)
    return dq_split_rule(BH, Sq, Skv, dh, DqWideServe::BQ, DqWideServe::BK,
                         (long long)kDqWideFill * sms, kDqWideOccupancySplits, ws_elems);
  return dq_split_rule(BH, Sq, Skv, dh, DqServe<128>::BQ, DqServe<128>::BK, 2LL * sms,
                       kDqOccupancySplits, ws_elems);
}

}  // namespace famous

// The split count of the bf16 kernels (dq_tc_plan), 1 for f32.  *ws_elems:
// the f32 workspace of the partials (0 for one split), which the wrapper
// allocates.
extern "C" int famous_mha_bwd_dq_plan(int dtype, int BH, int BKV, int Sq, int Skv, int dh,
                                      int sms, long long* ws_elems) {
  using namespace famous;
  *ws_elems = 0;
  if (dtype != kBF16 || dh <= 0 || dh > kMhaMaxDh || BKV <= 0 || BH % BKV != 0 || Sq <= 0 ||
      Skv <= 0)
    return 1;
  return dq_tc_plan(BH, Sq, Skv, dh, sms, ws_elems);
}

// part: the workspace of famous_mha_bwd_dq_plan when splits > 1, else null.
extern "C" int famous_mha_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 float* dq, void* part, int splits, int BH, int BKV, int Sq,
                                 int Skv, int dh, int causal, int window, int q_offset,
                                 float scale, void* stream) {
  using namespace famous;
  if (BKV <= 0 || BH % BKV != 0 || dh <= 0 || dh > kMhaMaxDh || splits < 1 ||
      (long long)BH * splits > 0x7fffffffLL ||
      (splits > 1 && (part == nullptr || dtype != kBF16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = BH / BKV;
  cudaError_t e;
  if (dtype == kF32 && dh <= kMhaTcMaxDh) {
    e = launch_dq<float, kMhaTcMaxDh>(q, k, v, dout, lse, delta, dq, BH, group, Sq, Skv, dh,
                                      causal, window, q_offset, scale, s);
  } else if (dtype == kF32) {
    e = launch_dq<float, kMhaMaxDh>(q, k, v, dout, lse, delta, dq, BH, group, Sq, Skv, dh,
                                    causal, window, q_offset, scale, s);
  } else if (dtype == kBF16 && dh > kMhaTcMaxDh) {
    e = launch_dq_wide<DqWideServe>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                    static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                                    lse, delta, dq, static_cast<float*>(part), splits, BH, group,
                                    Sq, Skv, dh, causal, window, q_offset, scale, s);
  } else if (dtype == kBF16) {
    e = launch_dq_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
                       dq, static_cast<float*>(part), splits, BH, group, Sq, Skv, dh, causal,
                       window, q_offset, scale, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
