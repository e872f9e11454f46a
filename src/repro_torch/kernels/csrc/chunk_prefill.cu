// chunk_prefill: a chunk of C query tokens at absolute positions
// [q_offset, q_offset + C) attends causally to the slot's resident prefix
// plus its own chunk, both already written into the contiguous KV cache.
//
//   q      (B, C, H, dh)         contiguous (the model's layout)
//   k, v   (B, Skv, KV, dh)      read by strides, dh contiguous
//   out    (B, C, H, dh)
//
// Key position j is visible to chunk row c iff j <= q_offset + c.
//
// Replaces: src/repro/kernels/decode/chunk_prefill.py, chunk_prefill (the
// Pallas kernel _chunk_prefill_kernel).  On the TPU one block holds all
// group * C rows of one kv head (4 blocks for one qwen2-7b slot, which
// would leave 128 of 132 SMs idle here), the wrapper copies the slot's
// stripe out of the batched cache and transposes it to kv-major, and the
// grid spans every key tile of Skv because a bound that depends on the
// offset would cost one executable per offset.  Here q and the cache
// stripe are read in place by strides, each block's key loop ends at run
// time at the last key its rows can see, and q_offset is a plain launch
// argument.  The softmax is the TPU kernel's: f32 running max and sum,
// masked keys get probability 0, divide by max(l, 1e-30).
//
// What bounds it on an H100: operations (7.0 GFLOP for C = 256 at offset
// 1792 on qwen2-7b, 7.1 us at the bf16 tensor-core peak) more than bytes
// (the slot's K/V stripe, 2 MB).
//
// Design, bf16: flash attention on tensor cores, mma.sync m16n8k16 (bf16
// x bf16 -> f32).  A block owns 128 chunk rows of one query head (64 at
// dh 256); each of its 4 warps owns 32 rows as two 16-row m-tiles, so
// every K and V fragment read from shared memory feeds two products.
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
//     or 256.  The causal mask runs only on the tiles that cross the
//     block's first row's diagonal.  104 KB of shared memory and 254
//     registers a thread: two blocks an SM.
//   - At C = 256 on qwen2-7b there are 2 x 28 = 56 such blocks for 132
//     SMs, so famous_chunk_prefill_plan splits each block's key range over
//     up to 4 blocks (from static shapes and the SM count only; 4 here):
//     each writes its f32 partial (m, l, O) to a workspace the wrapper
//     allocates, and a second kernel combines them in split order.  No sum
//     crosses blocks in any other way, so a relaunch is bit-identical.
//   scripts/torch_kernel_sweep.py times this geometry against 64-row
//   blocks of 16-row warps, 8 warps, 32-key tiles, a 3-stage ring, (chunk
//   row, query head) rows packed per kv head, and every split count
//   (PERF.md).
//
// f32: the CUDA-core kernel of the first port, in full f32 FMAs (no TF32):
// one block per (32 chunk rows, query head), 32 x 32 tiles of Q, K and V
// staged in shared memory, 8 threads a row in P V.
#include "common.cuh"

#include <algorithm>
#include <cmath>

namespace famous {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------


constexpr int kCpBQ = 32;       // chunk rows per block
constexpr int kCpBK = 32;       // keys per tile (= warp size: lane = key)
constexpr int kCpThreads = 256;
constexpr int kCpWarps = kCpThreads / 32;
constexpr int kCpMaxDh = 256;
constexpr int kCpLanesPerRow = kCpThreads / kCpBQ;          // 8 threads per row in P @ V
constexpr int kCpDPT = kCpMaxDh / kCpLanesPerRow;           // head-dim entries per thread

__host__ __device__ inline size_t chunk_smem_floats(int dh) {
  return (size_t)kCpBQ * dh               // Q tile (pre-scaled)
         + (size_t)kCpBK * (dh + 1)       // K tile (padded rows)
         + (size_t)kCpBK * dh             // V tile
         + (size_t)kCpBQ * (kCpBK + 1)    // scores / probabilities
         + 3 * (size_t)kCpBQ;             // running max, sum, correction
}

template <typename T>
__global__ void __launch_bounds__(kCpThreads)
chunk_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int C, int H, int KV,
                     int dh, int Skv, int q_offset, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                     float scale) {
  extern __shared__ float smem[];
  const int group = H / KV;
  const int c0 = blockIdx.x * kCpBQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / group;
  float* q_s = smem;
  float* k_s = q_s + kCpBQ * dh;
  float* v_s = k_s + kCpBK * (dh + 1);
  float* p_s = v_s + kCpBK * dh;
  float* m_s = p_s + kCpBQ * (kCpBK + 1);
  float* l_s = m_s + kCpBQ;
  float* c_s = l_s + kCpBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kCpBQ * dh; i += kCpThreads) {
    const int r = i / dh, d = i % dh, c = c0 + r;
    q_s[i] = c < C ? to_f(q[(((long long)b * C + c) * H + hq) * dh + d]) * scale : 0.f;
  }
  if (tid < kCpBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int row = tid / kCpLanesPerRow, dlane = tid % kCpLanesPerRow;
  float acc[kCpDPT];
#pragma unroll
  for (int i = 0; i < kCpDPT; ++i) acc[i] = 0.f;

  // the block's last visible key is q_offset + (its last real row)
  const int kend = min(Skv, q_offset + min(C, c0 + kCpBQ));
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  __syncthreads();

  for (int k0 = 0; k0 < kend; k0 += kCpBK) {
    for (int i = tid; i < kCpBK * dh; i += kCpThreads) {
      const int j = i / dh, d = i % dh, pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < kend) {
        kx = to_f(kb[pos * k_ss + d]);
        vx = to_f(vb[pos * v_ss + d]);
      }
      k_s[j * (dh + 1) + d] = kx;
      v_s[j * dh + d] = vx;
    }
    __syncthreads();
    // scores: (32 x 32) dot products of length dh; a warp shares one row
    for (int i = tid; i < kCpBQ * kCpBK; i += kCpThreads) {
      const int r = i / kCpBK, j = i % kCpBK;
      const float* qr = q_s + r * dh;
      const float* kr = k_s + j * (dh + 1);
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[r * (kCpBK + 1) + j] = s;
    }
    __syncthreads();
    // online softmax: one warp per row, lane = key
    for (int r = warp; r < kCpBQ; r += kCpWarps) {
      const int pos = k0 + lane;
      const bool ok = pos < kend && pos <= q_offset + c0 + r;
      const float s = ok ? p_s[r * (kCpBK + 1) + lane] : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p);
      p_s[r * (kCpBK + 1) + lane] = p;
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    // acc = acc * corr + P @ V; 8 threads per row, head-dim entries strided by 8
    {
      const float corr = c_s[row];
      const float* pr = p_s + row * (kCpBK + 1);
#pragma unroll
      for (int i = 0; i < kCpDPT; ++i) {
        const int d = dlane + i * kCpLanesPerRow;
        if (d >= dh) break;
        float a = acc[i] * corr;
#pragma unroll 8
        for (int j = 0; j < kCpBK; ++j) a = fmaf(pr[j], v_s[j * dh + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const int c = c0 + row;
  if (c < C) {
    T* o = out + (((long long)b * C + c) * H + hq) * dh;
#pragma unroll
    for (int i = 0; i < kCpDPT; ++i) {
      const int d = dlane + i * kCpLanesPerRow;
      if (d >= dh) break;
      o[d] = from_f<T>(acc[i] / fmaxf(l_s[row], 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcMaxSplits = 4;

// 2^x by the MUFU unit (ex2.approx.ftz: relative error about 2^-22;
// -inf gives 0, a denormal result flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A tile geometry: WARPS warps of MT x 16 chunk rows a block, K/V tiles of
// BK keys in a ring of STAGES, and whether a block's rows are (chunk row,
// query head) pairs of one kv head (PACK).
template <int WARPS_, int MT_, int BK_, int STAGES_, bool PACK_>
struct TcTiles {
  static constexpr int WARPS = WARPS_, MT = MT_, BK = BK_, STAGES = STAGES_;
  static constexpr bool PACK = PACK_;
  static constexpr int BQ = 16 * MT * WARPS, NT = 32 * WARPS;
};

template <int DP, typename G>
constexpr size_t chunk_tc_smem_bytes() {
  // Q tile, then STAGES pairs of K and V tiles; rows of DP + 8 elements
  return (size_t)(G::BQ + 2 * G::STAGES * G::BK) * (DP + 8) * sizeof(bf16);
}

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

// Block (x, y, b * splits + z).  part == nullptr: the block owns its whole
// key range and writes bf16 out; else it owns split z of the range's tiles
// and writes its f32 partial: O to part[(z * RT + row) * dh + d], m (log2
// units) to part[splits * RT * dh + z * RT + row], l after those, RT =
// B * C * H rows (b, c, h).
template <int DP, typename G>
__global__ void __launch_bounds__(G::NT)
chunk_prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        float* __restrict__ part, int B, int C, int H, int KV, int dh, int Skv,
                        int q_offset, long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh, float scale,
                        int splits, int vec) {
  constexpr int BQ = G::BQ, MT = G::MT, NT = G::NT, BK = G::BK, ST = G::STAGES, LD = DP + 8;
  constexpr int NS = BK / 8;      // 8-key score tiles of a K tile
  constexpr int ND = DP / 8;      // 8-column output tiles
  constexpr int T = BK * LD;      // elements of one K or V tile
  constexpr bool kQRegs = MT * DP <= 128;  // Q's A fragments stay in registers
  constexpr int CPR = DP / 8, RPP = NT / CPR;  // 16-byte chunks a row; rows a pass
  static_assert(BQ % RPP == 0 && BK % RPP == 0 && NS % 2 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* kv_s = q_s + BQ * LD;  // stage s: K at kv_s + 2 s T, V at + T

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma group id, thread in group
  const int group = H / KV;
  const int b = blockIdx.z / splits, z = blockIdx.z % splits;
  const ChunkRows<BQ, G::PACK> rows{(int)blockIdx.x, (int)blockIdx.y, C, group};
  const int hk = G::PACK ? blockIdx.y : blockIdx.y / group;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;

  // the block's keys end at its last row's diagonal; split z owns tiles
  // [t_lo, t_hi) of them
  const int kend = min(Skv, q_offset + rows.last_row() + 1);
  const int nt = (kend + BK - 1) / BK;
  const int tps = (nt + splits - 1) / splits;
  const int t_lo = min(nt, z * tps), t_hi = min(nt, t_lo + tps);
  const int diag_from = q_offset + rows.chunk_row(0);  // tiles past it need the mask

  // 16-byte chunk (tid % CPR) of rows tid / CPR + RPP i: the vec path's
  // share of a tile; columns past dh and rows past the end are zero-filled
  const int lc = (tid % CPR) * 8, lr = tid / CPR;
  const bool lc_ok = lc < dh;
  auto load_kv = [&](int stage, int t) {
    const int k0 = t * BK;
    bf16* kt = kv_s + 2 * stage * T;
    bf16* vt = kt + T;
    if (vec) {
#pragma unroll
      for (int i = 0; i < BK / RPP; ++i) {
        const int r = lr + i * RPP;
        const bool ok = lc_ok && k0 + r < kend;
        cp_async16(kt + r * LD + lc, ok ? kb + (k0 + r) * k_ss + lc : kb, ok ? 16 : 0);
        cp_async16(vt + r * LD + lc, ok ? vb + (k0 + r) * v_ss + lc : vb, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BK * DP; i += NT) {
        const int r = i / DP, c = i % DP;
        const bool ok = c < dh && k0 + r < kend;
        kt[r * LD + c] = ok ? kb[(k0 + r) * k_ss + c] : __float2bfloat16(0.f);
        vt[r * LD + c] = ok ? vb[(k0 + r) * v_ss + c] : __float2bfloat16(0.f);
      }
    }
  };
  auto q_row = [&](int i) {
    return q + (((long long)b * C + rows.chunk_row(i)) * H + rows.head(i)) * dh;
  };

  // Q and the first STAGES - 1 tiles, one commit group each (Q with the first)
  if (vec) {
#pragma unroll
    for (int i = 0; i < BQ / RPP; ++i) {
      const int r = lr + i * RPP;
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

  // this lane's rows: (m-tile mt, h) is block row warp * 16 MT + 16 mt + g + 8 h
  const int w0 = warp * 16 * MT;
  int lim[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) lim[mt][h] = q_offset + rows.chunk_row(w0 + 16 * mt + g + 8 * h);
  const float sl = scale * 1.4426950408889634f;  // scores in log2 units
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
    if (t + ST - 1 < t_hi) load_kv((i + ST - 1) % ST, t + ST - 1);
    cp_async_commit();
    const bf16* k_t = kv_s + 2 * (i % ST) * T;
    const bf16* v_t = k_t + T;
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

    // online softmax; accumulator element e of key tile j is row g (+8 for
    // e >= 2) of its m-tile, key t * BK + 8j + 2 tq (+1 for odd e); a
    // masked score is -inf, so its probability is exactly 0 even while its
    // row has seen no key (m stays at the finite -1e30)
    const int k0 = t * BK;
    const bool diag = k0 + BK - 1 > diag_from;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (diag && k0 + 8 * j + 2 * tq + (e & 1) > lim[mt][e >> 1]) s[mt][j][e] = -INFINITY;
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

    // O += P V: P's A fragments from the accumulators, rounded to bf16;
    // each V fragment feeds the warp's MT m-tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
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
      const long long row = ((long long)b * C + rows.chunk_row(i)) * H + rows.head(i);
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
// 1, ... (fixed, so deterministic).  A warp per row: every lane forms the
// row's weights, then the lanes stride over its dh columns.
constexpr int kCombineWarps = 8;

__global__ void __launch_bounds__(32 * kCombineWarps)
chunk_prefill_combine_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                             long long RT, int dh, int splits) {
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
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = lane; d < dh; d += 32) {
    float a = 0.f;
#pragma unroll
    for (int z = 0; z < kTcMaxSplits; ++z)
      if (z < splits) a += w[z] * part[(z * RT + row) * dh + d];
    out[row * dh + d] = __float2bfloat16(a * inv);
  }
}

// A tile geometry's launch, both passes (the second when splits > 1).
template <int DP, typename G>
static cudaError_t launch_chunk_tc(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                   float* part, int splits, int B, int C, int H, int KV, int dh,
                                   int Skv, int q_offset, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss,
                                   long long v_sh, float scale, cudaStream_t stream) {
  constexpr size_t smem = chunk_tc_smem_bytes<DP, G>();
  auto kernel = chunk_prefill_tc_kernel<DP, G>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int vec = dh % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0 && k_sb % 8 == 0 && k_ss % 8 == 0 &&
                  k_sh % 8 == 0 && v_sb % 8 == 0 && v_ss % 8 == 0 && v_sh % 8 == 0;
  const int rows = G::PACK ? C * (H / KV) : C;
  const dim3 grid((rows + G::BQ - 1) / G::BQ, G::PACK ? KV : H, B * splits);
  kernel<<<grid, G::NT, smem, stream>>>(q, k, v, out, splits > 1 ? part : nullptr, B, C, H, KV,
                                        dh, Skv, q_offset, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                                        scale, splits, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long RT = (long long)B * C * H;
  const long long blocks = (RT + kCombineWarps - 1) / kCombineWarps;
  chunk_prefill_combine_kernel<<<static_cast<unsigned>(blocks), 32 * kCombineWarps, 0, stream>>>(
      part, out, RT, dh, splits);
  return cudaGetLastError();
}

// The serving geometry at a padded head dim DP (PERF.md's sweep): 4 warps
// of 32 rows, 64-key tiles, 2 stages; at DP = 256 the warps own 16 rows,
// since 32 rows of f32 accumulators would not fit in registers.
template <int DP>
using ServeTiles = TcTiles<4, DP <= 128 ? 2 : 1, 64, 2, false>;

// the padded head dim of the bf16 kernel
inline int chunk_dp(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }

// the serving geometry at the padded head dim 64, 128 or 256
static cudaError_t launch_chunk_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                     float* part, int splits, int B, int C, int H, int KV,
                                     int dh, int Skv, int q_offset, long long k_sb,
                                     long long k_ss, long long k_sh, long long v_sb,
                                     long long v_ss, long long v_sh, float scale,
                                     cudaStream_t stream) {
  if (chunk_dp(dh) == 64)
    return launch_chunk_tc<64, ServeTiles<64>>(q, k, v, out, part, splits, B, C, H, KV, dh, Skv,
                                           q_offset, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                                           stream);
  if (chunk_dp(dh) == 128)
    return launch_chunk_tc<128, ServeTiles<128>>(q, k, v, out, part, splits, B, C, H, KV, dh, Skv,
                                            q_offset, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                                            stream);
  return launch_chunk_tc<256, ServeTiles<256>>(q, k, v, out, part, splits, B, C, H, KV, dh, Skv,
                                          q_offset, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                                          stream);
}

static cudaError_t launch_chunk_f32(const void* q, const void* k, const void* v, void* out,
                                    int B, int C, int H, int KV, int dh, int Skv, int q_offset,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh, float scale,
                                    cudaStream_t stream) {
  const size_t smem = chunk_smem_floats(dh) * sizeof(float);
  cudaError_t e = allow_smem(chunk_prefill_kernel<float>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((C + kCpBQ - 1) / kCpBQ, H, B);
  chunk_prefill_kernel<float><<<grid, kCpThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), C, H, KV, dh, Skv, q_offset, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      scale);
  return cudaGetLastError();
}

}  // namespace famous

// The key-range split count of the bf16 kernel, from static shapes and
// the SM count only: as many splits (at most 4) as keep the blocks of one
// launch within two per SM, each split at least 4 tiles of Skv deep.  1
// for f32.  *ws_elems: the f32 workspace of the split partials (splits x
// B x C x H x (dh + 2); 0 for one split), which the wrapper allocates.
extern "C" int famous_chunk_prefill_plan(int dtype, int B, int C, int H, int KV, int dh,
                                         int Skv, int sms, long long* ws_elems) {
  using namespace famous;
  *ws_elems = 0;
  if (dtype != kBF16 || B <= 0 || C <= 0 || KV <= 0 || H % KV != 0) return 1;
  const int bq = chunk_dp(dh) <= 128 ? ServeTiles<128>::BQ : ServeTiles<256>::BQ;
  const long long blocks = (long long)B * H * ((C + bq - 1) / bq);
  int splits = static_cast<int>(std::min<long long>(kTcMaxSplits, 2LL * sms / blocks));
  splits = std::max(1, std::min(splits, (Skv + 63) / 64 / 4));
  if (splits > 1) *ws_elems = (long long)splits * B * C * H * (dh + 2);
  return splits;
}

// part: the workspace of famous_chunk_prefill_plan when splits > 1, else
// null.
extern "C" int famous_chunk_prefill(int dtype, const void* q, const void* k, const void* v,
                                    void* out, void* part, int splits, int B, int C, int H,
                                    int KV, int dh, int Skv, int q_offset, long long k_sb,
                                    long long k_ss, long long k_sh, long long v_sb,
                                    long long v_ss, long long v_sh, float scale, void* stream) {
  using namespace famous;
  if (KV <= 0 || H % KV != 0 || dh <= 0 || dh > kCpMaxDh || q_offset < 0 || splits < 1 ||
      splits > kTcMaxSplits || (splits > 1 && (part == nullptr || dtype != kBF16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_chunk_f32(q, k, v, out, B, C, H, KV, dh, Skv, q_offset, k_sb, k_ss, k_sh, v_sb,
                         v_ss, v_sh, scale, s);
  else if (dtype == kBF16)
    e = launch_chunk_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<bf16*>(out),
                          static_cast<float*>(part), splits, B, C, H, KV, dh, Skv, q_offset, k_sb,
                          k_ss, k_sh, v_sb, v_ss, v_sh, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
