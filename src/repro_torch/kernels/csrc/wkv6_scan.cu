// wkv6_scan: the RWKV-6 wkv recurrence per (batch, head), in chunked form.
//
//   out_t = r_t (S_{t-1} + diag(u) k_t v_tᵀ),  S_t = diag(exp(logw_t)) S_{t-1} + k_t v_tᵀ
//
// r, k, v, logw: (BH, S, dh), f32 or bf16 (logw may differ from r, k, v:
// the model keeps it in f32); u: (BH, dh) f32; s0: optional (BH, dh, dh) f32
// carried state (zero when absent); out: (BH, S, dh) f32 and s_final: (BH,
// dh, dh) f32.  Chunks of C <= 64 steps, dh <= 64.
//
// Replaces: src/repro/kernels/scan/linear_scan.py, wkv6_scan (the Pallas
// kernel _wkv6_kernel), whose grid runs the chunks of one (batch, head) in
// order ("arbitrary") with the dh x dh state in VMEM scratch.  The s0 /
// s_final pair is what repro.models.rwkv6.wkv6_chunked adds to the Pallas
// kernel, and what chunked prefill needs to carry the state across engine
// chunks; with s0 absent the output is the Pallas kernel's.
//
// Each chunk, as the TPU kernel and wkv6_chunked compute it:
//   1. the inclusive cumsum cw of logw over time (and cw_prev = cw - logw);
//   2. qexp = r exp(cw_prev), kexp = k exp(-cw), kdec = k exp(cw_C - cw);
//   3. the strictly lower C x C scores att = qexp kexpᵀ and the diagonal
//      bonus diag_t = sum_d r u k;
//   4. out = qexp S + (att v + diag v);
//   5. S <- exp(cw_C) S + kdecᵀ v.
//
// Every product is an exact f32 multiply-add on the CUDA cores, not a TF32
// tensor-core product: kexp reaches e^C |k| (the model's clamp bounds
// |cw| <= C only), and only the product with qexp is bounded, so TF32's
// 10-bit mantissa would miss the f32 tolerance.
//
// What bounds it on an H100: at rwkv6-1.6b's serving shape (BH = 32, S =
// 256, dh = 64, C = 64) it does 4 C dh^2 + 2 C^2 dh multiply-adds per chunk
// (about 40 MFLOP per launch at f32's 67 TFLOP/s, 0.6 us) and moves 8.6 MB
// (2.6 us at 3.35 TB/s): bytes bound it.
//
// Design: only the state chain is sequential.  Steps 1-3, att v + diag v
// and the chunk's state increment dS_c = kdecᵀ v depend on no state, and so
// on no other chunk; and a value column e of S and out needs only column e
// of v.  So two launches on the caller's stream:
//   pass 1 (wkv6_chunk_kernel), one block per (bh, chunk, row split, column
//     split): the block's rows of att v + diag v (its out rows and columns,
//     written to out), its rows of dS_c (d rows by the row split, e columns
//     by the column split) and, for pass 2, qexp and exp(cw_C), into an f32
//     workspace the wrapper allocates (famous_wkv6_scan_plan sizes it).
//     The cumsum runs NT / 64 segments down each head-dim column, a thread
//     each, joined through shared memory, so no thread walks a whole chunk
//     and every thread of the block has a share.  The products are NT / 16
//     x 16 threads of blocked micro-tiles over shared memory,
//     each operand kept with its reduction index as the row (qexp and kexp
//     transposed as the scan writes them, att transposed as it is stored),
//     so one vector load feeds a micro-tile row or column; att v and
//     kdecᵀ v share one pass over v's rows, and the global stores come
//     after the products, a micro-tile row at a time.
//   pass 2 (wkv6_state_kernel), one block per (bh, column split): walks the
//     chunks in order, out_c = qexp_c S[:, cols] + out_c (today's order:
//     inter + (intra + diag v)), and S <- exp(cw_C) S + dS_c into a second
//     state buffer, the next chunks' workspace arriving by cp.async
//     meanwhile; then s_final.  Each chunk's product is bound by
//     shared-memory bandwidth (a 16-byte load of a warp takes four
//     wavefronts), so fewer threads with larger micro-tiles do it faster.
// At the serving shape pass 1 is 128 blocks and pass 2 another 256, where
// one block per (batch, head) gave 32.  Every sum runs in a fixed order
// and none crosses blocks, so a relaunch is bit-identical; the state chain
// is the chunked form's, chunk by chunk.  The splits, the thread counts,
// and whether pass 2 reads qexp from the workspace or recomputes it from r
// and logw, were chosen by scripts/torch_kernel_sweep.py (PERF.md).
#include "common.cuh"

namespace famous {

constexpr int kWkvMax = 64;          // the largest chunk and head dim
constexpr int kWkvLd = kWkvMax + 4;  // row stride of a 64-wide tile (16-byte rows)

// The shipped geometry: pass 1's row and column splits and threads, pass
// 2's column splits and threads, and qexp kept in the workspace (not
// recomputed by pass 2).
constexpr int kWkvRowSplits = 1, kWkvColSplits = 1, kWkvChunkThreads = 256;
constexpr int kWkvStateSplits = 8, kWkvStateThreads = 128;
constexpr bool kWkvQexpWs = true;

// The workspace: three arrays over the (bh, chunk) pairs in order, every
// dS_c (dh x dh, row d), then every exp(cw_C) (dh), then, when pass 2 reads
// it, every qexp transposed (dh x C, row d).
inline long long wkv_ws_elems(int BH, int S, int dh, int C, bool qws) {
  return (long long)BH * (S / C) * ((long long)dh * dh + dh + (qws ? (long long)C * dh : 0));
}

// Pass 1's tiles at RS row and CS column splits, in floats: logw/kdec, k,
// kexpᵀ (64 x kWkvLd each), r rows (RT x kWkvLd), qexpᵀ and attᵀ (64 x
// RT + 4 each; attᵀ takes k's place once the scan is done), v columns (64
// x ET + 4), the diagonal bonus (RT), u (64) and the cumsum's segment
// totals (NT); RT = 64 / RS, ET = 64 / CS.
template <int RS, int CS, int NT>
struct WkvChunkSmem {
  static constexpr int RT = kWkvMax / RS, ET = kWkvMax / CS, LDR = RT + 4, LDE = ET + 4;
  static constexpr int WK = 0, KK = WK + kWkvMax * kWkvLd, KT = KK + kWkvMax * kWkvLd,
                       RQ = KT + kWkvMax * kWkvLd, QT = RQ + RT * kWkvLd,
                       VV = QT + kWkvMax * LDR, DG = VV + kWkvMax * LDE, UU = DG + RT,
                       TT = UU + kWkvMax, floats = TT + NT;
  static_assert(kWkvMax * LDR <= kWkvMax * kWkvLd, "att fits in k's tile");
};

// Pass 2's ring of chunks in flight
constexpr int kWkvStages = 4;

// Pass 2's tiles at CS2 column splits: two buffers of the state columns
// (64 x E2P; chunk c reads one and writes the other) and kWkvStages stages
// of qexpᵀ (64 x kWkvLd), dS columns (64 x E2P), exp(cw_C) (64) and
// out columns (64 x E2P); without QWS also logw and r (64 x kWkvLd each)
// and the cumsum's segment totals (NT).
template <int CS2, int NT, bool QWS>
struct WkvStateSmem {
  static constexpr int E2 = kWkvMax / CS2, E2P = (E2 + 3) / 4 * 4;
  static constexpr int STAGE = kWkvMax * kWkvLd + 2 * kWkvMax * E2P + kWkvMax;
  static constexpr int floats =
      2 * kWkvMax * E2P + kWkvStages * STAGE + (QWS ? 0 : 2 * kWkvMax * kWkvLd + NT);
};

// N consecutive floats from shared memory, 16-byte aligned where N is a
// multiple of 4, else 4N-byte aligned
template <int N>
__device__ __forceinline__ void lds_vec(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// The first n of N consecutive floats to global memory at p: one 16-byte
// store where N = n = 4 and vec (p 16-byte aligned), else one at a time
// (a micro-tile row's columns, so a warp's stores fill whole sectors).
template <int N>
__device__ __forceinline__ void stg_row(float* p, const float (&v)[N], int n, bool vec) {
  if constexpr (N == 4) {
    if (vec && n == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) p[j] = v[j];
}

// acc[i][j] += sum_{x < K} a[x lda + m0 + i] b[x ldb + n0 + j] in order x =
// 0, 1, ..., as f32 FMAs: operands with the reduction index as the row.
// Rows and columns past the valid ones read whatever the tile holds there
// (the caller stores only the valid outputs, each an independent sum).
template <int MR, int NR>
__device__ __forceinline__ void fma_tile(float (&acc)[MR][NR], const float* a, int lda, int m0,
                                         const float* b, int ldb, int n0, int K) {
#pragma unroll 4
  for (int x = 0; x < K; ++x) {
    float av[MR], bv[NR];
    lds_vec(av, a + x * lda + m0);
    lds_vec(bv, b + x * ldb + n0);
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Rows [0, rows) and columns [c0, c0 + width) of a row-major (., dh)
// source, in f32, by a block of NT threads as 64 columns x NT / 64 rows
// (thread (tid / 64, tid % 64) takes rows tid / 64 + (NT / 64) j):
// load_rows issues all of a thread's loads into registers, store_rows
// writes them to a tile of row stride ld; a block issues every load before
// any store, so they are in flight together.
template <int NT, int NJ, typename T>
__device__ __forceinline__ void load_rows(float (&x)[NJ], const T* __restrict__ src, int dh,
                                          int c0, int rows, int width) {
  constexpr int RP = NT / kWkvMax;
  const int c = threadIdx.x % kWkvMax, r0 = threadIdx.x / kWkvMax;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int t = r0 + RP * j;
    x[j] = t < rows && c < width ? to_f(src[(long long)t * dh + c0 + c]) : 0.f;
  }
}

template <int NT, int NJ>
__device__ __forceinline__ void store_rows(const float (&x)[NJ], float* dst, int ld, int rows,
                                           int width) {
  constexpr int RP = NT / kWkvMax;
  const int c = threadIdx.x % kWkvMax, r0 = threadIdx.x / kWkvMax;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (r0 + RP * j < rows && c < width) dst[(r0 + RP * j) * ld + c] = x[j];
}

// The inclusive cumsum cw of a chunk's log-decays (C <= 64 rows of stride
// ld in shared memory) down each of dh <= 64 columns, by a block of NT
// threads as 64 columns x NT / 64 segments (thread (tid / 64, tid % 64) =
// (segment, column), so a warp reads 32 neighbouring columns of a row):
// each thread adds its segment in order, the segment totals meet in tot
// (NT floats), and each thread adds the totals of the segments before its
// own, in order, to its running sum.  Calls emit(t, d, logw, cw_t,
// cw_{C-1}) for each step of the thread's segment (which only that thread
// reads or writes), in order.  Every thread of the block must call it (it
// synchronises them).
template <int NT, typename F>
__device__ __forceinline__ void chunk_cumsum(const float* wk, int ld, int C, int dh, float* tot,
                                             F&& emit) {
  constexpr int NSEG = NT / kWkvMax, SEG = kWkvMax / NSEG;
  const int d = threadIdx.x % kWkvMax, seg = threadIdx.x / kWkvMax;
  const int ta = seg * SEG;
  const bool live = d < dh;
  float x[SEG];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < SEG; ++i) {
    x[i] = live && ta + i < C ? wk[(ta + i) * ld + d] : 0.f;
    run = __fadd_rn(run, x[i]);
  }
  tot[seg * kWkvMax + d] = run;
  __syncthreads();
  const int last = (C - 1) / SEG;  // the segment holding step C - 1
  float before = 0.f, cwC = 0.f;
#pragma unroll
  for (int s = 0; s < NSEG; ++s) {
    if (s < seg) before = __fadd_rn(before, tot[s * kWkvMax + d]);
    if (s <= last) cwC = __fadd_rn(cwC, tot[s * kWkvMax + d]);
  }
  if (!live) return;
  float cw[SEG], local = 0.f;
#pragma unroll
  for (int i = 0; i < SEG; ++i) {
    local = __fadd_rn(local, x[i]);
    cw[i] = __fadd_rn(before, local);
  }
#pragma unroll
  for (int i = 0; i < SEG; ++i)
    if (ta + i < C) emit(ta + i, d, x[i], cw[i], cwC);
}

// Rows [a0, a1) of RS equal parts of n, each a multiple of the micro-tile's
// M rows (so vector loads stay aligned)
template <int RS, int M>
__device__ __forceinline__ void split_range(int n, int part, int& a0, int& a1) {
  const int per = ((n + RS - 1) / RS + M - 1) / M * M;
  a0 = min(n, part * per);
  a1 = min(n, a0 + per);
}

// Pass 1.  Block (((chunk RS + rs) CS + cs), bh): out rows t in [t0, t1)
// and columns e in [e0, e1) get att v + diag v; dS_c rows d in [d0, d1)
// and columns [e0, e1) go to the workspace; the cs = 0 blocks write their
// rows of qexpᵀ (QWS) and the (0, 0) block exp(cw_C).
template <typename T, typename TW, int RS, int CS, int NT, bool QWS>
__global__ void __launch_bounds__(NT)
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const TW* __restrict__ w, const float* __restrict__ u, float* __restrict__ out,
                  float* __restrict__ ws_s, float* __restrict__ ws_w, float* __restrict__ ws_q,
                  int S, int dh, int C) {
  using SM = WkvChunkSmem<RS, CS, NT>;
  constexpr int LD = kWkvLd, LDR = SM::LDR, LDE = SM::LDE;
  // the products: 16 column groups of NR (4 in att) x NT / 16 row groups of MR
  constexpr int TM = NT / 16, MR = SM::RT / TM, NR = SM::ET / 16, NJ = kWkvMax / (NT / kWkvMax);
  static_assert(MR >= 1 && NR >= 1 && MR * TM == SM::RT, "splits against threads");
  extern __shared__ __align__(16) float sm[];
  float* wk = sm + SM::WK;  // (64, LD)    logw, then kdec in columns [d0, d1)
  float* kk = sm + SM::KK;  // (64, LD)    k; attᵀ (64, LDR) once the scan is done
  float* kt = sm + SM::KT;  // (64, LD)    kexpᵀ: row d, columns s < t1
  float* rq = sm + SM::RQ;  // (RT, LD)    r of rows [t0, t1)
  float* qt = sm + SM::QT;  // (64, LDR)   qexpᵀ: row d, column t - t0
  float* vv = sm + SM::VV;  // (64, LDE)   v, columns [e0, e1)
  float* dg = sm + SM::DG;  // (RT)        diagonal bonus
  float* uu = sm + SM::UU;  // (64)        u
  float* tt = sm + SM::TT;  // (4, 64)     the cumsum's segment totals
  float* at = kk;
  const int nC = S / C;
  const int cs = blockIdx.x % CS, rs = (blockIdx.x / CS) % RS, c = blockIdx.x / (CS * RS);
  const long long bh = blockIdx.y, cidx = bh * nC + c;
  int t0, t1, e0, e1, d0, d1;
  split_range<RS, MR>(C, rs, t0, t1);
  split_range<CS, NR>(dh, cs, e0, e1);
  split_range<RS, MR>(dh, rs, d0, d1);
  const int nt = t1 - t0, ne = e1 - e0;

  const int tid = threadIdx.x, lane = tid % 32;
  const int ty = tid / 16, tx = tid % 16;
  const long long base = (bh * S + (long long)c * C) * dh;
  {
    float xw[NJ], xk[NJ], xr[(NJ + RS - 1) / RS], xv[NJ];
    load_rows<NT>(xw, w + base, dh, 0, C, dh);
    load_rows<NT>(xk, k + base, dh, 0, C, dh);
    load_rows<NT>(xr, r + base + (long long)t0 * dh, dh, 0, nt, dh);
    load_rows<NT>(xv, v + base, dh, e0, C, ne);
    if (tid < dh) uu[tid] = u[bh * dh + tid];
    store_rows<NT>(xw, wk, LD, C, dh);
    store_rows<NT>(xk, kk, LD, C, dh);
    store_rows<NT>(xr, rq, LD, nt, dh);
    store_rows<NT>(xv, vv, LDE, C, ne);
  }
  __syncthreads();
  // diag_t = sum_d (r u) k, four threads a row (d = part + 4 j each, then
  // summed across the four)
  for (int t = t0 + tid / 4; t < t1; t += NT / 4) {
    const int part = tid % 4;
    const unsigned quad = 0xfu << (lane & ~3);
    float p = 0.f;
    for (int d = part; d < dh; d += 4)
      p += __fmul_rn(__fmul_rn(rq[(t - t0) * LD + d], uu[d]), kk[t * LD + d]);
    p += __shfl_xor_sync(quad, p, 1);
    p += __shfl_xor_sync(quad, p, 2);
    if (part == 0) dg[t - t0] = p;
  }
  // cw, then qexpᵀ, kexpᵀ and kdec (in place of logw)
  chunk_cumsum<NT>(wk, LD, C, dh, tt, [&](int t, int d, float x, float cw, float wC) {
    const float kv = kk[t * LD + d];
    if (t >= t0 && t < t1)
      qt[d * LDR + t - t0] = __fmul_rn(rq[(t - t0) * LD + d], expf(__fsub_rn(cw, x)));
    if (t < t1) kt[d * LD + t] = __fmul_rn(kv, expf(-cw));
    if (d >= d0 && d < d1) wk[t * LD + d] = __fmul_rn(kv, expf(__fsub_rn(wC, cw)));
    if (t == C - 1 && rs == 0 && cs == 0) ws_w[cidx * dh + d] = expf(wC);
  });
  __syncthreads();
  // attᵀ[s][t] = sum_d qexp[t][d] kexp[s][d] for s < t, else 0
  {
    float acc[MR][4] = {};
    fma_tile(acc, qt, LDR, ty * MR, kt, LD, tx * 4, dh);
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = ty * MR + i, s = tx * 4 + j;
        if (m < nt && s < t1) at[s * LDR + m] = s < t0 + m ? acc[i][j] : 0.f;
      }
  }
  __syncthreads();
  // intra[t][e] = sum_s att[t][s] v[s][e] and dS[d][e] = sum_t kdec[t][d]
  // v[t][e] in one pass over the rows of v, each row's load feeding both
  // (shared-memory wavefronts bound these products); the global stores
  // wait until both are done
  float intra[MR][NR] = {}, dS[MR][NR] = {};
#pragma unroll 4
  for (int x = 0; x < C; ++x) {
    float bv[NR], a1[MR], a2[MR];
    lds_vec(bv, vv + x * LDE + tx * NR);
    lds_vec(a2, wk + x * LD + d0 + ty * MR);
    if (x < t1) {
      lds_vec(a1, at + x * LDR + ty * MR);
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) intra[i][j] = fmaf(a1[i], bv[j], intra[i][j]);
    }
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < NR; ++j) dS[i][j] = fmaf(a2[i], bv[j], dS[i][j]);
  }
  const bool vec = dh % 4 == 0;  // 16-byte rows of out and dS
  const int nc = min(NR, ne - tx * NR);  // this thread's valid columns
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int m = ty * MR + i;
    if (m < nt) {  // out = att v + diag v
#pragma unroll
      for (int j = 0; j < NR; ++j)
        intra[i][j] = __fadd_rn(intra[i][j], __fmul_rn(dg[m], vv[(t0 + m) * LDE + tx * NR + j]));
      stg_row(out + base + (long long)(t0 + m) * dh + e0 + tx * NR, intra[i], nc, vec);
    }
    if (m < d1 - d0) stg_row(ws_s + (cidx * dh + d0 + m) * dh + e0 + tx * NR, dS[i], nc, vec);
  }
  if constexpr (QWS) {
    if (cs == 0) {
      const int m = tid % kWkvMax, r0 = tid / kWkvMax;
      for (int d = r0; d < dh; d += NT / kWkvMax)
        if (m < nt) ws_q[(cidx * dh + d) * C + t0 + m] = qt[d * LDR + m];
    }
  }
}

// rows x cols floats (cols <= CW, a power of 2) from global memory (row
// stride lds) to shared memory (row stride ldd) as cp.async copies by a
// block of NT threads: 16-byte chunks where vec (cols, both strides and
// both bases whole 16-byte chunks), else 4 bytes at a time.
template <int NT, int CW>
__device__ __forceinline__ void copy_rows(float* dst, int ldd, const float* src, long long lds,
                                          int rows, int cols, bool vec) {
  if (vec) {
    constexpr int Q = CW >= 4 ? CW / 4 : 1;  // chunks a row
    for (int i = threadIdx.x; i < rows * Q; i += NT) {
      const int r = i / Q, q = i % Q;
      if (q * 4 < cols) cp_async16(dst + r * ldd + q * 4, src + r * lds + q * 4, 16);
    }
  } else {
    for (int i = threadIdx.x; i < rows * CW; i += NT) {
      const int r = i / CW, q = i % CW;
      if (q < cols) cp_async4(dst + r * ldd + q, src + r * lds + q, 4);
    }
  }
}

// Pass 2.  Block (cs, bh) of NT threads owns state columns [e0, e0 + ne)
// and walks the chunks in order from s0 (or 0): out_c += qexp_c S, and S <-
// exp(cw_C) S + dS_c into the other state buffer, so one barrier a chunk
// orders them; finally s_final.  A ring of kWkvStages stages of cp.async
// copies brings the next chunks' qexpᵀ (QWS), dS columns, exp(cw_C) and
// out columns while one chunk is used.  Without QWS, qexpᵀ is recomputed
// from r and logw each chunk (loaded then, not prefetched).  Few threads
// suit it: the product of a chunk is bound by shared-memory bandwidth, which
// larger micro-tiles a thread use better.
template <typename T, typename TW, int CS2, int NT, bool QWS>
__global__ void __launch_bounds__(NT)
wkv6_state_kernel(const T* __restrict__ r, const TW* __restrict__ w, const float* __restrict__ s0,
                  const float* __restrict__ ws_s, const float* __restrict__ ws_w,
                  const float* __restrict__ ws_q, float* __restrict__ out,
                  float* __restrict__ s_final, int S, int dh, int C) {
  using SM = WkvStateSmem<CS2, NT, QWS>;
  constexpr int LD = kWkvLd, E2 = SM::E2, E2P = SM::E2P;
  // out (64 x E2) over the threads: NR columns x MR rows a thread
  constexpr int P = kWkvMax * E2 / NT, NR = P < 4 ? (P < 1 ? 1 : P) : 4;
  constexpr int MR = P / NR < 1 ? 1 : P / NR, TN = E2 / NR;
  constexpr int RE = NT / E2;  // rows a pass of a (64, E2) element loop
  static_assert(kWkvMax % CS2 == 0 && E2 >= 1 && TN * NR == E2 &&
                TN * (kWkvMax / MR) == NT && NT % E2 == 0, "column splits against threads");
  extern __shared__ __align__(16) float sm[];
  const int nC = S / C;
  const int e0 = min(dh, (int)blockIdx.x * E2), ne = min(dh, e0 + E2) - e0;
  if (ne <= 0) return;
  const long long bh = blockIdx.y;
  float* st = sm;  // 2 x (64, E2P) the state's columns [e0, e0 + ne)
  float* wk = sm + 2 * kWkvMax * E2P + kWkvStages * SM::STAGE;  // (64, LD) logw (recompute)
  float* rq = wk + kWkvMax * LD;                   // (64, LD) r (recompute only)
  float* tt = rq + kWkvMax * LD;                   // (NT) segment totals (recompute only)
  const int tid = threadIdx.x;
  const int ty = tid / TN, tx = tid % TN;
  const int ce = tid % E2, cr = tid / E2;  // a (64, E2) element loop's column and first row
  const bool vec = C % 4 == 0 && dh % 4 == 0;

  // stage s: qexpᵀ (64, LD), dS columns (64, E2P), out columns (64, E2P),
  // exp(cw_C) (64)
  auto qt_of = [&](int s) { return st + 2 * kWkvMax * E2P + s * SM::STAGE; };
  auto issue = [&](int s, int c) {
    const long long cidx = bh * nC + c;
    float* qt = qt_of(s);
    float* ds = qt + kWkvMax * LD;
    float* oi = ds + kWkvMax * E2P;
    float* wx = oi + kWkvMax * E2P;
    if constexpr (QWS) copy_rows<NT, kWkvMax>(qt, LD, ws_q + cidx * dh * C, C, dh, C, vec);
    copy_rows<NT, E2>(ds, E2P, ws_s + cidx * dh * dh + e0, dh, dh, ne, vec);
    copy_rows<NT, E2>(oi, E2P, out + (bh * S + (long long)c * C) * dh + e0, dh, C, ne, vec);
    copy_rows<NT, kWkvMax>(wx, 0, ws_w + cidx * dh, 0, 1, dh, vec);
  };

  // one commit group a chunk (empty past the last), so chunk c's group is
  // complete once at most kWkvStages - 2 later ones are pending
  for (int i = 0; i < kWkvStages - 1; ++i) {
    if (i < nC) issue(i, i);
    cp_async_commit();
  }
  // s0 (or 0) while the first chunks are on their way
  if (ce < ne)
    for (int d = cr; d < dh; d += RE) st[d * E2P + ce] = s0 ? s0[(bh * dh + d) * dh + e0 + ce] : 0.f;
  for (int c = 0; c < nC; ++c) {
    const int s = c % kWkvStages;
    cp_async_wait<kWkvStages - 2>();
    // chunk c has arrived, its state is whole, and chunk c - 1's stage and
    // state buffer are free
    __syncthreads();
    const float* sc = st + (c & 1) * kWkvMax * E2P;
    float* sn = st + ((c + 1) & 1) * kWkvMax * E2P;
    float* qt = qt_of(s);
    const float* ds = qt + kWkvMax * LD;
    const float* oi = ds + kWkvMax * E2P;
    const float* wx = oi + kWkvMax * E2P;
    const long long base = (bh * S + (long long)c * C) * dh;
    if constexpr (!QWS) {
      constexpr int NJ = kWkvMax / (NT / kWkvMax);
      float xr[NJ], xw[NJ];
      load_rows<NT>(xr, r + base, dh, 0, C, dh);
      load_rows<NT>(xw, w + base, dh, 0, C, dh);
      store_rows<NT>(xw, wk, LD, C, dh);
      store_rows<NT>(xr, rq, LD, C, dh);
      __syncthreads();
      chunk_cumsum<NT>(wk, LD, C, dh, tt, [&](int t, int d, float x, float cw, float) {
        qt[d * LD + t] = __fmul_rn(rq[t * LD + d], expf(__fsub_rn(cw, x)));
      });
      __syncthreads();
    }
    // out[t][e] = sum_d qexp[t][d] S[d][e] + (att v + diag v)[t][e]
    {
      float acc[MR][NR] = {};
      fma_tile(acc, qt, LD, ty * MR, sc, E2P, tx * NR, dh);
      const int nc = min(NR, ne - tx * NR);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int t = ty * MR + i;
        if (t >= C) continue;
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[i][j] = __fadd_rn(acc[i][j], oi[t * E2P + tx * NR + j]);
        stg_row(out + base + (long long)t * dh + e0 + tx * NR, acc[i], nc, dh % 4 == 0);
      }
    }
    // the copies of chunk c + kWkvStages - 1 go out after the product, whose
    // shared-memory loads they would otherwise queue behind
    if (c + kWkvStages - 1 < nC) issue((c + kWkvStages - 1) % kWkvStages, c + kWkvStages - 1);
    cp_async_commit();
    if (ce < ne)
      for (int d = cr; d < dh; d += RE)
        sn[d * E2P + ce] = __fadd_rn(__fmul_rn(wx[d], sc[d * E2P + ce]), ds[d * E2P + ce]);
  }
  __syncthreads();
  const float* sf = st + (nC & 1) * kWkvMax * E2P;
  if (ce < ne)
    for (int d = cr; d < dh; d += RE) s_final[(bh * dh + d) * dh + e0 + ce] = sf[d * E2P + ce];
}

// Both passes of one geometry on the caller's stream; ws holds
// wkv_ws_elems(BH, S, dh, C, QWS) floats.
template <typename T, typename TW, int RS, int CS, int NT, int CS2, int NT2, bool QWS>
static cudaError_t launch_wkv6(const void* r, const void* k, const void* v, const void* w,
                               const float* u, const float* s0, float* out, float* s_final,
                               float* ws, int BH, int S, int dh, int C, cudaStream_t stream) {
  const long long nC = S / C;
  float* ws_s = ws;
  float* ws_w = ws_s + BH * nC * dh * dh;
  float* ws_q = ws_w + BH * nC * dh;
  const size_t smem1 = WkvChunkSmem<RS, CS, NT>::floats * sizeof(float);
  auto pass1 = wkv6_chunk_kernel<T, TW, RS, CS, NT, QWS>;
  cudaError_t e = allow_smem(pass1, smem1);
  if (e != cudaSuccess) return e;
  // a block: one chunk's C steps at one of the RS x CS splits; writes every
  // (bh, chunk)'s dS, exp(cw) and (QWS) qexp
  const dim3 grid1(static_cast<unsigned>(nC * RS * CS), BH);
  record_launch(pass1, "wkv6_chunk_kernel", grid1, NT, smem1, {(long long)S * RS * CS, C},
                {BH, 1}, {}, wkv_ws_elems(BH, S, dh, C, QWS));
  pass1<<<grid1, NT, smem1, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, out, ws_s, ws_w, ws_q, S, dh, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem2 = WkvStateSmem<CS2, NT2, QWS>::floats * sizeof(float);
  auto pass2 = wkv6_state_kernel<T, TW, CS2, NT2, QWS>;
  e = allow_smem(pass2, smem2);
  if (e != cudaSuccess) return e;
  // the state's dh columns in blocks of E2 (no block past dh)
  constexpr int E2 = WkvStateSmem<CS2, NT2, QWS>::E2;
  const dim3 grid2((dh + E2 - 1) / E2, BH);
  record_launch(pass2, "wkv6_state_kernel", grid2, NT2, smem2, {dh, E2}, {BH, 1});
  pass2<<<grid2, NT2, smem2, stream>>>(
      static_cast<const T*>(r), static_cast<const TW*>(w), s0, ws_s, ws_w, ws_q, out, s_final, S,
      dh, C);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_wkv6_w(int wdtype, const void* r, const void* k, const void* v,
                                 const void* w, const float* u, const float* s0, float* out,
                                 float* s_final, float* ws, int BH, int S, int dh, int C,
                                 cudaStream_t stream) {
  constexpr int RS = kWkvRowSplits, CS = kWkvColSplits, NT = kWkvChunkThreads;
  constexpr int CS2 = kWkvStateSplits, NT2 = kWkvStateThreads;
  constexpr bool Q = kWkvQexpWs;
  if (wdtype == kF32)
    return launch_wkv6<T, float, RS, CS, NT, CS2, NT2, Q>(r, k, v, w, u, s0, out, s_final, ws, BH,
                                                          S, dh, C, stream);
  if (wdtype == kBF16)
    return launch_wkv6<T, __nv_bfloat16, RS, CS, NT, CS2, NT2, Q>(r, k, v, w, u, s0, out, s_final,
                                                                  ws, BH, S, dh, C, stream);
  return cudaErrorInvalidValue;
}

inline bool wkv_shape_ok(int BH, int S, int dh, int C) {
  return BH >= 0 && BH <= 65535 && S >= 0 && dh > 0 && dh <= kWkvMax && C > 0 && C <= kWkvMax &&
         S % C == 0;
}

}  // namespace famous

// The chunks a (batch, head) runs (S / C; 0 for a shape the kernel refuses)
// and, in *ws_elems, the f32 workspace the wrapper allocates for a launch.
extern "C" int famous_wkv6_scan_plan(int BH, int S, int dh, int C, long long* ws_elems) {
  using namespace famous;
  *ws_elems = 0;
  if (!wkv_shape_ok(BH, S, dh, C)) return 0;
  *ws_elems = wkv_ws_elems(BH, S, dh, C, kWkvQexpWs);
  return S / C;
}

// s0 may be null (a zero initial state); ws: famous_wkv6_scan_plan's
// workspace.
extern "C" int famous_wkv6_scan(int dtype, int wdtype, const void* r, const void* k,
                                const void* v, const void* w, const void* u, const void* s0,
                                void* out, void* s_final, void* ws, int BH, int S, int dh, int C,
                                void* stream) {
  using namespace famous;
  if (!wkv_shape_ok(BH, S, dh, C) || (BH > 0 && S > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* o = static_cast<float*>(out);
  float* sf = static_cast<float*>(s_final);
  float* wsf = static_cast<float*>(ws);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_wkv6_w<float>(wdtype, r, k, v, w, uf, s0f, o, sf, wsf, BH, S, dh, C, s);
  else if (dtype == kBF16)
    e = launch_wkv6_w<__nv_bfloat16>(wdtype, r, k, v, w, uf, s0f, o, sf, wsf, BH, S, dh, C, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
