// matmul_tiled: out(T, F) = X(T, D) @ W(D, F), f32 accumulation, one cast
// to the operands' dtype on the way out.  The QKV_PM of the FAMOUS paper
// (Algorithm 1): W is the fused [Wq|Wk|Wv] matrix, so one read of an X
// tile feeds all three projections.  Also both products of its VJP (dX =
// g·Wᵀ, dW = Xᵀ·g, on contiguous transposed copies).
//
// Replaces: src/repro/kernels/qkv/qkv_proj.py, matmul_tiled (the Pallas
// kernel _proj_kernel launched by _matmul_call).  There the reduction over
// D is a sequential grid axis that carries a VMEM f32 accumulator from one
// grid step to the next.  Here a block runs its D range itself with the
// accumulator in registers; ragged T, D and F are masked (zero-filled
// tiles) instead of asserting divisibility.
//
// What bounds it on an H100: at decode (T = 4 slots) and verify (T = 20)
// the product reads the whole W once, 33.0 MB in bf16 for qwen2-7b
// (3584 x 4608), so it is bound by memory (9.9 us at 3.35 TB/s); at a
// 256-token chunk it is 8.5 GFLOP, near the bf16 ridge (8.6 us at 989
// TFLOP/s, 11 us of bytes); training products are bound by operations.
//
// Design, bf16: tensor-core mma.sync m16n8k16 (bf16 x bf16 -> f32).  A
// fragments come from the X tile by ldmatrix, B fragments straight from
// the row-major (BK x BN) W tile by ldmatrix.trans, so W keeps its (D, F)
// layout.  Tiles are staged through padded shared memory (rows 16 bytes
// longer than the tile: conflict-free ldmatrix) by a multi-stage ring of
// 16-byte cp.async copies: the next D steps load while one multiplies.
// Two regimes, chosen from the static T:
//   T <= 32  rows padded to 16 (or 32), 128-column W stripes, 64-deep D
//            steps; the D range is split across blocks (split-K) so that
//            up to two blocks per SM stream W in one wave, each with up
//            to 48 KB in flight.  Each split writes its f32 partial tile to a
//            workspace (allocated by the wrapper); a second kernel sums
//            the splits in a fixed order and casts once, so the result is
//            the same bit for bit from launch to launch (no atomics).
//   T > 32   64-deep D steps and 32 x 32 warp tiles.  Up to T = 256 (a
//            serving chunk) 64 x 64 output tiles of 4 warps in a 4-stage
//            ring: 288 blocks at F = 4608, about two per SM, which balance
//            the SMs better than 144 blocks of 64 x 128 would.  Above
//            (training products) 64 x 128 tiles of 8 warps in a 3-stage
//            ring.
// Within a D step the ldmatrix fragments are double-buffered, so the next
// 16-deep slice loads while the current one multiplies.
// The 16-byte path needs D and F multiples of 8 and 16-byte aligned
// operands; otherwise the same kernel loads its tiles element by element.
//
// f32: the CUDA-core kernel of the first port, in full f32 FMAs (no
// TF32): 8 x 32 tiles at T <= 32, 64 x 64 tiles with a 4 x 4 register
// micro-tile above.  wgmma, TMA and a persistent schedule are left for a
// later change.
#include "common.cuh"

#include <algorithm>

namespace famous {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int BT, int BF, int BD, int TM, int TN>
__global__ void __launch_bounds__((BT / TM) * (BF / TN))
matmul_tiled_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int Tn, int D, int F) {
  constexpr int NX = BF / TN;  // threads along F
  constexpr int NY = BT / TM;  // threads along T
  constexpr int NT = NX * NY;
  __shared__ float xs[BT][BD + 1];
  __shared__ float ws[BD][BF];
  const int tid = threadIdx.x;
  const int tx = tid % NX, ty = tid / NX;
  const int t0 = blockIdx.y * BT, f0 = blockIdx.x * BF;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += BD) {
    for (int i = tid; i < BT * BD; i += NT) {
      const int r = i / BD, c = i % BD, t = t0 + r, d = d0 + c;
      xs[r][c] = (t < Tn && d < D) ? to_f(x[(long long)t * D + d]) : 0.f;
    }
    for (int i = tid; i < BD * BF; i += NT) {
      const int r = i / BF, c = i % BF, d = d0 + r, f = f0 + c;
      ws[r][c] = (d < D && f < F) ? to_f(w[(long long)d * F + f]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BD; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + NY * i][k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k][tx + NX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty + NY * i;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tx + NX * j;
      if (f < F) out[(long long)t * F + f] = from_f<T>(acc[i][j]);
    }
  }
}

template <int BT, int BF, int BD, int TM, int TN>
static cudaError_t launch_f32(const float* x, const float* w, float* out, int Tn, int D, int F,
                              cudaStream_t stream) {
  dim3 grid((F + BF - 1) / BF, (Tn + BT - 1) / BT);
  constexpr unsigned threads = (BT / TM) * (BF / TN);
  record_launch(matmul_tiled_kernel<float, BT, BF, BD, TM, TN>, "matmul_tiled_kernel<f32>", grid,
                threads, 0, {F, BF}, {Tn, BT});
  matmul_tiled_kernel<float, BT, BF, BD, TM, TN><<<grid, threads, 0, stream>>>(x, w, out, Tn, D, F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Copy rows [r0, r0 + R) x cols [c0, c0 + C) of a row-major (rows, cols)
// bf16 matrix into a shared tile of row stride LD elements, zero-filling
// what lies outside.  vec: cols % 8 == 0 and a 16-byte aligned base, so
// each 8-element chunk is wholly inside or outside and goes by cp.async;
// otherwise element by element (ragged D or F).
template <int R, int C, int LD, int NT>
__device__ __forceinline__ void load_tile_bf16(bf16* tile, const bf16* __restrict__ g, int r0,
                                               int rows, int c0, int cols, bool vec) {
  if (vec) {
    constexpr int CPR = C / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < R * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = r0 + r < rows && c0 + c < cols;
      const bf16* src = ok ? g + (long long)(r0 + r) * cols + c0 + c : g;
      cp_async16(tile + r * LD + c, src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += NT) {
      const int r = i / C, c = i % C;
      const bool ok = r0 + r < rows && c0 + c < cols;
      tile[r * LD + c] = ok ? g[(long long)(r0 + r) * cols + c0 + c] : __float2bfloat16(0.f);
    }
  }
}

template <int BM, int BN, int BK, int S>
constexpr size_t bf16_smem_bytes() {
  return (size_t)S * (BM * (BK + 8) + BK * (BN + 8)) * sizeof(bf16);
}

// Block (x, y, z) computes the (BM x BN) tile at rows y * BM, columns
// x * BN over D steps [z * kps, (z + 1) * kps) of BK.  part == nullptr:
// the block owns all of D and writes bf16 out; else it writes its f32
// partial tile to part[z] (T x F).
template <int BM, int BN, int BK, int WM, int WN, int S>
__global__ void __launch_bounds__(32 * WM * WN)
matmul_tiled_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         bf16* __restrict__ out, float* __restrict__ part, int Tn, int D,
                         int F, int kps, int vec) {
  constexpr int NT = 32 * WM * WN;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int MI = WTM / 16, NI = WTN / 8;   // mma tiles per warp
  constexpr int LDA = BK + 8, LDB = BN + 8;    // padded rows (16 bytes)
  static_assert(MI >= 1 && NI % 2 == 0 && BK % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = as + S * BM * LDA;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group id, thread in group
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk_all = (D + BK - 1) / BK;
  const int kt0 = blockIdx.z * kps;
  const int nk = max(0, min(nk_all - kt0, kps));
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  auto load = [&](int stage, int kt) {
    const int k0 = (kt0 + kt) * BK;
    load_tile_bf16<BM, BK, LDA, NT>(as + stage * BM * LDA, x, m0, Tn, k0, D, vec);
    load_tile_bf16<BK, BN, LDB, NT>(bs + stage * BK * LDB, w, k0, D, n0, F, vec);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();  // the tiles of step kt have landed
    __syncthreads();         // ... for every thread; step kt - 1's buffer is free
    if (kt + S - 1 < nk) load((kt + S - 1) % S, kt + S - 1);
    cp_async_commit();
    const bf16* a_t = as + (kt % S) * BM * LDA;
    const bf16* b_t = bs + (kt % S) * BK * LDB;
    // fragments double-buffered: those of the next 16-deep step load while
    // this step's mma run
    unsigned a[2][MI][4], b[2][NI][2];
    auto frags = [&](int buf, int kk) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[buf][i],
                    a_t + (wm * WTM + i * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
        // (k 8-15, n 8-15): the b0b1 / b2b3 halves of n-tiles j and j + 1
        unsigned r[4];
        ldmatrix_x4_trans(r, b_t + (kk + (lane & 15)) * LDB + wn * WTN + j * 8 + (lane >> 4) * 8);
        b[buf][j][0] = r[0];
        b[buf][j][1] = r[1];
        b[buf][j + 1][0] = r[2];
        b[buf][j + 1][1] = r[3];
      }
    };
    frags(0, 0);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      if (ks + 1 < BK / 16) frags((ks + 1) & 1, (ks + 1) * 16);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_bf16(acc[i][j], a[ks & 1][i], b[ks & 1][j][0], b[ks & 1][j][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator element r sits at row g (+8 for r >= 2), column 2t (+1 for
  // odd r) of its 16 x 8 mma tile
  float* pz = part ? part + (long long)blockIdx.z * Tn * F : nullptr;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WTM + i * 16 + g + 8 * h;
        const int col = n0 + wn * WTN + j * 8 + 2 * t;
        if (row >= Tn) continue;
        const long long o = (long long)row * F + col;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= F) continue;
          if (pz)
            pz[o + e] = acc[i][j][2 * h + e];
          else
            out[o + e] = __float2bfloat16(acc[i][j][2 * h + e]);
        }
      }
}

// The second pass of split-K: out[i] = bf16(sum over z of part[z][i]),
// the splits summed in order z = 0, 1, ... (fixed, so deterministic).
__global__ void matmul_tiled_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                                           int splits, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * n + i];
    out[i] = __float2bfloat16(s);
  }
}

// the small-T regime: 64-deep D steps over 128-column W stripes; up to
// kChunkT rows (a serving chunk), 64 x 64 output tiles
constexpr int kSmallT = 32, kSmallBN = 128, kSmallBK = 64, kChunkT = 256;

template <int BM, int BN, int BK, int WM, int WN, int S>
static cudaError_t launch_bf16(const bf16* x, const bf16* w, bf16* out, float* part, int Tn,
                               int D, int F, int splits, int vec, cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<BM, BN, BK, S>();
  auto kernel = matmul_tiled_bf16_kernel<BM, BN, BK, WM, WN, S>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int nk = (D + BK - 1) / BK;
  const int kps = (nk + splits - 1) / splits;
  dim3 grid((F + BN - 1) / BN, (Tn + BM - 1) / BM, splits);
  // the D steps over the z blocks; split partials of T x F each
  record_launch(kernel, "matmul_tiled_bf16_kernel", grid, 32 * WM * WN, smem, {F, BN}, {Tn, BM},
                {nk, kps}, part ? (long long)grid.z * Tn * F : 0);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(x, w, out, part, Tn, D, F, kps, vec);
  return cudaGetLastError();
}

}  // namespace famous

// The split count of the bf16 small-T regime, from static shapes and the
// SM count only: as many 128-column stripes x splits as fit two blocks
// per SM in one wave (rounded down: a second, partial wave costs more than
// the blocks it adds), each split at least 4 D steps deep, no split left
// empty.  1 for f32, for T > 32 and where one split already fills the
// card.  *ws_elems:
// the f32 workspace of the split partials (splits x T x F; 0 for one
// split), which the wrapper allocates.
extern "C" int famous_matmul_tiled_plan(int dtype, int Tn, int D, int F, int sms,
                                        long long* ws_elems) {
  using namespace famous;
  *ws_elems = 0;
  if (dtype != kBF16 || Tn > kSmallT || Tn <= 0 || D <= 0 || F <= 0) return 1;
  const int stripes = (F + kSmallBN - 1) / kSmallBN;
  const int nk = (D + kSmallBK - 1) / kSmallBK;
  int splits = 2 * sms / stripes;
  splits = std::max(1, std::min(splits, nk / 4));
  const int kps = (nk + splits - 1) / splits;
  splits = (nk + kps - 1) / kps;
  if (splits > 1) *ws_elems = (long long)splits * Tn * F;
  return splits;
}

// part: the workspace of famous_matmul_tiled_plan when splits > 1, else null.
extern "C" int famous_matmul_tiled(int dtype, const void* x, const void* w, void* out,
                                   void* part, int splits, int Tn, int D, int F, void* stream) {
  using namespace famous;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tn <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  if (D <= 0 || splits < 1 || (splits > 1 && (part == nullptr || dtype != kBF16 || Tn > kSmallT)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == kF32) {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* of = static_cast<float*>(out);
    e = Tn <= kSmallT ? launch_f32<8, 32, 64, 1, 1>(xf, wf, of, Tn, D, F, s)    // decode
                      : launch_f32<64, 64, 32, 4, 4>(xf, wf, of, Tn, D, F, s);  // chunk
  } else if (dtype == kBF16) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* ob = static_cast<bf16*>(out);
    float* pf = splits > 1 ? static_cast<float*>(part) : nullptr;
    const int vec = D % 8 == 0 && F % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (Tn <= 16)  // decode: 1 warp row x 4 warp columns of 16 x 32
      e = launch_bf16<16, kSmallBN, kSmallBK, 1, 4, 4>(xb, wb, ob, pf, Tn, D, F, splits, vec, s);
    else if (Tn <= kSmallT)  // speculative verify (n_slots x (draft_k + 1) rows)
      e = launch_bf16<32, kSmallBN, kSmallBK, 2, 4, 4>(xb, wb, ob, pf, Tn, D, F, splits, vec, s);
    else if (Tn <= kChunkT)  // prefill chunk: 2 x 2 warps of 32 x 32
      e = launch_bf16<64, 64, 64, 2, 2, 4>(xb, wb, ob, nullptr, Tn, D, F, 1, vec, s);
    else  // training: 2 x 4 warps of 32 x 32
      e = launch_bf16<64, 128, 64, 2, 4, 3>(xb, wb, ob, nullptr, Tn, D, F, 1, vec, s);
    if (e == cudaSuccess && pf) {
      const long long n = (long long)Tn * F;
      const int blocks = static_cast<int>(std::min<long long>((n + 255) / 256, 4096));
      record_launch(matmul_tiled_reduce_kernel, "matmul_tiled_reduce_kernel", dim3(blocks), 256,
                    0, {n, 256, true});
      matmul_tiled_reduce_kernel<<<blocks, 256, 0, s>>>(pf, ob, splits, n);
      e = cudaGetLastError();
    }
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
