// matmul_tiled_int8: out(T, F) = (Xq(T, D) @ Wq(D, F)) * sx(T) * sw(F) with
// int8 operands, an exact int32 accumulator and the dequantize on flush, f32
// out.  The QKV_PM of the FAMOUS paper in its own 8-bit fixed point: W is
// the fused [Wq|Wk|Wv] matrix quantized per column, X quantized per token.
//
//   xq   (T, D) int8 row-major
//   wqt  (F, D) int8 row-major: the quantized W stored TRANSPOSED, so that
//        the 32 consecutive D values an int8 mma wants for one column are
//        contiguous (the model quantizes and transposes W once, at load)
//   sx   (T,) f32, sw (F,) f32
//   out  (T, F) f32 = float(acc) * sx[t] * sw[f], two f32 multiplies in
//        that order and no add, so the result equals the plain version
//        (repro_torch/kernels/qkv/ref.py) bit for bit.
//
// Replaces: src/repro/kernels/qkv/qkv_proj.py, matmul_tiled_int8 (the
// Pallas kernel _proj_kernel_int8).  There the reduction over D is a
// sequential grid axis carrying a VMEM int32 accumulator from one grid step
// to the next, flushed through the scales at the last step.  Here a block
// owns one (BM x BN) output tile and runs its D range itself, the
// accumulator in registers; ragged T, F and D are masked (zero-filled
// tiles) instead of asserting divisibility.
//
// What bounds it on an H100: at decode (T = 4 slots) and verify (T = 20)
// the product reads all of W once, 16.5 MB of int8 at qwen2-7b's 3584 x
// 4608, so it is bound by memory (about 5 us at 3.35 TB/s, half the bf16
// kernel's bytes); at a 256-token chunk (8.5 G int8 ops, 22 MB) still by
// bytes (6.6 us) with the ops close behind (4.3 us at 1979 TOPS).
//
// Design: int8 tensor-core mma.sync (m16n8k32, s8 x s8 -> s32) on tiles
// staged through padded shared memory (rows 16 bytes longer than the tile:
// conflict-free ldmatrix) by a multi-stage ring of 16-byte cp.async copies,
// so the loads of the next D steps are in flight while one is multiplied.
// Both fragments come by ldmatrix (an 8 x 8 b16 matrix is 8 rows of 16
// int8 values, the layout of an int8 A or B fragment), four registers an
// instruction.  Two regimes, chosen from the static T:
//   T <= 32  16 (or 32) rows over W stripes of kI8SmallBN columns, with
//            the D range split across blocks (split-K) so that stripes x
//            splits fill one wave of two blocks an SM, each with its ring
//            of W in flight; each split writes its int32 partial tile to a
//            workspace the wrapper allocates, and a second pass adds them
//            in split order and applies the two multiplies.  Integer adds
//            are exact, so the result is the plain version's in any order.
//   T > 32   64 x 96 output tiles of 6 warps (32 x 32 each), 128-deep D
//            steps in a 3-stage ring: 192 blocks at T = 256, F = 4608, all
//            resident in one wave.  The int8 mma.sync rate of an SM bounds
//            a block, so filling the SMs counts for more than the re-reads
//            of X (once per column stripe) and W (once per row tile) from
//            L2: 128 x 128 tiles leave 60 of 132 SMs idle and ran 1.7x
//            slower, with or without split-K.
// The geometry and the split rule were chosen by
// scripts/torch_kernel_sweep.py (its int8 part; PERF.md).  wgmma, TMA and
// a persistent schedule are left for a later change.
#include "common.cuh"

#include <algorithm>

namespace famous {

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [r0, r0 + R) x cols [k0, k0 + BK) of a row-major (rows, D) int8
// matrix into a shared tile of row stride LD bytes, zero-filling what lies
// outside.  vec: D % 16 == 0 and 16-byte aligned rows, so each 16-byte
// chunk is wholly inside or outside and goes by cp.async; otherwise bytes
// are copied one by one (ragged D).
template <int R, int BK, int LD, int NT>
__device__ __forceinline__ void load_tile(int8_t* tile, const int8_t* __restrict__ g, int r0,
                                          int rows, int k0, int D, bool vec) {
  if (vec) {
    constexpr int CPR = BK / 16;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < R * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * 16;
      const bool ok = r0 + r < rows && k0 + c < D;
      const int8_t* src = ok ? g + (long long)(r0 + r) * D + k0 + c : g;
      cp_async16(tile + r * LD + c, src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const bool ok = r0 + r < rows && k0 + c < D;
      tile[r * LD + c] = ok ? g[(long long)(r0 + r) * D + k0 + c] : int8_t(0);
    }
  }
}

// A geometry: BM x BN output tiles of WM x WN warps, BK-deep D steps in a
// ring of S stages; rows of BK + 16 bytes.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int S_>
struct I8Tiles {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, S = S_;
  static constexpr int NT = 32 * WM * WN, LD = BK + 16;
  static constexpr size_t bytes = (size_t)S * (BM + BN) * LD;
};

// Block (x, y, z) computes the (BM x BN) tile at rows y * BM, columns
// x * BN over D steps [z * kps, (z + 1) * kps) of BK.  part == nullptr:
// the block owns all of D and writes the dequantized f32 out; else it
// writes its int32 partial tile to part[z] (T x F).
template <typename G>
__global__ void __launch_bounds__(G::NT)
matmul_int8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wqt,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   float* __restrict__ out, int* __restrict__ part, int Tn, int D, int F,
                   int kps, int vec) {
  constexpr int BM = G::BM, BN = G::BN, BK = G::BK, WN = G::WN, S = G::S, NT = G::NT;
  constexpr int LD = G::LD;
  constexpr int WTM = BM / G::WM, WTN = BN / WN;  // warp tile
  constexpr int MI = WTM / 16, NI = WTN / 8;      // mma tiles per warp
  static_assert(MI >= 1 && NI % 2 == 0 && BK % 32 == 0, "tile shape");
  extern __shared__ __align__(16) int8_t i8_smem[];
  int8_t* as = i8_smem;             // stage s at as + s BM LD
  int8_t* bs = as + S * BM * LD;    // stage s at bs + s BN LD

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group id, thread in group
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * kps;
  const int nk = max(0, min((D + BK - 1) / BK - kt0, kps));
  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  auto load = [&](int stage, int kt) {
    const int k0 = (kt0 + kt) * BK;
    load_tile<BM, BK, LD, NT>(as + stage * BM * LD, xq, m0, Tn, k0, D, vec);
    load_tile<BN, BK, LD, NT>(bs + stage * BN * LD, wqt, n0, F, k0, D, vec);
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
    const int8_t* a_t = as + (kt % S) * BM * LD;
    const int8_t* b_t = bs + (kt % S) * BN * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[MI][4], b[NI][2];
      // A matrices: (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31),
      // (8-15, 16-31): a0..a3 of the m16n8k32 fragment
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], a_t + (wm * WTM + i * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 16);
      // B matrices: (n 8j.., k 0-15), (8j.., k 16-31), (8j+8.., k 0-15),
      // (8j+8.., k 16-31): the b0 / b1 of n-tiles j and j + 1
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        unsigned r[4];
        ldmatrix_x4(r, b_t + (wn * WTN + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk +
                           ((lane >> 3) & 1) * 16);
        b[j][0] = r[0], b[j][1] = r[1], b[j + 1][0] = r[2], b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // flush: accumulator element r sits at row g (+8 for r >= 2), column
  // 2t (+1 for odd r) of its 16 x 8 mma tile
  int* pz = part ? part + (long long)blockIdx.z * Tn * F : nullptr;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm * WTM + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn * WTN + j * 8 + 2 * t + (r & 1);
        if (row >= Tn || col >= F) continue;
        const long long o = (long long)row * F + col;
        if (pz)
          pz[o] = acc[i][j][r];
        else
          out[o] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][r]), sx[row]), sw[col]);
      }
}

// The second pass of split-K: the int32 partials added in split order z =
// 0, 1, ... (exact), then the flush's two multiplies.
__global__ void __launch_bounds__(256)
matmul_int8_reduce_kernel(const int* __restrict__ part, const float* __restrict__ sx,
                          const float* __restrict__ sw, float* __restrict__ out, int F,
                          int splits, long long n) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n;
       i += 256LL * gridDim.x) {
    int s = 0;
    for (int z = 0; z < splits; ++z) s += part[z * n + i];
    out[i] = __fmul_rn(__fmul_rn(__int2float_rn(s), sx[i / F]), sw[i % F]);
  }
}

// One geometry's launch, both passes (the second when splits > 1)
template <typename G>
static cudaError_t launch_int8(const int8_t* xq, const int8_t* wqt, const float* sx,
                               const float* sw, float* out, int* part, int splits, int Tn, int D,
                               int F, int vec, cudaStream_t stream) {
  auto kernel = matmul_int8_kernel<G>;
  cudaError_t e = allow_smem(kernel, G::bytes);
  if (e != cudaSuccess) return e;
  const int nk = (D + G::BK - 1) / G::BK;
  const int kps = (nk + splits - 1) / splits;
  const dim3 grid((F + G::BN - 1) / G::BN, (Tn + G::BM - 1) / G::BM, splits);
  if (grid.y > 65535 || splits > 65535) return cudaErrorInvalidValue;
  record_launch(kernel, "matmul_int8_kernel", grid, G::NT, G::bytes, {F, G::BN}, {Tn, G::BM},
                {nk, kps}, splits > 1 ? (long long)grid.z * Tn * F : 0);
  kernel<<<grid, G::NT, G::bytes, stream>>>(xq, wqt, sx, sw, out, splits > 1 ? part : nullptr, Tn,
                                            D, F, kps, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long n = (long long)Tn * F;
  const int blocks = static_cast<int>(std::min<long long>((n + 255) / 256, 4096));
  record_launch(matmul_int8_reduce_kernel, "matmul_int8_reduce_kernel", dim3(blocks), 256, 0,
                {n, 256, true});
  matmul_int8_reduce_kernel<<<blocks, 256, 0, stream>>>(part, sx, sw, out, F, splits, n);
  return cudaGetLastError();
}

// The small-T regime: W stripes of kI8SmallBN columns, kI8SmallBK-deep D
// steps, 4 warps along the stripe
constexpr int kI8SmallT = 32, kI8SmallBN = 128, kI8SmallBK = 128;
using I8Decode = I8Tiles<16, kI8SmallBN, kI8SmallBK, 1, 4, 3>;  // T <= 16
using I8Verify = I8Tiles<32, kI8SmallBN, kI8SmallBK, 1, 4, 3>;  // 16 < T <= 32
using I8Chunk = I8Tiles<64, 96, 128, 2, 3, 3>;                  // T > 32

}  // namespace famous

// The split count, from static shapes and the SM count only.  T <= 32: as
// many W stripes x splits as fit two blocks an SM in one wave (rounded
// down: a second, partial wave costs more than the blocks it adds), each
// split at least 4 D steps deep, no split left empty.  T > 32: 1.
// *ws_elems: the int32 workspace of the split partials (splits x T x F; 0
// for one split), which the wrapper allocates.
extern "C" int famous_matmul_tiled_int8_plan(int Tn, int D, int F, int sms,
                                             long long* ws_elems) {
  using namespace famous;
  *ws_elems = 0;
  if (Tn > kI8SmallT || Tn <= 0 || D <= 0 || F <= 0) return 1;
  const int stripes = (F + kI8SmallBN - 1) / kI8SmallBN;
  const int nk = (D + kI8SmallBK - 1) / kI8SmallBK;
  int splits = 2 * sms / stripes;
  splits = std::max(1, std::min(splits, nk / 4));
  const int kps = (nk + splits - 1) / splits;
  splits = (nk + kps - 1) / kps;
  if (splits > 1) *ws_elems = (long long)splits * Tn * F;
  return splits;
}

// part: the int32 workspace of famous_matmul_tiled_int8_plan when splits >
// 1, else null.
extern "C" int famous_matmul_tiled_int8(const void* xq, const void* wqt, const void* sx,
                                        const void* sw, void* out, void* part, int splits,
                                        int Tn, int D, int F, void* stream) {
  using namespace famous;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tn <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  if (D <= 0 || splits < 1 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wqt);
  const int vec = D % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const float* a = static_cast<const float*>(sx);
  const float* b = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  int* p = static_cast<int*>(part);
  cudaError_t e;
  if (Tn <= 16)  // decode
    e = launch_int8<I8Decode>(x, w, a, b, o, p, splits, Tn, D, F, vec, s);
  else if (Tn <= kI8SmallT)  // speculative verify (n_slots x (draft_k + 1) rows)
    e = launch_int8<I8Verify>(x, w, a, b, o, p, splits, Tn, D, F, vec, s);
  else  // prefill chunk
    e = launch_int8<I8Chunk>(x, w, a, b, o, p, splits, Tn, D, F, vec, s);
  return static_cast<int>(e);
}
