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
// to the next, flushed through the scales at the last step.  Here one block
// owns one (BM x BN) output tile and runs the whole D loop itself, the
// accumulator in registers; ragged T, F and D are masked (zero-filled
// tiles) instead of asserting divisibility.
//
// What bounds it on an H100: at decode (T = 4 slots) and verify (T = 20)
// the product reads all of W once, 16.5 MB of int8 at qwen2-7b's 3584 x
// 4608, so it is bound by memory (about 5 us at 3.35 TB/s, half the bf16
// kernel's bytes); at a 256-token chunk (8.5 G int8 ops, 22 MB) still by
// bytes (6.6 us) with the ops close behind (4.3 us at 1979 TOPS).  Design:
// int8 tensor-core mma.sync (m16n8k32, s8 x s8 -> s32) on tiles staged
// through shared memory by cp.async in a 3-stage ring, so the loads of the
// next two D steps are in flight while one is multiplied; narrow tiles for
// small T (16 x 32 at decode: F / 32 = 144 blocks each stream their own
// W stripe once), 64 x 64 tiles for a prefill chunk.  wgmma, TMA and a
// persistent schedule are left for a later change.
#include "common.cuh"

namespace famous {

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

template <int BM, int BN, int BK, int WM, int WN, int S>
__global__ void __launch_bounds__(32 * WM * WN)
matmul_int8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wqt,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   float* __restrict__ out, int Tn, int D, int F, int vec) {
  constexpr int NT = 32 * WM * WN;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int MI = WTM / 16, NI = WTN / 8;   // mma tiles per warp
  constexpr int LD = BK + 16;  // padded row: 16-byte aligned, no bank conflicts
  static_assert(MI >= 1 && NI >= 1 && BK % 32 == 0, "tile shape");
  __shared__ __align__(16) int8_t as[S][BM * LD];
  __shared__ __align__(16) int8_t bs[S][BN * LD];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group id, thread in group
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (D + BK - 1) / BK;
  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) {
      load_tile<BM, BK, LD, NT>(as[s], xq, m0, Tn, s * BK, D, vec);
      load_tile<BN, BK, LD, NT>(bs[s], wqt, n0, F, s * BK, D, vec);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();  // the tiles of step kt have landed
    __syncthreads();         // ... for every thread; step kt - 1's buffer is free
    const int nxt = kt + S - 1;
    if (nxt < nk) {
      load_tile<BM, BK, LD, NT>(as[nxt % S], xq, m0, Tn, nxt * BK, D, vec);
      load_tile<BN, BK, LD, NT>(bs[nxt % S], wqt, n0, F, nxt * BK, D, vec);
    }
    cp_async_commit();
    const int8_t* a_t = as[kt % S];
    const int8_t* b_t = bs[kt % S];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      int a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* r = a_t + (wm * WTM + i * 16 + g) * LD + kk + t * 4;
        a[i][0] = *reinterpret_cast<const int*>(r);
        a[i][1] = *reinterpret_cast<const int*>(r + 8 * LD);
        a[i][2] = *reinterpret_cast<const int*>(r + 16);
        a[i][3] = *reinterpret_cast<const int*>(r + 8 * LD + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* r = b_t + (wn * WTN + j * 8 + g) * LD + kk + t * 4;
        b[j][0] = *reinterpret_cast<const int*>(r);
        b[j][1] = *reinterpret_cast<const int*>(r + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_s8(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // flush: accumulator element r sits at row g (+8 for r >= 2), column
  // 2t (+1 for odd r) of its 16 x 8 mma tile
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm * WTM + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn * WTN + j * 8 + 2 * t + (r & 1);
        if (row < Tn && col < F)
          out[(long long)row * F + col] =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][r]), sx[row]), sw[col]);
      }
}

template <int BM, int BN, int BK, int WM, int WN, int S>
static cudaError_t launch_int8(const int8_t* xq, const int8_t* wqt, const float* sx,
                               const float* sw, float* out, int Tn, int D, int F, int vec,
                               cudaStream_t stream) {
  dim3 grid((F + BN - 1) / BN, (Tn + BM - 1) / BM);
  matmul_int8_kernel<BM, BN, BK, WM, WN, S>
      <<<grid, 32 * WM * WN, 0, stream>>>(xq, wqt, sx, sw, out, Tn, D, F, vec);
  return cudaGetLastError();
}

}  // namespace famous

extern "C" int famous_matmul_tiled_int8(const void* xq, const void* wqt, const void* sx,
                                        const void* sw, void* out, int Tn, int D, int F,
                                        void* stream) {
  using namespace famous;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tn <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wqt);
  const int vec = D % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const float* a = static_cast<const float*>(sx);
  const float* b = static_cast<const float*>(sw);
  float* o = static_cast<float*>(out);
  cudaError_t e;
  if (Tn <= 16)  // decode: many narrow column stripes, deep D steps
    e = launch_int8<16, 32, 256, 1, 4, 3>(x, w, a, b, o, Tn, D, F, vec, s);
  else if (Tn <= 32)  // speculative verify (n_slots x (draft_k + 1) rows)
    e = launch_int8<32, 32, 128, 2, 2, 3>(x, w, a, b, o, Tn, D, F, vec, s);
  else  // prefill chunk
    e = launch_int8<64, 64, 64, 2, 2, 3>(x, w, a, b, o, Tn, D, F, vec, s);
  return static_cast<int>(e);
}
