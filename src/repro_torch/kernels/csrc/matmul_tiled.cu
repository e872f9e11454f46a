// matmul_tiled: out(T, F) = X(T, D) @ W(D, F), f32 accumulation, one cast
// to the operands' dtype on the way out.  The QKV_PM of the FAMOUS paper
// (Algorithm 1): W is the fused [Wq|Wk|Wv] matrix, so one read of an X
// tile feeds all three projections.
//
// Replaces: src/repro/kernels/qkv/qkv_proj.py, matmul_tiled (the Pallas
// kernel _proj_kernel launched by _matmul_call).  There the reduction over
// D is a sequential grid axis that carries a VMEM f32 accumulator from one
// grid step to the next.  Here one block owns one (BT x BF) output tile and
// runs the whole D loop itself, with the accumulator in registers; ragged
// edges of T, D and F are masked instead of asserting divisibility.
//
// What bounds it on an H100: at decode (T = n_slots = 4) the product reads
// the whole W once, 33.0 MB in bf16 for qwen2-7b, so it is bound by memory
// (about 9.9 us at 3.35 TB/s); at a 256-token prefill chunk it is near the
// ridge (8.5 GFLOP).  Design: a small-T tile (8 x 32) for decode so that
// F / 32 = 144 blocks fill the 132 SMs while each streams its own W
// stripe exactly once; a 64 x 64 tile with a 4 x 4 register micro-tile for
// prefill.  Both stage X and W tiles through shared memory with coalesced
// loads and run f32 FMAs on the CUDA cores.  Tensor cores (wgmma), TMA and
// multi-stage pipelining are left for a later change.
#include "common.cuh"

namespace famous {

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

template <typename T, int BT, int BF, int BD, int TM, int TN>
static void launch(const void* x, const void* w, void* out, int Tn, int D, int F,
                   cudaStream_t stream) {
  dim3 grid((F + BF - 1) / BF, (Tn + BT - 1) / BT);
  matmul_tiled_kernel<T, BT, BF, BD, TM, TN><<<grid, (BT / TM) * (BF / TN), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), Tn, D, F);
}

template <typename T>
static void dispatch(const void* x, const void* w, void* out, int Tn, int D, int F,
                     cudaStream_t stream) {
  if (Tn <= 32)
    launch<T, 8, 32, 64, 1, 1>(x, w, out, Tn, D, F, stream);  // decode: many narrow tiles
  else
    launch<T, 64, 64, 32, 4, 4>(x, w, out, Tn, D, F, stream);  // prefill chunk
}

}  // namespace famous

extern "C" int famous_matmul_tiled(int dtype, const void* x, const void* w, void* out,
                                   int Tn, int D, int F, void* stream) {
  using namespace famous;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tn <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype == kF32)
    dispatch<float>(x, w, out, Tn, D, F, s);
  else if (dtype == kBF16)
    dispatch<__nv_bfloat16>(x, w, out, Tn, D, F, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
