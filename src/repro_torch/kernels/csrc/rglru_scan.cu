// rglru_scan: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over
// (B, S, R), elementwise in the feature axis, from h_{-1} = 0, f32 out.
//
// Replaces: src/repro/kernels/scan/linear_scan.py, rglru_scan (the Pallas
// kernel _rglru_kernel).  There the time axis is a sequential grid axis
// whose tiles carry the running state in VMEM scratch, with a fori_loop over
// the rows of each tile.
//
// What bounds it on an H100: bytes.  At recurrentgemma-2b's serving shape
// (B = 1, S = 256, R = 2560) it reads a and b once and writes h once, 7.9 MB
// in f32, about 2.3 us at 3.35 TB/s; there is one multiply and one add per
// element.  What stands in the way is latency: one thread per feature
// walking time (the first port) keeps only its next few steps of a and b in
// flight, 2560 threads on 20 SMs at that shape, far from the bytes in
// flight that 3.35 TB/s needs at about 1 us of memory latency.
//
// Design: a block is a stripe of F features by P time segments of L steps
// (F x P threads, thread (p, f); neighbouring threads own neighbouring
// features, so every load and store of a step is coalesced).  Over a tile
// of P L steps every thread first holds its segment's L values of a and b
// in registers, all loads of the block in flight at once; then the
// segments run the recurrence in order, each taking the carried h of the
// segment before it through shared memory after a barrier and storing its
// outputs, and a segment that has run loads its share of the next tile
// while the later segments of this one run.  The chain stays every step
// in order, so the dependent arithmetic is S multiply-adds per feature
// (about 1 us at the serving shape), and its rounding is the plain
// version's: __fadd_rn(__fmul_rn(a, h), b), two roundings as `a * h + b`
// makes them, never contracted into a fused multiply-add.  The kernel is
// bit-equal to its plain version.  F, P and L were chosen by
// scripts/torch_kernel_sweep.py (PERF.md).
#include "common.cuh"

namespace famous {

// The shipped geometry: features a block, time segments, steps a segment
constexpr int kScanF = 32, kScanP = 16, kScanL = 16;

template <typename T, int F, int P, int L>
__global__ void __launch_bounds__(F * P)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out,
                  int S, int R) {
  constexpr int TILE = P * L;
  __shared__ float carry[F];  // h at the end of the last segment run
  const int f = threadIdx.x % F, p = threadIdx.x / F;
  const int r = blockIdx.x * F + f;
  const bool live = r < R;
  const long long base = (long long)blockIdx.y * S * R + r;
  // the input type in registers, widened only where the chain uses it, so
  // a prefetch never waits for its loads
  T av[L], bv[L];
  // this thread's segment of the tile at t0; steps past S are (1, 0),
  // which leave h as it is
  auto load = [&](int t0) {
    const int ts = t0 + p * L;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const bool ok = live && ts + i < S;
      av[i] = ok ? a[base + (long long)(ts + i) * R] : from_f<T>(1.f);
      bv[i] = ok ? b[base + (long long)(ts + i) * R] : from_f<T>(0.f);
    }
  };
  if (p == 0) carry[f] = 0.f;
  load(0);
  __syncthreads();
  for (int t0 = 0; t0 < S; t0 += TILE) {
    for (int q = 0; q < P; ++q) {
      if (p == q) {
        const int ts = t0 + p * L;
        float h = carry[f];
#pragma unroll
        for (int i = 0; i < L; ++i) {
          h = __fadd_rn(__fmul_rn(to_f(av[i]), h), to_f(bv[i]));
          if (live && ts + i < S) out[base + (long long)(ts + i) * R] = h;
        }
        carry[f] = h;
        if (t0 + TILE < S) load(t0 + TILE);
      }
      __syncthreads();
    }
  }
}

template <typename T, int F, int P, int L>
static cudaError_t launch_rglru(const void* a, const void* b, float* out, int B, int S, int R,
                                cudaStream_t stream) {
  static_assert(F * P <= 1024, "threads a block");
  dim3 grid((R + F - 1) / F, B);
  record_launch(rglru_scan_kernel<T, F, P, L>, "rglru_scan_kernel", grid, F * P, 0, {R, F},
                {B, 1});
  rglru_scan_kernel<T, F, P, L><<<grid, F * P, 0, stream>>>(static_cast<const T*>(a),
                                                           static_cast<const T*>(b), out, S, R);
  return cudaGetLastError();
}

}  // namespace famous

extern "C" int famous_rglru_scan(int dtype, const void* a, const void* b, void* out, int B, int S,
                                 int R, void* stream) {
  using namespace famous;
  if (B < 0 || S < 0 || R < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || R == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_rglru<float, kScanF, kScanP, kScanL>(a, b, o, B, S, R, s);
  else if (dtype == kBF16)
    e = launch_rglru<__nv_bfloat16, kScanF, kScanP, kScanL>(a, b, o, B, S, R, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
