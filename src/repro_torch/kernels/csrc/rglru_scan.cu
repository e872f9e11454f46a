// rglru_scan: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over
// (B, S, R), elementwise in the feature axis, from h_{-1} = 0, f32 out.
//
// Replaces: src/repro/kernels/scan/linear_scan.py, rglru_scan (the Pallas
// kernel _rglru_kernel).  There the time axis is a sequential grid axis
// whose tiles carry the running state in VMEM scratch, with a fori_loop over
// the rows of each tile.  The docstring names the GPU form, which this is:
// one thread per (batch, feature) walks time in order with the state in a
// register; neighbouring threads own neighbouring features, so every load
// and store of a time step is coalesced across the warp.
//
// What bounds it on an H100: bytes.  At recurrentgemma-2b's serving shape
// (B = 1, S = 256, R = 2560) it reads a and b once and writes h once, 7.9 MB
// in f32, about 2.3 us at 3.35 TB/s; there is one multiply-add per element.
// The sequential dependence in time leaves each thread one load latency per
// step, so the loop loads kUnroll steps of a and b ahead into registers and
// then runs their recurrence.  At that shape the grid is only 20 blocks:
// latency, not bandwidth, sets the time of this first version.
//
// The update is __fadd_rn(__fmul_rn(a, h), b), not a fused multiply-add:
// two roundings, as the plain version's `a * h + b` makes them.
#include "common.cuh"

namespace famous {

constexpr int kScanThreads = 128;
constexpr int kScanUnroll = 16;

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out,
                  int S, int R) {
  const int r = blockIdx.x * kScanThreads + threadIdx.x;
  if (r >= R) return;
  const long long base = (long long)blockIdx.y * S * R + r;
  float h = 0.f;
  int t = 0;
  for (; t + kScanUnroll <= S; t += kScanUnroll) {
    float av[kScanUnroll], bv[kScanUnroll];
#pragma unroll
    for (int i = 0; i < kScanUnroll; ++i) {
      const long long g = base + (long long)(t + i) * R;
      av[i] = to_f(a[g]);
      bv[i] = to_f(b[g]);
    }
#pragma unroll
    for (int i = 0; i < kScanUnroll; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);
      out[base + (long long)(t + i) * R] = h;
    }
  }
  for (; t < S; ++t) {
    const long long g = base + (long long)t * R;
    h = __fadd_rn(__fmul_rn(to_f(a[g]), h), to_f(b[g]));
    out[g] = h;
  }
}

template <typename T>
static cudaError_t launch_rglru(const void* a, const void* b, float* out, int B, int S, int R,
                                cudaStream_t stream) {
  dim3 grid((R + kScanThreads - 1) / kScanThreads, B);
  rglru_scan_kernel<T><<<grid, kScanThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), out, S, R);
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
    e = launch_rglru<float>(a, b, o, B, S, R, s);
  else if (dtype == kBF16)
    e = launch_rglru<__nv_bfloat16>(a, b, o, B, S, R, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
