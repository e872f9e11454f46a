// Helpers shared by the port's kernels: element conversion to and from the
// f32 compute type, warp reductions, and the launch epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace famous {

// dtype codes of the C interface (repro_torch/kernels/lib.py: DTYPE_CODE)
enum DType { kF32 = 0, kBF16 = 1 };

// Finite "minus infinity" of the TPU kernels' masks, so a fully masked
// tile never produces inf - inf.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The masks of the TPU attention kernels (_tile_mask in
// src/repro/kernels/attention/mha.py): key position kp is visible to query
// position qp (both absolute) when causal allows it (kp <= qp) and it lies
// inside the sliding window (kp > qp - window; window <= 0 is global).
__device__ __forceinline__ bool key_visible(int qp, int kp, int causal, int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// Raise the dynamic shared-memory cap of `kernel` when a launch needs more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace famous
