// mha_bwd_dkv: the key and value gradients of the flash backward, summed
// over each kv head's group of query heads, recomputing the probabilities
// from the forward's saved row log-sum-exp.
//
//   q, dout      (BH, Sq, dh)    contiguous, BH = BKV * group
//   k, v         (BKV, Skv, dh)  contiguous
//   lse, delta   (BH, Sq)        f32; delta = sum_d dO * O (computed by the wrapper)
//   dk, dv       (BKV, Skv, dh)  f32
//
//   P  = exp(scale * Q K^T - lse)  on the mask, 0 off it
//   dv = sum over the group's heads of P^T dO
//   dk = scale * sum over the group's heads of (P * (dO V^T - delta))^T Q
//
// Replaces: src/repro/kernels/attention/mha.py, mha_backward's second
// pallas_call (the Pallas kernel _mha_bwd_dkv_kernel).  There the grid is
// (BH, Skv/block_k, Sq/block_q) with the query axis sequential, carrying
// dk/dv accumulators in VMEM; the kernel writes per-query-head f32 dk/dv
// of shape (BH, Skv, dh) and the wrapper sums them over the group.  Here
// one block owns 32 keys of one kv head and loops over the group's query
// heads and over the query tiles that can see those keys (the causal edge
// starts the loop, the window ends it), with both accumulators in
// registers.  That is the same sum with no atomics, in a fixed order (so
// the result is deterministic), and without the group-times-larger
// intermediate.  The arithmetic is the TPU kernel's: the product is
// scaled, P is recomputed as 0 off the mask, and dk is scaled once on the
// way out.
//
// What bounds it on an H100: operations (8 * BH * Sq * Skv * dh FLOP,
// halved when causal: 60 GFLOP for qwen2-7b at S=2048, 61 us at the bf16
// tensor-core peak) far more than bytes.  This first version runs f32 FMAs
// on the CUDA cores from staged Q, dO, K and V tiles; the K/V tile stays
// in shared memory for the block's whole loop.  wgmma on bf16 tiles, and
// more blocks per kv head where BKV * Skv / 32 leaves SMs idle (256 blocks
// for qwen2-7b at S=2048), are the later changes.
#include "common.cuh"

namespace famous {

constexpr int kKvBQ = 32;       // query rows per tile
constexpr int kKvBK = 32;       // keys per block
constexpr int kKvThreads = 256;
constexpr int kKvMaxDh = 128;
constexpr int kKvLanesPerRow = kKvThreads / kKvBK;   // 8 threads per key row
constexpr int kKvDPT = kKvMaxDh / kKvLanesPerRow;    // head-dim entries per thread

__host__ __device__ inline size_t dkv_smem_floats(int dh) {
  return 2 * (size_t)kKvBK * (dh + 1)      // K and V tiles (padded rows)
         + 2 * (size_t)kKvBQ * dh          // Q and dO tiles
         + 2 * (size_t)kKvBQ * (kKvBK + 1) // P and dS
         + 2 * (size_t)kKvBQ;              // lse, delta
}

// Two blocks per SM (shared memory allows three) leave 128 registers a
// thread: the two accumulators and the unrolled P/dS reads fit without
// spilling, where the default allocation capped at 64 and spilled.
template <typename T>
__global__ void __launch_bounds__(kKvThreads, 2)
mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int Sq, int Skv, int dh, int group, int causal,
                   int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * kKvBK, bkv = blockIdx.y;
  float* k_s = smem;
  float* v_s = k_s + kKvBK * (dh + 1);
  float* q_s = v_s + kKvBK * (dh + 1);
  float* o_s = q_s + kKvBQ * dh;               // dO
  float* p_s = o_s + kKvBQ * dh;
  float* ds_s = p_s + kKvBQ * (kKvBK + 1);
  float* lse_s = ds_s + kKvBQ * (kKvBK + 1);
  float* dl_s = lse_s + kKvBQ;
  const int tid = threadIdx.x;

  const long long kbase = (long long)bkv * Skv + k0;
  for (int i = tid; i < kKvBK * dh; i += kKvThreads) {
    const int j = i / dh, d = i % dh;
    const bool in = k0 + j < Skv;
    k_s[j * (dh + 1) + d] = in ? to_f(k[kbase * dh + i]) : 0.f;
    v_s[j * (dh + 1) + d] = in ? to_f(v[kbase * dh + i]) : 0.f;
  }
  const int row = tid / kKvLanesPerRow, dlane = tid % kKvLanesPerRow;  // row = key
  float dk_acc[kKvDPT], dv_acc[kKvDPT];
#pragma unroll
  for (int i = 0; i < kKvDPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // query rows that can see one of the block's keys: [qbeg, qend)
  const int kmax = min(Skv, k0 + kKvBK) - 1;
  const int qbeg = causal ? max(0, k0 - q_offset) : 0;
  const int qend = window > 0 ? min(Sq, kmax + window - q_offset) : Sq;

  for (int g = 0; g < group; ++g) {
    const long long hbase = (long long)(bkv * group + g) * Sq;
    for (int q0 = qbeg; q0 < qend; q0 += kKvBQ) {
      __syncthreads();  // the previous tile's P, dS, Q and dO are consumed
      for (int i = tid; i < kKvBQ * dh; i += kKvThreads) {
        const bool in = q0 + i / dh < Sq;
        q_s[i] = in ? to_f(q[(hbase + q0) * dh + i]) : 0.f;
        o_s[i] = in ? to_f(dout[(hbase + q0) * dh + i]) : 0.f;
      }
      if (tid < kKvBQ) {
        const bool in = q0 + tid < Sq;
        lse_s[tid] = in ? lse[hbase + q0 + tid] : 0.f;
        dl_s[tid] = in ? delta[hbase + q0 + tid] : 0.f;
      }
      __syncthreads();
      // P and dS for (query r, key j); a warp shares one query row, lane = key
      for (int i = tid; i < kKvBQ * kKvBK; i += kKvThreads) {
        const int r = i / kKvBK, j = i % kKvBK, qi = q0 + r, pos = k0 + j;
        const float* qr = q_s + r * dh;
        const float* orow = o_s + r * dh;
        const float* kr = k_s + j * (dh + 1);
        const float* vr = v_s + j * (dh + 1);
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < dh; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(orow[d], vr[d], dp);
        }
        const bool ok = qi < Sq && pos < Skv &&
                        key_visible(q_offset + qi, pos, causal, window);
        const float p = ok ? expf(s * scale - lse_s[r]) : 0.f;
        p_s[r * (kKvBK + 1) + j] = p;
        ds_s[r * (kKvBK + 1) + j] = p * (dp - dl_s[r]);
      }
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q; 8 threads per key, head-dim entries strided by 8
#pragma unroll
      for (int i = 0; i < kKvDPT; ++i) {
        const int d = dlane + i * kKvLanesPerRow;
        if (d >= dh) break;
        float a = dv_acc[i], b = dk_acc[i];
#pragma unroll 8
        for (int r = 0; r < kKvBQ; ++r) {
          a = fmaf(p_s[r * (kKvBK + 1) + row], o_s[r * dh + d], a);
          b = fmaf(ds_s[r * (kKvBK + 1) + row], q_s[r * dh + d], b);
        }
        dv_acc[i] = a;
        dk_acc[i] = b;
      }
    }
  }

  if (k0 + row < Skv) {
    float* ok_ = dk + (kbase + row) * dh;
    float* ov = dv + (kbase + row) * dh;
#pragma unroll
    for (int i = 0; i < kKvDPT; ++i) {
      const int d = dlane + i * kKvLanesPerRow;
      if (d >= dh) break;
      ok_[d] = dk_acc[i] * scale;
      ov[d] = dv_acc[i];
    }
  }
}

template <typename T>
static cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, float* dk, float* dv,
                              int BKV, int group, int Sq, int Skv, int dh, int causal,
                              int window, int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats(dh) * sizeof(float);
  cudaError_t e = allow_smem(mha_bwd_dkv_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Skv + kKvBK - 1) / kKvBK, BKV);
  mha_bwd_dkv_kernel<T><<<grid, kKvThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dk, dv, Sq, Skv, dh, group, causal, window,
      q_offset, scale);
  return cudaGetLastError();
}

}  // namespace famous

extern "C" int famous_mha_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  float* dk, float* dv, int BH, int BKV, int Sq, int Skv,
                                  int dh, int causal, int window, int q_offset, float scale,
                                  void* stream) {
  using namespace famous;
  if (BKV <= 0 || BH % BKV != 0 || BKV > 65535 || dh <= 0 || dh > kKvMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Skv <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = BH / BKV;
  cudaError_t e;
  if (dtype == kF32)
    e = launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, BKV, group, Sq, Skv, dh, causal,
                          window, q_offset, scale, s);
  else if (dtype == kBF16)
    e = launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, BKV, group, Sq, Skv, dh,
                                  causal, window, q_offset, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
