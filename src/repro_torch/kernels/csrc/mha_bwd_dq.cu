// mha_bwd_dq: the query gradient of the flash backward, recomputing the
// probabilities from the forward's saved row log-sum-exp.
//
//   q, dout      (BH, Sq, dh)    contiguous, BH = BKV * group
//   k, v         (BKV, Skv, dh)  contiguous; query row bh reads kv row bh / group
//   lse, delta   (BH, Sq)        f32; delta = sum_d dO * O (computed by the wrapper)
//   dq           (BH, Sq, dh)    f32
//
//   P  = exp(scale * Q K^T - lse)  on the mask, 0 off it
//   dS = P * (dO V^T - delta)
//   dq = scale * dS K
//
// Replaces: src/repro/kernels/attention/mha.py, mha_backward's first
// pallas_call (the Pallas kernel _mha_bwd_dq_kernel).  There the grid is
// (BH, Sq/block_q, Skv/block_k) with the key axis sequential, carrying the
// f32 dq accumulator in VMEM across key tiles.  Here one block owns 32
// query rows of one head and loops over the key tiles its rows can see
// (the forward's causal and window bounds), with the accumulator in
// registers; ragged edges are masked.  The arithmetic is the TPU kernel's:
// q is not pre-scaled, the product is scaled, P is recomputed as 0 off the
// mask (so a row with no visible key gets dq = 0), and dq is scaled once
// on the way out.
//
// What bounds it on an H100: operations (6 * BH * Sq * Skv * dh FLOP,
// halved when causal: 45 GFLOP for qwen2-7b at S=2048, 46 us at the bf16
// tensor-core peak) far more than bytes (q, k, v, dO, lse, delta read and
// dq written once).  This first version computes S and dO V^T together,
// one pass over the staged Q, dO, K and V tiles, with f32 FMAs on the CUDA
// cores; wgmma on bf16 tiles is the later change.
#include "common.cuh"

namespace famous {

constexpr int kDqBQ = 32;       // query rows per block
constexpr int kDqBK = 32;       // keys per tile
constexpr int kDqThreads = 256;
constexpr int kDqMaxDh = 128;
constexpr int kDqLanesPerRow = kDqThreads / kDqBQ;   // 8 threads per row in dS @ K
constexpr int kDqDPT = kDqMaxDh / kDqLanesPerRow;    // head-dim entries per thread

__host__ __device__ inline size_t dq_smem_floats(int dh) {
  return 2 * (size_t)kDqBQ * dh            // Q and dO tiles
         + 2 * (size_t)kDqBK * (dh + 1)    // K and V tiles (padded rows)
         + (size_t)kDqBQ * (kDqBK + 1)     // dS
         + 2 * (size_t)kDqBQ;              // lse, delta
}

template <typename T>
__global__ void __launch_bounds__(kDqThreads)
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Skv,
                  int dh, int group, int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kDqBQ, bh = blockIdx.y;
  const int bkv = bh / group;
  float* q_s = smem;
  float* o_s = q_s + kDqBQ * dh;              // dO
  float* k_s = o_s + kDqBQ * dh;
  float* v_s = k_s + kDqBK * (dh + 1);
  float* ds_s = v_s + kDqBK * (dh + 1);
  float* lse_s = ds_s + kDqBQ * (kDqBK + 1);
  float* dl_s = lse_s + kDqBQ;
  const int tid = threadIdx.x;

  const long long rbase = (long long)bh * Sq + q0;
  for (int i = tid; i < kDqBQ * dh; i += kDqThreads) {
    const bool in = q0 + i / dh < Sq;
    q_s[i] = in ? to_f(q[rbase * dh + i]) : 0.f;
    o_s[i] = in ? to_f(dout[rbase * dh + i]) : 0.f;
  }
  if (tid < kDqBQ) {
    const bool in = q0 + tid < Sq;
    lse_s[tid] = in ? lse[rbase + tid] : 0.f;
    dl_s[tid] = in ? delta[rbase + tid] : 0.f;
  }
  const int row = tid / kDqLanesPerRow, dlane = tid % kDqLanesPerRow;
  float acc[kDqDPT];
#pragma unroll
  for (int i = 0; i < kDqDPT; ++i) acc[i] = 0.f;

  const int qlo = q_offset + q0, qhi = q_offset + min(Sq, q0 + kDqBQ) - 1;
  const int kend = causal ? min(Skv, qhi + 1) : Skv;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  const T* kb = k + (long long)bkv * Skv * dh;
  const T* vb = v + (long long)bkv * Skv * dh;
  __syncthreads();

  for (int k0 = kbeg; k0 < kend; k0 += kDqBK) {
    for (int i = tid; i < kDqBK * dh; i += kDqThreads) {
      const int j = i / dh, d = i % dh, pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < kend) {
        kx = to_f(kb[(long long)pos * dh + d]);
        vx = to_f(vb[(long long)pos * dh + d]);
      }
      k_s[j * (dh + 1) + d] = kx;
      v_s[j * (dh + 1) + d] = vx;
    }
    __syncthreads();
    // S and dP = dO V^T together; a warp shares one row, lane = key
    for (int i = tid; i < kDqBQ * kDqBK; i += kDqThreads) {
      const int r = i / kDqBK, j = i % kDqBK, pos = k0 + j;
      const float* qr = q_s + r * dh;
      const float* orow = o_s + r * dh;
      const float* kr = k_s + j * (dh + 1);
      const float* vr = v_s + j * (dh + 1);
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < dh; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(orow[d], vr[d], dp);
      }
      const bool ok = q0 + r < Sq && pos < kend && key_visible(qlo + r, pos, causal, window);
      const float p = ok ? expf(s * scale - lse_s[r]) : 0.f;
      ds_s[r * (kDqBK + 1) + j] = p * (dp - dl_s[r]);
    }
    __syncthreads();
    // dq += dS @ K; 8 threads per row, head-dim entries strided by 8
    {
      const float* dr = ds_s + row * (kDqBK + 1);
#pragma unroll
      for (int i = 0; i < kDqDPT; ++i) {
        const int d = dlane + i * kDqLanesPerRow;
        if (d >= dh) break;
        float a = acc[i];
#pragma unroll 8
        for (int j = 0; j < kDqBK; ++j) a = fmaf(dr[j], k_s[j * (dh + 1) + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  if (q0 + row < Sq) {
    float* o = dq + (rbase + row) * dh;
#pragma unroll
    for (int i = 0; i < kDqDPT; ++i) {
      const int d = dlane + i * kDqLanesPerRow;
      if (d >= dh) break;
      o[d] = acc[i] * scale;
    }
  }
}

template <typename T>
static cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, float* dq, int BH,
                             int group, int Sq, int Skv, int dh, int causal, int window,
                             int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_floats(dh) * sizeof(float);
  cudaError_t e = allow_smem(mha_bwd_dq_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kDqBQ - 1) / kDqBQ, BH);
  mha_bwd_dq_kernel<T><<<grid, kDqThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq, Sq, Skv, dh, group, causal, window,
      q_offset, scale);
  return cudaGetLastError();
}

}  // namespace famous

extern "C" int famous_mha_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 float* dq, int BH, int BKV, int Sq, int Skv, int dh,
                                 int causal, int window, int q_offset, float scale,
                                 void* stream) {
  using namespace famous;
  if (BKV <= 0 || BH % BKV != 0 || BH > 65535 || dh <= 0 || dh > kDqMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = BH / BKV;
  cudaError_t e;
  if (dtype == kF32)
    e = launch_dq<float>(q, k, v, dout, lse, delta, dq, BH, group, Sq, Skv, dh, causal,
                         window, q_offset, scale, s);
  else if (dtype == kBF16)
    e = launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, BH, group, Sq, Skv, dh,
                                 causal, window, q_offset, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
