// mha_forward: fused FAMOUS QK_PM -> softmax -> SV_PM over the flat
// layout, with the row log-sum-exp the flash backward needs.
//
//   q      (BH, Sq, dh)     contiguous, BH = BKV * group
//   k, v   (BKV, Skv, dh)   contiguous; query row bh reads kv row bh / group
//   out    (BH, Sq, dh)     in q's dtype
//   lse    (BH, Sq)         f32, m + log(max(l, 1e-30))
//
// Query position q_offset + i sees key j when key_visible() says so
// (causal and/or sliding window; neither is the encoder's full attention).
//
// Replaces: src/repro/kernels/attention/mha.py, mha_forward (the Pallas
// kernel _mha_kernel).  There the grid is (BH, Sq/block_q, Skv/block_k)
// and the last axis is sequential, carrying the f32 accumulator and the
// running max/sum in VMEM from one key tile to the next; the block sizes
// must divide the sequence lengths.  Here one block owns 32 query rows of
// one head and walks its key tiles itself, with the accumulator in
// registers; the loop runs only over the keys its rows can see (it ends at
// the causal edge and starts at the window's), and ragged edges are
// masked.  The arithmetic is the TPU kernel's: q is scaled before the
// product, masked scores are -1e30, P is 0 off the mask, and the output is
// divided by max(l, 1e-30), so a row with no visible key gives 0 and an
// LSE of about -1e30.
//
// What bounds it on an H100: operations (4 * BH * Sq * Skv * dh FLOP,
// halved when causal: 6.4 GFLOP for a famous-bert layer at B=8, S=512,
// about 6.5 us at the bf16 tensor-core peak) far more than bytes (q, k,
// v, out once each: 6.3 MB in bf16, 1.9 us).  This first version runs f32
// FMAs on the CUDA cores from 32 x 32 tiles of Q, K and V staged in shared
// memory, so it sits far from that bound; wgmma on bf16 tiles with TMA
// loads is the later change.
#include "common.cuh"

namespace famous {

constexpr int kFwBQ = 32;       // query rows per block
constexpr int kFwBK = 32;       // keys per tile (= warp size: lane = key)
constexpr int kFwThreads = 256;
constexpr int kFwWarps = kFwThreads / 32;
constexpr int kMhaMaxDh = 128;
constexpr int kFwLanesPerRow = kFwThreads / kFwBQ;        // 8 threads per row in P @ V
constexpr int kFwDPT = kMhaMaxDh / kFwLanesPerRow;        // head-dim entries per thread

__host__ __device__ inline size_t fwd_smem_floats(int dh) {
  return (size_t)kFwBQ * dh               // Q tile (pre-scaled)
         + (size_t)kFwBK * (dh + 1)       // K tile (padded rows)
         + (size_t)kFwBK * dh             // V tile
         + (size_t)kFwBQ * (kFwBK + 1)    // scores / probabilities
         + 3 * (size_t)kFwBQ;             // running max, sum, correction
}

template <typename T>
__global__ void __launch_bounds__(kFwThreads)
mha_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                   int Sq, int Skv, int dh, int group, int causal, int window, int q_offset,
                   float scale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kFwBQ, bh = blockIdx.y;
  const int bkv = bh / group;
  float* q_s = smem;
  float* k_s = q_s + kFwBQ * dh;
  float* v_s = k_s + kFwBK * (dh + 1);
  float* p_s = v_s + kFwBK * dh;
  float* m_s = p_s + kFwBQ * (kFwBK + 1);
  float* l_s = m_s + kFwBQ;
  float* c_s = l_s + kFwBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* qb = q + ((long long)bh * Sq + q0) * dh;
  for (int i = tid; i < kFwBQ * dh; i += kFwThreads) {
    const int r = i / dh;
    q_s[i] = q0 + r < Sq ? to_f(qb[i]) * scale : 0.f;
  }
  if (tid < kFwBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int row = tid / kFwLanesPerRow, dlane = tid % kFwLanesPerRow;
  float acc[kFwDPT];
#pragma unroll
  for (int i = 0; i < kFwDPT; ++i) acc[i] = 0.f;

  // keys the block's rows can see: [kbeg, kend)
  const int qlo = q_offset + q0, qhi = q_offset + min(Sq, q0 + kFwBQ) - 1;
  const int kend = causal ? min(Skv, qhi + 1) : Skv;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  const T* kb = k + (long long)bkv * Skv * dh;
  const T* vb = v + (long long)bkv * Skv * dh;
  __syncthreads();

  for (int k0 = kbeg; k0 < kend; k0 += kFwBK) {
    for (int i = tid; i < kFwBK * dh; i += kFwThreads) {
      const int j = i / dh, d = i % dh, pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < kend) {
        kx = to_f(kb[(long long)pos * dh + d]);
        vx = to_f(vb[(long long)pos * dh + d]);
      }
      k_s[j * (dh + 1) + d] = kx;
      v_s[j * dh + d] = vx;
    }
    __syncthreads();
    // scores: (32 x 32) dot products of length dh; a warp shares one row
    for (int i = tid; i < kFwBQ * kFwBK; i += kFwThreads) {
      const int r = i / kFwBK, j = i % kFwBK;
      const float* qr = q_s + r * dh;
      const float* kr = k_s + j * (dh + 1);
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[r * (kFwBK + 1) + j] = s;
    }
    __syncthreads();
    // online softmax: one warp per row, lane = key
    for (int r = warp; r < kFwBQ; r += kFwWarps) {
      const int pos = k0 + lane;
      const bool ok = pos < kend && key_visible(qlo + r, pos, causal, window);
      const float s = ok ? p_s[r * (kFwBK + 1) + lane] : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p);
      p_s[r * (kFwBK + 1) + lane] = p;
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    // acc = acc * corr + P @ V; 8 threads per row, head-dim entries strided by 8
    {
      const float corr = c_s[row];
      const float* pr = p_s + row * (kFwBK + 1);
#pragma unroll
      for (int i = 0; i < kFwDPT; ++i) {
        const int d = dlane + i * kFwLanesPerRow;
        if (d >= dh) break;
        float a = acc[i] * corr;
#pragma unroll 8
        for (int j = 0; j < kFwBK; ++j) a = fmaf(pr[j], v_s[j * dh + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const int qi = q0 + row;
  if (qi < Sq) {
    const float l = fmaxf(l_s[row], 1e-30f);
    T* o = out + ((long long)bh * Sq + qi) * dh;
#pragma unroll
    for (int i = 0; i < kFwDPT; ++i) {
      const int d = dlane + i * kFwLanesPerRow;
      if (d >= dh) break;
      o[d] = from_f<T>(acc[i] / l);
    }
    if (dlane == 0) lse[(long long)bh * Sq + qi] = m_s[row] + logf(l);
  }
}

template <typename T>
static cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                              float* lse, int BH, int group, int Sq, int Skv, int dh,
                              int causal, int window, int q_offset, float scale,
                              cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(dh) * sizeof(float);
  cudaError_t e = allow_smem(mha_forward_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kFwBQ - 1) / kFwBQ, BH);
  mha_forward_kernel<T><<<grid, kFwThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Sq, Skv, dh, group, causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace famous

extern "C" int famous_mha_forward(int dtype, const void* q, const void* k, const void* v,
                                  void* out, float* lse, int BH, int BKV, int Sq, int Skv,
                                  int dh, int causal, int window, int q_offset, float scale,
                                  void* stream) {
  using namespace famous;
  if (BKV <= 0 || BH % BKV != 0 || BH > 65535 || dh <= 0 || dh > kMhaMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = BH / BKV;
  cudaError_t e;
  if (dtype == kF32)
    e = launch_fwd<float>(q, k, v, out, lse, BH, group, Sq, Skv, dh, causal, window,
                          q_offset, scale, s);
  else if (dtype == kBF16)
    e = launch_fwd<__nv_bfloat16>(q, k, v, out, lse, BH, group, Sq, Skv, dh, causal, window,
                                  q_offset, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
