// chunk_prefill: a chunk of C query tokens at absolute positions
// [q_offset, q_offset + C) attends causally to the slot's resident prefix
// plus its own chunk, both already written into the contiguous KV cache.
//
//   q      (B, C, H, dh)         contiguous (the model's layout)
//   k, v   (B, Skv, KV, dh)      read by strides, dh contiguous
//   out    (B, C, H, dh)
//
// Key position j is visible to chunk row c iff j <= q_offset + c.
//
// Replaces: src/repro/kernels/decode/chunk_prefill.py, chunk_prefill (the
// Pallas kernel _chunk_prefill_kernel).  On the TPU one block holds all
// group * C rows of one kv head (4 blocks for one qwen2-7b slot, which
// would leave 128 of 132 SMs idle here), the wrapper copies the slot's
// stripe out of the batched cache and transposes it to kv-major, and the
// grid spans every key tile of Skv because a bound that depends on the
// offset would cost one executable per offset.  Here the rows are split
// over blocks: one block per (32 chunk rows, query head), 8 x 28 = 224
// blocks at C = 256; q and the cache stripe are read in place by strides;
// and each block's key loop ends at run time at the last key its rows can
// see, q_offset + min(C, c0 + 32).  The softmax is the TPU kernel's: f32
// running max and sum, masked scores at -1e30, divide by max(l, 1e-30).
//
// What bounds it on an H100: operations (7.5 GFLOP for C = 256 over 2048
// keys on qwen2-7b, about 7.6 us at the bf16 tensor-core peak) more than
// bytes (the slot's K/V stripe, 4 MB).  This first version runs f32 FMAs
// on the CUDA cores from 32 x 32 tiles of Q, K and V staged in shared
// memory, so it sits far from that bound; tensor-core MMA on bf16 tiles
// is a later change.
#include "common.cuh"

namespace famous {

constexpr int kCpBQ = 32;       // chunk rows per block
constexpr int kCpBK = 32;       // keys per tile (= warp size: lane = key)
constexpr int kCpThreads = 256;
constexpr int kCpWarps = kCpThreads / 32;
constexpr int kCpMaxDh = 256;
constexpr int kCpLanesPerRow = kCpThreads / kCpBQ;          // 8 threads per row in P @ V
constexpr int kCpDPT = kCpMaxDh / kCpLanesPerRow;           // head-dim entries per thread

__host__ __device__ inline size_t chunk_smem_floats(int dh) {
  return (size_t)kCpBQ * dh               // Q tile (pre-scaled)
         + (size_t)kCpBK * (dh + 1)       // K tile (padded rows)
         + (size_t)kCpBK * dh             // V tile
         + (size_t)kCpBQ * (kCpBK + 1)    // scores / probabilities
         + 3 * (size_t)kCpBQ;             // running max, sum, correction
}

template <typename T>
__global__ void __launch_bounds__(kCpThreads)
chunk_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int C, int H, int KV,
                     int dh, int Skv, int q_offset, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                     float scale) {
  extern __shared__ float smem[];
  const int group = H / KV;
  const int c0 = blockIdx.x * kCpBQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / group;
  float* q_s = smem;
  float* k_s = q_s + kCpBQ * dh;
  float* v_s = k_s + kCpBK * (dh + 1);
  float* p_s = v_s + kCpBK * dh;
  float* m_s = p_s + kCpBQ * (kCpBK + 1);
  float* l_s = m_s + kCpBQ;
  float* c_s = l_s + kCpBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kCpBQ * dh; i += kCpThreads) {
    const int r = i / dh, d = i % dh, c = c0 + r;
    q_s[i] = c < C ? to_f(q[(((long long)b * C + c) * H + hq) * dh + d]) * scale : 0.f;
  }
  if (tid < kCpBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int row = tid / kCpLanesPerRow, dlane = tid % kCpLanesPerRow;
  float acc[kCpDPT];
#pragma unroll
  for (int i = 0; i < kCpDPT; ++i) acc[i] = 0.f;

  // the block's last visible key is q_offset + (its last real row)
  const int kend = min(Skv, q_offset + min(C, c0 + kCpBQ));
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  __syncthreads();

  for (int k0 = 0; k0 < kend; k0 += kCpBK) {
    for (int i = tid; i < kCpBK * dh; i += kCpThreads) {
      const int j = i / dh, d = i % dh, pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < kend) {
        kx = to_f(kb[pos * k_ss + d]);
        vx = to_f(vb[pos * v_ss + d]);
      }
      k_s[j * (dh + 1) + d] = kx;
      v_s[j * dh + d] = vx;
    }
    __syncthreads();
    // scores: (32 x 32) dot products of length dh; a warp shares one row
    for (int i = tid; i < kCpBQ * kCpBK; i += kCpThreads) {
      const int r = i / kCpBK, j = i % kCpBK;
      const float* qr = q_s + r * dh;
      const float* kr = k_s + j * (dh + 1);
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[r * (kCpBK + 1) + j] = s;
    }
    __syncthreads();
    // online softmax: one warp per row, lane = key
    for (int r = warp; r < kCpBQ; r += kCpWarps) {
      const int pos = k0 + lane;
      const bool ok = pos < kend && pos <= q_offset + c0 + r;
      const float s = ok ? p_s[r * (kCpBK + 1) + lane] : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p);
      p_s[r * (kCpBK + 1) + lane] = p;
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
      const float* pr = p_s + row * (kCpBK + 1);
#pragma unroll
      for (int i = 0; i < kCpDPT; ++i) {
        const int d = dlane + i * kCpLanesPerRow;
        if (d >= dh) break;
        float a = acc[i] * corr;
#pragma unroll 8
        for (int j = 0; j < kCpBK; ++j) a = fmaf(pr[j], v_s[j * dh + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const int c = c0 + row;
  if (c < C) {
    T* o = out + (((long long)b * C + c) * H + hq) * dh;
#pragma unroll
    for (int i = 0; i < kCpDPT; ++i) {
      const int d = dlane + i * kCpLanesPerRow;
      if (d >= dh) break;
      o[d] = from_f<T>(acc[i] / fmaxf(l_s[row], 1e-30f));
    }
  }
}

template <typename T>
static cudaError_t launch_chunk(const void* q, const void* k, const void* v, void* out, int B,
                                int C, int H, int KV, int dh, int Skv, int q_offset,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh, float scale,
                                cudaStream_t stream) {
  const size_t smem = chunk_smem_floats(dh) * sizeof(float);
  cudaError_t e = allow_smem(chunk_prefill_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((C + kCpBQ - 1) / kCpBQ, H, B);
  chunk_prefill_kernel<T><<<grid, kCpThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), C, H, KV, dh, Skv, q_offset, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      scale);
  return cudaGetLastError();
}

}  // namespace famous

extern "C" int famous_chunk_prefill(int dtype, const void* q, const void* k, const void* v,
                                    void* out, int B, int C, int H, int KV, int dh, int Skv,
                                    int q_offset, long long k_sb, long long k_ss,
                                    long long k_sh, long long v_sb, long long v_ss,
                                    long long v_sh, float scale, void* stream) {
  using namespace famous;
  if (KV <= 0 || H % KV != 0 || dh <= 0 || dh > kCpMaxDh || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_chunk<float>(q, k, v, out, B, C, H, KV, dh, Skv, q_offset, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, scale, s);
  else if (dtype == kBF16)
    e = launch_chunk<__nv_bfloat16>(q, k, v, out, B, C, H, KV, dh, Skv, q_offset, k_sb, k_ss,
                                    k_sh, v_sb, v_ss, v_sh, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
