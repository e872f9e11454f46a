// decode_attention: one new query token per slot against the slot's
// contiguous KV cache, GQA, f32 online softmax.
//
//   q      (B, H, dh)            contiguous (the decode step's (B, 1, H, dh))
//   k, v   (B, Skv, KV, dh)      read by strides, dh contiguous
//   lens   (B,) int32            valid entries of each slot, on the device
//   out    (B, H, dh)
//
// Replaces: src/repro/kernels/decode/decode_attn.py, decode_attention (the
// Pallas kernel _decode_kernel).  There the JAX wrapper first transposes
// both caches to kv-major rows (a full copy of the cache per layer per step
// in eager PyTorch) and the grid visits every key tile of Skv whatever the
// length.  Here one block owns one (slot, kv head) pair and reads the cache
// in place by strides; the group of query heads that share the kv head are
// the block's rows (qwen2-7b: 7), so each K/V tile is read once for all of
// them.  The key loop stops at lens[b] at run time, without a rebuild.
// The softmax is the TPU kernel's: f32 running max and sum, masked scores
// at -1e30, and the final divide by max(l, 1e-30), which gives an empty
// slot (len 0) an output of 0.
//
// What bounds it on an H100: memory.  Each live token costs 2 * KV * dh
// elements (2 KB in bf16 for qwen2-7b) per layer and is read once; the
// arithmetic is 4 * H * dh FLOP per token.  Design: 32-key tiles staged
// through shared memory with coalesced loads (consecutive threads read
// consecutive head-dim elements), one warp per query row for the softmax
// (lane = key), and an f32 accumulator held in registers.  B * KV blocks
// (16 at decode) do not fill the card; splitting the key range across
// blocks (flash-decoding) is a later change.
#include "common.cuh"

namespace famous {

constexpr int kDecBK = 32;      // keys per tile (= warp size: lane = key)
constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecMaxGroup = 16;
constexpr int kDecMaxDh = 256;
constexpr int kDecDPT = kDecMaxDh / kDecThreads;  // head-dim entries per thread

__host__ __device__ inline size_t decode_smem_floats(int group, int dh) {
  return (size_t)group * dh                // q (pre-scaled)
         + (size_t)kDecBK * (dh + 1)       // K tile (padded rows)
         + (size_t)kDecBK * dh             // V tile
         + (size_t)group * kDecBK          // scores / probabilities
         + 3 * (size_t)group;              // running max, sum, correction
}

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lens,
                        T* __restrict__ out, int H, int KV, int dh, int Skv,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh, float scale) {
  extern __shared__ float smem[];
  const int group = H / KV;
  const int hk = blockIdx.x, b = blockIdx.y;
  float* q_s = smem;
  float* k_s = q_s + group * dh;
  float* v_s = k_s + kDecBK * (dh + 1);
  float* p_s = v_s + kDecBK * dh;
  float* m_s = p_s + group * kDecBK;
  float* l_s = m_s + group;
  float* c_s = l_s + group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const long long q_base = ((long long)b * H + (long long)hk * group) * dh;
  for (int i = tid; i < group * dh; i += kDecThreads) q_s[i] = to_f(q[q_base + i]) * scale;
  if (tid < group) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kDecMaxGroup][kDecDPT];
#pragma unroll
  for (int g = 0; g < kDecMaxGroup; ++g)
#pragma unroll
    for (int i = 0; i < kDecDPT; ++i) acc[g][i] = 0.f;

  const int len = max(0, min(lens[b], Skv));
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  __syncthreads();

  for (int k0 = 0; k0 < len; k0 += kDecBK) {
    for (int i = tid; i < kDecBK * dh; i += kDecThreads) {
      const int j = i / dh, d = i % dh, pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < len) {
        kx = to_f(kb[pos * k_ss + d]);
        vx = to_f(vb[pos * v_ss + d]);
      }
      k_s[j * (dh + 1) + d] = kx;
      v_s[j * dh + d] = vx;
    }
    __syncthreads();
    // scores: (group x 32) dot products of length dh
    for (int i = tid; i < group * kDecBK; i += kDecThreads) {
      const int g = i / kDecBK, j = i % kDecBK;
      const float* qr = q_s + g * dh;
      const float* kr = k_s + j * (dh + 1);
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax: one warp per query row, lane = key
    for (int g = warp; g < group; g += kDecWarps) {
      const bool ok = k0 + lane < len;
      const float s = ok ? p_s[g * kDecBK + lane] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p);
      p_s[g * kDecBK + lane] = p;
      if (lane == 0) {
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    // acc = acc * corr + P @ V; thread owns head-dim entries tid, tid + 128
#pragma unroll
    for (int i = 0; i < kDecDPT; ++i) {
      const int d = tid + i * kDecThreads;
      if (d >= dh) continue;
#pragma unroll
      for (int g = 0; g < kDecMaxGroup; ++g) {
        if (g >= group) break;
        float a = acc[g][i] * c_s[g];
        const float* pr = p_s + g * kDecBK;
#pragma unroll 8
        for (int j = 0; j < kDecBK; ++j) a = fmaf(pr[j], v_s[j * dh + d], a);
        acc[g][i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kDecDPT; ++i) {
    const int d = tid + i * kDecThreads;
    if (d >= dh) continue;
#pragma unroll
    for (int g = 0; g < kDecMaxGroup; ++g) {
      if (g >= group) break;
      out[q_base + (long long)g * dh + d] = from_f<T>(acc[g][i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T>
static cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* lens,
                                 void* out, int B, int H, int KV, int dh, int Skv,
                                 long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh, float scale,
                                 cudaStream_t stream) {
  const size_t smem = decode_smem_floats(H / KV, dh) * sizeof(float);
  cudaError_t e = allow_smem(decode_attention_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(KV, B);
  decode_attention_kernel<T><<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens,
      static_cast<T*>(out), H, KV, dh, Skv, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  return cudaGetLastError();
}

}  // namespace famous

extern "C" int famous_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                       const void* lens, void* out, int B, int H, int KV,
                                       int dh, int Skv, long long k_sb, long long k_ss,
                                       long long k_sh, long long v_sb, long long v_ss,
                                       long long v_sh, float scale, void* stream) {
  using namespace famous;
  if (KV <= 0 || H % KV != 0 || H / KV > kDecMaxGroup || dh <= 0 || dh > kDecMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_decode<float>(q, k, v, l, out, B, H, KV, dh, Skv, k_sb, k_ss, k_sh, v_sb, v_ss,
                             v_sh, scale, s);
  else if (dtype == kBF16)
    e = launch_decode<__nv_bfloat16>(q, k, v, l, out, B, H, KV, dh, Skv, k_sb, k_ss, k_sh,
                                     v_sb, v_ss, v_sh, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
