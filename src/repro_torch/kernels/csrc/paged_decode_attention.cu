// paged_decode_attention(_int8): one new query token per slot against the
// slot's pages of a shared K/V pool, GQA, f32 online softmax.
//
//   q           (B, H, dh)              contiguous (the decode step's (B, 1, H, dh))
//   k, v        (n_pages, ps, KV, dh)   contiguous pools; f32/bf16, or int8
//   k_scale,    (n_pages, ps, KV) f32   int8 pools only: one scale per row
//   v_scale
//   page_table  (B, n_p) int32          slot b's key pos lives in page
//                                       page_table[b, pos / ps], row pos % ps
//   lens        (B,) int32              valid keys of each slot
//   out         (B, H, dh)
//
// Replaces: src/repro/kernels/decode/decode_attn.py, paged_decode_attention
// (Pallas _paged_decode_kernel) and paged_decode_attention_int8
// (_paged_decode_kernel_int8).  There the page table and lengths are
// scalar-prefetched and each grid step DMAs one page of one kv head; the
// grid walks all n_p pages of every slot whatever its length.  Here one
// block owns one (slot, kv head) pair, as in decode_attention.cu, and its
// key loop stops at lens[b] (clamped to n_p * ps) at run time.  The only
// change from decode_attention.cu is the addressing: before each 32-key
// tile the block resolves the tile's page ids once into shared memory
// (one page-table read per key), then loads the K/V rows from those pages
// with consecutive threads on consecutive head-dim elements.  Keys past
// lens[b] are never read, so the null page 0 that free slots point at
// never adds to an output.  The fp and int8 kernels are two instantiations
// of one template that differ only in how a K/V element reaches the f32
// tile (pool_elem in common.cuh): a cast, or int8 times its row's f32
// scale, before any product, as at decode_attn.py:128-129.  The softmax is
// the TPU kernels': f32 running max and sum, -1e30 masks, and the final
// divide by max(l, 1e-30) (a slot with len 0 gets 0).
//
// What bounds it on an H100: memory.  Each live token costs 2 * KV * dh
// elements per layer (2 KB in bf16 for qwen2-7b; 1 KB plus 32 B of scales
// in int8) read once, against 4 * H * dh FLOP.  Design: as
// decode_attention.cu (32-key tiles staged through shared memory, one warp
// per query row for the softmax, the accumulator in registers); a page of
// 16 tokens is 16 contiguous rows of a kv head's dh elements, so a tile's
// loads stay 256-byte segments.  B * KV blocks (16 at decode) do not fill
// the card; splitting the key range across blocks is a later change.
#include "common.cuh"

namespace famous {

constexpr int kPdBK = 32;      // keys per tile (= warp size: lane = key)
constexpr int kPdThreads = 128;
constexpr int kPdWarps = kPdThreads / 32;
constexpr int kPdMaxGroup = 16;
constexpr int kPdMaxDh = 256;
constexpr int kPdDPT = kPdMaxDh / kPdThreads;  // head-dim entries per thread

__host__ __device__ inline size_t paged_decode_smem_bytes(int group, int dh) {
  return sizeof(long long) * kPdBK                   // pool rows of the tile's keys
         + sizeof(float) * ((size_t)group * dh       // q (pre-scaled)
                            + (size_t)kPdBK * (dh + 1)  // K tile (padded rows)
                            + (size_t)kPdBK * dh        // V tile
                            + (size_t)group * kPdBK     // scores / probabilities
                            + 3 * (size_t)group);       // running max, sum, correction
}

template <typename T, typename E>
__global__ void __launch_bounds__(kPdThreads)
paged_decode_kernel(const T* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const int* __restrict__ page_table, const int* __restrict__ lens,
                    T* __restrict__ out, int H, int KV, int dh, int ps, int n_p, int n_pages,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_s = reinterpret_cast<long long*>(smem_raw);
  const int group = H / KV;
  const int hk = blockIdx.x, b = blockIdx.y;
  float* q_s = reinterpret_cast<float*>(row_s + kPdBK);
  float* k_s = q_s + group * dh;
  float* v_s = k_s + kPdBK * (dh + 1);
  float* p_s = v_s + kPdBK * dh;
  float* m_s = p_s + group * kPdBK;
  float* l_s = m_s + group;
  float* c_s = l_s + group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const long long q_base = ((long long)b * H + (long long)hk * group) * dh;
  for (int i = tid; i < group * dh; i += kPdThreads) q_s[i] = to_f(q[q_base + i]) * scale;
  if (tid < group) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kPdMaxGroup][kPdDPT];
#pragma unroll
  for (int g = 0; g < kPdMaxGroup; ++g)
#pragma unroll
    for (int i = 0; i < kPdDPT; ++i) acc[g][i] = 0.f;

  const int len = max(0, min(lens[b], n_p * ps));
  const int* pt = page_table + (long long)b * n_p;
  __syncthreads();

  for (int k0 = 0; k0 < len; k0 += kPdBK) {
    if (tid < kPdBK) {
      const int pos = k0 + tid;
      row_s[tid] = pos < len ? pool_row(pt, pos, ps, KV, hk, n_pages) : -1;
    }
    __syncthreads();
    for (int i = tid; i < kPdBK * dh; i += kPdThreads) {
      const int j = i / dh, d = i % dh;
      const long long row = row_s[j];
      float kx = 0.f, vx = 0.f;
      if (row >= 0) {
        kx = pool_elem(k, k_scale, row, dh, d);
        vx = pool_elem(v, v_scale, row, dh, d);
      }
      k_s[j * (dh + 1) + d] = kx;
      v_s[j * dh + d] = vx;
    }
    __syncthreads();
    // scores: (group x 32) dot products of length dh
    for (int i = tid; i < group * kPdBK; i += kPdThreads) {
      const int g = i / kPdBK, j = i % kPdBK;
      const float* qr = q_s + g * dh;
      const float* kr = k_s + j * (dh + 1);
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax: one warp per query row, lane = key
    for (int g = warp; g < group; g += kPdWarps) {
      const bool ok = k0 + lane < len;
      const float s = ok ? p_s[g * kPdBK + lane] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p);
      p_s[g * kPdBK + lane] = p;
      if (lane == 0) {
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    // acc = acc * corr + P @ V; thread owns head-dim entries tid, tid + 128
#pragma unroll
    for (int i = 0; i < kPdDPT; ++i) {
      const int d = tid + i * kPdThreads;
      if (d >= dh) continue;
#pragma unroll
      for (int g = 0; g < kPdMaxGroup; ++g) {
        if (g >= group) break;
        float a = acc[g][i] * c_s[g];
        const float* pr = p_s + g * kPdBK;
#pragma unroll 8
        for (int j = 0; j < kPdBK; ++j) a = fmaf(pr[j], v_s[j * dh + d], a);
        acc[g][i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPdDPT; ++i) {
    const int d = tid + i * kPdThreads;
    if (d >= dh) continue;
#pragma unroll
    for (int g = 0; g < kPdMaxGroup; ++g) {
      if (g >= group) break;
      out[q_base + (long long)g * dh + d] = from_f<T>(acc[g][i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, typename E>
static cudaError_t launch_paged_decode(const void* q, const void* k, const void* v,
                                       const float* k_scale, const float* v_scale,
                                       const int* page_table, const int* lens, void* out, int B,
                                       int H, int KV, int dh, int ps, int n_p, int n_pages,
                                       float scale, cudaStream_t stream) {
  const size_t smem = paged_decode_smem_bytes(H / KV, dh);
  cudaError_t e = allow_smem(paged_decode_kernel<T, E>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(KV, B);
  paged_decode_kernel<T, E><<<grid, kPdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const E*>(k), static_cast<const E*>(v), k_scale,
      v_scale, page_table, lens, static_cast<T*>(out), H, KV, dh, ps, n_p, n_pages, scale);
  return cudaGetLastError();
}

static bool paged_decode_args_ok(int H, int KV, int dh, int ps, int n_p, int n_pages) {
  return KV > 0 && H % KV == 0 && H / KV <= kPdMaxGroup && dh > 0 && dh <= kPdMaxDh && ps > 0 &&
         n_p > 0 && n_pages > 0;
}

}  // namespace famous

extern "C" int famous_paged_decode_attention(int dtype, const void* q, const void* k,
                                             const void* v, const void* page_table,
                                             const void* lens, void* out, int B, int H, int KV,
                                             int dh, int ps, int n_p, int n_pages, float scale,
                                             void* stream) {
  using namespace famous;
  if (!paged_decode_args_ok(H, KV, dh, ps, n_p, n_pages))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* l = static_cast<const int*>(lens);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_paged_decode<float, float>(q, k, v, nullptr, nullptr, pt, l, out, B, H, KV, dh,
                                          ps, n_p, n_pages, scale, s);
  else if (dtype == kBF16)
    e = launch_paged_decode<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, pt, l, out,
                                                          B, H, KV, dh, ps, n_p, n_pages, scale,
                                                          s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" int famous_paged_decode_attention_int8(int dtype, const void* q, const void* k,
                                                  const void* v, const void* k_scale,
                                                  const void* v_scale, const void* page_table,
                                                  const void* lens, void* out, int B, int H,
                                                  int KV, int dh, int ps, int n_p, int n_pages,
                                                  float scale, void* stream) {
  using namespace famous;
  if (!paged_decode_args_ok(H, KV, dh, ps, n_p, n_pages))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* pt = static_cast<const int*>(page_table);
  const int* l = static_cast<const int*>(lens);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_paged_decode<float, int8_t>(q, k, v, ks, vs, pt, l, out, B, H, KV, dh, ps, n_p,
                                           n_pages, scale, s);
  else if (dtype == kBF16)
    e = launch_paged_decode<__nv_bfloat16, int8_t>(q, k, v, ks, vs, pt, l, out, B, H, KV, dh,
                                                   ps, n_p, n_pages, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
