// paged_chunk_prefill(_int8): a chunk of C query tokens of one slot at
// absolute positions [q_offset, q_offset + C) attends causally to the
// slot's pages of a shared K/V pool, which already hold the chunk's rows.
//
//   q           (B, C, H, dh)           contiguous (the model's layout)
//   k, v        (n_pages, ps, KV, dh)   contiguous pools; f32/bf16, or int8
//   k_scale,    (n_pages, ps, KV) f32   int8 pools only: one scale per row
//   v_scale
//   page_table  (B, n_p) int32          key pos of slot b lives in page
//                                       page_table[b, pos / ps], row pos % ps
//   out         (B, C, H, dh)
//
// Key position j is visible to chunk row c iff j <= q_offset + c.
//
// Replaces: src/repro/kernels/decode/chunk_prefill.py, paged_chunk_prefill
// (Pallas _paged_chunk_prefill_kernel) and paged_chunk_prefill_int8
// (_paged_chunk_prefill_kernel_int8).  On the TPU one block holds all
// group * C rows of one kv head in the (B, KV, group * C, dh) layout the
// wrapper transposes q into, and the grid walks every one of the slot's
// n_p pages through the scalar-prefetched table.  Here the design is
// chunk_prefill.cu's: q is read in the model's layout by strides, the rows
// are split over blocks of (32 chunk rows, one query head), 8 x 28 = 224
// blocks at C = 256 on qwen2-7b, and each block's key loop ends at run time
// at its causal edge q_offset + min(C, c0 + 32).  Only the addressing
// changes: before each 32-key tile the block resolves the tile's page ids
// once into shared memory, then loads the rows from those pages.  Keys past
// the causal edge are never read, so the null page that pads a short page
// table never adds to an output.  The fp and int8 kernels are two
// instantiations of one template that differ only in how a K/V element
// reaches the f32 tile (pool_elem in common.cuh: a cast, or int8 times its
// row's f32 scale before any product, as at chunk_prefill.py:215-216).
// The softmax is the TPU kernels': f32 running max and sum, -1e30 masks,
// divide by max(l, 1e-30).
//
// What bounds it on an H100: operations (7.5 GFLOP for C = 256 after 1792
// cached keys on qwen2-7b, about 7.6 us at the bf16 tensor-core peak) more
// than bytes (the slot's K/V pages, 4 MB in bf16, half that in int8).  This
// first version runs f32 FMAs on the CUDA cores from 32 x 32 tiles staged
// in shared memory, as chunk_prefill.cu does, so it sits far from that
// bound; tensor-core MMA on bf16 tiles is a later change.
#include "common.cuh"

namespace famous {

constexpr int kPcBQ = 32;       // chunk rows per block
constexpr int kPcBK = 32;       // keys per tile (= warp size: lane = key)
constexpr int kPcThreads = 256;
constexpr int kPcWarps = kPcThreads / 32;
constexpr int kPcMaxDh = 256;
constexpr int kPcLanesPerRow = kPcThreads / kPcBQ;          // 8 threads per row in P @ V
constexpr int kPcDPT = kPcMaxDh / kPcLanesPerRow;           // head-dim entries per thread

__host__ __device__ inline size_t paged_chunk_smem_bytes(int dh) {
  return sizeof(long long) * kPcBK                   // pool rows of the tile's keys
         + sizeof(float) * ((size_t)kPcBQ * dh       // Q tile (pre-scaled)
                            + (size_t)kPcBK * (dh + 1)   // K tile (padded rows)
                            + (size_t)kPcBK * dh         // V tile
                            + (size_t)kPcBQ * (kPcBK + 1)  // scores / probabilities
                            + 3 * (size_t)kPcBQ);        // running max, sum, correction
}

template <typename T, typename E>
__global__ void __launch_bounds__(kPcThreads)
paged_chunk_prefill_kernel(const T* __restrict__ q, const E* __restrict__ k,
                           const E* __restrict__ v, const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, const int* __restrict__ page_table,
                           T* __restrict__ out, int C, int H, int KV, int dh, int ps, int n_p,
                           int n_pages, int q_offset, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_s = reinterpret_cast<long long*>(smem_raw);
  const int group = H / KV;
  const int c0 = blockIdx.x * kPcBQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / group;
  float* q_s = reinterpret_cast<float*>(row_s + kPcBK);
  float* k_s = q_s + kPcBQ * dh;
  float* v_s = k_s + kPcBK * (dh + 1);
  float* p_s = v_s + kPcBK * dh;
  float* m_s = p_s + kPcBQ * (kPcBK + 1);
  float* l_s = m_s + kPcBQ;
  float* c_s = l_s + kPcBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kPcBQ * dh; i += kPcThreads) {
    const int r = i / dh, d = i % dh, c = c0 + r;
    q_s[i] = c < C ? to_f(q[(((long long)b * C + c) * H + hq) * dh + d]) * scale : 0.f;
  }
  if (tid < kPcBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int row = tid / kPcLanesPerRow, dlane = tid % kPcLanesPerRow;
  float acc[kPcDPT];
#pragma unroll
  for (int i = 0; i < kPcDPT; ++i) acc[i] = 0.f;

  // the block's last visible key is q_offset + (its last real row)
  const int kend = min(n_p * ps, q_offset + min(C, c0 + kPcBQ));
  const int* pt = page_table + (long long)b * n_p;
  __syncthreads();

  for (int k0 = 0; k0 < kend; k0 += kPcBK) {
    if (tid < kPcBK) {
      const int pos = k0 + tid;
      row_s[tid] = pos < kend ? pool_row(pt, pos, ps, KV, hk, n_pages) : -1;
    }
    __syncthreads();
    for (int i = tid; i < kPcBK * dh; i += kPcThreads) {
      const int j = i / dh, d = i % dh;
      const long long r = row_s[j];
      float kx = 0.f, vx = 0.f;
      if (r >= 0) {
        kx = pool_elem(k, k_scale, r, dh, d);
        vx = pool_elem(v, v_scale, r, dh, d);
      }
      k_s[j * (dh + 1) + d] = kx;
      v_s[j * dh + d] = vx;
    }
    __syncthreads();
    // scores: (32 x 32) dot products of length dh; a warp shares one row
    for (int i = tid; i < kPcBQ * kPcBK; i += kPcThreads) {
      const int r = i / kPcBK, j = i % kPcBK;
      const float* qr = q_s + r * dh;
      const float* kr = k_s + j * (dh + 1);
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[r * (kPcBK + 1) + j] = s;
    }
    __syncthreads();
    // online softmax: one warp per row, lane = key
    for (int r = warp; r < kPcBQ; r += kPcWarps) {
      const int pos = k0 + lane;
      const bool ok = pos < kend && pos <= q_offset + c0 + r;
      const float s = ok ? p_s[r * (kPcBK + 1) + lane] : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p);
      p_s[r * (kPcBK + 1) + lane] = p;
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
      const float* pr = p_s + row * (kPcBK + 1);
#pragma unroll
      for (int i = 0; i < kPcDPT; ++i) {
        const int d = dlane + i * kPcLanesPerRow;
        if (d >= dh) break;
        float a = acc[i] * corr;
#pragma unroll 8
        for (int j = 0; j < kPcBK; ++j) a = fmaf(pr[j], v_s[j * dh + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const int c = c0 + row;
  if (c < C) {
    T* o = out + (((long long)b * C + c) * H + hq) * dh;
#pragma unroll
    for (int i = 0; i < kPcDPT; ++i) {
      const int d = dlane + i * kPcLanesPerRow;
      if (d >= dh) break;
      o[d] = from_f<T>(acc[i] / fmaxf(l_s[row], 1e-30f));
    }
  }
}

template <typename T, typename E>
static cudaError_t launch_paged_chunk(const void* q, const void* k, const void* v,
                                      const float* k_scale, const float* v_scale,
                                      const int* page_table, void* out, int B, int C, int H,
                                      int KV, int dh, int ps, int n_p, int n_pages, int q_offset,
                                      float scale, cudaStream_t stream) {
  const size_t smem = paged_chunk_smem_bytes(dh);
  cudaError_t e = allow_smem(paged_chunk_prefill_kernel<T, E>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((C + kPcBQ - 1) / kPcBQ, H, B);
  paged_chunk_prefill_kernel<T, E><<<grid, kPcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const E*>(k), static_cast<const E*>(v), k_scale,
      v_scale, page_table, static_cast<T*>(out), C, H, KV, dh, ps, n_p, n_pages, q_offset,
      scale);
  return cudaGetLastError();
}

static bool paged_chunk_args_ok(int H, int KV, int dh, int ps, int n_p, int n_pages,
                                int q_offset) {
  return KV > 0 && H % KV == 0 && dh > 0 && dh <= kPcMaxDh && ps > 0 && n_p > 0 &&
         n_pages > 0 && q_offset >= 0;
}

}  // namespace famous

extern "C" int famous_paged_chunk_prefill(int dtype, const void* q, const void* k,
                                          const void* v, const void* page_table, void* out,
                                          int B, int C, int H, int KV, int dh, int ps, int n_p,
                                          int n_pages, int q_offset, float scale,
                                          void* stream) {
  using namespace famous;
  if (!paged_chunk_args_ok(H, KV, dh, ps, n_p, n_pages, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_paged_chunk<float, float>(q, k, v, nullptr, nullptr, pt, out, B, C, H, KV, dh, ps,
                                         n_p, n_pages, q_offset, scale, s);
  else if (dtype == kBF16)
    e = launch_paged_chunk<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, pt, out, B,
                                                         C, H, KV, dh, ps, n_p, n_pages,
                                                         q_offset, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" int famous_paged_chunk_prefill_int8(int dtype, const void* q, const void* k,
                                               const void* v, const void* k_scale,
                                               const void* v_scale, const void* page_table,
                                               void* out, int B, int C, int H, int KV, int dh,
                                               int ps, int n_p, int n_pages, int q_offset,
                                               float scale, void* stream) {
  using namespace famous;
  if (!paged_chunk_args_ok(H, KV, dh, ps, n_p, n_pages, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* pt = static_cast<const int*>(page_table);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_paged_chunk<float, int8_t>(q, k, v, ks, vs, pt, out, B, C, H, KV, dh, ps, n_p,
                                          n_pages, q_offset, scale, s);
  else if (dtype == kBF16)
    e = launch_paged_chunk<__nv_bfloat16, int8_t>(q, k, v, ks, vs, pt, out, B, C, H, KV, dh, ps,
                                                  n_p, n_pages, q_offset, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
