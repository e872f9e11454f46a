// paged_chunk_prefill(_int8): a chunk of C query tokens of one slot at
// absolute positions [q_offset, q_offset + C) attends causally to the
// slot's pages of a shared K/V pool, which already hold the chunk's rows.
//
//   q           (B, C, H, dh)           contiguous (the model's layout)
//   k, v        (n_pages, ps, KV, dh)   contiguous pools; f32/bf16, or int8
//   k_scale,    (n_pages, ps, KV) f32   int8 pools only: one scale per row
//   v_scale
//   page_table  (n_slots, n_p) int32    key pos of q's row b lives in page
//                                       page_table[slot + b, pos / ps], row
//                                       pos % ps
//   slot        int32 in device memory  (null: 0)
//   q_offset    int32 in device memory  the chunk's first position
//   out         (B, C, H, dh)
//
// Key position j is visible to chunk row c iff j <= q_offset + c (and j <
// n_p * ps).  The slot and q_offset are read by each block, as the TPU
// kernel reads q_offset from SMEM, so one captured CUDA graph of the
// launch serves every slot and offset.
//
// Replaces: src/repro/kernels/decode/chunk_prefill.py, paged_chunk_prefill
// (Pallas _paged_chunk_prefill_kernel) and paged_chunk_prefill_int8
// (_paged_chunk_prefill_kernel_int8).  On the TPU one block holds all
// group * C rows of one kv head in the (B, KV, group * C, dh) layout the
// wrapper transposes q into, the grid walks every one of the slot's n_p
// pages through the scalar-prefetched table, and int8 pages are
// dequantized in f32 before the products (chunk_prefill.py:215-216).
//
// What bounds it on an H100: operations (7.0 GFLOP for C = 256 at offset
// 1792 on qwen2-7b, 7.1 us at the bf16 tensor-core peak; 0.11 ms at the
// f32 FMA rate) more than bytes (the slot's K/V pages, 4 MB in bf16, half
// that in int8).
//
// Design, bf16: the tensor-core kernel and ordered split combine of
// chunk_tc.cuh, the body chunk_prefill.cu runs on a contiguous cache, on
// PagedKV: q is read in the model's layout, the rows split over blocks of
// (128 chunk rows, one query head) whose key ranges are split as the
// contiguous kernel's (famous_chunk_prefill_plan with Skv = n_p * ps),
// and only the addressing differs: each 64-key tile's page ids reach
// shared memory a tile ahead, one read a page, and each key's pool row is
// then copied by the same 16-byte cp.async.  Keys past a block's causal
// edge are never read, so the null page that pads a short table never adds
// to an output.  int8 pools keep their values exact in the bf16 tiles and
// apply the f32 row scales to the scores (K, after Q K^T) and to P's
// columns (V, before P is rounded for P V); their rows are staged through
// an int8 ring of cp.async copies (kServeInt8Stage).  The softmax is
// chunk_tc.cuh's: f32 running max and sum in log2 units, -inf masks,
// divide by max(l, 1e-30).  On identity pages over a contiguous cache the
// fp kernel gives chunk_prefill's bits.
//
// f32 (q and out f32; f32 or int8 pools): the CUDA-core kernel of the
// first port, kept as chunk_prefill.cu keeps its own (f32 at 2e-5 is the
// parity of the paged and contiguous kernels): one block per (32 chunk
// rows, query head), 32 x 32 tiles in shared memory, each key's row
// resolved through the page table before its tile is loaded, an int8
// element dequantized (int8 times its row's scale) before any product.
#include "chunk_tc.cuh"

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
                           int n_pages, const int* __restrict__ slot,
                           const int* __restrict__ q_off, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_s = reinterpret_cast<long long*>(smem_raw);
  const int group = H / KV;
  const int c0 = blockIdx.x * kPcBQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / group;
  const int q_offset = __ldg(q_off);
  const long long sb = b + (slot != nullptr ? __ldg(slot) : 0);  // the page-table row
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
  const int* pt = page_table + sb * n_p;
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
                                      int KV, int dh, int ps, int n_p, int n_pages,
                                      const int* slot, const int* q_offset, float scale,
                                      cudaStream_t stream) {
  const size_t smem = paged_chunk_smem_bytes(dh);
  cudaError_t e = allow_smem(paged_chunk_prefill_kernel<T, E>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((C + kPcBQ - 1) / kPcBQ, H, B);
  record_launch(paged_chunk_prefill_kernel<T, E>, "paged_chunk_prefill_kernel", grid, kPcThreads,
                smem, {C, kPcBQ}, {H, 1}, {B, 1});
  paged_chunk_prefill_kernel<T, E><<<grid, kPcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const E*>(k), static_cast<const E*>(v), k_scale,
      v_scale, page_table, static_cast<T*>(out), C, H, KV, dh, ps, n_p, n_pages, slot, q_offset,
      scale);
  return cudaGetLastError();
}

// The int8 staging of the serving kernel (chunk_tc.cuh, KVStage): at the
// serving geometry the int8 ring is 1-2% faster than register staging
// (PERF.md's sweep); registers win only with 64-row blocks, which lose to
// 128-row blocks on both.
constexpr KVStage kServeInt8Stage = KVStage::kRing8;

static bool paged_chunk_args_ok(int dtype, int H, int KV, int dh, int ps, int n_p, int n_pages,
                                const void* q_offset, int splits, const void* part) {
  return KV > 0 && H % KV == 0 && dh > 0 && dh <= kPcMaxDh && ps > 0 && n_p > 0 &&
         n_pages > 0 && q_offset != nullptr && splits >= 1 && splits <= kTcMaxSplits &&
         (splits == 1 || (part != nullptr && dtype == kBF16));
}

}  // namespace famous

// part: the split workspace of famous_chunk_prefill_plan (with Skv =
// n_p * ps) when splits > 1, else null; f32 takes one split.  slot (may be
// null) and q_offset: int32 scalars in device memory; the caller keeps
// q_offset >= 0 and slot + B within the page table.
extern "C" int famous_paged_chunk_prefill(int dtype, const void* q, const void* k,
                                          const void* v, const void* page_table, void* out,
                                          void* part, int splits, int B, int C, int H, int KV,
                                          int dh, int ps, int n_p, int n_pages, const void* slot,
                                          const void* q_offset, float scale, void* stream) {
  using namespace famous;
  if (!paged_chunk_args_ok(dtype, H, KV, dh, ps, n_p, n_pages, q_offset, splits, part))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* sl = static_cast<const int*>(slot);
  const int* off = static_cast<const int*>(q_offset);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_paged_chunk<float, float>(q, k, v, nullptr, nullptr, pt, out, B, C, H, KV, dh, ps,
                                         n_p, n_pages, sl, off, scale, s);
  else if (dtype == kBF16)
    e = launch_chunk_serve(
        static_cast<const bf16*>(q),
        PagedKV<bf16, KVStage::kCopy>{static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                                      nullptr, nullptr, pt, ps, n_p, n_pages, n_p * ps},
        ChunkQ{off, sl}, static_cast<bf16*>(out), static_cast<float*>(part), splits, B, C, H,
        KV, dh, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" int famous_paged_chunk_prefill_int8(int dtype, const void* q, const void* k,
                                               const void* v, const void* k_scale,
                                               const void* v_scale, const void* page_table,
                                               void* out, void* part, int splits, int B, int C,
                                               int H, int KV, int dh, int ps, int n_p,
                                               int n_pages, const void* slot,
                                               const void* q_offset, float scale,
                                               void* stream) {
  using namespace famous;
  if (!paged_chunk_args_ok(dtype, H, KV, dh, ps, n_p, n_pages, q_offset, splits, part))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* pt = static_cast<const int*>(page_table);
  const int* sl = static_cast<const int*>(slot);
  const int* off = static_cast<const int*>(q_offset);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_paged_chunk<float, int8_t>(q, k, v, ks, vs, pt, out, B, C, H, KV, dh, ps, n_p,
                                          n_pages, sl, off, scale, s);
  else if (dtype == kBF16)
    e = launch_chunk_serve(
        static_cast<const bf16*>(q),
        PagedKV<int8_t, kServeInt8Stage>{static_cast<const int8_t*>(k),
                                         static_cast<const int8_t*>(v), ks, vs, pt, ps, n_p,
                                         n_pages, n_p * ps},
        ChunkQ{off, sl}, static_cast<bf16*>(out), static_cast<float*>(part), splits, B, C, H,
        KV, dh, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
