// mha_forward: fused FAMOUS QK_PM -> softmax -> SV_PM over the flat
// layout, with the row log-sum-exp the flash backward needs.
//
//   q      (BH, Sq, dh)     contiguous, BH = BKV * group
//   k, v   (BKV, Skv, dh)   contiguous; query row bh reads kv row bh / group
//   out    (BH, Sq, dh)     in q's dtype
//   lse    (BH, Sq)         f32, m + log(max(l, 1e-30)); kNegInf for a row
//                           that sees no key
//
// Query position q_offset + i sees key j when key_visible() says so
// (causal and/or sliding window; neither is the encoder's full attention).
//
// Replaces: src/repro/kernels/attention/mha.py, mha_forward (the Pallas
// kernel _mha_kernel).  There the grid is (BH, Sq/block_q, Skv/block_k)
// and the last axis is sequential, carrying the f32 accumulator and the
// running max/sum in VMEM from one key tile to the next; the block sizes
// must divide the sequence lengths.  Here a block owns a tile of query
// rows of one head and walks its key tiles itself, with the accumulator in
// registers; the loop runs only over the keys its rows can see (it ends at
// the causal edge and starts at the window's), and ragged edges are
// masked.  Masked keys get probability 0 and the output is divided by
// max(l, 1e-30), so a row with no visible key gives 0, as on the TPU.
//
// What bounds it on an H100: operations (4 * BH * Sq * Skv * dh FLOP,
// halved when causal: 6.4 GFLOP for a famous-bert layer at B=8, S=512,
// 6.5 us at the bf16 tensor-core peak; 30 us for qwen2-7b at S=2048) far
// more than bytes (q, k, v, out once each: 6.3 MB in bf16, 1.9 us).
//
// Design, bf16: the tensor-core flash-attention body of chunk_tc.cuh (its
// header says how a block works: mma.sync m16n8k16, Q and K by ldmatrix,
// V by ldmatrix.trans, P from the score accumulators in registers, the
// online softmax on the fragments in log2 units with the scale after
// Q K^T, an f32 l of the unrounded P, P rounded to bf16 only for P V, a
// 2-stage cp.async ring of 64-key tiles), run on its FlatQ query side:
// ContigKV reads kv row b of (BKV, Skv, dh) for the group's query heads,
// the masks are key_visible()'s (full, causal with q_offset, a window's
// lower edge masked like the diagonal, only on the tiles that cross an
// edge), the LSE leaves in natural log, and under the causal mask the row
// blocks launch longest (last) first.  128-row blocks of 4 warps; dh 96
// (famous-bert) runs natively (six k16 steps, 208-byte padded rows, still
// conflict-free for ldmatrix), as scripts/torch_kernel_sweep.py chose
// (PERF.md).  A dh above 128 (recurrentgemma-2b's 256) runs the body's
// DP = 256 geometry, ServeTiles<256>: 64-row blocks, 16 rows a warp.
// famous-bert has 256 blocks and qwen2-7b 448, so the key
// range is split (famous_mha_forward_plan: chunk_tc_plan's rule) only at
// shapes with few rows; the ordered combine then also emits the LSE.
//
// f32: the CUDA-core kernel of the first port, in full f32 FMAs (no TF32):
// 32 x 32 tiles of Q, K and V staged in shared memory, q scaled before
// the product as the TPU kernel does, 8 threads a row in P V; one
// instantiation for dh <= 128 and one for dh <= 256.
#include "chunk_tc.cuh"

namespace famous {

constexpr int kFwBQ = 32;       // query rows per block
constexpr int kFwBK = 32;       // keys per tile (= warp size: lane = key)
constexpr int kFwThreads = 256;
constexpr int kFwWarps = kFwThreads / 32;
constexpr int kFwLanesPerRow = kFwThreads / kFwBQ;        // 8 threads per row in P @ V

__host__ __device__ inline size_t fwd_smem_floats(int dh) {
  return (size_t)kFwBQ * dh               // Q tile (pre-scaled)
         + (size_t)kFwBK * (dh + 1)       // K tile (padded rows)
         + (size_t)kFwBK * dh             // V tile
         + (size_t)kFwBQ * (kFwBK + 1)    // scores / probabilities
         + 3 * (size_t)kFwBQ;             // running max, sum, correction
}

// MaxDh: the largest head dim of the instantiation (kMhaTcMaxDh, or
// kMhaMaxDh above it); each thread holds MaxDh / 8 output columns.
template <typename T, int MaxDh>
__global__ void __launch_bounds__(kFwThreads)
mha_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                   int Sq, int Skv, int dh, int group, int causal, int window, int q_offset,
                   float scale) {
  constexpr int kFwDPT = MaxDh / kFwLanesPerRow;  // head-dim entries per thread
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

template <typename T, int MaxDh>
static cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                              float* lse, int BH, int group, int Sq, int Skv, int dh,
                              int causal, int window, int q_offset, float scale,
                              cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(dh) * sizeof(float);
  cudaError_t e = allow_smem(mha_forward_kernel<T, MaxDh>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kFwBQ - 1) / kFwBQ, BH);
  record_launch(mha_forward_kernel<T, MaxDh>, "mha_forward_kernel", grid, kFwThreads, smem,
                {Sq, kFwBQ}, {BH, 1});
  mha_forward_kernel<T, MaxDh><<<grid, kFwThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Sq, Skv, dh, group, causal, window, q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: chunk_tc.cuh's tensor-core body on the flat layout
// ---------------------------------------------------------------------------

// One geometry G at padded head dim DP: B = BKV kv rows of H = group query
// heads over one kv head each (KV = 1).
template <int DP, typename G>
static cudaError_t launch_fwd_tc(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                 float* lse, float* part, int splits, int BKV, int group, int Sq,
                                 int Skv, int dh, int causal, int window, int q_offset,
                                 float scale, int reverse, cudaStream_t stream) {
  const long long rs = (long long)Skv * dh;
  const ContigKV src{k, v, rs, dh, 0, rs, dh, 0, Skv};
  return launch_tc<DP, G, ContigKV, FlatQ>(q, src, FlatQ{causal, window, reverse, lse}, out,
                                           part, splits, BKV, Sq, group, 1, dh, q_offset, scale,
                                           stream);
}

static cudaError_t launch_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                   float* lse, float* part, int splits, int BKV, int group,
                                   int Sq, int Skv, int dh, int causal, int window, int q_offset,
                                   float scale, cudaStream_t stream) {
  if (dh > kMhaTcMaxDh)
    return launch_fwd_tc<256, ServeTiles<256>>(q, k, v, out, lse, part, splits, BKV, group, Sq,
                                               Skv, dh, causal, window, q_offset, scale, causal,
                                               stream);
  switch (mha_tc_dp(dh)) {
    case 64:
      return launch_fwd_tc<64, ServeTiles<64>>(q, k, v, out, lse, part, splits, BKV, group, Sq,
                                               Skv, dh, causal, window, q_offset, scale, causal,
                                               stream);
    case 96:
      return launch_fwd_tc<96, ServeTiles<96>>(q, k, v, out, lse, part, splits, BKV, group, Sq,
                                               Skv, dh, causal, window, q_offset, scale, causal,
                                               stream);
    default:
      return launch_fwd_tc<128, ServeTiles<128>>(q, k, v, out, lse, part, splits, BKV, group, Sq,
                                                 Skv, dh, causal, window, q_offset, scale,
                                                 causal, stream);
  }
}

}  // namespace famous

// The key-range split count of the bf16 kernel (chunk_tc_plan on the flat
// shape: B = BKV, C = Sq, H = group), 1 for f32.  *ws_elems: the f32
// workspace of the split partials (0 for one split), which the wrapper
// allocates.
extern "C" int famous_mha_forward_plan(int dtype, int BH, int BKV, int Sq, int Skv, int dh,
                                       int sms, long long* ws_elems) {
  using namespace famous;
  *ws_elems = 0;
  if (dtype != kBF16 || BKV <= 0 || BH % BKV != 0 || Sq <= 0) return 1;
  return chunk_tc_plan(BKV, Sq, BH / BKV, dh, Skv, sms, ws_elems);
}

// part: the workspace of famous_mha_forward_plan when splits > 1, else null.
extern "C" int famous_mha_forward(int dtype, const void* q, const void* k, const void* v,
                                  void* out, float* lse, void* part, int splits, int BH, int BKV,
                                  int Sq, int Skv, int dh, int causal, int window, int q_offset,
                                  float scale, void* stream) {
  using namespace famous;
  if (BKV <= 0 || BH % BKV != 0 || BH > 65535 || dh <= 0 || dh > kMhaMaxDh || splits < 1 ||
      splits > kTcMaxSplits || (splits > 1 && (part == nullptr || dtype != kBF16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = BH / BKV;
  cudaError_t e;
  if (dtype == kF32 && dh <= kMhaTcMaxDh)
    e = launch_fwd<float, kMhaTcMaxDh>(q, k, v, out, lse, BH, group, Sq, Skv, dh, causal, window,
                                       q_offset, scale, s);
  else if (dtype == kF32)
    e = launch_fwd<float, kMhaMaxDh>(q, k, v, out, lse, BH, group, Sq, Skv, dh, causal, window,
                                     q_offset, scale, s);
  else if (dtype == kBF16)
    e = launch_fwd_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), static_cast<bf16*>(out), lse,
                        static_cast<float*>(part), splits, BKV, group, Sq, Skv, dh, causal,
                        window, q_offset, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
