// mla_decode: one new query token per row against its slot's latent cache,
// absorbed latent attention (MLA, DeepSeek-V3 / kimi-k2-instruct), bf16.
//
//   q      (R, 64, 576)          contiguous: per head [q_nope W_UK^T (512) |
//                                q_rope (64)], the absorbed query
//   kv     (slots, Skv, 576)     read in place, rows contiguous, slot stride
//                                given: per token [c (512, normed) | k_rope]
//   lens   (R,) int32            valid rows of each row's slot
//   out    (R, 64, 512)          P c: the heads' latent outputs (W_UV follows)
//
// Replaces no TPU kernel: the JAX package has no latent attention.  It was
// added because no design of decode_split.cuh covers a group of 64 query
// heads over one 576-wide row: all 64 heads of a slot read the same latent
// row, scores over its 576 values and P V over its first 512.
//
// What bounds it on an H100: bytes.  A key costs one row of 1152 bytes and
// 2 * 64 * (576 + 512) = 139 kFLOP: on CUDA cores that is compute-bound,
// on tensor cores 121 FLOP a byte, under the card's ridge of about 295.
//
// Design: flash-decoding with the 64 heads as the M side of mma.sync
// m16n8k16 products.  The grid is (range, row): a block owns a range of L
// keys of one row (mla_plan, from static shapes; a range past the row's
// length exits at once) and walks it in tiles of 64 keys, each tile's
// 72 KB of rows arriving by 16-byte cp.async copies into one of two
// shared-memory stages while the block computes on the other; q (72 KB)
// stays in shared memory for the whole range.  Rows are stored with their
// 16-byte chunks XOR-swizzled by the row's low three bits, so ldmatrix
// reads them without bank conflicts.  Eight warps: warp (p, h), p = 0..3
// and h = 0..1, owns heads 16p..16p+15; for the scores it takes keys
// 32h..32h+31 of the tile (36 k-steps over the 576 values), for P V the
// latent columns 256h..256h+255 (f32 accumulators in registers: 128 a
// thread).  The two warps of a head strip trade their score maxima through
// shared memory (one barrier), so both keep the same running max; P goes
// to shared memory in bf16 (a second barrier) and is read back as the A
// operand of P V, whose B operand is the same tile's rows, read transposed.
// Base-2 online softmax; at the range's end each block writes its (m, l,
// acc) in f32 to the workspace of decode_split.cuh's layout, whose combine
// pass (instantiated on the tag type below) merges the ranges in a fixed
// order, so relaunches are bit-identical.
#include "decode_split.cuh"

namespace famous {

constexpr int kMlaH = 64, kMlaDk = 576, kMlaDv = 512;
constexpr int kMlaTK = 64;                  // keys a tile
constexpr int kMlaThreads = 256;            // 8 warps
constexpr int kMlaChunks = kMlaDk / 8;      // 16-byte chunks of a row: 72
constexpr int kMlaMaxKeys = 2048;           // L's cap
constexpr size_t kMlaRowTile = (size_t)kMlaTK * kMlaDk;  // elements of a tile
constexpr size_t kMlaSmem =
    (kMlaRowTile * 3 + (size_t)kMlaH * kMlaTK) * sizeof(__nv_bfloat16) +
    2 * kMlaH * sizeof(float);

// The combine pass of decode_split.cuh instantiated for this kernel: the
// tag names it in a profile (its symbol carries "mla_decode").
struct mla_decode_rows {};

// the element offset of (row, col) in a swizzled [rows][576] tile
__device__ __forceinline__ int mla_sw(int row, int col) {
  return row * kMlaDk + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}

// the element offset of (row, key) in the swizzled [64][64] P tile
__device__ __forceinline__ int mla_psw(int row, int key) {
  return row * kMlaTK + (((key >> 3) ^ (row & 7)) << 3) + (key & 7);
}

// rows [k0, k0 + 64) of a slot into a swizzled tile; rows at or past `end`
// zero-filled (nothing read)
__device__ __forceinline__ void mla_load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              int k0, int end) {
  for (int c = threadIdx.x; c < kMlaTK * kMlaChunks; c += kMlaThreads) {
    const int r = c / kMlaChunks, ch = c % kMlaChunks;
    const bool ok = k0 + r < end;
    cp_async16(dst + r * kMlaDk + ((ch ^ (r & 7)) << 3),
               ok ? src + (long long)(k0 + r) * kMlaDk + ch * 8 : src, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kMlaThreads, 1)
mla_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kv,
                  const int* __restrict__ lens, float* __restrict__ ws, int R, int Skv,
                  long long slot_stride, int L, int S, float scale2) {
  extern __shared__ __align__(16) unsigned char mla_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(mla_smem);
  __nv_bfloat16* sK = sQ + kMlaRowTile;             // two stages
  __nv_bfloat16* sP = sK + 2 * kMlaRowTile;
  float* red = reinterpret_cast<float*>(sP + kMlaH * kMlaTK);  // [2][64]

  const int split = blockIdx.x, r = blockIdx.y;
  const int len = max(0, min(lens[r], Skv));
  const int k_begin = split * L;
  if (k_begin >= len) return;
  const int k_end = min(len, k_begin + L);
  const int n_tiles = (k_end - k_begin + kMlaTK - 1) / kMlaTK;
  const __nv_bfloat16* rows = kv + (long long)r * slot_stride;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = warp & 3, hf = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * p;  // this warp's first head

  // q and the first tile, one commit group
  const __nv_bfloat16* qr = q + (long long)r * kMlaH * kMlaDk;
  for (int c = tid; c < kMlaH * kMlaChunks; c += kMlaThreads) {
    const int h = c / kMlaChunks, ch = c % kMlaChunks;
    cp_async16(sQ + h * kMlaDk + ((ch ^ (h & 7)) << 3), qr + h * kMlaDk + ch * 8, 16);
  }
  mla_load_tile(sK, rows, k_begin, k_end);
  cp_async_commit();

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[32][4];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kMlaTK;
    const __nv_bfloat16* tile = sK + (it & 1) * kMlaRowTile;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      mla_load_tile(sK + ((it + 1) & 1) * kMlaRowTile, rows, k0 + kMlaTK, k_end);
      cp_async_commit();
    }

    // scores: heads row0.., keys 32 hf .. 32 hf + 31 of the tile
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kMlaDk / 16; ++kk) {
      unsigned a[4], b[4];
      ldmatrix_x4(a, sQ + mla_sw(row0 + (lane & 15), 16 * kk + 8 * (lane >> 4)));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int key = 32 * hf + 16 * jj + (lane & 7) + 8 * (lane >> 4);
        ldmatrix_x4(b, tile + mla_sw(key, 16 * kk + 8 * ((lane >> 3) & 1)));
        mma_bf16(s[2 * jj], a, b[0], b[1]);
        mma_bf16(s[2 * jj + 1], a, b[2], b[3]);
      }
    }
    // mask keys past the range, scale to base 2, this warp's row maxima
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 32 * hf + 8 * j + 2 * t + (e & 1);
        const float v = key < k_end ? s[j][e] * scale2 : kNegInf;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if (t == 0) {
      red[hf * kMlaH + row0 + g] = mx[0];
      red[hf * kMlaH + row0 + g + 8] = mx[1];
    }
    __syncthreads();
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i;
      const float m_new = fmaxf(m_run[i], fmaxf(red[row], red[kMlaH + row]));
      alpha[i] = ex2(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
    // P in bf16 to shared memory; l sums the rounded values P V uses
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = 32 * hf + 8 * j + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat162 pv = __floats2bfloat162_rn(ex2(s[j][2 * i] - m_run[i]),
                                                        ex2(s[j][2 * i + 1] - m_run[i]));
        l_run[i] += __low2float(pv) + __high2float(pv);
        *reinterpret_cast<__nv_bfloat162*>(sP + mla_psw(row0 + g + 8 * i, key)) = pv;
      }
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    __syncthreads();
    // P V: heads row0.., latent columns 256 hf .. 256 hf + 255
#pragma unroll
    for (int kk = 0; kk < kMlaTK / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, sP + mla_psw(row0 + (lane & 15), 16 * kk + 8 * (lane >> 4)));
      const int key = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        unsigned b[4];
        ldmatrix_x4_trans(b, tile + mla_sw(key, 256 * hf + 16 * jj + 8 * (lane >> 4)));
        mma_bf16(acc[2 * jj], a, b[0], b[1]);
        mma_bf16(acc[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }

  // the range's partial: l summed over the two warps of a head strip
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  __syncthreads();
  if (t == 0) {
    red[hf * kMlaH + row0 + g] = l_run[0];
    red[hf * kMlaH + row0 + g + 8] = l_run[1];
  }
  __syncthreads();
  const long long RH = (long long)R * kMlaH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int h = row0 + g + 8 * i;
    const long long row = (long long)r * kMlaH + h;
    float* a_out = ws + (row * S + split) * kMlaDv + 256 * hf + 2 * t;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<float2*>(a_out + 8 * j) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    if (hf == 0 && t == 0) {
      ws[RH * S * kMlaDv + row * S + split] = m_run[i] * kLn2;  // natural log units
      ws[RH * S * (kMlaDv + 1) + row * S + split] = red[h] + red[kMlaH + h];
    }
  }
}

// Keys per range L from static shapes and the SM count only: the largest
// power of two in [64, kMlaMaxKeys] (2048: scripts/torch_kernel_sweep.py
// timed 2048 fastest at the kimi-k2-instruct cell's decode step) whose grid at full rows, R *
// ceil(Skv / L) blocks, still gives each SM four, and no longer than Skv
// needs.  *ws_elems: the f32 workspace (decode_ws_elems at 64 heads of 512).
inline int mla_plan(int R, int Skv, int sms, long long* ws_elems) {
  int L = kMlaMaxKeys;
  const long long rows = std::max(R, 1);
  while (L > kMlaTK && rows * ((Skv + L - 1) / L) < 4LL * sms) L >>= 1;
  while (L > kMlaTK && L / 2 >= Skv) L >>= 1;
  *ws_elems = decode_ws_elems(R, kMlaH, kMlaDv, Skv, L);
  return L;
}

}  // namespace famous

extern "C" int famous_mla_decode_plan(int R, int Skv, int sms, long long* ws_elems) {
  return famous::mla_plan(R, Skv, sms, ws_elems);
}

// q (R, 64, 576), kv (slots, Skv, 576) with rows R of it read (row r at
// slot r), out (R, 64, 512), all bf16; ws: f32 workspace of the plan's
// size at L keys a range.
extern "C" int famous_mla_decode(const void* q, const void* kv, const void* lens, void* out,
                                 void* ws, int R, int Skv, long long slot_stride, int L,
                                 float scale, void* stream) {
  using namespace famous;
  if (R < 0 || Skv <= 0 || L < kMlaTK || L > kMlaMaxKeys || L % kMlaTK || ws == nullptr ||
      slot_stride < (long long)Skv * kMlaDk || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(kv) % 16 || slot_stride % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = (Skv + L - 1) / L;
  const dim3 grid(S, R);
  auto kernel = mla_decode_kernel;
  cudaError_t e = allow_smem(kernel, kMlaSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // each (row, head, range): 512 accumulators, then m and l
  record_launch(kernel, "mla_decode_kernel", grid, kMlaThreads, kMlaSmem, {Skv, L}, {R, 1}, {},
                (long long)R * S * kMlaH * (kMlaDv + 2));
  kernel<<<grid, kMlaThreads, kMlaSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kv),
      static_cast<const int*>(lens), static_cast<float*>(ws), R, Skv, slot_stride, L, S,
      scale * kLog2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_combine<__nv_bfloat16, mla_decode_rows>(
      static_cast<const float*>(ws), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), R, kMlaH, kMlaDv, Skv, L, S, s));
}
