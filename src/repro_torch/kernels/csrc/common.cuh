// Helpers shared by the port's kernels: element conversion to and from the
// f32 compute type, warp reductions, the launch epilogue and the launch
// record the contract checker reads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace famous {

// dtype codes of the C interface (repro_torch/kernels/lib.py: DTYPE_CODE)
enum DType { kF32 = 0, kBF16 = 1 };

// Finite "minus infinity" of the TPU kernels' masks, so a fully masked
// tile never produces inf - inf.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The masks of the TPU attention kernels (_tile_mask in
// src/repro/kernels/attention/mha.py): key position kp is visible to query
// position qp (both absolute) when causal allows it (kp <= qp) and it lies
// inside the sliding window (kp > qp - window; window <= 0 is global).
__device__ __forceinline__ bool key_visible(int qp, int kp, int causal, int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// Paged K/V pools (paged_decode_attention.cu, paged_chunk_prefill.cu) are
// contiguous (n_pages, page_size, KV, dh) tensors; a "row" is one (token,
// kv head) vector of dh elements, row = (page * page_size + pos % page_size)
// * KV + kv_head.  int8 pools carry f32 (n_pages, page_size, KV) scale pools,
// one scale per row.

// The row of key `pos` of kv head `hk` in a slot whose page-table row is
// `pt`.  An id outside [0, n_pages) reads the null page 0 instead of
// faulting (the engine never writes one; XLA's gather clamps likewise).
__device__ __forceinline__ long long pool_row(const int* pt, int pos, int ps, int KV, int hk,
                                              int n_pages) {
  int page = pt[pos / ps];
  if (page < 0 || page >= n_pages) page = 0;
  return ((long long)page * ps + pos % ps) * KV + hk;
}

// Element d of pool row `row` in f32: a cast from f32 or bf16, or the int8
// value times the row's f32 scale (the in-tile dequantization of the int8
// kernels, done before any product, as in the TPU kernels).
template <typename E>
__device__ __forceinline__ float pool_elem(const E* pool, const float* row_scale, long long row,
                                           int dh, int d) {
  if constexpr (std::is_same<E, int8_t>::value)
    return static_cast<float>(pool[row * dh + d]) * row_scale[row];
  else
    return to_f(pool[row * dh + d]);
}

// 16-byte asynchronous copy global -> shared (cp.async.cg, bypassing L1);
// src_bytes < 16 zero-fills the rest (0: a masked chunk reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tensor-core fragments (matmul_tiled.cu, chunk_prefill.cu): the
// shared-memory address of a pointer, ldmatrix (plain and transposed) and
// mma.sync m16n8k16 bf16 x bf16 -> f32.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to one bf16x2 mma operand, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Two f32 values as a hi + lo pair of bf16x2 operands: hi = bf16(x), lo =
// bf16(x - hi), so two products carry about 16 significant bits of x where
// one carries 8 (mha_bwd_dkv.cu's P^T and dS^T).
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// 2^x by the MUFU unit (ex2.approx.ftz: relative error about 2^-22;
// -inf gives 0, a denormal result flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// 4-byte asynchronous copy global -> shared (cp.async.ca); src_bytes 0
// zero-fills
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)), "l"(gmem),
               "r"(src_bytes));
}

// R rows of a (rows, dh) bf16 tensor from row `row0` into a shared tile of
// row stride LD, rows from `valid` on and columns from dh to DP
// zero-filled, the NT threads of the block sharing the copy: by 16-byte
// cp.async copies where vec (dh % 8 == 0 and 16-byte aligned bases), else
// element by element (mha_bwd_dq.cu, mha_bwd_dkv.cu).
template <int DP, int LD, int NT>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long row0, int R, int valid, int dh,
                                               int vec) {
  if (vec) {
    constexpr int CPR = DP / 8;  // 16-byte chunks of a row
    for (int c = threadIdx.x; c < R * CPR; c += NT) {
      const int r = c / CPR, col = (c % CPR) * 8;
      const bool ok = col < dh && r < valid;
      cp_async16(dst + r * LD + col, ok ? src + (row0 + r) * dh + col : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = c < dh && r < valid ? src[(row0 + r) * dh + c] : __float2bfloat16(0.f);
    }
  }
}

// The head dims of the MHA kernels (mha_forward.cu, mha_bwd_dq.cu,
// mha_bwd_dkv.cu): any dh up to kMhaMaxDh (recurrentgemma-2b's 256).  The
// bf16 tensor-core geometries of dq and dk/dv, one warp to each 16-row or
// 16-key strip, hold dh <= kMhaTcMaxDh; above it bf16 runs their wide
// geometries (DqWide, DkvWide: dh padded to kMhaMaxDh, the columns split
// across two warps a strip), and the bf16 forward chunk_tc.cuh's DP = 256
// geometry.  f32 runs the CUDA-core kernels at every dh, templated on
// their largest dh, so the dh <= kMhaTcMaxDh instantiations keep their
// registers.
constexpr int kMhaTcMaxDh = 128, kMhaMaxDh = 256;

// The padded head dim of the bf16 MHA kernels at dh <= kMhaTcMaxDh: 64 or
// 128, and 96 (famous-bert's) natively, which scripts/torch_kernel_sweep.py
// timed faster than padding it to 128.
inline int mha_tc_dp(int dh) { return dh <= 64 ? 64 : dh <= 96 ? 96 : 128; }

// Raise the dynamic shared-memory cap of `kernel` when a launch needs more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The launch log that repro_torch/analysis/kernel_check.py reads through
// kernels/lib.py (launch_log.cu).  The layout is mirrored by lib.py's
// _LaunchRecord: keep the two in step.
struct LaunchRecord {
  char name[48];
  int grid[3], block[3];
  long long dyn_smem;     // dynamic shared memory asked at the launch
  long long smem_cap;     // the function's dynamic shared-memory cap then
  long long static_smem;  // the compiled kernel's static shared memory
  int regs;               // registers a thread
  int max_threads;        // the largest block the compiled kernel allows
  int smem_optin;         // the device's opt-in shared memory a block
  int grid_stride;        // bit d: the blocks loop over grid dim d
  long long extent[3];    // per grid dim: what the grid must cover
  long long tile[3];      // per grid dim: what one block covers of it
  long long ws_written;   // workspace elements the launched grid writes
};

bool launch_log_on();
void log_launch(const LaunchRecord& r);

// One grid dimension as the contract checker reads it: the extent the
// launch must cover and what one block covers of it; loop: the blocks
// stride over the extent by the grid (a grid-stride loop).
struct Cover {
  long long extent = 1, tile = 1;
  bool loop = false;
};

// Record a launch about to be made (only while kernels/lib.py turned the
// log on: the contract checker is enabled).  Called just before each
// <<<...>>> with the same kernel, grid, threads and dynamic shared memory.
template <typename K>
inline void record_launch(K kernel, const char* name, dim3 grid, unsigned threads, size_t smem,
                          Cover x, Cover y = {}, Cover z = {}, long long ws_written = 0) {
  if (!launch_log_on()) return;
  LaunchRecord r{};
  for (int i = 0; i < 47 && name[i]; ++i) r.name[i] = name[i];
  r.grid[0] = grid.x, r.grid[1] = grid.y, r.grid[2] = grid.z;
  r.block[0] = threads, r.block[1] = 1, r.block[2] = 1;
  r.dyn_smem = static_cast<long long>(smem);
  cudaFuncAttributes a{};
  if (cudaFuncGetAttributes(&a, kernel) == cudaSuccess) {
    r.smem_cap = a.maxDynamicSharedSizeBytes;
    r.static_smem = static_cast<long long>(a.sharedSizeBytes);
    r.regs = a.numRegs;
    r.max_threads = a.maxThreadsPerBlock;
  } else {
    r.regs = -1;
    cudaGetLastError();  // the launch that follows reports its own error
  }
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&r.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    cudaGetLastError();
  const Cover c[3] = {x, y, z};
  for (int d = 0; d < 3; ++d) {
    r.extent[d] = c[d].extent;
    r.tile[d] = c[d].tile;
    if (c[d].loop) r.grid_stride |= 1 << d;
  }
  r.ws_written = ws_written;
  log_launch(r);
}

}  // namespace famous
