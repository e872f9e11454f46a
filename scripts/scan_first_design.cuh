// The scan kernels' first CUDA design, kept as the baseline variants of
// scripts/torch_kernel_sweep.py (parts wkv6 and rglru), which time the
// redesigned kernels of src/repro_torch/kernels/csrc against them on the
// same card and inputs.  Never part of the port's library.
//   wkv6: one block per (batch, head) walking its chunks in order, the
//     (dh, dh) state in shared memory, 256 threads of 4 x 4 micro-tiles,
//     the cumsum walked by one thread per head-dim column;
//   rglru: one thread per (batch, feature) walking time in order, 16 steps
//     of a and b loaded ahead, 128-thread blocks.
#pragma once

#include "common.cuh"

namespace famous {
namespace first_design {


constexpr int kWkvThreads = 256;
constexpr int kWkvMax = 64;  // the largest chunk and head dim: 16 x 16 threads x 4 x 4

__host__ __device__ inline int wkv_smem_floats(int C, int dh) {
  const int ld = dh + 1;
  return dh * ld + 5 * C * ld + C * (C + 1) + C + 2 * dh;
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kWkvThreads)
wkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const TW* __restrict__ w, const float* __restrict__ u,
                 const float* __restrict__ s0, float* __restrict__ out,
                 float* __restrict__ s_final, int S, int dh, int C) {
  extern __shared__ float sm[];
  const int ld = dh + 1;          // padded row stride of every (rows, dh) tile
  float* st = sm;                 // (dh, ld)   the state S[d][e]
  float* qx = st + dh * ld;       // (C, ld)    r, then qexp
  float* kr = qx + C * ld;        // (C, ld)    k
  float* kx = kr + C * ld;        // (C, ld)    kexp
  float* vv = kx + C * ld;        // (C, ld)    v
  float* cw = vv + C * ld;        // (C, ld)    logw, then cw, then kdec
  float* att = cw + C * ld;       // (C, C + 1) strictly lower scores
  float* dg = att + C * (C + 1);  // (C)        diagonal bonus
  float* uu = dg + C;             // (dh)       u
  float* wl = uu + dh;            // (dh)       cw at the chunk's last step

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const long long bh = blockIdx.x;
  const long long base = bh * S * dh;
  for (int i = tid; i < dh * dh; i += kWkvThreads)
    st[(i / dh) * ld + i % dh] = s0 ? s0[bh * dh * dh + i] : 0.f;
  for (int i = tid; i < dh; i += kWkvThreads) uu[i] = u[bh * dh + i];

  // micro-tile rows and columns of this thread, clamped for the reads
  // (a smaller C or dh leaves some threads with nothing to store)
  int row[4], col[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = ty + 16 * i;
    col[i] = tx + 16 * i;
  }

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();  // the previous chunk is done with every tile
    for (int i = tid; i < C * dh; i += kWkvThreads) {
      const int t = i / dh, d = i % dh;
      const long long g = base + (long long)(c0 + t) * dh + d;
      qx[t * ld + d] = to_f(r[g]);
      kr[t * ld + d] = to_f(k[g]);
      vv[t * ld + d] = to_f(v[g]);
      cw[t * ld + d] = to_f(w[g]);
    }
    __syncthreads();
    // diag_t = sum_d (r u) k, one warp per row (before r becomes qexp)
    for (int t = warp; t < C; t += kWkvThreads / 32) {
      float p = 0.f;
      for (int d = lane; d < dh; d += 32)
        p += __fmul_rn(__fmul_rn(qx[t * ld + d], uu[d]), kr[t * ld + d]);
      p = warp_sum(p);
      if (lane == 0) dg[t] = p;
    }
    __syncthreads();
    // one thread per head-dim column walks time: cw, cw_prev, qexp, kexp
    if (tid < dh) {
      const int d = tid;
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float wt = cw[t * ld + d];
        acc = __fadd_rn(acc, wt);
        cw[t * ld + d] = acc;
        qx[t * ld + d] = __fmul_rn(qx[t * ld + d], expf(__fsub_rn(acc, wt)));
        kx[t * ld + d] = __fmul_rn(kr[t * ld + d], expf(-acc));
      }
      wl[d] = acc;
    }
    __syncthreads();
    // kdec = k exp(cw_C - cw), in place of cw
    for (int i = tid; i < C * dh; i += kWkvThreads) {
      const int t = i / dh, d = i % dh;
      cw[t * ld + d] = __fmul_rn(kr[t * ld + d], expf(__fsub_rn(wl[d], cw[t * ld + d])));
    }
    // att[t][s] = sum_d qexp[t][d] kexp[s][d] for s < t, else 0
    {
      float acc[4][4] = {};
      int tr[4], sr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tr[i] = min(row[i], C - 1);
        sr[i] = min(col[i], C - 1);
      }
      for (int d = 0; d < dh; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = qx[tr[i] * ld + d];
          kv[i] = kx[sr[i] * ld + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (row[i] < C && col[j] < C)
            att[row[i] * (C + 1) + col[j]] = col[j] < row[i] ? acc[i][j] : 0.f;
    }
    __syncthreads();
    // out[t][e] = sum_d qexp[t][d] S[d][e] + (sum_s att[t][s] v[s][e] + diag_t v[t][e])
    {
      float inter[4][4] = {}, intra[4][4] = {};
      int tr[4], er[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tr[i] = min(row[i], C - 1);
        er[i] = min(col[i], dh - 1);
      }
      for (int d = 0; d < dh; ++d) {
        float qv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = qx[tr[i] * ld + d];
          sv[i] = st[d * ld + er[i]];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(qv[i], sv[j], inter[i][j]);
      }
      for (int s = 0; s < C; ++s) {
        float av[4], vs[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = att[tr[i] * (C + 1) + s];
          vs[i] = vv[s * ld + er[i]];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) intra[i][j] = fmaf(av[i], vs[j], intra[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (row[i] < C && col[j] < dh) {
            const int t = row[i], e = col[j];
            const float in = __fadd_rn(intra[i][j], __fmul_rn(dg[t], vv[t * ld + e]));
            out[base + (long long)(c0 + t) * dh + e] = __fadd_rn(inter[i][j], in);
          }
    }
    __syncthreads();  // every read of the old state is done
    // S[d][e] <- exp(cw_C[d]) S[d][e] + sum_t kdec[t][d] v[t][e]
    {
      float acc[4][4] = {};
      int dr[4], er[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dr[i] = min(row[i], dh - 1);
        er[i] = min(col[i], dh - 1);
      }
      for (int t = 0; t < C; ++t) {
        float kv[4], vs[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = cw[t * ld + dr[i]];
          vs[i] = vv[t * ld + er[i]];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kv[i], vs[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (row[i] < dh && col[j] < dh) {
            const int d = row[i], e = col[j];
            st[d * ld + e] = __fadd_rn(__fmul_rn(expf(wl[d]), st[d * ld + e]), acc[i][j]);
          }
    }
  }
  __syncthreads();
  for (int i = tid; i < dh * dh; i += kWkvThreads)
    s_final[bh * dh * dh + i] = st[(i / dh) * ld + i % dh];
}

template <typename T, typename TW>
static cudaError_t launch_wkv6(const void* r, const void* k, const void* v, const void* w,
                               const float* u, const float* s0, float* out, float* s_final,
                               int BH, int S, int dh, int C, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(wkv_smem_floats(C, dh)) * sizeof(float);
  cudaError_t e = allow_smem(wkv6_scan_kernel<T, TW>, smem);
  if (e != cudaSuccess) return e;
  wkv6_scan_kernel<T, TW><<<BH, kWkvThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, s0, out, s_final, S, dh, C);
  return cudaGetLastError();
}



constexpr int kScanThreads = 128;
constexpr int kScanUnroll = 16;

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out,
                  int S, int R) {
  const int r = blockIdx.x * kScanThreads + threadIdx.x;
  if (r >= R) return;
  const long long base = (long long)blockIdx.y * S * R + r;
  float h = 0.f;
  int t = 0;
  for (; t + kScanUnroll <= S; t += kScanUnroll) {
    float av[kScanUnroll], bv[kScanUnroll];
#pragma unroll
    for (int i = 0; i < kScanUnroll; ++i) {
      const long long g = base + (long long)(t + i) * R;
      av[i] = to_f(a[g]);
      bv[i] = to_f(b[g]);
    }
#pragma unroll
    for (int i = 0; i < kScanUnroll; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);
      out[base + (long long)(t + i) * R] = h;
    }
  }
  for (; t < S; ++t) {
    const long long g = base + (long long)t * R;
    h = __fadd_rn(__fmul_rn(to_f(a[g]), h), to_f(b[g]));
    out[g] = h;
  }
}

template <typename T>
static cudaError_t launch_rglru(const void* a, const void* b, float* out, int B, int S, int R,
                                cudaStream_t stream) {
  dim3 grid((R + kScanThreads - 1) / kScanThreads, B);
  rglru_scan_kernel<T><<<grid, kScanThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), out, S, R);
  return cudaGetLastError();
}


}  // namespace first_design
}  // namespace famous
