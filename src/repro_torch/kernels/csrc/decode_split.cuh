// The split-key decode kernels ("flash-decoding") and their combine pass,
// shared by decode_attention.cu (contiguous caches, also speculative
// verify rows) and paged_decode_attention.cu (paged pools, fp and int8).
// The two differ only in where a key's K/V row lives, so the kernels are
// templates on a row source:
//   ContigRows<T>   a cache read in place by strides (decode_attention.cu);
//   PagedRows<E>    a shared (n_pages, page_size, KV, dh) pool addressed by
//                   the slot's page-table row; E = int8_t adds each row's
//                   f32 scale (paged_decode_attention.cu).
//
//   q      (R, H, dh)     contiguous; row r reads slot r / rps
//   lens   (R,) int32     valid keys of each row
//   out    (R, H, dh)
//
// What bounds it on an H100: memory.  Each live key costs 2 * KV * dh
// elements per layer (2 KB in bf16 for qwen2-7b, 16 KB for deepseek-7b's
// 32 kv heads, 1 KB plus 32 B of scales in int8), read once; the
// arithmetic is 4 * H * dh FLOP a key.  At 4 slots there are only rows * KV
// (row, kv head) pairs to spread over 132 SMs: 16 for qwen2-7b, 4 for
// recurrentgemma-2b's single kv head; a deepseek-7b step of 24 long rows
// has 768 and reads about 0.8 GB a layer.
//
// Two designs of the first pass; the grid is (range, kv head, row) in
// both: each block owns a range of L keys of one (row, kv head) and all
// `group` query heads that share the kv head, so each K/V byte is read
// once for all of them.  L comes from static shapes only (decode_plan,
// stream_plan), so the grid never depends on a length read on the
// host; a block whose range starts at or past lens[row] exits at once.
// decode_design picks the design from the static group and dh.
//
// The split design (decode_split_kernel; every PagedRows launch, and
// contiguous f32 or groups other than 1 and 6): L is the largest power of
// two up to 256 whose ranges give every SM a block at full length and
// whose K and V fit 64 KB of shared memory.  Inside a block:
//   0. (paged) the range's page ids go to shared memory, one page-table
//      read per page; each key's row is then pool_row of that copy (an id
//      outside [0, n_pages) reads the null page 0); int8 pools also stage
//      each key's K and V row scales;
//   1. the range's K rows, then its V rows, go to shared memory as two
//      groups of 16-byte cp.async copies (neighbouring threads on
//      neighbouring addresses; an int8 row is dh bytes), the whole range
//      in flight at once;
//   2. scores, while V is still arriving: a key's dh is split across a
//      group of lanes, 8 elements each (two keys per warp step at dh 128,
//      one at 256); each lane holds its 8 elements of every query head of
//      the group in registers for the whole range, forms its partial dot
//      for each head (an int8 element is first dequantized to f32, int8
//      times its row's scale), and the lanes sum them by warp shuffles
//      that halve the values a lane keeps at each step (15 shuffles for 16
//      heads); the sum is then scaled;
//   3. softmax over the range, one warp per query head: max, exp, sum;
//   4. P V with each of the 256 threads owning one head-dim column for
//      all heads, f32 accumulators in registers (V dequantized likewise).
// Three __syncthreads per block (four when paged).  At group 1 this leaves
// most of the block idle (one softmax warp of 8, half the threads past dh
// 128 in P V) and no bytes in flight while it computes: 28.7% of the byte
// bound at the deepseek-7b cell's decode step.
//
// The stream design (decode_stream_kernel; contiguous bf16 at dh 128 and
// groups 1 and 6, where scripts/torch_kernel_sweep.py timed it faster):
// ranges of up to 512 keys (stream_plan: the largest power of two
// whose grid at full rows fills two waves of resident blocks), never
// held whole.  The range is cut into tiles of TK = 8 keys, and warp w of
// the W = 4 owns tiles w, w + 4, ...: each warp streams its own tiles
// through its own ring of NS = 4 stages (16-byte cp.async copies, one
// commit group a tile), so three tiles are in flight while it computes on
// the fourth, and no block-wide barrier stalls it.  A warp computes on a
// tile as a whole: two keys a warp step at dh 128 (16 lanes of 8 elements
// a key, q in registers), 4 shuffles to sum a key's dot, an online softmax
// per query head (running max m and sum l; the accumulator rescaled by
// e^(m - m') when a tile raises the max), then P V with each lane owning 4
// head-dim columns, each key's p shuffled from the lane that scored it.
// So every lane works at group 1, and the group is a template parameter.
// At the range's end each warp writes its (m, l, acc) to its own region of
// shared memory and the block merges the four in warp order (one
// __syncthreads a block).  64 KB of shared memory a block: three resident
// blocks an SM, 36 tiles (144 KB) in flight.  At the deepseek-7b cell's
// shape the sweep timed 84-88% of the byte bound (1.07 ms -> 0.35 ms a
// layer); what bounds it there is the HBM, and at group 6 the lanes' per-
// head scoring (41% of the bound at the grok-1 cell's shape).
//
// Both designs write each block's partial (m, l, acc[group][dh]) in f32 to
// a workspace that the wrapper allocates (its size from the plan query),
// and a second kernel combines the live ranges of each (row, head) in a
// fixed order (bit-identical from launch to launch) and divides by
// max(l, 1e-30); a row of length 0 has no live range and gets exactly 0.
#pragma once

#include "common.cuh"

#include <algorithm>

namespace famous {

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecMaxGroup = 16;
constexpr int kDecMaxDh = 256;  // = kDecThreads: one P V column a thread
constexpr int kDecMinKeys = 16, kDecMaxKeys = 256;
constexpr int kDecKVBytes = 64 * 1024;  // K + V of one range in shared memory
constexpr int kCombineThreads = 128;

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// shared memory of a block: K and V ranges (L x dhp, raw), scores /
// probabilities (L x gp, f32), m and l (gp each); the row source's own
// (page ids, row scales) follow
inline size_t decode_smem_bytes(int group, int dh, int L, int esize) {
  const size_t dhp = round8(dh), gp = round4(group);
  return 2 * (size_t)L * dhp * esize + (L * gp + 2 * gp) * sizeof(float);
}

// f32 workspace of a launch: acc (R * H, S, dh), then m and l (R * H, S)
// each, S = ceil(Skv / L) ranges
inline long long decode_ws_elems(int R, int H, int dh, int Skv, int L) {
  return (long long)R * H * ((Skv + L - 1) / L) * (dh + 2);
}

// Keys per range L, from static shapes and the SM count only: the largest
// power of two in [16, 256] whose K and V ranges (esize-byte elements) fit
// 64 KB of shared memory, halved while R * KV * ceil(Skv / L) < sms (every
// SM a block when the rows are full) and while L / 2 still covers Skv.
// *ws_elems: the f32 workspace the launch needs.
inline int decode_plan(int R, int H, int KV, int dh, int Skv, int esize, int sms,
                       long long* ws_elems) {
  const long long dhp = round8(std::max(dh, 1));
  int L = kDecMaxKeys;
  while (L > kDecMinKeys && 2 * L * dhp * esize > kDecKVBytes) L >>= 1;
  const long long pairs = (long long)std::max(R, 1) * std::max(KV, 1);
  while (L > kDecMinKeys && pairs * ((Skv + L - 1) / L) < sms) L >>= 1;
  while (L > kDecMinKeys && L / 2 >= Skv) L >>= 1;
  *ws_elems = decode_ws_elems(R, H, dh, Skv, L);
  return L;
}

// the launch arguments both entry points check before anything runs;
// max_keys: L's cap of the launch's design
inline bool decode_args_ok(int R, int H, int KV, int dh, int rps, int L, const void* ws,
                           int max_keys = kDecMaxKeys) {
  return KV > 0 && H % KV == 0 && H / KV <= kDecMaxGroup && dh > 0 && dh <= kDecMaxDh &&
         rps > 0 && R % rps == 0 && L >= 1 && L <= max_keys && ws != nullptr;
}

template <typename E> __device__ __forceinline__ E zero_elem() {
  if constexpr (std::is_same<E, int8_t>::value)
    return 0;
  else
    return from_f<E>(0.f);
}

// ---------------------------------------------------------------------------
// row sources
// ---------------------------------------------------------------------------

// A contiguous cache (Rows, Skv, KV, dh) read in place by strides.
template <typename E>
struct ContigRows {
  using Elem = E;
  static constexpr bool kScaled = false;
  const E* k;
  const E* v;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;

  struct Range {
    const E* kb;
    const E* vb;
    long long k_ss, v_ss;
    __device__ const E* k_row(int j) const { return kb + j * k_ss; }
    __device__ const E* v_row(int j) const { return vb + j * v_ss; }
  };

  static size_t extra_bytes(int) { return 0; }

  __device__ Range range(int slot, int hk, int k_lo, int, float*, int) const {
    return {k + slot * k_sb + hk * k_sh + k_lo * k_ss, v + slot * v_sb + hk * v_sh + k_lo * v_ss,
            k_ss, v_ss};
  }
};

// A shared pool (n_pages, ps, KV, dh) read through the slot's row of a
// (slots, n_p) page table; int8 pools come with f32 (n_pages, ps, KV) row
// scales.
template <typename E>
struct PagedRows {
  using Elem = E;
  static constexpr bool kScaled = std::is_same<E, int8_t>::value;
  const E* k;
  const E* v;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  int ps, n_p, n_pages, KV, dh;

  struct Range {
    const E* k;
    const E* v;
    const int* page_s;  // the range's page ids, from page k_lo / ps on
    const float* ks_s;
    const float* vs_s;
    int rel, ps, KV, hk, n_pages, dh;
    __device__ long long row(int j) const {
      return pool_row(page_s, rel + j, ps, KV, hk, n_pages);
    }
    __device__ const E* k_row(int j) const { return k + row(j) * dh; }
    __device__ const E* v_row(int j) const { return v + row(j) * dh; }
    __device__ float k_scale(int j) const { return ks_s[j]; }
    __device__ float v_scale(int j) const { return vs_s[j]; }
  };

  // page ids (a range of L keys spans at most L + 1 pages), then the K and
  // V row scales of int8 pools
  static size_t extra_bytes(int L) {
    return (L + 1) * sizeof(int) + (kScaled ? 2 * (size_t)L * sizeof(float) : 0);
  }

  // Called by every thread of the block: stages the page ids (one read a
  // page) and the row scales in x_s, which extra_bytes(L) sized.  The
  // scales are read after the block's next __syncthreads.
  __device__ Range range(int slot, int hk, int k_lo, int nkeys, float* x_s, int L) const {
    int* page_s = reinterpret_cast<int*>(x_s);
    float* ks_s = x_s + L + 1;
    float* vs_s = ks_s + L;
    const int first = k_lo / ps, last = (k_lo + nkeys - 1) / ps;
    const int* pt = page_table + (long long)slot * n_p;
    for (int i = threadIdx.x; i <= last - first; i += blockDim.x) page_s[i] = pt[first + i];
    __syncthreads();
    const Range rg{k, v, page_s, ks_s, vs_s, k_lo - first * ps, ps, KV, hk, n_pages, dh};
    if constexpr (kScaled) {
      for (int j = threadIdx.x; j < nkeys; j += blockDim.x) {
        const long long rw = rg.row(j);
        ks_s[j] = k_scale[rw];
        vs_s[j] = v_scale[rw];
      }
    }
    return rg;
  }
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

// Copy n rows of dh elements (row j at row(j)) into shared rows of dhp
// elements.  vec: 16-byte aligned rows of whole 16-byte chunks (so dhp ==
// dh), by cp.async; otherwise element by element, the padding zero-filled.
template <typename E, typename RowPtr>
__device__ __forceinline__ void load_rows(E* dst, RowPtr row, int n, int dh, int dhp, bool vec) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(E);  // elements per 16-byte chunk
    const int cpr = dh / EPC;
    for (int i = threadIdx.x; i < n * cpr; i += kDecThreads) {
      const int j = i / cpr, c = (i % cpr) * EPC;
      cp_async16(dst + j * dhp + c, row(j) + c, 16);
    }
  } else {
    for (int i = threadIdx.x; i < n * dhp; i += kDecThreads) {
      const int j = i / dhp, d = i % dhp;
      dst[j * dhp + d] = d < dh ? row(j)[d] : zero_elem<E>();
    }
  }
}

// 8 consecutive shared-memory elements (aligned to their size x 8) in f32
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x, f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const char4 a = *reinterpret_cast<const char4*>(&u.x);
  const char4 b = *reinterpret_cast<const char4*>(&u.y);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// A lane's 8-element chunk of one query head, held in registers for the
// whole range: bf16 pairs as stored (exact; the scale is applied to the
// summed score) or f32.  load: n valid elements of p (the rest 0); vec: a
// 16-byte aligned full chunk.
template <typename T> struct QChunk;

template <> struct QChunk<float> {
  float x[8];
  __device__ __forceinline__ void load(const float* __restrict__ p, int n, bool vec) {
    if (vec) {
      load8(p, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = e < n ? p[e] : 0.f;
    }
  }
  __device__ __forceinline__ float dot(const float (&k)[8]) const {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(x[e], k[e], s);
    return s;
  }
};

template <> struct QChunk<__nv_bfloat16> {
  __nv_bfloat162 x[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p, int n, bool vec) {
    if (vec) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = h[i];
    } else {
      const __nv_bfloat16 z = __float2bfloat16(0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = __halves2bfloat162(2 * i < n ? p[2 * i] : z, 2 * i + 1 < n ? p[2 * i + 1] : z);
    }
  }
  __device__ __forceinline__ float dot(const float (&k)[8]) const {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(x[i]);
      s = fmaf(f.x, k[2 * i], s);
      s = fmaf(f.y, k[2 * i + 1], s);
    }
    return s;
  }
};

// Sum NV per-head partials over the lanes of a key group (xor offsets O,
// O/2, ..., 1) while halving the values each lane keeps: at offset O a
// lane with bit O set keeps the upper half and sends the lower.  16 values
// over 16 lanes take 15 shuffles (lane c ends with head c) where a
// butterfly per head would take 64.
template <int NV, int O>
__device__ __forceinline__ void reduce_heads(float (&v)[kDecMaxGroup], int lane) {
  if constexpr (O >= 1) {
    if constexpr (NV > 1) {
      constexpr int H = NV / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_heads<H, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_heads<1, O / 2>(v, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// the two passes
// ---------------------------------------------------------------------------

// Block (split, hk, r): keys [split * L, min((split + 1) * L, len)) of
// kv head hk of row r.  LPK lanes per key, 8 head-dim elements each
// (dhp <= 8 * LPK).  The partial goes to ws (layout: see the combine
// kernel).
template <typename T, typename Rows, int LPK>
__global__ void __launch_bounds__(kDecThreads)
decode_split_kernel(const T* __restrict__ q, const Rows src, const int* __restrict__ lens,
                    float* __restrict__ ws, int R, int H, int KV, int dh, int Skv, int rps,
                    int L, int S, float scale, int vec) {
  using E = typename Rows::Elem;
  constexpr int KPP = 32 / LPK;                              // keys per warp step
  constexpr int NVF = LPK >= 16 ? 1 : kDecMaxGroup / LPK;    // heads a lane ends with
  constexpr int SHARE = LPK == 32 ? 2 : 1;                   // lanes holding one head
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const int group = H / KV, dhp = round8(dh), gp = round4(group);
  const int split = blockIdx.x, hk = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q_base = ((long long)r * H + (long long)hk * group) * dh;

  const int len = max(0, min(lens[r], Skv));
  const int k_lo = split * L;
  if (k_lo >= len) return;  // no live key in this range
  const int nkeys = min(L, len - k_lo);

  E* k_s = reinterpret_cast<E*>(dec_smem);
  E* v_s = k_s + L * dhp;
  float* s_s = reinterpret_cast<float*>(v_s + L * dhp);  // [key][gp]
  float* m_s = s_s + L * gp;
  float* l_s = m_s + gp;
  float* x_s = l_s + gp;  // the row source's page ids and scales

  const typename Rows::Range rng = src.range(r / rps, hk, k_lo, nkeys, x_s, L);
  load_rows(k_s, [&](int j) { return rng.k_row(j); }, nkeys, dh, dhp, vec);
  cp_async_commit();
  load_rows(v_s, [&](int j) { return rng.v_row(j); }, nkeys, dh, dhp, vec);
  cp_async_commit();
  // scores: lane chunk c holds elements [8c, 8c + 8) of key j and of every
  // query head; the group's partial dots are summed across the key's lanes
  // by reduce_heads
  const int c = lane % LPK;
  const bool c_ok = 8 * c < dhp;
  QChunk<T> qc[kDecMaxGroup];
#pragma unroll
  for (int g = 0; g < kDecMaxGroup; ++g)
    if (g < group && c_ok) qc[g].load(q + q_base + (long long)g * dh + 8 * c, dh - 8 * c, vec);
  cp_async_wait<1>();  // K has landed (V may still be in flight)
  __syncthreads();

  for (int j0 = warp * KPP; j0 < nkeys; j0 += kDecWarps * KPP) {
    const int j = j0 + lane / LPK;
    const bool live = c_ok && j < nkeys;
    float kf[8];
    if (live) {
      load8(k_s + j * dhp + 8 * c, kf);
      if constexpr (Rows::kScaled) {
        const float sc = rng.k_scale(j);
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] *= sc;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = 0.f;
    }
    float part[kDecMaxGroup];
#pragma unroll
    for (int g = 0; g < kDecMaxGroup; ++g) part[g] = g < group && live ? qc[g].dot(kf) : 0.f;
    reduce_heads<kDecMaxGroup, LPK / 2>(part, lane);
    if (j < nkeys && c % SHARE == 0) {
#pragma unroll
      for (int i = 0; i < NVF; ++i) {
        const int g = (c / SHARE) * NVF + i;
        if (g < group) s_s[j * gp + g] = part[i] * scale;
      }
    }
  }
  __syncthreads();

  // softmax over the range's live keys (at least one): a warp per head
  for (int g = warp; g < group; g += kDecWarps) {
    float m = kNegInf;
    for (int j = lane; j < nkeys; j += 32) m = fmaxf(m, s_s[j * gp + g]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nkeys; j += 32) {
      const float p = expf(s_s[j * gp + g] - m);
      s_s[j * gp + g] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_s[g] = m;
      l_s[g] = l;
    }
  }
  cp_async_wait<0>();  // V has landed
  __syncthreads();

  const long long RH = (long long)R * H;
  const long long row0 = (long long)r * H + (long long)hk * group;  // (row, head 0)
  if (tid < group) {
    ws[RH * S * dh + (row0 + tid) * S + split] = m_s[tid];
    ws[RH * S * (dh + 1) + (row0 + tid) * S + split] = l_s[tid];
  }

  // P V: thread tid owns head-dim column tid for every head
  const int d = tid;
  if (d >= dh) return;
  float acc[kDecMaxGroup];
#pragma unroll
  for (int g = 0; g < kDecMaxGroup; ++g) acc[g] = 0.f;
#pragma unroll 4
  for (int j = 0; j < nkeys; ++j) {
    float vv = to_f(v_s[j * dhp + d]);
    if constexpr (Rows::kScaled) vv *= rng.v_scale(j);
    const float* pr = s_s + j * gp;
#pragma unroll
    for (int g4 = 0; g4 < kDecMaxGroup; g4 += 4) {
      if (g4 < group) {
        const float4 p = *reinterpret_cast<const float4*>(pr + g4);
        acc[g4] = fmaf(p.x, vv, acc[g4]);
        acc[g4 + 1] = fmaf(p.y, vv, acc[g4 + 1]);
        acc[g4 + 2] = fmaf(p.z, vv, acc[g4 + 2]);
        acc[g4 + 3] = fmaf(p.w, vv, acc[g4 + 3]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kDecMaxGroup; ++g) {
    if (g >= group) break;
    ws[((row0 + g) * S + split) * dh + d] = acc[g];
  }
}

// The second pass: for (row r, head h) = block (h, r), combine the live
// ranges s < ceil(len / L) in order s = 0, 1, ...:  M = max m_s, w_s =
// exp(m_s - M), out = sum w_s acc_s / max(sum w_s l_s, 1e-30).  The
// weights are computed once into shared memory; each sum runs in order
// s = 0, 1, ... in one thread (deterministic).  Workspace: acc (R*H, S,
// dh), then m (R*H, S), then l (R*H, S), f32.  Rows only names the
// instantiation, so a profile tells the contiguous and paged passes apart.
template <typename T, typename Rows>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ ws, const int* __restrict__ lens,
                      T* __restrict__ out, int R, int H, int dh, int Skv, int L, int S) {
  extern __shared__ float w_s[];  // S weights, then S l values
  __shared__ float red[kCombineThreads / 32];
  const int h = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const long long RH = (long long)R * H, row = (long long)r * H + h;
  const int len = max(0, min(lens[r], Skv));
  const int n = min(S, (len + L - 1) / L);
  const float* acc = ws + row * S * dh;
  const float* ms = ws + RH * S * dh + row * S;
  const float* ls = ws + RH * S * (dh + 1) + row * S;
  float* l_s = w_s + S;
  float M = kNegInf;
  for (int s = tid; s < n; s += kCombineThreads) M = fmaxf(M, ms[s]);
  M = warp_max(M);
  if ((tid & 31) == 0) red[tid >> 5] = M;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCombineThreads / 32; ++i) M = fmaxf(M, red[i]);
  for (int s = tid; s < n; s += kCombineThreads) {
    w_s[s] = expf(ms[s] - M);
    l_s[s] = ls[s];
  }
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < n; ++s) l += w_s[s] * l_s[s];
  for (int d = tid; d < dh; d += kCombineThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n; ++s) a += w_s[s] * acc[(long long)s * dh + d];
    out[row * dh + d] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, typename Rows, int LPK>
static cudaError_t launch_split(dim3 grid, size_t smem, cudaStream_t stream, const T* q,
                                const Rows& src, const int* lens, float* ws, int R, int H,
                                int KV, int dh, int Skv, int rps, int L, int S, float scale,
                                int vec) {
  auto kernel = decode_split_kernel<T, Rows, LPK>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  // each (row, head, range): dh accumulators, then m and l
  record_launch(kernel, "decode_split_kernel", grid, kDecThreads, smem, {Skv, L}, {KV, 1}, {R, 1},
                (long long)grid.z * grid.y * (H / KV) * grid.x * (dh + 2));
  kernel<<<grid, kDecThreads, smem, stream>>>(q, src, lens, ws, R, H, KV, dh, Skv, rps, L, S,
                                              scale, vec);
  return cudaGetLastError();
}

// The second pass of both designs: the S ranges' partials of each (row,
// head) combined into out.
template <typename T, typename Rows>
static cudaError_t launch_combine(const float* ws, const int* lens, T* out, int R, int H, int dh,
                                  int Skv, int L, int S, cudaStream_t stream) {
  const size_t csmem = 2 * (size_t)S * sizeof(float);
  auto combine = decode_combine_kernel<T, Rows>;
  cudaError_t e = allow_smem(combine, csmem);
  if (e != cudaSuccess) return e;
  record_launch(combine, "decode_combine_kernel", dim3(H, R), kCombineThreads, csmem, {H, 1},
                {R, 1});
  combine<<<dim3(H, R), kCombineThreads, csmem, stream>>>(ws, lens, out, R, H, dh, Skv, L, S);
  return cudaGetLastError();
}

// Both passes on `stream`.  vec: q 16-byte aligned with dh % 8 == 0, and
// every K/V row a whole number of 16-byte aligned chunks.
template <typename T, typename Rows>
static cudaError_t launch_decode_split(const T* q, const Rows& src, const int* lens, T* out,
                                       float* ws, int R, int H, int KV, int dh, int Skv,
                                       int rps, int L, float scale, int vec,
                                       cudaStream_t stream) {
  using E = typename Rows::Elem;
  const int S = (Skv + L - 1) / L;
  const size_t smem = decode_smem_bytes(H / KV, dh, L, sizeof(E)) + Rows::extra_bytes(L);
  const dim3 grid(S, KV, R);
  const int dhp = round8(dh);
  cudaError_t e;
  // lanes per key: 8 head-dim elements a lane
  if (dhp <= 64)
    e = launch_split<T, Rows, 8>(grid, smem, stream, q, src, lens, ws, R, H, KV, dh, Skv, rps, L,
                                 S, scale, vec);
  else if (dhp <= 128)
    e = launch_split<T, Rows, 16>(grid, smem, stream, q, src, lens, ws, R, H, KV, dh, Skv, rps,
                                  L, S, scale, vec);
  else
    e = launch_split<T, Rows, 32>(grid, smem, stream, q, src, lens, ws, R, H, KV, dh, Skv, rps,
                                  L, S, scale, vec);
  if (e != cudaSuccess) return e;
  return launch_combine<T, Rows>(ws, lens, out, R, H, dh, Skv, L, S, stream);
}

// ---------------------------------------------------------------------------
// the stream design (contiguous caches at the groups decode_design names)
// ---------------------------------------------------------------------------

// The geometry of a stream block: W warps, TK keys a warp's tile, NS
// stages in each warp's ring.
template <int W_, int TK_, int NS_>
struct StreamTiles {
  static constexpr int W = W_, TK = TK_, NS = NS_;
};
// The kernel's own geometry.  scripts/torch_kernel_sweep.py's decode part
// timed seven at the deepseek-7b cell's shape (24 rows of 32 heads over
// 1024-4096 keys): at their best L all within 3% of the best (8 x 8 x 3,
// 1% ahead of this one) but 16-key tiles (5% slower) and six stages
// (24%); this one was also timed at groups 6, 7 and 10.
using StreamServe = StreamTiles<4, 8, 4>;
// L at most: longer ranges were slower at every swept shape (fewer
// blocks to balance ragged rows), and the partials at 512 are ~0.4% of the
// K/V bytes at the cell's shape
constexpr int kStreamMaxKeys = 512;
constexpr int kSmemPerSm = 228 * 1024, kSmThreads = 2048;
// waves of resident blocks the grid holds at full rows, at least
constexpr int kStreamWaves = 2;

// The designs of the contiguous decode kernel (kernels/decode/decode_attn.py
// DESIGNS): kDecSplit, decode_split_kernel, ranges of at most 256 keys held
// whole in shared memory; kDecStream, decode_stream_kernel, each warp
// streaming its tiles of a longer range through a ring.
enum DecodeDesign { kDecSplit = 0, kDecStream = 1 };

// The design of a launch, from static shapes only: the stream design where
// it is built (bf16, dh 128) at the groups the sweep timed it faster than
// the split design at the split design's own L (group 1, deepseek-7b's;
// group 6, grok-1's and its TP ranks'), the split design elsewhere (group
// 7 timed no faster on the stream design: 0.0139 against 0.0141 ms at the
// table shape, 0.0167 against 0.0163 at a qwen2-7b step; group 10 at dh
// 256 1.4x slower).
inline int decode_design(int esize, int H, int KV, int dh) {
  const bool grouped = KV > 0 && H % KV == 0 && (H / KV == 1 || H / KV == 6);
  return esize == 2 && dh == 128 && grouped ? kDecStream : kDecSplit;
}

// bytes of one warp's region of shared memory: its ring (NS stages of a K
// tile and a V tile) or, once its tiles are done, its partial (acc[G][DH],
// then m[G] and l[G], f32), whichever is larger
template <typename T, int G, int DH, typename Tiles>
__host__ __device__ constexpr int stream_warp_bytes() {
  constexpr int ring = Tiles::NS * 2 * Tiles::TK * DH * (int)sizeof(T);
  constexpr int part = G * (DH + 2) * (int)sizeof(float);
  return ((ring > part ? ring : part) + 15) / 16 * 16;  // 16-byte aligned rings
}

// Keys per range L of the stream design, from static shapes and the SM
// count only: the largest power of two in [W * TK, kStreamMaxKeys] whose
// grid at full rows, R * KV * ceil(Skv / L) blocks, fills kStreamWaves
// waves of the blocks the SMs hold at once, halved while L / 2 still
// covers Skv.  *ws_elems: the f32 workspace (decode_ws_elems, as the split
// design's).
template <typename T, int G, int DH, typename Tiles = StreamServe>
inline int stream_plan(int R, int H, int KV, int Skv, int sms, long long* ws_elems) {
  const int block_bytes = Tiles::W * stream_warp_bytes<T, G, DH, Tiles>();
  const int resident =
      std::max(1, std::min(kSmemPerSm / (block_bytes + 1024), kSmThreads / (Tiles::W * 32)));
  const long long want = (long long)kStreamWaves * resident * std::max(sms, 1);
  const long long pairs = (long long)std::max(R, 1) * std::max(KV, 1);
  int L = kStreamMaxKeys;
  while (L > Tiles::W * Tiles::TK && pairs * ((Skv + L - 1) / L) < want) L >>= 1;
  while (L > Tiles::W * Tiles::TK && L / 2 >= Skv) L >>= 1;
  *ws_elems = decode_ws_elems(R, H, DH, Skv, L);
  return L;
}

// One 16-byte chunk global -> shared: by cp.async where vec, else element
// by element (visible to the warp after its next __syncwarp).
template <typename E>
__device__ __forceinline__ void copy_chunk(E* dst, const E* src, int vec) {
  if (vec) {
    cp_async16(dst, src, 16);
  } else {
#pragma unroll
    for (int e = 0; e < 16 / (int)sizeof(E); ++e) dst[e] = src[e];
  }
}

// N = 4 or 8 consecutive bf16 of shared memory (aligned to 2N bytes) in f32
template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float (&f)[N]) {
  if constexpr (N == 8) {
    load8(p, f);
  } else {
    static_assert(N == 4, "4 or 8 elements");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
  }
}

// Block (split, hk, r): keys [split * L, min((split + 1) * L, len)) of kv
// head hk of row r, its G query heads, dh = DH.  The range is cut into
// tiles of TK keys; warp w owns tiles w, w + W, w + 2W, ..., streamed
// through its own ring of NS stages, and keeps its own (m, l, acc) per
// head in registers (an online softmax over its tiles).  At the range's
// end the W partials are merged in warp order into the block's partial,
// which goes to ws in the split design's layout.
template <typename T, typename Rows, int G, int DH, typename Tiles>
__global__ void __launch_bounds__(Tiles::W * 32)
decode_stream_kernel(const T* __restrict__ q, const Rows src, const int* __restrict__ lens,
                     float* __restrict__ ws, int R, int H, int Skv, int rps, int L, int S,
                     float scale, int vec) {
  static_assert(sizeof(T) == 2, "16-bit elements, 8 a chunk");
  constexpr int W = Tiles::W, TK = Tiles::TK, NS = Tiles::NS;
  constexpr int CH = DH / 8;          // 16-byte chunks of a row
  constexpr int KPI = 32 / CH;        // keys a warp covers at once
  constexpr int NI = TK / KPI;        // keys a lane scores in a tile
  constexpr int DPL = DH / 32;        // head-dim columns a lane accumulates
  constexpr int STAGE = 2 * TK * DH;  // elements of a stage: K tile, V tile
  constexpr int REGION = stream_warp_bytes<T, G, DH, Tiles>() / (int)sizeof(T);
  static_assert(CH * KPI == 32 && TK % KPI == 0 && DPL * 32 == DH && NS >= 2, "geometry");
  extern __shared__ __align__(16) unsigned char dec_smem[];
  const int split = blockIdx.x, hk = blockIdx.y, r = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int len = max(0, min(lens[r], Skv));
  const int k_lo = split * L;
  if (k_lo >= len) return;  // no live key in this range
  const int nkeys = min(L, len - k_lo);
  const int ntiles = (nkeys + TK - 1) / TK;
  const int nt = warp < ntiles ? (ntiles - warp + W - 1) / W : 0;  // this warp's tiles
  T* ring = reinterpret_cast<T*>(dec_smem) + warp * REGION;
  const typename Rows::Range rng = src.range(r / rps, hk, k_lo, nkeys, nullptr, L);
  // lane (kq, c): chunk c of keys kq, kq + KPI, ... of a tile, to copy and
  // to score
  const int c = lane % CH, kq = lane / CH;

  // the warp's n-th tile into stage n % NS
  auto issue = [&](int n) {
    const int t0 = (warp + n * W) * TK, valid = min(TK, nkeys - t0);
    T* st = ring + (n % NS) * STAGE;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int j = i * KPI + kq;
      if (j < valid) {
        copy_chunk(st + j * DH + 8 * c, rng.k_row(t0 + j) + 8 * c, vec);
        copy_chunk(st + (TK + j) * DH + 8 * c, rng.v_row(t0 + j) + 8 * c, vec);
      }
    }
  };
#pragma unroll
  for (int n = 0; n < NS - 1; ++n) {
    if (n < nt) issue(n);
    cp_async_commit();
  }
  const long long q_base = ((long long)r * H + (long long)hk * G) * DH;
  QChunk<T> qc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) qc[g].load(q + q_base + g * DH + 8 * c, 8, vec);
  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf, l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  }

  for (int n = 0; n < nt; ++n) {
    cp_async_wait<NS - 2>();  // tile n has landed
    __syncwarp();             // ... for every lane, and stage (n - 1) % NS is free
    if (n + NS - 1 < nt) issue(n + NS - 1);
    cp_async_commit();
    const T* kt = ring + (n % NS) * STAGE;
    const T* vt = kt + TK * DH;
    const int valid = min(TK, nkeys - (warp + n * W) * TK);
    // scores: each lane's partial dots, summed over the CH lanes of a key
    float s[G][NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float kf[8];
      load8(kt + (i * KPI + kq) * DH + 8 * c, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) s[g][i] = qc[g].dot(kf);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = kNegInf;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
#pragma unroll
        for (int o = CH / 2; o > 0; o >>= 1) s[g][i] += __shfl_xor_sync(0xffffffffu, s[g][i], o);
        s[g][i] = i * KPI + kq < valid ? s[g][i] * scale : kNegInf;
        mt = fmaxf(mt, s[g][i]);
      }
#pragma unroll
      for (int o = 16; o >= CH; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      // the online softmax: rescale what the earlier tiles gave
      const float mn = fmaxf(m[g], mt);
      const float alpha = expf(m[g] - mn);
      float ts = 0.f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        s[g][i] = i * KPI + kq < valid ? expf(s[g][i] - mn) : 0.f;
        ts += s[g][i];
      }
#pragma unroll
      for (int o = 16; o >= CH; o >>= 1) ts += __shfl_xor_sync(0xffffffffu, ts, o);
      l[g] = l[g] * alpha + ts;
      m[g] = mn;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[g][d] *= alpha;
    }
    // P V: lane owns columns [lane * DPL, lane * DPL + DPL); key j's p
    // from the lane that scored it
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      if (j < valid) {
        float vf[DPL];
        load_bf16<DPL>(vt + j * DH + lane * DPL, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = __shfl_sync(0xffffffffu, s[g][j / KPI], (j % KPI) * CH);
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[g][d] = fmaf(p, vf[d], acc[g][d]);
        }
      }
    }
  }

  // the warp's partial into its own region, then the W partials merged in
  // warp order: M = max m_w, acc = sum e^(m_w - M) acc_w, l likewise (a
  // warp with no tile has m_w = kNegInf and weight 0)
  cp_async_wait<0>();
  __syncwarp();
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int d = 0; d < DPL; ++d) part[g * DH + lane * DPL + d] = acc[g][d];
    if (lane == 0) {
      part[G * DH + g] = m[g];
      part[G * DH + G + g] = l[g];
    }
  }
  __syncthreads();
  const long long RH = (long long)R * H;
  const long long row0 = (long long)r * H + (long long)hk * G;  // (row, head 0)
  for (int e = threadIdx.x; e < G * DH; e += W * 32) {
    const int g = e / DH, d = e % DH;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w)
      M = fmaxf(M, reinterpret_cast<const float*>(reinterpret_cast<const T*>(dec_smem) +
                                                  w * REGION)[G * DH + g]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float* pw = reinterpret_cast<const float*>(reinterpret_cast<const T*>(dec_smem) +
                                                       w * REGION);
      const float wt = expf(pw[G * DH + g] - M);
      a += wt * pw[e];
      lsum += wt * pw[G * DH + G + g];
    }
    ws[((row0 + g) * S + split) * DH + d] = a;
    if (d == 0) {
      ws[RH * S * DH + (row0 + g) * S + split] = M;
      ws[RH * S * (DH + 1) + (row0 + g) * S + split] = lsum;
    }
  }
}

template <typename T, typename Rows, int G, int DH, typename Tiles>
static cudaError_t launch_stream(dim3 grid, cudaStream_t stream, const T* q, const Rows& src,
                                 const int* lens, float* ws, int R, int H, int Skv, int rps,
                                 int L, int S, float scale, int vec) {
  auto kernel = decode_stream_kernel<T, Rows, G, DH, Tiles>;
  const size_t smem = (size_t)Tiles::W * stream_warp_bytes<T, G, DH, Tiles>();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  // each (row, head, range): DH accumulators, then m and l
  record_launch(kernel, "decode_stream_kernel", grid, Tiles::W * 32, smem, {Skv, L}, {H / G, 1},
                {R, 1}, (long long)grid.z * grid.y * G * grid.x * (DH + 2));
  kernel<<<grid, Tiles::W * 32, smem, stream>>>(q, src, lens, ws, R, H, Skv, rps, L, S, scale,
                                                vec);
  return cudaGetLastError();
}

// Both passes of the stream design on `stream` (dh = DH, H = KV * G); vec
// as launch_decode_split's.
template <typename T, typename Rows, int G, int DH, typename Tiles = StreamServe>
static cudaError_t launch_decode_stream(const T* q, const Rows& src, const int* lens, T* out,
                                        float* ws, int R, int H, int KV, int Skv, int rps, int L,
                                        float scale, int vec, cudaStream_t stream) {
  const int S = (Skv + L - 1) / L;
  cudaError_t e = launch_stream<T, Rows, G, DH, Tiles>(dim3(S, KV, R), stream, q, src, lens, ws,
                                                       R, H, Skv, rps, L, S, scale, vec);
  if (e != cudaSuccess) return e;
  return launch_combine<T, Rows>(ws, lens, out, R, H, DH, Skv, L, S, stream);
}

}  // namespace famous
