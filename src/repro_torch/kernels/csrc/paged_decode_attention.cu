// paged_decode_attention(_int8): one new query token per row against its
// slot's pages of a shared K/V pool, GQA, f32 softmax.
//
//   q           (R, H, dh)              contiguous (the decode step's (B, 1, H, dh))
//   k, v        (n_pages, ps, KV, dh)   contiguous pools; f32/bf16, or int8
//   k_scale,    (n_pages, ps, KV) f32   int8 pools only: one scale per row
//   v_scale
//   page_table  (R / rps, n_p) int32    slot b's key pos lives in page
//                                       page_table[b, pos / ps], row pos % ps
//   lens        (R,) int32              valid keys of each row
//   out         (R, H, dh)
//
// Row r reads slot r / rps.  Decode has one row per slot (rps = 1);
// speculative verify flattens (slot, verify position j) into row
// slot * W + j with rps = W, so the W rows of a slot read its page-table
// row in place.
//
// Replaces: src/repro/kernels/decode/decode_attn.py, paged_decode_attention
// (Pallas _paged_decode_kernel) and paged_decode_attention_int8
// (_paged_decode_kernel_int8).  There the page table and lengths are
// scalar-prefetched and each grid step DMAs one page of one kv head with
// an f32 online softmax (running max and sum, -1e30 masks, a final divide
// by max(l, 1e-30), so a slot with len 0 gets 0); the grid walks all n_p
// pages of every slot whatever its length.
//
// What bounds it on an H100: memory.  Each live token costs 2 * KV * dh
// elements per layer (2 KB in bf16 for qwen2-7b; 1 KB plus 32 B of scales
// in int8) read once, against 4 * H * dh FLOP.
//
// Design: the split-key kernel and combine pass of decode_split.cuh (its
// header says how a block works), shared with decode_attention.cu, on
// PagedRows: a block resolves its range's page ids once into shared
// memory, then copies each key's pool row (dh elements; dh bytes for int8)
// by 16-byte cp.async, a page of 16 tokens being 16 rows of one kv head.
// Keys past lens[row] are never read, so the null page 0 that free slots
// point at never adds to an output.  The fp and int8 kernels are two
// instantiations that differ only in the pool's element type: int8 rows
// bring their f32 scales to shared memory, and each element is dequantized
// to f32 (int8 times its row's scale) before any product, as at
// decode_attn.py:128-129.
#include "decode_split.cuh"

namespace famous {

template <typename T, typename E>
static cudaError_t launch_paged_decode(const void* q, const void* k, const void* v,
                                       const float* k_scale, const float* v_scale,
                                       const int* page_table, const int* lens, void* out,
                                       float* ws, int R, int H, int KV, int dh, int ps, int n_p,
                                       int n_pages, int rps, int L, float scale,
                                       cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(E);  // pool elements per 16-byte chunk
  const int vec = dh % 8 == 0 && dh % EPC == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const PagedRows<E> src{static_cast<const E*>(k), static_cast<const E*>(v), k_scale, v_scale,
                         page_table, ps, n_p, n_pages, KV, dh};
  return launch_decode_split(static_cast<const T*>(q), src, lens, static_cast<T*>(out), ws, R, H,
                             KV, dh, n_p * ps, rps, L, scale, vec, stream);
}

static int paged_decode_check(int R, int H, int KV, int dh, int ps, int n_p, int n_pages,
                              int rps, int L, const void* ws) {
  if (!decode_args_ok(R, H, KV, dh, rps, L, ws) || ps <= 0 || n_p <= 0 || n_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace famous

// Keys per range L and the f32 workspace elements (*ws_elems) of a launch
// over R rows of pools with n_p * page_size keys a slot and esize-byte
// elements (4 f32, 2 bf16, 1 int8), from static shapes and the SM count
// only (decode_plan in decode_split.cuh); the wrapper allocates the
// workspace.
extern "C" int famous_paged_decode_attention_plan(int R, int H, int KV, int dh, int Skv,
                                                  int esize, int sms, long long* ws_elems) {
  return famous::decode_plan(R, H, KV, dh, Skv, esize, sms, ws_elems);
}

// ws: f32 workspace of the plan's size; L: the plan's keys per range.
extern "C" int famous_paged_decode_attention(int dtype, const void* q, const void* k,
                                             const void* v, const void* page_table,
                                             const void* lens, void* out, void* ws, int R, int H,
                                             int KV, int dh, int ps, int n_p, int n_pages,
                                             int rps, int L, float scale, void* stream) {
  using namespace famous;
  if (int bad = paged_decode_check(R, H, KV, dh, ps, n_p, n_pages, rps, L, ws)) return bad;
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* l = static_cast<const int*>(lens);
  float* w = static_cast<float*>(ws);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_paged_decode<float, float>(q, k, v, nullptr, nullptr, pt, l, out, w, R, H, KV, dh,
                                          ps, n_p, n_pages, rps, L, scale, s);
  else if (dtype == kBF16)
    e = launch_paged_decode<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, pt, l, out,
                                                          w, R, H, KV, dh, ps, n_p, n_pages, rps,
                                                          L, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" int famous_paged_decode_attention_int8(int dtype, const void* q, const void* k,
                                                  const void* v, const void* k_scale,
                                                  const void* v_scale, const void* page_table,
                                                  const void* lens, void* out, void* ws, int R,
                                                  int H, int KV, int dh, int ps, int n_p,
                                                  int n_pages, int rps, int L, float scale,
                                                  void* stream) {
  using namespace famous;
  if (int bad = paged_decode_check(R, H, KV, dh, ps, n_p, n_pages, rps, L, ws)) return bad;
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* pt = static_cast<const int*>(page_table);
  const int* l = static_cast<const int*>(lens);
  float* w = static_cast<float*>(ws);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_paged_decode<float, int8_t>(q, k, v, ks, vs, pt, l, out, w, R, H, KV, dh, ps, n_p,
                                           n_pages, rps, L, scale, s);
  else if (dtype == kBF16)
    e = launch_paged_decode<__nv_bfloat16, int8_t>(q, k, v, ks, vs, pt, l, out, w, R, H, KV, dh,
                                                   ps, n_p, n_pages, rps, L, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
