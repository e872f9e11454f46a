// decode_attention: one new query token per row against its slot's
// contiguous KV cache, GQA, f32 softmax.
//
//   q      (R, H, dh)            contiguous (the decode step's (B, 1, H, dh))
//   k, v   (R / rps, Skv, KV, dh) read by strides, dh contiguous
//   lens   (R,) int32            valid entries of each row, on the device
//   out    (R, H, dh)
//
// Row r reads slot r / rps of the caches.  Decode has one row per slot
// (rps = 1); speculative verify flattens (slot, verify position j) into
// row slot * W + j with rps = W and length cache_len + j + 1, so the W
// rows of a slot share its cache in place, where the JAX wrapper
// broadcasts the cache W ways.
//
// Replaces: src/repro/kernels/decode/decode_attn.py, decode_attention (the
// Pallas kernel _decode_kernel).  There one grid row per (slot, kv head)
// walks every key tile of Skv in sequence with an f32 online softmax
// (running max and sum, masked scores at -1e30, a final divide by
// max(l, 1e-30), which gives an empty slot an output of 0).
//
// What bounds it on an H100: memory.  Each live key costs 2 * KV * dh
// elements per layer (2 KB in bf16 for qwen2-7b), read once; the
// arithmetic is 4 * H * dh FLOP a key.  At 4 slots there are only
// rows * KV (row, kv head) pairs to spread over 132 SMs: 16 for qwen2-7b,
// 4 for recurrentgemma-2b's single kv head.
//
// Design: flash-decoding, the split-key kernel and combine pass of
// decode_split.cuh (its header says how a block works) on ContigRows: each
// range's K/V rows are the cache's rows read in place by strides.
#include "decode_split.cuh"

// Keys per range L and the f32 workspace elements (*ws_elems) of a launch,
// from static shapes and the SM count only (decode_plan in
// decode_split.cuh); the wrapper allocates the workspace.
extern "C" int famous_decode_attention_plan(int dtype, int R, int H, int KV, int dh, int Skv,
                                            int sms, long long* ws_elems) {
  using namespace famous;
  return decode_plan(R, H, KV, dh, Skv, dtype == kF32 ? 4 : 2, sms, ws_elems);
}

namespace famous {

template <typename T>
static cudaError_t launch_contig(const void* q, const void* k, const void* v, const int* lens,
                                 void* out, float* ws, int R, int H, int KV, int dh, int Skv,
                                 int rps, int L, long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh, float scale,
                                 cudaStream_t stream) {
  constexpr long long EPC = 16 / sizeof(T);
  const int vec = dh % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0 && k_sb % EPC == 0 &&
                  k_ss % EPC == 0 && k_sh % EPC == 0 && v_sb % EPC == 0 && v_ss % EPC == 0 &&
                  v_sh % EPC == 0;
  const ContigRows<T> src{static_cast<const T*>(k), static_cast<const T*>(v), k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh};
  return launch_decode_split(static_cast<const T*>(q), src, lens, static_cast<T*>(out), ws, R, H,
                             KV, dh, Skv, rps, L, scale, vec, stream);
}

}  // namespace famous

// ws: f32 workspace of the plan's size.
extern "C" int famous_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                       const void* lens, void* out, void* ws, int R, int H,
                                       int KV, int dh, int Skv, int rps, int L, long long k_sb,
                                       long long k_ss, long long k_sh, long long v_sb,
                                       long long v_ss, long long v_sh, float scale,
                                       void* stream) {
  using namespace famous;
  if (!decode_args_ok(R, H, KV, dh, rps, L, ws)) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  if (Skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  float* w = static_cast<float*>(ws);
  cudaError_t e;
  if (dtype == kF32)
    e = launch_contig<float>(q, k, v, l, out, w, R, H, KV, dh, Skv, rps, L, k_sb, k_ss, k_sh,
                             v_sb, v_ss, v_sh, scale, s);
  else if (dtype == kBF16)
    e = launch_contig<__nv_bfloat16>(q, k, v, l, out, w, R, H, KV, dh, Skv, rps, L, k_sb, k_ss,
                                     k_sh, v_sb, v_ss, v_sh, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
