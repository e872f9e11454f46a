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
// elements per layer (2 KB in bf16 for qwen2-7b, 16 KB for deepseek-7b),
// read once; the arithmetic is 4 * H * dh FLOP a key.  At 4 slots there
// are only rows * KV (row, kv head) pairs to spread over 132 SMs: 16 for
// qwen2-7b, 4 for recurrentgemma-2b's single kv head.
//
// Design: flash-decoding on ContigRows (each range's K/V rows are the
// cache's rows read in place by strides), in one of the two designs of
// decode_split.cuh (its header says how each block works), picked from
// static shapes by decode_design: the stream design (each warp streaming
// its key tiles through a cp.async ring, an online softmax a warp) for
// bf16 at dh 128 and one or six query heads a kv head (deepseek-7b,
// grok-1), the split design (a range held whole in shared memory)
// elsewhere; then the combine pass.
#include "decode_split.cuh"

// The design of a launch (famous::DecodeDesign) from static shapes only.
extern "C" int famous_decode_attention_design(int dtype, int H, int KV, int dh) {
  using namespace famous;
  return decode_design(dtype == kF32 ? 4 : 2, H, KV, dh);
}

// Keys per range L and the f32 workspace elements (*ws_elems) of a launch,
// from static shapes and the SM count only (decode_plan or stream_plan in
// decode_split.cuh, by the launch's design); the wrapper allocates the
// workspace.
extern "C" int famous_decode_attention_plan(int dtype, int R, int H, int KV, int dh, int Skv,
                                            int sms, long long* ws_elems) {
  using namespace famous;
  const int esize = dtype == kF32 ? 4 : 2;
  if (decode_design(esize, H, KV, dh) == kDecStream) switch (H / KV) {
      case 1: return stream_plan<__nv_bfloat16, 1, 128>(R, H, KV, Skv, sms, ws_elems);
      case 6: return stream_plan<__nv_bfloat16, 6, 128>(R, H, KV, Skv, sms, ws_elems);
    }
  return decode_plan(R, H, KV, dh, Skv, esize, sms, ws_elems);
}

namespace famous {

// Whether q and every K/V row read in place by these strides are whole
// 16-byte aligned chunks, for cp.async.
template <typename T>
static int contig_vec(const void* q, const void* k, const void* v, int dh, long long k_sb,
                      long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                      long long v_sh) {
  constexpr long long EPC = 16 / sizeof(T);
  return dh % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
         k_sb % EPC == 0 && k_ss % EPC == 0 && k_sh % EPC == 0 && v_sb % EPC == 0 &&
         v_ss % EPC == 0 && v_sh % EPC == 0;
}

template <typename T>
static cudaError_t launch_contig(const void* q, const void* k, const void* v, const int* lens,
                                 void* out, float* ws, int R, int H, int KV, int dh, int Skv,
                                 int rps, int L, long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh, float scale,
                                 cudaStream_t stream) {
  const int vec = contig_vec<T>(q, k, v, dh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh);
  const ContigRows<T> src{static_cast<const T*>(k), static_cast<const T*>(v), k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh};
  const T* qt = static_cast<const T*>(q);
  T* o = static_cast<T*>(out);
  if constexpr (sizeof(T) == 2) {
    // decode_design's stream shapes: groups 1 and 6 at dh 128
    if (decode_design(sizeof(T), H, KV, dh) == kDecStream) switch (H / KV) {
        case 1:
          return launch_decode_stream<T, ContigRows<T>, 1, 128>(qt, src, lens, o, ws, R, H, KV,
                                                                Skv, rps, L, scale, vec, stream);
        case 6:
          return launch_decode_stream<T, ContigRows<T>, 6, 128>(qt, src, lens, o, ws, R, H, KV,
                                                                Skv, rps, L, scale, vec, stream);
        default:
          return cudaErrorInvalidValue;
      }
  }
  return launch_decode_split(qt, src, lens, o, ws, R, H, KV, dh, Skv, rps, L, scale, vec, stream);
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
  const bool streamed = decode_design(dtype == kF32 ? 4 : 2, H, KV, dh) == kDecStream;
  if (!decode_args_ok(R, H, KV, dh, rps, L, ws, streamed ? kStreamMaxKeys : kDecMaxKeys))
    return static_cast<int>(cudaErrorInvalidValue);
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
