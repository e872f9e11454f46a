"""Design sweeps of the port's redesigned kernels, on one H100.

    python3 scripts/torch_kernel_sweep.py [--iters N] [--parts LIST]

Backs the fixed choices in ``kernels/csrc/matmul_tiled.cu``,
``kernels/csrc/decode_split.cuh`` (``decode_attention`` and
``paged_decode_attention``) and ``kernels/csrc/chunk_tc.cuh``
(``chunk_prefill`` and the paged chunk kernels) with times taken on the
card:

- ``matmul_tiled`` bf16 above T = 32: eight output-tile shapes (BM x BN x
  BK, warps, ring stages) at the serving-chunk and training shapes;
- ``matmul_tiled`` bf16 at T <= 32: the split-K count at decode (T = 4)
  and verify (T = 20), against the count the kernel's plan picks;
- ``decode_attention``: the split design's keys per block range L and
  the stream design's geometries (warps, keys a tile, ring stages) times
  its L, against the design and L the kernel's plan picks and SDPA, each
  with its share of the byte bound, at the chip_smoke table shape, a
  qwen2-7b decode step, recurrentgemma-2b's heads, deepseek-7b's (group 1)
  and grok-1's (group 6) layouts, and the decode steps of the two
  benchmark cells (deepseek-7b 24 slots over 1024-4096 keys, grok-1 32
  slots over 64-3840, and as chat rows sit, lognormal, some slots idle);
- ``paged_decode_attention`` (bf16 and int8 pools): L against the plan's,
  at the table shape and a qwen2-7b decode step (513-page pool of
  16-token pages);
- ``chunk_prefill`` bf16 at C = 256 on qwen2-7b (offsets 0, 1024, 1792):
  seven tile geometries (warps and rows a warp, keys a tile, ring stages,
  (chunk row, query head) rows packed per kv head) times the key-range
  split count 1-4, against the kernel's own geometry at the plan's split
  count and SDPA with GQA and the causal mask;
- ``paged_chunk_prefill`` and ``paged_chunk_prefill_int8`` (bf16 queries)
  at C = 256 on qwen2-7b (offsets 1024, 1792; pages of 16 and 64 tokens):
  the int8 pools' two stagings (``chunk_tc.cuh``'s KVStage: an int8
  cp.async ring, or registers) and 128- and 64-row blocks, each at split
  counts 1-4, against ``chunk_prefill`` on a contiguous cache of the same
  shape through its own entry point;
- ``mha_forward`` and ``mha_bwd_dkv`` bf16 at the two training shapes
  (famous-bert B=8 S=512 8 heads of 96, full; qwen2-7b B=1 S=2048 28 / 4
  heads of 128, causal): the forward at 128- and 64-row blocks, dh 96
  native against padded to 128, longest-first row blocks against natural
  order; dk/dv at 64 and 128 keys a block, 64- and 32-row query items, dh
  96 native against padded, split counts 1 / 2 / 4 / 7, and its hi + lo
  products against a one-pass variant that rounds P^T and dS^T to bf16
  once (timing only: it fails the 1e-4 gate and is not shipped); dq at 64
  and 128 rows a block, 64- and 32-key tiles, dh 96 native against
  padded, split counts 1 / 2 / 4, hi + lo against one pass; each against
  SDPA's forward or its whole backward on the same clock (``dq``: the
  dq sweep alone);
- ``mha_bwd_dq`` and ``mha_bwd_dkv`` bf16 above dh 128 (``mha256``) at
  recurrentgemma-2b's local attention (B=1, 10 / 1 heads of 256, causal,
  a 2048-token window; 4096 and 1292 tokens, and a model=2 rank's 5 / 1
  heads at 2048): the wide geometries (dq's rows a block, keys a tile,
  warps to a 16-row strip and K / V ring stages; dk/dv's keys a block,
  rows an item, warps to a 16-key strip and Q / dO ring stages) at split
  counts 1-4 (dq) and 4-24 (dk/dv), against the kernels' own plans and
  SDPA's whole backward;
- ``matmul_tiled_int8`` (``int8``) at qwen2-7b's D = 3584, F = 4608:
  output-tile shapes (rows, W-stripe columns, D step, warps, ring stages)
  times split-K counts at decode (T = 4), verify (T = 20) and a chunk
  (T = 256), against the plan's choice and, at T = 256, ``torch._int_mm``
  plus the same dequantize (it takes no T <= 16, nor one off a multiple
  of 8);
- ``wkv6_scan`` (``wkv6``) at rwkv6-1.6b's serving chunk (B·H = 32, S =
  256, dh = 64, chunk 64) and a long prompt (S = 2048), bf16 r, k, v and
  f32 logw with a carried state, as the model calls it: pass 1's row and
  column splits, pass 2's column splits, both passes' threads, and qexp
  read from the workspace against recomputed by pass 2, each with the two passes' device times
  apart, against the first design (one block per batch·head,
  ``scripts/scan_first_design.cuh``);
- ``rglru_scan`` (``rglru``) at recurrentgemma-2b's chunk (B = 1, S = 256,
  R = 2560) and a long prompt (S = 4096), f32 as the model calls it: the
  block's features F, time segments P and steps a segment L, each bit-equal
  to the plain version, against the first design (one thread per feature).

Each variant is built from the committed sources (a generated file that
includes the kernel's ``.cu`` and instantiates the variant, one ``nvcc``
a file for the parts asked for, all started together; the paged L
through the port's own entry points, L being a launch argument), checked
against ``torch.matmul`` or the kernel's plain version, and timed by the
profiler's device time of the whole call, inputs rotated past the L2 as
``chip_smoke.py`` does; the library call (``torch.matmul``, SDPA) on the
same clock.  Prints one line per shape and writes
``chiprun_out/kernel_sweep.json``.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# (BM, BN, BK, warps along M, warps along N, stages); the first two are
# the kernel's own choices for T <= 256 and for larger T
MM_TILES = [(64, 64, 64, 2, 2, 4), (64, 128, 64, 2, 4, 3),
            (64, 64, 64, 2, 2, 3), (64, 64, 32, 2, 2, 4),
            (64, 128, 32, 2, 4, 4), (128, 64, 64, 4, 2, 3),
            (128, 128, 32, 2, 4, 3), (32, 128, 64, 1, 4, 4)]
# (T, D, F): qwen2-7b QKV at a ragged, a partial and a full 256-token
# chunk; recurrentgemma-2b's; famous-bert's training X.W, dX and dW
MM_SHAPES = [(100, 3584, 4608), (200, 3584, 4608), (256, 3584, 4608),
             (256, 2560, 3072), (4096, 768, 2304), (4096, 2304, 768),
             (768, 4096, 2304)]
MM_SPLITS = [1, 2, 4, 7, 14]
MM_SPLIT_SHAPES = [(4, 3584, 4608), (20, 3584, 4608), (4, 2560, 3072)]
# chunk_prefill tile geometries (chunk_prefill.cu's TcTiles: warps, 16-row
# m-tiles a warp, keys a K/V tile, ring stages, rows packed per kv head);
# the first is the kernel's own (ServeTiles)
CP_TILES = [(4, 2, 64, 2, False), (4, 1, 64, 2, False), (4, 1, 64, 3, False),
            (4, 1, 32, 2, False), (4, 2, 32, 2, False), (8, 1, 64, 2, False),
            (4, 1, 64, 2, True)]
CP_SPLITS = [1, 2, 3, 4]
CP_OFFSETS = [0, 1024, 1792]
# paged chunk variants: (pool, int8 staging, tile geometry); the first of
# each pool is the kernel's own (ServeTiles, kServeInt8Stage)
PC_VARIANTS = [("fp", "kCopy", (4, 2, 64, 2)),
               ("int8", "kRing8", (4, 2, 64, 2)),
               ("int8", "kRegs8", (4, 2, 64, 2)),
               ("fp", "kCopy", (4, 1, 64, 2)),
               ("int8", "kRing8", (4, 1, 64, 2)),
               ("int8", "kRegs8", (4, 1, 64, 2)),
               ("int8", "kRegs8", (8, 1, 64, 2))]
PC_OFFSETS = [1024, 1792]
PC_PAGE_SIZES = [16, 64]
# (label, B, H, KV, dh, Skv, lens): the chip_smoke table shape, a qwen2-7b
# and a recurrentgemma-2b decode step, the layouts of rows 8b / 8c at
# group 1 (deepseek-7b) and 6 (grok-1) and grok-1's TP ranks, and the two
# benchmark cells' decode steps: deepseek-7b.longctx-batch (24 slots
# decoding over 1024-4096 keys, as its prompts and outputs reach) and
# grok-1-314b-4L.chat-rate (32 slots over 64-3840 keys, uniform, and as
# its chat rows sit: lognormal around 640 keys, 8 slots idle), and
# deepseek-7b on short chat rows; lengths drawn from a fixed seed
DEC_SHAPES = [("table", 4, 28, 4, 128, 2048, [1, 37, 1000, 2048]),
              ("qwen2-7b step", 4, 28, 4, 128, 2048, [1025] * 4),
              ("recurrentgemma-2b step", 4, 10, 1, 256, 2048, [1025] * 4),
              ("deepseek-7b table", 4, 32, 32, 128, 2048,
               [1, 37, 1000, 2048]),
              ("grok-1 table", 4, 48, 8, 128, 2048, [1, 37, 1000, 2048]),
              ("grok-1 TP=2 table", 4, 24, 4, 128, 2048,
               [1, 37, 1000, 2048]),
              ("grok-1 TP=4 table", 4, 12, 2, 128, 2048,
               [1, 37, 1000, 2048]),
              ("deepseek-7b cell", 24, 32, 32, 128, 4096,
               "uniform 1024 4096"),
              ("grok-1 cell", 32, 48, 8, 128, 4096, "uniform 64 3840"),
              ("grok-1 chat rows", 32, 48, 8, 128, 4096,
               "lognormal 640 0.8 64 3840 8"),
              ("deepseek-7b chat rows", 24, 32, 32, 128, 4096,
               "lognormal 384 0.8 32 2800 4")]
DEC_L = [16, 32, 64, 128, 256]
# the stream design (decode_split.cuh decode_stream_kernel): (group, dh,
# warps W, keys a tile TK, ring stages NS); the first of each (group, dh)
# is the kernel's own geometry (StreamServe)
DEC_STREAM = [(1, 128, 4, 8, 4), (1, 128, 4, 8, 3), (1, 128, 4, 8, 6),
              (1, 128, 4, 16, 3), (1, 128, 8, 8, 3), (1, 128, 2, 8, 4),
              (1, 128, 4, 4, 4), (6, 128, 4, 8, 4), (7, 128, 4, 8, 4),
              (10, 256, 4, 4, 4)]
DEC_STREAM_L = [32, 64, 128, 256, 512, 1024]
# mha_forward variants (chunk_tc.cuh's TcTiles warps, 16-row m-tiles a
# warp) x padded head dims; the first tiling at the smallest DP is the
# kernel's own
MHA_FWD_TILES = [(4, 2), (4, 1)]
MHA_DPS = [96, 128]
# mha_bwd_dkv variants (mha_bwd_dkv.cu's DkvTiles: keys a block, query
# rows an item, hi + lo products); the first is the kernel's own
MHA_DKV_TILES = [(64, 64, True), (128, 64, True), (64, 32, True),
                 (64, 64, False)]
MHA_DKV_SPLITS = [1, 2, 4, 7]
# mha_bwd_dq variants (mha_bwd_dq.cu's DqTiles: query rows a block, keys
# a tile, hi + lo products); the first is the kernel's own
MHA_DQ_TILES = [(64, 64, True), (128, 64, True), (64, 32, True),
                (64, 64, False)]
MHA_DQ_SPLITS = [1, 2, 4]
# the bf16 backward above dh 128 (the ``mha256`` part): mha_bwd_dq.cu's
# DqWide (query rows a block, keys a tile, warps to a 16-row strip, ring
# stages) and mha_bwd_dkv.cu's DkvWide (keys a block, query rows an item,
# warps to a 16-key strip, ring stages); the first of each is the
# kernel's own
MHA_DQ_WIDE = [(64, 64, 2, 2), (64, 32, 2, 2), (64, 32, 2, 1),
               (32, 64, 2, 2), (64, 64, 4, 2)]
MHA_DQ_WIDE_SPLITS = [1, 2, 3, 4]
MHA_DKV_WIDE = [(64, 32, 2, 2), (64, 64, 2, 1), (32, 64, 2, 2),
                (32, 64, 4, 2), (64, 64, 4, 1), (32, 32, 2, 2)]
MHA_DKV_WIDE_SPLITS = [4, 8, 12, 16, 24]
# (label, B, S, H, KV, dh, window), causal: chip_smoke.py's LOCAL_ATTN and
# RG_TP_ATTN (PERF.md rows 4b/5b, 4c/5c, 4f/5f)
MHA_WIDE_SHAPES = [("recurrentgemma-2b local", 1, 4096, 10, 1, 256, 2048),
                   ("recurrentgemma-2b local ragged", 1, 1292, 10, 1, 256,
                    2048),
                   ("recurrentgemma-2b TP=2", 1, 2048, 5, 1, 256, 2048)]
# matmul_tiled_int8 variants (matmul_tiled_int8.cu's I8Tiles: BM, BN, BK,
# warps along M and N, ring stages) by regime; the first of each is the
# kernel's own
I8_TILES = {
    "decode": [(16, 128, 128, 1, 4, 3), (16, 64, 128, 1, 4, 3),
               (16, 128, 64, 1, 4, 4), (16, 64, 256, 1, 4, 3),
               (16, 32, 256, 1, 2, 3)],
    "verify": [(32, 128, 128, 1, 4, 3), (32, 64, 128, 1, 4, 3),
               (32, 128, 64, 2, 4, 4)],
    "chunk": [(64, 96, 128, 2, 3, 3), (128, 128, 64, 2, 4, 4),
              (64, 64, 64, 2, 2, 3),
              (128, 64, 64, 2, 2, 4), (64, 128, 64, 2, 2, 4),
              (128, 128, 128, 2, 4, 3), (256, 64, 64, 4, 2, 3),
              (128, 128, 64, 4, 2, 4), (64, 144, 64, 2, 3, 4),
              (64, 144, 128, 2, 3, 3), (32, 144, 64, 1, 3, 4),
              (64, 128, 128, 2, 2, 3), (64, 64, 128, 2, 2, 3), (64, 96, 128, 2, 3, 4),
              (64, 96, 256, 2, 3, 2), (32, 96, 128, 1, 3, 3),
              (64, 48, 128, 2, 3, 3), (128, 96, 128, 4, 3, 3),
              (64, 96, 64, 2, 3, 4)],
}
# (regime, T) at qwen2-7b's fused QKV (D, F), and the split counts swept
I8_SHAPES = [("decode", 4), ("verify", 20), ("chunk", 256)]
I8_D, I8_F = 3584, 4608
I8_SPLITS = {"decode": [1, 2, 4, 7, 14], "verify": [1, 2, 4, 7, 14],
             "chunk": [1, 2, 3]}
# wkv6_scan.cu variants (pass 1 row and column splits and threads, pass 2
# column splits and threads, qexp in the workspace); the first is the
# kernel's own
WKV_VARIANTS = [(1, 1, 256, 8, 128, True), (1, 1, 256, 8, 64, True),
                (1, 1, 256, 8, 256, True), (1, 1, 256, 4, 128, True),
                (1, 1, 256, 4, 64, True), (1, 1, 256, 2, 128, True),
                (1, 1, 256, 16, 128, True), (2, 1, 256, 8, 128, True),
                (4, 1, 256, 8, 128, True), (1, 2, 256, 8, 128, True),
                (1, 4, 256, 8, 128, True), (1, 1, 512, 8, 128, True),
                (1, 1, 256, 8, 128, False)]
# (label, BH, S, dh, chunk)
WKV_SHAPES = [("rwkv6-1.6b chunk", 32, 256, 64, 64),
              ("rwkv6-1.6b long prompt", 32, 2048, 64, 64)]
# rglru_scan.cu variants (features a block F, time segments P, steps a
# segment L); the first is the kernel's own
RGLRU_VARIANTS = [(32, 16, 16), (32, 8, 32), (32, 4, 64), (32, 16, 8),
                  (32, 32, 8), (32, 16, 32), (32, 32, 16), (16, 16, 16),
                  (16, 32, 16), (64, 8, 16), (64, 16, 8)]
# (label, B, S, R)
RGLRU_SHAPES = [("recurrentgemma-2b chunk", 1, 256, 2560),
                ("recurrentgemma-2b long prompt", 1, 4096, 2560)]
# (label, B, S, H, KV, dh, causal): chip_smoke.py's TRAIN_ATTN
MHA_SHAPES = [("famous-bert", 8, 512, 8, 8, 96, False),
              ("qwen2-7b", 1, 2048, 28, 4, 128, True)]


# the generated files each sweep part needs
PART_SOURCES = {"matmul": ["sweep_mm.cu"], "decode": ["sweep_decode.cu"],
                "paged": ["sweep_decode.cu"], "chunk": ["sweep_chunk.cu"],
                "pagedchunk": ["sweep_paged_chunk.cu"],
                "mha": ["sweep_mha_fwd.cu", "sweep_mha_dkv.cu",
                        "sweep_mha_dq.cu"],
                "dq": ["sweep_mha_dq.cu"],
                "mha256": ["sweep_dq256.cu", "sweep_dkv256.cu"],
                "int8": ["sweep_int8.cu"], "wkv6": ["sweep_wkv6.cu"],
                "rglru": ["sweep_rglru.cu"],
                # the port's own library: no generated source
                "mla": []}


def sweep_sources() -> dict[str, str]:
    """The generated CUDA files: each includes one kernel source and adds
    a launcher per tile shape or the decode workspace size."""
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    cases = "\n".join(
        f"    case {i}: e = launch_bf16<{bm}, {bn}, {bk}, {wm}, {wn}, {st}>("
        "xb, wb, ob, nullptr, T, D, F, 1, vec, s); break;"
        for i, (bm, bn, bk, wm, wn, st) in enumerate(MM_TILES))
    mm = f"""#include "{csrc / 'matmul_tiled.cu'}"

extern "C" int sweep_mm(int cfg, const void* x, const void* w, void* out,
                        int T, int D, int F, void* stream) {{
  using namespace famous;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = D % 8 == 0 && F % 8 == 0;
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
{cases}
  }}
  return static_cast<int>(e);
}}
"""
    st_cases = "\n".join(
        f"    case {i}: e = launch_decode_stream<bf16, ContigRows<bf16>, {g}, "
        f"{dh}, StreamTiles<{w}, {tk}, {ns}>>(qb, src, lb, ob, wb, R, H, KV, "
        "Skv, 1, L, scale, vec, s); break;"
        for i, (g, dh, w, tk, ns) in enumerate(DEC_STREAM))
    dec = f"""#include "{csrc / 'decode_attention.cu'}"

extern "C" long long sweep_decode_ws(int R, int H, int dh, int Skv, int L) {{
  return famous::decode_ws_elems(R, H, dh, Skv, L);
}}

// cfg -1: the split design at L; cfg i >= 0: DEC_STREAM[i] at L
extern "C" int sweep_decode(int cfg, const void* q, const void* k, const void* v,
                            const void* lens, void* out, void* ws, int R, int H, int KV,
                            int dh, int Skv, int L, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                            float scale, void* stream) {{
  using namespace famous;
  using bf16 = __nv_bfloat16;
  const int vec = contig_vec<bf16>(q, k, v, dh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh);
  const ContigRows<bf16> src{{static_cast<const bf16*>(k), static_cast<const bf16*>(v), k_sb,
                             k_ss, k_sh, v_sb, v_ss, v_sh}};
  const bf16* qb = static_cast<const bf16*>(q);
  const int* lb = static_cast<const int*>(lens);
  bf16* ob = static_cast<bf16*>(out);
  float* wb = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (cfg < 0) {{
    if (L <= kDecMaxKeys)
      e = launch_decode_split(qb, src, lb, ob, wb, R, H, KV, dh, Skv, 1, L, scale, vec, s);
    return static_cast<int>(e);
  }}
  switch (cfg) {{
{st_cases}
  }}
  return static_cast<int>(e);
}}
"""
    cp_cases = "\n".join(
        f"    case {i}: e = launch_chunk_tc<128, "
        f"TcTiles<{w}, {mt}, {bk}, {st}, {str(pk).lower()}>>("
        "qb, ContigKV{kb, vb, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], "
        "Skv}, qm, ob, static_cast<float*>(part), splits, 1, C, H, KV, dh, "
        "scale, s); break;"
        for i, (w, mt, bk, st, pk) in enumerate(CP_TILES))
    pc_cases = "\n".join(
        f"    case {i}: e = launch_chunk_tc<128, "
        f"TcTiles<{w}, {mt}, {bk}, {st}, false>>(qb, "
        + ("PagedKV<bf16, KVStage::kCopy>{static_cast<const bf16*>(k), "
           "static_cast<const bf16*>(v), nullptr, nullptr"
           if pool == "fp" else
           f"PagedKV<int8_t, KVStage::{stage}>{{static_cast<const int8_t*>"
           "(k), static_cast<const int8_t*>(v), ks, vs")
        + ", pt, ps, n_p, n_pages, n_p * ps}, qm, ob, "
        "static_cast<float*>(part), splits, 1, C, H, KV, dh, scale, s); "
        "break;"
        for i, (pool, stage, (w, mt, bk, st)) in enumerate(PC_VARIANTS))
    cp = f"""#include "{csrc / 'chunk_prefill.cu'}"

extern "C" int sweep_chunk(int cfg, const void* q, const void* k,
                           const void* v, void* out, void* part, int splits,
                           int C, int H, int KV, int dh, int Skv,
                           const void* off, const long long* ks,
                           const long long* vs, float scale, void* stream) {{
  using namespace famous;
  const ChunkQ qm{{static_cast<const int*>(off), nullptr}};
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
{cp_cases}
  }}
  return static_cast<int>(e);
}}
"""
    pc = f"""#include "{csrc / 'paged_chunk_prefill.cu'}"

extern "C" int sweep_paged_chunk(int cfg, const void* q, const void* k,
                                 const void* v, const float* ks,
                                 const float* vs, const int* pt, void* out,
                                 void* part, int splits, int C, int H,
                                 int KV, int dh, int ps, int n_p,
                                 int n_pages, const void* off, float scale,
                                 void* stream) {{
  using namespace famous;
  const ChunkQ qm{{static_cast<const int*>(off), nullptr}};
  const bf16* qb = static_cast<const bf16*>(q);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
{pc_cases}
  }}
  return static_cast<int>(e);
}}
"""
    fwd_cases = "\n".join(
        f"    case {i * len(MHA_DPS) + j}: e = launch_fwd_tc<{dp}, "
        f"TcTiles<{w}, {mt}, 64, 2, false>>(qb, kb, vb, ob, lse, "
        "static_cast<float*>(part), splits, BKV, group, Sq, Skv, dh, causal, "
        "window, q_offset, scale, reverse, s); break;"
        for i, (w, mt) in enumerate(MHA_FWD_TILES)
        for j, dp in enumerate(MHA_DPS))
    fwd = f"""#include "{csrc / 'mha_forward.cu'}"

extern "C" int sweep_mha_fwd(int cfg, const void* q, const void* k,
                             const void* v, void* out, float* lse,
                             void* part, int splits, int BKV, int group,
                             int Sq, int Skv, int dh, int causal, int window,
                             int q_offset, float scale, int reverse,
                             void* stream) {{
  using namespace famous;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
{fwd_cases}
  }}
  return static_cast<int>(e);
}}
"""
    dkv_cases = "\n".join(
        f"    case {i * len(MHA_DPS) + j}: e = launch_dkv_tc<DkvTiles<{dp}, "
        f"{bk}, {bq}, {str(hilo).lower()}>>(qb, kb, vb, ob, lse, delta, dk, "
        "dv, static_cast<float*>(part), splits, BKV, group, Sq, Skv, dh, "
        "causal, window, q_offset, scale, s); break;"
        for i, (bk, bq, hilo) in enumerate(MHA_DKV_TILES)
        for j, dp in enumerate(MHA_DPS))
    dkv = f"""#include "{csrc / 'mha_bwd_dkv.cu'}"

extern "C" int sweep_mha_dkv(int cfg, const void* q, const void* k,
                             const void* v, const void* dout,
                             const float* lse, const float* delta, float* dk,
                             float* dv, void* part, int splits, int BKV,
                             int group, int Sq, int Skv, int dh, int causal,
                             int window, int q_offset, float scale,
                             void* stream) {{
  using namespace famous;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
{dkv_cases}
  }}
  return static_cast<int>(e);
}}
"""
    dq_cases = "\n".join(
        f"    case {i * len(MHA_DPS) + j}: e = launch_dq_tc<DqTiles<{dp}, "
        f"{bq}, {bk}, {str(hilo).lower()}>>(qb, kb, vb, ob, lse, delta, dq, "
        "static_cast<float*>(part), splits, BH, group, Sq, Skv, dh, causal, "
        "window, q_offset, scale, s); break;"
        for i, (bq, bk, hilo) in enumerate(MHA_DQ_TILES)
        for j, dp in enumerate(MHA_DPS))
    dq = f"""#include "{csrc / 'mha_bwd_dq.cu'}"

extern "C" int sweep_mha_dq(int cfg, const void* q, const void* k,
                            const void* v, const void* dout,
                            const float* lse, const float* delta, float* dq,
                            void* part, int splits, int BH, int group,
                            int Sq, int Skv, int dh, int causal, int window,
                            int q_offset, float scale, void* stream) {{
  using namespace famous;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
{dq_cases}
  }}
  return static_cast<int>(e);
}}
"""
    i8_cases = "\n".join(
        f"    case {i}: e = launch_int8<I8Tiles<{bm}, {bn}, {bk}, {wm}, {wn}, "
        f"{st}>>(x, w, a, b, o, p, splits, T, D, F, vec, s); break;"
        for i, (bm, bn, bk, wm, wn, st) in enumerate(i8_tile_list()))
    i8 = f"""#include "{csrc / 'matmul_tiled_int8.cu'}"

extern "C" int sweep_int8(int cfg, const void* xq, const void* wqt,
                          const float* a, const float* b, float* o,
                          int* p, int splits, int T, int D, int F,
                          void* stream) {{
  using namespace famous;
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wqt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = D % 16 == 0;
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
{i8_cases}
  }}
  return static_cast<int>(e);
}}
"""
    base = ROOT / "scripts" / "scan_first_design.cuh"
    wkv_cases = "\n".join(
        f"    case {i + 1}: e = launch_wkv6<bf, float, {rs}, {cs}, {nt}, {cs2}, "
        f"{nt2}, {str(q).lower()}>(r, k, v, w, u, s0, out, sf, ws, BH, S, dh, C, "
        "s); break;"
        for i, (rs, cs, nt, cs2, nt2, q) in enumerate(WKV_VARIANTS))
    wkv = f"""#include "{csrc / 'wkv6_scan.cu'}"
#include "{base}"

extern "C" int sweep_wkv6(int cfg, const void* r, const void* k,
                          const void* v, const void* w, const float* u,
                          const float* s0, float* out, float* sf, float* ws,
                          int BH, int S, int dh, int C, void* stream) {{
  using namespace famous;
  using bf = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
    case 0: e = first_design::launch_wkv6<bf, float>(r, k, v, w, u, s0, out,
                                                     sf, BH, S, dh, C, s);
      break;
{wkv_cases}
  }}
  return static_cast<int>(e);
}}
"""
    rg_cases = "\n".join(
        f"    case {i + 1}: e = launch_rglru<float, {f}, {p}, {l}>(a, b, out, "
        "B, S, R, s); break;"
        for i, (f, p, l) in enumerate(RGLRU_VARIANTS))
    rg = f"""#include "{csrc / 'rglru_scan.cu'}"
#include "{base}"

extern "C" int sweep_rglru(int cfg, const void* a, const void* b, float* out,
                           int B, int S, int R, void* stream) {{
  using namespace famous;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
    case 0: e = first_design::launch_rglru<float>(a, b, out, B, S, R, s);
      break;
{rg_cases}
  }}
  return static_cast<int>(e);
}}
"""
    wide_args = ("(q), static_cast<const bf16*>(k), static_cast<const bf16*>"
                 "(v), static_cast<const bf16*>(dout), lse, delta, ")
    dq256_cases = "\n".join(
        f"    case {i}: e = launch_dq_wide<DqWide<{bq}, {bk}, {wc}, {st}>>("
        f"static_cast<const bf16*>{wide_args}dq, static_cast<float*>(part), "
        "splits, BH, group, Sq, Skv, dh, causal, window, q_offset, scale, s); "
        "break;"
        for i, (bq, bk, wc, st) in enumerate(MHA_DQ_WIDE))
    dq256 = f"""#include "{csrc / 'mha_bwd_dq.cu'}"

extern "C" int sweep_dq256(int cfg, const void* q, const void* k,
                           const void* v, const void* dout, const float* lse,
                           const float* delta, float* dq, void* part,
                           int splits, int BH, int group, int Sq, int Skv,
                           int dh, int causal, int window, int q_offset,
                           float scale, void* stream) {{
  using namespace famous;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
{dq256_cases}
  }}
  return static_cast<int>(e);
}}
"""
    dkv256_cases = "\n".join(
        f"    case {i}: e = launch_dkv_wide<DkvWide<{bk}, {bq}, {wc}, {st}>>("
        f"static_cast<const bf16*>{wide_args}dk, dv, static_cast<float*>"
        "(part), splits, BKV, group, Sq, Skv, dh, causal, window, q_offset, "
        "scale, s); break;"
        for i, (bk, bq, wc, st) in enumerate(MHA_DKV_WIDE))
    dkv256 = f"""#include "{csrc / 'mha_bwd_dkv.cu'}"

extern "C" int sweep_dkv256(int cfg, const void* q, const void* k,
                            const void* v, const void* dout,
                            const float* lse, const float* delta, float* dk,
                            float* dv, void* part, int splits, int BKV,
                            int group, int Sq, int Skv, int dh, int causal,
                            int window, int q_offset, float scale,
                            void* stream) {{
  using namespace famous;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (cfg) {{
{dkv256_cases}
  }}
  return static_cast<int>(e);
}}
"""
    return {"sweep_mm.cu": mm, "sweep_decode.cu": dec, "sweep_chunk.cu": cp,
            "sweep_dq256.cu": dq256, "sweep_dkv256.cu": dkv256,
            "sweep_paged_chunk.cu": pc, "sweep_mha_fwd.cu": fwd,
            "sweep_mha_dkv.cu": dkv, "sweep_mha_dq.cu": dq,
            "sweep_int8.cu": i8, "sweep_wkv6.cu": wkv, "sweep_rglru.cu": rg}


def i8_tile_list():
    """Every int8 tile shape, regimes in I8_TILES' order (the sweep's cfg
    index)."""
    return [t for tiles in I8_TILES.values() for t in tiles]


def build(out_dir: Path, parts) -> ctypes.CDLL:
    """Compile the generated files the parts need (one nvcc each, in
    parallel) and link them with the error strings and the launch log
    into one library."""
    from repro_torch.kernels import lib

    out_dir.mkdir(parents=True, exist_ok=True)
    names = sorted({f for p in parts for f in PART_SOURCES[p]})
    texts = sweep_sources()
    procs = []
    for name in names:
        (out_dir / name).write_text(texts[name])
        obj = out_dir / (name + ".o")
        procs.append((obj, subprocess.Popen(
            [lib.nvcc_path(), *lib.ARCH_FLAGS, *lib.NVCC_FLAGS, "-I",
             str(lib.CSRC), "-c", str(out_dir / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for obj, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {obj.name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(obj.name)
    so = out_dir / "libsweep.so"
    if not failed:
        run = subprocess.run(
            [lib.nvcc_path(), *lib.ARCH_FLAGS, *lib.NVCC_FLAGS, "-shared",
             "-o", str(so), *(str(o) for o, _ in procs),
             str(lib.CSRC / "errors.cu"), str(lib.CSRC / "launch_log.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link (rc {run.returncode})\n{run.stdout}")
        if run.returncode != 0:
            failed.append("link")
    (out_dir / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    so_lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    PLL = ctypes.POINTER(ctypes.c_longlong)
    sigs = {
        "sweep_mm": [I, P, P, P, I, I, I, P],
        "sweep_chunk": [I, P, P, P, P, P, I, I, I, I, I, I, P, PLL, PLL, F,
                        P],
        "sweep_paged_chunk": [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                              I, P, F, P],
        "sweep_mha_fwd": [I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F,
                          I, P],
        "sweep_mha_dkv": [I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                          I, I, F, P],
        "sweep_mha_dq": [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                         I, F, P],
        "sweep_dq256": [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                        I, F, P],
        "sweep_dkv256": [I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                         I, I, F, P],
        "sweep_int8": [I, P, P, P, P, P, P, I, I, I, I, P],
        "sweep_wkv6": [I, P, P, P, P, P, P, P, P, P, I, I, I, I, P],
        "sweep_rglru": [I, P, P, P, I, I, I, P],
        "famous_matmul_tiled": lib._SIGNATURES["famous_matmul_tiled"],
        "sweep_decode": [I, P, P, P, P, P, P, I, I, I, I, I, I,
                         ctypes.c_longlong, ctypes.c_longlong,
                         ctypes.c_longlong, ctypes.c_longlong,
                         ctypes.c_longlong, ctypes.c_longlong, F, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(so_lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, I
    if hasattr(so_lib, "sweep_decode_ws"):
        so_lib.sweep_decode_ws.argtypes = [I, I, I, I, I]
        so_lib.sweep_decode_ws.restype = ctypes.c_longlong
    return so_lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--parts",
                    default="matmul,decode,paged,chunk,pagedchunk,mha,int8,"
                    "wkv6,rglru",
                    help="comma-separated sweeps to run")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as Fn

    import chip_smoke as cs
    from repro_torch.kernels import lib
    from repro_torch.kernels.decode import decode_attn
    from repro_torch.kernels.decode import ref as dec_ref
    from repro_torch.kernels.qkv import qkv_proj

    parts = set(args.parts.split(","))
    unknown = parts - set(PART_SOURCES)
    if unknown:
        print(f"kernel_sweep: unknown parts {sorted(unknown)}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lib.load()   # the port's library: the plans and error strings
    so = (build(ROOT / "build" / "sweep", parts)
          if any(PART_SOURCES[p] for p in parts) else None)
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = lib.sm_count(dev)
    code = lib.DTYPE_CODE[torch.bfloat16]
    it = args.iters
    smi = cs.smi_line()
    print(f"card: {smi}", flush=True)
    result = {"card": smi, "matmul_tiles": [], "matmul_splits": [],
              "decode_L": [], "paged_decode_L": [], "chunk_prefill": [],
              "paged_chunk_prefill": [], "mha_forward": [],
              "mha_bwd_dkv": [], "mha_bwd_dq": [], "mha_bwd_dq_wide": [],
              "mha_bwd_dkv_wide": [], "matmul_tiled_int8": [],
              "wkv6_scan": [], "rglru_scan": [], "mla_decode": []}

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def dev_ms(fn, sets):
        return cs.device_ms(torch, fn, sets, it)

    # matmul_tiled above T = 32: output-tile shapes
    for T, D, F in MM_SHAPES if "matmul" in parts else ():
        sets = [(randn((T, D)), randn((D, F), D ** -0.5))
                for _ in range(cs.n_sets((T * D + D * F) * 2))]
        ref = torch.matmul(sets[0][0].float(), sets[0][1].float())
        row = {"T": T, "D": D, "F": F, "library_ms": dev_ms(torch.matmul,
                                                            sets)}
        for i, tile in enumerate(MM_TILES):
            def kern(x, w, i=i):
                out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                                  device=dev)
                lib.check("sweep_mm", so.sweep_mm(
                    i, x.data_ptr(), w.data_ptr(), out.data_ptr(), T, D, F,
                    stream()))
                return out
            err, ok = cs.compare(torch, kern(*sets[0]), ref, cs.TOL["bf16"])
            name = "{}x{}x{} w{}x{} s{}".format(*tile)
            row[name] = {"ms": dev_ms(kern, sets), "max_abs_err": err,
                         "ok": ok}
        result["matmul_tiles"].append(row)
        print(f"matmul_tiled T={T} D={D} F={F}: torch.matmul "
              f"{ms_text(row['library_ms'])} ms | " + row_text(row),
              flush=True)
        del sets

    # matmul_tiled at T <= 32: split-K counts through the kernel's entry
    for T, D, F in MM_SPLIT_SHAPES if "matmul" in parts else ():
        sets = [(randn((T, D)), randn((D, F), D ** -0.5))
                for _ in range(cs.n_sets((T * D + D * F) * 2))]
        ref = torch.matmul(sets[0][0].float(), sets[0][1].float())
        chosen, _ = qkv_proj._plan(code, T, D, F, sms)
        row = {"T": T, "D": D, "F": F, "plan_splits": chosen,
               "library_ms": dev_ms(torch.matmul, sets)}
        for n in sorted(set(MM_SPLITS + [chosen])):
            # the split partials: n x T x F f32 (matmul_tiled.cu's plan)
            part = torch.empty(n * T * F, dtype=torch.float32, device=dev)

            def kern(x, w, n=n, part=part):
                out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                                  device=dev)
                lib.check("famous_matmul_tiled", so.famous_matmul_tiled(
                    code, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                    part.data_ptr() if n > 1 else None, n, T, D, F,
                    stream()))
                return out
            err, ok = cs.compare(torch, kern(*sets[0]), ref, cs.TOL["bf16"])
            row[f"splits={n}"] = {"ms": dev_ms(kern, sets),
                                  "max_abs_err": err, "ok": ok}
        result["matmul_splits"].append(row)
        print(f"matmul_tiled T={T} D={D} F={F} (plan: {chosen} splits): "
              f"torch.matmul {ms_text(row['library_ms'])} ms | "
              + row_text(row), flush=True)
        del sets

    if "decode" in parts:
        decode_sweep(torch, Fn, lib, so, randn, dev_ms, result, sms)
    if "paged" in parts:
        paged_decode_sweep(torch, lib, so, randn, dev_ms, result, sms)
    if "chunk" in parts:
        chunk_sweep(torch, Fn, lib, so, randn, dev_ms, result, sms)
    if "pagedchunk" in parts:
        paged_chunk_sweep(torch, lib, so, randn, dev_ms, result, sms)
    if "mha" in parts:
        mha_sweep(torch, Fn, lib, so, randn, dev_ms, result, sms)
    elif "dq" in parts:
        mha_sweep(torch, Fn, lib, so, randn, dev_ms, result, sms, ("dq",))
    if "mha256" in parts:
        mha_wide_sweep(torch, Fn, lib, so, randn, dev_ms, result, sms)
    if "int8" in parts:
        int8_sweep(torch, lib, so, gen, dev_ms, result, sms)
    if "wkv6" in parts or "rglru" in parts:
        scan_sweep(torch, so, gen, it, result, parts)
    if "mla" in parts:
        mla_sweep(torch, lib, randn, dev_ms, result, sms)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_sweep.json").write_text(json.dumps(result, indent=1))
    bad = [k for sec in ("matmul_tiles", "matmul_splits", "decode_L",
                         "paged_decode_L", "chunk_prefill",
                         "paged_chunk_prefill", "mha_forward", "mha_bwd_dkv",
                         "mha_bwd_dq", "mha_bwd_dq_wide", "mha_bwd_dkv_wide",
                         "matmul_tiled_int8", "wkv6_scan",
                         "rglru_scan", "mla_decode")
           for row in result[sec] for k, v in row.items()
           if isinstance(v, dict) and v.get("ok") is False
           and not v.get("expected_miss")]
    print(json.dumps({"ok": not bad, "wrong": bad}))
    return 1 if bad else 0


def ms_text(ms):
    """A time, or "n/a" where the variant did not run or the profiler saw
    no device time."""
    return "n/a" if ms is None else f"{ms:.4f}"


def row_text(row):
    return " | ".join(
        f"{k} {ms_text(v['ms'])}" + (
            "" if v.get("ok", True) else
            f" (misses the gate: {v['expected_miss']})"
            if v.get("expected_miss") else " WRONG")
        for k, v in row.items() if isinstance(v, dict))


def dec_lens(spec, B, seed=0):
    """A shape's lengths: its list; "uniform lo hi": B lengths drawn
    uniformly from [lo, hi]; "lognormal median sigma lo hi idle": B - idle
    lognormal lengths clipped to [lo, hi], then idle empty rows; drawn
    with a fixed seed."""
    import numpy as np

    if not isinstance(spec, str):
        return list(spec)
    kind, *a = spec.split()
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return [int(x) for x in rng.integers(int(a[0]), int(a[1]) + 1, B)]
    med, sigma, lo, hi, idle = float(a[0]), float(a[1]), *map(int, a[2:])
    x = np.clip(med * np.exp(sigma * rng.standard_normal(B - idle)), lo, hi)
    return [int(v) for v in x] + [0] * idle


def decode_sweep(torch, Fn, lib, so, randn, dev_ms, result, sms):
    """``decode_attention`` bf16 at each DEC_SHAPES entry: the split
    design at each L of DEC_L and the stream design's DEC_STREAM variants
    of the shape's (group, dh) at each L of DEC_STREAM_L, each checked
    against the plain version and timed with its share of the byte bound
    (q, out and each live key's K and V row read once), against the plan's
    design and L and SDPA."""
    import chip_smoke as cs
    from repro_torch.kernels.decode import decode_attn
    from repro_torch.kernels.decode import ref as dec_ref

    dev = torch.device("cuda")
    code = lib.DTYPE_CODE[torch.bfloat16]
    stream = torch.cuda.current_stream().cuda_stream
    for label, B, H, KV, dh, Skv, spec in DEC_SHAPES:
        lens_list = dec_lens(spec, B)
        scale = dh ** -0.5
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        mask = (torch.arange(Skv, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        sets = [(randn((B, H, dh)), randn((B, Skv, KV, dh)),
                 randn((B, Skv, KV, dh)))
                for _ in range(cs.n_sets(4 * B * Skv * KV * dh))]
        ref = dec_ref.decode_reference(*sets[0], lens, scale=scale)
        chosen, _ = decode_attn.plan(code, B, H, KV, dh, Skv, sms)
        nbytes = 2 * (2 * B * H * dh + sum(lens_list) * 2 * KV * dh) + 4 * B
        bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3

        def library(q, k, v):
            return Fn.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, scale=scale, enable_gqa=True)
        row = {"shape": label, "B": B, "H": H, "KV": KV, "dh": dh,
               "Skv": Skv, "lens": lens_list,
               "plan": [decode_attn.design(code, H, KV, dh), chosen],
               "bound_ms": bound_ms, "library_ms": dev_ms(library, sets)}
        variants = [("split", -1, L) for L in DEC_L] + [
            ("stream {}x{}x{}".format(*geo[2:]), i, L)
            for i, geo in enumerate(DEC_STREAM)
            if geo[:2] == (H // KV, dh) for L in DEC_STREAM_L]
        for name, cfg, L in variants:
            ws = torch.empty(so.sweep_decode_ws(B, H, dh, Skv, L),
                             dtype=torch.float32, device=dev)

            def kern(q, k, v, cfg=cfg, L=L, ws=ws):
                out = torch.empty_like(q)
                err = so.sweep_decode(
                    cfg, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lens.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H,
                    KV, dh, Skv, L, *k.stride()[:3], *v.stride()[:3],
                    scale, stream)
                if err:
                    raise RuntimeError(f"{name} L={L}: CUDA error {err}")
                return out
            key = f"{name} L={L}"
            try:
                out = kern(*sets[0])
            except RuntimeError as e:   # past shared memory or the keys cap
                torch.cuda.synchronize()
                row[key] = {"ms": None, "error": str(e)}
                continue
            err, ok = cs.compare(torch, out, ref, cs.ATTN_TOL["bf16"])
            ms = dev_ms(kern, sets)
            row[key] = {"ms": ms, "max_abs_err": err, "ok": ok,
                        "pct_of_bound": None if not ms else
                        100.0 * bound_ms / ms}
        result["decode_L"].append(row)
        timed = [(v["ms"], k) for k, v in row.items()
                 if isinstance(v, dict) and v.get("ms")]
        best = min(timed)
        print(f"decode_attention {label} B={B} H={H} KV={KV} dh={dh} "
              f"Skv={Skv} (plan: {row['plan'][0]} L={chosen}; bound "
              f"{bound_ms:.4f} ms; best {best[1]} {best[0]:.4f} ms, "
              f"{100 * bound_ms / best[0]:.1f}% of bound): SDPA "
              f"{ms_text(row['library_ms'])} ms | " + row_text(row),
              flush=True)
        del sets


def paged_decode_sweep(torch, lib, so, randn, dev_ms, result, sms):
    """``paged_decode_attention`` (bf16 pools) and its int8 instantiation:
    keys per block range L through the port's own entry points (L is a
    launch argument), each against the plan's L."""
    import chip_smoke as cs
    from repro_torch.core import quant
    from repro_torch.kernels.decode import decode_attn
    from repro_torch.kernels.decode import ref as dec_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, KV, dh, ps, n_pages = 4, 28, 4, 128, 16, 513
    n_p, scale = 2048 // ps, dh ** -0.5
    pt = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:B * n_p]
          + 1).to(torch.int32).reshape(B, n_p).contiguous()
    code = lib.DTYPE_CODE[torch.bfloat16]
    stream = torch.cuda.current_stream().cuda_stream
    for label, lens_list in (("table", [1, 37, 1000, 2048]),
                             ("qwen2-7b step", [1025] * 4)):
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        for kind in ("fp", "int8"):
            def pools():
                k = randn((n_pages, ps, KV, dh))
                v = randn((n_pages, ps, KV, dh))
                if kind == "fp":
                    return (k, v)
                (kq, ks), (vq, vs) = (quant.quantize(x, -1) for x in (k, v))
                return (kq, vq, ks[..., 0].contiguous(),
                        vs[..., 0].contiguous())
            esize = 2 if kind == "fp" else 1
            sets = [(randn((B, H, dh)), *pools())
                    for _ in range(cs.n_sets(2 * n_pages * ps * KV * dh
                                             * esize))]
            plain = (dec_ref.paged_decode_reference if kind == "fp" else
                     dec_ref.paged_decode_reference_int8)
            ref = plain(*sets[0], pt, lens, scale=scale)
            chosen, _ = decode_attn.paged_plan(B, H, KV, dh, n_p * ps, esize,
                                               sms)
            name = "famous_paged_decode_attention" + (
                "" if kind == "fp" else "_int8")
            row = {"shape": label, "pool": kind, "lens": lens_list,
                   "plan_L": chosen}
            for L in DEC_L:
                ws = torch.empty(so.sweep_decode_ws(B, H, dh, n_p * ps, L),
                                 dtype=torch.float32, device=dev)

                def kern(q, *pool, L=L, ws=ws, name=name):
                    out = torch.empty_like(q)
                    lib.check(name, getattr(lib.load(), name)(
                        code, q.data_ptr(), *(x.data_ptr() for x in pool),
                        pt.data_ptr(), lens.data_ptr(), out.data_ptr(),
                        ws.data_ptr(), B, H, KV, dh, ps, n_p, n_pages, 1, L,
                        scale, stream))
                    return out
                err, ok = cs.compare(torch, kern(*sets[0]), ref,
                                     cs.ATTN_TOL["bf16"])
                row[f"L={L}"] = {"ms": dev_ms(kern, sets), "max_abs_err": err,
                                 "ok": ok}
            result["paged_decode_L"].append(row)
            print(f"paged_decode_attention {label} {kind} pools "
                  f"lens={lens_list} (plan: L={chosen}): " + row_text(row),
                  flush=True)
            del sets


def chunk_sweep(torch, Fn, lib, so, randn, dev_ms, result, sms):
    """``chunk_prefill`` bf16 at C = 256 on qwen2-7b's heads (one slot of
    a 2048-key cache): each tiling of CP_TILES at each split count, against
    the plan's split count and SDPA with GQA and the causal mask, on the
    same clock."""
    import chip_smoke as cs
    from repro_torch.kernels.decode import chunk_prefill
    from repro_torch.kernels.decode import ref as dec_ref

    dev = torch.device("cuda")
    C, H, KV, dh, Skv = 256, 28, 4, 128, 2048
    scale = dh ** -0.5
    code = lib.DTYPE_CODE[torch.bfloat16]
    stream = torch.cuda.current_stream().cuda_stream
    chosen, _ = chunk_prefill.plan(code, 1, C, H, KV, dh, Skv, sms)
    sets = [(randn((1, C, H, dh)), randn((1, Skv, KV, dh)),
             randn((1, Skv, KV, dh))) for _ in range(8)]
    for off in CP_OFFSETS:
        cmask = (torch.arange(Skv, device=dev)[None, :]
                 <= off + torch.arange(C, device=dev)[:, None])

        def library(q, k, v, cmask=cmask):
            return Fn.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=cmask, scale=scale, enable_gqa=True)
        ref = dec_ref.chunk_prefill_reference(*sets[0], off, scale=scale)
        off_t = torch.tensor([off], dtype=torch.int32, device=dev)
        row = {"C": C, "offset": off, "plan_splits": chosen,
               "library_ms": dev_ms(library, sets)}
        for i, (warps, mt, bk, st, pack) in enumerate(CP_TILES):
            for n in CP_SPLITS:
                part = torch.empty(n * C * H * (dh + 2), dtype=torch.float32,
                                   device=dev)

                def kern(q, k, v, i=i, n=n, part=part, off_t=off_t):
                    out = torch.empty_like(q)
                    ks = (ctypes.c_longlong * 3)(*k.stride()[:3])
                    vs = (ctypes.c_longlong * 3)(*v.stride()[:3])
                    lib.check("sweep_chunk", so.sweep_chunk(
                        i, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), part.data_ptr(), n, C, H, KV, dh,
                        Skv, off_t.data_ptr(), ks, vs, scale, stream))
                    return out
                err, ok = cs.compare(torch, kern(*sets[0]), ref,
                                     cs.ATTN_TOL["bf16"])
                name = (f"{16 * mt * warps} rows ({warps}w x {16 * mt}) "
                        f"{bk} keys {st} stages{' packed' if pack else ''} "
                        f"splits={n}")
                row[name] = {"ms": dev_ms(kern, sets), "max_abs_err": err,
                             "ok": ok}
        result["chunk_prefill"].append(row)
        print(f"chunk_prefill C={C} offset={off} (plan: the first tiling, "
              f"{chosen} splits): SDPA {ms_text(row['library_ms'])} ms | "
              + row_text(row), flush=True)
    del sets


def paged_chunk_sweep(torch, lib, so, randn, dev_ms, result, sms):
    """The bf16 paged chunk kernels at C = 256 on qwen2-7b's heads, one
    slot whose 2048 keys lie on shuffled pages of a 4-slot pool (16- or
    64-token pages): each variant of PC_VARIANTS at each split count,
    checked against the plain paged version, against ``chunk_prefill``
    on a contiguous cache of the same shape (its own entry point and plan)
    on the same clock."""
    import chip_smoke as cs
    from repro_torch.core import quant
    from repro_torch.kernels.decode import chunk_prefill
    from repro_torch.kernels.decode import ref as dec_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    C, H, KV, dh, Skv = 256, 28, 4, 128, 2048
    scale = dh ** -0.5
    code = lib.DTYPE_CODE[torch.bfloat16]
    stream = torch.cuda.current_stream().cuda_stream
    chosen, _ = chunk_prefill.plan(code, 1, C, H, KV, dh, Skv, sms)
    csets = [(randn((1, C, H, dh)), randn((1, Skv, KV, dh)),
              randn((1, Skv, KV, dh))) for _ in range(8)]
    for ps in PC_PAGE_SIZES:
        n_p = Skv // ps
        n_pages = 4 * n_p + 1
        pt = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:n_p]
              + 1).to(torch.int32)[None].contiguous()
        pools = {}
        for kind in ("fp", "int8"):
            sets = []
            for q, _, _ in csets:
                k = randn((n_pages, ps, KV, dh))
                v = randn((n_pages, ps, KV, dh))
                if kind == "int8":
                    (k, ks), (v, vs) = (quant.quantize(x, -1) for x in (k, v))
                    sets.append((q, k, v, ks[..., 0].contiguous(),
                                 vs[..., 0].contiguous()))
                else:
                    sets.append((q, k, v))
            pools[kind] = sets
        for off in PC_OFFSETS:
            off_t = torch.tensor([off], dtype=torch.int32, device=dev)
            row = {"C": C, "offset": off, "page_size": ps,
                   "plan_splits": chosen,
                   "chunk_prefill_ms": dev_ms(
                       lambda q, k, v, off=off: chunk_prefill.chunk_prefill(
                           q, k, v, off, scale=scale), csets)}
            refs = {"fp": dec_ref.paged_chunk_prefill_reference(
                        *pools["fp"][0], pt, off, scale=scale),
                    "int8": dec_ref.paged_chunk_prefill_reference_int8(
                        *pools["int8"][0], pt, off, scale=scale)}
            for i, (kind, stage, (w, mt, _, _)) in enumerate(PC_VARIANTS):
                for n in CP_SPLITS:
                    part = torch.empty(n * C * H * (dh + 2),
                                       dtype=torch.float32, device=dev)

                    def kern(q, k, v, ks=None, vs=None, i=i, n=n, part=part,
                             off_t=off_t):
                        out = torch.empty_like(q)
                        lib.check("sweep_paged_chunk", so.sweep_paged_chunk(
                            i, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            None if ks is None else ks.data_ptr(),
                            None if vs is None else vs.data_ptr(),
                            pt.data_ptr(), out.data_ptr(), part.data_ptr(),
                            n, C, H, KV, dh, ps, n_p, n_pages,
                            off_t.data_ptr(), scale, stream))
                        return out
                    err, ok = cs.compare(torch, kern(*pools[kind][0]),
                                         refs[kind], cs.ATTN_TOL["bf16"])
                    name = (f"{kind} {stage} {16 * mt * w} rows ({w}w x "
                            f"{16 * mt}) splits={n}")
                    row[name] = {"ms": dev_ms(kern, pools[kind]),
                                 "max_abs_err": err, "ok": ok}
            result["paged_chunk_prefill"].append(row)
            print(f"paged_chunk_prefill C={C} offset={off} page={ps} (plan: "
                  f"the first of each pool, {chosen} splits): chunk_prefill "
                  f"{ms_text(row['chunk_prefill_ms'])} ms | " + row_text(row),
                  flush=True)
        del pools


def mha_sweep(torch, Fn, lib, so, randn, dev_ms, result, sms,
              kernels=("fwd", "dkv", "dq")):
    """The bf16 ``mha_forward``, ``mha_bwd_dkv`` and ``mha_bwd_dq`` at the
    two training shapes: each variant of MHA_FWD_TILES x MHA_DPS (x
    row-block order under the causal mask), MHA_DKV_TILES x MHA_DPS x
    split counts and MHA_DQ_TILES x MHA_DPS x split counts, checked
    against the plain versions (ATTN_TOL, BWD_TOL, with the share of the
    tolerance used; the one-pass backward variants, and dk/dv runs longer
    than the plan allows (``ref.dkv_run_items``), may miss BWD_TOL: recorded, not
    failed), against the kernels' own plans and SDPA's forward or whole
    backward on the same clock.  ``kernels`` names which of the three to
    sweep."""
    import chip_smoke as cs
    from repro_torch.kernels.attention import mha as mha_k
    from repro_torch.kernels.attention import ref as mha_ref

    dev = torch.device("cuda")
    code = lib.DTYPE_CODE[torch.bfloat16]
    stream = torch.cuda.current_stream().cuda_stream
    for label, B, S, H, KV, dh, causal in MHA_SHAPES:
        kw = dict(causal=causal, window=0, scale=dh ** -0.5, q_offset=0)
        BH, BKV = B * H, B * KV
        per = 2 * (2 * BH + 2 * BKV) * S * dh
        sets = [(randn((BH, S, dh)), randn((BKV, S, dh)), randn((BKV, S, dh)))
                for _ in range(cs.n_sets(per))]
        bsets, lsets = [], []
        for q, k, v in sets:
            o, lse = mha_ref.mha_forward_reference(q, k, v, **kw)
            do = randn((BH, S, dh))
            bsets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
            leaves = tuple(t.detach().clone().requires_grad_()
                           for t in (q, k, v))
            lo = Fn.scaled_dot_product_attention(
                *(t.view(B, -1, S, dh) for t in leaves), is_causal=causal,
                scale=kw["scale"], enable_gqa=True)
            lsets.append((lo, leaves, do.view(lo.shape)))
        ref_f = mha_ref.mha_forward_reference(*sets[0], **kw)
        ref_b = mha_ref.mha_bwd_dkv_reference(*bsets[0], **kw)

        def sdpa(q, k, v):
            return Fn.scaled_dot_product_attention(
                *(t.view(B, -1, S, dh) for t in (q, k, v)), is_causal=causal,
                scale=kw["scale"], enable_gqa=True)

        def sdpa_b(lo, leaves, g):
            return torch.autograd.grad(lo, leaves, g, retain_graph=True)

        lib_b_ms = dev_ms(sdpa_b, lsets)
        if "fwd" in kernels:
            # the forward
            f_splits, _ = mha_k.forward_plan(code, BH, BKV, S, S, dh, sms)
            row = {"shape": label, "plan_splits": f_splits,
                   "library_ms": dev_ms(sdpa, sets),
                   "kernel_ms": dev_ms(lambda q, k, v: mha_k.mha_forward(
                       q, k, v, **kw), sets)}
            for i, (w, mt) in enumerate(MHA_FWD_TILES):
                for j, dp in enumerate(MHA_DPS):
                    if dp < dh:
                        continue
                    for rev in ((1, 0) if causal else (0,)):
                        def kern(q, k, v, cfg=i * len(MHA_DPS) + j, rev=rev):
                            out = torch.empty_like(q)
                            lse = torch.empty((BH, S), dtype=torch.float32,
                                              device=dev)
                            lib.check("sweep_mha_fwd", so.sweep_mha_fwd(
                                cfg, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), lse.data_ptr(), None, 1, BKV,
                                H // KV, S, S, dh, int(causal), 0, 0,
                                kw["scale"], rev, stream))
                            return out, lse
                        err, ok = cs.compare(torch, kern(*sets[0]), ref_f,
                                             cs.ATTN_TOL["bf16"])
                        name = (f"{16 * mt * w} rows dh {dp}"
                                + (f" {'longest first' if rev else 'natural'}"
                                   if causal else ""))
                        row[name] = {"ms": dev_ms(kern, sets), "max_abs_err": err,
                                     "ok": ok}
            result["mha_forward"].append(row)
            print(f"mha_forward {label} (plan: {f_splits} splits): kernel "
                  f"{ms_text(row['kernel_ms'])} ms, SDPA "
                  f"{ms_text(row['library_ms'])} ms | " + row_text(row),
                  flush=True)
            del sets

        if "dkv" in kernels:
            # dk/dv
            b_splits, _ = mha_k.dkv_plan(code, BH, BKV, S, S, dh, sms)
            row = {"shape": label, "plan_splits": b_splits,
                   "library_ms": lib_b_ms,
                   "kernel_ms": dev_ms(lambda *a: mha_k.mha_bwd_dkv(*a, **kw),
                                       bsets)}
            for i, (bk, bq, hilo) in enumerate(MHA_DKV_TILES):
                for j, dp in enumerate(MHA_DPS):
                    if dp < dh:
                        continue
                    for n in sorted(set(MHA_DKV_SPLITS + [b_splits])):
                        part = torch.empty(2 * n * BKV * S * dh,
                                           dtype=torch.float32, device=dev)

                        def kern(q, k, v, do, lse, delta, n=n, part=part,
                                 cfg=i * len(MHA_DPS) + j):
                            dk = torch.empty(k.shape, dtype=torch.float32,
                                             device=dev)
                            dv = torch.empty_like(dk)
                            lib.check("sweep_mha_dkv", so.sweep_mha_dkv(
                                cfg, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                dk.data_ptr(), dv.data_ptr(), part.data_ptr(), n,
                                BKV, H // KV, S, S, dh, int(causal), 0, 0,
                                kw["scale"], stream))
                            return dk, dv
                        err, ok = cs.compare(torch, kern(*bsets[0]), ref_b,
                                             cs.BWD_TOL["bf16"])
                        name = (f"{bk} keys {bq} rows dh {dp}"
                                f"{'' if hilo else ' one-pass'} splits={n}")
                        # the longest run: the first key block's items
                        items = (H // KV) * -(-S // bq)
                        run = -(-items // n)
                        cap = mha_ref.dkv_run_items(bq)
                        miss = ("one pass" if not hilo else
                                f"runs of {run} items" if run > cap
                                else None)
                        row[name] = {"ms": dev_ms(kern, bsets), "max_abs_err": err,
                                     "ok": ok, "expected_miss": miss}
            result["mha_bwd_dkv"].append(row)
            print(f"mha_bwd_dkv {label} (plan: {b_splits} splits): kernel "
                  f"{ms_text(row['kernel_ms'])} ms, SDPA backward (dq, dk, dv) "
                  f"{ms_text(row['library_ms'])} ms | " + row_text(row),
                  flush=True)

        if "dq" in kernels:
            # dq
            ref_q = mha_ref.mha_bwd_dq_reference(*bsets[0], **kw)
            q_splits, _ = mha_k.dq_plan(code, BH, BKV, S, S, dh, sms)
            row = {"shape": label, "plan_splits": q_splits,
                   "library_ms": lib_b_ms,
                   "kernel_ms": dev_ms(lambda *a: mha_k.mha_bwd_dq(*a, **kw),
                                       bsets)}
            for i, (bq, bk, hilo) in enumerate(MHA_DQ_TILES):
                for j, dp in enumerate(MHA_DPS):
                    if dp < dh:
                        continue
                    for n in sorted(set(MHA_DQ_SPLITS + [q_splits])):
                        part = torch.empty(n * BH * S * dh, dtype=torch.float32,
                                           device=dev)

                        def kern(q, k, v, do, lse, delta, n=n, part=part,
                                 cfg=i * len(MHA_DPS) + j):
                            dq = torch.empty(q.shape, dtype=torch.float32,
                                             device=dev)
                            lib.check("sweep_mha_dq", so.sweep_mha_dq(
                                cfg, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                dq.data_ptr(), part.data_ptr(), n, BH, H // KV, S,
                                S, dh, int(causal), 0, 0, kw["scale"], stream))
                            return dq
                        got = kern(*bsets[0])
                        err, ok = cs.compare(torch, got, ref_q,
                                             cs.BWD_TOL["bf16"])
                        name = (f"{bq} rows {bk} keys dh {dp}"
                                f"{'' if hilo else ' one-pass'} splits={n}")
                        row[name] = {"ms": dev_ms(kern, bsets), "max_abs_err": err,
                                     "ok": ok, "tol_share": cs.tol_share(
                                         torch, got, ref_q, cs.BWD_TOL["bf16"]),
                                     "expected_miss": None if hilo else
                                     "one pass"}
            result["mha_bwd_dq"].append(row)
            print(f"mha_bwd_dq {label} (plan: {q_splits} splits): kernel "
                  f"{ms_text(row['kernel_ms'])} ms, SDPA backward (dq, dk, dv) "
                  f"{ms_text(row['library_ms'])} ms | " + row_text(row),
                  flush=True)
        del bsets, lsets


def mha_wide_sweep(torch, Fn, lib, so, randn, dev_ms, result, sms):
    """The bf16 ``mha_bwd_dq`` and ``mha_bwd_dkv`` above dh 128 at
    MHA_WIDE_SHAPES: each geometry of MHA_DQ_WIDE and MHA_DKV_WIDE at each
    split count, checked against the plain versions at BWD_TOL (with the
    share of it used; a dk/dv split count whose runs pass the plan's cap of
    ``ref.DKV_RUN_ROWS`` rows may miss: recorded, not failed), against the
    kernels' own plans (through the port's entry points) and SDPA's whole
    backward on the same clock."""
    import chip_smoke as cs
    from repro_torch.kernels.attention import mha as mha_k
    from repro_torch.kernels.attention import ref as mha_ref

    dev = torch.device("cuda")
    code = lib.DTYPE_CODE[torch.bfloat16]
    stream = torch.cuda.current_stream().cuda_stream
    for label, B, S, H, KV, dh, window in MHA_WIDE_SHAPES:
        kw = dict(causal=True, window=window, scale=dh ** -0.5, q_offset=0)
        BH, BKV, group = B * H, B * KV, H // KV
        ok_mask = mha_ref.visible(S, S, causal=True, window=window,
                                  q_offset=0, device=dev)
        per = 2 * (2 * BH + 2 * BKV) * S * dh
        bsets, lsets = [], []
        for _ in range(cs.n_sets(per)):
            q, k, v = (randn((BH, S, dh)), randn((BKV, S, dh)),
                       randn((BKV, S, dh)))
            o, lse = mha_ref.mha_forward_reference(q, k, v, **kw)
            do = randn((BH, S, dh))
            bsets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
            leaves = tuple(t.detach().clone().requires_grad_()
                           for t in (q, k, v))
            lo = Fn.scaled_dot_product_attention(
                *(t.view(B, -1, S, dh) for t in leaves), attn_mask=ok_mask,
                scale=kw["scale"], enable_gqa=True)
            lsets.append((lo, leaves, do.view(lo.shape)))

        def sdpa_b(lo, leaves, g):
            return torch.autograd.grad(lo, leaves, g, retain_graph=True)

        lib_b_ms = dev_ms(sdpa_b, lsets)
        del lsets
        ref_q = mha_ref.mha_bwd_dq_reference(*bsets[0], **kw)
        q_splits, _ = mha_k.dq_plan(code, BH, BKV, S, S, dh, sms)
        row = {"shape": label, "plan_splits": q_splits,
               "library_ms": lib_b_ms,
               "kernel_ms": dev_ms(lambda *a: mha_k.mha_bwd_dq(*a, **kw),
                                   bsets)}
        for i, (bq, bk, wc, st) in enumerate(MHA_DQ_WIDE):
            for n in sorted(set(MHA_DQ_WIDE_SPLITS + [q_splits])):
                part = torch.empty(n * BH * S * dh, dtype=torch.float32,
                                   device=dev)

                def kern(q, k, v, do, lse, delta, n=n, part=part, cfg=i):
                    dq = torch.empty(q.shape, dtype=torch.float32, device=dev)
                    lib.check("sweep_dq256", so.sweep_dq256(
                        cfg, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), part.data_ptr(), n, BH, group, S, S,
                        dh, 1, window, 0, kw["scale"], stream))
                    return dq
                name = (f"{bq} rows {bk} keys {wc} warps a strip {st} "
                        f"stages splits={n}")
                try:
                    got = kern(*bsets[0])
                except RuntimeError as e:   # a launch the card refused
                    torch.cuda.synchronize()
                    row[name] = {"ms": None, "error": str(e), "ok": False}
                    continue
                err, ok = cs.compare(torch, got, ref_q, cs.BWD_TOL["bf16"])
                row[name] = {"ms": dev_ms(kern, bsets), "max_abs_err": err,
                             "ok": ok, "tol_share": cs.tol_share(
                                 torch, got, ref_q, cs.BWD_TOL["bf16"])}
        result["mha_bwd_dq_wide"].append(row)
        print(f"mha_bwd_dq {label} dh {dh} (plan: {q_splits} splits): kernel "
              f"{ms_text(row['kernel_ms'])} ms, SDPA backward (dq, dk, dv) "
              f"{ms_text(lib_b_ms)} ms | " + row_text(row), flush=True)
        del ref_q

        ref_b = mha_ref.mha_bwd_dkv_reference(*bsets[0], **kw)
        b_splits, _ = mha_k.dkv_plan(code, BH, BKV, S, S, dh, sms)
        row = {"shape": label, "plan_splits": b_splits,
               "library_ms": lib_b_ms,
               "kernel_ms": dev_ms(lambda *a: mha_k.mha_bwd_dkv(*a, **kw),
                                   bsets)}
        for i, (bk, bq, wc, st) in enumerate(MHA_DKV_WIDE):
            for n in sorted(set(MHA_DKV_WIDE_SPLITS + [b_splits])):
                part = torch.empty(2 * n * BKV * S * dh, dtype=torch.float32,
                                   device=dev)

                def kern(q, k, v, do, lse, delta, n=n, part=part, cfg=i):
                    dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
                    dv = torch.empty_like(dk)
                    lib.check("sweep_dkv256", so.sweep_dkv256(
                        cfg, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), part.data_ptr(), n, BKV,
                        group, S, S, dh, 1, window, 0, kw["scale"], stream))
                    return dk, dv
                name = (f"{bk} keys {bq} rows {wc} warps a strip {st} "
                        f"stages splits={n}")
                try:
                    got = kern(*bsets[0])
                except RuntimeError as e:   # a launch the card refused
                    torch.cuda.synchronize()
                    row[name] = {"ms": None, "error": str(e), "ok": False}
                    continue
                err, ok = cs.compare(torch, got, ref_b, cs.BWD_TOL["bf16"])
                # the longest run: the key block that sees the most items
                run = max((hi - lo for *_, runs in mha_ref.dkv_runs(
                    S, S, group, causal=True, window=window, q_offset=0,
                    splits=n, block_keys=bk, block_q=bq) for lo, hi in runs),
                    default=0)
                cap = mha_ref.dkv_run_items(bq)
                row[name] = {
                    "ms": dev_ms(kern, bsets), "max_abs_err": err, "ok": ok,
                    "tol_share": cs.tol_share(torch, got, ref_b,
                                              cs.BWD_TOL["bf16"]),
                    "expected_miss": (f"runs of {run} items of {bq} rows"
                                      if run > cap else None)}
        result["mha_bwd_dkv_wide"].append(row)
        print(f"mha_bwd_dkv {label} dh {dh} (plan: {b_splits} splits): kernel "
              f"{ms_text(row['kernel_ms'])} ms, SDPA backward (dq, dk, dv) "
              f"{ms_text(lib_b_ms)} ms | " + row_text(row), flush=True)
        del ref_b, bsets
        torch.cuda.empty_cache()


def int8_sweep(torch, lib, so, gen, dev_ms, result, sms):
    """``matmul_tiled_int8`` at qwen2-7b's fused QKV: each regime's tile
    shapes (I8_TILES) times its split counts (I8_SPLITS), which must equal
    the plain version exactly, against the kernel's own entry at the
    plan's split count and, where it takes the shape, ``torch._int_mm`` +
    the same dequantize on the same clock."""
    import chip_smoke as cs
    from repro_torch.core import quant
    from repro_torch.kernels.qkv import qkv_proj
    from repro_torch.kernels.qkv import ref as qkv_ref

    dev = torch.device("cuda")
    D, F = I8_D, I8_F
    stream = torch.cuda.current_stream().cuda_stream
    tiles = i8_tile_list()

    def operands(T):
        x = torch.randn((T, D), generator=gen, device=dev)
        w = torch.randn((D, F), generator=gen, device=dev) * D ** -0.5
        (xq, sx), (wq, sw) = quant.quantize(x, 1), quant.quantize(w, 0)
        return xq, wq.t().contiguous(), sx, sw, wq

    for regime, T in I8_SHAPES:
        sets = [operands(T)
                for _ in range(cs.n_sets(T * D + 2 * D * F))]
        ref = qkv_ref.matmul_int8_reference(sets[0][0], sets[0][4],
                                            sets[0][2], sets[0][3])
        chosen, _ = qkv_proj._plan_int8(T, D, F, sms)
        row = {"regime": regime, "T": T, "D": D, "F": F,
               "plan_splits": chosen,
               "kernel_ms": dev_ms(lambda xq, wqt, sx, sw, wq:
                                   qkv_proj.matmul_tiled_int8(xq, wqt, sx, sw),
                                   sets),
               "library_ms": dev_ms(
                   lambda xq, wqt, sx, sw, wq: torch._int_mm(xq, wq).to(
                       torch.float32) * sx * sw, sets)
               if T > 16 and T % 8 == 0 else None}
        for tile in I8_TILES[regime]:
            cfg = tiles.index(tile)
            for n in I8_SPLITS[regime]:
                part = torch.empty(n * T * F, dtype=torch.int32, device=dev)

                def kern(xq, wqt, sx, sw, wq, n=n, part=part, cfg=cfg):
                    out = torch.empty((T, F), dtype=torch.float32, device=dev)
                    lib.check("sweep_int8", so.sweep_int8(
                        cfg, xq.data_ptr(), wqt.data_ptr(), sx.data_ptr(),
                        sw.data_ptr(), out.data_ptr(), part.data_ptr(), n, T,
                        D, F, stream))
                    return out
                got = kern(*sets[0])
                name = "{}x{}x{} w{}x{} s{}".format(*tile) + f" splits={n}"
                row[name] = {"ms": dev_ms(kern, sets),
                             "ok": bool(torch.equal(got, ref))}
        result["matmul_tiled_int8"].append(row)
        print(f"matmul_tiled_int8 T={T} D={D} F={F} (plan: {chosen} "
              f"splits): kernel {ms_text(row['kernel_ms'])} ms, _int_mm + "
              f"dequantize {ms_text(row['library_ms'])} ms | "
              + row_text(row), flush=True)
        del sets



def device_ms_by_kernel(torch, fn, sets, iters):
    """Mean device ms per call of ``fn`` for each kernel it launches, by
    the profiler (names shortened to the function name)."""
    from torch.profiler import ProfilerActivity, profile

    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", None)
              or getattr(ev, "self_cuda_time_total", 0))
        if us:
            name = ev.key.split("(")[0].split("<")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return out


# mla_decode: (rows, cache rows a slot, lengths) of the correctness rows,
# then the kimi-k2-instruct cell's decode step (128 slots over 3k-17k
# latent rows of a 17408-row cache), timed at each L and the plan's
MLA_CHECKS = ((3, 300, [1, 63, 65]), (4, 4200, [64, 2048, 2049, 4200]),
              (2, 17408, [17408, 3072]))
MLA_TIMED = (128, 17408, "uniform 3072 17407")
MLA_L = (256, 512, 1024, 2048)


def mla_sweep(torch, lib, randn, dev_ms, result, sms):
    """``mla_decode`` (bf16, 64 heads of 576 / 512): at MLA_CHECKS against
    the plain version (f32 of the same bf16 inputs, unrounded) and the
    kernel's split mirror, relaunched bit-identically; then the cell's
    decode step at each L of MLA_L and the plan's, each with its share of
    the byte bound (every live latent row read once, q and out)."""
    import chip_smoke as cs
    from repro_torch.kernels.decode import mla_decode as mla
    from repro_torch.kernels.decode import ref as dec_ref

    dev = torch.device("cuda")
    scale = 0.1309
    for R, Skv, lens in MLA_CHECKS:
        q = randn((R, mla.HEADS, mla.DK), 0.05)
        kv = randn((R, Skv, mla.DK))
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = mla.mla_decode(q, kv, ln, scale=scale, dv=mla.DV)
        again = mla.mla_decode(q, kv, ln, scale=scale, dv=mla.DV)
        plain = dec_ref.mla_decode_reference(q.float(), kv.float(), ln,
                                             scale=scale, dv=mla.DV)
        L, _ = mla.plan(R, Skv, sms)
        mirror = dec_ref.mla_decode_split_reference(
            q.cpu(), kv.cpu(), ln.cpu(), scale=scale, dv=mla.DV, L=L).to(dev)
        err, ok = cs.compare(torch, out, plain, cs.DECODE_NEW_TOL["bf16"])
        merr, mok = cs.compare(torch, out, mirror, cs.DECODE_NEW_TOL["bf16"])
        row = {"R": R, "Skv": Skv, "lens": lens, "L": L,
               "plain": {"ms": None, "max_abs_err": err, "ok": ok},
               "mirror": {"ms": None, "max_abs_err": merr, "ok": mok},
               "relaunch": {"ms": None, "ok": bool(torch.equal(out, again))}}
        result["mla_decode"].append(row)
        print(f"mla_decode check R={R} Skv={Skv} lens={lens} L={L}: plain "
              f"err {err:.2e} ok {ok} | mirror err {merr:.2e} ok {mok} | "
              f"relaunch equal {row['relaunch']['ok']}", flush=True)
    R, Skv, spec = MLA_TIMED
    lens = dec_lens(spec, R)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    nbytes = 2 * (sum(lens) * mla.DK + R * mla.HEADS * (mla.DK + mla.DV))
    bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
    sets = [(randn((R, mla.HEADS, mla.DK), 0.05), randn((R, Skv, mla.DK)))
            for _ in range(2)]
    plan_L, _ = mla.plan(R, Skv, sms)
    mask = (torch.arange(Skv, device=dev)[None, :]
            < ln[:, None])[:, None, None, :]

    def library(q, kv):
        # SDPA on the absorbed form: the 64 query heads as 64 queries of
        # one head over the latent rows (keys the whole row, values its
        # first 512 columns), so nothing is repeated per head
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, None], kv[:, None], kv[:, None, :, :mla.DV],
            attn_mask=mask, scale=scale)

    def plain(q, kv):
        return dec_ref.mla_decode_reference(q, kv, ln, scale=scale,
                                            dv=mla.DV)
    row = {"R": R, "Skv": Skv, "lens": spec, "plan_L": plan_L,
           "bound_ms": bound_ms, "library_ms": dev_ms(library, sets),
           "plain_ms": dev_ms(plain, sets[:1])}
    for L in sorted(set(MLA_L) | {plan_L}):
        # the C entry at this L, its workspace decode_split.cuh's
        # decode_ws_elems at 64 heads of 512 (the serving wrapper takes L
        # and the workspace from the plan)
        ws = torch.empty(R * mla.HEADS * -(-Skv // L) * (mla.DV + 2),
                         dtype=torch.float32, device=dev)
        out = torch.empty((R, mla.HEADS, mla.DV), dtype=torch.bfloat16,
                          device=dev)

        def kern(q, kv, L=L, ws=ws, out=out):
            lib.check("famous_mla_decode", lib.load().famous_mla_decode(
                q.data_ptr(), kv.data_ptr(), ln.data_ptr(), out.data_ptr(),
                ws.data_ptr(), R, Skv, kv.stride(0), L, scale,
                lib.stream_of(q)), ws)
            return out
        ms = dev_ms(kern, sets)
        row[f"L={L}"] = {"ms": ms, "bound_pct": None if not ms
                         else 100.0 * bound_ms / ms}
    result["mla_decode"].append(row)
    print(f"mla_decode R={R} Skv={Skv} lens {spec} (plan L={plan_L}, bound "
          f"{bound_ms:.4f} ms, SDPA {ms_text(row['library_ms'])}, plain "
          f"{ms_text(row['plain_ms'])}): " + " | ".join(
              f"{k} {ms_text(v['ms'])} ({v['bound_pct'] or 0:.1f}%)"
              for k, v in row.items() if isinstance(v, dict)), flush=True)


def scan_sweep(torch, so, gen, iters, result, parts):
    """``wkv6_scan`` and ``rglru_scan`` variants (WKV_VARIANTS,
    RGLRU_VARIANTS) at their shapes against the first design (cfg 0) and
    the kernels' own entry points, by profiler device time, each pass of
    wkv6 apart; wkv6 within the bf16 gate of the plain version, rglru bit
    for bit."""
    import chip_smoke as cs
    from repro_torch.kernels.scan import linear_scan
    from repro_torch.kernels.scan import ref as scan_ref

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    f32, bf = torch.float32, torch.bfloat16

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    for label, BH, S, dh, C in WKV_SHAPES if "wkv6" in parts else ():
        def operands():
            r, k, v = (randn((BH, S, dh), bf, 0.5) for _ in range(3))
            logw = -torch.exp(torch.clamp(randn((BH, S, dh), f32), -20, 0))
            return r, k, v, logw, randn((BH, dh), f32, 0.5), randn(
                (BH, dh, dh), f32)
        sets = [operands()
                for _ in range(cs.n_sets(3 * BH * S * dh * 2 + 4 * BH * S * dh))]
        ref = scan_ref.wkv6_chunked_reference(*sets[0], chunk=C)
        own = device_ms_by_kernel(
            torch, lambda *a: linear_scan.wkv6_scan(*a, chunk=C), sets, iters)
        row = {"shape": label, "BH": BH, "S": S, "dh": dh, "chunk": C,
               "kernel": {"ms": sum(own.values()), "passes": own}}
        for cfg in range(len(WKV_VARIANTS) + 1):
            qws = cfg == 0 or WKV_VARIANTS[cfg - 1][5]
            n_ws = BH * (S // C) * (dh * dh + dh + (C * dh if qws else 0))
            ws = torch.empty(n_ws, dtype=f32, device=dev)

            def kern(r, k, v, logw, u, s0, cfg=cfg, ws=ws):
                out = torch.empty((BH, S, dh), dtype=f32, device=dev)
                sf = torch.empty((BH, dh, dh), dtype=f32, device=dev)
                lib_check = so.sweep_wkv6(
                    cfg, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                    logw.data_ptr(), u.data_ptr(), s0.data_ptr(),
                    out.data_ptr(), sf.data_ptr(), ws.data_ptr(), BH, S, dh,
                    C, stream)
                if lib_check:
                    raise RuntimeError(f"sweep_wkv6 cfg {cfg}: {lib_check}")
                return out, sf
            err, ok = cs.compare(torch, kern(*sets[0]), ref, cs.TOL["bf16"])
            passes = device_ms_by_kernel(torch, kern, sets, iters)
            name = ("first design" if cfg == 0 else
                    "rows {} cols {} threads {} | state cols {} threads {} "
                    "{}".format(*WKV_VARIANTS[cfg - 1][:5],
                        "qexp ws" if qws else "recompute"))
            row[name] = {"ms": sum(passes.values()), "passes": passes,
                         "max_abs_err": err, "ok": ok}
        result["wkv6_scan"].append(row)
        print(f"wkv6_scan {label} BH={BH} S={S} dh={dh} chunk={C}: kernel "
              f"{ms_text(row['kernel']['ms'])} ms | " + " | ".join(
                  f"{k} {ms_text(v['ms'])} ("
                  + ", ".join(f"{n} {ms_text(t)}" for n, t in v["passes"].items())
                  + ")" + ("" if v.get("ok", True) else " WRONG")
                  for k, v in row.items()
                  if isinstance(v, dict) and "passes" in v and k != "kernel"),
              flush=True)
        del sets

    for label, B, S, R in RGLRU_SHAPES if "rglru" in parts else ():
        sets = [(torch.sigmoid(randn((B, S, R), f32)), randn((B, S, R), f32,
                                                             0.1))
                for _ in range(cs.n_sets(2 * B * S * R * 4))]
        ref = scan_ref.rglru_reference(*sets[0])
        row = {"shape": label, "B": B, "S": S, "R": R,
               "kernel": {"ms": cs.device_ms(torch, linear_scan.rglru_scan,
                                             sets, iters)}}
        for cfg in range(len(RGLRU_VARIANTS) + 1):
            def kern(a, b, cfg=cfg):
                out = torch.empty((B, S, R), dtype=f32, device=dev)
                err = so.sweep_rglru(cfg, a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), B, S, R, stream)
                if err:
                    raise RuntimeError(f"sweep_rglru cfg {cfg}: {err}")
                return out
            name = ("first design" if cfg == 0 else
                    "F {} P {} L {}".format(*RGLRU_VARIANTS[cfg - 1]))
            row[name] = {"ms": cs.device_ms(torch, kern, sets, iters),
                         "ok": bool(torch.equal(kern(*sets[0]), ref))}
        result["rglru_scan"].append(row)
        print(f"rglru_scan {label} B={B} S={S} R={R}: kernel "
              f"{ms_text(row['kernel']['ms'])} ms | " + row_text(
                  {k: v for k, v in row.items() if k != "kernel"}),
              flush=True)
        del sets


if __name__ == "__main__":
    sys.exit(main())
