#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--iters N]

Phases, in order; any failure exits non-zero before the result line:

  1. the card's name and power limit (``nvidia-smi``);
  2. build: every CUDA source under ``src/repro_torch/kernels/csrc`` is
     compiled for sm_90a into one shared library (``build/``);
  3. kernels: each hand-written kernel against its plain PyTorch version,
     in f32 and bf16 (the int8 projection on int8 operands, exactly), with
     the kernel's, the plain version's and one
     library call's time (CUDA events, inputs rotated through more than
     the 50 MB L2; where the kernel's profiled device time is under
     30 us, that time of the whole call, second pass included, for both
     the kernel and the library call), and the least time the card could take
     (bytes over 3.35 TB/s or operations over the type's peak).  Serving
     shapes of qwen2-7b for ``matmul_tiled`` (T = 4, 256, 1, 17, 100; also
     recurrentgemma-2b's D=2560 F=3072 and a D, F off multiples of 8),
     ``matmul_tiled_int8`` (T = 4 decode, 20 verify, 256 chunk),
     ``decode_attention`` (also as verify rows, 5 per slot, at
     recurrentgemma-2b's 10 / 1 heads of 256, and at lengths on its range
     boundaries with an empty row, which must be exactly 0 and match the
     plain mirror of the split-and-combine algebra) and ``chunk_prefill``
     (offsets 0, 1792 and 1000, the last in bf16 also against the plain
     mirror of its tensor-core algebra); ``matmul_tiled``,
     ``decode_attention``, ``chunk_prefill`` and the paged kernels
     relaunched on the same inputs must give the same bits; and for the
     four paged kernels (fp and int8 pools, a 513-page pool of 16-token
     pages; the decode kernels also at their range boundaries, with the
     empty row exactly 0 and the paged split mirror, and as verify rows
     reading each slot's page-table row in place; the bf16 chunk kernels
     also at offset 1000 against the paged tensor-core mirror, and on
     identity pages over a contiguous cache, where they must give
     ``chunk_prefill``'s bits; no library call reads a page table, so
     they have no library time); training shapes of
     famous-bert (B=8, S=512, 8 heads, dh=96, non-causal) and qwen2-7b
     (B=1, S=2048, 28/4 heads, dh=128, causal) for ``mha_forward``,
     ``mha_bwd_dq``, ``mha_bwd_dkv`` and ``matmul_tiled`` in its dX / dW
     roles (the attention kernels also at MASK_ATTN's masks, one of them
     8192 causal tokens on one kv head, and at recurrentgemma-2b's local
     attention, 10 / 1 heads of 256 over 4096 tokens in a 2048-token
     window; each relaunched for bit identity, in bf16 held to the mirror
     of its tensor-core algebra, the backward plans' longest runs within
     their caps); and the two linear-recurrence kernels at their serving
     shapes and at prompt length (``rglru_scan``: recurrentgemma-2b's
     256-token chunk and a 4096-token prompt, B=1, R=2560, bit-equal to the
     plain version; ``wkv6_scan``: rwkv6-1.6b's chunk and a 2048-token
     prompt, B·H=32, dh=64, chunk 64, without and with a carried state, out
     and final state checked; both relaunched for bit identity);
  4. Table I: the paper's topology (SL=64, d_model=768, h=8) through
     ``famous.qkv_projection`` + ``famous.attention`` with impl reference,
     xla and pallas; the three must agree; then ``mha_block`` with the
     paper's 8-bit projection (``quant="int8"``): the kernel's projection
     must equal plain torch ops' exactly;
  5. slice parity: a 2-layer cut of qwen2-7b at full width runs
     ``prefill_chunk`` + ``decode_step`` through the kernels
     (``impl="pallas"``) and through plain torch ops (``impl="xla"``) on
     the same weights, on contiguous caches, on paged pools and (bf16) on
     int8 pools, and with the int8 projection; the logits must agree, and
     at f32 the paged kernels' logits must agree with the contiguous
     kernels'; then ``verify_step`` (5 tokens a slot, run under
     ``set_sync_debug_mode("error")``: no device->host copy) must give the
     logits of 5 sequential ``decode_step`` calls at f32 on contiguous,
     paged and int8 pools;
  6. training parity: the same 2-layer cut, one ``make_train_step``
     gradient through ``impl="pallas"`` and ``impl="xla"`` on one state
     and batch, in f32 and bf16 compute; loss, global gradient norm and
     every gradient leaf must agree;
  7. training runs through ``launch.train.build`` + ``Trainer``:
     famous-bert at full size (12 layers, B=8, S=512, bf16, 30 steps,
     checkpoints every 10 into a temporary directory; the loss must fall)
     and qwen2-7b at full width with 2 layers (B=1, S=2048, 5 steps);
  8. serving: the full 28-layer qwen2-7b in bf16, random weights made on
     the card from ``--seed``, serves 8 greedy requests through
     ``ServingEngine.run``; then 8 requests that share a 1024-token system
     prompt, on contiguous KV, on the paged pool with the prefix cache, and
     on int8 pools with the prefix cache (requests 4-7 must hit the cached
     prompt, and only the paged kernels may serve attention there); the
     first 8 requests again with the int8 projection (``FamousConfig(
     quant="int8")``: only ``matmul_tiled_int8`` may project); the shared-
     prefix traffic speculatively (``draft_k=4``) on the paged pool with
     the prefix cache, with the fp and the int8 projection; and a 2-layer
     full-width f32 run whose drafter proposes the plain run's own tokens
     (every draft accepted; the tokens must equal the plain run's).
     Every run but the last is a graph parity pair: it runs once under
     ``graphs.disable_capture()`` (every step eager) and once with the
     decode or verify step and its sampler replayed as CUDA graphs (the
     main path); the tokens and the kernel launch counts (replays
     included) must be identical, the graph engine must have captured its
     step, its census must show at most 3 per kind, and, warmed, it must
     serve 4 fresh requests inside ``retrace_guard`` without a new
     capture.  Warm-up and capture run under ``torch.cuda.
     set_sync_debug_mode("error")`` (checked to raise on a device->host
     copy), so a step that syncs fails there;
  9. recurrent slice parity: one (RG-LRU, RG-LRU, local attention) unit
     of recurrentgemma-2b and two RWKV-6 layers of rwkv6-1.6b at full
     width through ``prefill_chunk`` + ``decode_step``, kernels against
     plain torch ops, f32 and bf16; the recurrentgemma prompt (2300 tokens,
     9 chunks) wraps its 2048-token ring, and an inactive slot's recurrent
     state must not move during decode;
 10. recurrent serving: recurrentgemma-2b (max_seq 4096, prompts of
     88-3600 tokens, three past the window) and rwkv6-1.6b (max_seq 2048)
     at full depth in bf16, 8 greedy requests each, with launch counts
     checked per chunk and decode step, each a graph parity pair as in 8;
 11. monolithic slice parity (f32, full width, cut depth): slot 1
     prefilled by ``transformer.prefill`` + ``write_prefill_to_slot``,
     then 2 decode steps, kernels against plain torch ops and against
     ``prefill_chunk`` (qwen2-7b on contiguous, paged and int8 pools; a
     recurrentgemma-2b unit past its ring; rwkv6-1.6b at 640 and 37
     prefilled tokens), and the dense zoo's 2-layer cuts (qwen3-32b,
     deepseek-7b, command-r-plus-104b) through ``prefill_chunk``, kernels
     against plain, on contiguous caches and int8 pools;
 12. monolithic serving: a 1024-token qwen2-7b prefill against its 4
     chunks (profiled), then graph parity pairs with
     ``prefill_mode="monolithic"`` at full depth: qwen2-7b (two prompts
     in each of 4 buckets; contiguous, paged, int8 pools), recurrentgemma-
     2b and rwkv6-1.6b (4 exact lengths twice); the prefill census must
     equal the 4 lengths served twice and each prefill launch
     ``mha_forward`` / the scans once a layer; the same qwen2-7b prompts
     chunked for this call's tok/s and TTFT beside;
 13. dense zoo serving, chunked graph parity pairs at full width:
     deepseek-7b (30 layers), qwen3-32b (16 of 64 layers; also paged int8
     with the prefix cache) and command-r-plus-104b (4 of 64 layers);
 14. runtime programmability: one ``FlexibleAttention`` at the demo's
     maxima (8 heads, 128 tokens, dh 96) per dtype runs
     ``examples/flexible_serving.py``'s eight topologies on one captured
     graph (``compilations == 1``; a ninth inside ``retrace_guard``), each
     against the plain ``attention_reference`` at its exact shape (2e-5
     f32, 2e-2 bf16), with each topology's replay time beside one
     exact-shape plain call; a ``BucketCache`` over the demo's lengths
     misses once per distinct bucket;
 15. MoE and vlm slice parity at full width, kernels against plain torch
     ops through ``prefill_chunk`` + ``decode_step``: grok-1-314b (2
     layers) and llava-next-34b (2 layers) at f32, kimi-k2-1t-a32b (1
     layer) in bf16 and with f32 compute on its bf16 expert stacks;
     tokens whose routing differs between the two runs are counted (under
     1% with f32 compute, reported in bf16) and the logits they do not
     reach held at the slice tolerance;
 16. MoE and vlm serving, chunked graph parity pairs at full width, bf16:
     grok-1-314b (4 of 64 layers; contiguous, then paged int8 KV with the
     prefix cache), kimi-k2-1t-a32b (1 of 61 layers) and llava-next-34b's
     backbone (30 of 60 layers), each with its peak memory;
 17. training on the stub frontends' embeddings through
     ``launch.train.build`` + ``Trainer``: hubert-xlarge at full size (48
     layers, B=8, S=512, 10 steps; the loss must fall) and llava-next-34b
     (2 layers, B=1, S=2048, 5 steps); then one grok-1-314b layer's
     train-step loss and gradient (S=2048, f32), kernels against plain;
 18. tensor-parallel serving (``ServingEngine(mesh=...)``): 18a, the full
     28-layer qwen2-7b in bf16 on phase 8's prompts with
     ``mesh=make_serving_mesh(tp=1)`` over a process group of one rank,
     a graph parity pair whose tokens, final caches (bit for bit),
     census, kernel launches and cache bytes must equal the ``mesh=None``
     engine's on the same weights, then its ``step_breakdown``; the same
     pairs for grok-1-314b at 4 of 64 layers and the full 24-layer
     rwkv6-1.6b; 18b, 2-layer qwen2-7b (contiguous, then paged), one
     recurrentgemma-2b unit, one grok-1-314b layer (experts split over
     the ranks; contiguous, then paged) and 2 rwkv6-1.6b layers
     (contiguous, then paged) at full width in f32, each rank drawing
     its weights leaf by leaf and keeping only its shards, served on a
     mesh of one rank here and on TP=2 and TP=4 meshes of spawned ranks
     sharing the card over gloo, eagerly (a gloo sum cannot be
     captured): every rank's tokens must equal TP=1's, every serving
     kernel of the slice must launch on every rank with no plain version
     run, qwen2-7b's and grok-1's cache bytes a rank times TP must equal
     TP=1's, and rwkv6-1.6b's be TP=1's with the wkv state cut TP ways;
     each slice's peak memory a rank and each spawn's seconds are
     printed; the same ranks then serve, eagerly in f32, 18c: 2-layer
     qwen2-7b (contiguous, paged) and one grok-1-314b layer under
     TP_ONLY_RULES (the vocabulary tables cut over "model"; each rank's
     weights held, drawing and serving, printed), 18d: 2-layer qwen2-7b
     under ZERO_SEQ_RULES on model=2 and DEFAULT_RULES on (data=2,
     model=2) (every gathered leaf gathered at each step), and 18e:
     replica groups under SERVE_TP_RULES on (data=2) and (data=2,
     model=2), 2-layer qwen2-7b (contiguous, paged) and one
     recurrentgemma-2b unit: every rank's tokens must equal TP=1's (18e:
     a contiguous cache's bytes a rank half of one group's, a paged one's
     equal), every serving kernel launched on every rank, no plain
     version run; each run's seconds are printed;
 19. duplicate page ids in monolithic paged prefill: 20 scatters of a
     stripe whose page-table row names the null page 126 times must leave
     every page its last stretch, and a shrunk grok-1-314b served
     monolithic on a paged pool must give the same tokens eager and as
     graphs;
 20. sharded training (``make_train_step(mesh=)`` through
     ``launch.train.build``): 20a, famous-bert at full size (B=8, S=512,
     bf16, 5 steps) on a (data=1, model=1) mesh over a process group of
     one rank against ``mesh=None``: equal losses, the final state bit
     for bit and equal launch counts, both median steps printed; then
     one-rank f32 references (famous-bert 3 steps; 2-layer qwen2-7b,
     B=1, S=2048, 2 steps) and ranks spawned sharing the card over gloo:
     famous-bert on (data=2), (model=2), (pod=2) and (data=2, model=2)
     meshes under DEFAULT_RULES (20b), the data=2 run's step-2
     checkpoint restored by ``elastic.reshard_restore`` on model=2 for
     step 3, qwen2-7b at TP=2 under TP_ONLY_RULES (20c), and on model=2
     under DEFAULT_RULES recurrentgemma-2b's 2 units and rwkv6-1.6b's 2
     layers (B=1, S=2048, 2 steps; 20d); 20c and recurrentgemma-2b's
     20d take the vocab-parallel embedding, head and loss (each rank's
     vocabulary range printed).  On every
     rank each step's loss within 1e-5 and grad norm within 1e-4 of the
     reference (relative), the parameters after the last step within
     1e-4 of each leaf's norm, every training kernel launched and
     no plain version run; each rank's peak memory and each run's
     seconds are printed;
 21. analysis (``repro_torch.analysis``): (a) ``python -m
     repro_torch.analysis`` in this process (lint, the launch-contract
     check of every kernel family at tiny shapes, the retrace guard on
     three warmed engines) must exit 0; (b) every kernel row of phase 3
     was relaunched once, untimed, with the contract checker on: no row
     may have a violation, and each kernel's main-path row, its dh-256
     rows and another row whose grid writes a workspace (split partials
     or a second pass's input) print every launch's grid, threads,
     dynamic + static shared memory against the budget, registers and
     workspace;
     (c) with the budget lowered to 48 KB the checker must refuse a
     main-path launch that (b) shows needs more; (d) ``analytical.H100``'s
     shared memory a block and SM count must equal the device's, and the
     fixed cost of a kernel in a replayed CUDA graph is printed beside the
     spec's launch latency; (e) the §VII model's predictions on
     ``analytical.H100`` (autotuned tiles) are printed beside phase 3's
     events: Table I's QKV_PM against ``matmul_tiled`` at T=64, D=768,
     F=2304, its QK + SV against ``mha_forward`` (1 x 64 tokens, 8 heads of
     96, full), and qwen2-7b's chunk (C=256 at offset 1792, 28 / 4 heads)
     against ``chunk_prefill``; (f) ``examples/quickstart_torch.py`` runs as
     a subprocess and must exit 0;
 22. dry run (``repro_torch.launch.dryrun``): (a) the CLI in two
     subprocesses, started together, on qwen2-7b ``decode_32k`` and
     ``train_4k`` over a fake 256-rank pod1 group: each must print ``ALL
     CELLS PASSED``; each cell's memory a device, dominant term, roofline
     fraction and useful-FLOP ratio are printed; (b) the dry run's
     prediction against the same step on the card (``impl="xla"``, no
     mesh): full-width qwen2-7b's serving decode step (4 slots, max_seq
     2048, bf16 weights) and a 2-layer training step (B=1, S=2048, f32
     parameters), each counted on ``meta`` tensors by ``op_cost``, then
     run with its arguments resident under ``FlopCounterMode`` after
     ``reset_peak_memory_stats``: the FLOPs must be equal, the
     arguments' bytes must equal the real arguments' summed ``nbytes``,
     and the predicted peak (arguments + ``peak_bytes``) must lie within
     25% of ``max_memory_allocated`` less what was allocated before the
     arguments were made (printed); (c) the decode step's ``t_bound`` on
     ``analytical.H100`` beside its time by CUDA events with
     ``impl="pallas"`` (``matmul_tiled`` and ``decode_attention``), eager
     and as a CUDA graph replay, ungated.

The bf16 rows of the decode kernels at recurrentgemma-2b's heads and at
their range boundaries (contiguous and paged, against the plain version
and the split mirrors) are gated per element in ulps (ULP_GATE); the
tensor-core mirrors' rows are held at DECODE_NEW_TOL against the
mirror's unrounded output, their ulps printed.

The kernel phase also holds the serving kernels at the zoo's head layouts
(qwen3-32b's 64 / 8 heads of 80, deepseek-7b's 32 / 32 and
command-r-plus-104b's 96 / 8 of 128, bf16) and the MoE / vlm configs'
(kimi-k2-1t-a32b's 64 / 8 of 112, grok-1-314b's 48 / 8 and
llava-next-34b's 56 / 8 of 128), the MHA kernels at a ragged 1292 tokens
of recurrentgemma-2b's local attention and at hubert-xlarge's training
shape (B=8, S=512, 16 / 16 heads of 80, non-causal), and a
tensor-parallel rank's shapes (phase 18): ``matmul_tiled`` at qwen2-7b's
fused widths 2304 (TP=2) and 1152 (TP=4), the serving kernels at its 14 /
2 and 7 / 1 heads of 128, ``rglru_scan`` at R=1280; a TP=2 famous-bert
training rank's (phase 20): the MHA kernels at 4 / 4 heads of 96 and
``matmul_tiled`` with its VJP at T=4096, D=768, F=1152; the MoE and
recurrent families' rank shapes (phases 18 and 20): ``matmul_tiled`` at
grok-1's fused widths 4096 (TP=2) and 2048 (TP=4), the serving kernels
at its 24 / 4 and 12 / 2 heads of 128, ``wkv6_scan`` at 16 and 8 heads
of the 256-token chunk, and the MHA kernels at a recurrentgemma-2b
training rank's 5 / 1 heads of 256 (S=2048, window 2048); a replica
group's (phase 18e): ``matmul_tiled`` at T=2 (2 of 4 slots) and the
decode kernel at B=2 on qwen2-7b's 28 / 4 and 14 / 2 and
recurrentgemma-2b's 10 / 1 and 5 / 1 heads; training
parity also a recurrentgemma-2b unit (S=3072) and 2 qwen3-32b layers;
the training runs also recurrentgemma-2b (2 units) and rwkv6-1.6b (2
layers) at B=1, S=2048.

``step_breakdown`` times one decode step and one prefill chunk of a
serving engine's model eagerly, and the decode step again as a CUDA graph
(a speculative engine also its verify step, eager and as a graph): CUDA
events against profiled device time.

The launch counters are set to 0 before each run of phases 7, 8, 10, 12,
13, 16, 17, 18, 19 and 20 and read after it: every kernel must have launched on those paths and no plain
version may have run on the card.  Each phase prints its seconds.  The
last three lines of output are the per-kernel JSON record
(``{"kernels": [...]}``), the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
# dense bf16 and int8 tensor core; f32 FMA
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
TOL = {"f32": 1e-4, "bf16": 2e-2}             # kernel vs plain, atol = rtol
ATTN_TOL = {"f32": 2e-5, "bf16": 2e-2}
# the decode rows added with the split kernel (recurrentgemma-2b's heads,
# range-boundary lengths, the split mirrors, contiguous and paged) and the
# chunk kernel against its tensor-core mirror: bf16 at a tenth of ATTN_TOL
DECODE_NEW_TOL = {"f32": ATTN_TOL["f32"], "bf16": 2e-3}
# the bf16 gate of those rows whose kernels compute in f32 on the CUDA
# cores (decode and paged decode, against the plain version and the split
# mirror), per element in ulps (``lib.ulp_gate``): the kernel's bf16
# output within half a bf16 ulp of the unrounded f32 output of the same
# bf16 inputs, plus the f32 gate.  A kernel that rounds its f32 result
# once always passes; one a whole ulp off does not.  The tensor-core
# mirrors (chunk, paged chunk, MHA forward) keep DECODE_NEW_TOL["bf16"],
# now against the mirror's unrounded output: the mirror rounds P to bf16
# from exp2 where the kernel uses ex2.approx, so a correct kernel's f32
# result can sit a flipped P rounding away from the mirror's (7.1e-4 on
# an output near 0 at chunk offset 1000), past any f32 allowance; their
# error past 2e-5 in ulps is printed beside, ungated
ULP_GATE_ATOL = DECODE_NEW_TOL["f32"]
ULP_GATE = f"0.5 ulp past {ULP_GATE_ATOL:g}"
L2_BYTES = 50 * 2**20
BWD_TOL = {"f32": 1e-4, "bf16": 1e-4}          # f32 math on the same inputs
# the bf16 dq and dk/dv kernels against the plain mirrors of their
# tensor-core algebra (the same hi + lo products; the f32 summation order
# and ex2.approx differ): BWD_TOL, since the order alone moves qwen2-7b's
# dk by 4.4e-5 (the f32 kernel against the plain version, PERF.md)
BWD_MIRROR_TOL = BWD_TOL["bf16"]
# the bf16 forward against its mirror: the output on the rows that see at
# least 256 keys, the LSE on every row.  Kernel and mirror round P to bf16
# from f32 values an ulp or two apart (ex2.approx against exp2), and a
# flipped rounding moves a row's output by up to 2^-8 p |v| / l: with
# unit-variance scores l is about 6 at 64 keys (where qwen2-7b's rows used
# 0.85 of 2e-3 on an H100) and about 16 at 256
MIRROR_MIN_KEYS = 256
SERVING_KERNELS = ("matmul_tiled", "decode_attention", "chunk_prefill")
PAGED_KERNELS = {"fp": ("paged_decode_attention", "paged_chunk_prefill"),
                 "int8": ("paged_decode_attention_int8",
                          "paged_chunk_prefill_int8")}
TRAINING_KERNELS = ("matmul_tiled", "mha_forward", "mha_bwd_dq",
                    "mha_bwd_dkv")
# the RG-LRU scan against its plain version: one f32 add and multiply per
# step on the same inputs, in the same order; also held to be bit-equal
RGLRU_TOL = {"f32": 1e-5, "bf16": 2e-2}
# the scans' prompt-length rows: rglru 4096 tokens (recurrentgemma-2b's
# max_seq), wkv6 2048 (rwkv6-1.6b's)
SCAN_LONG = {"rglru_scan": 4096, "wkv6_scan": 2048}
# a kernel whose profiled device time is under this is timed by it, and so
# is its library call (each call's kernels summed): CUDA events over
# back-to-back launches read the host's launch rate there
DEVICE_TIME_UNDER_MS = 0.03
REPLACES = {
    "matmul_tiled": "src/repro/kernels/qkv/qkv_proj.py:71",
    "matmul_tiled_int8": "src/repro/kernels/qkv/qkv_proj.py:129",
    "decode_attention": "src/repro/kernels/decode/decode_attn.py:276",
    "chunk_prefill": "src/repro/kernels/decode/chunk_prefill.py:91",
    "mha_forward": "src/repro/kernels/attention/mha.py:122",
    "mha_bwd_dq": "src/repro/kernels/attention/mha.py:262",
    "mha_bwd_dkv": "src/repro/kernels/attention/mha.py:282",
    "paged_decode_attention": "src/repro/kernels/decode/decode_attn.py:193",
    "paged_decode_attention_int8":
        "src/repro/kernels/decode/decode_attn.py:249",
    "paged_chunk_prefill": "src/repro/kernels/decode/chunk_prefill.py:189",
    "paged_chunk_prefill_int8":
        "src/repro/kernels/decode/chunk_prefill.py:285",
    "rglru_scan": "src/repro/kernels/scan/linear_scan.py:57",
    "wkv6_scan": "src/repro/kernels/scan/linear_scan.py:127",
}
# the paged int8 kernels are instantiations in their fp kernels' sources;
# the int8 projection has a source of its own
SOURCES = {name: "src/repro_torch/kernels/csrc/" + (
    f"{name}.cu" if name.startswith("matmul") else
    f"{name.removesuffix('_int8')}.cu") for name in REPLACES}
# the QKV projection's serving rows (T, D, F): qwen2-7b at decode (T=4),
# a chunk (256), one row, a speculative verify past 16 rows (17) and a
# ragged last chunk (100); recurrentgemma-2b's; and a D and F that are not
# multiples of 8 (the kernel's element-by-element tile loads)
SERVING_PROJ = tuple((T, 3584, 4608) for T in (4, 256, 1, 17, 100)) + (
    (4, 2560, 3072), (256, 2560, 3072), (4, 3581, 4603), (100, 3581, 4603))
# the fused projection's per-rank widths under tensor parallelism:
# qwen2-7b's 14 + 2 x 2 heads of 128 a rank at TP=2, 7 + 2 x 1 at TP=4,
# at decode (T=4) and a chunk (256)
TP_PROJ = tuple((T, 3584, F) for F in (2304, 1152) for T in (4, 256))
# the training shapes of the attention kernels:
# name, B, S, H, KV, dh, causal
TRAIN_ATTN = (("famous-bert", 8, 512, 8, 8, 96, False),
              ("qwen2-7b", 1, 2048, 28, 4, 128, True),
              # hubert-xlarge's encoder: 16 / 16 heads of 80, bidirectional
              ("hubert-xlarge", 8, 512, 16, 16, 80, False))
# the masks of the bf16 tensor-core bodies on qwen2-7b's heads: name, B,
# Sq, Skv, H, KV, dh, causal, window, q_offset.  A 512-key window; the
# last 128 rows of a 4096-token sequence (few row blocks, so the forward
# splits its key range and its combine writes the LSE, and dq splits its
# rows' keys for occupancy); a window whose rows 27-63 see no key (their
# output and dq must be exactly 0 and their LSE finite, near -1e30); and
# one kv head's 7 query heads over 8192 causal tokens, where the backward
# plans need their run caps most: dk/dv 14 runs of a key block's 896
# items, dq 2 runs of a row's 8192 keys (the plain version's (7, 8192,
# 8192) f32 tensors come to about 8 GB)
MASK_ATTN = (("qwen2-7b window=512", 1, 2048, 2048, 28, 4, 128, True, 512, 0),
             ("qwen2-7b q_offset=3968", 1, 128, 4096, 28, 4, 128, True, 0,
              3968),
             ("qwen2-7b empty rows", 1, 64, 64, 28, 4, 128, True, 64, 100),
             ("qwen2-7b 1 kv head S=8192", 1, 8192, 8192, 7, 1, 128, True, 0,
              0))
# recurrentgemma-2b's local attention (configs/recurrentgemma_2b.py: 10
# query heads over one kv head of 256, a 2048-token window) at its
# max_seq, in the same row format: the MHA kernels above dh 128 (the bf16
# forward's 64-row tensor-core blocks; dq and dk/dv on their CUDA-core
# kernels in both dtypes, one split)
LOCAL_ATTN = (("recurrentgemma-2b local", 1, 4096, 4096, 10, 1, 256, True,
               2048, 0),
              # a ragged length, as an exact-length monolithic prefill of
              # a recurrentgemma-2b prompt hands the forward
              ("recurrentgemma-2b local ragged", 1, 1292, 1292, 10, 1, 256,
               True, 2048, 0))
# the serving head layouts new with qwen3-32b (dh 80), deepseek-7b (one
# query head a kv head) and command-r-plus-104b (12 a kv head): name, H,
# KV, dh
NEW_LAYOUTS = (("qwen3-32b", 64, 8, 80), ("deepseek-7b", 32, 32, 128),
               ("command-r-plus-104b", 96, 8, 128))
# and those new with the MoE and vlm configs: kimi-k2-1t-a32b's dh 112
# (64 / 8 heads; chunk_tc.cuh pads it to DP 128, as dh 80, and the padded
# columns of q and k hold the next head's values in memory, so a load past
# dh would show in the error), grok-1-314b's group of 6 (48 / 8 of 128)
# and llava-next-34b's group of 7 (56 / 8 of 128)
MOE_LAYOUTS = (("kimi-k2-1t-a32b", 64, 8, 112), ("grok-1-314b", 48, 8, 128),
               ("llava-next-34b", 56, 8, 128))
# and a rank's heads under tensor parallelism (phase 18): qwen2-7b's 28 / 4
# at TP=2 and TP=4
TP_LAYOUTS = (("qwen2-7b TP=2", 14, 2, 128), ("qwen2-7b TP=4", 7, 1, 128))
# the QKV projection's VJP at the same two training shapes: T = B*S, D, F
TRAIN_PROJ = (("famous-bert", 8 * 512, 768, 3 * 768),
              ("qwen2-7b", 2048, 3584, 3584 + 2 * 512))
# a TP=2 famous-bert training rank (phase 20): 4 of the 8 heads of 96, the
# fused projection's 3 x 4 x 96 columns
TP_TRAIN_ATTN = (("famous-bert TP=2", 8, 512, 4, 4, 96, False),)
TP_TRAIN_PROJ = (("famous-bert TP=2", 8 * 512, 768, 3 * 4 * 96),)
# the MoE and recurrent families' rank shapes (phases 18 and 20): grok-1's
# fused projection at TP=2 ((24 + 2 x 4) x 128 columns) and TP=4 ((12 + 2
# x 2) x 128), at decode (T=4) and a chunk (256); its 24 / 4 and 12 / 2
# heads of 128; rwkv6-1.6b's wkv at 16 and 8 of its 32 heads (one slot,
# the serving chunk); a recurrentgemma-2b training rank's local attention
# at model=2: 5 of its 10 query heads over its one kv head of 256, B=1,
# S=2048 in a 2048-token window
GROK_TP_PROJ = tuple((T, 6144, F) for F in (4096, 2048) for T in (4, 256))
GROK_TP_LAYOUTS = (("grok-1-314b TP=2", 24, 4, 128),
                   ("grok-1-314b TP=4", 12, 2, 128))
WKV6_TP_BH = (16, 8)
RG_TP_ATTN = (("recurrentgemma-2b TP=2", 1, 2048, 2048, 5, 1, 256, True,
               2048, 0),)
# a replica group's decode shapes (phase 18e): 2 of the 4 slots, so the
# fused projection at T=2 (qwen2-7b's width at data=2, TP=1 and at
# (data=2, model=2)) and the decode kernel at B=2 on the group's heads
DP_PROJ = ((2, 3584, 4608), (2, 3584, 2304))
DP_LAYOUTS = (("qwen2-7b dp=2", 28, 4, 128), ("qwen2-7b (2,2)", 14, 2, 128),
              ("recurrentgemma-2b dp=2", 10, 1, 256),
              ("recurrentgemma-2b (2,2)", 5, 1, 256))
DP_LENS = [1000, 2048]
# Table I's topology (SL=64, d_model=768, h=8; examples/quickstart.py), for
# the analytical model's predictions (phase 21e)
TABLE_ONE_PROJ = ((64, 768, 3 * 768),)
TABLE_ONE_ATTN = ("Table I", 1, 64, 64, 8, 8, 96, False, 0, 0)
SMEM_LOW = 48 * 1024     # phase 21c's lowered budget


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """One line per source: each kernel instance's registers and spill
    bytes, from ``nvcc -Xptxas -v``."""
    out, name = [], None
    for line in log.splitlines():
        if line.startswith("== "):
            name = line.split()[1]
        elif "registers" in line and name:
            regs = line.split("Used ")[1].split(" registers")[0]
            out.append([name, regs, None])
        elif "spill stores" in line and name:
            out.append([name, None, line.split(",")[1].strip().split()[0]])
    merged = {}
    for name, regs, spill in out:
        d = merged.setdefault(name, {"registers": [], "spill_store_bytes": []})
        if regs:
            d["registers"].append(int(regs))
        if spill:
            d["spill_store_bytes"].append(int(spill))
    return "ptxas " + json.dumps(merged)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, sets, iters):
    """Mean ms of ``fn(*args)`` over ``iters`` launches, cycling through
    input sets that together exceed the L2, so each launch reads cold
    inputs as the serving path does."""
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_call_ms(torch, fn, iters):
    """Median ms of one ``fn()`` by CUDA events recorded just before and
    after each of ``iters`` calls (after one untimed call): a host pause
    between calls, such as a collection of the Python heap, lands outside
    every pair, where over a few back-to-back calls it would add to their
    mean.  For a graph replay this is its device time plus the gaps
    inside the graph."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(end) for start, end in pairs)
    return times[len(times) // 2]


def device_ms(torch, fn, sets, iters):
    """Mean device ms per call of ``fn`` over ``iters`` calls cycling
    through ``sets``: the profiler's device time of every kernel the call
    launches (a second pass included); None when it saw none."""
    from torch.profiler import ProfilerActivity, profile

    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    total_us = sum(getattr(ev, "self_device_time_total", None)
                   or getattr(ev, "self_cuda_time_total", 0)
                   for ev in prof.key_averages())
    return total_us / 1e3 / iters if total_us else None


def n_sets(bytes_per_set: int) -> int:
    return max(2, min(64, math.ceil(2 * L2_BYTES / max(bytes_per_set, 1)) + 1))


def bound(nbytes: float, flops: float, dt: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tol_share(torch, out, ref, tol):
    """The largest |out - ref| / (tol + tol |ref|): how much of its
    tolerance a check used (at most 1 where it passed)."""
    if isinstance(out, (tuple, list)):
        return max(tol_share(torch, o, r, tol) for o, r in zip(out, ref))
    out, ref = out.float(), ref.float()
    share = (out - ref).abs() / (tol + tol * ref.abs())
    return float(share.max()) if share.numel() else 0.0


def ulp_check(out, ref32):
    """(max_abs_err, worst ulps past ULP_GATE_ATOL, ok) of the ulp
    gate."""
    from repro_torch.kernels import lib
    return lib.ulp_gate(out, ref32, ULP_GATE_ATOL)


def tc_mirror_check(torch, out, mirror32):
    """A bf16 tensor-core kernel's output against its mirror's unrounded
    f32 output at DECODE_NEW_TOL["bf16"]: (max_abs_err, ok, the text
    printed, with the worst error past ULP_GATE_ATOL in ulps,
    ungated)."""
    err, ok = compare(torch, out, mirror32, DECODE_NEW_TOL["bf16"])
    _, ulps, _ = ulp_check(out, mirror32)
    return err, ok, (f"tol {DECODE_NEW_TOL['bf16']:g}; {ulps:.2f} ulp past "
                     f"{ULP_GATE_ATOL:g}, ungated")


def compare(torch, out, ref, tol):
    """Max |out - ref| and whether every element is within
    tol + tol * |ref| and finite; tuples compare element by element."""
    if isinstance(out, (tuple, list)):
        res = [compare(torch, o, r, tol) for o, r in zip(out, ref)]
        return max(e for e, _ in res), all(ok for _, ok in res)
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ok = bool(torch.all(err <= tol + tol * ref.abs())) and bool(
        torch.isfinite(out).all())
    return (float(err.max()) if err.numel() else 0.0), ok


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(torch, iters, seed):
    import torch.nn.functional as F

    from repro_torch.kernels import lib
    from repro_torch.kernels.decode import chunk_prefill, decode_attn
    from repro_torch.kernels.decode import ref as dec_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    rows = []

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(name, shape, dt, out, ref, tol, fn, plain, lib_fn, sets,
               nbytes, flops, n_iter=iters, lib_sets=None, ops_dt=None,
               again=None, ulp_ref=None):
        """One kernel row.  ``again``: a second launch's output on the
        same inputs, which must equal ``out`` bit for bit.  ``ulp_ref``:
        a bf16 row gated in ulps, the plain version's unrounded f32
        output on the same inputs, to which ``out`` is held by the ulp
        gate in place of ``tol``."""
        ulps = None
        if ulp_ref is None:
            err, ok = compare(torch, out, ref, tol)
            share = tol_share(torch, out, ref, tol)
            tol_text = f"{tol:g}"
        else:
            err, ulps, ok = ulp_check(out, ulp_ref)
            share = ulps / 0.5
            tol, tol_text = ULP_GATE, ULP_GATE
        identical = None if again is None else all(
            torch.equal(a, b) for a, b in (
                zip(out, again) if isinstance(out, tuple) else [(out, again)]))
        ok = ok and identical is not False
        lib_sets = lib_sets or sets
        ms = time_ms(torch, fn, sets, n_iter)
        library_ms = (time_ms(torch, lib_fn, lib_sets, n_iter)
                      if lib_fn else None)
        timed_by = "events"
        dev_ms = device_ms(torch, fn, sets, n_iter)
        if dev_ms is not None and dev_ms < DEVICE_TIME_UNDER_MS:
            # kernel and library call both by device time, whole call
            ms, timed_by = dev_ms, "profiler"
            if lib_fn:
                library_ms = device_ms(torch, lib_fn, lib_sets, n_iter) \
                    or library_ms
        plain_ms = time_ms(torch, plain, sets, max(3, n_iter // 4))
        b_ms, b_by = bound(nbytes, flops, ops_dt or dt)
        contract = contract_check(torch, fn, sets[0])
        row = dict(name=name, shape=shape, dtype=dt, max_abs_err=err, tol=tol,
                   max_ulps=ulps, tol_share=share, ok=ok, ms=ms,
                   timed_by=timed_by,
                   plain_ms=plain_ms, library_ms=library_ms, device_ms=dev_ms,
                   bit_identical=identical,
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                   contract=contract)
        rows.append(row)
        same = "" if identical is None else \
            f" relaunch {'bit-identical' if identical else 'DIFFERS'}"
        in_ulps = "" if ulps is None else f" ({ulps:.2f} ulp past " \
            f"{ULP_GATE_ATOL:g})"
        print(f"kernel {name:17s} {shape:34s} {dt:4s} max_abs_err={err:.3e}"
              f"{in_ulps} (tol {tol_text}, {share:.2f} of it) "
              f"kernel_ms={ms:.4f} "
              f"({timed_by}) plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms if library_ms is None else round(library_ms, 4)} "
              f"bound_ms={b_ms:.4f} ({b_by}){same} {'ok' if ok else 'FAIL'}",
              flush=True)
        return row

    # matmul_tiled: the fused QKV projection (see SERVING_PROJ)
    matmul_rows(torch, dts, randn, record, SERVING_PROJ)

    int8_kernel_rows(torch, gen, record, iters)

    # decode_attention: 4 slots, 28 query / 4 kv heads, mixed lengths
    B, H, KV, dh, Skv = 4, 28, 4, 128, 2048
    lens_list = [1, 37, 1000, 2048]
    scale = dh ** -0.5

    def decode_row(dt, dtype, H, KV, dh, lens_list, extra="", tol=None,
                   ulp=False):
        """One ``decode_attention`` row at B = len(lens_list), Skv; library:
        SDPA with GQA and a length mask; ``ulp``: a bf16 row held by the
        ulp gate.  Returns the first input set, the kernel's output and the
        plain version's."""
        tol = tol or ATTN_TOL[dt]
        B = len(lens_list)
        e = torch.tensor([], dtype=dtype).element_size()
        scale, live = dh ** -0.5, sum(lens_list)
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        mask = (torch.arange(Skv, device=dev)[None, :] < lens[:, None])
        mask = mask[:, None, None, :]
        per = 2 * B * Skv * KV * dh * e
        sets = [(randn((B, H, dh), dtype), randn((B, Skv, KV, dh), dtype),
                 randn((B, Skv, KV, dh), dtype), lens)
                for _ in range(n_sets(per))]

        def kern(q, k, v, ln):
            return decode_attn.decode_attention(q, k, v, ln, scale=scale)

        def plain(q, k, v, ln):
            return dec_ref.decode_reference(q, k, v, ln, scale=scale)

        def library(q, k, v, ln):
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, scale=scale, enable_gqa=True)

        q, k, v, ln = sets[0]
        out, ref = kern(q, k, v, ln), plain(q, k, v, ln)
        nonempty = lens > 0   # SDPA gives NaN on an empty row
        lib_out = library(q, k, v, ln)[:, :, 0]
        lib_err, _ = compare(torch, lib_out[nonempty], ref[nonempty], tol)
        print(f"  (library vs plain max_abs_err {lib_err:.3e})")
        ulp_ref = (plain(q.float(), k, v, ln) if ulp and dt == "bf16"
                   else None)
        record("decode_attention", f"B={B} H={H} KV={KV} dh={dh} "
               f"Skv={Skv} lens={lens_list}{extra}", dt, out, ref,
               tol, kern, plain, library, sets,
               2 * B * H * dh * e + live * KV * dh * 2 * e + 4 * B,
               4.0 * H * dh * live, again=kern(q, k, v, ln), ulp_ref=ulp_ref)
        del sets
        return (q, k, v, ln), out, ref

    for dt, dtype in dts.items():
        e = torch.tensor([], dtype=dtype).element_size()
        (_, k, v, lens), _, _ = decode_row(dt, dtype, H, KV, dh, lens_list)

        # the same kernel as speculative-verify rows: W = 5 rows a slot,
        # row j of slot b sees lens[b] + j keys (clipped to Skv), all rows
        # of a slot reading its cache in place
        W = 5
        vlens = torch.clamp(lens[:, None] + torch.arange(
            W, device=dev, dtype=torch.int32), max=Skv).reshape(-1).contiguous()
        vlive = int(vlens.sum())
        # each slot's keys are read once for its W rows
        slot_keys = sum(min(n + W - 1, Skv) for n in lens_list)
        vsets = [(randn((B * W, H, dh), dtype), k, v, vlens)] + [
            (randn((B * W, H, dh), dtype), randn(k.shape, dtype),
             randn(k.shape, dtype), vlens)
            for _ in range(n_sets(2 * k.numel() * e) - 1)]

        def vkern(q, k, v, ln):
            return decode_attn.decode_attention(q, k, v, ln, scale=scale,
                                                rows_per_slot=W)

        def vplain(q, k, v, ln):
            return dec_ref.decode_reference(q, k, v, ln, scale=scale,
                                            rows_per_slot=W)

        # library: SDPA over each slot's W query rows at once, row j
        # masked to its own length
        vmask = (torch.arange(Skv, device=dev)[None, None, :]
                 < vlens.view(B, W)[:, :, None])[:, None]

        def vlibrary(q, k, v, ln):
            o = F.scaled_dot_product_attention(
                q.view(B, W, H, dh).transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2), attn_mask=vmask, scale=scale,
                enable_gqa=True)
            return o.transpose(1, 2).reshape(B * W, H, dh)

        q, k, v, ln = vsets[0]
        vref = vplain(q, k, v, ln)
        lib_err, _ = compare(torch, vlibrary(q, k, v, ln), vref, ATTN_TOL[dt])
        print(f"  (library vs plain max_abs_err {lib_err:.3e})")
        record("decode_attention", f"verify B={B} W={W} H={H} KV={KV} "
               f"dh={dh} Skv={Skv} lens={lens_list}+j", dt, vkern(q, k, v, ln),
               vref, ATTN_TOL[dt], vkern, vplain, vlibrary, vsets,
               2 * B * W * H * dh * e + slot_keys * KV * dh * 2 * e
               + 4 * B * W, 4.0 * H * dh * vlive, again=vkern(q, k, v, ln))
        del vsets, k, v

        # recurrentgemma-2b's layout: 10 query heads over one kv head of
        # 256, 1025 keys a slot (a decode step at 1024 cached tokens)
        decode_row(dt, dtype, 10, 1, 256, [1025] * B,
                   tol=DECODE_NEW_TOL[dt], ulp=True)
        # lengths at the kernel's range boundaries, an empty row first:
        # that row must be exactly 0, and the kernel must also match the
        # plain mirror of its split-and-combine algebra
        L, _ = decode_attn.plan(lib.DTYPE_CODE[dtype], B, H, KV, dh, Skv,
                                lib.sm_count(dev))
        edge = [0, L - 1, L, L + 1]
        tol = DECODE_NEW_TOL[dt]
        (q, k, v, ln), out, _ = decode_row(dt, dtype, H, KV, dh, edge,
                                           f" (L={L})", tol=tol, ulp=True)
        split = dec_ref.decode_split_reference(
            q.float() if dt == "bf16" else q, k, v, ln, scale=scale,
            keys_per_split=L)
        s_err, s_ok = compare(torch, out, split, tol)
        s_gate = f"tol {tol:g}"
        if dt == "bf16":
            s_err, s_ulps, s_ok = ulp_check(out, split)
            s_gate = f"{s_ulps:.2f} ulp past {ULP_GATE_ATOL:g}; {ULP_GATE}"
        zero = bool(torch.all(out[0] == 0))
        rows[-1].update(split_mirror_err=s_err, empty_row_zero=zero)
        print(f"  (decode_attention {dt} lens {edge}: vs the split mirror "
              f"max_abs_err {s_err:.3e} ({s_gate}), empty row "
              f"{'exactly 0' if zero else 'NOT 0'}) "
              f"{'ok' if s_ok and zero else 'FAIL'}", flush=True)
        check(s_ok and zero, f"decode_attention {dt} at lens {edge}: mirror "
              f"error {s_err}, empty row zero {zero}")
        del q, k, v

    # chunk_prefill: one slot of the batched cache, C = 256 at offsets 0,
    # 1792 and 1000 (off the 64-key tiles), read as the main path reads it:
    # the whole cache, the slot and the offset as int32 scalars in device
    # memory; every launch relaunched for bit identity, and in bf16 at
    # 1000 the kernel held to the plain mirror of its tensor-core algebra
    # (split count from its plan)
    C, slot = 256, 2
    slot_t = torch.tensor([slot], dtype=torch.int32, device=dev)
    for dt, dtype in dts.items():
        e = torch.tensor([], dtype=dtype).element_size()
        for off in (0, 1792, 1000):
            visible = sum(off + c + 1 for c in range(C))
            per = (C * H * dh + 2 * (off + C) * KV * dh) * e
            cmask = (torch.arange(Skv, device=dev)[None, :]
                     <= off + torch.arange(C, device=dev)[:, None])
            off_t = torch.tensor([off], dtype=torch.int32, device=dev)

            def kern(q, k, v, off_t=off_t):
                return chunk_prefill.chunk_prefill(q, k, v, off_t,
                                                   scale=scale, slot=slot_t)

            def plain(q, k, v, off_t=off_t):
                return dec_ref.chunk_prefill_reference(
                    q, k, v, off_t, scale=scale, slot=slot_t)

            def library(q, k, v, cmask=cmask):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k[slot:slot + 1].transpose(1, 2),
                    v[slot:slot + 1].transpose(1, 2), attn_mask=cmask,
                    scale=scale, enable_gqa=True)

            sets = [(randn((1, C, H, dh), dtype),
                     randn((B, Skv, KV, dh), dtype),
                     randn((B, Skv, KV, dh), dtype))
                    for _ in range(min(8, n_sets(per)))]
            q, k, v = sets[0]
            out, ref = kern(q, k, v), plain(q, k, v)
            record("chunk_prefill", f"C={C} offset={off} H={H} KV={KV} "
                   f"dh={dh} Skv={Skv}", dt, out, ref, ATTN_TOL[dt], kern,
                   plain, library, sets,
                   2 * C * H * dh * e + (off + C) * KV * dh * 2 * e,
                   4.0 * H * dh * visible, again=kern(q, k, v))
            if dt == "bf16" and off == 1000:
                splits, _ = chunk_prefill.plan(
                    lib.DTYPE_CODE[dtype], 1, C, H, KV, dh, Skv,
                    lib.sm_count(dev))
                mirror = dec_ref.chunk_prefill_tc_reference(
                    q, k[slot:slot + 1], v[slot:slot + 1], off, scale=scale,
                    splits=splits, round_out=False)
                m_err, m_ok, m_text = tc_mirror_check(torch, out, mirror)
                rows[-1].update(tc_mirror_err=m_err)
                print(f"  (chunk_prefill {dt} offset {off}: vs the "
                      f"tensor-core mirror ({splits} splits) max_abs_err "
                      f"{m_err:.3e} ({m_text})) "
                      f"{'ok' if m_ok else 'FAIL'}", flush=True)
                check(m_ok, f"chunk_prefill {dt} offset {off}: mirror "
                      f"error {m_err}")
    paged_kernel_rows(torch, dts, randn, record, iters, gen)
    layout_kernel_rows(torch, F, randn, record, decode_row, gen,
                       max(10, iters // 2))
    chunk_graph_checks(torch, dts, randn, gen)
    training_kernel_rows(torch, F, dts, randn, record, iters)
    scan_kernel_rows(torch, dts, randn, record, iters)
    tp_kernel_rows(torch, F, dts, randn, record, decode_row, gen, iters)
    family_tp_kernel_rows(torch, F, dts, randn, record, decode_row, gen,
                          iters)
    dp_kernel_rows(torch, dts, randn, record, decode_row)
    # Table I's projection and attention, for phase 21e's model
    matmul_rows(torch, dts, randn, record, TABLE_ONE_PROJ)
    attention_rows(torch, F, dts, randn, record, max(5, iters // 5),
                   *TABLE_ONE_ATTN)
    torch.cuda.synchronize()
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    return rows


def contract_check(torch, fn, inputs):
    """One untimed call of ``fn(*inputs)`` with the launch-contract
    checker on: every launch it made (``kernel_check.Launch`` fields and
    the wrapper) and its violations (None: none)."""
    from repro_torch.analysis import kernel_check

    violations = None
    with kernel_check.checking(True), kernel_check.collecting() as seen:
        try:
            fn(*inputs)
        except kernel_check.KernelContractError as e:
            violations = str(e)
    torch.cuda.synchronize()
    return dict(violations=violations, launches=[
        dict(dataclasses.asdict(launch), wrapper=wrapper)
        for wrapper, launch in seen])


def matmul_rows(torch, dts, randn, record, shapes):
    """``matmul_tiled`` at each (T, D, F) of ``shapes``, f32 and bf16,
    against its plain version and ``torch.matmul``, relaunched for bit
    identity."""
    from repro_torch.kernels.qkv import qkv_proj
    from repro_torch.kernels.qkv import ref as qkv_ref

    for dt, dtype in dts.items():
        e = torch.tensor([], dtype=dtype).element_size()
        for T, D, Fo in shapes:
            per = (T * D + D * Fo) * e
            sets = [(randn((T, D), dtype), randn((D, Fo), dtype, D ** -0.5))
                    for _ in range(n_sets(per))]
            x, w = sets[0]
            out = qkv_proj.matmul_tiled(x, w)
            ref = qkv_ref.matmul_reference(x, w)
            record("matmul_tiled", f"T={T} D={D} F={Fo}", dt, out, ref,
                   TOL[dt], qkv_proj.matmul_tiled, qkv_ref.matmul_reference,
                   torch.matmul, sets, (T * D + D * Fo + T * Fo) * e,
                   2.0 * T * D * Fo, again=qkv_proj.matmul_tiled(x, w))
            del sets


def tp_kernel_rows(torch, F, dts, randn, record, decode_row, gen, iters):
    """A tensor-parallel rank's kernel shapes (phase 18), drawn after every
    other row so that the earlier rows keep their inputs: ``matmul_tiled``
    at TP_PROJ's fused widths (f32 and bf16), the serving kernels at
    TP_LAYOUTS' heads (bf16, as ``layout_kernel_rows``), and
    ``rglru_scan`` on a TP=2 rank's R=1280 channels of the 256-token
    chunk; and a TP=2 famous-bert training rank's (phase 20): the MHA
    kernels at TP_TRAIN_ATTN, ``matmul_tiled`` and its VJP at
    TP_TRAIN_PROJ."""
    matmul_rows(torch, dts, randn, record, TP_PROJ)
    layout_kernel_rows(torch, F, randn, record, decode_row, gen,
                       max(10, iters // 2), layouts=TP_LAYOUTS)
    rglru_rows(torch, dts, randn, record, 256, 1280)
    # a TP=2 famous-bert training rank (phase 20): 4 of 8 heads of 96,
    # the fused projection's 1152 columns and its VJP
    slow = max(5, iters // 5)
    for label, B, S, H, KV, dh, causal in TP_TRAIN_ATTN:
        attention_rows(torch, F, dts, randn, record, slow, label, B, S, S, H,
                       KV, dh, causal, 0, 0)
    matmul_rows(torch, dts, randn, record,
                [(T, D, Fo) for _, T, D, Fo in TP_TRAIN_PROJ])
    proj_vjp_rows(torch, dts, randn, record, slow, TP_TRAIN_PROJ)


def family_tp_kernel_rows(torch, F, dts, randn, record, decode_row, gen,
                          iters):
    """The MoE and recurrent families' rank shapes (phases 18 and 20),
    drawn after every other row: ``matmul_tiled`` at GROK_TP_PROJ, the
    serving kernels at GROK_TP_LAYOUTS' heads (as ``layout_kernel_rows``),
    ``wkv6_scan`` at WKV6_TP_BH heads of the 256-token chunk, and the MHA
    kernels at RG_TP_ATTN."""
    matmul_rows(torch, dts, randn, record, GROK_TP_PROJ)
    layout_kernel_rows(torch, F, randn, record, decode_row, gen,
                       max(10, iters // 2), layouts=GROK_TP_LAYOUTS)
    for BH in WKV6_TP_BH:
        wkv6_rows(torch, dts, randn, record, 256, BH)
    for args in RG_TP_ATTN:
        attention_rows(torch, F, dts, randn, record, max(5, iters // 5),
                       *args)


def dp_kernel_rows(torch, dts, randn, record, decode_row):
    """A replica group's decode shapes (phase 18e), drawn after every
    other row: ``matmul_tiled`` at DP_PROJ (f32 and bf16) and the decode
    kernel at B=2 (DP_LENS) on DP_LAYOUTS' heads, bf16 (heads of 256
    held as recurrentgemma-2b's B=4 row is: DECODE_NEW_TOL, in ulps)."""
    matmul_rows(torch, dts, randn, record, DP_PROJ)
    for label, H, KV, dh in DP_LAYOUTS:
        wide = {"tol": DECODE_NEW_TOL["bf16"], "ulp": True} if dh > 128 \
            else {}
        decode_row("bf16", torch.bfloat16, H, KV, dh, DP_LENS, f" {label}",
                   **wide)


def int8_kernel_rows(torch, gen, record, iters):
    """``matmul_tiled_int8`` at the serving path's shapes, the fused QKV
    projection of qwen2-7b (D = 3584, F = 4608) with the paper's 8-bit
    operands: T = 4 (decode), 20 (verify: 4 slots x 5) and 256 (a chunk).
    X is quantized per token and W per column by ``core.quant``; the kernel
    takes W transposed (F, D), the plain version (D, F).  The kernel must
    equal the plain version exactly (integer sums, the same two f32
    multiplies; at T <= 32 over the int32 partials of its split-K plan),
    and a relaunch its own bits.  Library: ``torch._int_mm`` (cuBLASLt's int8 GEMM) plus the
    same dequantize, where it takes the shape (T > 16 and a multiple of
    8: T = 256 only)."""
    from repro_torch.core import quant
    from repro_torch.kernels.qkv import qkv_proj
    from repro_torch.kernels.qkv import ref as qkv_ref

    dev = torch.device("cuda")
    D, Fo = 3584, 4608

    def operands(T):
        x = torch.randn((T, D), generator=gen, device=dev)
        w = torch.randn((D, Fo), generator=gen, device=dev) * D ** -0.5
        (xq, sx), (wq, sw) = quant.quantize(x, 1), quant.quantize(w, 0)
        return xq, wq, wq.t().contiguous(), sx, sw

    def kern(xq, wq, wqt, sx, sw):
        return qkv_proj.matmul_tiled_int8(xq, wqt, sx, sw)

    def plain(xq, wq, wqt, sx, sw):
        return qkv_ref.matmul_int8_reference(xq, wq, sx, sw)

    def library(xq, wq, wqt, sx, sw):
        return torch._int_mm(xq, wq).to(torch.float32) * sx * sw

    for T in (4, 20, 256):
        per = T * D + 2 * D * Fo
        sets = [operands(T) for _ in range(n_sets(per))]
        out, ref = kern(*sets[0]), plain(*sets[0])
        lib_fn = None
        if T > 16 and T % 8 == 0:
            lib_err, _ = compare(torch, library(*sets[0]), ref, 0.0)
            print(f"  (library vs plain max_abs_err {lib_err:.3e})")
            lib_fn = library
        record("matmul_tiled_int8", f"T={T} D={D} F={Fo}", "int8", out, ref,
               0.0, kern, plain, lib_fn, sets,
               T * D + D * Fo + 4 * (T + Fo) + 4 * T * Fo, 2.0 * T * D * Fo,
               again=kern(*sets[0]))
        check(torch.equal(out, ref),
              f"matmul_tiled_int8 T={T} differs from its plain version")
        del sets


def paged_kernel_rows(torch, dts, randn, record, iters, gen):
    """The four paged kernels at qwen2-7b's serving shapes: a 513-page pool
    of 16-token pages (the engine's default for 4 slots of 2048), page ids
    a seeded permutation; decode at B=4 with lens 1/37/1000/2048, chunk
    prefill of C=256 at offset 1792 for one slot; fp pools in the query's
    dtype, int8 pools (quantized by ``core.quant``) with f32 scales.  The
    decode kernels also at lengths on their range boundaries [0, L-1, L,
    L+1] (the empty row must be exactly 0, and the kernel must match the
    plain mirror of its paged split-and-combine algebra) and as verify
    rows (5 a slot, reading the slot's page-table row in place).  The
    bf16 chunk kernels also at offset 1000, there held to the plain mirror
    of their tensor-core algebra, and the fp one on a pool holding a
    contiguous cache under identity pages, which must give
    ``chunk_prefill``'s bits.  Every launch is relaunched for bit
    identity.  No single PyTorch call reads a page table, so these rows
    have no library time."""
    from repro_torch.core import quant
    from repro_torch.kernels.decode import chunk_prefill, decode_attn
    from repro_torch.kernels.decode import ref as dec_ref

    dev = torch.device("cuda")
    B, H, KV, dh, ps, n_pages = 4, 28, 4, 128, 16, 513
    n_p, scale = 2048 // ps, dh ** -0.5
    pt = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:B * n_p]
          + 1).to(torch.int32).reshape(B, n_p).contiguous()
    # the chunk rows read slot 2's row of the whole table, as the main
    # path does (slot and offset int32 scalars in device memory)
    slot_t = torch.tensor([2], dtype=torch.int32, device=dev)
    lens_list = [1, 37, 1000, 2048]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    live = sum(lens_list)
    live_pages = sum(-(-n // ps) for n in lens_list)
    C, off = 256, 1792
    pool_shape = (n_pages, ps, KV, dh)

    def pools(dtype, kind):
        k, v = randn(pool_shape, dtype), randn(pool_shape, dtype)
        if kind == "fp":
            return (k, v)
        (kq, ks), (vq, vs) = quant.quantize(k, -1), quant.quantize(v, -1)
        return (kq, vq, ks[..., 0].contiguous(), vs[..., 0].contiguous())

    for dt, dtype in dts.items():
        e = torch.tensor([], dtype=dtype).element_size()
        for kind in ("fp", "int8"):
            # bytes of one K/V row (dh elements) and its scale
            row = dh * e if kind == "fp" else dh + 4
            sfx = "" if kind == "fp" else "_int8"
            per = 2 * n_pages * ps * KV * row
            sets = [(randn((B, H, dh), dtype), *pools(dtype, kind))
                    for _ in range(n_sets(per))]
            dec_k = getattr(decode_attn, "paged_decode_attention" + sfx)
            dec_p = getattr(dec_ref, "paged_decode_reference" + sfx)

            def kern(q, *pool, fn=dec_k):
                return fn(q, *pool, pt, lens, scale=scale)

            def plain(q, *pool, fn=dec_p):
                return fn(q, *pool, pt, lens, scale=scale)

            q0 = sets[0]
            record("paged_decode_attention" + sfx,
                   f"B={B} H={H} KV={KV} dh={dh} page={ps} pool={n_pages} "
                   f"lens={lens_list}", dt, kern(*q0), plain(*q0),
                   ATTN_TOL[dt], kern, plain, None, sets,
                   2 * B * H * dh * e + live * KV * row * 2
                   + 4 * (live_pages + B), 4.0 * H * dh * live,
                   again=kern(*q0))
            paged_decode_extra_rows(torch, dt, kind, sets, pt, record, randn,
                                    scale)

            csets = [(randn((1, C, H, dh), dtype), *pool[1:])
                     for pool in sets[:min(8, len(sets))]]
            ch_k = getattr(chunk_prefill, "paged_chunk_prefill" + sfx)
            ch_p = getattr(dec_ref, "paged_chunk_prefill_reference" + sfx)
            # the bf16 rows again at offset 1000 (off the 64-key tiles),
            # held to the plain mirror of the tensor-core algebra
            for c_off in (off, 1000) if dt == "bf16" else (off,):
                c_vis = sum(c_off + c + 1 for c in range(C))
                off_t = torch.tensor([c_off], dtype=torch.int32, device=dev)

                def ckern(q, *pool, fn=ch_k, off_t=off_t):
                    return fn(q, *pool, pt, off_t, scale=scale, slot=slot_t)

                def cplain(q, *pool, fn=ch_p, off_t=off_t):
                    return fn(q, *pool, pt, off_t, scale=scale, slot=slot_t)

                c0 = csets[0]
                out = ckern(*c0)
                r = record("paged_chunk_prefill" + sfx,
                           f"C={C} offset={c_off} H={H} KV={KV} dh={dh} "
                           f"page={ps} pool={n_pages}", dt, out, cplain(*c0),
                           ATTN_TOL[dt], ckern, cplain, None, csets,
                           2 * C * H * dh * e + (c_off + C) * KV * row * 2
                           + 4 * ((c_off + C) // ps), 4.0 * H * dh * c_vis,
                           again=ckern(*c0))
                if c_off == 1000:
                    r.update(tc_mirror_err=paged_chunk_mirror_check(
                        torch, kind, c0, pt[2:3], c_off, scale, out))
            if dt == "bf16" and kind == "fp":
                paged_chunk_identity_check(torch, randn, dtype, C, H, KV, dh,
                                           ps, scale)
            del sets, csets


def layout_kernel_rows(torch, F, randn, record, decode_row, gen, iters,
                       layouts=NEW_LAYOUTS + MOE_LAYOUTS):
    """The serving kernels at ``layouts`` (NEW_LAYOUTS' and MOE_LAYOUTS'
    head layouts; TP_LAYOUTS' from ``tp_kernel_rows``), bf16 (the serving
    dtype; the f32 kernels meet them in the dense-zoo slice): the
    contiguous decode kernel (B=4, lens 1/37/1000/2048), ``chunk_prefill``
    (C=256 at offset 1792 in slot 2 of a 4-slot cache), and the paged
    decode and chunk kernels on fp and int8 pools (a 513-page pool of
    16-token pages, page ids a seeded permutation), each held to its plain
    version, relaunched for bit identity and timed beside the library call
    (SDPA with GQA; none for the paged kernels) and its bound."""
    from repro_torch.core import quant
    from repro_torch.kernels.decode import chunk_prefill, decode_attn
    from repro_torch.kernels.decode import ref as dec_ref

    dev = torch.device("cuda")
    dt, dtype, e = "bf16", torch.bfloat16, 2
    B, Skv, C, off, ps, n_pages = 4, 2048, 256, 1792, 16, 513
    n_p, lens_list = Skv // ps, [1, 37, 1000, 2048]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    live = sum(lens_list)
    live_pages = sum(-(-n // ps) for n in lens_list)
    visible = sum(off + c + 1 for c in range(C))
    slot_t = torch.tensor([2], dtype=torch.int32, device=dev)
    off_t = torch.tensor([off], dtype=torch.int32, device=dev)
    pt = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:B * n_p]
          + 1).to(torch.int32).reshape(B, n_p).contiguous()
    cmask = (torch.arange(Skv, device=dev)[None, :]
             <= off + torch.arange(C, device=dev)[:, None])
    for label, H, KV, dh in layouts:
        scale = dh ** -0.5
        decode_row(dt, dtype, H, KV, dh, lens_list, f" {label}")

        def kern(q, k, v):
            return chunk_prefill.chunk_prefill(q, k, v, off_t, scale=scale,
                                               slot=slot_t)

        def plain(q, k, v):
            return dec_ref.chunk_prefill_reference(q, k, v, off_t,
                                                   scale=scale, slot=slot_t)

        def library(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k[2:3].transpose(1, 2),
                v[2:3].transpose(1, 2), attn_mask=cmask, scale=scale,
                enable_gqa=True)

        per = (C * H * dh + 2 * (off + C) * KV * dh) * e
        sets = [(randn((1, C, H, dh), dtype), randn((B, Skv, KV, dh), dtype),
                 randn((B, Skv, KV, dh), dtype))
                for _ in range(min(4, n_sets(per)))]
        record("chunk_prefill", f"{label} C={C} offset={off} H={H} KV={KV} "
               f"dh={dh} Skv={Skv}", dt, kern(*sets[0]), plain(*sets[0]),
               ATTN_TOL[dt], kern, plain, library, sets,
               2 * C * H * dh * e + (off + C) * KV * dh * 2 * e,
               4.0 * H * dh * visible, n_iter=iters, again=kern(*sets[0]))
        del sets
        shape = (n_pages, ps, KV, dh)
        for kind in ("fp", "int8"):
            sfx = "" if kind == "fp" else "_int8"
            row = dh * e if kind == "fp" else dh + 4

            def pools():
                k, v = randn(shape, dtype), randn(shape, dtype)
                if kind == "fp":
                    return (k, v)
                (kq, ks), (vq, vs) = (quant.quantize(k, -1),
                                      quant.quantize(v, -1))
                return (kq, vq, ks[..., 0].contiguous(),
                        vs[..., 0].contiguous())

            sets = [(randn((B, H, dh), dtype), *pools())
                    for _ in range(min(4, n_sets(2 * n_pages * ps * KV
                                                 * row)))]
            dec_k = getattr(decode_attn, "paged_decode_attention" + sfx)
            dec_p = getattr(dec_ref, "paged_decode_reference" + sfx)
            ch_k = getattr(chunk_prefill, "paged_chunk_prefill" + sfx)
            ch_p = getattr(dec_ref, "paged_chunk_prefill_reference" + sfx)

            def dkern(q, *pool, fn=dec_k):
                return fn(q, *pool, pt, lens, scale=scale)

            def dplain(q, *pool, fn=dec_p):
                return fn(q, *pool, pt, lens, scale=scale)

            def ckern(q, *pool, fn=ch_k):
                return fn(q, *pool, pt, off_t, scale=scale, slot=slot_t)

            def cplain(q, *pool, fn=ch_p):
                return fn(q, *pool, pt, off_t, scale=scale, slot=slot_t)

            s0 = sets[0]
            record("paged_decode_attention" + sfx,
                   f"{label} B={B} H={H} KV={KV} dh={dh} page={ps} "
                   f"pool={n_pages} lens={lens_list}", dt, dkern(*s0),
                   dplain(*s0), ATTN_TOL[dt], dkern, dplain, None, sets,
                   2 * B * H * dh * e + live * KV * row * 2
                   + 4 * (live_pages + B), 4.0 * H * dh * live,
                   n_iter=iters, again=dkern(*s0))
            csets = [(randn((1, C, H, dh), dtype), *st[1:]) for st in sets]
            c0 = csets[0]
            record("paged_chunk_prefill" + sfx,
                   f"{label} C={C} offset={off} H={H} KV={KV} dh={dh} "
                   f"page={ps} pool={n_pages}", dt, ckern(*c0), cplain(*c0),
                   ATTN_TOL[dt], ckern, cplain, None, csets,
                   2 * C * H * dh * e + (off + C) * KV * row * 2
                   + 4 * ((off + C) // ps), 4.0 * H * dh * visible,
                   n_iter=iters, again=ckern(*c0))
            del sets, csets
        torch.cuda.empty_cache()


def chunk_graph_checks(torch, dts, randn, gen):
    """The three chunk kernels as the engine's chunk graph runs them: one
    CUDA graph of each launch (``graphs.Executable``: warmed and captured
    with the slot and q_offset staged at (1, 512) in a device buffer),
    replayed after restaging them to (0, 0), (2, 1000) and (1, 1792), in
    f32 and bf16, on qwen2-7b's heads: a (4, 2048) contiguous cache, and
    fp and int8 pools of 16-token pages (a seeded permutation of 512
    pages).  Each replay must equal a fresh launch at those values bit
    for bit, and its plain version at the kernel rows' tolerance."""
    from repro_torch.core import quant
    from repro_torch.kernels.decode import chunk_prefill
    from repro_torch.kernels.decode import ref as dec_ref
    from repro_torch.serve import graphs

    dev = torch.device("cuda")
    B, C, H, KV, dh, Skv, ps = 4, 256, 28, 4, 128, 2048, 16
    n_p, scale = Skv // ps, dh ** -0.5
    n_pages = 1 + B * n_p
    pt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(B, n_p).contiguous()
    for dt, dtype in dts.items():
        q = randn((1, C, H, dh), dtype)
        k, v = randn((B, Skv, KV, dh), dtype), randn((B, Skv, KV, dh), dtype)
        fp = tuple(randn((n_pages, ps, KV, dh), dtype) for _ in range(2))
        (kq, ksc), (vq, vsc) = (quant.quantize(x, -1) for x in fp)
        i8 = (kq, vq, ksc[..., 0].contiguous(), vsc[..., 0].contiguous())
        cases = (
            ("chunk_prefill", chunk_prefill.chunk_prefill,
             dec_ref.chunk_prefill_reference, (k, v)),
            ("paged_chunk_prefill", chunk_prefill.paged_chunk_prefill,
             dec_ref.paged_chunk_prefill_reference, fp + (pt,)),
            ("paged_chunk_prefill_int8",
             chunk_prefill.paged_chunk_prefill_int8,
             dec_ref.paged_chunk_prefill_reference_int8, i8 + (pt,)))
        for name, kern, plain, operands in cases:
            staged = graphs.StaticInput((2,), torch.int32, dev)

            def body(key, kern=kern, operands=operands, t=staged.tensor):
                return kern(q, *operands, t[1:2], scale=scale, slot=t[0:1])

            # a pool of its own: a pool whose graphs were all freed takes
            # no new capture
            ex = graphs.Executable(body, graphs.GraphPool(dev))
            staged.put((1, 512))
            ex("chunk")                     # eager warm-up
            ex("chunk")                     # capture, then one replay
            check(ex.graph_keys == ["chunk"], f"{name}: no graph captured")
            for slot, off in ((0, 0), (2, 1000), (1, 1792)):
                staged.put((slot, off))
                out = ex("chunk")
                fresh = kern(q, *operands, off, scale=scale, slot=slot)
                ref = plain(q, *operands, off, scale=scale, slot=slot)
                torch.cuda.synchronize()
                same = torch.equal(out, fresh)
                err, ok = compare(torch, out, ref, ATTN_TOL[dt])
                print(f"  ({name} {dt} graph replayed at slot {slot} offset "
                      f"{off}: {'equal to' if same else 'DIFFERS from'} a "
                      f"fresh launch, vs the plain version max_abs_err "
                      f"{err:.3e} (tol {ATTN_TOL[dt]:g})) "
                      f"{'ok' if same and ok else 'FAIL'}", flush=True)
                check(same and ok, f"{name} {dt} graph at slot {slot} offset "
                      f"{off}: bit-equal {same}, plain error {err}")
        del k, v, fp, i8


def paged_chunk_mirror_check(torch, kind, inputs, pt, off, scale, out):
    """A bf16 paged chunk kernel's output ``out`` on ``inputs`` (q, pools)
    against the plain mirror of its tensor-core algebra (split count from
    the kernel's plan over the table's n_p * page_size keys), unrounded,
    at DECODE_NEW_TOL (``tc_mirror_check``).  Returns the max error."""
    from repro_torch.kernels import lib
    from repro_torch.kernels.decode import chunk_prefill
    from repro_torch.kernels.decode import ref as dec_ref

    q, pools = inputs[0], inputs[1:]
    _, C, H, dh = q.shape
    _, ps, KV, _ = pools[0].shape
    splits, _ = chunk_prefill.plan(lib.DTYPE_CODE[q.dtype], 1, C, H, KV, dh,
                                   pt.shape[1] * ps, lib.sm_count(q.device))
    fn = (dec_ref.paged_chunk_prefill_tc_reference if kind == "fp" else
          dec_ref.paged_chunk_prefill_tc_reference_int8)
    mirror = fn(q, *pools, pt, off, scale=scale, splits=splits,
                round_out=False)
    err, ok, text = tc_mirror_check(torch, out, mirror)
    sfx = "" if kind == "fp" else "_int8"
    print(f"  (paged_chunk_prefill{sfx} bf16 offset {off}: vs the "
          f"tensor-core mirror ({splits} splits) max_abs_err {err:.3e} "
          f"({text})) {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"paged_chunk_prefill{sfx} bf16 offset {off}: mirror error "
          f"{err}")
    return err


def paged_chunk_identity_check(torch, randn, dtype, C, H, KV, dh, ps, scale):
    """``paged_chunk_prefill`` on a pool that holds one contiguous cache
    page by page, read through an identity page table, must give
    ``chunk_prefill``'s bits on that cache (one body, one split plan), at
    offsets 1792 and 1000."""
    from repro_torch.kernels.decode import chunk_prefill

    dev = torch.device("cuda")
    Skv = 2048
    q = randn((1, C, H, dh), dtype)
    k, v = randn((1, Skv, KV, dh), dtype), randn((1, Skv, KV, dh), dtype)
    kp, vp = (x.reshape(Skv // ps, ps, KV, dh) for x in (k, v))
    pt = torch.arange(Skv // ps, dtype=torch.int32, device=dev)[None]
    for off in (1792, 1000):
        same = torch.equal(
            chunk_prefill.paged_chunk_prefill(q, kp, vp, pt, off,
                                              scale=scale),
            chunk_prefill.chunk_prefill(q, k, v, off, scale=scale))
        got = "bit for bit" if same else "DIFFERS"
        print(f"  (paged_chunk_prefill bf16 offset {off} on identity pages "
              f"against chunk_prefill: {got}) {'ok' if same else 'FAIL'}",
              flush=True)
        check(same, f"paged_chunk_prefill on identity pages at offset {off} "
              f"differs from chunk_prefill")


def paged_decode_extra_rows(torch, dt, kind, sets, pt, record, randn, scale):
    """``paged_decode_attention`` (fp pools) or its int8 instantiation on
    ``sets`` (q, pools) and page table ``pt`` at the lengths on the range
    boundaries of the kernel's plan, [0, L-1, L, L+1], and as verify rows
    (W = 5 a slot; row j of slot b sees lens[b] + j keys of 1/37/1000/2043,
    clipped, through slot b's page-table row in place)."""
    from repro_torch.kernels import lib
    from repro_torch.kernels.decode import decode_attn
    from repro_torch.kernels.decode import ref as dec_ref

    dev = torch.device("cuda")
    sfx = "" if kind == "fp" else "_int8"
    fn = getattr(decode_attn, "paged_decode_attention" + sfx)
    ref = getattr(dec_ref, "paged_decode_reference" + sfx)
    q0, pool = sets[0][0], sets[0][1:]
    B, H, dh = q0.shape
    n_pages, ps, KV, _ = pool[0].shape
    n_p = pt.shape[1]
    e, esize = q0.element_size(), pool[0].element_size()
    row = dh * esize + (0 if kind == "fp" else 4)  # a K/V row and its scale
    tol = DECODE_NEW_TOL[dt]
    L, _ = decode_attn.paged_plan(B, H, KV, dh, n_p * ps, esize,
                                  lib.sm_count(dev))
    shape = f"H={H} KV={KV} dh={dh} page={ps} pool={n_pages}"

    edge = [0, L - 1, L, L + 1]
    lens = torch.tensor(edge, dtype=torch.int32, device=dev)

    def kern(q, *pool):
        return fn(q, *pool, pt, lens, scale=scale)

    def plain(q, *pool):
        return ref(q, *pool, pt, lens, scale=scale)

    out = kern(*sets[0])
    live = sum(edge)
    pages = sum(-(-n // ps) for n in edge)
    bf16 = dt == "bf16"
    # a bf16 row is held by the ulp gate to the f32 outputs of the same
    # bf16 inputs
    q32 = q0.float() if bf16 else q0
    record("paged_decode_attention" + sfx, f"edge B={B} {shape} lens={edge} "
           f"(L={L})", dt, out, plain(*sets[0]), tol, kern, plain, None, sets,
           2 * B * H * dh * e + live * KV * row * 2 + 4 * (pages + B),
           4.0 * H * dh * live, again=kern(*sets[0]),
           ulp_ref=plain(q32, *pool) if bf16 else None)
    mirror = dec_ref.paged_decode_split_reference(
        q32, pool[0], pool[1], pt, lens, scale=scale, keys_per_split=L,
        k_scale=pool[2] if kind == "int8" else None,
        v_scale=pool[3] if kind == "int8" else None)
    s_err, s_ok = compare(torch, out, mirror, tol)
    s_gate = f"tol {tol:g}"
    if bf16:
        s_err, s_ulps, s_ok = ulp_check(out, mirror)
        s_gate = f"{s_ulps:.2f} ulp past {ULP_GATE_ATOL:g}; {ULP_GATE}"
    zero = bool(torch.all(out[0] == 0))
    print(f"  (paged_decode_attention{sfx} {dt} lens {edge}: vs the split "
          f"mirror max_abs_err {s_err:.3e} ({s_gate}), empty row "
          f"{'exactly 0' if zero else 'NOT 0'}) "
          f"{'ok' if s_ok and zero else 'FAIL'}", flush=True)
    check(s_ok and zero, f"paged_decode_attention{sfx} {dt} at lens {edge}: "
          f"mirror error {s_err}, empty row zero {zero}")

    # verify rows at the contiguous verify row's tolerance: rows of 1-5
    # keys give outputs up to a few units, where one bf16 step of the
    # output exceeds the mirror tolerance
    W, base = 5, [1, 37, 1000, 2043]
    vlens = torch.clamp(torch.tensor(base, dtype=torch.int32, device=dev)
                        [:, None] + torch.arange(W, dtype=torch.int32,
                                                 device=dev),
                        max=n_p * ps).reshape(-1).contiguous()
    vsets = [(randn((B * W, H, dh), q0.dtype), *st[1:]) for st in sets]

    def vkern(q, *pool):
        return fn(q, *pool, pt, vlens, scale=scale, rows_per_slot=W)

    def vplain(q, *pool):
        return ref(q, *pool, pt, vlens, scale=scale, rows_per_slot=W)

    # each slot's keys (and pages) are read once for its W rows
    slot_keys = [min(n + W - 1, n_p * ps) for n in base]
    pages = sum(-(-n // ps) for n in slot_keys)
    record("paged_decode_attention" + sfx, f"verify B={B} W={W} {shape} "
           f"lens={base}+j", dt, vkern(*vsets[0]), vplain(*vsets[0]),
           ATTN_TOL[dt], vkern, vplain, None, vsets,
           2 * B * W * H * dh * e + sum(slot_keys) * KV * row * 2
           + 4 * (pages + B * W), 4.0 * H * dh * int(vlens.sum()),
           again=vkern(*vsets[0]))


def training_kernel_rows(torch, F, dts, randn, record, iters):
    """The training path's kernels at its two shapes: the attention forward
    (library: ``scaled_dot_product_attention`` with GQA), the dq and dk/dv
    backward kernels (library: that call's backward, timed as
    ``torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)``, the
    same number for both), and the QKV projection's VJP products dX and dW
    on their transposed contiguous operands (library: ``torch.matmul``).
    All three are relaunched on the same inputs (the bits must agree) and,
    in bf16, held to the plain mirrors of their tensor-core algebra, with
    the backward plans' longest runs within their caps; MASK_ATTN's rows
    run every mask of those bodies, LOCAL_ATTN's the head dim of 256
    (whose bf16 dq and dk/dv run the CUDA-core kernels, held to the plain
    versions alone)."""
    slow = max(5, iters // 5)
    for label, B, S, H, KV, dh, causal in TRAIN_ATTN:
        attention_rows(torch, F, dts, randn, record, slow, label, B, S, S, H,
                       KV, dh, causal, 0, 0)
    for args in MASK_ATTN + LOCAL_ATTN:
        attention_rows(torch, F, dts, randn, record, slow, *args)
    local_attention_through_ops(torch, dts, randn)

    proj_vjp_rows(torch, dts, randn, record, slow, TRAIN_PROJ)


def proj_vjp_rows(torch, dts, randn, record, n_iter, shapes):
    """The QKV projection's VJP products at each (label, T, D, F) of
    ``shapes``: dX and dW on their transposed contiguous operands, f32 and
    bf16 (library: ``torch.matmul``)."""
    from repro_torch.kernels.qkv import qkv_proj
    from repro_torch.kernels.qkv import ref as qkv_ref

    for label, T, D, Fo in shapes:
        for dt, dtype in dts.items():
            e = torch.tensor([], dtype=dtype).element_size()
            # dX = g (T, F) @ W^T (F, D);  dW = X^T (D, T) @ g (T, F)
            for role, (m, kd, n) in (("dX", (T, Fo, D)), ("dW", (D, T, Fo))):
                sets = [(randn((m, kd), dtype), randn((kd, n), dtype, kd ** -0.5))
                        for _ in range(n_sets((m * kd + kd * n) * e))]
                x, w = sets[0]
                record("matmul_tiled", f"{role} {label} T={m} D={kd} F={n}", dt,
                       qkv_proj.matmul_tiled(x, w),
                       qkv_ref.matmul_reference(x, w), TOL[dt],
                       qkv_proj.matmul_tiled, qkv_ref.matmul_reference,
                       torch.matmul, sets, (m * kd + kd * n + m * n) * e,
                       2.0 * m * kd * n, n_iter=n_iter)


def attention_rows(torch, F, dts, randn, record, n_iter, label, B, Sq, Skv, H,
                   KV, dh, causal, window, q_offset):
    """``mha_forward``, ``mha_bwd_dq`` and ``mha_bwd_dkv`` at one shape and
    mask (see :func:`training_kernel_rows`)."""
    from repro_torch.kernels import lib
    from repro_torch.kernels.attention import mha as mha_k
    from repro_torch.kernels.attention import ref as mha_ref

    kw = dict(causal=causal, window=window, scale=dh ** -0.5,
              q_offset=q_offset)
    shape = (f"{label} B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} dh={dh} "
             f"{'causal' if causal else 'full'}")
    dev = torch.device("cuda")
    ok_mask = mha_ref.visible(Sq, Skv, causal=causal, window=window,
                              q_offset=q_offset, device=dev)
    # (query, key) pairs this run's mask leaves visible
    pairs = B * H * int(ok_mask.sum())
    rows_bytes = B * H * Sq * 4                    # one f32 (BH, Sq) row
    empty = ~ok_mask.any(-1)                       # rows that see no key
    for dt, dtype in dts.items():
        e = torch.tensor([], dtype=dtype).element_size()
        code = lib.DTYPE_CODE[dtype]
        qn, kn = B * H * Sq * dh, B * KV * Skv * dh
        sets = [(randn((B * H, Sq, dh), dtype),
                 randn((B * KV, Skv, dh), dtype),
                 randn((B * KV, Skv, dh), dtype))
                for _ in range(n_sets((2 * qn + 2 * kn) * e))]

        def kern_f(q, k, v):
            return mha_k.mha_forward(q, k, v, return_lse=True, **kw)

        def plain_f(q, k, v):
            return mha_ref.mha_forward_reference(q, k, v, **kw)

        def lib_f(q, k, v):
            return F.scaled_dot_product_attention(
                q.view(B, H, Sq, dh), k.view(B, KV, Skv, dh),
                v.view(B, KV, Skv, dh), is_causal=causal and not window
                and not q_offset, attn_mask=ok_mask if window or q_offset
                else None, scale=kw["scale"], enable_gqa=True)

        q, k, v = sets[0]
        out, ref = kern_f(q, k, v), plain_f(q, k, v)
        full = ~empty   # SDPA gives NaN on a row that sees no key
        lib_err, _ = compare(torch, lib_f(q, k, v).reshape(out[0].shape)[
            :, full], ref[0][:, full], ATTN_TOL[dt])
        print(f"  (library vs plain max_abs_err {lib_err:.3e})")
        record("mha_forward", shape, dt, out, ref, ATTN_TOL[dt], kern_f,
               plain_f, lib_f, sets, (2 * qn + 2 * kn) * e + rows_bytes,
               4.0 * dh * pairs, n_iter=n_iter, again=kern_f(q, k, v))
        if bool(empty.any()):
            zero = bool(torch.all(out[0][:, empty] == 0))
            lse_e = out[1][:, empty]
            lse_ok = bool(torch.isfinite(lse_e).all()) and bool(
                torch.all(lse_e <= -1e29))
            print(f"  (mha_forward {dt}: {int(empty.sum())} rows see no key: "
                  f"output {'exactly 0' if zero else 'NOT 0'}, LSE "
                  f"{'finite, near -1e30' if lse_ok else 'WRONG'} "
                  f"[{float(lse_e.min()):.3e}, {float(lse_e.max()):.3e}]) "
                  f"{'ok' if zero and lse_ok else 'FAIL'}", flush=True)
            check(zero and lse_ok, f"mha_forward {dt} {shape}: empty rows "
                  f"zero {zero}, LSE ok {lse_ok}")
        if dt == "bf16":
            splits, _ = mha_k.forward_plan(code, B * H, B * KV, Sq, Skv, dh,
                                           lib.sm_count(dev))
            # against the mirror's f32 output, which the kernel rounds once
            mirror = mha_ref.mha_forward_tc_reference(
                q, k, v, splits=splits, round_out=False,
                block_rows=mha_k.forward_block_rows(dh), **kw)
            many = ok_mask.sum(-1) >= MIRROR_MIN_KEYS
            # against the mirror's unrounded output (tc_mirror_check) and
            # its f32 LSE, at DECODE_NEW_TOL
            o_err, o_ok, o_text = tc_mirror_check(torch, out[0][:, many],
                                                  mirror[0][:, many])
            o_share = tol_share(torch, out[0][:, many], mirror[0][:, many],
                                DECODE_NEW_TOL[dt])
            l_err, l_ok = compare(torch, out[1], mirror[1],
                                  DECODE_NEW_TOL[dt])
            few = float((out[0][:, ~many].float() - mirror[0][:, ~many])
                        .abs().max()) if bool((~many).any()) else 0.0
            print(f"  (rows that see under {MIRROR_MIN_KEYS} keys: "
                  f"{int((~many).sum())}, output vs the mirror max_abs_err "
                  f"{few:.3e}, held to the plain version at "
                  f"{ATTN_TOL[dt]:g})")
            print(f"  (mha_forward {dt} {shape}: LSE vs the mirror "
                  f"max_abs_err {l_err:.3e} (tol {DECODE_NEW_TOL[dt]:g})) "
                  f"{'ok' if l_ok else 'FAIL'}", flush=True)
            check(l_ok, f"mha_forward {dt} {shape}: mirror LSE error "
                  f"{l_err}")
            mirror_check("mha_forward", dt, shape, splits, o_err, o_ok,
                         o_text, o_share)

        # backward inputs: the plain forward's residuals and a cotangent
        bsets, lsets = [], []
        for q, k, v in sets:
            o, lse = plain_f(q, k, v)
            do = randn((B * H, Sq, dh), dtype)
            delta = (do.float() * o.float()).sum(-1)
            bsets.append((q, k, v, do, lse, delta))
            lq, lk, lv = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            lo = lib_f(lq, lk, lv)
            lsets.append((lo, (lq, lk, lv), do.view(lo.shape)))
        del sets

        def lib_b(lo, leaves, g):
            return torch.autograd.grad(lo, leaves, g, retain_graph=True)

        in_bytes = (2 * qn + 2 * kn) * e + 2 * rows_bytes
        for name, kern, plain, nbytes, flops, plan, mirror_fn in (
                ("mha_bwd_dq", mha_k.mha_bwd_dq, mha_ref.mha_bwd_dq_reference,
                 in_bytes + qn * 4, 6.0 * dh * pairs, mha_k.dq_plan,
                 mha_ref.mha_bwd_dq_tc_reference),
                ("mha_bwd_dkv", mha_k.mha_bwd_dkv,
                 mha_ref.mha_bwd_dkv_reference, in_bytes + 2 * kn * 4,
                 8.0 * dh * pairs, mha_k.dkv_plan,
                 mha_ref.mha_bwd_dkv_tc_reference)):
            def kfn(*a, kern=kern):
                return kern(*a, **kw)

            def pfn(*a, plain=plain):
                return plain(*a, **kw)

            out, ref = kfn(*bsets[0]), pfn(*bsets[0])
            record(name, shape, dt, out, ref, BWD_TOL[dt], kfn, pfn, lib_b,
                   bsets, nbytes, flops, n_iter=n_iter, lib_sets=lsets,
                   again=kfn(*bsets[0]))
            if name == "mha_bwd_dq" and bool(empty.any()):
                zero = bool(torch.all(out[:, empty] == 0))
                print(f"  (mha_bwd_dq {dt}: rows that see no key: dq "
                      f"{'exactly 0' if zero else 'NOT 0'}) "
                      f"{'ok' if zero else 'FAIL'}", flush=True)
                check(zero, f"mha_bwd_dq {dt} {shape}: empty rows not 0")
            if dt == "bf16" and dh > mha_k.TC_MAX_HEAD_DIM:
                # the CUDA-core kernel: f32 FMAs on the bf16 values, one run
                splits, _ = plan(code, B * H, B * KV, Sq, Skv, dh,
                                 lib.sm_count(dev))
                print(f"  ({name} {dt} {shape}: the CUDA-core route, "
                      f"{splits} split, held to the plain version at "
                      f"{BWD_TOL[dt]:g}) {'ok' if splits == 1 else 'FAIL'}",
                      flush=True)
                check(splits == 1, f"{name} {dt} {shape}: {splits} splits "
                      f"on the CUDA-core route")
            elif dt == "bf16":
                splits, _ = plan(code, B * H, B * KV, Sq, Skv, dh,
                                 lib.sm_count(dev))
                run_cap_check(mha_ref, name, shape, splits, Sq, Skv, H // KV,
                              kw)
                mirror = mirror_fn(*bsets[0], splits=splits, **kw)
                m_err, m_ok = compare(torch, out, mirror, BWD_MIRROR_TOL)
                mirror_check(name, dt, shape, splits, m_err, m_ok,
                             BWD_MIRROR_TOL, tol_share(torch, out, mirror,
                                                       BWD_MIRROR_TOL))
                del mirror
            del out, ref
        del bsets, lsets


def local_attention_through_ops(torch, dts, randn):
    """``ops.mha`` (the autograd function the models call) forward and
    backward at LOCAL_ATTN's shape, f32 and bf16: the launch counters, set
    to 0 just before, must show each of the three MHA kernels and no plain
    version on the card; the output and the gradients must agree with the
    plain versions' (forward at ATTN_TOL; gradients at BWD_TOL in f32 and
    at TOL in bf16, where ``ops.mha`` rounds them to the inputs' dtype)."""
    from repro_torch.kernels import lib
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention import ref as mha_ref

    _, B, S, _, H, KV, dh, causal, window, _ = LOCAL_ATTN[0]
    kw = dict(causal=causal, window=window, scale=dh ** -0.5, q_offset=0)
    for dt, dtype in dts.items():
        q = randn((B, S, H, dh), dtype).requires_grad_()
        k = randn((B, S, KV, dh), dtype).requires_grad_()
        v = randn((B, S, KV, dh), dtype).requires_grad_()
        g = randn((B, S, H, dh), dtype)
        lib.STATS.reset()
        out = attn_ops.mha(q, k, v, **kw)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        torch.cuda.synchronize()
        launches = {n: lib.STATS.launches[n] for n in TRAINING_KERNELS[1:]}
        plain = sum(lib.STATS.plain_on_cuda.values())

        def flat(x):
            return x.detach().transpose(1, 2).reshape(-1, S, dh).contiguous()

        fq, fk, fv, fg = flat(q), flat(k), flat(v), flat(g)
        ref_o, lse = mha_ref.mha_forward_reference(fq, fk, fv, **kw)
        delta = (fg.float() * ref_o.float()).sum(-1)
        ref_dq = mha_ref.mha_bwd_dq_reference(fq, fk, fv, fg, lse, delta,
                                              **kw)
        ref_dk, ref_dv = mha_ref.mha_bwd_dkv_reference(fq, fk, fv, fg, lse,
                                                       delta, **kw)
        f_err, f_ok = compare(torch, flat(out), ref_o, ATTN_TOL[dt])
        gtol = BWD_TOL[dt] if dt == "f32" else TOL[dt]
        g_err, g_ok = compare(torch, (flat(dq), flat(dk), flat(dv)),
                              (ref_dq, ref_dk, ref_dv), gtol)
        ok = (f_ok and g_ok and plain == 0
              and all(n == 1 for n in launches.values()))
        print(f"  (ops.mha {dt} recurrentgemma-2b local B={B} S={S} H={H} "
              f"KV={KV} dh={dh} window={window}: launches {launches}, plain "
              f"on the card {plain}; out max_abs_err {f_err:.3e} (tol "
              f"{ATTN_TOL[dt]:g}), dq/dk/dv {g_err:.3e} (tol {gtol:g})) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"ops.mha {dt} at dh {dh}: launches {launches}, plain "
              f"{plain}, errors {f_err} / {g_err}")
        del q, k, v, g, out, dq, dk, dv, ref_o, ref_dq, ref_dk, ref_dv


def run_cap_check(mha_ref, name, shape, splits, Sq, Skv, group, kw):
    """The backward plans' run caps: the longest run that ``splits`` gives
    the kernel's geometry (64-row blocks of 64-key tiles for dq, 64-key
    blocks of 64-row items for dk/dv; the mirrors' run enumerations) stays
    within ``ref.DQ_RUN_KEYS`` keys or ``ref.DKV_RUN_ITEMS`` items."""
    mask = dict(causal=kw["causal"], window=kw["window"],
                q_offset=kw["q_offset"], splits=splits)
    if name == "mha_bwd_dq":
        longest = max((hi - lo for _, _, runs in mha_ref.dq_runs(Sq, Skv, **mask)
                       for lo, hi in runs), default=0)
        cap, unit = mha_ref.DQ_RUN_KEYS, "keys"
    else:
        longest = max((hi - lo for *_, runs in mha_ref.dkv_runs(
            Sq, Skv, group, **mask) for lo, hi in runs), default=0)
        cap, unit = mha_ref.DKV_RUN_ITEMS, "items"
    ok = longest <= cap
    print(f"  ({name} {shape}: {splits} splits, longest run {longest} {unit}"
          f" (cap {cap})) {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name} {shape}: a run of {longest} {unit} past the cap {cap}")


def mirror_check(name, dt, shape, splits, err, ok, tol, share):
    """``tol``: the gate, a number or its text."""
    tol = tol if isinstance(tol, str) else f"tol {tol:g}"
    print(f"  ({name} {dt} {shape}: vs the tensor-core mirror ({splits} "
          f"splits) max_abs_err {err:.3e} ({tol}, {share:.2f} of it)) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name} {dt} {shape}: mirror error {err}")


def scan_kernel_rows(torch, dts, randn, record, iters):
    """The two linear-recurrence kernels at the serving shapes of their
    models and at prompt length (SCAN_LONG; monolithic prefill calls the
    scans at a whole prompt).  ``rglru_scan``: recurrentgemma-2b's
    256-token chunk and a 4096-token prompt, B=1, R=2560, and the chunk at
    a TP=2 rank's R=1280 (a = sigmoid of a
    normal draw, b normal x 0.1; f32 inputs on the main path, bf16 inputs
    checked too); the kernel runs every step in the plain version's order
    and rounding, so it must equal it bit for bit.  ``wkv6_scan``:
    rwkv6-1.6b's 256-token chunk and a 2048-token prompt (32 chunks),
    B·H=32, dh=64, chunk 64, without and with a random carried state s0
    (the main path always carries one), out and s_final both checked; r,
    k, v in f32 or bf16 and logw in f32, as the model makes them; the C
    plan's workspace equal to ``linear_scan.wkv6_workspace_elems``.
    Without s0 the kernel is also held to the sequential recurrence (JAX's
    chunked-vs-sequential tolerance, 1e-4 / rtol 1e-3; at prompt length
    in f32 only).  Every launch is relaunched and must give the same bits.
    No single PyTorch call computes either scan, so they have no library
    time.  Both run every product on f32 FMA units, so their operation
    bound is at the f32 rate whatever the input type."""
    for S in (256, SCAN_LONG["rglru_scan"]):
        rglru_rows(torch, dts, randn, record, S, 2560)

    for S in (256, SCAN_LONG["wkv6_scan"]):
        wkv6_rows(torch, dts, randn, record, S, 32)


def wkv6_rows(torch, dts, randn, record, S, BH):
    """``wkv6_scan`` at B·H = ``BH`` heads of 64 over S steps, chunk 64
    (see :func:`scan_kernel_rows`)."""
    from repro_torch.kernels.scan import linear_scan
    from repro_torch.kernels.scan import ref as scan_ref

    f32 = torch.float32
    dh, C = 64, 64
    n_chunks = S // C
    # multiply-adds the chunked form needs: inter and state 2 C dh^2
    # each, the strictly lower scores and their product with v C (C-1)
    # dh each, the diagonal bonus and the elementwise decay terms
    flops = float(n_chunks * BH * (4 * C * dh * dh + 2 * C * (C - 1) * dh
                                   + 8 * C * dh + 2 * dh * dh))
    n_ws = linear_scan.wkv6_plan(BH, S, dh, C)[1]
    want = linear_scan.wkv6_workspace_elems(BH, S, dh, C)
    print(f"  (wkv6_scan BH={BH} S={S}: the C plan's workspace {n_ws} f32, "
          f"the Python formula {want}) {'ok' if n_ws == want else 'FAIL'}",
          flush=True)
    check(n_ws == want, f"wkv6_scan BH={BH} S={S}: plan workspace {n_ws} "
          f"!= {want}")
    for dt, dtype in dts.items():
        e = torch.tensor([], dtype=dtype).element_size()
        for carried in (False, True):
            def operands():
                r, k, v = (randn((BH, S, dh), dtype, 0.5)
                           for _ in range(3))
                logw = -torch.exp(torch.clamp(randn((BH, S, dh), f32),
                                              -20, 0))
                u = randn((BH, dh), f32, 0.5)
                s0 = randn((BH, dh, dh), f32) if carried else None
                return r, k, v, logw, u, s0

            per = 3 * BH * S * dh * e + 4 * BH * S * dh
            sets = [operands() for _ in range(n_sets(per))]

            def kern(r, k, v, logw, u, s0):
                return linear_scan.wkv6_scan(r, k, v, logw, u, s0,
                                             chunk=C)

            def plain(r, k, v, logw, u, s0):
                return scan_ref.wkv6_chunked_reference(r, k, v, logw, u,
                                                       s0, chunk=C)

            out = kern(*sets[0])
            state_bytes = 4 * BH * dh * dh * (2 if carried else 1)
            record("wkv6_scan", f"BH={BH} S={S} dh={dh} chunk={C} "
                   f"s0={'random' if carried else 'none'} (logw f32)", dt,
                   out, plain(*sets[0]), TOL[dt], kern, plain, None, sets,
                   per + 4 * BH * dh + 4 * BH * S * dh + state_bytes,
                   flops, ops_dt="f32", again=kern(*sets[0]))
            if not carried and (S == 256 or dt == "f32"):
                seq = scan_ref.wkv6_reference(*sets[0][:5])
                err = float((out[0] - seq).abs().max())
                ok = bool(torch.all((out[0] - seq).abs()
                                    <= 1e-4 + 1e-3 * seq.abs()))
                print(f"  (wkv6_scan {dt} S={S} vs the sequential "
                      f"recurrence: max_abs_err {err:.3e}, limit 1e-4 + "
                      f"1e-3 |ref| {'ok' if ok else 'FAIL'})", flush=True)
                check(ok, f"wkv6_scan {dt} S={S} differs from the "
                      f"sequential recurrence by {err}")
            del sets


def rglru_rows(torch, dts, randn, record, S, R, B=1):
    """``rglru_scan`` at (B, S, R), f32 and bf16 inputs (a = sigmoid of a
    normal draw, b normal x 0.1): bit-equal to its plain version and
    relaunched for bit identity; no library call computes it."""
    from repro_torch.kernels.scan import linear_scan
    from repro_torch.kernels.scan import ref as scan_ref

    f32 = torch.float32
    for dt, dtype in dts.items():
        e = torch.tensor([], dtype=dtype).element_size()
        sets = [(torch.sigmoid(randn((B, S, R), f32)).to(dtype),
                 randn((B, S, R), dtype, 0.1))
                for _ in range(n_sets(2 * B * S * R * e))]
        a, b = sets[0]
        out, ref = linear_scan.rglru_scan(a, b), \
            scan_ref.rglru_reference(a, b)
        equal = bool(torch.equal(out, ref))
        row = record("rglru_scan", f"B={B} S={S} R={R}", dt, out, ref,
                     RGLRU_TOL[dt], linear_scan.rglru_scan,
                     scan_ref.rglru_reference, None, sets,
                     2 * B * S * R * e + 4 * B * S * R, 2.0 * B * S * R,
                     ops_dt="f32", again=linear_scan.rglru_scan(a, b))
        row.update(bit_equal_plain=equal)
        print(f"  (rglru_scan {dt} S={S} R={R}: "
              f"{'bit-equal to' if equal else 'DIFFERS from'} the plain "
              f"version) {'ok' if equal else 'FAIL'}", flush=True)
        check(equal, f"rglru_scan {dt} S={S} R={R} is not bit-equal "
              f"to its plain version")
        del sets


# ---------------------------------------------------------------------------
# phase 4: the paper's Table I topology through the three impls
# ---------------------------------------------------------------------------


def table_one_phase(torch, seed):
    """examples/quickstart.py on the card: SL=64, d_model=768, h=8, f32,
    non-causal; the xla and pallas impls against the reference; then the
    pallas impl in bf16 against the reference on the same inputs."""
    from repro_torch.core import famous

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, SL, D, H = 1, 64, 768, 8
    dh = D // H
    x = torch.randn((B, SL, D), generator=gen, device=dev)
    ws = [torch.randn((D, H, dh), generator=gen, device=dev) * 0.05
          for _ in range(3)]
    outs = {}
    for impl in ("reference", "xla", "pallas"):
        cfg = famous.FamousConfig(impl=impl, tile_d=64, tile_q=64, tile_k=64)
        q, k, v = famous.qkv_projection(x, *ws, cfg=cfg)
        outs[impl] = famous.attention(q, k, v, causal=False, cfg=cfg)
    torch.cuda.synchronize()
    ref = outs["reference"]
    errs = {impl: float((outs[impl] - ref).abs().max())
            for impl in ("xla", "pallas")}
    ok = all(e < 1e-4 for e in errs.values()) and all(
        bool(torch.isfinite(o).all()) for o in outs.values())
    print(f"table I (SL={SL}, d_model={D}, h={H}, f32): attention out "
          f"{tuple(ref.shape)}, mean {float(ref.mean()):+.6f}; max|xla - "
          f"reference| = {errs['xla']:.2e}, max|pallas - reference| = "
          f"{errs['pallas']:.2e} (limit 1e-4) {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, f"Table I impls disagree: {errs}")

    # bf16: the pallas impl (the tensor-core forward, dh = 96) against the
    # reference on the same bf16 inputs, at the kernels' bf16 tolerance
    tiles = dict(tile_d=64, tile_q=64, tile_k=64)
    bq, bk, bv = (t.to(torch.bfloat16) for t in famous.qkv_projection(
        x, *ws, cfg=famous.FamousConfig(impl="reference", **tiles)))
    outs_bf16 = {impl: famous.attention(
        bq, bk, bv, causal=False, cfg=famous.FamousConfig(impl=impl, **tiles))
        for impl in ("reference", "pallas")}
    b_err, b_ok = compare(torch, outs_bf16["pallas"], outs_bf16["reference"],
                          ATTN_TOL["bf16"])
    print(f"table I bf16: max|pallas - reference| = {b_err:.2e} (tol "
          f"{ATTN_TOL['bf16']:g}) {'ok' if b_ok else 'FAIL'}", flush=True)
    check(b_ok, f"Table I bf16 impls disagree: {b_err}")
    errs["bf16_pallas"] = b_err

    # the paper's 8-bit projection: the int8 kernel (pallas) against plain
    # torch ops (xla: int8_einsum), exactly on the projection; mha_block
    # through both, and its output against the fp block's
    params = dict(zip(("wq", "wk", "wv"), ws))
    params["wo"] = torch.randn((H, dh, D), generator=gen, device=dev) * 0.05
    kw = dict(num_heads=H, num_kv_heads=H, causal=False)
    proj, blocks = {}, {}
    for impl in ("pallas", "xla"):
        cfg = famous.FamousConfig(impl=impl, quant="int8", tile_q=64,
                                  tile_k=64)
        proj[impl] = famous.qkv_projection(x, *ws, cfg=cfg)
        blocks[impl] = famous.mha_block(x, params, cfg=cfg, **kw)
    fp = famous.mha_block(x, params, cfg=famous.FamousConfig(
        impl="pallas", tile_q=64, tile_k=64), **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(proj["pallas"], proj["xla"]))
    blk_err = float((blocks["pallas"] - blocks["xla"]).abs().max())
    q_err = float((fp - blocks["pallas"]).abs().max())
    blk_ok = (blk_err < 1e-4 * max(1.0, float(blocks["xla"].abs().max()))
              and bool(torch.isfinite(blocks["pallas"]).all()))
    print(f"table I int8 (quant='int8'): projection kernel == plain "
          f"{'exactly' if exact else 'NOT exactly'}; mha_block out "
          f"{tuple(fp.shape)} max|pallas - xla| = {blk_err:.2e} (limit 1e-4 "
          f"relative); int8 vs fp block max|diff| = {q_err:.3e} (max|out| "
          f"{float(fp.abs().max()):.3e}) {'ok' if exact and blk_ok else 'FAIL'}",
          flush=True)
    check(exact and blk_ok, f"Table I int8: projection exact {exact}, block "
          f"error {blk_err}")
    errs.update(int8_projection_exact=exact, int8_block_err=blk_err,
                int8_vs_fp_block_err=q_err)
    return errs


# ---------------------------------------------------------------------------
# phase 5: slice parity at full width
# ---------------------------------------------------------------------------


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def random_params(torch, cfg, dtype, seed, prepare=True):
    """Random weights on the card; biases and norm scales drawn too, so a
    bias or scale fault shows in the logits.  The serving layout, or with
    ``prepare=False`` the spec tree (which a mesh engine shards)."""
    from repro_torch.models import module, transformer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = transformer.model_spec(cfg)
    # an MoE config's expert stacks are drawn last, one at a time, with the
    # cache emptied before each: a stack's f32 draw (22.5 GB for kimi-k2)
    # then takes a segment that no lasting tensor shares, and is released
    blocks = [("blocks", k) for k in spec["blocks"]] + [
        (k,) for k in spec if k.startswith("tail")]
    held = [(path, name, _at(spec, path)["ffn"].pop(name))
            for path in blocks if cfg.num_experts
            and "ffn" in _at(spec, path)
            for name in ("w_in", "w_gate", "w_out")]
    tree = module.init_params(spec, gen, dtype, dev)
    for path, name, leaf in held:
        gc.collect()
        torch.cuda.empty_cache()
        _at(tree, path)["ffn"][name] = module.init_params(leaf, gen, dtype,
                                                          dev)
    if held:
        gc.collect()
        torch.cuda.empty_cache()

    def fill(path_tree):
        for name, leaf in path_tree.items():
            if isinstance(leaf, dict):
                fill(leaf)
            elif name.startswith("b"):
                leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev)
                           * 0.1)
            elif name == "scale":
                leaf.copy_(1 + 0.1 * torch.randn(leaf.shape, generator=gen,
                                                 device=dev))

    fill(tree)
    return transformer.prepare_params(tree, cfg) if prepare else tree


def slice_phase(torch, seed):
    """The 2-layer full-width cut through ``prefill_chunk`` + ``decode_step``
    on contiguous caches, on paged pools (a 513-page pool of 16-token pages,
    page ids a seeded permutation), in bf16 on int8 pools, and with the
    int8 projection (``quant="int8"``, contiguous caches; the kernels on
    weights quantized once by ``transformer.quantize_qkv``): the kernels
    (``impl="pallas"``) against plain torch ops (``impl="xla"``) on the
    same weights, and at f32 the paged kernels against the contiguous
    ones.  The int8 projection's logits against the fp ones are reported.
    Then, at f32, ``verify_step`` against sequential ``decode_step``."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen,
                           device=dev)
    n_slots, max_seq, C, n, ps, n_pages = 4, 2048, 256, 400, 16, 513
    pt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(n_slots, max_seq // ps).contiguous()
    results = {}

    def run(params, dtype, impl, kind):
        quant = "int8" if kind == "int8 projection" else "none"
        fcfg = FamousConfig(impl=impl, quant=quant)
        if quant == "int8" and impl == "pallas":
            params = transformer.quantize_qkv(params)
        if kind in ("contiguous", "int8 projection"):
            caches = transformer.make_caches(cfg, n_slots, max_seq, dtype,
                                             dev)
            kw = {}
        else:
            caches = transformer.make_caches(
                cfg, n_slots, max_seq, dtype, dev, cache_kind="paged",
                page_size=ps, n_pages=n_pages,
                kv_dtype="int8" if kind == "int8" else "fp")
            kw = {"page_table": pt}
        for start in (0, C):
            transformer.prefill_chunk(
                params, prompt[:, start:start + C], caches, 1, start,
                min(C, n - start), cfg, fcfg, **kw)
        last = torch.tensor([5, int(prompt[0, n - 1]), 9, 11], device=dev)
        clen = torch.tensor([0, n - 1, 0, 0], dtype=torch.int32, device=dev)
        lg, _ = transformer.decode_step(params, last, caches, clen, cfg, fcfg,
                                        **kw)
        return lg

    # tolerance relative to the largest logit: f32 differs only in the
    # order of sums; bf16 also rounds q/k/v and the attention output at
    # other places on the two paths (int8 pools quantize what each path
    # wrote), and 2 layers carry that to the logits
    for dt, dtype, tol, kinds in (
            ("f32", torch.float32, 1e-4,
             ("contiguous", "paged", "int8 projection")),
            ("bf16", torch.bfloat16, 5e-2,
             ("contiguous", "paged", "int8", "int8 projection"))):
        params = random_params(torch, cfg, dtype, seed)
        logits = {(kind, impl): run(params, dtype, impl, kind)
                  for kind in kinds for impl in ("pallas", "xla")}
        torch.cuda.synchronize()
        pairs = [(kind, (kind, "pallas"), (kind, "xla")) for kind in kinds]
        if dt == "f32":
            pairs.append(("paged vs contiguous kernels", ("paged", "pallas"),
                          ("contiguous", "pallas")))
        for label, a, b in pairs:
            ref = logits[b]
            err = float((logits[a] - ref).abs().max())
            limit = tol * float(ref.abs().max())
            finite = bool(torch.isfinite(logits[a]).all())
            key = dt if label == "contiguous" else f"{dt} {label}"
            results[key] = dict(max_abs_err=err, limit=limit,
                                max_abs_logit=float(ref.abs().max()),
                                shape=list(ref.shape))
            what = (label if label.endswith("kernels")
                    else f"{label}: kernels vs plain")
            print(f"slice parity {dt} {what}: 2-layer qwen2-7b at full "
                  f"width, logits {tuple(ref.shape)}, max|diff| = "
                  f"{err:.3e} (limit {limit:.3e} = {tol:g} * max|logit|)",
                  flush=True)
            check(finite and err <= limit,
                  f"slice parity {key} failed: {results[key]}")
        q_err = float((logits[("int8 projection", "pallas")]
                       - logits[("contiguous", "pallas")]).abs().max())
        results[f"{dt} int8 vs fp projection"] = dict(max_abs_err=q_err)
        print(f"slice {dt}: int8 vs fp projection (kernels), max|logit "
              f"diff| = {q_err:.3e} (max|logit| "
              f"{float(logits[('contiguous', 'pallas')].abs().max()):.3e}; "
              f"reported, not gated)", flush=True)
        if dt == "f32":
            results["verify"] = verify_parity(torch, cfg, params, prompt, pt,
                                              n, C, ps, n_pages)
        del params, logits
        torch.cuda.empty_cache()
    return results


def verify_parity(torch, cfg, params, prompt, pt, n, C, ps, n_pages, W=5):
    """``verify_step`` of W tokens a slot against W sequential
    ``decode_step`` calls from the same caches, through the kernels at
    f32, on contiguous caches, paged pools and int8 pools.  Slot 1 holds a
    prefilled prompt of ``n`` tokens; slots 0, 2 and 3 are empty and
    verify from position 0.  Limit: 1e-4 x max|logit| (sums in another
    order: the projection and MLP see 20 rows instead of 4)."""
    from repro_torch.core.famous import FamousConfig
    from repro_torch.models import transformer
    from repro_torch.serve import graphs

    dev = torch.device("cuda")
    fcfg = FamousConfig(impl="pallas")
    gen = torch.Generator(device=dev).manual_seed(n)
    toks = torch.randint(0, cfg.vocab_size, (4, W), generator=gen, device=dev)
    toks[1, 0] = prompt[0, n - 1]
    clen = torch.tensor([0, n - 1, 0, 0], dtype=torch.int32, device=dev)
    out = {}
    for kind in ("contiguous", "paged", "int8"):
        kw = {}
        if kind == "contiguous":
            caches = transformer.make_caches(cfg, 4, 2048, torch.float32, dev)
        else:
            caches = transformer.make_caches(
                cfg, 4, 2048, torch.float32, dev, cache_kind="paged",
                page_size=ps, n_pages=n_pages,
                kv_dtype="int8" if kind == "int8" else "fp")
            kw = {"page_table": pt}
        for start in (0, C):
            transformer.prefill_chunk(params, prompt[:, start:start + C],
                                      caches, 1, start, min(C, n - start),
                                      cfg, fcfg, **kw)
        seq = [{k: v.clone() for k, v in c.items()} for c in caches]
        with graphs.no_host_sync(dev):
            vlog, _ = transformer.verify_step(params, toks, caches, clen,
                                              cfg, fcfg, **kw)
        slog = torch.stack([transformer.decode_step(
            params, toks[:, j], seq, clen + j, cfg, fcfg, **kw)[0]
            for j in range(W)], dim=1)
        torch.cuda.synchronize()
        err = float((vlog - slog).abs().max())
        limit = 1e-4 * float(slog.abs().max())
        finite = bool(torch.isfinite(vlog).all())
        out[kind] = dict(max_abs_err=err, limit=limit,
                         shape=list(vlog.shape))
        print(f"verify parity f32 {kind}: verify_step of {W} tokens x 4 "
              f"slots vs {W} sequential decode_steps (kernels), logits "
              f"{tuple(vlog.shape)}, max|diff| = {err:.3e} (limit "
              f"{limit:.3e}) {'ok' if finite and err <= limit else 'FAIL'}",
              flush=True)
        check(finite and err <= limit, f"verify parity {kind}: {out[kind]}")
        del caches, seq
    return out


# ---------------------------------------------------------------------------
# phase 6: training parity at full width
# ---------------------------------------------------------------------------

# (loss, global grad norm, every leaf's ||pallas - xla|| / ||xla||), relative
TRAIN_TOL = {"f32": (1e-5, 1e-4, 1e-3), "bf16": (5e-3, 2e-2, 5e-2)}


# the training parity cuts at full width: arch, layers, S.
# recurrentgemma-2b's one (RG-LRU, RG-LRU, local attention) unit over 3072
# tokens, past its 2048-token window (the MHA kernels at dh 256; the
# RG-LRU differentiated through the models' associative scan on both
# impls); qwen3-32b's 2 layers (qk-norm, dh 80)
TRAIN_PARITY = (("qwen2-7b", 2, 2048), ("recurrentgemma-2b", 3, 3072),
                ("qwen3-32b", 2, 2048))


def train_parity_phase(torch, seed):
    return {f"{arch} {layers}": train_parity(torch, seed, arch, layers, S)
            for arch, layers, S in TRAIN_PARITY}


def train_parity(torch, seed, arch, layers, S):
    """A ``layers``-layer cut of ``arch`` at full width: the gradient of one
    ``make_train_step`` (its ``grads_of``) on one f32 state and one
    B=1 batch of S tokens, through the kernels (``impl="pallas"``) and
    through plain torch ops (``impl="xla"``), in f32 and in bf16
    compute."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.data import pipeline
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    state = step_lib.init_state(cfg, step_lib.TrainConfig(), gen, dev)
    params = state.pop("params")
    del state
    batch = pipeline.device_batch(
        cfg, ShapeConfig("parity", S, 1, "train"), seed, 0, dev)
    results = {}
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tcfg = step_lib.TrainConfig(compute_dtype=dtype)
        got = {}
        for impl in ("pallas", "xla"):
            step = step_lib.make_train_step(cfg, FamousConfig(impl=impl), tcfg)
            loss, grads = step.grads_of(params, batch)
            got[impl] = (float(loss), float(adamw.global_norm(grads)),
                         tree_leaves(grads))
        (lp, np_, gp), (lx, nx, gx) = got["pallas"], got["xla"]
        leaf_err = max(float(torch.linalg.vector_norm((a - b).float())
                             / torch.linalg.vector_norm(b.float()))
                       for a, b in zip(gp, gx))
        errs = (abs(lp - lx) / abs(lx), abs(np_ - nx) / nx, leaf_err)
        tol = TRAIN_TOL[dt]
        ok = all(e <= t for e, t in zip(errs, tol)) and math.isfinite(lp)
        results[dt] = dict(loss_pallas=lp, loss_xla=lx, gnorm_pallas=np_,
                           gnorm_xla=nx, rel_errs=errs, tol=tol)
        print(f"train parity {dt}: {layers}-layer {arch} at full width, B=1 "
              f"S={S}: loss {lp:.6f} vs {lx:.6f} (rel {errs[0]:.2e}, tol "
              f"{tol[0]:g}), grad norm {np_:.6f} vs {nx:.6f} (rel "
              f"{errs[1]:.2e}, tol {tol[1]:g}), worst leaf ||pallas - "
              f"xla||/||xla|| {errs[2]:.2e} (tol {tol[2]:g}) over "
              f"{len(gp)} leaves {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"training parity {arch} {dt} failed: {results[dt]}")
        del got, gp, gx
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 7: training runs through the launcher's build + Trainer
# ---------------------------------------------------------------------------


def training_run(torch, label, arch, shape, steps, seed, ckpt_every,
                 num_layers=None, kernels=TRAINING_KERNELS):
    """``launch.train.build`` + ``Trainer`` on the card with bf16 compute
    and a 5-step warmup; the launch counters cover exactly this run, and
    each of ``kernels`` (the path's) must have launched."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import lib
    from repro_torch.launch import train as train_launch
    from repro_torch.models.module import tree_leaves
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import step as step_lib
    from repro_torch.train import trainer as trainer_lib

    cfg = get_config(arch)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    tcfg = step_lib.TrainConfig(schedule_warmup=5)
    cfg, state, train_step, batch_fn = train_launch.build(
        arch, shape, smoke=False, tcfg=tcfg, seed=seed, device="cuda",
        cfg=cfg)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_") if ckpt_every \
        else None
    try:
        tr = trainer_lib.Trainer(
            train_step, state, batch_fn,
            trainer_lib.TrainerConfig(total_steps=steps,
                                      ckpt_every=ckpt_every or steps,
                                      ckpt_dir=ckpt_dir))
        torch.cuda.synchronize()
        lib.STATS.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(lib.STATS.launches)
        plain = dict(lib.STATS.plain_on_cuda)
        saved = ckpt_lib.all_steps(ckpt_dir) if ckpt_dir else []
    finally:
        if ckpt_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    # one more step, profiled: device time by kernel group, and the share
    # of the step's host-clock time the device sat idle
    batch = batch_fn(steps)
    t1 = time.perf_counter()
    prof = profile_groups(torch, lambda: train_step(tr.state, batch))
    prof_wall_ms = (time.perf_counter() - t1) * 1e3
    log = tr.metrics_log
    losses = [m["loss"] for m in log]
    step_ms = sorted(m["dt"] for m in log[1:])[len(log[1:]) // 2] * 1e3
    toks = shape.global_batch * shape.seq_len
    res = dict(arch=cfg.name, layers=cfg.num_layers, params=n_params,
               batch=shape.global_batch, seq=shape.seq_len, steps=len(log),
               losses=losses, grad_norms=[m["grad_norm"] for m in log],
               step_ms_median=step_ms, first_step_ms=log[0]["dt"] * 1e3,
               tokens_per_s=toks / (step_ms / 1e3), wall_s=wall,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, checkpoints=saved, profiled_step=prof,
               profiled_step_wall_ms=prof_wall_ms)
    print(f"train {label}: {cfg.name} {cfg.num_layers} layers "
          f"({n_params / 1e9:.3f}B params), B={shape.global_batch} "
          f"S={shape.seq_len} bf16, {len(log)} steps in {wall:.1f}s: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (last-5 mean "
          f"{sum(losses[-5:]) / len(losses[-5:]):.4f}), step "
          f"{step_ms:.1f} ms median (first {res['first_step_ms']:.0f} ms), "
          f"{res['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{res['peak_mem_gb']:.1f} GB, checkpoints {saved}", flush=True)
    print(f"  launches {json.dumps(launches)}", flush=True)
    print(f"  profiled step: {prof_wall_ms:.1f} ms wall, device "
          f"{prof['device_ms']:.1f} ms: {group_text(prof['by_group_ms'])}",
          flush=True)
    check(all(launches[k] > 0 for k in kernels),
          f"{label}: a kernel never launched on the training path: "
          f"{launches}")
    check(len(log) == steps and tr.restarts == 0,
          f"{label}: {len(log)} of {steps} steps, {tr.restarts} restarts")
    check(all(math.isfinite(x) for x in losses), f"{label}: loss {losses}")
    check(not any(plain.values()),
          f"{label}: a plain version ran on CUDA tensors: {plain}")
    del tr, state, train_step
    torch.cuda.empty_cache()
    return res


def training_phase(torch, seed):
    from repro_torch.configs.base import ShapeConfig

    bert = training_run(torch, "famous-bert --full", "famous-bert",
                        ShapeConfig("bert_512", 512, 8, "train"), 30, seed,
                        ckpt_every=10)
    losses = bert["losses"]
    check(sum(losses[-5:]) / 5 < losses[0],
          f"famous-bert: the loss did not fall over 30 steps: {losses}")
    check(bert["checkpoints"] == [10, 20, 30],
          f"famous-bert: checkpoints {bert['checkpoints']}")
    qwen = training_run(torch, "qwen2-7b 2 layers", "qwen2-7b",
                        ShapeConfig("qwen_2048", 2048, 1, "train"), 5, seed,
                        ckpt_every=0, num_layers=2)
    # the recurrent families at full width, cut depth: recurrentgemma-2b's
    # local attention trains through the MHA kernels at dh 256, its RG-LRU
    # and all of rwkv6-1.6b through the models' torch scans (no kernel of
    # this repo runs on rwkv6-1.6b's training path)
    shape = ShapeConfig("recurrent_2048", 2048, 1, "train")
    rg = training_run(torch, "recurrentgemma-2b 2 units",
                      "recurrentgemma-2b", shape, 5, seed, ckpt_every=0,
                      num_layers=6)
    rw = training_run(torch, "rwkv6-1.6b 2 layers", "rwkv6-1.6b", shape, 5,
                      seed, ckpt_every=0, num_layers=2, kernels=())
    return {"famous-bert": bert, "qwen2-7b-2layer": qwen,
            "recurrentgemma-2b-2unit": rg, "rwkv6-1.6b-2layer": rw}


# ---------------------------------------------------------------------------
# phase 8: serving the full model
# ---------------------------------------------------------------------------


def sync_mode_check(torch):
    """``graphs.no_host_sync`` (``set_sync_debug_mode("error")``, under
    which every warm-up and capture runs) must raise on a device->host
    copy: otherwise the executables' no-sync gate would hold vacuously."""
    from repro_torch.serve import graphs

    x = torch.ones(2, device="cuda")
    try:
        with graphs.no_host_sync(x.device):
            x.cpu()
    except RuntimeError:
        print("graphs: set_sync_debug_mode('error') raises on a device->host "
              "copy (warm-up and capture run under it)", flush=True)
        return
    check(False, "set_sync_debug_mode('error') let a device->host copy "
          "through")


class _PhaseClock:
    """An engine observer's wrapper that adds up the host seconds of each
    engine phase: ``prefill_chunk`` spans are a chunk's staging and
    dispatch (eager kernels, or with graphs one replay, whose device time
    lands in the next sync), and ``decode`` / ``verify`` spans end in the
    step's device->host sync.  Everything else goes to the wrapped
    observer."""

    def __init__(self, inner):
        self.inner = inner
        self.host_s = {}

    @contextlib.contextmanager
    def phase(self, name, **args):
        t = time.perf_counter()
        with self.inner.phase(name, **args):
            yield
        self.host_s[name] = (self.host_s.get(name, 0.0)
                             + time.perf_counter() - t)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def serve_once(torch, make_engine, reqs, eager):
    """``make_engine()`` serves ``reqs`` to the end, every step eager when
    ``eager`` (``graphs.disable_capture()``), else with the steps'
    graphs, its phases timed by :class:`_PhaseClock`.  Returns (requests
    by rid, engine, launches, plain-on-CUDA counts, wall seconds)."""
    from repro_torch.kernels import lib
    from repro_torch.serve import graphs

    engine = make_engine()
    engine.obs = _PhaseClock(engine.obs)
    torch.cuda.synchronize()
    lib.STATS.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with graphs.disable_capture() if eager else contextlib.nullcontext():
        done = sorted(engine.run(reqs), key=lambda r: r.rid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (done, engine, dict(engine.kernel_launches),
            dict(lib.STATS.plain_on_cuda), wall)


def graph_pair(torch, label, make_engine, make_reqs):
    """One serving configuration on two fresh engines: eager first, then
    with graphs (the main path).  Gates: the same tokens, the same kernel
    launch counts (replays counted) and plain-version counts, the graph
    engine's step kind (decode, or verify when speculative) and its
    prefill chunk captured once each and replayed, ``clear`` at most
    once, no kind above 3; a monolithic engine's prefill graphs at most
    one per length served, each replayed.  Returns the graph run
    (requests, engine, launches, plain counts, wall seconds) and the
    pair's record: tok/s and TTFT of both runs, the census, replays, capture seconds, the graph
    pools' bytes and the chunk inputs' staging stalls."""
    import numpy as np

    e_done, e_eng, e_launch, e_plain, e_wall = serve_once(
        torch, make_engine, make_reqs(), eager=True)
    e_census, e_clock = e_eng.compilations, e_eng.obs
    del e_eng
    torch.cuda.empty_cache()
    run = serve_once(torch, make_engine, make_reqs(), eager=False)
    done, engine, launches, plain, wall = run
    kind = "verify" if engine.speculative_active else "decode"
    census = engine.compilations
    stats = engine.graph_stats

    def summary(reqs, seconds, clock):
        toks = sum(len(r.out) for r in reqs)
        ttft = [r.t_first - r.t_submit for r in reqs]
        host = dict(clock.host_s)
        host["rest"] = seconds - sum(host.values())
        return dict(tokens=toks, wall_s=seconds, tok_per_s=toks / seconds,
                    ttft_p50_s=float(np.median(ttft)), host_s=host)

    pair = dict(eager=summary(e_done, e_wall, e_clock),
                graph=summary(done, wall, engine.obs),
                census=census, eager_census=e_census,
                replays=stats["replays"], graph_keys=stats["keys"],
                capture_s=stats["capture_s"], pool_bytes=stats["pool_bytes"],
                pools=stats["pools"], chunk_stalls=stats["chunk_stalls"],
                chunk_stall_s=stats["chunk_stall_s"],
                tokens_equal=[r.out for r in done] == [r.out for r in e_done],
                launches_equal=launches == e_launch)
    g, e = pair["graph"], pair["eager"]
    pool_mib = {k: round(v["bytes"] / 2**20, 1)
                for k, v in stats["pools"].items()}
    print(f"graph parity {label}: tokens identical {pair['tokens_equal']}, "
          f"launches identical {pair['launches_equal']}; eager "
          f"{e['tok_per_s']:.1f} tok/s, TTFT p50 {e['ttft_p50_s'] * 1e3:.0f} "
          f"ms; graphs {g['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{g['ttft_p50_s'] * 1e3:.0f} ms; census {census}, "
          f"{stats['replays'][kind]} {kind} and "
          f"{stats['replays']['prefill']} prefill replays, graphs "
          f"{stats['keys'][kind]}, capture {stats['capture_s']:.2f} s, pools "
          f"{pool_mib} MiB, chunk staging stalls {stats['chunk_stalls']} "
          f"({stats['chunk_stall_s'] * 1e3:.1f} ms); host s by phase: eager "
          f"{ {k: round(v, 3) for k, v in e['host_s'].items()} }, graphs "
          f"{ {k: round(v, 3) for k, v in g['host_s'].items()} }",
          flush=True)
    check(pair["tokens_equal"], f"{label}: graph tokens differ from eager")
    check(pair["launches_equal"] and plain == e_plain,
          f"{label}: launches with graphs {launches} / {plain}, eager "
          f"{e_launch} / {e_plain}")
    if engine.chunked:
        prefill_ok = (census["prefill"] == 1
                      and stats["replays"]["prefill"] > 0)
    else:   # one graph per length used twice, at most one per length
        prefill_ok = census["prefill"] <= len(engine.prefill_keys) and (
            stats["replays"]["prefill"] >= census["prefill"])
    others = [v for k, v in census.items() if k != "prefill"]
    check(census[kind] == 1 and stats["replays"][kind] > 0 and prefill_ok
          and census["clear"] <= 1 and max(others) <= 3
          and (census["prefill"] <= 3 or not engine.chunked)
          and not any(e_census.values()),
          f"{label}: census {census} (eager {e_census}), replays "
          f"{stats['replays']}")
    return run, pair


def guard_warm(torch, label, engine, prompts, cut=512):
    """The warmed graph engine serves 4 fresh requests (the first ``cut``
    tokens of 4 prompts, or whole prompts when ``cut`` is None; 8 new
    tokens each) inside ``retrace_guard``: a warm region must capture
    nothing (a monolithic engine is given prompts whose lengths it has
    captured)."""
    from repro_torch.analysis.retrace_guard import retrace_guard
    from repro_torch.serve.engine import Request

    before = engine.compilations
    reqs = [Request(rid=1000 + i, tokens=list(p[:cut]), max_new=8)
            for i, p in enumerate(prompts[:4])]
    with retrace_guard(engine, label=label):
        done = engine.run(reqs)
    torch.cuda.synchronize()
    check(all(r.error is None and len(r.out) == 8 for r in done),
          f"{label}: guarded batch {[(r.rid, r.error) for r in done]}")
    print(f"retrace guard {label}: 4 fresh requests, census {before} -> "
          f"{engine.compilations}", flush=True)
    return engine.compilations


def serving_phase(torch, seed):
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = get_config("qwen2-7b")
    t0 = time.perf_counter()
    params = random_params(torch, cfg, torch.bfloat16, seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = cfg.param_count()
    sync_mode_check(torch)
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(64, 1537, size=8)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
               for n in lens]

    def make_engine():
        return ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                             n_slots=4, max_seq=2048, dtype=torch.bfloat16,
                             chunk=256, device="cuda")

    def make_reqs():
        return [Request(rid=i, tokens=list(p), max_new=32)
                for i, p in enumerate(prompts)]

    (done, engine, launches, plain, wall), pair = graph_pair(
        torch, "qwen2-7b", make_engine, make_reqs)
    reqs = make_reqs()
    check(len(done) == len(reqs), f"{len(done)} of {len(reqs)} came back")
    errors = [(r.rid, r.error) for r in done if r.error is not None]
    check(not errors, f"requests failed: {errors}")
    for r in done:
        check(len(r.out) == r.max_new, f"request {r.rid} made {len(r.out)}")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"request {r.rid}: token out of range")
    check(all(launches[k] > 0 for k in SERVING_KERNELS),
          f"a kernel never launched on the serving path: {launches}")
    check(not any(plain.values()),
          f"a plain version ran on CUDA tensors: {plain}")
    toks = sum(len(r.out) for r in done)
    ttft = sorted(r.t_first - r.t_submit for r in done)
    res = dict(requests=len(done), prompt_lens=lens, tokens=toks,
               wall_s=wall, tok_per_s=toks / wall,
               ttft_p50_s=float(np.median(ttft)), ttft_max_s=ttft[-1],
               launches=launches, param_count=n_params, init_s=t_init,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"serving: qwen2-7b 28 layers bf16 ({n_params / 1e9:.2f}B params), "
          f"{len(done)} requests (prompts {lens}), {toks} tokens in "
          f"{wall:.2f}s = {toks / wall:.1f} tok/s, TTFT p50 "
          f"{res['ttft_p50_s'] * 1e3:.0f} ms, peak memory "
          f"{res['peak_mem_gb']:.1f} GB", flush=True)
    print("kernels " + json.dumps(launches), flush=True)
    res["graph_pair"] = pair
    res["guard_census"] = guard_warm(torch, "qwen2-7b", engine, prompts)
    res["steps"] = step_breakdown(torch, engine)
    del engine
    torch.cuda.empty_cache()
    res["int8_projection"] = int8_projection_run(
        torch, cfg, params, prompts, [r.out for r in done])
    res["shared_prefix"] = shared_prefix_runs(torch, cfg, params, seed)
    del params
    torch.cuda.empty_cache()
    res["oracle_speculative"] = oracle_speculative_run(torch, seed)
    return res


def int8_projection_run(torch, cfg, params, prompts, fp_tokens):
    """The same 8 requests as the fp run, through the paper's 8-bit QKV_PM
    (``FamousConfig(impl="pallas", quant="int8")``: the engine quantizes
    each layer's fused W once).  Every projection must go through
    ``matmul_tiled_int8``: 28 launches per decode step and per chunk (as
    many as the attention kernels), none of ``matmul_tiled``.  The share
    of tokens equal to the fp run's is reported, not gated (near ties of
    random weights flip under any lossy change)."""
    import numpy as np

    from repro_torch.core.famous import FamousConfig
    from repro_torch.serve.engine import Request, ServingEngine

    def make_engine():
        return ServingEngine(params, cfg,
                             FamousConfig(impl="pallas", quant="int8"),
                             n_slots=4, max_seq=2048, dtype=torch.bfloat16,
                             chunk=256, device="cuda")

    def make_reqs():
        return [Request(rid=i, tokens=list(p), max_new=32)
                for i, p in enumerate(prompts)]

    (done, engine, launches, plain, wall), pair = graph_pair(
        torch, "qwen2-7b int8 projection", make_engine, make_reqs)
    check(len(done) == 8 and all(r.error is None and len(r.out) == 32
                                 for r in done),
          f"int8 projection: {[(r.rid, r.error, len(r.out)) for r in done]}")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          "int8 projection: token out of range")
    check(not any(plain.values()),
          f"int8 projection: a plain version ran on CUDA tensors: {plain}")
    per_step = launches["decode_attention"] + launches["chunk_prefill"]
    check(launches["matmul_tiled"] == 0 and per_step > 0
          and launches["matmul_tiled_int8"] == per_step,
          f"int8 projection: the projection did not run on "
          f"matmul_tiled_int8 once per layer and step: {launches}")
    outs = [r.out for r in done]
    same = sum(a == b for o, r in zip(outs, fp_tokens)
               for a, b in zip(o, r)) / sum(len(r) for r in fp_tokens)
    toks = sum(len(o) for o in outs)
    ttft = sorted(r.t_first - r.t_submit for r in done)
    ttft_steps = [engine.sched.fairness(r.rid)["ttft_steps"] for r in done]
    res = dict(tokens=toks, wall_s=wall, tok_per_s=toks / wall,
               ttft_p50_s=float(np.median(ttft)), ttft_steps=ttft_steps,
               ttft_steps_p50=float(np.median(ttft_steps)),
               token_share_equal_to_fp=same, launches=launches,
               decode_steps=launches["decode_attention"] // cfg.num_layers,
               chunks=launches["chunk_prefill"] // cfg.num_layers)
    print(f"serving int8 projection (FamousConfig(quant='int8'), the same 8 "
          f"requests): {toks} tokens in {wall:.2f}s = {toks / wall:.1f} "
          f"tok/s, TTFT p50 {res['ttft_p50_s'] * 1e3:.0f} ms "
          f"({res['ttft_steps_p50']:g} steps), matmul_tiled_int8 "
          f"{launches['matmul_tiled_int8']} launches = {cfg.num_layers} x "
          f"({res['decode_steps']} decode steps + {res['chunks']} chunks), "
          f"matmul_tiled {launches['matmul_tiled']}; tokens equal to the fp "
          f"run {same:.3f}", flush=True)
    print("kernels " + json.dumps(launches), flush=True)
    res["graph_pair"] = pair
    res["guard_census"] = guard_warm(torch, "qwen2-7b int8 projection",
                                     engine, prompts)
    res["steps"] = step_breakdown(torch, engine)
    del engine
    torch.cuda.empty_cache()
    return res


def oracle_speculative_run(torch, seed):
    """Speculation that exercises accept and rollback at full width: a
    2-layer cut of qwen2-7b at f32 serves 4 requests plainly on the paged
    pool, then speculatively (``draft_k=4``) with a drafter that proposes
    the plain run's own tokens.  Every draft is then accepted, so the run
    takes far fewer steps; its tokens must equal the plain run's."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.kernels import lib
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2)
    params = random_params(torch, cfg, torch.float32, seed + 4)
    rng = np.random.default_rng(seed + 4)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
               for n in (100, 300, 50, 700)]

    class Oracle:
        def __init__(self, ref):
            self.ref = ref

        def draft(self, seq, k):
            for p, out in self.ref:
                if seq[:len(p)] == p:
                    pos = len(seq) - len(p)
                    return out[pos:pos + k]
            return []

    kw = dict(n_slots=4, max_seq=1024, dtype=torch.float32, chunk=256,
              cache_kind="paged", page_size=16, device="cuda")
    runs = {}
    for label, extra in (("plain", {}), ("speculative", dict(
            speculative=True, draft_k=4))):
        if extra:
            extra["drafter"] = Oracle(list(zip(prompts, runs["plain"][0])))
        engine = ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                               **kw, **extra)
        reqs = [Request(rid=i, tokens=list(p), max_new=32)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        lib.STATS.reset()
        t0 = time.perf_counter()
        done = sorted(engine.run(reqs), key=lambda r: r.rid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(lib.STATS.launches)
        check(all(r.error is None and len(r.out) == 32 for r in done),
              f"oracle {label}: {[(r.rid, r.error) for r in done]}")
        check(not any(lib.STATS.plain_on_cuda.values()),
              f"oracle {label}: a plain version ran on CUDA tensors")
        engine.alloc.assert_invariants()
        runs[label] = ([r.out for r in done], engine, wall, launches)
    (ref, _, _, _), (outs, eng, wall, launches) = runs["plain"], \
        runs["speculative"]
    toks = sum(len(o) for o in outs)
    per_slot_step = toks / (toks - eng.spec_accepted)
    res = dict(tokens_equal=outs == ref, spec_steps=eng.spec_steps,
               drafted=eng.spec_drafted, accepted=eng.spec_accepted,
               acceptance_rate=eng.acceptance_rate,
               tokens_per_slot_step=per_slot_step, wall_s=wall,
               plain_wall_s=runs["plain"][2], launches=launches,
               plain_launches=runs["plain"][3])
    print(f"serving oracle speculative (2-layer qwen2-7b f32, paged, "
          f"draft_k=4): tokens equal to the plain run: {outs == ref}; "
          f"{eng.spec_drafted} drafted, {eng.spec_accepted} accepted (rate "
          f"{eng.acceptance_rate:.3f}), {eng.spec_steps} verify steps for "
          f"{toks} tokens ({per_slot_step:.2f} per slot and step); "
          f"{wall:.2f}s vs plain {runs['plain'][2]:.2f}s", flush=True)
    print("kernels " + json.dumps(launches), flush=True)
    check(outs == ref, "oracle speculative: tokens differ from the plain run")
    check(all(launches[k] > 0 for k in PAGED_KERNELS["fp"]),
          f"oracle speculative: paged kernels not launched: {launches}")
    del runs, eng, params
    torch.cuda.empty_cache()
    return res


# phase 8's shared-prefix traffic: the contiguous run the paged runs are
# compared with, then the paged runs (page 16, the default pool): fp and
# int8 KV, and speculative (draft_k 4) with the fp and the int8 projection
SHARED_PREFIX_RUNS = (
    ("contiguous", {}),
    ("paged", dict(cache_kind="paged", prefix_cache=True)),
    ("paged int8", dict(cache_kind="paged", prefix_cache=True,
                        kv_dtype="int8")),
    ("paged speculative", dict(cache_kind="paged", prefix_cache=True,
                               speculative=True, draft_k=4)),
    ("paged speculative int8 projection", dict(
        cache_kind="paged", prefix_cache=True, speculative=True, draft_k=4,
        quant="int8")),
)


def shared_prefix_runs(torch, cfg, params, seed):
    """8 greedy requests, each a seeded 1024-token system prompt shared by
    all plus its own 32-512-token suffix, 32 new tokens each, through the
    full model with 4 slots, max_seq 2048 and chunk 256: on contiguous KV,
    then on the paged pool with the prefix cache, then on int8 pools with
    the prefix cache, then speculatively (``draft_k=4``, the prompt-lookup
    drafter) on the paged pool with the prefix cache, with the fp and the
    int8 projection.  Requests 4-7 are admitted after the first retire and
    must hit the 64 pages of the system prompt; only the paged kernels may
    serve attention on the paged runs, and only ``matmul_tiled_int8`` may
    project on the int8-projection run.  The share of tokens equal to the
    contiguous run is reported, not gated: random weights leave near
    ties."""
    import numpy as np

    from repro_torch.core.famous import FamousConfig
    from repro_torch.obs.runtime import NullObserver
    from repro_torch.serve.engine import Request, ServingEngine

    class PrefixHits(NullObserver):
        """Each request's prefix-cache hit pages at its last admission."""

        def __init__(self):
            self.pages = {}

        def on_prefix_lookup(self, rid, hit_pages, hit_tokens):
            self.pages[rid] = hit_pages

    rng = np.random.default_rng(seed + 3)
    system = [int(t) for t in rng.integers(0, cfg.vocab_size, size=1024)]
    suffixes = [int(n) for n in rng.integers(32, 513, size=8)]
    prompts = [system + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                      size=n)]
               for n in suffixes]
    out, ref_tokens = {}, None

    def make_reqs():
        return [Request(rid=i, tokens=list(p), max_new=32)
                for i, p in enumerate(prompts)]

    for label, kw in SHARED_PREFIX_RUNS:
        kw = dict(kw)
        quant = kw.pop("quant", "none")

        def make_engine():
            return ServingEngine(params, cfg,
                                 FamousConfig(impl="pallas", quant=quant),
                                 n_slots=4, max_seq=2048,
                                 dtype=torch.bfloat16, chunk=256,
                                 page_size=16, observer=PrefixHits(),
                                 device="cuda", **kw)

        (done, engine, launches, plain, wall), pair = graph_pair(
            torch, f"shared prefix {label}", make_engine, make_reqs)
        hits = engine.obs
        check(len(done) == 8 and all(r.error is None for r in done),
              f"{label}: {[(r.rid, r.error) for r in done]}")
        for r in done:
            check(len(r.out) == 32 and all(0 <= t < cfg.vocab_size
                                           for t in r.out),
                  f"{label}: request {r.rid} made {r.out}")
        check(not any(plain.values()),
              f"{label}: a plain version ran on CUDA tensors: {plain}")
        outs = [r.out for r in done]
        if ref_tokens is None:
            ref_tokens = outs
            check(all(launches[k] > 0 for k in SERVING_KERNELS),
                  f"{label}: a kernel never launched: {launches}")
        else:
            paged = PAGED_KERNELS[kw.get("kv_dtype", "fp")]
            check(all(launches[k] > 0 for k in paged)
                  and launches["decode_attention"] == 0
                  and launches["chunk_prefill"] == 0,
                  f"{label}: attention did not run on {paged}: {launches}")
            check(all(hits.pages.get(rid, 0) >= 64 for rid in range(4, 8)),
                  f"{label}: prefix hit pages by request {hits.pages}")
        proj = "matmul_tiled_int8" if quant == "int8" else "matmul_tiled"
        other = "matmul_tiled" if quant == "int8" else "matmul_tiled_int8"
        check(launches[proj] > 0 and launches[other] == 0,
              f"{label}: the projection did not run on {proj}: {launches}")
        same = sum(a == b for o, r in zip(outs, ref_tokens)
                   for a, b in zip(o, r)) / sum(len(r) for r in ref_tokens)
        toks = sum(len(o) for o in outs)
        ttft = sorted(r.t_first - r.t_submit for r in done)
        # engine steps from submission to first token: the prefix cache's
        # effect on TTFT without the host's per-step time in it
        ttft_steps = [engine.sched.fairness(r.rid)["ttft_steps"]
                      for r in done]
        res = dict(suffixes=suffixes, tokens=toks, wall_s=wall,
                   tok_per_s=toks / wall, ttft_p50_s=float(np.median(ttft)),
                   ttft_max_s=ttft[-1], ttft_steps=ttft_steps,
                   ttft_steps_p50=float(np.median(ttft_steps)),
                   prefix_hit_pages=engine.prefix_hit_pages,
                   hit_pages_by_request=hits.pages,
                   pool_bytes=engine.cache_bytes_per_device(),
                   token_share_equal_to_contiguous=same, launches=launches)
        spec = ""
        if engine.speculative_active:
            # every token of a speculative run comes from a verify step:
            # one per slot and step, plus the accepted drafts
            slot_steps = toks - engine.spec_accepted
            res.update(spec_steps=engine.spec_steps,
                       drafted=engine.spec_drafted,
                       accepted=engine.spec_accepted,
                       acceptance_rate=engine.acceptance_rate,
                       tokens_per_slot_step=toks / slot_steps)
            spec = (f"; speculative: {engine.spec_drafted} drafted, "
                    f"{engine.spec_accepted} accepted (rate "
                    f"{engine.acceptance_rate:.3f}), {engine.spec_steps} "
                    f"verify steps, {toks / slot_steps:.3f} tokens per slot "
                    f"and step")
        print(f"serving {label} (shared 1024-token system prompt, suffixes "
              f"{suffixes}): {toks} tokens in {wall:.2f}s = "
              f"{toks / wall:.1f} tok/s, TTFT p50 "
              f"{res['ttft_p50_s'] * 1e3:.0f} ms ({res['ttft_steps_p50']:g} "
              f"steps; by request {ttft_steps}), prefix hit pages "
              f"{engine.prefix_hit_pages} (by request {hits.pages}), KV "
              f"bytes {res['pool_bytes']}, tokens equal to the contiguous "
              f"run {same:.3f}{spec}", flush=True)
        print("kernels " + json.dumps(launches), flush=True)
        res["graph_pair"] = pair
        res["guard_census"] = guard_warm(torch, f"shared prefix {label}",
                                         engine, prompts)
        if label in ("paged", "paged int8", "paged speculative"):
            res["steps"] = step_breakdown(torch, engine)
        out[label] = res
        del engine
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 9 and 10: the recurrent families
# ---------------------------------------------------------------------------

# arch, cut depth of the slice, its prompt length and max_seq: one
# (RG-LRU, RG-LRU, local attention) unit of recurrentgemma-2b on a prompt
# past its 2048-token window (9 chunks: the ring wraps, the state crosses
# chunks), two RWKV-6 layers on 3 chunks
RECURRENT_SLICES = (("recurrentgemma-2b", 3, 2300, 4096),
                    ("rwkv6-1.6b", 2, 600, 1024))


def recurrent_slice_phase(torch, seed):
    """Each recurrent family at full width and cut depth through
    ``prefill_chunk`` + ``decode_step``, through the kernels
    (``impl="pallas"``) and through their plain versions (``impl="xla"``)
    on the same weights, in f32 and bf16, chunk 256.  Slot 1 prefills the
    prompt (the last chunk has a pad tail); slot 0 holds one chunk of
    another prompt and sits inactive through the two decode steps, so its
    recurrent state must come out unchanged.  Limits as the qwen2-7b
    slice: 1e-4 / 5e-2 x max|logit| at f32 / bf16."""
    from repro_torch.configs.base import RGLRU, RWKV6, get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    C = 256
    results = {}
    for arch, depth, n, max_seq in RECURRENT_SLICES:
        cfg = dataclasses.replace(get_config(arch), num_layers=depth)
        kinds = transformer.layer_kinds(cfg)
        gen = torch.Generator(device=dev).manual_seed(seed + 5)
        prompt = torch.zeros((1, -(-n // C) * C), dtype=torch.long,
                             device=dev)
        prompt[:, :n] = torch.randint(0, cfg.vocab_size, (1, n),
                                      generator=gen, device=dev)
        other = torch.randint(0, cfg.vocab_size, (1, C + 1), generator=gen,
                              device=dev)
        follow = torch.randint(0, cfg.vocab_size, (2,), generator=gen,
                               device=dev)
        for dt, dtype, tol in (("f32", torch.float32, 1e-4),
                               ("bf16", torch.bfloat16, 5e-2)):
            params = random_params(torch, cfg, dtype, seed)
            logits = {}
            for impl in ("pallas", "xla"):
                fcfg = FamousConfig(impl=impl)
                caches = transformer.make_caches(cfg, 2, max_seq, dtype, dev)
                transformer.prefill_chunk(params, other[:, :C], caches, 0, 0,
                                          C, cfg, fcfg)
                for start in range(0, n, C):
                    transformer.prefill_chunk(
                        params, prompt[:, start:start + C], caches, 1, start,
                        min(C, n - start), cfg, fcfg)
                held = [{k: v[0].clone() for k, v in c.items()}
                        for kind, c in zip(kinds, caches)
                        if kind in (RGLRU, RWKV6)]
                last = torch.stack([other[0, C], prompt[0, n - 1]])
                clen = torch.tensor([C, n - 1], dtype=torch.int32, device=dev)
                active = torch.tensor([False, True], device=dev)
                outs = []
                for j in range(2):
                    lg, _ = transformer.decode_step(params, last, caches, clen,
                                                    cfg, fcfg, active=active)
                    outs.append(lg[1])
                    last = torch.stack([other[0, C], follow[j]])
                    clen = clen + torch.tensor([0, 1], dtype=torch.int32,
                                               device=dev)
                after = [{k: v[0] for k, v in c.items()}
                         for kind, c in zip(kinds, caches)
                         if kind in (RGLRU, RWKV6)]
                frozen = all(torch.equal(a[k], b[k])
                             for a, b in zip(held, after) for k in a)
                check(frozen, f"{arch} {dt} {impl}: the inactive slot's "
                      f"recurrent state moved during decode")
                logits[impl] = torch.stack(outs)
                del caches, held, after
            torch.cuda.synchronize()
            ref = logits["xla"]
            err = float((logits["pallas"] - ref).abs().max())
            limit = tol * float(ref.abs().max())
            finite = bool(torch.isfinite(logits["pallas"]).all())
            results[f"{arch} {dt}"] = dict(
                max_abs_err=err, limit=limit,
                max_abs_logit=float(ref.abs().max()), layers=depth,
                prompt=n, chunks=-(-n // C), shape=list(ref.shape))
            print(f"recurrent slice {dt} {arch}: {depth} layers at full "
                  f"width, a {n}-token prompt in {-(-n // C)} chunks of {C} "
                  f"then 2 decode steps (slot 0 inactive, its state "
                  f"unchanged), kernels vs plain logits {tuple(ref.shape)}: "
                  f"max|diff| = {err:.3e} (limit {limit:.3e} = {tol:g} * "
                  f"max|logit|) {'ok' if finite and err <= limit else 'FAIL'}",
                  flush=True)
            check(finite and err <= limit,
                  f"recurrent slice {arch} {dt}: {results[f'{arch} {dt}']}")
            del params, logits
            torch.cuda.empty_cache()
    return results


class _StepCounter:
    """Counts the engine's prefill chunks and decode steps (its observer
    phases), to check launch counts per step."""

    def __init__(self):
        from repro_torch.obs.runtime import NullObserver
        self._null = NullObserver()
        self.phases = {}

    def phase(self, name, **args):
        self.phases[name] = self.phases.get(name, 0) + 1
        return self._null.phase(name)

    def __getattr__(self, name):
        return getattr(self._null, name)


def recurrent_serving_phase(torch, seed):
    """Both recurrent families at full depth, bf16, random weights made on
    the card, 8 greedy requests of 32 new tokens through
    ``ServingEngine.run`` (4 slots, chunk 256, contiguous caches):
    recurrentgemma-2b at max_seq 4096 on prompts of 88-3600 tokens, three
    of them past the 2048-token window (their decode reads a wrapped
    ring); rwkv6-1.6b at max_seq 2048 on the qwen2-7b run's prompt
    lengths.  Per chunk, ``rglru_scan`` must launch once per RG-LRU layer
    (18) and ``wkv6_scan`` once per RWKV-6 layer (24); per decode step
    ``decode_attention`` once per local-attention layer (8), and the QKV
    projection once per attention layer and step; no plain scan may run
    on the card."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServingEngine

    out = {}
    for arch, max_seq in (("recurrentgemma-2b", 4096), ("rwkv6-1.6b", 2048)):
        cfg = get_config(arch)
        kinds = transformer.layer_kinds(cfg)
        per_kind = {k: kinds.count(k) for k in set(kinds)}
        if arch == "rwkv6-1.6b":
            rng = np.random.default_rng(seed)    # the qwen2-7b run's lengths
            lens = [int(x) for x in rng.integers(64, 1537, size=8)]
        else:
            rng = np.random.default_rng(seed + 6)
            lens = [int(x) for x in rng.integers(88, 3601, size=8)]
            lens[:3] = [int(x) for x in rng.integers(2049, 3601, size=3)]
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
                   for n in lens]
        t0 = time.perf_counter()
        params = random_params(torch, cfg, torch.bfloat16, seed)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        def make_engine():
            return ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                                 n_slots=4, max_seq=max_seq,
                                 dtype=torch.bfloat16, chunk=256,
                                 observer=_StepCounter(), device="cuda")

        def make_reqs():
            return [Request(rid=i, tokens=list(p), max_new=32)
                    for i, p in enumerate(prompts)]

        (done, engine, launches, plain, wall), pair = graph_pair(
            torch, arch, make_engine, make_reqs)
        counter = engine.obs
        chunks = counter.phases.get("prefill_chunk", 0)
        steps = counter.phases.get("decode", 0)
        check(len(done) == 8 and all(r.error is None and len(r.out) == 32
                                     for r in done),
              f"{arch}: {[(r.rid, r.error, len(r.out)) for r in done]}")
        check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
              f"{arch}: token out of range")
        check(not any(plain.values()),
              f"{arch}: a plain version ran on CUDA tensors: {plain}")
        want = {"rglru_scan": per_kind.get("rglru", 0) * chunks,
                "wkv6_scan": per_kind.get("rwkv6", 0) * chunks,
                "decode_attention": per_kind.get("local_attn", 0) * steps,
                "matmul_tiled": per_kind.get("local_attn", 0)
                * (steps + chunks),
                "chunk_prefill": 0}
        got = {k: launches[k] for k in want}
        check(got == want and chunks > 0 and steps > 0,
              f"{arch}: launches {got}, want {want} for {chunks} chunks and "
              f"{steps} decode steps")
        toks = sum(len(r.out) for r in done)
        ttft = sorted(r.t_first - r.t_submit for r in done)
        ttft_steps = [engine.sched.fairness(r.rid)["ttft_steps"] for r in done]
        res = dict(layers=cfg.num_layers, params=cfg.param_count(),
                   prompt_lens=lens, max_seq=max_seq, tokens=toks,
                   wall_s=wall, tok_per_s=toks / wall,
                   ttft_p50_s=float(np.median(ttft)), ttft_max_s=ttft[-1],
                   ttft_steps=ttft_steps,
                   ttft_steps_p50=float(np.median(ttft_steps)),
                   chunks=chunks, decode_steps=steps, launches=launches,
                   cache_bytes=engine.cache_bytes_per_device(),
                   init_s=t_init,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"serving {arch}: {cfg.num_layers} layers bf16 "
              f"({res['params'] / 1e9:.2f}B params), max_seq {max_seq}, "
              f"8 requests (prompts {lens}), {toks} tokens in {wall:.2f}s = "
              f"{toks / wall:.1f} tok/s, TTFT p50 "
              f"{res['ttft_p50_s'] * 1e3:.0f} ms ({res['ttft_steps_p50']:g} "
              f"steps; by request {ttft_steps}), {chunks} chunks and {steps} "
              f"decode steps, launches {got} (as expected), cache bytes "
              f"{res['cache_bytes']}, peak memory {res['peak_mem_gb']:.1f} GB",
              flush=True)
        print("kernels " + json.dumps(launches), flush=True)
        res["graph_pair"] = pair
        res["guard_census"] = guard_warm(torch, arch, engine, prompts)
        res["steps"] = step_breakdown(torch, engine)
        out[arch] = res
        del engine, params
        torch.cuda.empty_cache()
    return out


def step_breakdown(torch, engine):
    """Device time of one decode step (4 slots at 1024 cached tokens) and
    one 256-token prefill chunk (offset 1024) of the serving engine's model:
    the step's time from CUDA events, and its kernels' device time by
    group from ``torch.profiler``.  A paged engine gets a page table with
    80 private pages per slot (1280 tokens).  A speculative engine adds
    its verify step (``draft_k + 1`` tokens a slot at the same lengths).
    Then the decode step (and the verify step) again as a CUDA graph of
    the same function on the same inputs (``graphs.Executable``: warmed,
    captured, then replayed), with its capture seconds and pool bytes, and
    the chunk as the engine's chunk graph runs it: its slot, offset and
    valid count staged in a device buffer, warmed and captured at slot 1,
    offset 512, then timed after restaging slot 0, offset 1024 (the eager
    row's), so the one graph serves both."""
    from repro_torch.models import transformer
    from repro_torch.serve import graphs

    dev = torch.device("cuda")
    p, cfg, fcfg, caches = engine.params, engine.cfg, engine.fcfg, engine.caches
    last = torch.ones(engine.n_slots, dtype=torch.long, device=dev)
    clen = torch.full((engine.n_slots,), 1024, dtype=torch.int32, device=dev)
    chunk = torch.ones((1, engine.chunk), dtype=torch.long, device=dev)
    kw = {}
    if engine.paged:
        per = (1024 + engine.chunk) // engine.pcfg.page_size
        pt = torch.zeros((engine.n_slots, engine.alloc.pages_per_slot),
                         dtype=torch.int32, device=dev)
        pt[:, :per] = 1 + torch.arange(engine.n_slots * per, device=dev,
                                       dtype=torch.int32).reshape(-1, per)
        kw = {"page_table": pt}
    steps = {
        "decode_step": lambda: transformer.decode_step(p, last, caches, clen,
                                                       cfg, fcfg, **kw),
        "prefill_chunk": lambda: transformer.prefill_chunk(
            p, chunk, caches, 0, 1024, engine.chunk, cfg, fcfg, **kw),
    }
    staged = graphs.StaticInput((3,), torch.int32, dev)
    sc = staged.tensor
    steps["prefill_chunk (graph)"] = lambda: transformer.prefill_chunk(
        p, chunk, caches, sc[0:1], sc[1:2], sc[2:3], cfg, fcfg, **kw)
    graphed = ["decode_step", "prefill_chunk (graph)"]
    if engine.speculative_active:
        vtok = torch.ones((engine.n_slots, engine.draft_k + 1),
                          dtype=torch.long, device=dev)
        steps["verify_step"] = lambda: transformer.verify_step(
            p, vtok, caches, clen, cfg, fcfg, **kw)
        graphed.append("verify_step")
    pool = graphs.GraphPool(dev)
    costs = {}                            # graph row -> capture s, bytes
    staged.put((1, 512, engine.chunk))
    for name in graphed:
        ex = graphs.Executable(lambda key, fn=steps[name]: fn(), pool)
        before = (pool.capture_s, pool.bytes)
        ex(name)                          # the eager warm-up
        ex(name)                          # capture, then one replay
        row = name if name.endswith("(graph)") else f"{name} (graph)"
        steps[row] = lambda ex=ex, key=name: ex(key)
        costs[row] = dict(capture_s=pool.capture_s - before[0],
                          pool_bytes=pool.bytes - before[1])
    staged.put((0, 1024, engine.chunk))
    out = {}
    for name, fn in steps.items():
        step_ms = time_ms(torch, lambda: fn(), [()], 5)
        out[name] = dict(step_ms=step_ms, **profile_groups(torch, fn),
                         **costs.get(name, {}))
        extra = ""
        if name in costs:
            # a replay is ~10 ms of device time: a host pause before the
            # first of 5 replays shows in their mean, not in the median
            out[name]["median_ms"] = median_call_ms(torch, fn, 10)
            extra = (f"; median of 10 replays "
                     f"{out[name]['median_ms']:.3f} ms (CUDA events); "
                     f"capture {costs[name]['capture_s']:.3f} s, pool "
                     f"{costs[name]['pool_bytes'] / 2**20:.1f} MiB")
        device, span = out[name]["device_ms"], out[name]["span_ms"]
        print(f"step {name}: {step_ms:.3f} ms (CUDA events, mean of 5); "
              f"profiled device span "
              f"{f'{span:.3f} ms' if span else 'not measured'}, device time "
              f"{f'{device:.3f} ms' if device else 'not measured'}: "
              f"{group_text(out[name]['by_group_ms'])}{extra}", flush=True)
    return out


def profile_groups(torch, fn):
    """Device time of one call of ``fn`` from ``torch.profiler``, summed
    by kernel group: each port kernel, library GEMMs, everything else;
    and the call's device span, from its first device event's start to
    its last one's end, in the same trace (span less device time: the
    device's idle time inside the call, which CUDA events taken in another
    call cannot tell from a change of clock)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import lib

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if not us:
            continue
        key = ev.key
        group = kernel_group(key, lib.KERNELS)
        if group is None:
            group = ("library GEMM" if any(
                w in key.lower() for w in ("gemm", "gemv", "xmma",
                                           "cutlass", "nvjet", "splitk"))
                else "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
    top = sorted(((getattr(ev, "self_device_time_total", 0) / 1e3, ev.key)
                  for ev in prof.key_averages()), reverse=True)
    spans = [ev.time_range for ev in prof.events()
             if str(ev.device_type).endswith("CUDA")]
    span_ms = ((max(r.end for r in spans) - min(r.start for r in spans)) / 1e3
               if spans else None)
    return dict(device_ms=sum(groups.values()), by_group_ms=groups,
                span_ms=span_ms, top_kernels=top[:12])


def kernel_group(key, names):
    """The port kernel a profiler key belongs to.  The decode split kernel
    and the bf16 chunk kernel, and their combine passes, by their row
    source: ``PagedRows`` for the paged decode kernels and ``PagedKV`` for
    the paged chunk kernels (an int8 instantiation reads ``signed char``
    pools), ``ContigRows`` for ``decode_attention`` and ``ContigKV`` for
    ``chunk_prefill``, except on its ``FlatQ`` query side, which is the
    bf16 ``mha_forward``; the f32 paged chunk kernel by its symbol and pool
    type likewise; the int8 projection's symbol is ``matmul_int8_kernel``;
    ``wkv6_scan``'s two passes are ``wkv6_chunk_kernel`` and
    ``wkv6_state_kernel``; the others by their name."""
    if "matmul_int8_kernel" in key:
        return "matmul_tiled_int8"
    if "wkv6_chunk_kernel" in key or "wkv6_state_kernel" in key:
        return "wkv6_scan"
    if "FlatQ" in key:
        return "mha_forward"
    for sym, name in (("PagedRows", "paged_decode_attention"),
                      ("PagedKV", "paged_chunk_prefill"),
                      ("paged_chunk_prefill_kernel", "paged_chunk_prefill")):
        if sym in key:
            return name + ("_int8" if "signed char" in key else "")
    if "ContigRows" in key:
        return "decode_attention"
    if "ContigKV" in key:
        return "chunk_prefill"
    return next((k for k in names if k in key), None)


def group_text(groups):
    return ", ".join(f"{k} {v:.3f} ms" for k, v in
                     sorted(groups.items(), key=lambda kv: -kv[1])) \
        or "not measured"


# ---------------------------------------------------------------------------
# phases 11-12: monolithic prefill and the dense zoo
# ---------------------------------------------------------------------------


def slot_logits(torch, cfg, params, fcfg, prompt, n, mode, dtype, max_seq,
                kind="contiguous", pt=None, ps=16, n_pages=513, C=256):
    """Slot 1 of a 4-slot cache takes ``prompt[0, :n]`` as the engine
    does: its first n - 1 tokens prefilled (``mode`` "monolithic":
    ``transformer.prefill`` into a batch-1 scratch cache, then
    ``write_prefill_to_slot``, paged through slot 1's table row;
    "chunked": ``prefill_chunk`` over C-token chunks), then two
    ``decode_step`` calls from token n - 1.  Returns slot 1's logits (2,
    vocab) f32."""
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    kw, paged = {}, kind != "contiguous"
    if paged:
        caches = transformer.make_caches(
            cfg, 4, max_seq, dtype, dev, cache_kind="paged", page_size=ps,
            n_pages=n_pages, kv_dtype="int8" if kind == "int8" else "fp")
        kw = {"page_table": pt}
    else:
        caches = transformer.make_caches(cfg, 4, max_seq, dtype, dev)
    m = n - 1
    if mode == "monolithic":
        one = transformer.make_caches(cfg, 1, max_seq, dtype, dev)
        transformer.prefill(params, prompt[:, :m], one, cfg, fcfg)
        transformer.write_prefill_to_slot(caches, one, 1, cfg,
                                          page_ids=pt[1] if paged else None)
        del one
    else:
        padded = torch.zeros((1, -(-m // C) * C), dtype=torch.long,
                             device=dev)
        padded[:, :m] = prompt[:, :m]
        for start in range(0, m, C):
            transformer.prefill_chunk(params, padded[:, start:start + C],
                                      caches, 1, start, min(C, m - start),
                                      cfg, fcfg, **kw)
    last = torch.tensor([5, int(prompt[0, m]), 9, 11], device=dev)
    clen = torch.tensor([0, m, 0, 0], dtype=torch.int32, device=dev)
    active = torch.tensor([False, True, False, False], device=dev)
    outs = []
    for j in range(2):
        lg, _ = transformer.decode_step(params, last, caches, clen, cfg,
                                        fcfg, active=active, **kw)
        outs.append(lg[1])
        last = torch.tensor([5, int(prompt[0, m + 1 + j]), 9, 11],
                            device=dev)
        clen = clen + torch.tensor([0, 1, 0, 0], dtype=torch.int32,
                                   device=dev)
    del caches
    return torch.stack(outs)


def parity_check(torch, results, key, got, ref, tol, what):
    err = float((got - ref).abs().max())
    limit = tol * float(ref.abs().max())
    finite = bool(torch.isfinite(got).all())
    results[key] = dict(max_abs_err=err, limit=limit,
                        max_abs_logit=float(ref.abs().max()))
    print(f"{key}: {what}, max|diff| = {err:.3e} (limit {limit:.3e} = "
          f"{tol:g} * max|logit|) "
          f"{'ok' if finite and err <= limit else 'FAIL'}",
          flush=True)
    check(finite and err <= limit, f"{key}: {results[key]}")


# monolithic slices at full width: arch, layers, prompt tokens (n - 1 are
# prefilled: recurrentgemma-2b's 2299 wrap its 2048-token ring, rwkv6's
# 640 are ten 64-step chunks and its 37 one chunk of 37), max_seq
MONO_SLICES = (("qwen2-7b", 2, 400, 2048),
               ("recurrentgemma-2b", 3, 2300, 4096),
               ("rwkv6-1.6b", 2, 641, 2048), ("rwkv6-1.6b", 2, 38, 2048))
# the dense zoo's 2-layer cuts at full width
ZOO_SLICE_ARCHS = ("qwen3-32b", "deepseek-7b", "command-r-plus-104b")


def monolithic_slice_phase(torch, seed):
    """Monolithic prefill at full width, cut depth, f32: slot 1 prefilled
    by ``transformer.prefill`` + ``write_prefill_to_slot`` then two decode
    steps, through the kernels (``impl="pallas"``: ``mha_forward``, the
    scan kernels) against plain torch ops (``impl="xla"``), and against
    the same prompt through ``prefill_chunk`` + ``decode_step`` (kernels),
    on qwen2-7b's contiguous caches, paged and int8 pools, one
    recurrentgemma-2b unit and two rwkv6-1.6b layers.  Then the dense
    zoo's 2-layer cuts through ``prefill_chunk`` + ``decode_step``, kernels
    against plain torch ops, on contiguous caches and int8 pools.  Limit
    1e-4 x max|logit| (sums in another order), and 5e-2 where int8 pools
    are written from the two paths' own K/V, whose last bits differ (a
    value on a rounding edge takes the next int8 step), as the bf16
    slice's int8 limit."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.famous import FamousConfig

    dev = torch.device("cuda")
    dtype = torch.float32
    pallas, xla = FamousConfig(impl="pallas"), FamousConfig(impl="xla")
    results = {}
    for arch, depth, n, max_seq in MONO_SLICES:
        cfg = dataclasses.replace(get_config(arch), num_layers=depth)
        gen = torch.Generator(device=dev).manual_seed(seed + 7)
        prompt = torch.randint(0, cfg.vocab_size, (1, n + 2), generator=gen,
                               device=dev)
        params = random_params(torch, cfg, dtype, seed)
        ps, n_pages = 16, 4 * max_seq // 16 + 1
        pt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).to(
            torch.int32).reshape(4, max_seq // ps).contiguous()
        kinds = (("contiguous", "paged", "int8") if arch == "qwen2-7b"
                 else ("contiguous",))
        for kind in kinds:
            args = (prompt, n)
            kw = dict(max_seq=max_seq, kind=kind, pt=pt, ps=ps,
                      n_pages=n_pages)
            mono = slot_logits(torch, cfg, params, pallas, *args,
                               "monolithic", dtype, **kw)
            tol = 5e-2 if kind == "int8" else 1e-4
            label = f"monolithic {arch} {depth} layers n={n} {kind}"
            what = (f"a {n - 1}-token prefill then 2 decode steps, logits "
                    f"{tuple(mono.shape)}")
            parity_check(torch, results, f"{label} kernels vs plain",
                         mono, slot_logits(torch, cfg, params, xla, *args,
                                           "monolithic", dtype, **kw),
                         tol, what)
            parity_check(torch, results, f"{label} vs chunked (kernels)",
                         mono, slot_logits(torch, cfg, params, pallas, *args,
                                           "chunked", dtype, **kw),
                         tol, what)
        del params
        torch.cuda.empty_cache()
    for arch in ZOO_SLICE_ARCHS:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        gen = torch.Generator(device=dev).manual_seed(seed + 8)
        prompt = torch.randint(0, cfg.vocab_size, (1, 402), generator=gen,
                               device=dev)
        params = random_params(torch, cfg, dtype, seed)
        pt = (torch.randperm(512, generator=gen, device=dev) + 1).to(
            torch.int32).reshape(4, 128).contiguous()
        for kind in ("contiguous", "int8"):
            kw = dict(max_seq=2048, kind=kind, pt=pt)
            got = slot_logits(torch, cfg, params, pallas, prompt, 400,
                              "chunked", dtype, **kw)
            ref = slot_logits(torch, cfg, params, xla, prompt, 400,
                              "chunked", dtype, **kw)
            parity_check(torch, results, f"zoo {arch} 2 layers {kind} "
                         f"kernels vs plain", got, ref,
                         5e-2 if kind == "int8" else 1e-4,
                         f"{cfg.num_heads} / {cfg.num_kv_heads} heads of "
                         f"{cfg.head_dim}, a 399-token prefill in 256-token "
                         f"chunks then 2 decode steps")
        del params
        torch.cuda.empty_cache()
    return results


def serving_run(torch, label, arch, layers, prompts, max_seq, seed, kw,
                max_new=16, want=None, guard=None, params=None,
                breakdown=False):
    """One serving configuration as a graph parity pair (``graph_pair``) at
    full width, ``layers`` deep, bf16, random weights from ``seed``: every
    request must finish with in-range tokens, no plain version may run on
    the card, and ``want(launches, engine)`` returns the launch counts the
    path must show.  Then the warm engine serves 4 fresh requests under
    ``retrace_guard`` (``guard``: whole prompts whose lengths a monolithic
    engine captured; default the first 512 tokens of 4 prompts), and, with
    ``breakdown``, times its decode step and chunk (``step_breakdown``)."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    if params is None:
        params = random_params(torch, cfg, torch.bfloat16, seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    def make_engine():
        return ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                             n_slots=4, max_seq=max_seq, dtype=torch.bfloat16,
                             chunk=256, observer=_StepCounter(),
                             device="cuda", **kw)

    def make_reqs():
        return [Request(rid=i, tokens=list(p), max_new=max_new)
                for i, p in enumerate(prompts)]

    (done, engine, launches, plain, wall), pair = graph_pair(
        torch, label, make_engine, make_reqs)
    check(len(done) == len(prompts)
          and all(r.error is None and len(r.out) == max_new for r in done),
          f"{label}: {[(r.rid, r.error, len(r.out)) for r in done]}")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          f"{label}: token out of range")
    check(not any(plain.values()),
          f"{label}: a plain version ran on CUDA tensors: {plain}")
    phases = engine.obs.phases
    if want is not None:
        expect = want(phases, engine)
        got = {k: launches[k] for k in expect}
        check(got == expect, f"{label}: launches {got}, want {expect} for "
              f"phases {phases}")
    toks = sum(len(r.out) for r in done)
    ttft = sorted(r.t_first - r.t_submit for r in done)
    res = dict(arch=arch, layers=cfg.num_layers, params=cfg.param_count(),
               prompt_lens=[len(p) for p in prompts], max_seq=max_seq,
               tokens=toks, wall_s=wall, tok_per_s=toks / wall,
               ttft_p50_s=float(np.median(ttft)), phases=phases,
               launches=launches, prefill_keys=engine.prefill_keys,
               prefix_hit_tokens=engine.prefix_hit_tokens,
               cache_bytes=engine.cache_bytes_per_device(), init_s=t_init,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               graph_pair=pair)
    print(f"serving {label}: {cfg.num_layers} layers bf16 "
          f"({res['params'] / 1e9:.2f}B params), {len(prompts)} requests "
          f"(prompts {res['prompt_lens']}), {toks} tokens in {wall:.2f}s = "
          f"{toks / wall:.1f} tok/s, TTFT p50 {res['ttft_p50_s'] * 1e3:.0f} "
          f"ms, phases {phases}, prefill keys {engine.prefill_keys}, prefix "
          f"hit tokens {engine.prefix_hit_tokens}, peak memory "
          f"{res['peak_mem_gb']:.1f} GB, init {t_init:.1f} s", flush=True)
    print("kernels " + json.dumps(launches), flush=True)
    res["guard_census"] = guard_warm(torch, label, engine, guard or prompts,
                                     cut=None if guard else 512)
    if breakdown:
        res["steps"] = step_breakdown(torch, engine)
    del engine, params
    torch.cuda.empty_cache()
    return res


def _prompts(rng, vocab, lens):
    return [[int(t) for t in rng.integers(0, vocab, size=n)] for n in lens]


def prefill_breakdown(torch, cfg, params, n=1024, C=256):
    """Device time of one ``n``-token monolithic prefill of the model
    (``transformer.prefill`` into a batch-1 cache) against the ``n // C``
    chunks that ``prefill_chunk`` takes for the same tokens (slot 0 of a
    4-slot cache), each warmed once, then profiled by kernel group."""
    from repro_torch.core.famous import FamousConfig
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    fcfg = FamousConfig(impl="pallas")
    toks = torch.randint(0, cfg.vocab_size, (1, n), device=dev)
    one = transformer.make_caches(cfg, 1, 2048, torch.bfloat16, dev)
    four = transformer.make_caches(cfg, 4, 2048, torch.bfloat16, dev)

    def mono():
        transformer.prefill(params, toks, one, cfg, fcfg)

    def chunks():
        for start in range(0, n, C):
            transformer.prefill_chunk(params, toks[:, start:start + C], four,
                                      0, start, C, cfg, fcfg)

    res = {}
    for label, fn in (("monolithic", mono), ("chunks", chunks)):
        fn()
        res[label] = profile_groups(torch, fn)
        print(f"prefill breakdown {cfg.name} {n} tokens, {label}: device "
              f"{res[label]['device_ms']:.3f} ms, span "
              f"{res[label]['span_ms']:.3f} ms: "
              f"{group_text(res[label]['by_group_ms'])}", flush=True)
    del one, four
    torch.cuda.empty_cache()
    return res


def monolithic_serving_phase(torch, seed):
    """``prefill_mode="monolithic"`` at full depth, bf16, 4 slots, 16 new
    tokens a request: qwen2-7b (28 layers) on 8 prompts of 88-1316 tokens,
    two in each power-of-two bucket (128-2048), on contiguous KV, paged KV
    and paged int8 KV; recurrentgemma-2b on 1293-3581 tokens and
    rwkv6-1.6b on prefills of 64-1536 tokens (multiples of 64), four exact
    lengths twice each.  Each is a graph parity pair whose prefill graphs
    are exactly the lengths served twice, each replayed once; per
    prefill, ``mha_forward`` launches once per attention layer,
    ``rglru_scan`` / ``wkv6_scan`` once per recurrent layer, and no chunk
    kernel runs.  The same qwen2-7b prompts chunked (graphs only) give the
    chunked tok/s and TTFT of this call beside."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer

    rng = np.random.default_rng(seed + 11)
    out = {}
    cfg = get_config("qwen2-7b")
    lens = [88, 300, 600, 1316, 100, 400, 700, 1200]
    prompts = _prompts(rng, cfg.vocab_size, lens)
    params = random_params(torch, cfg, torch.bfloat16, seed)
    out["prefill vs chunks"] = prefill_breakdown(torch, cfg, params)

    def qwen_want(kind):
        def want(phases, engine):
            n, steps = phases.get("prefill", 0), phases.get("decode", 0)
            dec = ("paged_decode_attention" + ("_int8" if kind == "int8"
                                               else "")
                   if kind != "contiguous" else "decode_attention")
            return {"mha_forward": 28 * n, "chunk_prefill": 0,
                    "paged_chunk_prefill": 0, "paged_chunk_prefill_int8": 0,
                    "matmul_tiled": 28 * (n + steps), dec: 28 * steps}
        return want

    for kind, kw in (("contiguous", {}),
                     ("paged", dict(cache_kind="paged", page_size=16)),
                     ("int8", dict(cache_kind="paged", page_size=16,
                                   kv_dtype="int8"))):
        res = serving_run(torch, f"qwen2-7b monolithic {kind}", "qwen2-7b",
                          None, prompts, 2048, seed,
                          dict(kw, prefill_mode="monolithic"),
                          want=qwen_want(kind), guard=prompts[:4],
                          params=params)
        census = res["graph_pair"]["census"]["prefill"]
        check(census == 4 and res["graph_pair"]["replays"]["prefill"] == 4
              and sorted(res["prefill_keys"]) == [128, 512, 1024, 2048],
              f"qwen2-7b monolithic {kind}: census {census}, keys "
              f"{res['prefill_keys']}")
        out[f"qwen2-7b {kind}"] = res
    # the same prompts chunked, for this call's chunked tok/s and TTFT
    from repro_torch.core.famous import FamousConfig
    from repro_torch.serve.engine import Request, ServingEngine
    done, eng, _, _, wall = serve_once(
        torch, lambda: ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                                     n_slots=4, max_seq=2048,
                                     dtype=torch.bfloat16, chunk=256,
                                     device="cuda"),
        [Request(rid=i, tokens=list(p), max_new=16)
         for i, p in enumerate(prompts)], eager=False)
    toks = sum(len(r.out) for r in done)
    ttft = float(np.median([r.t_first - r.t_submit for r in done]))
    out["qwen2-7b chunked (same prompts)"] = dict(tokens=toks, wall_s=wall,
                                                  tok_per_s=toks / wall,
                                                  ttft_p50_s=ttft)
    mono = out["qwen2-7b contiguous"]
    print(f"monolithic vs chunked, qwen2-7b contiguous, same prompts, graphs "
          f"(information, not gated): monolithic {mono['tok_per_s']:.1f} "
          f"tok/s, TTFT p50 {mono['ttft_p50_s'] * 1e3:.0f} ms; chunked "
          f"{toks / wall:.1f} tok/s, TTFT p50 {ttft * 1e3:.0f} ms",
          flush=True)
    del eng, params
    torch.cuda.empty_cache()

    for arch, max_seq, base in (("recurrentgemma-2b", 4096,
                                 [1293, 2100, 2900, 3581]),
                                ("rwkv6-1.6b", 2048, [65, 641, 1025, 1537])):
        cfg = get_config(arch)
        kinds = transformer.layer_kinds(cfg)
        per = {k: kinds.count(k) for k in set(kinds)}
        prompts = _prompts(rng, cfg.vocab_size, base * 2)

        def want(phases, engine, per=per):
            n, steps = phases.get("prefill", 0), phases.get("decode", 0)
            local = per.get("local_attn", 0)
            return {"rglru_scan": per.get("rglru", 0) * n,
                    "wkv6_scan": per.get("rwkv6", 0) * n,
                    "mha_forward": local * n, "chunk_prefill": 0,
                    "decode_attention": local * steps,
                    "matmul_tiled": local * (n + steps)}

        res = serving_run(torch, f"{arch} monolithic", arch, None, prompts,
                          max_seq, seed, dict(prefill_mode="monolithic"),
                          want=want, guard=prompts[:4])
        census = res["graph_pair"]["census"]["prefill"]
        check(census == 4 and sorted(res["prefill_keys"])
              == [n - 1 for n in base],
              f"{arch} monolithic: census {census}, keys "
              f"{res['prefill_keys']}")
        out[arch] = res
    return out


def zoo_serving_phase(torch, seed):
    """The dense zoo served chunked (``layered_serving``): deepseek-7b at
    full depth (30 layers) on contiguous KV; qwen3-32b cut to 16 of 64
    layers (its 65.5 GB of bf16 weights would not leave room on the card)
    on contiguous KV and on paged int8 KV with the prefix cache;
    command-r-plus-104b cut to 4 of 64 layers (each holds 1.57B
    parameters, and the tied 256000 x 12288 head adds its f32 copy)."""
    import numpy as np

    return layered_serving(torch, seed, np.random.default_rng(seed + 12),
                           ZOO_SERVING)


# ---------------------------------------------------------------------------
# phase 14: runtime programmability (core/flexible.py)
# ---------------------------------------------------------------------------

# examples/flexible_serving.py's maxima, its eight Table I topologies (h,
# SL, dh: tests 1-3 vary h, 4-5 d_head, 6-8 SL), a ninth topology that no
# earlier call used, and the bucket demo's lengths
FLEX_MAXIMA = dict(max_heads=8, max_seq=128, max_head_dim=96)
FLEX_TOPOLOGIES = ((8, 64, 96), (4, 64, 96), (2, 64, 96), (8, 64, 64),
                   (8, 64, 32), (8, 128, 96), (8, 32, 96), (8, 16, 96))
FLEX_NINTH = (5, 100, 48)
BUCKET_SEQS = (10, 17, 33, 60, 100, 120)


def flexible_phase(torch, seed):
    """One ``FlexibleAttention`` at the demo's maxima per dtype serves the
    eight topologies on the card: each output against the plain
    ``famous.attention_reference`` at its exact shape (2e-5 f32, as JAX's
    test; 2e-2 bf16), one padded program built (its first call the eager
    warm-up, its second the capture, both under ``no_host_sync``; then
    replays), a ninth topology inside ``retrace_guard``.  Then each
    topology's time: the whole call (padding, replay, slice) and the
    graph's replay alone, beside one exact-shape call of the plain
    function: the padding's cost.  A ``BucketCache`` over the demo's
    lengths must miss once per distinct bucket; each bucket's executable,
    called twice, captures once and gives ``tanh``'s bits."""
    from repro_torch.analysis.retrace_guard import retrace_guard
    from repro_torch.core import famous
    from repro_torch.core.flexible import (BucketCache, FlexibleAttention,
                                           next_pow2)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    res = {}
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tol = ATTN_TOL[dt]
        fa = FlexibleAttention(**FLEX_MAXIMA, causal=True, device=dev)
        rows = []
        inputs = {}
        for H, SL, dh in FLEX_TOPOLOGIES + (FLEX_NINTH,):
            q, k, v = ((torch.randn((2, SL, H, dh), generator=gen,
                                    device=dev) * 0.5).to(dtype)
                       for _ in range(3))
            inputs[(H, SL, dh)] = (q, k, v)
            if (H, SL, dh) == FLEX_NINTH:
                with retrace_guard(fa, label=f"flexible {dt} ninth"):
                    out = fa(q, k, v)
            else:
                out = fa(q, k, v)
            ref = famous.attention_reference(q, k, v, causal=True)
            err, ok = compare(torch, out, ref, tol)
            ok = ok and out.shape == ref.shape
            rows.append(dict(topology=[H, SL, dh], max_abs_err=err, ok=ok,
                             compilations=fa.compilations))
            check(ok, f"flexible {dt} topology {(H, SL, dh)}: error {err} "
                  f"(tol {tol})")
        check(fa.compilations == 1 and rows[len(FLEX_TOPOLOGIES) - 1][
            "compilations"] == 1, f"flexible {dt}: compilations "
              f"{[r['compilations'] for r in rows]}")
        key = (2, dtype)
        for row in rows:
            q, k, v = inputs[tuple(row["topology"])]
            row["call_ms"] = median_call_ms(torch, lambda: fa(q, k, v), 20)
            fa(q, k, v)   # stage this topology, then time the replay alone
            row["replay_ms"] = median_call_ms(
                torch, lambda: fa._exec(key), 20)
            row["plain_exact_ms"] = median_call_ms(
                torch, lambda: famous.attention_reference(q, k, v,
                                                          causal=True), 20)
            print(f"flexible {dt} (h={row['topology'][0]}, SL="
                  f"{row['topology'][1]:3d}, dh={row['topology'][2]:2d}): "
                  f"max_abs_err {row['max_abs_err']:.3e} (tol {tol:g}), "
                  f"call {row['call_ms']:.4f} ms, replay "
                  f"{row['replay_ms']:.4f} ms, exact-shape plain "
                  f"{row['plain_exact_ms']:.4f} ms", flush=True)
        print(f"flexible {dt}: {len(rows)} topologies on one padded program "
              f"at {FLEX_MAXIMA}, compilations {fa.compilations}, replays "
              f"{fa._exec.replays}", flush=True)
        res[dt] = dict(rows=rows, compilations=fa.compilations,
                       replays=fa._exec.replays)
        del fa, inputs

    cache = BucketCache(lambda x, bucket: torch.tanh(x))
    fns = {}
    for n in BUCKET_SEQS:
        fn, b = cache.get(n)
        fns[b] = fn
        x = torch.randn((b,), generator=gen, device=dev)
        y1, y2 = fn(x), fn(x)
        check(torch.equal(y1, torch.tanh(x)) and torch.equal(y2, y1),
              f"bucket {b}: the executable differs from tanh")
    buckets = sorted(fns)
    distinct = len({next_pow2(n) for n in BUCKET_SEQS})
    captured = sum(fn.compilations for fn in fns.values())
    print(f"bucket cache: seqs {list(BUCKET_SEQS)} -> buckets {buckets}, "
          f"misses {cache.misses} (distinct buckets {distinct}), hits "
          f"{cache.hits}, executables {len(cache)}, captured {captured}",
          flush=True)
    check(cache.misses == len(cache) == distinct == captured,
          f"bucket cache: misses {cache.misses}, len {len(cache)}, distinct "
          f"{distinct}, captured {captured}")
    res["bucket_cache"] = dict(buckets=buckets, misses=cache.misses,
                               distinct=distinct, captured=captured)
    return res


# ---------------------------------------------------------------------------
# phase 15: MoE and vlm slice parity
# ---------------------------------------------------------------------------

# arch, layers, runs: grok-1-314b at f32 is 2 x 19.7 GB of experts plus
# its 3.2 GB embedding and head; kimi-k2-1t-a32b's one layer of experts is
# 384 x 3 x 7168 x 2048 = 16.9B parameters (67.6 GB at f32), so it runs
# in bf16, and again with f32 compute on those bf16 expert stacks (each
# cast to f32 inside its einsum, one at a time: 22.5 GB)
MOE_SLICES = (("grok-1-314b", 2, ("f32",)), ("llava-next-34b", 2, ("f32",)),
              ("kimi-k2-1t-a32b", 1, ("bf16", "f32 on bf16 experts")))
# tokens whose routing may differ between the kernels and plain torch ops,
# held on every run with f32 compute.  In bf16 the two paths round the
# residual stream at different places, and a top-8-of-384 router whose
# top-k margins lie below that rounding changes experts for a few percent
# of tokens (5.1% in kimi-k2's bf16 slice on the H100): there the count is
# reported and the logits the changed tokens reach are left out
ROUTING_FLIP_SHARE = 0.01


def _routing_recorder(moe, record):
    """A ``moe.router_dispatch`` that also records, per call, each token's
    top-k experts (sorted), which experts kept it (``dispatch`` summed
    over the capacity slots) and its top-k margin (its K-th softcapped
    logit less its (K+1)-th)."""
    dispatch_fn = moe.router_dispatch

    def recording(logits, K, capacity_factor, softcap=0.0):
        out = dispatch_fn(logits, K, capacity_factor, softcap)
        lg = softcap * (logits / softcap).tanh() if softcap else logits
        E = logits.shape[-1]
        top = lg.topk(min(K + 1, E), dim=-1)
        margin = (top.values[..., K - 1] - top.values[..., K]) if K < E \
            else top.values[..., 0]
        record.append((top.indices[..., :K].sort(-1).values.reshape(-1, K),
                       out[0].sum(-1).gt(0).reshape(-1, E),
                       margin.reshape(-1)))
        return out

    return dispatch_fn, recording


def _f32_but_experts(torch, params):
    """The serving layout with every leaf in f32 except the MoE expert
    stacks (``w_in`` / ``w_gate`` / ``w_out`` of rank 3), which stay as
    they are and are shared."""
    def conv(tree):
        return {k: conv(v) if isinstance(v, dict) else (
            v if k in ("w_in", "w_gate", "w_out") and v.ndim == 3
            else v.float()) for k, v in tree.items()}

    return dict(params, layers=[conv(p) for p in params["layers"]],
                embed=conv(params["embed"]),
                final_norm=conv(params["final_norm"]))


def moe_slice_phase(torch, seed):
    """MOE_SLICES at full width through ``prefill_chunk`` (a 512-token
    prompt in slot 1, two 256-token chunks) + 4 ``decode_step`` calls over
    4 slots (inputs fixed, so both runs see the same tokens), contiguous
    caches, the kernels (``impl="pallas"``) against plain torch ops
    (``impl="xla"``) on the same weights.  Routing is discontinuous: a
    token whose kept experts differ between the two runs in any layer is
    counted (under 1% of the routed tokens where compute is f32), beside
    the tokens whose top-k choice differs and the smallest top-k margin,
    and the logits are held at the slice tolerance (f32 1e-4, bf16 5e-2,
    times max|logit|) on the decode rows that no such token reaches."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe

    results = {}
    for arch, layers, runs in MOE_SLICES:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        params = random_params(torch, cfg, torch.bfloat16
                               if runs[0] == "bf16" else torch.float32, seed)
        for run in runs:
            # hand the cached blocks back (the f32 draws of the expert
            # stacks' segments among them) before other tensors can land
            # in them: one f32 copy of a kimi-k2 expert stack needs 22.5 GB
            # in one block
            gc.collect()
            torch.cuda.empty_cache()
            if run == "f32 on bf16 experts":
                params = _f32_but_experts(torch, params)
                gc.collect()
                torch.cuda.empty_cache()
            print(f"moe slice {arch} {run}: "
                  f"{torch.cuda.memory_allocated() / 1e9:.1f} GB "
                  f"allocated, {torch.cuda.memory_reserved() / 1e9:.1f} GB "
                  f"reserved before the run", flush=True)
            res = moe_slice_run(torch, seed, moe, cfg, params, run)
            results[f"{arch} {run}"] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return results


def moe_slice_run(torch, seed, moe, cfg, params, run, n_slots=4,
                  max_seq=1024, C=256, n=512, steps=4):
    from repro_torch.core.famous import FamousConfig
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    dtype = transformer._compute_dtype(params)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    dec = torch.randint(0, cfg.vocab_size, (steps, n_slots), generator=gen,
                        device=dev)
    got = {}
    for impl in ("pallas", "xla"):
        fcfg = FamousConfig(impl=impl)
        record = []
        original, recording = _routing_recorder(moe, record)
        moe.router_dispatch = recording
        try:
            caches = transformer.make_caches(cfg, n_slots, max_seq, dtype,
                                             dev)
            for start in range(0, n, C):
                transformer.prefill_chunk(
                    params, prompt[:, start:start + C], caches, 1, start, C,
                    cfg, fcfg)
            clen = torch.tensor([0, n, 0, 0], dtype=torch.int32, device=dev)
            logits = []
            for s in range(steps):
                lg, _ = transformer.decode_step(params, dec[s], caches, clen,
                                                cfg, fcfg)
                logits.append(lg)
                clen = clen + 1
        finally:
            moe.router_dispatch = original
        torch.cuda.synchronize()
        got[impl] = (torch.stack(logits), record)
        del caches
    (lp, rp), (lx, rx) = got["pallas"], got["xla"]
    L = cfg.num_layers
    # token keys of each router call: the prefill chunks' rows in layer
    # order, then the decode steps' slots
    keys = [("p", j * C + t) for j in range(n // C) for _ in range(L)
            for t in range(C)]
    keys += [("d", s, b) for s in range(steps) for _ in range(L)
             for b in range(n_slots)]
    changed, chose, margins, k = set(), set(), [], 0
    for (tp, kp, mp), (tx, kx, mx) in zip(rp, rx):
        for i, (kept, top) in enumerate(zip((kp != kx).any(-1).tolist(),
                                            (tp != tx).any(-1).tolist())):
            if kept:
                changed.add(keys[k + i])
            if top:
                chose.add(keys[k + i])
        k += kp.shape[0]
        margins += [float(mp.min()), float(mx.min())]
    want_rows = len(keys) if cfg.num_experts else 0
    check(k == want_rows, f"{cfg.name}: {k} routed rows, {want_rows} "
          f"expected")
    routed = n + steps * n_slots if cfg.num_experts else 0
    prompt_changed = any(key[0] == "p" for key in changed)
    keep = torch.ones((steps, n_slots), dtype=torch.bool, device=dev)
    for s in range(steps):
        for b in range(n_slots):
            reached = any(("d", s2, b) in changed for s2 in range(s + 1))
            keep[s, b] = not (reached or (b == 1 and prompt_changed))
    err = float((lp - lx).abs()[keep].max()) if bool(keep.any()) else 0.0
    limit = tol * float(lx.abs().max())
    finite = bool(torch.isfinite(lp).all())
    share = len(changed) / routed if routed else 0.0
    gated = dtype == torch.float32
    res = dict(layers=L, run=run, max_abs_err=err, limit=limit,
               max_abs_logit=float(lx.abs().max()), routed_tokens=routed,
               routing_changed=len(changed), topk_changed=len(chose),
               changed_share=share, share_gated=gated,
               min_topk_margin=min(margins) if margins else None,
               rows_held=int(keep.sum()),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    ok = finite and err <= limit and (share < ROUTING_FLIP_SHARE
                                      or not gated)
    print(f"moe slice {cfg.name} {L} layer(s) {run} at full width: kept "
          f"experts differ on {len(changed)} of {routed} routed tokens "
          f"({share:.4%}; {'limit ' + format(ROUTING_FLIP_SHARE, '.0%') if gated else 'reported'}), "
          f"top-k choice on {len(chose)}, smallest top-k margin "
          f"{res['min_topk_margin']}, logits on {res['rows_held']} of "
          f"{steps * n_slots} decode rows max|diff| = {err:.3e} (limit "
          f"{limit:.3e} = {tol:g} * max|logit|), peak memory "
          f"{res['peak_mem_gb']:.1f} GB {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, f"moe slice {cfg.name} {run}: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 16: MoE and vlm serving
# ---------------------------------------------------------------------------

# the dense zoo's and the MoE / vlm configs' chunked serving runs: arch,
# layers (None: all), cases
ZOO_SERVING = (("deepseek-7b", None, ("contiguous",)),
               ("qwen3-32b", 16, ("contiguous", "int8 prefix")),
               ("command-r-plus-104b", 4, ("contiguous",)))
# grok-1-314b: 4 of 64 layers (9.7 GB of bf16 experts each); kimi-k2:
# 1 of 61 (33.8 GB of experts); llava-next-34b's backbone: 30 of 60
MOE_SERVING = (("grok-1-314b", 4, ("contiguous", "int8 prefix")),
               ("kimi-k2-1t-a32b", 1, ("contiguous",)),
               ("llava-next-34b", 30, ("contiguous",)))


def layered_serving(torch, seed, rng, table):
    """``table``'s configs served chunked (chunk 256, 4 slots, max_seq
    2048, 16 new tokens), graph parity pairs at full width, bf16: 8
    prompts of 88-1316 tokens on contiguous KV, and, for "int8 prefix", 8
    behind a shared 512-token system prompt on paged int8 KV with the
    prefix cache (later requests must hit it).  Per chunk the projection
    and ``chunk_prefill`` (or its paged int8 twin) launch once per layer,
    per decode step the projection and the decode kernel.  An MoE
    config's contiguous engine then times its decode step and chunk
    (``step_breakdown``).  Each run
    prints its peak memory, and that of making its weights (each leaf is
    drawn in f32 before the cast)."""
    from repro_torch.configs.base import get_config

    out = {}
    for arch, layers, cases in table:
        cfg = get_config(arch)
        L = layers or cfg.num_layers
        lens = [int(x) for x in rng.integers(88, 1317, size=8)]
        torch.cuda.reset_peak_memory_stats()
        params = random_params(torch, dataclasses.replace(
            cfg, num_layers=L), torch.bfloat16, seed)
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"serving weights {arch} {L} layers: peak memory "
              f"{init_peak:.1f} GB while drawing them, "
              f"{torch.cuda.memory_allocated() / 1e9:.1f} GB held",
              flush=True)
        for case in cases:
            if case == "contiguous":
                prompts, kw = _prompts(rng, cfg.vocab_size, lens), {}
                names = ("chunk_prefill", "decode_attention")
            else:
                system = _prompts(rng, cfg.vocab_size, [512])[0]
                prompts = [system + p for p in _prompts(
                    rng, cfg.vocab_size, [int(x) for x in
                                          rng.integers(64, 513, size=8)])]
                kw = dict(cache_kind="paged", page_size=16, kv_dtype="int8",
                          prefix_cache=True)
                names = ("paged_chunk_prefill_int8",
                         "paged_decode_attention_int8")

            def want(phases, engine, names=names):
                n, steps = (phases.get("prefill_chunk", 0),
                            phases.get("decode", 0))
                return {"matmul_tiled": L * (n + steps), names[0]: L * n,
                        names[1]: L * steps, "mha_forward": 0}

            # the MoE engines' decode step and chunk, timed alone
            res = serving_run(torch, f"{arch} {case}", arch, L, prompts,
                              2048, seed, kw, want=want, params=params,
                              breakdown=bool(cfg.num_experts and not kw))
            res["init_peak_mem_gb"] = init_peak
            if kw:
                check(res["prefix_hit_tokens"] > 0,
                      f"{arch} {case}: no prefix-cache hit")
            out[f"{arch} {case}"] = res
        # the engines sit in reference cycles: collect them before the
        # next config's weights are drawn
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_serving_phase(torch, seed):
    import numpy as np

    return layered_serving(torch, seed, np.random.default_rng(seed + 16),
                           MOE_SERVING)


# ---------------------------------------------------------------------------
# phase 17: training on the stub frontends, and grok-1's gradient parity
# ---------------------------------------------------------------------------


def frontend_training_phase(torch, seed):
    """``launch.train.build`` + ``Trainer`` fed by the frontend pipeline's
    f32 embeddings: hubert-xlarge at full size (48 layers, B=8, S=512,
    about 10 s of 20 ms audio frames, bf16, 10 steps; the loss must fall)
    and llava-next-34b cut to 2 layers (B=1, S=2048, 5 steps); then one
    grok-1-314b layer's train-step gradient, kernels against plain."""
    from repro_torch.configs.base import ShapeConfig

    hubert = training_run(torch, "hubert-xlarge --full", "hubert-xlarge",
                          ShapeConfig("hubert_512", 512, 8, "train"), 10,
                          seed, ckpt_every=0)
    losses = hubert["losses"]
    check(sum(losses[-5:]) / 5 < losses[0],
          f"hubert-xlarge: the loss did not fall over 10 steps: {losses}")
    llava = training_run(torch, "llava-next-34b 2 layers", "llava-next-34b",
                         ShapeConfig("llava_2048", 2048, 1, "train"), 5,
                         seed, ckpt_every=0, num_layers=2)
    return {"hubert-xlarge": hubert, "llava-next-34b-2layer": llava,
            "grok-1-314b parity": moe_train_parity(torch, seed)}


def moe_train_parity(torch, seed, S=2048):
    """One grok-1-314b layer at full width: the loss and gradient of the
    train step (its ``grads_of``; no optimizer state) on one f32 state and
    one B=1 batch of S tokens, through the kernels and through plain torch
    ops, f32 compute, held as ``train_parity`` holds them.  The parameters
    are 26 GB at f32 and each gradient as much, so the kernels' gradient
    waits in host memory while the plain one is taken."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.data import pipeline
    from repro_torch.models import module, transformer
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    cfg = dataclasses.replace(get_config("grok-1-314b"), num_layers=1)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    torch.cuda.reset_peak_memory_stats()
    params = module.init_params(transformer.model_spec(cfg), gen,
                                torch.float32, dev)
    tree_map(lambda p: p.requires_grad_(True), params)
    batch = pipeline.device_batch(
        cfg, ShapeConfig("parity", S, 1, "train"), seed, 0, dev)
    tcfg = step_lib.TrainConfig(compute_dtype=torch.float32)
    got = {}
    for impl in ("pallas", "xla"):
        step = step_lib.make_train_step(cfg, FamousConfig(impl=impl), tcfg)
        t0 = time.perf_counter()
        loss, grads = step.grads_of(params, batch)
        gnorm = float(adamw.global_norm(grads))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        leaves = tree_leaves(grads)
        if impl == "pallas":    # to pinned host memory, and back below
            leaves = [torch.empty(g.shape, dtype=g.dtype,
                                  pin_memory=True).copy_(g)
                      for g in leaves]
        got[impl] = (float(loss), gnorm, leaves, seconds)
        del grads
    (lp, np_, gp, tp), (lx, nx, gx, tx) = got["pallas"], got["xla"]
    leaf_err = max(float(torch.linalg.vector_norm(
        a.to(dev, non_blocking=True) - b) / torch.linalg.vector_norm(b))
        for a, b in zip(gp, gx))
    errs = (abs(lp - lx) / abs(lx), abs(np_ - nx) / nx, leaf_err)
    tol = TRAIN_TOL["f32"]
    ok = all(e <= t for e, t in zip(errs, tol)) and math.isfinite(lp)
    peak = torch.cuda.max_memory_allocated() / 1e9
    res = dict(loss_pallas=lp, loss_xla=lx, gnorm_pallas=np_, gnorm_xla=nx,
               rel_errs=errs, tol=tol, leaves=len(gx), s_pallas=tp,
               s_xla=tx, peak_mem_gb=peak)
    print(f"train parity f32: 1-layer grok-1-314b at full width, B=1 S={S}: "
          f"loss {lp:.6f} vs {lx:.6f} (rel {errs[0]:.2e}, tol {tol[0]:g}), "
          f"grad norm {np_:.6f} vs {nx:.6f} (rel {errs[1]:.2e}, tol "
          f"{tol[1]:g}), worst leaf ||pallas - xla||/||xla|| {errs[2]:.2e} "
          f"(tol {tol[2]:g}) over {len(gx)} leaves; {tp:.1f} / {tx:.1f} s, "
          f"peak memory {peak:.1f} GB {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"training parity grok-1-314b failed: {res}")
    del params, got, gp, gx
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 19: duplicate page ids in monolithic paged prefill
# ---------------------------------------------------------------------------


def paged_prefill_writes_phase(torch, seed):
    """``transformer._scatter_pages`` names the null page once for every
    page past a slot's live ones; each duplicate must write the last
    stretch that names it (its device writes land in no fixed order).
    20 draws of a 2048-token bf16 stripe into 128 pages of which 126 are
    the null page: every named page must hold its last stretch.  Then a
    shrunk grok-1-314b (an MoE, where pad rows take expert capacity)
    served with ``prefill_mode="monolithic"`` on a paged pool as a graph
    parity pair: the same tokens eager and as graphs."""
    import numpy as np

    from repro_torch.configs.base import get_config, shrink
    from repro_torch.core.famous import FamousConfig
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServingEngine

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    n_p, ps, kv, dh = 128, 16, 8, 128
    ids = torch.tensor([3, 1] + [0] * (n_p - 2), dtype=torch.int32,
                       device=dev)
    bad = 0
    for _ in range(20):
        seq = torch.randn((n_p * ps, kv, dh), generator=gen,
                          device=dev).to(torch.bfloat16)
        pool = torch.zeros((4, ps, kv, dh), dtype=torch.bfloat16, device=dev)
        transformer._scatter_pages(pool, seq, ids)
        stretch = seq.reshape(n_p, ps, kv, dh)
        bad += not (torch.equal(pool[0], stretch[-1])
                    and torch.equal(pool[3], stretch[0])
                    and torch.equal(pool[1], stretch[1]))
    print(f"paged prefill writes: 20 scatters of 128 pages, 126 of them "
          f"the null page: {20 - bad} of 20 leave every page its last "
          f"stretch {'ok' if not bad else 'FAIL'}", flush=True)
    check(not bad, f"_scatter_pages: {bad} of 20 scatters left a page "
          f"other than its last stretch")

    cfg = shrink(get_config("grok-1-314b"))
    params = random_params(torch, cfg, torch.float32, seed + 19)
    rng = np.random.default_rng(seed + 19)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
               for n in rng.integers(5, 120, size=8)]

    def make_engine():
        return ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                             n_slots=4, max_seq=256, cache_kind="paged",
                             page_size=16, prefill_mode="monolithic",
                             device="cuda")

    def make_reqs():
        return [Request(rid=i, tokens=list(p), max_new=8)
                for i, p in enumerate(prompts)]

    (done, engine, launches, plain, wall), pair = graph_pair(
        torch, "grok-1-314b shrunk monolithic paged", make_engine, make_reqs)
    check(all(r.error is None for r in done),
          f"grok-1 shrunk: {[(r.rid, r.error) for r in done]}")
    del engine, params
    torch.cuda.empty_cache()
    return dict(scatter_bad=bad, pair=pair, launches=launches)


# ---------------------------------------------------------------------------
# phase 18: tensor-parallel serving (parallel/sharding.py, launch/mesh.py)
# ---------------------------------------------------------------------------

# phase 18b's slices at full width: arch, layers, cache kind, the
# serving kernels the slice launches, and how a rank's cache bytes follow
# TP=1's ("split": times TP; "rwkv": the wkv state split, the token-shift
# rows whole; None: not gated).  qwen2-7b's 28 / 4 heads run 14 / 2 a rank
# at TP=2 and 7 / 1 at TP=4; one recurrentgemma-2b unit (RG-LRU, RG-LRU,
# local attention) runs 5 / 1 heads of its 10 / 1 and LRU width 1280 at
# TP=2, and at TP=4 keeps its heads whole (10 does not divide by 4) while
# the FFN and LRU hidden shard (its local attention's chunk runs torch
# ops, its decode the decode kernel); one grok-1-314b layer holds 4 of its
# 8 experts and 24 / 4 heads a rank at TP=2, 2 and 12 / 2 at TP=4; two
# rwkv6-1.6b layers 16 and 8 of their 32 heads (the wkv6 kernel in each
# chunk; decode and the channel mix are torch ops)
TP_SLICES = (("qwen2-7b", 2, "contiguous", SERVING_KERNELS, "split"),
             ("qwen2-7b", 2, "paged", ("matmul_tiled",) + PAGED_KERNELS["fp"],
              "split"),
             ("recurrentgemma-2b", 3, "contiguous",
              ("matmul_tiled", "decode_attention", "rglru_scan"), None),
             ("grok-1-314b", 1, "contiguous", SERVING_KERNELS, "split"),
             ("grok-1-314b", 1, "paged",
              ("matmul_tiled",) + PAGED_KERNELS["fp"], "split"),
             ("rwkv6-1.6b", 2, "contiguous", ("wkv6_scan",), "rwkv"),
             ("rwkv6-1.6b", 2, "paged", ("wkv6_scan",), "rwkv"))
# 18c: "vocab" over "model" (TP_ONLY_RULES), on the TP=2 and TP=4 meshes
VOCAB_SLICES = (TP_SLICES[0], TP_SLICES[1], TP_SLICES[3])
# 18d: the rule sets whose leaves are gathered at each step, by world
# size: rule set, mesh shape; on 2-layer qwen2-7b, 3 requests of one chunk
# and 3 new tokens each (every step gathers gigabytes through the host;
# the third request lands in the second replica group's first slot)
GATHER_RUNS = {2: ("ZERO_SEQ_RULES", (1, 2)), 4: ("DEFAULT_RULES", (2, 2))}
GATHER_SLICES = (("qwen2-7b", 2, "contiguous", SERVING_KERNELS, None),)
GATHER_TRAFFIC = ((40, 77, 100), 3)
# 18e: replica groups under SERVE_TP_RULES, (data=2) on 2 ranks and
# (data=2, model=2) on 4; a rank's cache bytes against one group's at the
# same "model" size: "half" (per-slot caches cut over the groups) or
# "whole" (page pools)
DP_SLICES = (("qwen2-7b", 2, "contiguous", SERVING_KERNELS, "half"),
             ("qwen2-7b", 2, "paged", ("matmul_tiled",) + PAGED_KERNELS["fp"],
              "whole"),
             ("recurrentgemma-2b", 3, "contiguous",
              ("matmul_tiled", "decode_attention", "rglru_scan"), "half"))
TRAFFIC = ((40, 129, 300, 77), 8)
TP_JOIN_S = 420


def mesh_phase(torch, seed):
    """Phase 18: 18a, the engine on a mesh of one rank against the engine
    without one; 18b, TP=2 and TP=4 over gloo ranks sharing the card."""
    import torch.distributed as dist

    try:
        out = {"tp1": tp1_phase(torch, seed)}
        out["tp_ranks"] = tp_ranks_phase(torch, seed)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


# phase 18a's graph pairs, a TP=1 mesh against mesh=None on the same bf16
# weights: arch, layers (None: all), new tokens a request.  qwen2-7b on
# phase 8's prompts; grok-1-314b at 4 of 64 layers (9.7 GB of experts
# each, as in phase 16); rwkv6-1.6b at full depth
TP1_RUNS = (("qwen2-7b", None, 32), ("grok-1-314b", 4, 16),
            ("rwkv6-1.6b", None, 16))


def tp1_phase(torch, seed):
    """Phase 18a: TP1_RUNS served by ``mesh=None`` and by
    ``mesh=make_serving_mesh(tp=1)`` over a process group of one rank,
    each as a graph parity pair on 8 prompts of 64-1536 tokens.  Over a
    "model" axis of size 1 nothing is cut and no collective runs, so
    tokens, final caches (bit for bit), census, kernel launch counts and
    cache bytes must all be equal.  Then qwen2-7b's mesh engine's step
    times (``step_breakdown``)."""
    from repro_torch.launch.mesh import make_serving_mesh

    mesh = make_serving_mesh(tp=1)
    return {arch: tp1_pair(torch, seed, mesh, arch, layers, max_new)
            for arch, layers, max_new in TP1_RUNS}


def tp1_pair(torch, seed, mesh, arch, layers, max_new):
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    tree = random_params(torch, cfg, torch.bfloat16, seed, prepare=False)
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(64, 1537, size=8)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
               for n in lens]

    def make_reqs():
        return [Request(rid=i, tokens=list(p), max_new=max_new)
                for i, p in enumerate(prompts)]

    runs, res = {}, {}
    for label, m in (("mesh=None", None), ("TP=1 mesh", mesh)):
        def make_engine(m=m):
            return ServingEngine(tree, cfg, FamousConfig(impl="pallas"),
                                 n_slots=4, max_seq=2048,
                                 dtype=torch.bfloat16, chunk=256, mesh=m,
                                 device="cuda")

        (done, engine, launches, plain, wall), pair = graph_pair(
            torch, f"{arch} {label}", make_engine, make_reqs)
        check(not any(plain.values()), f"{arch} {label}: a plain version "
              f"ran on CUDA tensors: {plain}")
        runs[label] = dict(
            tokens=[r.out for r in done], launches=launches,
            census=engine.compilations, bytes=engine.cache_bytes_per_device(),
            caches=[{n: b.clone() for n, b in c.items()}
                    for c in engine.caches])
        res[label] = dict(pair=pair, launches=launches,
                          census=runs[label]["census"],
                          cache_bytes=runs[label]["bytes"])
        if m is not None and arch == "qwen2-7b":
            res["steps"] = step_breakdown(torch, engine)
        del engine
        torch.cuda.empty_cache()
    a, b = runs["mesh=None"], runs["TP=1 mesh"]
    same_caches = all(torch.equal(x[n], y[n]) for x, y in
                      zip(a["caches"], b["caches"]) for n in x)
    same = dict(tokens=a["tokens"] == b["tokens"], caches=same_caches,
                census=a["census"] == b["census"],
                launches=a["launches"] == b["launches"],
                cache_bytes=a["bytes"] == b["bytes"])
    res["equal"] = same
    res["launches"] = b["launches"]
    print(f"tensor parallel 18a: {arch} bf16 {cfg.num_layers} layers, TP=1 "
          f"mesh {mesh} against mesh=None: {same}; graph tok/s "
          f"{res['TP=1 mesh']['pair']['graph']['tok_per_s']:.1f} against "
          f"{res['mesh=None']['pair']['graph']['tok_per_s']:.1f}, eager "
          f"{res['TP=1 mesh']['pair']['eager']['tok_per_s']:.1f} against "
          f"{res['mesh=None']['pair']['eager']['tok_per_s']:.1f} "
          f"{'ok' if all(same.values()) else 'FAIL'}", flush=True)
    check(all(same.values()), f"the {arch} TP=1 mesh engine differs from "
          f"mesh=None: {same}")
    del tree, runs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def rank_params(torch, cfg, dtype, seed, mesh, rules=None):
    """This rank's shards of random weights on the card, in the spec
    tree's layout (``ServingEngine(mesh=)`` takes them as they are):
    leaf by leaf in the spec's order from one generator, each drawn
    whole (biases and norm scales then redrawn, as in ``random_params``),
    cut to the rank's shard under ``rules`` (default SERVE_TP_RULES) and
    copied, and the whole leaf freed before the next draw.  Every rank
    draws the same weights and holds its shards plus one whole leaf at a
    time (a whole f32 grok-1 layer with its vocab tables is 26 GB); on a
    mesh of one rank nothing is cut."""
    from repro_torch.models import module, transformer
    from repro_torch.parallel import sharding as shd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = transformer.model_spec(cfg)
    specs = shd.tree_specs(mesh, module.logical_axes(spec),
                           rules or shd.SERVE_TP_RULES,
                           module.param_shapes(spec))
    coords = shd.mesh_coords(mesh)

    def draw(name, leaf, leaf_spec):
        t = module.init_params(leaf, gen, dtype, dev)
        if name.startswith("b"):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.1)
        elif name == "scale":
            t.copy_(1 + 0.1 * torch.randn(t.shape, generator=gen,
                                          device=dev))
        part = shd.local_shard(t, leaf_spec, mesh, coords)
        return t if part is t else part.clone()

    def walk(tree, specs):
        return {k: walk(v, specs[k]) if isinstance(v, dict)
                else draw(k, v, specs[k]) for k, v in tree.items()}

    return walk(spec, specs)


def held_gb(params) -> float:
    """GB of the distinct tensor storages a serving layout holds (the
    fused QKV weight's views count once)."""
    seen = {}

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
        elif hasattr(x, "untyped_storage"):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()

    walk(params)
    return sum(seen.values()) / 1e9


def tp_slices(torch, mesh, seed, slices=TP_SLICES, rules=None,
              traffic=TRAFFIC):
    """``slices`` (default TP_SLICES) served on ``mesh`` under ``rules``
    (default SERVE_TP_RULES) in f32, eagerly (a gloo group's collectives
    cannot be captured): ``traffic`` (prompt lengths, new tokens; 4
    requests of 40-300 tokens, 8 new each), 4 slots, max_seq 512, chunk
    128.  Per slice: tokens, kernel launches and plain versions run on
    CUDA tensors, cache bytes, the weights the engine holds, seconds, peak
    memory.  Every process draws the same weights from ``seed`` and keeps
    its shards (``rank_params``)."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.kernels import lib
    from repro_torch.serve import graphs
    from repro_torch.serve.engine import Request, ServingEngine

    out = {}
    lens, max_new = traffic
    for arch, layers, kind, kernels, bytes_rule in slices:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        tree = rank_params(torch, cfg, torch.float32, seed + 18, mesh, rules)
        draw_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        rng = np.random.default_rng(seed + 18)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=n)]
                   for n in lens]
        engine = ServingEngine(tree, cfg, FamousConfig(impl="pallas"),
                               n_slots=4, max_seq=512, chunk=128,
                               cache_kind=kind, page_size=16, mesh=mesh,
                               sharding_rules=rules, device="cuda")
        del tree
        torch.cuda.synchronize()
        lib.STATS.reset()
        t0 = time.perf_counter()
        with graphs.disable_capture():
            done = sorted(engine.run([Request(rid=i, tokens=p,
                                              max_new=max_new)
                                      for i, p in enumerate(prompts)]),
                          key=lambda r: r.rid)
        torch.cuda.synchronize()
        out[f"{arch} {layers} layers {kind}"] = dict(
            tokens=[r.out for r in done],
            errors=[r.error for r in done if r.error],
            launches=dict(lib.STATS.launches),
            plain_on_cuda=dict(lib.STATS.plain_on_cuda),
            cache_bytes=engine.cache_bytes_per_device(),
            held_gb=held_gb(engine.params),
            kernels=kernels, bytes_rule=bytes_rule,
            # the wkv state's bytes, which an RWKV-6 rank splits
            state_bytes=(4 * layers * 4 * cfg.d_model * cfg.rwkv_head_dim
                         if bytes_rule == "rwkv" else 0),
            seconds=time.perf_counter() - t0,
            draw_peak_gb=draw_peak,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_rank(rank, world, tmp, seed):
    """One rank of phase 18b (a spawned process): joins the gloo group over
    ``tmp``'s FileStore, serves ``tp_slices`` on the TP=``world`` mesh and
    writes them, with its peak memory, to ``tmp/rank{rank}.json``."""
    import traceback

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
        rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_mesh, make_serving_mesh
        from repro_torch.parallel import sharding as shd
        torch.cuda.reset_peak_memory_stats()
        tp = make_serving_mesh(tp=world)
        res = dict(slices=tp_slices(torch, tp, seed))
        res["18c"] = tp_slices(torch, tp, seed, VOCAB_SLICES,
                               shd.TP_ONLY_RULES)
        rules, shape = GATHER_RUNS[world]
        res["18d"] = tp_slices(torch, make_mesh(shape, ("data", "model")),
                               seed, GATHER_SLICES, getattr(shd, rules),
                               GATHER_TRAFFIC)
        res["18e"] = tp_slices(torch, make_serving_mesh(tp=world // 2, dp=2),
                               seed, DP_SLICES)
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    except Exception:
        res = dict(error=traceback.format_exc())
    finally:
        dist.destroy_process_group()
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(res))


def tp_ranks_phase(torch, seed):
    """Phase 18b–18e: TP_SLICES (and GATHER_SLICES at GATHER_TRAFFIC) on
    a mesh of one rank in this process, then on meshes of 2 and 4
    spawned ranks sharing the card over gloo, eagerly: 18b TP_SLICES on
    TP=2 and TP=4, 18c VOCAB_SLICES there under TP_ONLY_RULES, 18d
    GATHER_RUNS, 18e DP_SLICES on (data=2) and (data=2, model=2).  Every
    rank's tokens must equal TP=1's; every serving kernel of a slice must
    launch on every rank and no plain version run on CUDA tensors; cache
    bytes a rank (``rank_runs_check``): 18b and 18c qwen2-7b's and
    grok-1's times TP equal TP=1's, rwkv6-1.6b's TP=1's with the wkv
    state cut TP ways; 18e a contiguous cache's half of one group's at
    the same "model" size, a paged one's equal.  Each run's weights held,
    peak memory a rank and seconds, and each spawn's seconds, are
    printed; every join has a deadline, and a rank still running at it
    is killed."""
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import make_serving_mesh

    tp1 = make_serving_mesh(tp=1)
    base = tp_slices(torch, tp1, seed)
    base_gather = tp_slices(torch, tp1, seed, GATHER_SLICES,
                            traffic=GATHER_TRAFFIC)
    out = {"tp1": base, "tp1 18d traffic": base_gather}
    for world in (2, 4):
        tmp = tempfile.mkdtemp(prefix=f"tp{world}-")
        t0 = time.perf_counter()
        ctx = mp.start_processes(tp_rank, args=(world, tmp, seed),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + TP_JOIN_S
        try:
            while not ctx.join(timeout=max(1.0,
                                           deadline - time.monotonic())):
                check(time.monotonic() < deadline,
                      f"TP={world}: the ranks did not finish in {TP_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        seconds = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(world)]
        shutil.rmtree(tmp, ignore_errors=True)
        for r, got in enumerate(ranks):
            check("error" not in got, f"TP={world} rank {r}: "
                  f"{got.get('error')}")

        def tp_bytes(want, g):
            state = want["state_bytes"]
            return {"split": g["cache_bytes"] * world == want["cache_bytes"],
                    "rwkv": g["cache_bytes"] == (want["cache_bytes"] - state
                                                 + state // world),
                    None: True}[want["bytes_rule"]]

        # one group's bytes at 18e's "model" size: TP=1's on (data=2),
        # TP=2's rank 0 on (data=2, model=2)
        group = (base if world == 2 else
                 {n: dict(r, cache_bytes=r["cache_bytes"][0])
                  for n, r in out["tp2"]["slices"].items()})

        def dp_bytes(want, g):
            one = group[want["name"]]["cache_bytes"]
            return {"half": g["cache_bytes"] * 2 == one,
                    "whole": g["cache_bytes"] == one}[g["bytes_rule"]]

        res = dict(seconds=seconds,
                   peak_mem_gb=[got["peak_mem_gb"] for got in ranks])
        rules, shape = GATHER_RUNS[world]
        for key, label, want, bytes_ok in (
                ("slices", f"18b TP={world}", base, tp_bytes),
                ("18c", f"18c TP={world} TP_ONLY_RULES", base, tp_bytes),
                ("18d", f"18d {rules} on {shape}", base_gather, tp_bytes),
                ("18e", f"18e replica groups (data=2, model={world // 2})",
                 base, dp_bytes)):
            res[key] = rank_runs_check(label, [rk[key] for rk in ranks],
                                       want, bytes_ok)
        print(f"tensor parallel 18b–18e world {world}: {seconds:.1f} s for "
              f"the spawn, peak memory a rank "
              f"{[round(x, 2) for x in res['peak_mem_gb']]} GB", flush=True)
        out[f"tp{world}"] = res
    return out


def rank_runs_check(label, got, base, bytes_ok):
    """The runs of each rank (``got``, a list by rank of {name: run})
    against the TP=1 runs ``base`` of the same names: tokens, every
    kernel of the run launched on every rank, no plain version, and
    ``bytes_ok(want, run)`` for each rank's cache bytes.  Prints a line a
    run and fails on any miss."""
    res = {}
    for name in got[0]:
        want = dict(base[name], name=name)
        runs = [g[name] for g in got]
        tokens_ok = all(g["tokens"] == want["tokens"] and not g["errors"]
                        for g in runs)
        launched = all(g["launches"][k] > 0 for g in runs
                       for k in g["kernels"])
        plain_none = not any(v for g in runs
                             for v in g["plain_on_cuda"].values())
        bytes_good = all(bytes_ok(want, g) for g in runs)
        r = res[name] = dict(
            tokens_equal=tokens_ok, kernels_launched=launched,
            no_plain=plain_none, cache_bytes_ok=bytes_good,
            cache_bytes=[g["cache_bytes"] for g in runs],
            launches=[{k: g["launches"][k] for k in g["kernels"]}
                      for g in runs],
            held_gb=[g["held_gb"] for g in runs],
            seconds=[g["seconds"] for g in runs],
            draw_peak_gb=[g["draw_peak_gb"] for g in runs],
            peak_mem_gb=[g["peak_mem_gb"] for g in runs])
        ok = tokens_ok and launched and plain_none and bytes_good
        print(f"tensor parallel {label} {name}: tokens equal to TP=1 on "
              f"every rank {tokens_ok}, kernels launched on every rank "
              f"{launched} {r['launches'][0]}, no plain version "
              f"{plain_none}, cache bytes a rank {r['cache_bytes']} against "
              f"TP=1 {want['cache_bytes']} ({bytes_good}); weights held a "
              f"rank {[round(x, 2) for x in r['held_gb']]} GB against TP=1 "
              f"{want['held_gb']:.2f}; rank seconds "
              f"{[round(x, 2) for x in r['seconds']]} against TP=1 "
              f"{want['seconds']:.2f}; peak memory a rank serving "
              f"{[round(x, 2) for x in r['peak_mem_gb']]} GB against TP=1 "
              f"{want['peak_mem_gb']:.2f}, drawing the weights "
              f"{[round(x, 2) for x in r['draw_peak_gb']]} GB against "
              f"{want['draw_peak_gb']:.2f} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"{label} {name}: {r}")
    return res


# ---------------------------------------------------------------------------
# phase 20: sharded training
# ---------------------------------------------------------------------------

# 20b's meshes over famous-bert at full size (B=8, S=512, f32 compute, 3
# steps, DEFAULT_RULES): name, shape; the ranks of a world size share the
# card over gloo
SHARDED_MESHES = (("data=2", (2, 1)), ("model=2", (1, 2)),
                  ("pod=2", (2, 1, 1)), ("data=2 model=2", (2, 2)))
# the one-rank references: key, arch, layers (None: all), S, B, steps
SHARDED_REFS = (("famous-bert", "famous-bert", None, 512, 8, 3),
                ("qwen2-7b TP=2", "qwen2-7b", 2, 2048, 1, 2),
                ("recurrentgemma-2b model=2", "recurrentgemma-2b", 6, 2048,
                 1, 2),
                ("rwkv6-1.6b model=2", "rwkv6-1.6b", 2, 2048, 1, 2))
# 20d: the recurrent families on model=2 under DEFAULT_RULES (run key and
# reference, the training kernels the run launches): recurrentgemma-2b's
# 2 units (RG-LRU channels, 5 of 10 query heads over the whole kv head,
# the MLP hidden), rwkv6-1.6b's 2 layers at full width (16 of 32 heads,
# the norm's statistics summed, the channel mix's hidden; its wkv is the
# model's differentiable torch scan, so it launches no kernel)
SHARDED_FAMILIES = {"recurrentgemma-2b model=2": TRAINING_KERNELS,
                    "rwkv6-1.6b model=2": ()}
SHARDED_STEP_AT_SAVE = 2
SHARDED_JOIN_S = 480


def sharded_training_phase(torch, seed):
    """Phase 20: 20a, famous-bert at full size through ``launch.train.
    build`` on a (data=1, model=1) mesh against ``mesh=None``; 20b and
    20c and the resize on meshes of spawned ranks sharing the card over
    gloo, against one-rank runs here."""
    import torch.distributed as dist

    try:
        out = {"20a": one_rank_mesh_training(torch, seed)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out.update(sharded_rank_phase(torch, seed))
    return out


def _sharded_tcfg(torch, dtype):
    from repro_torch.train import step as step_lib
    return step_lib.TrainConfig(compute_dtype=dtype, schedule_warmup=5)


def _shape_cfg(arch, layers, S, B):
    from repro_torch.configs.base import ShapeConfig, get_config
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg, ShapeConfig(f"{arch}_{S}", S, B, "train")


def one_rank_mesh_training(torch, seed):
    """20a: famous-bert at full size (12 layers, d 768, 8 heads), B=8,
    S=512, bf16 compute, 5 steps through ``launch.train.build`` with
    ``mesh=None`` and on a (data=1, model=1) mesh (a process group of one
    rank): nothing is cut and no collective runs, so the losses, the
    final state (bit for bit) and the kernel launch counts must be
    equal.  Both median step times are printed."""
    from repro_torch.kernels import lib
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.models.module import tree_leaves

    cfg, shape = _shape_cfg("famous-bert", None, 512, 8)
    mesh = make_training_mesh((1, 1))
    runs = {}
    for label, m in (("mesh=None", None), ("(1, 1) mesh", mesh)):
        _, state, ts, batch_fn = train_launch.build(
            "famous-bert", shape, smoke=False,
            tcfg=_sharded_tcfg(torch, torch.bfloat16), seed=seed + 20,
            device="cuda", cfg=cfg, mesh=m)
        batches = [batch_fn(i) for i in range(5)]
        torch.cuda.synchronize()
        lib.STATS.reset()
        losses, times = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, met = ts(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
        runs[label] = dict(
            losses=losses, launches=dict(lib.STATS.launches),
            plain=dict(lib.STATS.plain_on_cuda),
            step_ms_median=sorted(times[1:])[len(times[1:]) // 2] * 1e3,
            leaves=[t.detach() for t in tree_leaves(state)
                    if isinstance(t, torch.Tensor)])
        del state, ts, batches
    a, b = runs["mesh=None"], runs["(1, 1) mesh"]
    same = dict(losses=a["losses"] == b["losses"],
                state=all(torch.equal(x, y) for x, y in
                          zip(a["leaves"], b["leaves"])),
                launches=a["launches"] == b["launches"])
    launched = all(b["launches"][k] > 0 for k in TRAINING_KERNELS)
    plain_none = not any(v for r in runs.values() for v in r["plain"].values())
    ratio = b["step_ms_median"] / a["step_ms_median"]
    ok = all(same.values()) and launched and plain_none
    print(f"sharded training 20a: famous-bert 12 layers B=8 S=512 bf16, 5 "
          f"steps, (1, 1) mesh against mesh=None: {same}; step "
          f"{b['step_ms_median']:.1f} ms median against "
          f"{a['step_ms_median']:.1f} ms ({ratio:.3f}x); launches "
          f"{json.dumps({k: b['launches'][k] for k in TRAINING_KERNELS})} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"20a: the (1, 1) mesh run differs from mesh=None: {same}, "
          f"launched {launched}, no plain version {plain_none}")
    res = {label: {k: v for k, v in r.items() if k != "leaves"}
           for label, r in runs.items()}
    res.update(equal=same, step_ratio=ratio)
    del runs
    torch.cuda.empty_cache()
    return res


def one_rank_reference(torch, seed, arch, layers, S, B, steps, path):
    """A one-rank (``mesh=None``) f32-compute run of ``steps`` steps:
    its losses and gradient norms, its parameters after the last step
    saved to ``path`` (``torch.save``, a list in ``tree_leaves`` order),
    and its seconds."""
    from repro_torch.launch import train as train_launch
    from repro_torch.models.module import tree_leaves

    cfg, shape = _shape_cfg(arch, layers, S, B)
    _, state, ts, batch_fn = train_launch.build(
        arch, shape, smoke=False, tcfg=_sharded_tcfg(torch, torch.float32),
        seed=seed + 20, device="cuda", cfg=cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, gnorms = [], []
    for i in range(steps):
        state, met = ts(state, batch_fn(i))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    seconds = time.perf_counter() - t0
    torch.save([p.detach().cpu() for p in tree_leaves(state["params"])],
               path)
    del state, ts
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, grad_norms=gnorms, seconds=seconds)


def sharded_run(torch, key, mesh, rules, ref_path, seed, steps,
                state=None, start=0, save=None):
    """SHARDED_REFS' run ``key`` on ``mesh`` under ``rules`` through
    ``launch.train.build`` (f32 compute), steps [start, steps) from
    ``state`` (default: the build's, this rank's shards of the full
    draw); ``save``: a directory to checkpoint into after step
    SHARDED_STEP_AT_SAVE.  Returns this rank's losses and gradient norms,
    the worst ||params - reference|| / ||reference|| over the whole
    parameter leaves against ``ref_path`` (the ranks' shards' sums of
    squares summed over the mesh), the launch counts of the steps, the
    plain versions run on CUDA tensors, seconds, the peak memory of the
    whole run and of the steps alone, and the vocabulary ranges."""
    from repro_torch.kernels import lib
    from repro_torch.launch import train as train_launch
    from repro_torch.models.module import tree_leaves
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import checkpoint as ckpt_lib

    _, arch, layers, S, B, _ = next(r for r in SHARDED_REFS if r[0] == key)
    cfg, shape = _shape_cfg(arch, layers, S, B)
    torch.cuda.reset_peak_memory_stats()
    _, built, ts, batch_fn = train_launch.build(
        arch, shape, smoke=False, tcfg=_sharded_tcfg(torch, torch.float32),
        seed=seed + 20, device="cuda", cfg=cfg, mesh=mesh, rules=rules)
    state = state or built
    del built
    torch.cuda.synchronize()
    # the build draws whole leaves before it keeps the rank's shards: the
    # steps' own peak is read apart
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    lib.STATS.reset()
    t0 = time.perf_counter()
    losses, gnorms = [], []
    for i in range(start, steps):
        state, met = ts(state, batch_fn(i))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        if save and i + 1 == SHARDED_STEP_AT_SAVE:
            ckpt_lib.save_checkpoint(save, i + 1, state,
                                     specs=ts.state_specs, mesh=mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(lib.STATS.launches)
    plain = dict(lib.STATS.plain_on_cuda)
    comm = ts.layout.comm
    ref = torch.load(ref_path, mmap=True)
    # each leaf's squared error and squared norm over this rank's shard
    # against the same slice of the reference, summed over every rank in
    # one all-reduce: a leaf that r ranks hold counts r times in both, so
    # the ratio is the whole leaf's (no leaf is gathered)
    sq = torch.zeros((len(ref), 2), dtype=torch.float64, device="cuda")
    for i, (leaf, spec, want) in enumerate(zip(
            tree_leaves(state["params"]),
            tree_leaves(ts.state_specs["params"]), ref)):
        want = shd.local_shard(want, spec, mesh, comm.coords).to(leaf.device)
        sq[i, 0] = (leaf.detach() - want).double().square().sum()
        sq[i, 1] = want.double().square().sum()
        del want
    sq = comm.sum_world(sq)
    worst = float((sq[:, 0] / sq[:, 1]).sqrt().max())
    res = dict(losses=losses, grad_norms=gnorms, worst_param_rel=worst,
               launches=launches, plain_on_cuda=plain, seconds=seconds,
               peak_mem_gb=max(build_peak, step_peak,
                               torch.cuda.max_memory_allocated() / 1e9),
               step_peak_gb=step_peak, vocab=ts.layout.vocab)
    del state, ts, ref
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sharded_rank(rank, world, tmp, ref_dir, seed):
    """One rank of phase 20 (a spawned process): joins the gloo group over
    ``tmp``'s FileStore and runs its world size's meshes of
    SHARDED_MESHES; the world of 2 also saves its data=2 run at step 2,
    resumes it on model=2 (``elastic.reshard_restore``) and runs 20c and
    20d.
    Writes the results to ``tmp/rank{rank}.json``."""
    import traceback

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
        rank=rank, world_size=world)
    try:
        res = sharded_rank_runs(torch, world, tmp, ref_dir, seed)
    except Exception:
        res = dict(error=traceback.format_exc())
    finally:
        dist.destroy_process_group()
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(res))


def sharded_rank_runs(torch, world, tmp, ref_dir, seed):
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import elastic
    from repro_torch.train import step as step_lib

    bert_ref = str(Path(ref_dir) / "famous-bert.pt")
    ckpt = str(Path(tmp) / "ckpt")
    meshes = {name: make_training_mesh(shape) for name, shape in
              SHARDED_MESHES if math.prod(shape) == world}
    out = {}
    for name, mesh in meshes.items():
        out[name] = sharded_run(
            torch, "famous-bert", mesh, shd.DEFAULT_RULES, bert_ref, seed, 3,
            save=ckpt if name == "data=2" else None)
    if world != 2:
        return out
    # resize: the data=2 run's step-2 checkpoint onto model=2, step 3
    cfg, shape = _shape_cfg("famous-bert", None, 512, 8)
    _, like, _, _ = train_launch.build(
        "famous-bert", shape, smoke=False,
        tcfg=_sharded_tcfg(torch, torch.float32), seed=seed, device="cuda",
        cfg=cfg, mesh=meshes["model=2"])
    state, step = elastic.reshard_restore(
        ckpt, like, meshes["model=2"], step_lib.state_logical_axes(cfg))
    del like
    out["resize data=2 -> model=2"] = dict(
        sharded_run(torch, "famous-bert", meshes["model=2"],
                    shd.DEFAULT_RULES, bert_ref, seed, 3, state=state,
                    start=step), restored_step=step)
    del state
    out["qwen2-7b TP=2"] = sharded_run(
        torch, "qwen2-7b TP=2", meshes["model=2"], shd.TP_ONLY_RULES,
        str(Path(ref_dir) / "qwen2-7b TP=2.pt"), seed, 2)
    for key in SHARDED_FAMILIES:
        out[key] = sharded_run(torch, key, meshes["model=2"],
                               shd.DEFAULT_RULES,
                               str(Path(ref_dir) / f"{key}.pt"), seed, 2)
    return out


def sharded_rank_phase(torch, seed):
    """20b, 20c, 20d and the resize.  The one-rank references
    (SHARDED_REFS) run here first; then the ranks of world 2 and of world
    4 are spawned at once, sharing the card over gloo.  On every rank of
    every run: each step's loss within TRAIN_TOL["f32"][0] relative and
    grad norm within [1] of the reference's, the parameters after the
    last step within 1e-4 relative (each whole leaf's norm) of the
    reference's, every kernel of TRAINING_KERNELS (20d: of
    SHARDED_FAMILIES) launched and no plain version run.  Each
    rank's peak memory and each run's seconds are printed; every join has
    a deadline, and a rank still running at it is killed."""
    import torch.multiprocessing as mp

    ref_dir = tempfile.mkdtemp(prefix="sharded-ref-")
    tmps = {w: tempfile.mkdtemp(prefix=f"sharded{w}-") for w in (2, 4)}
    try:
        refs = {}
        for key, arch, layers, S, B, steps in SHARDED_REFS:
            refs[key] = one_rank_reference(torch, seed, arch, layers, S, B,
                                           steps,
                                           str(Path(ref_dir) / f"{key}.pt"))
            print(f"sharded training reference {key}: {B}x{S}, {steps} "
                  f"f32 steps on one rank, losses {refs[key]['losses']}, "
                  f"grad norms {refs[key]['grad_norms']}, "
                  f"{refs[key]['seconds']:.1f} s", flush=True)
        t0 = time.perf_counter()
        ctxs = {w: mp.start_processes(sharded_rank,
                                      args=(w, tmps[w], ref_dir, seed),
                                      nprocs=w, join=False,
                                      start_method="spawn")
                for w in tmps}
        deadline = time.monotonic() + SHARDED_JOIN_S
        seconds = {}
        try:
            for w, ctx in ctxs.items():
                while not ctx.join(timeout=max(
                        1.0, deadline - time.monotonic())):
                    check(time.monotonic() < deadline,
                          f"sharded training: the {w} ranks did not finish "
                          f"in {SHARDED_JOIN_S} s")
                seconds[w] = time.perf_counter() - t0
        finally:
            for ctx in ctxs.values():
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
        ranks = {w: [json.loads((Path(tmps[w]) / f"rank{r}.json")
                                .read_text()) for r in range(w)]
                 for w in tmps}
    finally:
        for d in [ref_dir, *tmps.values()]:
            shutil.rmtree(d, ignore_errors=True)
    out = {"references": refs, "spawn_seconds": seconds}
    for w, got in ranks.items():
        for r, res in enumerate(got):
            check("error" not in res, f"sharded training world {w} rank "
                  f"{r}: {res.get('error')}")
        for name in got[0]:
            key = (name if name in refs else "famous-bert")
            kernels = SHARDED_FAMILIES.get(name, TRAINING_KERNELS)
            ref = refs[key]
            first = SHARDED_STEP_AT_SAVE if name.startswith("resize") else 0
            loss_tol, norm_tol = TRAIN_TOL["f32"][:2]
            per = []
            for r, res in enumerate(got):
                run = res[name]
                loss_err = max(abs(a - b) / abs(b) for a, b in zip(
                    run["losses"], ref["losses"][first:]))
                norm_err = max(abs(a - b) / b for a, b in zip(
                    run["grad_norms"], ref["grad_norms"][first:]))
                launched = all(run["launches"][k] > 0 for k in kernels)
                plain_none = not any(run["plain_on_cuda"].values())
                ok = (loss_err <= loss_tol and norm_err <= norm_tol
                      and run["worst_param_rel"] <= 1e-4 and launched
                      and plain_none
                      and len(run["losses"]) == len(ref["losses"]) - first)
                per.append(dict(rank=r, loss_rel=loss_err,
                                grad_norm_rel=norm_err,
                                param_rel=run["worst_param_rel"],
                                launched=launched, no_plain=plain_none,
                                ok=ok, seconds=run["seconds"],
                                peak_mem_gb=run["peak_mem_gb"],
                                step_peak_gb=run["step_peak_gb"],
                                vocab=run["vocab"],
                                launches={k: run["launches"][k]
                                          for k in kernels}))
                print(f"sharded training {name} (world {w}) rank {r}: "
                      f"losses {['%.6f' % x for x in run['losses']]}, loss "
                      f"rel {loss_err:.2e} (tol {loss_tol:g}), grad norm "
                      f"rel {norm_err:.2e} (tol {norm_tol:g}), whole "
                      f"params rel {run['worst_param_rel']:.2e} (tol 1e-4), "
                      f"launches {per[-1]['launches']}, no plain "
                      f"{plain_none}, {run['seconds']:.1f} s, peak memory "
                      f"{run['peak_mem_gb']:.2f} GB (the steps alone "
                      f"{run['step_peak_gb']:.2f} GB), vocabulary rows / "
                      f"head columns {run['vocab']} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"sharded training {name} rank {r}: {per[-1]}")
            out[name] = per
    print(f"sharded training: the ranks took {seconds} s (world: seconds "
          f"from the spawn)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 21: analysis (repro_torch.analysis and the §VII model)
# ---------------------------------------------------------------------------

# each kernel's main-path row in phase 3 (its shape's prefix and dtype), as
# the kernels JSON line reads it
MAIN_SHAPE = {"matmul_tiled": "T=4 ", "matmul_tiled_int8": "T=4 ",
              "decode_attention": "B=4",
              "chunk_prefill": "C=256 offset=1792",
              "mha_forward": "famous-bert", "mha_bwd_dq": "famous-bert",
              "mha_bwd_dkv": "famous-bert",
              "paged_decode_attention": "B=4",
              "paged_decode_attention_int8": "B=4",
              "paged_chunk_prefill": "C=256 offset=1792",
              "paged_chunk_prefill_int8": "C=256 offset=1792",
              "rglru_scan": "B=1 S=256",
              "wkv6_scan": "BH=32 S=256 dh=64 chunk=64 s0=random"}
# the dtypes the main path hands each kernel: the RG-LRU's a and b are f32
# in a bf16 model
MAIN_DT = {"matmul_tiled_int8": "int8", "rglru_scan": "f32"}


def main_row(rows, name):
    dt = MAIN_DT.get(name, "bf16")
    return next(r for r in rows if r["name"] == name and r["dtype"] == dt
                and r["shape"].startswith(MAIN_SHAPE[name]))


def analysis_phase(torch, rows, seed):
    """Phase 21 (see the module docstring): the analysis CLI, the contract
    check of phase 3's launches, a lowered budget refused, the H100 spec
    against the device, the §VII model beside phase 3's events, and the
    quickstart twin."""
    import os

    from repro_torch.analysis import kernel_check
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.core import analytical
    from repro_torch.kernels import lib
    from repro_torch.kernels.decode import chunk_prefill
    from repro_torch.kernels.scan import linear_scan
    from repro_torch.serve import graphs

    res = {}
    # (a) the CLI, on the card
    t0 = time.perf_counter()
    rc = analysis_main([])
    res["cli_rc"], res["cli_s"] = rc, time.perf_counter() - t0
    print(f"analysis (a): python -m repro_torch.analysis exit {rc} in "
          f"{res['cli_s']:.1f}s {'ok' if rc == 0 else 'FAIL'}", flush=True)
    check(rc == 0, f"python -m repro_torch.analysis exited {rc}")

    # (b) every kernel row's checked relaunch
    budget = kernel_check.smem_budget()
    bad = [(r["name"], r["shape"], r["dtype"], r["contract"]["violations"])
           for r in rows if r["contract"]["violations"]
           or not r["contract"]["launches"]]
    n_launches = sum(len(r["contract"]["launches"]) for r in rows)
    checked = {r["name"] for r in rows if r["contract"]["launches"]}
    print(f"analysis (b): {len(rows)} kernel rows, {n_launches} launches "
          f"checked (budget {budget} B), {len(bad)} with a violation or no "
          f"record", flush=True)
    shown = []
    for name in lib.KERNELS:
        main = main_row(rows, name)
        # another row of the main dtype whose grid writes a workspace
        # (split partials, or a second pass's input)
        ws_row = next((r for r in rows if r["name"] == name
                       and r is not main and r["dtype"] == main["dtype"]
                       and any(x["ws_written"]
                               for x in r["contract"]["launches"])), None)
        dh256 = [r for r in rows if r["name"] == name
                 and "dh=256" in r["shape"]]
        for tag, r in [("main", main), ("workspace", ws_row)] + [
                ("dh 256", r) for r in dh256]:
            if r is None:
                continue
            shown.append(dict(kernel=name, row=tag, shape=r["shape"],
                              dtype=r["dtype"],
                              launches=r["contract"]["launches"]))
            print(f"  {name} [{tag}] {r['shape']} {r['dtype']}:")
            for x in r["contract"]["launches"]:
                launch = kernel_check.Launch(**{
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in x.items() if k != "wrapper"})
                print(f"    {launch.text(budget)}", flush=True)
    res.update(rows_checked=len(rows), launches_checked=n_launches,
               violations=bad, shown=shown)
    check(not bad, f"kernel contract violations: {bad}")
    check(checked == set(lib.KERNELS),
          f"kernels with no checked launch: {set(lib.KERNELS) - checked}")

    # (c) the budget lowered to 48 KB: the main-path chunk launch, which
    # (b) shows takes more, must be refused, naming its kernel
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((1, 256, 28, 128), generator=gen, device=dev).bfloat16()
    kc, vc = (torch.randn((4, 2048, 4, 128), generator=gen,
                          device=dev).bfloat16() for _ in range(2))

    def chunk():
        return chunk_prefill.chunk_prefill(q, kc, vc, 1792, scale=128 ** -0.5,
                                           slot=2)

    with kernel_check.checking(True), kernel_check.collecting() as seen:
        chunk()
    need = max(x.smem for _, x in seen)
    big = next(x for _, x in seen if x.smem == need)
    refused = None
    prev = os.environ.get("REPRO_SMEM_BUDGET_BYTES")
    os.environ["REPRO_SMEM_BUDGET_BYTES"] = str(SMEM_LOW)
    try:
        with kernel_check.checking(True):
            chunk()
    except kernel_check.KernelContractError as e:
        refused = str(e)
    finally:
        if prev is None:
            del os.environ["REPRO_SMEM_BUDGET_BYTES"]
        else:
            os.environ["REPRO_SMEM_BUDGET_BYTES"] = prev
    torch.cuda.synchronize()
    ok = (need > SMEM_LOW and refused is not None and big.name in refused
          and f"budget of {SMEM_LOW}" in refused)
    res["lowered_budget"] = dict(launch=big.name, smem=need, refused=refused)
    print(f"analysis (c): chunk_prefill C=256 offset=1792 bf16 needs "
          f"{need} B ({big.name}); at a {SMEM_LOW} B budget the checker "
          f"{'refuses it: ' + refused.splitlines()[-1].strip() if refused else 'ACCEPTS it'} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"a {SMEM_LOW} B budget did not refuse {big.name} "
          f"({need} B): {refused}")

    # (d) the spec against the device; the fixed cost of a kernel in a
    # replayed graph (100 tiny rglru_scan launches) beside the spec's
    hw = analytical.H100
    props = torch.cuda.get_device_properties(dev)
    dev_smem = props.shared_memory_per_block_optin
    dev_sms = props.multi_processor_count
    a, b = (torch.zeros((1, 1, 32), device=dev) for _ in range(2))

    def hundred():
        return [linear_scan.rglru_scan(a, b) for _ in range(100)]

    hundred()
    torch.cuda.synchronize()
    graph, _ = graphs.capture(hundred, graphs.GraphPool(dev))
    per_launch_us = median_call_ms(torch, graph.replay, 20) * 1e3 / 100
    del graph
    ok = hw.smem_bytes == dev_smem and hw.sms == dev_sms
    res["spec"] = dict(smem_spec=hw.smem_bytes, smem_device=dev_smem,
                       sms_spec=hw.sms, sms_device=dev_sms,
                       launch_us_spec=hw.launch_latency * 1e6,
                       launch_us_graph=per_launch_us)
    print(f"analysis (d): {hw.name} spec shared memory a block "
          f"{hw.smem_bytes} B, SMs {hw.sms}; device {dev_smem} B, "
          f"{dev_sms} SMs {'ok' if ok else 'FAIL'}; a tiny kernel in a "
          f"replayed graph {per_launch_us:.2f} us (spec launch latency "
          f"{hw.launch_latency * 1e6:.2f} us)", flush=True)
    check(ok, f"H100 spec {hw.smem_bytes} B / {hw.sms} SMs against the "
          f"device's {dev_smem} B / {dev_sms}")

    # (e) the §VII model on the H100 beside phase 3's events
    def row_ms(name, prefix):
        return next(r["ms"] for r in rows if r["name"] == name
                    and r["dtype"] == "bf16" and r["shape"].startswith(prefix))

    preds = []
    for label, call, modules, name, prefix in (
            ("Table I QKV_PM", dict(batch=1, seq=64, heads=8, kv_heads=8,
                                    head_dim=96, d_model=768),
             ("QKV_PM",), "matmul_tiled", "T=64 D=768 F=2304"),
            ("Table I QK+SV", dict(batch=1, seq=64, heads=8, kv_heads=8,
                                   head_dim=96, d_model=768),
             ("QK_PM", "SV_PM"), "mha_forward", "Table I"),
            ("qwen2-7b chunk QK+SV", dict(batch=1, seq=256, kv_seq=2048,
                                          heads=28, kv_heads=4, head_dim=128,
                                          d_model=3584),
             ("QK_PM", "SV_PM"), "chunk_prefill", "C=256 offset=1792")):
        tuned = analytical.autotune_tiles(hw=hw, **call)
        pred_us = sum(m.t_total for m in tuned["latency"].modules
                      if m.name in modules) * 1e6
        got_us = row_ms(name, prefix) * 1e3
        preds.append(dict(label=label, tiles=tuned["tiles"], pred_us=pred_us,
                          kernel=name, measured_us=got_us,
                          ratio=got_us / pred_us))
        print(f"analysis (e): {label}: predicted {pred_us:.2f} us at tiles "
              f"{tuned['tiles']}; {name} measured {got_us:.2f} us (x"
              f"{got_us / pred_us:.2f})", flush=True)
    res["predictions"] = preds

    # (f) the quickstart twin
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" /
                                               "quickstart_torch.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    res["quickstart"] = dict(rc=proc.returncode,
                             s=time.perf_counter() - t0,
                             out=proc.stdout[-4000:], err=proc.stderr[-4000:])
    print("\n".join("  | " + ln for ln in proc.stdout.splitlines()))
    print(f"analysis (f): examples/quickstart_torch.py exit "
          f"{proc.returncode} in {res['quickstart']['s']:.1f}s "
          f"{'ok' if proc.returncode == 0 else 'FAIL'}", flush=True)
    check(proc.returncode == 0, f"quickstart_torch.py exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    return res


# ---------------------------------------------------------------------------
# phase 22: the dry run
# ---------------------------------------------------------------------------

DRYRUN_CELLS = ("decode_32k", "train_4k")


def dryrun_phase(torch, seed):
    """Phase 22 (see the module docstring)."""
    import os

    out_dir = ROOT / "chiprun_out" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {shape: subprocess.Popen(
        [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
         "--arch", "qwen2-7b", "--shape", shape, "--mesh", "pod1",
         "--out", str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for shape in DRYRUN_CELLS}
    try:
        res = {"b": dryrun_prediction(torch, seed)}
        res["a"] = {}
        for shape, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            ok = p.returncode == 0 and "ALL CELLS PASSED" in stdout
            print(f"dry run (a): qwen2-7b {shape} pod1: exit "
                  f"{p.returncode} {'ALL CELLS PASSED' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"dry run CLI on {shape}: {stdout[-2000:]}"
                      f"{stderr[-2000:]}")
            cell = json.loads((out_dir / f"qwen2-7b__{shape}__pod1.json")
                              .read_text())
            rf, mem = cell["roofline"], cell["memory"]
            res["a"][shape] = dict(memory=mem, roofline=rf,
                                   t_run_s=cell["t_run_s"])
            print(f"dry run (a): {shape}: {mem['per_device_gib']:.3f} GiB a "
                  f"device (fits 80 GB: {mem['fits_80gb']}), dominant "
                  f"{rf['dominant']}, roofline fraction "
                  f"{rf['roofline_fraction']:.4g}, useful-FLOP ratio "
                  f"{rf['useful_flop_ratio']:.4g}, step run on meta in "
                  f"{cell['t_run_s']} s", flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    res["c"] = dryrun_bound_vs_time(torch, res["b"].pop("decode_step"))
    return res


def predict_and_measure(torch, label, fn, meta_args, make_args):
    """(b) for one step: ``fn`` counted on ``meta_args`` by ``op_cost``,
    then run on the card on ``make_args()`` under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.roofline import op_cost

    pred = op_cost.analyse_ops(fn, *meta_args)
    pred_args = op_cost.argument_bytes(meta_args)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = make_args()
    real_args = op_cost.argument_bytes(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    flops = fc.get_total_flops()
    predicted = pred_args + pred.peak_bytes
    ratio = (peak - base) / predicted
    row = dict(flops=flops, predicted_flops=pred.flops,
               argument_bytes=real_args, predicted_argument_bytes=pred_args,
               peak_bytes=pred.peak_bytes, predicted_peak=predicted,
               max_memory_allocated=peak, allocated_before=base,
               ratio=ratio)
    print(f"dry run (b): {label}: FLOPs {flops:.6e} on the card, "
          f"{pred.flops:.6e} predicted; arguments {real_args} B, "
          f"{pred_args} B predicted; peak {peak - base} B "
          f"(max_memory_allocated {peak} less {base} allocated before), "
          f"{predicted} B predicted (arguments + peak_bytes "
          f"{pred.peak_bytes}): x{ratio:.4f}", flush=True)
    check(flops == pred.flops, f"{label}: FLOPs {flops} on the card, "
                               f"{pred.flops} predicted")
    check(real_args == pred_args, f"{label}: arguments {real_args} B, "
                                  f"{pred_args} B predicted")
    check(abs(ratio - 1) <= 0.25, f"{label}: peak x{ratio:.4f} of the "
                                  f"prediction")
    return row, args, pred


def dryrun_prediction(torch, seed):
    """22(b): qwen2-7b's decode step, then a 2-layer training step."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import pipeline
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.train import step as step_lib

    cfg = get_config("qwen2-7b")
    dev = torch.device("cuda")
    shape = ShapeConfig("serve_2048", 2048, 4, "decode")
    low = dryrun.lower_serve(cfg, shape)

    def decode_args():
        params = random_params(torch, cfg, torch.bfloat16, seed)
        caches = transformer.make_caches(cfg, 4, 2048, torch.bfloat16, dev)
        tokens = torch.randint(0, cfg.vocab_size, (4,), device=dev)
        clen = torch.full((4,), 1024, dtype=torch.int32, device=dev)
        return params, tokens, caches, clen

    out = {}
    out["decode"], args, pred = predict_and_measure(
        torch, "qwen2-7b decode step (4 x 2048, bf16)", low.fn, low.args,
        decode_args)
    out["decode_step"] = dict(args=args, pred=pred, cfg=cfg, shape=shape,
                              arg_bytes=out["decode"]["argument_bytes"])

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    tshape = ShapeConfig("qwen_2048", 2048, 1, "train")
    tcfg = step_lib.TrainConfig(schedule_warmup=5)
    low = dryrun.lower_train(cfg2, tshape, tcfg=tcfg)

    def train_args():
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = step_lib.init_state(cfg2, tcfg, gen, dev)
        return state, pipeline.device_batch(cfg2, tshape, seed, 0, dev)

    # the decode step's arguments stay for (c): 16.8 GB beside 38 GB
    out["train"], _, _ = predict_and_measure(
        torch, "qwen2-7b 2-layer train step (1 x 2048, f32)", low.fn,
        low.args, train_args)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dryrun_bound_vs_time(torch, decode):
    """22(c): the decode step's roofline bound on ``analytical.H100``
    beside its time through the kernels, eager and as a graph replay."""
    from repro_torch.core.analytical import H100
    from repro_torch.core.famous import FamousConfig
    from repro_torch.models import transformer
    from repro_torch.roofline import analysis
    from repro_torch.serve import graphs

    cfg, shape, pred = decode["cfg"], decode["shape"], decode["pred"]
    params, tokens, caches, clen = decode["args"]
    rf = analysis.analyse("qwen2-7b", shape.name, "1 card", cost=pred,
                          chips=1,
                          model_flops_total=analysis.model_flops(cfg, shape),
                          hw=H100)
    fcfg = FamousConfig(impl="pallas")

    def step():
        return transformer.decode_step(params, tokens, caches, clen, cfg,
                                       fcfg)

    eager = time_ms(torch, step, [()], 5)
    pool = graphs.GraphPool(torch.device("cuda"))
    ex = graphs.Executable(lambda key: step(), pool)
    ex("decode")                          # the eager warm-up
    ex("decode")                          # capture, then one replay
    replay = median_call_ms(torch, lambda: ex("decode"), 10)
    out = dict(t_bound_ms=rf.t_bound * 1e3, t_compute_ms=rf.t_compute * 1e3,
               t_memory_ms=rf.t_memory * 1e3, dominant=rf.dominant,
               args_read_ms=decode["arg_bytes"] / H100.hbm_bw * 1e3,
               bytes_accessed=pred.bytes_accessed, flops=pred.flops,
               eager_ms=eager, graph_ms=replay,
               bound_over_eager=rf.t_bound * 1e3 / eager,
               bound_over_graph=rf.t_bound * 1e3 / replay)
    print(f"dry run (c): qwen2-7b decode step (4 x 2048, 1024 cached, bf16): "
          f"t_bound {out['t_bound_ms']:.3f} ms on {H100.name} "
          f"({rf.dominant}: {pred.bytes_accessed:.4e} B unfused, "
          f"{pred.flops:.4e} FLOPs of the xla path; its arguments read "
          f"once {out['args_read_ms']:.3f} ms); through the kernels "
          f"{eager:.3f} ms eager (CUDA events, mean of 5), {replay:.3f} ms "
          f"a graph replay (median of 10): t_bound x"
          f"{out['bound_over_eager']:.3f} of eager, "
          f"x{out['bound_over_graph']:.3f} of the replay", flush=True)
    del ex, pool
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "chip_smoke.json"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import lib

    smi = smi_line()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    path = lib.build()
    lib.load()
    t_build = time.perf_counter() - t0
    print(f"build: {path} in {t_build:.1f}s", flush=True)
    print(ptxas_summary(lib.BUILD_LOG), flush=True)

    phase_s = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        res = fn(torch, *a)
        phase_s[name] = time.perf_counter() - t
        print(f"phase {name}: {phase_s[name]:.1f}s", flush=True)
        return res

    rows = phase("kernels", kernel_phase, args.iters, args.seed)
    table_one = phase("table I", table_one_phase, args.seed)
    parity = phase("slice parity", slice_phase, args.seed)
    train_parity = phase("training parity", train_parity_phase, args.seed)
    training = phase("training runs", training_phase, args.seed)
    serving = phase("serving", serving_phase, args.seed)
    rec_parity = phase("recurrent slice parity", recurrent_slice_phase,
                       args.seed)
    rec_serving = phase("recurrent serving", recurrent_serving_phase,
                        args.seed)
    mono_parity = phase("monolithic slice parity", monolithic_slice_phase,
                        args.seed)
    mono_serving = phase("monolithic serving", monolithic_serving_phase,
                         args.seed)
    zoo_serving = phase("dense zoo serving", zoo_serving_phase, args.seed)
    flexible = phase("flexible", flexible_phase, args.seed)
    moe_parity = phase("moe slice parity", moe_slice_phase, args.seed)
    moe_serving = phase("moe serving", moe_serving_phase, args.seed)
    frontend_training = phase("frontend training", frontend_training_phase,
                              args.seed)
    mesh_serving = phase("tensor-parallel serving", mesh_phase, args.seed)
    paged_writes = phase("paged prefill writes", paged_prefill_writes_phase,
                         args.seed)
    sharded = phase("sharded training", sharded_training_phase, args.seed)
    analysis = phase("analysis", analysis_phase, rows, args.seed)
    dry_run = phase("dry run", dryrun_phase, args.seed)

    paths = [r["launches"] for r in training.values()] + [serving["launches"]]
    paths += [r["launches"] for r in serving["shared_prefix"].values()]
    paths += [serving["int8_projection"]["launches"],
              serving["oracle_speculative"]["launches"]]
    paths += [r["launches"] for r in rec_serving.values()]
    paths += [r["launches"] for r in mono_serving.values()
              if "launches" in r]
    paths += [r["launches"] for r in zoo_serving.values()]
    paths += [r["launches"] for r in moe_serving.values()]
    paths += [r["launches"] for r in frontend_training.values()
              if "launches" in r]
    paths += [run[k]["launches"] for run in mesh_serving["tp1"].values()
              for k in ("mesh=None", "TP=1 mesh")]
    paths += [paged_writes["launches"]]
    paths += [sharded["20a"][k]["launches"] for k in ("mesh=None",
                                                      "(1, 1) mesh")]
    launches = {k: sum(p[k] for p in paths) for k in lib.KERNELS}
    check(all(v > 0 for v in launches.values()),
          f"a kernel never launched on the training and serving paths: "
          f"{launches}")
    entries = []
    for name in lib.KERNELS:
        r = main_row(rows, name)
        entries.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"], dtype=r["dtype"],
            timed_by=r["timed_by"]))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, torch=torch.__version__,
                                   build_s=t_build, build_log=lib.BUILD_LOG,
                                   kernels=rows, table_one=table_one,
                                   slice_parity=parity,
                                   train_parity=train_parity,
                                   training=training, serving=serving,
                                   recurrent_slice_parity=rec_parity,
                                   recurrent_serving=rec_serving,
                                   monolithic_slice_parity=mono_parity,
                                   monolithic_serving=mono_serving,
                                   zoo_serving=zoo_serving,
                                   flexible=flexible,
                                   moe_slice_parity=moe_parity,
                                   moe_serving=moe_serving,
                                   frontend_training=frontend_training,
                                   mesh_serving=mesh_serving,
                                   paged_prefill_writes=paged_writes,
                                   sharded_training=sharded,
                                   analysis=analysis,
                                   dry_run=dry_run,
                                   phase_s=phase_s),
                              indent=1))
    print(json.dumps({"kernels": entries}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
