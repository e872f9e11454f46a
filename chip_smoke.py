#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--iters N]

Phases, in order; any failure exits non-zero before the result line:

  1. the card's name and power limit (``nvidia-smi``);
  2. build: every CUDA source under ``src/repro_torch/kernels/csrc`` is
     compiled for sm_90a into one shared library (``build/``);
  3. kernels: each hand-written kernel against its plain PyTorch version,
     in f32 and bf16, with the kernel's, the plain version's and one
     library call's time (CUDA events, inputs rotated through more than
     the 50 MB L2), and the least time the card could take (bytes over
     3.35 TB/s or operations over the type's peak).  Serving shapes of
     qwen2-7b for ``matmul_tiled``, ``decode_attention`` and
     ``chunk_prefill``; training shapes of famous-bert (B=8, S=512, 8
     heads, dh=96, non-causal) and qwen2-7b (B=1, S=2048, 28/4 heads,
     dh=128, causal) for ``mha_forward``, ``mha_bwd_dq``, ``mha_bwd_dkv``
     and ``matmul_tiled`` in its dX / dW roles;
  4. Table I: the paper's topology (SL=64, d_model=768, h=8) through
     ``famous.qkv_projection`` + ``famous.attention`` with impl reference,
     xla and pallas; the three must agree;
  5. slice parity: a 2-layer cut of qwen2-7b at full width runs
     ``prefill_chunk`` + ``decode_step`` through the kernels
     (``impl="pallas"``) and through plain torch ops (``impl="xla"``) on
     the same weights; the logits must agree;
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
     ``ServingEngine.run``.

The launch counters are set to 0 before each run of phases 7 and 8 and
read after it: every kernel must have launched on those paths and no plain
version may have run on the card.  The last three lines of output are the
per-kernel JSON record (``{"kernels": [...]}``), the ``nvidia-smi`` name
and power limit, and ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
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
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}   # dense bf16 tensor core; f32 FMA
TOL = {"f32": 1e-4, "bf16": 2e-2}             # kernel vs plain, atol = rtol
ATTN_TOL = {"f32": 2e-5, "bf16": 2e-2}
L2_BYTES = 50 * 2**20
BWD_TOL = {"f32": 1e-4, "bf16": 1e-4}          # f32 math on the same inputs
SERVING_KERNELS = ("matmul_tiled", "decode_attention", "chunk_prefill")
TRAINING_KERNELS = ("matmul_tiled", "mha_forward", "mha_bwd_dq",
                    "mha_bwd_dkv")
REPLACES = {
    "matmul_tiled": "src/repro/kernels/qkv/qkv_proj.py:71",
    "decode_attention": "src/repro/kernels/decode/decode_attn.py:276",
    "chunk_prefill": "src/repro/kernels/decode/chunk_prefill.py:91",
    "mha_forward": "src/repro/kernels/attention/mha.py:122",
    "mha_bwd_dq": "src/repro/kernels/attention/mha.py:262",
    "mha_bwd_dkv": "src/repro/kernels/attention/mha.py:282",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in REPLACES}
# the training shapes of the attention kernels:
# name, B, S, H, KV, dh, causal
TRAIN_ATTN = (("famous-bert", 8, 512, 8, 8, 96, False),
              ("qwen2-7b", 1, 2048, 28, 4, 128, True))
# the QKV projection's VJP at the same two training shapes: T = B*S, D, F
TRAIN_PROJ = (("famous-bert", 8 * 512, 768, 3 * 768),
              ("qwen2-7b", 2048, 3584, 3584 + 2 * 512))


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


def n_sets(bytes_per_set: int) -> int:
    return max(2, min(64, math.ceil(2 * L2_BYTES / max(bytes_per_set, 1)) + 1))


def bound(nbytes: float, flops: float, dt: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(torch, iters, seed):
    import torch.nn.functional as F

    from repro_torch.kernels.decode import chunk_prefill, decode_attn
    from repro_torch.kernels.decode import ref as dec_ref
    from repro_torch.kernels.qkv import qkv_proj
    from repro_torch.kernels.qkv import ref as qkv_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    rows = []

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(name, shape, dt, out, ref, tol, fn, plain, lib_fn, sets,
               nbytes, flops, n_iter=iters, lib_sets=None):
        err, ok = compare(torch, out, ref, tol)
        ms = time_ms(torch, fn, sets, n_iter)
        plain_ms = time_ms(torch, plain, sets, max(3, n_iter // 4))
        library_ms = (time_ms(torch, lib_fn, lib_sets or sets, n_iter)
                      if lib_fn else None)
        b_ms, b_by = bound(nbytes, flops, dt)
        row = dict(name=name, shape=shape, dtype=dt, max_abs_err=err, tol=tol,
                   ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
        rows.append(row)
        print(f"kernel {name:17s} {shape:34s} {dt:4s} max_abs_err={err:.3e} "
              f"(tol {tol:g}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms if library_ms is None else round(library_ms, 4)} "
              f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}",
              flush=True)

    # matmul_tiled: the fused QKV projection, T = 4 (decode) and 256 (chunk)
    D, Fo = 3584, 4608
    for dt, dtype in dts.items():
        e = torch.tensor([], dtype=dtype).element_size()
        for T in (4, 256):
            per = (T * D + D * Fo) * e
            sets = [(randn((T, D), dtype), randn((D, Fo), dtype, D ** -0.5))
                    for _ in range(n_sets(per))]
            x, w = sets[0]
            out = qkv_proj.matmul_tiled(x, w)
            ref = qkv_ref.matmul_reference(x, w)
            record("matmul_tiled", f"T={T} D={D} F={Fo}", dt, out, ref,
                   TOL[dt], qkv_proj.matmul_tiled, qkv_ref.matmul_reference,
                   torch.matmul, sets, (T * D + D * Fo + T * Fo) * e,
                   2.0 * T * D * Fo)

    # decode_attention: 4 slots, 28 query / 4 kv heads, mixed lengths
    B, H, KV, dh, Skv = 4, 28, 4, 128, 2048
    lens_list = [1, 37, 1000, 2048]
    scale = dh ** -0.5
    live = sum(lens_list)
    for dt, dtype in dts.items():
        e = torch.tensor([], dtype=dtype).element_size()
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
        lib_out = library(q, k, v, ln)[:, :, 0]
        lib_err, _ = compare(torch, lib_out, ref, ATTN_TOL[dt])
        print(f"  (library vs plain max_abs_err {lib_err:.3e})")
        record("decode_attention", f"B={B} H={H} KV={KV} dh={dh} "
               f"Skv={Skv} lens={lens_list}", dt, out, ref, ATTN_TOL[dt],
               kern, plain, library, sets,
               2 * B * H * dh * e + live * KV * dh * 2 * e + 4 * B,
               4.0 * H * dh * live)

    # chunk_prefill: one slot of the batched cache, C = 256 at two offsets
    C, slot = 256, 2
    for dt, dtype in dts.items():
        e = torch.tensor([], dtype=dtype).element_size()
        for off in (0, 1792):
            visible = sum(off + c + 1 for c in range(C))
            per = (C * H * dh + 2 * (off + C) * KV * dh) * e
            cmask = (torch.arange(Skv, device=dev)[None, :]
                     <= off + torch.arange(C, device=dev)[:, None])

            def kern(q, k, v, off=off):
                return chunk_prefill.chunk_prefill(
                    q, k[slot:slot + 1], v[slot:slot + 1], off, scale=scale)

            def plain(q, k, v, off=off):
                return dec_ref.chunk_prefill_reference(
                    q, k[slot:slot + 1], v[slot:slot + 1], off, scale=scale)

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
                   4.0 * H * dh * visible)
    training_kernel_rows(torch, F, dts, randn, record, iters)
    torch.cuda.synchronize()
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    return rows


def training_kernel_rows(torch, F, dts, randn, record, iters):
    """The training path's kernels at its two shapes: the attention forward
    (library: ``scaled_dot_product_attention`` with GQA), the dq and dk/dv
    backward kernels (library: that call's backward, timed as
    ``torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)``, the
    same number for both), and the QKV projection's VJP products dX and dW
    on their transposed contiguous operands (library: ``torch.matmul``)."""
    from repro_torch.kernels.attention import mha as mha_k
    from repro_torch.kernels.attention import ref as mha_ref
    from repro_torch.kernels.qkv import qkv_proj
    from repro_torch.kernels.qkv import ref as qkv_ref

    slow = max(5, iters // 5)
    for label, B, S, H, KV, dh, causal in TRAIN_ATTN:
        kw = dict(causal=causal, window=0, scale=dh ** -0.5, q_offset=0)
        shape = (f"{label} B={B} S={S} H={H} KV={KV} dh={dh} "
                 f"{'causal' if causal else 'full'}")
        # (query, key) pairs this run's mask leaves visible
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
        rows_bytes = B * H * S * 4                     # one f32 (BH, S) row
        for dt, dtype in dts.items():
            e = torch.tensor([], dtype=dtype).element_size()
            qn, kn = B * H * S * dh, B * KV * S * dh
            sets = [(randn((B * H, S, dh), dtype), randn((B * KV, S, dh), dtype),
                     randn((B * KV, S, dh), dtype))
                    for _ in range(n_sets((2 * qn + 2 * kn) * e))]

            def kern_f(q, k, v):
                return mha_k.mha_forward(q, k, v, return_lse=True, **kw)

            def plain_f(q, k, v):
                return mha_ref.mha_forward_reference(q, k, v, **kw)

            def lib_f(q, k, v):
                return F.scaled_dot_product_attention(
                    q.view(B, H, S, dh), k.view(B, KV, S, dh),
                    v.view(B, KV, S, dh), is_causal=causal,
                    scale=kw["scale"], enable_gqa=True)

            q, k, v = sets[0]
            out, ref = kern_f(q, k, v), plain_f(q, k, v)
            lib_err, _ = compare(torch, lib_f(q, k, v).reshape(out[0].shape),
                                 ref[0], ATTN_TOL[dt])
            print(f"  (library vs plain max_abs_err {lib_err:.3e})")
            record("mha_forward", shape, dt, out, ref, ATTN_TOL[dt], kern_f,
                   plain_f, lib_f, sets, (2 * qn + 2 * kn) * e + rows_bytes,
                   4.0 * dh * pairs, n_iter=slow)

            # backward inputs: the plain forward's residuals and a cotangent
            bsets, lsets = [], []
            for q, k, v in sets:
                o, lse = plain_f(q, k, v)
                do = randn((B * H, S, dh), dtype)
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
            for name, kern, plain, nbytes, flops in (
                    ("mha_bwd_dq", mha_k.mha_bwd_dq, mha_ref.mha_bwd_dq_reference,
                     in_bytes + qn * 4, 6.0 * dh * pairs),
                    ("mha_bwd_dkv", mha_k.mha_bwd_dkv,
                     mha_ref.mha_bwd_dkv_reference, in_bytes + 2 * kn * 4,
                     8.0 * dh * pairs)):
                def kfn(*a, kern=kern):
                    return kern(*a, **kw)

                def pfn(*a, plain=plain):
                    return plain(*a, **kw)

                out, ref = kfn(*bsets[0]), pfn(*bsets[0])
                record(name, shape, dt, out, ref, BWD_TOL[dt], kfn, pfn, lib_b,
                       bsets, nbytes, flops, n_iter=slow, lib_sets=lsets)
            del bsets, lsets

    for label, T, D, Fo in TRAIN_PROJ:
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
                       2.0 * m * kd * n, n_iter=slow)


# ---------------------------------------------------------------------------
# phase 4: the paper's Table I topology through the three impls
# ---------------------------------------------------------------------------


def table_one_phase(torch, seed):
    """examples/quickstart.py on the card: SL=64, d_model=768, h=8, f32,
    non-causal; the xla and pallas impls against the reference."""
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
    return errs


# ---------------------------------------------------------------------------
# phase 5: slice parity at full width
# ---------------------------------------------------------------------------


def random_params(torch, cfg, dtype, seed):
    """Random weights on the card; biases and norm scales drawn too, so a
    bias or scale fault shows in the logits."""
    from repro_torch.models import module, transformer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tree = module.init_params(transformer.model_spec(cfg), gen, dtype, dev)

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
    return transformer.prepare_params(tree, cfg)


def slice_phase(torch, seed):
    from repro_torch.configs.base import get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen,
                           device=dev)
    n_slots, max_seq, C, n = 4, 2048, 256, 400
    results = {}
    # tolerance relative to the largest logit: f32 differs only in the
    # order of sums; bf16 also rounds q/k/v and the attention output at
    # other places on the two paths, and 2 layers carry that to the logits
    for dt, dtype, tol in (("f32", torch.float32, 1e-4),
                           ("bf16", torch.bfloat16, 5e-2)):
        params = random_params(torch, cfg, dtype, seed)
        logits = {}
        for impl in ("pallas", "xla"):
            fcfg = FamousConfig(impl=impl)
            caches = transformer.make_caches(cfg, n_slots, max_seq, dtype, dev)
            for start in (0, C):
                transformer.prefill_chunk(
                    params, prompt[:, start:start + C], caches, 1, start,
                    min(C, n - start), cfg, fcfg)
            last = torch.tensor([5, int(prompt[0, n - 1]), 9, 11], device=dev)
            clen = torch.tensor([0, n - 1, 0, 0], dtype=torch.int32,
                                device=dev)
            lg, _ = transformer.decode_step(params, last, caches, clen, cfg,
                                            fcfg)
            logits[impl] = lg
        torch.cuda.synchronize()
        ref = logits["xla"]
        err = float((logits["pallas"] - ref).abs().max())
        limit = tol * float(ref.abs().max())
        finite = bool(torch.isfinite(logits["pallas"]).all())
        results[dt] = dict(max_abs_err=err, limit=limit,
                           max_abs_logit=float(ref.abs().max()),
                           shape=list(ref.shape))
        print(f"slice parity {dt}: 2-layer qwen2-7b at full width, logits "
              f"{tuple(ref.shape)}, max|kernels - plain| = {err:.3e} "
              f"(limit {limit:.3e} = {tol:g} * max|logit|)",
              flush=True)
        check(finite and err <= limit,
              f"slice parity {dt} failed: {results[dt]}")
        del params, logits
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 6: training parity at full width
# ---------------------------------------------------------------------------

# (loss, global grad norm, every leaf's ||pallas - xla|| / ||xla||), relative
TRAIN_TOL = {"f32": (1e-5, 1e-4, 1e-3), "bf16": (5e-3, 2e-2, 5e-2)}


def train_parity_phase(torch, seed):
    """A 2-layer cut of qwen2-7b at full width: the gradient of one
    ``make_train_step`` (its ``grads_of``) on one f32 state and one
    B=1, S=2048 batch, through the kernels (``impl="pallas"``) and through
    plain torch ops (``impl="xla"``), in f32 and in bf16 compute."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.data import pipeline
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    state = step_lib.init_state(cfg, step_lib.TrainConfig(), gen, dev)
    params = state.pop("params")
    del state
    batch = pipeline.device_batch(
        cfg, ShapeConfig("parity", 2048, 1, "train"), seed, 0, dev)
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
        print(f"train parity {dt}: 2-layer qwen2-7b at full width, B=1 "
              f"S=2048: loss {lp:.6f} vs {lx:.6f} (rel {errs[0]:.2e}, tol "
              f"{tol[0]:g}), grad norm {np_:.6f} vs {nx:.6f} (rel "
              f"{errs[1]:.2e}, tol {tol[1]:g}), worst leaf ||pallas - "
              f"xla||/||xla|| {errs[2]:.2e} (tol {tol[2]:g}) over "
              f"{len(gp)} leaves {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"training parity {dt} failed: {results[dt]}")
        del got, gp, gx
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 7: training runs through the launcher's build + Trainer
# ---------------------------------------------------------------------------


def training_run(torch, label, arch, shape, steps, seed, ckpt_every,
                 num_layers=None):
    """``launch.train.build`` + ``Trainer`` on the card with bf16 compute
    and a 5-step warmup; the launch counters cover exactly this run."""
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
    check(all(launches[k] > 0 for k in TRAINING_KERNELS),
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
    return {"famous-bert": bert, "qwen2-7b-2layer": qwen}


# ---------------------------------------------------------------------------
# phase 8: serving the full model
# ---------------------------------------------------------------------------


def serving_phase(torch, seed):
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.famous import FamousConfig
    from repro_torch.kernels import lib
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = get_config("qwen2-7b")
    t0 = time.perf_counter()
    params = random_params(torch, cfg, torch.bfloat16, seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = cfg.param_count()
    engine = ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                           n_slots=4, max_seq=2048, dtype=torch.bfloat16,
                           chunk=256, device="cuda")
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(64, 1537, size=8)]
    reqs = [Request(rid=i, tokens=[int(t) for t in
                                   rng.integers(0, cfg.vocab_size, size=n)],
                    max_new=32) for i, n in enumerate(lens)]
    lib.STATS.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lib.STATS.launches)
    plain = dict(lib.STATS.plain_on_cuda)
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
    res["steps"] = step_breakdown(torch, engine)
    return res


def step_breakdown(torch, engine):
    """Device time of one decode step (4 slots at 1024 cached tokens) and
    one 256-token prefill chunk (offset 1024) of the serving engine's model:
    the step's time from CUDA events, and its kernels' device time by
    group from ``torch.profiler``."""
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    p, cfg, fcfg, caches = engine.params, engine.cfg, engine.fcfg, engine.caches
    last = torch.ones(engine.n_slots, dtype=torch.long, device=dev)
    clen = torch.full((engine.n_slots,), 1024, dtype=torch.int32, device=dev)
    chunk = torch.ones((1, engine.chunk), dtype=torch.long, device=dev)
    steps = {
        "decode_step": lambda: transformer.decode_step(p, last, caches, clen,
                                                       cfg, fcfg),
        "prefill_chunk": lambda: transformer.prefill_chunk(
            p, chunk, caches, 0, 1024, engine.chunk, cfg, fcfg),
    }
    out = {}
    for name, fn in steps.items():
        step_ms = time_ms(torch, lambda: fn(), [()], 5)
        out[name] = dict(step_ms=step_ms, **profile_groups(torch, fn))
        print(f"step {name}: {step_ms:.3f} ms (CUDA events); profiled "
              f"device time {out[name]['device_ms']:.3f} ms: "
              f"{group_text(out[name]['by_group_ms'])}", flush=True)
    return out


def profile_groups(torch, fn):
    """Device time of one call of ``fn`` from ``torch.profiler``, summed
    by kernel group: each port kernel, library GEMMs, everything else."""
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
        group = next((k for k in lib.KERNELS if k in key), None)
        if group is None:
            group = ("library GEMM" if any(
                w in key.lower() for w in ("gemm", "gemv", "xmma",
                                           "cutlass", "nvjet", "splitk"))
                else "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
    top = sorted(((getattr(ev, "self_device_time_total", 0) / 1e3, ev.key)
                  for ev in prof.key_averages()), reverse=True)
    return dict(device_ms=sum(groups.values()), by_group_ms=groups,
                top_kernels=top[:12])


def group_text(groups):
    return ", ".join(f"{k} {v:.3f} ms" for k, v in
                     sorted(groups.items(), key=lambda kv: -kv[1])) \
        or "not measured"


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

    rows = kernel_phase(torch, args.iters, args.seed)
    table_one = table_one_phase(torch, args.seed)
    parity = slice_phase(torch, args.seed)
    train_parity = train_parity_phase(torch, args.seed)
    training = training_phase(torch, args.seed)
    serving = serving_phase(torch, args.seed)

    paths = [r["launches"] for r in training.values()] + [serving["launches"]]
    launches = {k: sum(p[k] for p in paths) for k in lib.KERNELS}
    check(all(v > 0 for v in launches.values()),
          f"a kernel never launched on the training and serving paths: "
          f"{launches}")
    main_shape = {"matmul_tiled": "T=4 ", "decode_attention": "B=4",
                  "chunk_prefill": "C=256 offset=1792",
                  "mha_forward": "famous-bert", "mha_bwd_dq": "famous-bert",
                  "mha_bwd_dkv": "famous-bert"}
    entries = []
    for name in lib.KERNELS:
        r = next(r for r in rows if r["name"] == name and r["dtype"] == "bf16"
                 and r["shape"].startswith(main_shape[name]))
        entries.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"], dtype=r["dtype"]))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, torch=torch.__version__,
                                   build_s=t_build, build_log=lib.BUILD_LOG,
                                   kernels=rows, table_one=table_one,
                                   slice_parity=parity,
                                   train_parity=train_parity,
                                   training=training, serving=serving),
                              indent=1))
    print(json.dumps({"kernels": entries}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
