#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--iters N]

Phases, in order; any failure exits non-zero before the result line:

  1. the card's name and power limit (``nvidia-smi``);
  2. build: every CUDA source under ``src/repro_torch/kernels/csrc`` is
     compiled for sm_90a into one shared library (``build/``);
  3. kernels: each hand-written kernel against its plain PyTorch version at
     the serving path's qwen2-7b shapes, in f32 and bf16, with the kernel's,
     the plain version's and one library call's time (CUDA events, inputs
     rotated through more than the 50 MB L2), and the least time the card
     could take (bytes over 3.35 TB/s or operations over the type's peak);
  4. slice parity: a 2-layer cut of qwen2-7b at full width runs
     ``prefill_chunk`` + ``decode_step`` through the kernels
     (``impl="pallas"``) and through plain torch ops (``impl="xla"``) on
     the same weights; the logits must agree;
  5. serving: the full 28-layer qwen2-7b in bf16, random weights made on
     the card from ``--seed``, serves 8 greedy requests through
     ``ServingEngine.run``; every kernel must have launched and no plain
     version may have run on the card.

The line before the last holds the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}   # dense bf16 tensor core; f32 FMA
TOL = {"f32": 1e-4, "bf16": 2e-2}             # kernel vs plain, atol = rtol
ATTN_TOL = {"f32": 2e-5, "bf16": 2e-2}
L2_BYTES = 50 * 2**20
REPLACES = {
    "matmul_tiled": "src/repro/kernels/qkv/qkv_proj.py:71",
    "decode_attention": "src/repro/kernels/decode/decode_attn.py:276",
    "chunk_prefill": "src/repro/kernels/decode/chunk_prefill.py:91",
}
SOURCES = {
    "matmul_tiled": "src/repro_torch/kernels/csrc/matmul_tiled.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "chunk_prefill": "src/repro_torch/kernels/csrc/chunk_prefill.cu",
}


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
               nbytes, flops):
        err, ok = compare(torch, out, ref, tol)
        ms = time_ms(torch, fn, sets, iters)
        plain_ms = time_ms(torch, plain, sets, max(3, iters // 4))
        library_ms = time_ms(torch, lib_fn, sets, iters) if lib_fn else None
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
    torch.cuda.synchronize()
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: slice parity at full width
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
# phase 5: serving the full model
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
    check(all(v > 0 for v in launches.values()),
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
    from torch.profiler import ProfilerActivity, profile

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
            group = next((k for k in ("matmul_tiled", "decode_attention",
                                      "chunk_prefill") if k in key), None)
            if group is None:
                group = ("library GEMM" if any(
                    w in key.lower() for w in ("gemm", "gemv", "xmma",
                                               "cutlass", "nvjet", "splitk"))
                    else "other")
            groups[group] = groups.get(group, 0.0) + us / 1e3
        device_ms = sum(groups.values())
        top = sorted(((getattr(ev, "self_device_time_total", 0) / 1e3,
                       ev.key) for ev in prof.key_averages()), reverse=True)
        out[name] = dict(step_ms=step_ms, device_ms=device_ms,
                         by_group_ms=groups, top_kernels=top[:12])
        shares = ", ".join(f"{k} {v:.3f} ms" for k, v in
                           sorted(groups.items(), key=lambda kv: -kv[1]))
        print(f"step {name}: {step_ms:.3f} ms (CUDA events); profiled "
              f"device time {device_ms:.3f} ms: {shares or 'not measured'}",
              flush=True)
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

    rows = kernel_phase(torch, args.iters, args.seed)
    parity = slice_phase(torch, args.seed)
    serving = serving_phase(torch, args.seed)

    main_shape = {"matmul_tiled": "T=4 ", "decode_attention": "B=4",
                  "chunk_prefill": "C=256 offset=1792"}
    entries = []
    for name in lib.KERNELS:
        r = next(r for r in rows if r["name"] == name and r["dtype"] == "bf16"
                 and r["shape"].startswith(main_shape[name]))
        entries.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=serving["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"], dtype=r["dtype"]))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, torch=torch.__version__,
                                   build_s=t_build, build_log=lib.BUILD_LOG,
                                   kernels=rows, slice_parity=parity,
                                   serving=serving), indent=1))
    print(json.dumps({"kernels": entries}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
