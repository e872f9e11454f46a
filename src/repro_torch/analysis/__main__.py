"""``python -m repro_torch.analysis``: run every static-analysis pass
(the counterpart of ``python -m repro.analysis``).

Passes (any can be skipped; the exit status is nonzero if any ran and
failed):

1. **lint**: the AST rules of :mod:`repro_torch.analysis.lint` over
   ``src/repro_torch`` against the checked-in baseline
   (``analysis/lint_baseline.txt``): new findings fail, stale baseline
   entries are reported.  ``--update-baseline`` rewrites the baseline to
   the current findings instead of failing.
2. **kernel-check**: every kernel family launched once at tiny shapes on
   the card, in f32 and bf16, with the launch-contract checker on (grid
   coverage, threads, shared memory against the budget and the
   ``allow_smem`` cap, workspace against the wrapper's plan), including
   the int8 and paged twins and a split launch of every launcher that
   splits.  The kernels run only on a CUDA device: on a host without one
   this pass fails and says so; ``--no-kernel-check`` skips it.
3. **retrace**: tiny warmed serving engines (plain, speculative, int8
   paged, and under ``torchrun`` with 2 or more ranks a TP=2 mesh) each
   serve a fresh batch under
   :func:`repro_torch.analysis.retrace_guard.retrace_guard` with zero new
   CUDA-graph captures.  On the CPU nothing is captured, so there the pass
   shows only that the engines run.

``scripts/ci_torch.sh`` runs this before the port's tests.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys


def run_lint(update_baseline: bool) -> int:
    from repro_torch.analysis import lint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings = lint.lint_paths(root)
    if update_baseline:
        lint.write_baseline(findings)
        print(f"lint: baseline rewritten with {len(findings)} finding(s) "
              f"-> {lint.BASELINE_FILE}")
        return 0
    new, stale = lint.compare_to_baseline(findings, lint.load_baseline())
    for f in new:
        print(f"lint: NEW {f}")
    for fp in stale:
        print(f"lint: stale baseline entry (fixed? remove it): {fp}")
    n_base = len(findings) - len(new)
    print(f"lint: {len(findings)} finding(s): {len(new)} new, "
          f"{n_base} baselined, {len(stale)} stale baseline entr(ies)")
    return 1 if new else 0


def kernel_launches(torch, dev, gen):
    """(label, launch) for every kernel family at tiny shapes, f32 and
    bf16 (int8 operands for the int8 projection), with a split launch of
    each launcher that splits: the bf16 projections at T = 4 over a deep
    D, the chunk and MHA forward kernels over 1024 keys, dq and dk/dv at
    a few row blocks."""
    from repro_torch.kernels.attention import mha
    from repro_torch.kernels.decode import chunk_prefill as cp
    from repro_torch.kernels.decode import decode_attn as da
    from repro_torch.kernels.decode import mla_decode as mla
    from repro_torch.kernels.qkv import qkv_proj
    from repro_torch.kernels.scan import linear_scan as ls

    def arr(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def i8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(shape):
        return torch.rand(shape, generator=gen, device=dev) * 2e-2 + 1e-3

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    out = []
    # the int8 projection at T = 4 (its split-K over D = 1024) and T = 64
    for T, D in ((4, 1024), (64, 256)):
        out.append((f"qkv/matmul_tiled_int8 T={T} D={D}", functools.partial(
            qkv_proj.matmul_tiled_int8, i8((T, D)), i8((128, D)),
            scales((T, 1)), scales((1, 128)))))
    pt = i32(list(range(1, 33))).reshape(2, 16)     # 16 pages of 64 a slot
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        # T = 4 over D = 512: the bf16 split-K; T = 64: the chunk tiles
        for T, D in ((4, 512), (64, 64)):
            out.append((f"qkv/matmul_tiled {tag} T={T} D={D}",
                        functools.partial(qkv_proj.matmul_tiled,
                                          arr((T, D), dt), arr((D, 128), dt))))
        k, v = arr((2, 64, 2, 64), dt), arr((2, 64, 2, 64), dt)
        out.append((f"decode/decode_attention {tag}", functools.partial(
            da.decode_attention, arr((2, 4, 64), dt), k, v, i32([5, 60]),
            scale=0.125)))
        kp, vp = arr((33, 64, 2, 64), dt), arr((33, 64, 2, 64), dt)
        out.append((f"decode/paged_decode_attention {tag}",
                    functools.partial(da.paged_decode_attention,
                                      arr((2, 4, 64), dt), kp, vp, pt,
                                      i32([5, 1000]), scale=0.125)))
        ks, vs = scales((33, 64, 2)), scales((33, 64, 2))
        out.append((f"decode/paged_decode_attention_int8 {tag}",
                    functools.partial(da.paged_decode_attention_int8,
                                      arr((2, 4, 64), dt), i8(kp.shape),
                                      i8(vp.shape), ks, vs, pt,
                                      i32([5, 1000]), scale=0.125)))
        # 1024 keys a slot: the bf16 chunk kernels split the key range
        kc, vc = arr((2, 1024, 2, 64), dt), arr((2, 1024, 2, 64), dt)
        out.append((f"decode/chunk_prefill {tag}", functools.partial(
            cp.chunk_prefill, arr((1, 8, 4, 64), dt), kc, vc, 1000,
            scale=0.125, slot=1)))
        out.append((f"decode/paged_chunk_prefill {tag}", functools.partial(
            cp.paged_chunk_prefill, arr((1, 8, 4, 64), dt), kp, vp, pt, 1000,
            scale=0.125, slot=1)))
        out.append((f"decode/paged_chunk_prefill_int8 {tag}",
                    functools.partial(cp.paged_chunk_prefill_int8,
                                      arr((1, 8, 4, 64), dt), i8(kp.shape),
                                      i8(vp.shape), ks, vs, pt, 1000,
                                      scale=0.125, slot=1)))
        # 4 query heads over 2 kv heads; 1024 keys split the bf16 forward
        q, kk, vv = arr((4, 64, 64), dt), arr((2, 1024, 64), dt), \
            arr((2, 1024, 64), dt)
        out.append((f"attention/mha_forward {tag}", functools.partial(
            mha.mha_forward, q, kk, vv, causal=True, q_offset=960)))
        q, kk, vv, do = (arr((4, 128, 64), dt), arr((2, 128, 64), dt),
                         arr((2, 128, 64), dt), arr((4, 128, 64), dt))
        lse, delta = arr((4, 128)), arr((4, 128))
        out.append((f"attention/mha_bwd_dq {tag}", functools.partial(
            mha.mha_bwd_dq, q, kk, vv, do, lse, delta)))
        out.append((f"attention/mha_bwd_dkv {tag}", functools.partial(
            mha.mha_bwd_dkv, q, kk, vv, do, lse, delta)))
        out.append((f"scan/rglru_scan {tag}", functools.partial(
            ls.rglru_scan, arr((2, 8, 80), dt, 0.5), arr((2, 8, 80), dt))))
        out.append((f"scan/wkv6_scan {tag}", functools.partial(
            ls.wkv6_scan, arr((2, 8, 8), dt), arr((2, 8, 8), dt),
            arr((2, 8, 8), dt), -arr((2, 8, 8), dt).abs(), arr((2, 8)),
            arr((2, 8, 8)), chunk=4)))
    # the latent decode takes bf16 at 64 heads of 576 / 512 only: two rows
    # over 300 latent rows, split into ranges of 64
    out.append(("decode/mla_decode bf16", functools.partial(
        mla.mla_decode, arr((2, 64, 576), torch.bfloat16, 0.05),
        arr((2, 300, 576), torch.bfloat16), i32([5, 300]), scale=0.07,
        dv=512)))
    return out


def run_kernel_check(device: str) -> int:
    """Launch each kernel family once, tiny, with checking on."""
    import torch

    from repro_torch.analysis import kernel_check

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        print(f"kernel-check: FAIL no CUDA device (--device {device}, "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}): "
              f"the hand-written kernels launch only on a card; pass "
              f"--no-kernel-check to skip this pass")
        return 1
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = 0
    with kernel_check.checking(True), kernel_check.collecting() as seen:
        for label, launch in kernel_launches(torch, dev, gen):
            n0 = len(seen)
            try:
                launch()
                torch.cuda.synchronize(dev)
                names = ", ".join(x.name for _, x in seen[n0:])
                print(f"kernel-check: ok {label} ({names})")
            except kernel_check.KernelContractError as e:
                print(f"kernel-check: FAIL {label}: {e}")
                failures += 1
    print(f"kernel-check: {len(seen)} launch(es) checked, {failures} "
          f"failure(s)")
    return 1 if failures else 0


def run_retrace(device: str) -> int:
    import contextlib

    import numpy as np
    import torch

    from repro_torch.analysis.retrace_guard import RetraceError, retrace_guard
    from repro_torch.configs.base import get_config, shrink
    from repro_torch.core.famous import FamousConfig
    from repro_torch.models import module, transformer
    from repro_torch.serve import graphs
    from repro_torch.serve.engine import (Request, ServingEngine,
                                          resolve_device)

    dev = resolve_device(device)
    cfg = shrink(get_config("qwen2-7b"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = module.init_params(transformer.model_spec(cfg), gen,
                                torch.float32, dev)
    rng = np.random.default_rng(0)
    world = int(os.environ.get("WORLD_SIZE", "1"))

    def reqs(rid0):
        return [Request(rid=rid0 + i, max_new=3,
                        tokens=list(rng.integers(0, cfg.vocab_size, 5 + i)))
                for i in range(3)]

    def guarded(label, **kw):
        engine = ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                               n_slots=2, max_seq=32, chunk=8,
                               dtype=torch.float32, device=dev, **kw)
        mesh = kw.get("mesh")
        eager = (mesh is not None and dev.type == "cuda"
                 and torch.distributed.get_backend() != "nccl")
        with graphs.disable_capture() if eager else contextlib.nullcontext():
            # the first call of each executable runs eagerly, the second
            # captures: two warm batches take every executable through
            engine.run(reqs(0))
            engine.run(reqs(10))
            try:
                with retrace_guard(engine, label=f"warm {label} loop"):
                    engine.run(reqs(20))
            except RetraceError as e:
                print(f"retrace: FAIL {e}")
                return 1
        print(f"retrace: ok: warm {label} engine served a fresh batch with "
              f"zero new captures (census {engine.compilations})")
        return 0

    status = guarded("plain")
    status |= guarded("speculative", speculative=True, draft_k=3)
    status |= guarded("int8 paged", cache_kind="paged", page_size=8,
                      kv_dtype="int8")
    if world >= 2:
        from repro_torch.launch.mesh import make_serving_mesh
        status |= guarded("TP=2 sharded",
                          mesh=make_serving_mesh(tp=2, device_type=dev.type))
    else:
        print("retrace: note: TP=2 sharded pass skipped (1 rank; run under "
              "torchrun --nproc-per-node 2 for it)")
    if dev.type != "cuda":
        print(f"retrace: note: on {dev} nothing is captured, so the census "
              f"cannot grow: this pass shows only that the engines run")
    return status


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro_torch static-analysis passes (lint, kernel "
                    "launch-contract check, retrace guard)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the lint baseline instead of failing on "
                         "new findings")
    ap.add_argument("--no-lint", action="store_true")
    ap.add_argument("--no-kernel-check", action="store_true")
    ap.add_argument("--no-retrace", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the kernel check needs "
                         "cuda")
    args = ap.parse_args(argv)

    status = 0
    if not args.no_lint:
        print("== repro_torch.analysis: lint ==")
        status |= run_lint(args.update_baseline)
    if not args.no_kernel_check:
        print("== repro_torch.analysis: kernel contract check ==")
        status |= run_kernel_check(args.device)
    if not args.no_retrace:
        print("== repro_torch.analysis: retrace guard ==")
        status |= run_retrace(args.device)
    print("repro_torch.analysis: " + ("FAILED" if status else "clean"))
    return status


if __name__ == "__main__":
    sys.exit(main())
