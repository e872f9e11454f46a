"""Serving launcher: ``python -m repro_torch.launch.serve --arch qwen2-7b``.

Drives the Scheduler/Runtime continuous-batching engine over a synthetic
request stream on the GPU, at the config's full width and depth with random
bf16 weights made on the card from ``--seed`` (``--smoke`` shrinks the
config).  ``--device cpu`` runs the kernels' plain PyTorch versions on
the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.models import module, transformer
from repro_torch.obs.runtime import Observer
from repro_torch.obs.trace import now
from repro_torch.serve.engine import Request, ServingEngine, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the config to the CPU-test size")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=256,
                    help="prefill chunk length (must divide max-seq)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="per-step token budget; 0 = slots + chunk")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for every request (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k filter (0 = full vocab)")
    ap.add_argument("--metrics", action="store_true",
                    help="attach an Observer and print the Prometheus text "
                         "exposition after the run")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write Chrome/Perfetto trace_event JSON to PATH")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = shrink(cfg)
    dtype = torch.bfloat16
    obs = (Observer(trace=bool(args.trace_out))
           if args.metrics or args.trace_out else None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = transformer.prepare_params(
        module.init_params(transformer.model_spec(cfg), gen, dtype, device),
        cfg)
    engine = ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                           n_slots=args.slots, max_seq=args.max_seq,
                           dtype=dtype, chunk=args.chunk,
                           token_budget=args.token_budget, observer=obs,
                           device=device)
    rng = np.random.default_rng(args.seed)
    # prompt lengths from max_seq / 32 to three quarters of max_seq
    # (64..1536 at the default 2048), leaving room for max_new tokens
    hi = max(1, min(args.max_seq * 3 // 4, args.max_seq - args.max_new))
    lo = max(1, min(args.max_seq // 32, hi))
    reqs = [Request(rid=i,
                    tokens=list(rng.integers(0, cfg.vocab_size,
                                             size=int(rng.integers(lo, hi + 1)))),
                    max_new=args.max_new, temperature=args.temperature,
                    top_k=args.top_k, seed=args.seed + i)
            for i in range(args.requests)]
    t0 = now()
    done = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = now() - t0
    tok = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s) on {device}; kernel launches "
          f"{engine.kernel_launches}")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        ttft = (r.t_first - r.t_submit) * 1e3 if r.t_first else float("nan")
        print(f"  req {r.rid}: prompt {len(r.tokens)} tokens -> "
              f"out[:8]={r.out[:8]} (ttft={ttft:.0f}ms, error={r.error})")
    if obs is not None:
        if args.trace_out:
            obs.write_trace(args.trace_out)
            print(f"trace: {len(obs.tracer.events)} events -> "
                  f"{args.trace_out}")
        if args.metrics:
            print(obs.prometheus_text(), end="")
    return done


if __name__ == "__main__":
    main()
