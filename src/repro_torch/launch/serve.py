"""Serving launcher: ``python -m repro_torch.launch.serve --arch qwen2-7b``
(or any registered decoder: recurrentgemma-2b, rwkv6-1.6b, qwen3-32b,
deepseek-7b, command-r-plus-104b, the MoE grok-1-314b and kimi-k2-1t-a32b,
and llava-next-34b's backbone, which is served tokens as JAX's engine
serves it).  Encoder-only configs (famous-bert, hubert-xlarge) have no
decode and exit, as JAX's launcher does.

``--prefill-mode monolithic`` prefills each prompt whole at admission
(JAX's comparison path); an RWKV-6 stack then takes prompts whose
prefilled length is at most 64 or a multiple of 64, so the synthetic
prompts are cut to that rule.

Drives the Scheduler/Runtime continuous-batching engine over a synthetic
request stream on the GPU, at the config's full width and depth with random
bf16 weights made on the card from ``--seed`` (``--smoke`` shrinks the
config).  ``--device cpu`` runs the kernels' plain PyTorch versions on
the CPU.

``--tp N`` (or ``--mesh-shape D,T``) serves tensor-parallel, one process
a rank: ``torchrun --nproc-per-node N -m repro_torch.launch.serve --tp
N`` (an MoE config splits its experts over the ranks, rwkv6-1.6b its
heads); ``--mesh-shape D,T`` with D > 1 adds D replica groups of T
ranks, each computing its own slots (SERVE_TP_RULES, as JAX's launcher;
other rule sets through ``ServingEngine(sharding_rules=)``).  Every rank draws the same weights from ``--seed`` and keeps its
shard; rank 0 prints the mesh, its cache bytes and the run.  ``--tp 1``
(the default) runs without a mesh.  NCCL serves where every rank has a
card of its own, with CUDA graphs; ranks that share one card run over
gloo, eagerly (``graphs.disable_capture()``).
"""
from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from repro_torch.configs.base import (RWKV6, RunConfig, get_config,
                                      list_configs, shrink)
from repro_torch.core.famous import FamousConfig
from repro_torch.models import module, transformer
from repro_torch.obs.runtime import Observer
from repro_torch.obs.trace import now
from repro_torch.serve import graphs
from repro_torch.serve.engine import Request, ServingEngine, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=list_configs(),
                    help="a registered decoder config: the dense "
                         "qwen2-7b, the hybrid recurrentgemma-2b (RG-LRU + "
                         "sliding-window attention), the attention-free "
                         "rwkv6-1.6b, the MoE grok-1-314b, ...; "
                         "encoder-only configs exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the config to the CPU-test size")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-mode", choices=("chunked", "monolithic"),
                    default="chunked",
                    help="chunked: fixed-shape prefill chunks interleaved "
                         "with decode under the token budget; monolithic: "
                         "whole-prompt prefill at admission (comparison "
                         "path)")
    ap.add_argument("--chunk", type=int, default=256,
                    help="prefill chunk length (must divide max-seq)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="per-step token budget; 0 = slots + chunk")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for every request (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k filter (0 = full vocab)")
    ap.add_argument("--cache-kind", choices=("contiguous", "paged"),
                    default="contiguous",
                    help="KV-cache layout: per-slot max_seq stripes, or a "
                         "shared page pool with per-slot page tables")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged mode)")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="pool pages incl. the null page (paged mode); 0 = "
                         "full contiguous-equivalent capacity, less "
                         "oversubscribes")
    ap.add_argument("--kv-dtype", choices=("fp", "int8"), default="fp",
                    help="KV-cache element type (paged only): int8 stores "
                         "quantized pages plus per-token-per-kv-head f32 "
                         "scale pools, dequantized inside the attention "
                         "kernels")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share identical full prompt blocks across "
                         "requests through refcounted pages (paged only)")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-model-free speculative decoding: a host-side "
                         "prompt-lookup drafter proposes tokens, one batched "
                         "verify step accepts the longest matching prefix "
                         "(token-identical to plain decode)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="max draft tokens per verify step (the verify "
                         "step's width is draft-k + 1)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism: shard attention heads / kv "
                         "heads / RWKV-6 heads / FFN and LRU hidden / MoE "
                         "experts over a 'model' mesh axis of this size, "
                         "one process a rank (torchrun --nproc-per-node "
                         "N). 1 = unsharded baseline")
    ap.add_argument("--mesh-shape", default="",
                    help="explicit 'data,model' mesh shape, e.g. '2,2' "
                         "(overrides --tp; data > 1 makes replica groups: "
                         "the slots' caches cut over them, each group "
                         "computing its own slots)")
    ap.add_argument("--metrics", action="store_true",
                    help="attach an Observer and print the Prometheus text "
                         "exposition after the run")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="also write the exposition to PATH (implies "
                         "--metrics)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write Chrome/Perfetto trace_event JSON to PATH")
    args = ap.parse_args(argv)
    args.metrics = args.metrics or bool(args.metrics_out)

    if args.mesh_shape:
        dp, tp = (int(x) for x in args.mesh_shape.split(","))
    else:
        dp, tp = 1, args.tp
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = shrink(cfg)
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    device = resolve_device(args.device)
    mesh = RunConfig(arch=args.arch, tp=tp, dp=dp).make_mesh(device.type)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    dtype = torch.bfloat16
    obs = (Observer(trace=bool(args.trace_out))
           if args.metrics or args.trace_out else None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = module.init_params(transformer.model_spec(cfg), gen, dtype,
                                device)
    engine = ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                           n_slots=args.slots, max_seq=args.max_seq,
                           dtype=dtype, prefill_mode=args.prefill_mode,
                           chunk=args.chunk,
                           token_budget=args.token_budget,
                           cache_kind=args.cache_kind,
                           page_size=args.page_size,
                           n_pages=args.n_pages or None,
                           kv_dtype=args.kv_dtype,
                           prefix_cache=args.prefix_cache,
                           speculative=args.speculative,
                           draft_k=args.draft_k, observer=obs,
                           mesh=mesh, device=device)
    del params
    if rank0 and mesh is not None:
        print(f"mesh {mesh}: {torch.distributed.get_world_size()} ranks "
              f"over {torch.distributed.get_backend()}; this rank's KV "
              f"cache {engine.cache_bytes_per_device()} bytes")
    rng = np.random.default_rng(args.seed)
    # prompt lengths from max_seq / 32 to three quarters of max_seq
    # (64..1536 at the default 2048), leaving room for max_new tokens
    hi = max(1, min(args.max_seq * 3 // 4, args.max_seq - args.max_new))
    lo = max(1, min(args.max_seq // 32, hi))
    lens = [int(rng.integers(lo, hi + 1)) for _ in range(args.requests)]
    if (args.prefill_mode == "monolithic"
            and RWKV6 in transformer.layer_kinds(cfg)):
        lens = [n if n <= 65 else (n - 1) // 64 * 64 + 1 for n in lens]
    reqs = [Request(rid=i,
                    tokens=list(rng.integers(0, cfg.vocab_size, size=n)),
                    max_new=args.max_new, temperature=args.temperature,
                    top_k=args.top_k, seed=args.seed + i)
            for i, n in enumerate(lens)]
    eager = (mesh is not None and device.type == "cuda"
             and torch.distributed.get_backend() != "nccl")
    t0 = now()
    with graphs.disable_capture() if eager else contextlib.nullcontext():
        done = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = now() - t0
    if not rank0:
        return done
    tok = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s) on {device}; kernel launches "
          f"{engine.kernel_launches}; KV cache "
          f"{engine.cache_bytes_per_device()} bytes ({args.cache_kind}, "
          f"{args.kv_dtype}), prefix hit pages {engine.prefix_hit_pages}")
    if args.speculative:
        print(f"speculative: draft_k={args.draft_k}, "
              f"{engine.spec_accepted}/{engine.spec_drafted} drafts accepted "
              f"(rate {engine.acceptance_rate:.2f}, "
              f"{engine.accepted_per_step:.2f} tokens/step over "
              f"{engine.spec_steps} steps)")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        ttft = (r.t_first - r.t_submit) * 1e3 if r.t_first else float("nan")
        print(f"  req {r.rid}: prompt {len(r.tokens)} tokens -> "
              f"out[:8]={r.out[:8]} (ttft={ttft:.0f}ms, error={r.error})")
    if obs is not None:
        if args.trace_out:
            obs.write_trace(args.trace_out)
            print(f"trace: {len(obs.tracer.events)} events -> "
                  f"{args.trace_out}")
        text = obs.prometheus_text()
        if args.metrics_out:
            with open(args.metrics_out, "w", encoding="utf-8") as fh:
                fh.write(text)
            print(f"metrics: exposition -> {args.metrics_out}")
        if args.metrics:
            print(text, end="")
    return done


if __name__ == "__main__":
    main()
