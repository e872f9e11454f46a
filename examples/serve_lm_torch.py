"""Serving example (the PyTorch twin of ``examples/serve_lm.py``): batched
requests through the Scheduler / Runtime engine (token-budgeted chunked
prefill interleaved with batched decode) on a reduced qwen2-style model,
once monolithic, once chunked, once chunked + paged, and once with the
prefix cache (cold, then warm), checking that the generated tokens are
identical every way; then int8 KV pools against fp ones.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.models import module, transformer
from repro_torch.obs.trace import now
from repro_torch.serve.engine import Request, ServingEngine, resolve_device


def serve(params, cfg, reqs, label, device, engine=None, **kw):
    engine = engine or ServingEngine(params, cfg, FamousConfig(impl="xla"),
                                     n_slots=4, max_seq=256, device=device,
                                     **kw)
    t0 = now()
    done = sorted(engine.run(reqs), key=lambda r: r.rid)
    dt = now() - t0
    tok = sum(len(r.out) for r in done)
    print(f"{label:22s}: {len(done)} requests, {tok} new tokens, "
          f"{dt:.2f}s ({tok/dt:.1f} tok/s on {device.type}), "
          f"prefill graphs: {engine.prefill_compilations}")
    return done, engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = shrink(get_config("qwen2-7b"))
    params = module.init_params(transformer.model_spec(cfg),
                                torch.Generator(device=device).manual_seed(0),
                                torch.float32, device)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size,
                                 size=int(rng.integers(4, 180))))
               for _ in range(12)]

    def reqs():
        return [Request(rid=i, tokens=[int(t) for t in p], max_new=16)
                for i, p in enumerate(prompts)]

    run = lambda label, **kw: serve(params, cfg, reqs(), label, device, **kw)
    mono, _ = run("monolithic", prefill_mode="monolithic")
    chunked, _ = run("chunked")
    paged, _ = run("chunked + paged", cache_kind="paged", page_size=16)
    # prefix cache: the first pass publishes every prompt's full blocks on
    # retirement; the second pass (same prompts, same engine) aliases them
    # and skips the cached prefill outright, still token-identical
    cold, eng = run("prefix cache (cold)", cache_kind="paged", page_size=16,
                    prefix_cache=True)
    warm, _ = run("prefix cache (warm)", engine=eng)
    assert [r.out for r in mono] == [r.out for r in chunked], \
        "chunked prefill must be token-identical"
    assert [r.out for r in mono] == [r.out for r in paged], \
        "paged cache must be token-identical"
    assert [r.out for r in mono] == [r.out for r in cold] \
        == [r.out for r in warm], "prefix cache must be token-identical"
    assert eng.prefix_hit_pages > 0, "warm pass must alias cached pages"
    print("monolithic == chunked == chunked+paged == prefix-cached "
          "(cold & warm), token for token")
    print(f"  warm pass reused {eng.prefix_hit_pages} pages / "
          f"{eng.prefix_hit_tokens} prompt tokens from the prefix cache")
    for r in mono[:4]:
        print(f"  req {r.rid:2d} | prompt len {len(r.tokens):3d} -> {r.out}")

    # int8 KV pools: the same pool geometry at ~3.2x the live tokens a
    # byte.  Quantization is lossy, so on this random-init model (near-tie
    # logit margins) greedy tokens may flip at a few positions: assert the
    # memory saved and that no request failed, and report the agreement.
    q8, qeng = run("chunked + paged int8", cache_kind="paged", page_size=16,
                   kv_dtype="int8")
    assert all(r.error is None for r in q8)

    def bytes_of(e):
        return sum(b.numel() * b.element_size() for c in e.caches
                   for b in c.values())

    _, fpeng = run("chunked + paged fp", cache_kind="paged", page_size=16)
    ratio = bytes_of(qeng) / bytes_of(fpeng)
    assert ratio <= 0.55, f"int8 cache bytes ratio {ratio:.3f} not halved"
    agree = np.mean([a == b for rf, rq in zip(mono, q8)
                     for a, b in zip(rf.out, rq.out)])
    print(f"int8 KV cache: {ratio:.2f}x the fp cache bytes, "
          f"{agree:.0%} token agreement with fp greedy on random-init "
          f"weights")


if __name__ == "__main__":
    main()
