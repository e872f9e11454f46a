"""Quickstart: the FAMOUS attention core on a GPU (the PyTorch twin of
``examples/quickstart.py``).

Runs the paper-faithful reference, the torch-ops path and the hand-written
CUDA kernels on the paper's topology, checks they agree, and shows the
§VII analytical model and tile autotuner for an H100.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

On the CPU (``--device cpu``) the kernel path runs the kernels' plain
PyTorch versions.
"""
import argparse

import torch

from repro_torch.core import analytical, famous
from repro_torch.serve.engine import resolve_device

# the paper's Table I test #1 topology: SL=64, d_model=768, h=8
B, SL, D, H = 1, 64, 768, 8
dh = D // H


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, SL, D), generator=gen, device=dev)
    wq, wk, wv = (torch.randn((D, H, dh), generator=gen, device=dev) * 0.05
                  for _ in range(3))

    outs = {}
    for impl in ("reference", "xla", "pallas"):
        cfg = famous.FamousConfig(impl=impl, tile_d=64, tile_q=64, tile_k=64)
        q, k, v = famous.qkv_projection(x, wq, wk, wv, cfg=cfg)
        outs[impl] = famous.attention(q, k, v, causal=False, cfg=cfg)
        print(f"{impl:10s} -> attention out {tuple(outs[impl].shape)}, "
              f"mean={float(outs[impl].mean()):+.6f}")

    err = float((outs["pallas"] - outs["reference"]).abs().max())
    print(f"max |pallas - reference| = {err:.2e} on {dev}")
    if not err < 1e-4:
        raise SystemExit(f"the kernel path disagrees with the reference: "
                         f"{err:.2e}")

    hw = analytical.H100
    print(f"\nAnalytical model (paper §VII, on {hw.name}):")
    lat = analytical.mha_latency(batch=B, seq=SL, heads=H, kv_heads=H,
                                 head_dim=dh, d_model=D, tile_q=64,
                                 tile_k=64, tile_d=64, hw=hw)
    print(lat.table())
    print(f"\npredicted GOPS (dense, bf16): {lat.gops():.0f}")

    print("\nTile autotune (replaces the paper's 36 h trial synthesis):")
    tuned = analytical.autotune_tiles(batch=8, seq=2048, heads=H, kv_heads=H,
                                      head_dim=dh, d_model=D, hw=hw)
    print(f"  best tiles: {tuned['tiles']}  "
          f"predicted total: {tuned['latency'].total * 1e6:.1f} us")
    return err


if __name__ == "__main__":
    main()
