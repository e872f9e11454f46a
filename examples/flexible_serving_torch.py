"""Runtime programmability demo — the paper's §IV-C on a GPU (the PyTorch
twin of ``examples/flexible_serving.py``).

FAMOUS synthesises once and then reconfigures (heads, d_model, SL) from
software with zero re-synthesis (Table I tests #1–#8: one bitstream, eight
topologies).  Here: ONE captured CUDA graph serves eight attention
topologies; a shape-bucketed cache shows the complementary trade-off.

    PYTHONPATH=src python examples/flexible_serving_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core import famous
from repro_torch.core.flexible import BucketCache, FlexibleAttention

MAXIMA = dict(max_heads=8, max_seq=128, max_head_dim=96)
# Table I runtime sweep: vary h (tests 1-3), d_head (4-5), SL (6-8)
TOPOLOGIES = [(8, 64, 96), (4, 64, 96), (2, 64, 96),
              (8, 64, 64), (8, 64, 32),
              (8, 128, 96), (8, 32, 96), (8, 16, 96)]
BUCKET_SEQS = (10, 17, 33, 60, 100, 120)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    args = ap.parse_args(argv)

    print(f"'synthesis-time' maxima: {MAXIMA}")
    fa = FlexibleAttention(**MAXIMA, causal=True, device=args.device)
    dev = fa.device
    for H, SL, dh in TOPOLOGIES:
        gen = torch.Generator(device=dev).manual_seed(H * SL + dh)
        q, k, v = (torch.randn((2, SL, H, dh), generator=gen, device=dev)
                   * 0.5 for _ in range(3))
        t0 = time.perf_counter()
        out = fa(q, k, v)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) * 1e3
        ref = famous.attention_reference(q, k, v, causal=True)
        err = float((out - ref).abs().max())
        print(f"  topology (h={H}, SL={SL:3d}, dh={dh:2d}): {dt:7.1f} ms  "
              f"err vs dedicated program: {err:.1e}")
    print(f"padded programs built: {fa.compilations} "
          "(one — every topology reused it)")

    print("\nbucketed alternative (one executable per pow-2 bucket, no "
          "padding waste):")
    cache = BucketCache(lambda x, bucket: torch.tanh(x))
    for n in BUCKET_SEQS:
        fn, b = cache.get(n)
        print(f"  seq {n:3d} -> bucket {b:3d}")
    print(f"bucket executables: {len(cache)}  (hits={cache.hits})")


if __name__ == "__main__":
    main()
