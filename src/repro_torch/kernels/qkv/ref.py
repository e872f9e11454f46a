"""Plain PyTorch version of the tiled QKV-projection kernel (Algorithm 1).

The kernel wrapper (:func:`repro_torch.kernels.qkv.qkv_proj.matmul_tiled`)
runs it for tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernel
against it on the card.  The serving path never calls it on CUDA tensors
(``lib.STATS.plain_on_cuda`` counts any such call)."""
from __future__ import annotations

import torch

from repro_torch.kernels.lib import STATS


def matmul_reference(x: torch.Tensor, w: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """x: (T, D) @ w: (D, F) -> (T, F): f32 products and sums, one cast."""
    if x.is_cuda:
        STATS.plain_on_cuda["matmul_tiled"] += 1
    return (x.to(torch.float32) @ w.to(torch.float32)).to(out_dtype or x.dtype)
