"""Plain PyTorch versions of the tiled QKV-projection kernels (Algorithm 1),
fp and int8.

The kernel wrappers (:mod:`repro_torch.kernels.qkv.qkv_proj`) run them for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernels against them on
the card.  The serving path never calls them on CUDA tensors
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


def matmul_int8_reference(xq: torch.Tensor, wq: torch.Tensor,
                          sx: torch.Tensor, sw: torch.Tensor,
                          out_dtype=torch.float32) -> torch.Tensor:
    """xq: (T, D) int8 @ wq: (D, F) int8, exact integer sums, dequantized
    as ``acc.f32 * sx * sw`` with sx: (T, 1) and sw: (1, F) f32 (JAX's
    ``matmul_int8_reference``).  The sums run in f64, exact for integers
    below 2^53, since torch has no integer matmul on CUDA."""
    if xq.is_cuda:
        STATS.plain_on_cuda["matmul_tiled_int8"] += 1
    acc = xq.to(torch.float64) @ wq.to(torch.float64)
    return (acc.to(torch.float32) * sx * sw).to(out_dtype)
