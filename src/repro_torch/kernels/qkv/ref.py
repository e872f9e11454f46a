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


def qkv_reference(x, wq, wk, wv, bq=None, bk=None, bv=None):
    """x: (B, S, D); w*: (D, H, dh) -> q, k, v (B, S, H, dh): each an f32
    product against its unfused weight, plus its f32 bias, cast back to
    ``x``'s dtype (JAX's ``qkv_reference``)."""
    def one(w, b):
        y = torch.einsum("bsd,dhe->bshe", x.to(torch.float32),
                         w.to(torch.float32))
        if b is not None:
            y = y + b.to(torch.float32)
        return y.to(x.dtype)

    return one(wq, bq), one(wk, bk), one(wv, bv)


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


def matmul_int8_split_reference(xq: torch.Tensor, wq: torch.Tensor,
                                sx: torch.Tensor, sw: torch.Tensor, *,
                                splits: int, block_k: int = 128,
                                out_dtype=torch.float32) -> torch.Tensor:
    """The split-K int8 kernel's algebra (``matmul_tiled_int8.cu`` at T <=
    32): D cut into steps of ``block_k``, split z owning steps [z * kps,
    (z + 1) * kps) with kps = ceil(steps / splits); each split's exact
    int32 partial, the partials added in split order, then the flush's
    ``acc.f32 * sx * sw``.  For tests and ``chip_smoke.py`` only."""
    if xq.is_cuda:
        STATS.plain_on_cuda["matmul_tiled_int8"] += 1
    D = xq.shape[1]
    steps = -(-D // block_k)
    kps = -(-steps // splits) * block_k     # D values a split
    acc = torch.zeros((xq.shape[0], wq.shape[1]), dtype=torch.int64,
                      device=xq.device)
    for d0 in range(0, D, kps):
        part = (xq[:, d0:d0 + kps].to(torch.float64)
                @ wq[d0:d0 + kps].to(torch.float64))
        acc = acc + part.to(torch.int64)
    return (acc.to(torch.float32) * sx * sw).to(out_dtype)
