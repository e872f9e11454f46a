"""Symmetric int8 quantization (the port of ``repro.core.quant``).

The int8 KV pools store each (token, kv head) row of K and V as int8 with
one f32 scale; writes quantize, the paged attention kernels dequantize in
their tiles.  ``quantize`` is bit-identical to the JAX function: the input
is upcast to f32 first, the scale is ``max(amax, 1e-8) / 127`` as an f32
division, and the quotient is rounded half to even (``torch.round``, as
``jnp.round``) before the clip to ±127.  ``int8_einsum`` comes with the
int8 projection kernel (ROADMAP Queue 2: ``matmul_tiled_int8``).
"""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``axis``.  Returns (q int8,
    scale f32) with x ≈ q * scale; scale keeps a size-1 ``axis``."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
