"""Symmetric int8 quantization (the port of ``repro.core.quant``).

The int8 KV pools store each (token, kv head) row of K and V as int8 with
one f32 scale; writes quantize, the paged attention kernels dequantize in
their tiles.  ``quantize`` is bit-identical to the JAX function: the input
is upcast to f32 first, the scale is ``max(amax, 1e-8) / 127`` as an f32
division, and the quotient is rounded half to even (``torch.round``, as
``jnp.round``) before the clip to ±127.

``int8_einsum`` is the ``quant="int8"`` projection of the xla impl (the
paper's 8-bit fixed point): both operands quantized over the contraction
dim, multiplied as exact int32 products, and dequantized as
``acc.f32 * x_scale * w_scale`` in that order, as in JAX, so it is
bit-identical to the JAX function at f32.
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


def int8_einsum(spec: str, x: torch.Tensor, w: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """einsum with both operands quantized to int8 over their contraction
    dim, which must be the last dim of ``x`` and the first of ``w``.

    The int8 x int8 products accumulate exactly, as JAX's int32 dot does:
    torch has no integer matmul on CUDA, so the sum runs in f64, where
    every partial sum of int8 products is an exact integer (far below
    2^53).  The accumulator is dequantized in
    f32 by the per-token scale of ``x`` and the per-column scale of ``w``,
    and only the final cast narrows, to ``out_dtype`` or ``x.dtype``."""
    lhs, rest = spec.split(",")
    rhs, out = rest.split("->")
    c = lhs[-1]
    if rhs[0] != c or c in out:
        raise ValueError(f"unsupported int8 einsum {spec}")
    xq, xs = quantize(x, axis=-1)              # xs: x.shape[:-1] + (1,)
    wq, ws = quantize(w, axis=0)               # ws: (1,) + w.shape[1:]
    acc = torch.einsum(spec, xq.to(torch.float64), wq.to(torch.float64))
    x_bcast = xs.reshape(xs.shape[:-1] + (1,) * (w.ndim - 1))
    w_bcast = ws.reshape((1,) * (x.ndim - 1) + w.shape[1:])
    out_f = acc.to(torch.float32) * x_bcast * w_bcast
    return out_f.to(x.dtype if out_dtype is None else out_dtype)
