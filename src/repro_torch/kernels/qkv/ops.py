"""Fused Q/K/V projection through the tiled matmul kernels, fp or int8.

[Wq|Wk|Wv] arrives fused as one (D, F) matrix — fused once at load time
(``repro_torch.models.attention.fuse_qkv``), where the JAX wrapper
re-concatenates it on every call — so the X tile is read once and feeds all
three projections: the QKV_PM shared-X-BRAM trick.

``quant="int8"`` is the paper's 8-bit fixed point (JAX ``ops.py`` int8
branch): X quantized per token, the fused W per column, the int8 kernel's
f32 output cast to ``x.dtype``, the bias added after that cast.  The model
quantizes W once at load (``w_int8``: int8 (F, D), the kernel's transposed
layout, and its (1, F) f32 scale); without it W is quantized here, from
its own dtype, as JAX does on every call.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant as quant_lib
from repro_torch.kernels.qkv import qkv_proj


def quantize_weight(w_qkv: torch.Tensor):
    """(int8 (F, D) transposed W, f32 (1, F) per-column scale) of a fused
    (D, F) W, quantized in its own dtype."""
    wq, sw = quant_lib.quantize(w_qkv, axis=0)
    return wq.t().contiguous(), sw


def qkv_projection(x: torch.Tensor, w_qkv: torch.Tensor, shapes,
                   bq=None, bk=None, bv=None, *, quant: str = "none",
                   w_int8=None):
    """x: (B, S, D); w_qkv: (D, F) with F = H*dh + 2*KV*dh; shapes: the
    ((H, dh), (KV, dh), (KV, dh)) head shapes.  Returns (q, k, v), each
    (B, S, heads, dh) in ``x.dtype``.  The bias is added after the cast,
    in ``x.dtype``, as in the JAX wrapper."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    if quant == "int8":
        xq, sx = quant_lib.quantize(xt, axis=1)
        wqt, sw = w_int8 if w_int8 is not None else quantize_weight(w_qkv)
        out = qkv_proj.matmul_tiled_int8(xq, wqt, sx, sw).to(x.dtype)
    else:
        out = qkv_proj.matmul_tiled(xt, w_qkv)
    nq = shapes[0][0] * shapes[0][1]
    nk = shapes[1][0] * shapes[1][1]
    q = out[:, :nq].reshape(B, S, *shapes[0])
    k = out[:, nq:nq + nk].reshape(B, S, *shapes[1])
    v = out[:, nq + nk:].reshape(B, S, *shapes[2])
    if bq is not None:
        q = q + bq.to(q.dtype)
        k = k + bk.to(k.dtype)
        v = v + bv.to(v.dtype)
    return q, k, v
