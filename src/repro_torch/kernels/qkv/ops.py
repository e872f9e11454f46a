"""Fused Q/K/V projection through the tiled matmul kernel.

[Wq|Wk|Wv] arrives fused as one (D, F) matrix — fused once at load time
(``repro_torch.models.attention.fuse_qkv``), where the JAX wrapper
re-concatenates it on every call — so the X tile is read once and feeds all
three projections: the QKV_PM shared-X-BRAM trick.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.qkv import qkv_proj


def qkv_projection(x: torch.Tensor, w_qkv: torch.Tensor, shapes,
                   bq=None, bk=None, bv=None):
    """x: (B, S, D); w_qkv: (D, F) with F = H*dh + 2*KV*dh; shapes: the
    ((H, dh), (KV, dh), (KV, dh)) head shapes.  Returns (q, k, v), each
    (B, S, heads, dh) in ``x.dtype``.  The bias is added after the cast,
    in ``x.dtype``, as in the JAX wrapper."""
    B, S, D = x.shape
    out = qkv_proj.matmul_tiled(x.reshape(B * S, D), w_qkv)
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
