"""Public wrapper of the fused MHA kernels, on the model's (B, S, H, dh)
layout.

The kernels take the flat ``(B·H, S, dh)`` layout; ``mha`` transposes in
and out, as the JAX wrapper does.  Backward: a flash autograd function
whose forward saves ``(q, k, v, out, lse)`` and whose backward runs the dq
and dk/dv kernels (blockwise recompute from the LSE), so
``impl="pallas"`` trains through the kernels with no fallback.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.attention import mha as mha_kernel


def _to_flat(x):  # (B, S, H, dh) -> (B*H, S, dh), contiguous
    B, S, H, dh = x.shape
    # reshape alone returns a strided view when B == 1
    return x.transpose(1, 2).reshape(B * H, S, dh).contiguous()


def _from_flat(x, B, H):  # (B*H, S, dh) -> (B, S, H, dh)
    _, S, dh = x.shape
    return x.reshape(B, H, S, dh).transpose(1, 2)


class _FlashMHA(torch.autograd.Function):
    """Flash attention over the flat layout: forward and backward are the
    kernels of :mod:`repro_torch.kernels.attention.mha`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        out, lse = mha_kernel.mha_forward(
            q, k, v, causal=causal, window=window, scale=scale,
            q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, scale=scale,
                        q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = mha_kernel.mha_backward(q, k, v, out, lse,
                                             dout.contiguous(), **ctx.args)
        # cast to the inputs' dtypes, as the JAX custom VJP does
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def mha(q, k, v, *, causal=True, window=0, scale=None, q_offset=0,
        block_q=512, block_k=512):
    """q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh).  Returns (B, Sq, H, dh).

    Differentiable through the flash backward kernels, the GQA group sum
    of dk/dv taken inside the dk/dv kernel.  ``block_q``/``block_k`` are
    the Pallas tile sizes and are ignored: the CUDA kernels take their
    tiles and split counts from static shapes and the SM count, and mask
    ragged edges.  In bf16, on tensor cores, the forward runs 128-row
    query blocks over 64-key tiles (64-row blocks above dh 128), dq 64-row
    blocks over 64-key tiles (32-key above dh 128) and dk/dv 64-key blocks
    over 64-row query tiles (above dh 128, up to recurrentgemma-2b's 256,
    two warps share each 16-row or 16-key strip); in f32 all three kernels
    run 32 x 32 tiles on the CUDA cores."""
    del block_q, block_k
    B, Sq, H, dh = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    out = _FlashMHA.apply(_to_flat(q), _to_flat(k), _to_flat(v),
                          bool(causal), int(window), scale, int(q_offset))
    return _from_flat(out, B, H)
