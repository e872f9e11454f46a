"""Absorbed latent-attention decode kernel wrapper (MLA, kimi-k2-instruct).

On CUDA tensors ``mla_decode`` launches the hand-written kernel of
``kernels/csrc/mla_decode.cu``: flash-decoding over a slot's latent rows
with the 64 query heads of a slot as the M side of tensor-core products,
scores over the 576 values of a row and P V over its first 512, an
online softmax, key ranges of L keys from static shapes (:func:`plan`),
f32 partials in a workspace allocated here and ``decode_split.cuh``'s
combine pass (one launch count per call in ``lib.STATS.launches``, one
in ``lib.STATS.designs`` under ``mla_decode.tc``).  It takes bf16 at 64
heads of 576 / 512 only.  On CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.decode.ref` (``mla_decode_reference``; where
``mla_decode_split_reference`` mirrors the kernel's tile algebra for the
tests).  It replaces no Pallas kernel: the JAX package has no latent
attention.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import lib
from repro_torch.kernels.decode import ref

NAME = "mla_decode"
HEADS, DK, DV = 64, 576, 512     # the kernel's static shape


def mla_decode(q, kv, lens, *, scale: float, dv: int):
    """q: (R, H, dk) absorbed queries; kv: (n_slots >= R, Skv, dk) latent
    rows, row r reading slot r; lens: (R,) int32 valid rows, on kv's
    device.  Softmax of ``scale`` q.row over each slot's first lens rows;
    returns P rows[..., :dv], (R, H, dv)."""
    if q.device.type == "cpu":
        return ref.mla_decode_reference(q, kv, lens, scale=scale, dv=dv)
    return _launch(q, kv, lens, scale, dv)


def _launch(q, kv, lens, scale, dv):
    lib.require_cuda(NAME, q, kv, lens)
    R, H, dk = q.shape
    if (q.dtype != torch.bfloat16 or kv.dtype != torch.bfloat16
            or (H, dk, dv) != (HEADS, DK, DV) or kv.dim() != 3
            or kv.shape[2] != dk or kv.shape[0] < R or lens.shape != (R,)):
        raise ValueError(f"{NAME}: bf16 q (R, {HEADS}, {DK}) and latent rows "
                         f"(slots, Skv, {DK}) with dv {DV}, got q "
                         f"{q.dtype} {tuple(q.shape)}, kv {kv.dtype} "
                         f"{tuple(kv.shape)}, dv {dv}, lens "
                         f"{tuple(lens.shape)}")
    lib.require_int32(NAME, lens)
    if not q.is_contiguous() or kv.stride(2) != 1 or kv.stride(1) != dk:
        raise ValueError(f"{NAME}: q contiguous and latent rows contiguous")
    Skv = kv.shape[1]
    L, n_ws = plan(R, Skv, lib.sm_count(q.device))
    out = torch.empty((R, H, dv), dtype=q.dtype, device=q.device)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    err = lib.load().famous_mla_decode(
        q.data_ptr(), kv.data_ptr(), lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), R, Skv, kv.stride(0), L, float(scale),
        lib.stream_of(q))
    lib.check(NAME, err, ws)
    lib.STATS.launches[NAME] += 1
    lib.STATS.designs[f"{NAME}.tc"] += 1
    return out


@functools.lru_cache(maxsize=None)
def plan(rows: int, Skv: int, sms: int) -> tuple[int, int]:
    """Keys per block range L for a static shape (rows, cache rows a slot,
    SM count) and the f32 elements of the workspace: the largest power of
    two in [64, 2048] whose grid at full rows gives every SM four blocks."""
    return lib.plan("famous_mla_decode_plan", rows, Skv, sms)
