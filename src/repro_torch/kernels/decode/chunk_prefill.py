"""Chunked-prefill attention kernel wrapper (the serving prefill hot loop).

On CUDA tensors ``chunk_prefill`` launches the hand-written kernel of
``kernels/csrc/chunk_prefill.cu`` (the port of the Pallas
``_chunk_prefill_kernel`` in ``repro/kernels/decode/chunk_prefill.py``):
the chunk rows split over blocks of (32 rows, one query head), q and the
slot's cache stripe read in place by strides, and each block's key loop
ending at run time at the last key its rows can see.  ``q_offset`` is a
plain integer argument of the launch, so one build serves every offset.
On CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.decode.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lib
from repro_torch.kernels.decode import ref

NAME = "chunk_prefill"


def chunk_prefill(q, k_cache, v_cache, q_offset: int, *, scale: float):
    """q: (B, C, H, dh) at positions [q_offset, q_offset + C); caches:
    (B, Skv, KV, dh) with the chunk rows already written.  Returns
    (B, C, H, dh)."""
    if q.device.type == "cpu":
        return ref.chunk_prefill_reference(q, k_cache, v_cache, q_offset,
                                           scale=scale)
    return _launch(q, k_cache, v_cache, int(q_offset), scale)


def _launch(q, k_cache, v_cache, q_offset, scale):
    lib.require_cuda(NAME, q, k_cache, v_cache)
    code = lib.require_dtype(NAME, q, k_cache, v_cache)
    B, C, H, dh = q.shape
    _, Skv, KV, _ = k_cache.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != dh or H % KV):
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    if not 0 <= q_offset <= Skv - C:
        raise ValueError(f"{NAME}: chunk [{q_offset}, {q_offset + C}) "
                         f"outside a cache of {Skv}")
    if not q.is_contiguous():
        raise ValueError(f"{NAME}: q must be contiguous")
    if k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError(f"{NAME}: caches need a contiguous head dim")
    out = torch.empty_like(q)
    so = lib.load()
    err = so.famous_chunk_prefill(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), B, C, H, KV, dh, Skv, q_offset,
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        float(scale), lib.stream_of(q))
    lib.check(NAME, err)
    lib.STATS.launches[NAME] += 1
    return out
