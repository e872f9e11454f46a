"""Single-token decode attention kernel wrapper (serving hot loop).

On CUDA tensors ``decode_attention`` launches the hand-written kernel of
``kernels/csrc/decode_attention.cu`` (the port of the Pallas
``_decode_kernel`` in ``repro/kernels/decode/decode_attn.py``): one block
per (slot, kv head), the grouped query heads as its rows, the cache read in
place by strides, the key loop ending at each slot's length at run time.
On CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.decode.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lib
from repro_torch.kernels.decode import ref

NAME = "decode_attention"


def decode_attention(q, k_cache, v_cache, cache_len, *, scale: float):
    """q: (B, H, dh); caches: (B, Skv, KV, dh); cache_len: (B,) int32 on
    the caches' device.  Returns (B, H, dh)."""
    if q.device.type == "cpu":
        return ref.decode_reference(q, k_cache, v_cache, cache_len,
                                    scale=scale)
    return _launch(q, k_cache, v_cache, cache_len, scale)


def _launch(q, k_cache, v_cache, cache_len, scale):
    lib.require_cuda(NAME, q, k_cache, v_cache, cache_len)
    code = lib.require_dtype(NAME, q, k_cache, v_cache)
    B, H, dh = q.shape
    _, Skv, KV, _ = k_cache.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != dh or H % KV or cache_len.shape != (B,)):
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, "
                         f"cache_len {tuple(cache_len.shape)}")
    if cache_len.dtype != torch.int32:
        raise ValueError(f"{NAME}: cache_len must be int32")
    if not q.is_contiguous() or not cache_len.is_contiguous():
        raise ValueError(f"{NAME}: q and cache_len must be contiguous")
    if k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError(f"{NAME}: caches need a contiguous head dim")
    out = torch.empty_like(q)
    so = lib.load()
    err = so.famous_decode_attention(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), B, H, KV, dh, Skv,
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        float(scale), lib.stream_of(q))
    lib.check(NAME, err)
    lib.STATS.launches[NAME] += 1
    return out
