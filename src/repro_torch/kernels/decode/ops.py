"""Decode / chunked-prefill attention from the model's (B, S, H, dh)
layout.

The JAX wrappers transpose q and both caches to kv-major rows on every
call; the port's kernels read the model layout by strides, so the only
layout work left here is dropping the decode step's unit sequence axis (a
view) and making q contiguous for the kernels."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode import chunk_prefill as chunk_kernels
from repro_torch.kernels.decode import decode_attn


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None):
    """q: (B, 1, H, dh); caches: (B, Skv, KV, dh); cache_len: (B,) valid
    entries.  Returns (B, 1, H, dh)."""
    B, _, H, dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    lens = cache_len.to(device=k_cache.device, dtype=torch.int32)
    out = decode_attn.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                       lens.contiguous(), scale=scale)
    return out.reshape(B, 1, H, dh)


def chunk_prefill_attention(q, k_cache, v_cache, q_offset: int, *,
                            scale=None):
    """q: (B, C, H, dh) at positions [q_offset, q_offset+C); caches:
    (B, Skv, KV, dh) with the chunk rows already written; q_offset: a host
    integer.  Returns (B, C, H, dh)."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    return chunk_kernels.chunk_prefill(q.contiguous(), k_cache, v_cache,
                                       int(q_offset), scale=scale)
