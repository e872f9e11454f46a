"""Plain PyTorch versions of the decode and chunked-prefill attention
kernels, at the kernels' own layouts.

The kernel wrappers run them for tensors on the CPU; ``chip_smoke.py`` holds
the CUDA kernels against them on the card.  Like the kernels they give a
row with no visible key an output of 0 (the dense ``famous`` oracles give
NaN there).  The serving path never calls them on CUDA tensors
(``lib.STATS.plain_on_cuda`` counts any such call)."""
from __future__ import annotations

import torch

from repro_torch.kernels.lib import STATS


def _softmax_pv(s: torch.Tensor, ok: torch.Tensor, v: torch.Tensor):
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    return p @ v


def decode_reference(q, k_cache, v_cache, cache_len, *, scale: float):
    """q: (B, H, dh); caches: (B, Skv, KV, dh); cache_len: (B,) int.
    Returns (B, H, dh): query head h attends kv head h // (H // KV) at
    positions < cache_len[b]."""
    if q.is_cuda:
        STATS.plain_on_cuda["decode_attention"] += 1
    B, H, dh = q.shape
    Skv, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qf = q.to(torch.float32).reshape(B, KV, g, dh) * scale
    kf = k_cache.to(torch.float32).permute(0, 2, 3, 1)        # (B, KV, dh, Skv)
    vf = v_cache.to(torch.float32).permute(0, 2, 1, 3)        # (B, KV, Skv, dh)
    s = qf @ kf                                               # (B, KV, g, Skv)
    pos = torch.arange(Skv, device=q.device)
    ok = (pos[None, :] < cache_len.to(q.device)[:, None])[:, None, None, :]
    out = _softmax_pv(s, ok, vf)                              # (B, KV, g, dh)
    return out.reshape(B, H, dh).to(q.dtype)


def chunk_prefill_reference(q, k_cache, v_cache, q_offset: int, *,
                            scale: float):
    """q: (B, C, H, dh) at positions [q_offset, q_offset + C); caches:
    (B, Skv, KV, dh) with the chunk rows already written.  Row c sees cache
    position j iff j <= q_offset + c.  Returns (B, C, H, dh)."""
    if q.is_cuda:
        STATS.plain_on_cuda["chunk_prefill"] += 1
    B, C, H, dh = q.shape
    Skv, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qf = (q.to(torch.float32).reshape(B, C, KV, g, dh).permute(0, 2, 3, 1, 4)
          * scale)                                            # (B, KV, g, C, dh)
    kf = k_cache.to(torch.float32).permute(0, 2, 3, 1)[:, :, None]
    vf = v_cache.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    s = qf @ kf                                               # (B, KV, g, C, Skv)
    ok = (torch.arange(Skv, device=q.device)[None, :]
          <= (q_offset + torch.arange(C, device=q.device))[:, None])
    out = _softmax_pv(s, ok, vf)                              # (B, KV, g, C, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, dh).to(q.dtype)
