"""Plain PyTorch versions of the decode and chunked-prefill attention
kernels, contiguous and paged (fp and int8 pools), at the kernels' own
layouts.

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


def _count(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        STATS.plain_on_cuda[name] += 1


def decode_reference(q, k_cache, v_cache, cache_len, *, scale: float,
                     rows_per_slot: int = 1):
    """q: (R, H, dh); caches: (R / rows_per_slot, Skv, KV, dh); cache_len:
    (R,) int.  Returns (R, H, dh): row r, query head h attends kv head
    h // (H // KV) of slot r // rows_per_slot at positions < cache_len[r]."""
    _count("decode_attention", q)
    if rows_per_slot > 1:
        k_cache = k_cache.repeat_interleave(rows_per_slot, dim=0)
        v_cache = v_cache.repeat_interleave(rows_per_slot, dim=0)
    return _decode(q, k_cache, v_cache, cache_len, scale)


def _decode(q, k_cache, v_cache, cache_len, scale):
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


def decode_split_reference(q, k_cache, v_cache, cache_len, *, scale: float,
                           keys_per_split: int, rows_per_slot: int = 1):
    """The contiguous decode kernel's split-and-combine algebra, in f32:
    :func:`decode_reference` computed as the kernel computes it.  The key
    axis is cut into ranges of ``keys_per_split`` keys; each range that
    starts below a row's length gives a partial (m, l, acc): the max of its
    live scores, the sum of exp(s - m) and exp(s - m) @ V.  The live ranges
    are then combined in order, ``M = max m_s``, ``out = sum e^(m_s - M)
    acc_s / max(sum e^(m_s - M) l_s, 1e-30)``; a row with no live range
    (length 0) comes out exactly 0.  Used by the tests and ``chip_smoke.py``
    only, never on the serving path."""
    _count("decode_attention", q)
    if rows_per_slot > 1:
        k_cache = k_cache.repeat_interleave(rows_per_slot, dim=0)
        v_cache = v_cache.repeat_interleave(rows_per_slot, dim=0)
    B, H, dh = q.shape
    Skv, KV = k_cache.shape[1], k_cache.shape[2]
    L = keys_per_split
    qf = q.to(torch.float32).reshape(B, KV, H // KV, dh) * scale
    kf = k_cache.to(torch.float32).permute(0, 2, 3, 1)        # (B, KV, dh, Skv)
    vf = v_cache.to(torch.float32).permute(0, 2, 1, 3)        # (B, KV, Skv, dh)
    lens = cache_len.to(device=q.device, dtype=torch.long).clamp(0, Skv)
    parts = []
    for lo in range(0, Skv, L):
        hi = min(lo + L, Skv)
        s = qf @ kf[..., lo:hi]                               # (B, KV, g, n)
        pos = torch.arange(lo, hi, device=q.device)
        ok = (pos[None, :] < lens[:, None])[:, None, None, :]
        s = s.masked_fill(~ok, -1e30)
        m = s.amax(-1)
        p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        parts.append((lens > lo, m, p.sum(-1), p @ vf[:, :, lo:hi]))
    live_m = [torch.where(live[:, None, None], m, -1e30)
              for live, m, _, _ in parts]
    M = torch.stack(live_m).amax(0)
    l = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][3])
    for (live, m, ls, a), lm in zip(parts, live_m):
        w = torch.where(live[:, None, None], torch.exp(lm - M), 0.0)
        l = l + w * ls
        acc = acc + w[..., None] * a
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, dh).to(q.dtype)


def chunk_prefill_reference(q, k_cache, v_cache, q_offset: int, *,
                            scale: float):
    """q: (B, C, H, dh) at positions [q_offset, q_offset + C); caches:
    (B, Skv, KV, dh) with the chunk rows already written.  Row c sees cache
    position j iff j <= q_offset + c.  Returns (B, C, H, dh)."""
    _count("chunk_prefill", q)
    return _chunk(q, k_cache, v_cache, q_offset, scale)


def _chunk(q, k_cache, v_cache, q_offset, scale):
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


# ---------------------------------------------------------------------------
# paged pools: (n_pages, page_size, KV, dh), addressed by (B, n_p) page ids
# ---------------------------------------------------------------------------


def gather_pages(pages, page_table):
    """Flatten a page pool into per-slot contiguous caches.

    pages: (n_pages, page_size, KV, dh); page_table: (B, n_p) int.
    Returns (B, n_p * page_size, KV, dh)."""
    n_p, ps = page_table.shape[1], pages.shape[1]
    g = pages[page_table.long()]                  # (B, n_p, ps, KV, dh)
    return g.reshape(g.shape[0], n_p * ps, *pages.shape[2:])


def gather_pages_int8(pages, scale_pool, page_table):
    """Dequantizing gather of an int8 pool: int8 (n_pages, ps, KV, dh) rows
    times their f32 (n_pages, ps, KV) scales.  Returns f32 (B, n_p * ps,
    KV, dh): what the int8 kernels compute tile by tile, made whole."""
    g = gather_pages(pages, page_table).to(torch.float32)
    s = gather_pages(scale_pool[..., None], page_table)
    return g * s.to(torch.float32)


def paged_decode_reference(q, k_pages, v_pages, page_table, cache_len, *,
                           scale: float):
    """q: (B, H, dh); pools: (n_pages, ps, KV, dh); page_table: (B, n_p);
    cache_len: (B,).  Returns (B, H, dh)."""
    _count("paged_decode_attention", q)
    return _decode(q, gather_pages(k_pages, page_table),
                   gather_pages(v_pages, page_table), cache_len, scale)


def paged_decode_reference_int8(q, k_pages, v_pages, k_scale, v_scale,
                                page_table, cache_len, *, scale: float):
    """:func:`paged_decode_reference` on int8 pools with f32 scale pools."""
    _count("paged_decode_attention_int8", q)
    return _decode(q, gather_pages_int8(k_pages, k_scale, page_table),
                   gather_pages_int8(v_pages, v_scale, page_table),
                   cache_len, scale)


def paged_chunk_prefill_reference(q, k_pages, v_pages, page_table,
                                  q_offset: int, *, scale: float):
    """q: (B, C, H, dh) at positions [q_offset, q_offset + C); pools as
    :func:`paged_decode_reference`, the chunk rows already written.
    Returns (B, C, H, dh)."""
    _count("paged_chunk_prefill", q)
    return _chunk(q, gather_pages(k_pages, page_table),
                  gather_pages(v_pages, page_table), q_offset, scale)


def paged_chunk_prefill_reference_int8(q, k_pages, v_pages, k_scale,
                                       v_scale, page_table, q_offset: int,
                                       *, scale: float):
    """:func:`paged_chunk_prefill_reference` on int8 pools."""
    _count("paged_chunk_prefill_int8", q)
    return _chunk(q, gather_pages_int8(k_pages, k_scale, page_table),
                  gather_pages_int8(v_pages, v_scale, page_table),
                  q_offset, scale)
