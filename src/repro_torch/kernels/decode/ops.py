"""Decode / speculative-verify / chunked-prefill attention from the model's
(B, S, H, dh) layout, on contiguous caches and on paged pools (fp and
int8).

The JAX wrappers transpose q (and the contiguous caches) to kv-major rows
on every call; the port's kernels read the model layout by strides, so the
only layout work left here is dropping the decode step's unit sequence
axis (a view) and making q contiguous for the kernels."""
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


def _verify_lens(cache_len, W: int, cap: int, device):
    """(B * W,) int32 row lengths of a verify: position j of slot b sees
    ``cache_len[b] + j + 1`` keys, clipped to ``cap`` (pad rows past a
    nearly full slot; the engine discards their output)."""
    cl = cache_len.to(device=device, dtype=torch.int32)
    j = torch.arange(1, W + 1, dtype=torch.int32, device=device)
    return torch.clamp(cl[:, None] + j, max=cap).reshape(-1).contiguous()


def verify_attention(q, k_cache, v_cache, cache_len, *, scale=None):
    """Speculative verify on the decode kernel: q: (B, W, H, dh) at
    per-slot positions ``cache_len[b] + j`` (their K/V already written);
    caches: (B, Skv, KV, dh); cache_len: (B,) valid entries before the
    first verify token.  Returns (B, W, H, dh).

    Each (slot, verify position) pair is a kernel row ``b * W + j`` with
    its own length; the kernel reads slot ``row // W`` of the caches in
    place (``rows_per_slot=W``), where the JAX wrapper broadcasts each
    slot's cache W ways."""
    B, W, H, dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    lens = _verify_lens(cache_len, W, k_cache.shape[1], k_cache.device)
    out = decode_attn.decode_attention(q.reshape(B * W, H, dh).contiguous(),
                                       k_cache, v_cache, lens, scale=scale,
                                       rows_per_slot=W)
    return out.reshape(B, W, H, dh)


def paged_verify_attention(q, k_pages, v_pages, page_table, cache_len, *,
                           k_scale=None, v_scale=None, scale=None):
    """Paged speculative verify: q: (B, W, H, dh); pools: (n_pages,
    page_size, KV, dh); page_table: (B, n_p) int32; cache_len: (B,).
    Returns (B, W, H, dh).  The rows of :func:`verify_attention` on the
    paged decode kernels (int8 with ``k_scale``/``v_scale``): row ``b * W +
    j`` reads slot b's page-table row in place (``rows_per_slot=W``); only
    the lengths are per row."""
    B, W, H, dh = q.shape
    lens = _verify_lens(cache_len, W, page_table.shape[1] * k_pages.shape[1],
                        k_pages.device)
    out = paged_decode_attention(q.reshape(B * W, 1, H, dh), k_pages,
                                 v_pages, page_table, lens, k_scale=k_scale,
                                 v_scale=v_scale, scale=scale,
                                 rows_per_slot=W)
    return out.reshape(B, W, H, dh)


def chunk_prefill_attention(q, k_cache, v_cache, q_offset, *, scale=None,
                            slot=None):
    """q: (B, C, H, dh) at positions [q_offset, q_offset+C); caches:
    (B, Skv, KV, dh) with the chunk rows already written, or, given
    ``slot``, the whole batched cache of which q (B = 1) reads stripe
    ``slot``.  ``q_offset`` and ``slot``: ints or one-element int tensors
    on the device, which the kernel reads there.  Returns (B, C, H, dh)."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    return chunk_kernels.chunk_prefill(q.contiguous(), k_cache, v_cache,
                                       q_offset, scale=scale, slot=slot)


def paged_decode_attention(q, k_pages, v_pages, page_table, cache_len, *,
                           k_scale=None, v_scale=None, scale=None,
                           rows_per_slot: int = 1):
    """q: (R, 1, H, dh); pools: (n_pages, page_size, KV, dh); page_table:
    (R / rows_per_slot, n_p) int32; cache_len: (R,) valid entries.
    ``k_scale``/``v_scale`` (f32 (n_pages, page_size, KV)) select the
    int8-pool kernel.  Returns (R, 1, H, dh)."""
    R, _, H, dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    dev = k_pages.device
    lens = cache_len.to(device=dev, dtype=torch.int32).contiguous()
    pt = page_table.to(device=dev, dtype=torch.int32).contiguous()
    qf = q[:, 0].contiguous()
    if k_scale is not None:
        out = decode_attn.paged_decode_attention_int8(
            qf, k_pages, v_pages, k_scale, v_scale, pt, lens, scale=scale,
            rows_per_slot=rows_per_slot)
    else:
        out = decode_attn.paged_decode_attention(
            qf, k_pages, v_pages, pt, lens, scale=scale,
            rows_per_slot=rows_per_slot)
    return out.reshape(R, 1, H, dh)


def paged_chunk_prefill_attention(q, k_pages, v_pages, page_table,
                                  q_offset, *, k_scale=None, v_scale=None,
                                  scale=None, slot=None):
    """q: (B, C, H, dh) at positions [q_offset, q_offset + C); pools:
    (n_pages, page_size, KV, dh) with the chunk rows already written;
    page_table: (B, n_p) int32, or, given ``slot``, the whole (n_slots,
    n_p) table of which q (B = 1) reads row ``slot``.  ``q_offset`` and
    ``slot`` as in :func:`chunk_prefill_attention`.  ``k_scale``/
    ``v_scale`` select the int8-pool kernel.  Returns (B, C, H, dh)."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    pt = page_table.to(device=k_pages.device, dtype=torch.int32).contiguous()
    if k_scale is not None:
        return chunk_kernels.paged_chunk_prefill_int8(
            q.contiguous(), k_pages, v_pages, k_scale, v_scale, pt, q_offset,
            scale=scale, slot=slot)
    return chunk_kernels.paged_chunk_prefill(q.contiguous(), k_pages, v_pages,
                                             pt, q_offset, scale=scale,
                                             slot=slot)
