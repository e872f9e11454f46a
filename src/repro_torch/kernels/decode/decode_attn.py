"""Single-token decode attention kernel wrapper (serving hot loop).

On CUDA tensors ``decode_attention`` launches the hand-written kernel of
``kernels/csrc/decode_attention.cu`` (the port of the Pallas
``_decode_kernel`` in ``repro/kernels/decode/decode_attn.py``): one block
per (slot, kv head), the grouped query heads as its rows, the cache read in
place by strides, the key loop ending at each slot's length at run time.
On CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.decode.ref`.

``paged_decode_attention`` and ``paged_decode_attention_int8`` launch the
kernels of ``kernels/csrc/paged_decode_attention.cu`` (the ports of the
Pallas ``_paged_decode_kernel`` and ``_paged_decode_kernel_int8``): the
same design, reading each key through the slot's page table from a shared
(n_pages, page_size, KV, dh) pool, f32/bf16 or int8 with f32 scales.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lib
from repro_torch.kernels.decode import ref

NAME = "decode_attention"


def decode_attention(q, k_cache, v_cache, cache_len, *, scale: float,
                     rows_per_slot: int = 1):
    """q: (R, H, dh); caches: (R / rows_per_slot, Skv, KV, dh); cache_len:
    (R,) int32 on the caches' device.  Row r attends slot
    ``r // rows_per_slot`` (speculative verify: the W rows of a slot share
    its cache, each with its own length).  Returns (R, H, dh)."""
    if q.device.type == "cpu":
        return ref.decode_reference(q, k_cache, v_cache, cache_len,
                                    scale=scale, rows_per_slot=rows_per_slot)
    return _launch(q, k_cache, v_cache, cache_len, scale, rows_per_slot)


def _launch(q, k_cache, v_cache, cache_len, scale, rows_per_slot):
    lib.require_cuda(NAME, q, k_cache, v_cache, cache_len)
    code = lib.require_dtype(NAME, q, k_cache, v_cache)
    B, H, dh = q.shape
    _, Skv, KV, _ = k_cache.shape
    if (k_cache.shape != v_cache.shape
            or k_cache.shape[0] * rows_per_slot != B
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
        rows_per_slot, k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        float(scale), lib.stream_of(q))
    lib.check(NAME, err)
    lib.STATS.launches[NAME] += 1
    return out


PAGED = "paged_decode_attention"
PAGED_INT8 = "paged_decode_attention_int8"


def paged_decode_attention(q, k_pages, v_pages, page_table, cache_len, *,
                           scale: float):
    """q: (B, H, dh); pools: (n_pages, page_size, KV, dh); page_table:
    (B, n_p) int32 page ids; cache_len: (B,) int32, both on the pools'
    device.  Returns (B, H, dh)."""
    if q.device.type == "cpu":
        return ref.paged_decode_reference(q, k_pages, v_pages, page_table,
                                          cache_len, scale=scale)
    return _launch_paged(PAGED, q, k_pages, v_pages, None, None, page_table,
                         cache_len, scale)


def paged_decode_attention_int8(q, k_pages, v_pages, k_scale, v_scale,
                                page_table, cache_len, *, scale: float):
    """:func:`paged_decode_attention` on int8 pools with f32
    (n_pages, page_size, KV) scale pools, dequantized in the kernel's
    tiles."""
    if q.device.type == "cpu":
        return ref.paged_decode_reference_int8(q, k_pages, v_pages, k_scale,
                                               v_scale, page_table, cache_len,
                                               scale=scale)
    return _launch_paged(PAGED_INT8, q, k_pages, v_pages, k_scale, v_scale,
                         page_table, cache_len, scale)


def _launch_paged(name, q, k_pages, v_pages, k_scale, v_scale, page_table,
                  cache_len, scale):
    int8 = k_scale is not None
    lib.require_cuda(name, q, k_pages, v_pages, page_table, cache_len,
                     *((k_scale, v_scale) if int8 else ()))
    code = lib.require_dtype(name, q) if int8 else \
        lib.require_dtype(name, q, k_pages, v_pages)
    B, H, dh = q.shape
    n_pages, ps, KV, _ = k_pages.shape
    n_p = page_table.shape[-1]
    lib.require_pool(name, k_pages, v_pages, k_scale, v_scale, dh, H)
    if page_table.shape != (B, n_p) or cache_len.shape != (B,):
        raise ValueError(f"{name}: q {tuple(q.shape)}, page_table "
                         f"{tuple(page_table.shape)}, cache_len "
                         f"{tuple(cache_len.shape)}")
    lib.require_int32(name, page_table, cache_len)
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    out = torch.empty_like(q)
    so = lib.load()
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if int8:
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
    err = getattr(so, f"famous_{name}")(
        code, *ptrs, page_table.data_ptr(), cache_len.data_ptr(),
        out.data_ptr(), B, H, KV, dh, ps, n_p, n_pages, float(scale),
        lib.stream_of(q))
    lib.check(name, err)
    lib.STATS.launches[name] += 1
    return out
