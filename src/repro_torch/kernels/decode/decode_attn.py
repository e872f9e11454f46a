"""Single-token decode attention kernel wrapper (serving hot loop).

On CUDA tensors ``decode_attention`` launches the hand-written kernel of
``kernels/csrc/decode_attention.cu`` (the port of the Pallas
``_decode_kernel`` in ``repro/kernels/decode/decode_attn.py``):
flash-decoding.  Each block owns a range of L keys of one (row, kv head),
the grouped query heads as its rows, and reads the cache in place by
strides; a range past the row's length exits at once.  L comes from static
shapes only (:func:`plan`), so the grid never depends on a length read on
the host.  Two designs (:func:`design`, from the static group and head
dim): "stream" for bf16 at dh 128 and one or six query heads a kv head
(deepseek-7b, grok-1): ranges of up to 512 keys, each of a block's four
warps streaming its 8-key tiles through its own ring of cp.async stages
with an online softmax, bounded by HBM bandwidth (84-88% of it at the
deepseek-7b cell's shape on an H100); "split" elsewhere: ranges of up to
256 keys held whole in shared memory.  The blocks write f32 partials to a
workspace allocated here (its size from the same plan), and the kernel's
second pass combines them in a fixed order (one launch count per call in
``lib.STATS.launches``, one under its design in ``lib.STATS.designs``;
bit-identical relaunches).
On CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.decode.ref` (where ``decode_split_reference``
mirrors either design's split-and-combine algebra for the tests).

``paged_decode_attention`` and ``paged_decode_attention_int8`` launch the
kernels of ``kernels/csrc/paged_decode_attention.cu`` (the ports of the
Pallas ``_paged_decode_kernel`` and ``_paged_decode_kernel_int8``): the
same split-key kernel and combine pass (``csrc/decode_split.cuh``), each
block resolving its range's page ids once and reading the rows of a shared
(n_pages, page_size, KV, dh) pool, f32/bf16 or int8 with f32 scales; L and
the workspace from :func:`paged_plan`.  ``rows_per_slot`` lets the W
verify rows of a slot read its page-table row in place.  On CPU tensors
they run the plain versions (``paged_decode_split_reference`` mirrors the
paged split-and-combine algebra for the tests).
"""
from __future__ import annotations

import functools

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
    L, n_ws = plan(code, B, H, KV, dh, Skv, lib.sm_count(q.device))
    # each range's (acc, m, l) in f32, combined by the kernel's second pass
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    err = lib.load().famous_decode_attention(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(),
        ws.data_ptr(), B, H, KV, dh, Skv,
        rows_per_slot, L, k_cache.stride(0), k_cache.stride(1),
        k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        float(scale), lib.stream_of(q))
    lib.check(NAME, err, ws)
    lib.STATS.launches[NAME] += 1
    lib.STATS.designs[f"{NAME}.{design(code, H, KV, dh)}"] += 1
    return out


@functools.lru_cache(maxsize=None)
def plan(code: int, rows: int, H: int, KV: int, dh: int, Skv: int,
         sms: int) -> tuple[int, int]:
    """Keys per block range L of the contiguous kernel for a static shape
    (``lib.DTYPE_CODE`` dtype code, row count, query and kv heads, head
    dim, cache length, SM count), and the f32 elements of its workspace:
    the grid splits Skv into ``ceil(Skv / L)`` ranges, whatever the
    lengths.  L is :func:`design`'s: at most 256 for "split", 512 for
    "stream"."""
    return lib.plan("famous_decode_attention_plan", code, rows, H, KV, dh,
                    Skv, sms)


STREAM_TILES = (4, 8)   # decode_split.cuh StreamServe: warps, keys a tile


@functools.lru_cache(maxsize=None)
def design(code: int, H: int, KV: int, dh: int) -> str:
    """The design a launch at these static shapes takes: "stream" (bf16,
    dh 128, 1 or 6 query heads a kv head: ``decode_stream_kernel``, its
    algebra ``ref.decode_split_reference(..., stream_tiles=STREAM_TILES)``)
    or "split" (``decode_split_kernel``, the plain split algebra)."""
    d = lib.load().famous_decode_attention_design(code, H, KV, dh)
    return lib.DESIGNS[d].split(".")[1]


PAGED = "paged_decode_attention"
PAGED_INT8 = "paged_decode_attention_int8"


def paged_decode_attention(q, k_pages, v_pages, page_table, cache_len, *,
                           scale: float, rows_per_slot: int = 1):
    """q: (R, H, dh); pools: (n_pages, page_size, KV, dh); page_table:
    (R / rows_per_slot, n_p) int32 page ids; cache_len: (R,) int32, both on
    the pools' device.  Row r reads slot ``r // rows_per_slot``.  Returns
    (R, H, dh)."""
    if q.device.type == "cpu":
        return ref.paged_decode_reference(q, k_pages, v_pages, page_table,
                                          cache_len, scale=scale,
                                          rows_per_slot=rows_per_slot)
    return _launch_paged(PAGED, q, k_pages, v_pages, None, None, page_table,
                         cache_len, scale, rows_per_slot)


def paged_decode_attention_int8(q, k_pages, v_pages, k_scale, v_scale,
                                page_table, cache_len, *, scale: float,
                                rows_per_slot: int = 1):
    """:func:`paged_decode_attention` on int8 pools with f32
    (n_pages, page_size, KV) scale pools, dequantized in the kernel's
    tiles."""
    if q.device.type == "cpu":
        return ref.paged_decode_reference_int8(
            q, k_pages, v_pages, k_scale, v_scale, page_table, cache_len,
            scale=scale, rows_per_slot=rows_per_slot)
    return _launch_paged(PAGED_INT8, q, k_pages, v_pages, k_scale, v_scale,
                         page_table, cache_len, scale, rows_per_slot)


def _launch_paged(name, q, k_pages, v_pages, k_scale, v_scale, page_table,
                  cache_len, scale, rows_per_slot):
    int8 = k_scale is not None
    lib.require_cuda(name, q, k_pages, v_pages, page_table, cache_len,
                     *((k_scale, v_scale) if int8 else ()))
    code = lib.require_dtype(name, q) if int8 else \
        lib.require_dtype(name, q, k_pages, v_pages)
    R, H, dh = q.shape
    n_pages, ps, KV, _ = k_pages.shape
    n_p = page_table.shape[-1]
    lib.require_pool(name, k_pages, v_pages, k_scale, v_scale, dh, H)
    if (page_table.shape[0] * rows_per_slot != R or page_table.dim() != 2
            or cache_len.shape != (R,)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, page_table "
                         f"{tuple(page_table.shape)}, cache_len "
                         f"{tuple(cache_len.shape)}, rows_per_slot "
                         f"{rows_per_slot}")
    lib.require_int32(name, page_table, cache_len)
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    out = torch.empty_like(q)
    L, n_ws = paged_plan(R, H, KV, dh, n_p * ps, k_pages.element_size(),
                         lib.sm_count(q.device))
    # each range's (acc, m, l) in f32, combined by the kernel's second pass
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if int8:
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
    err = getattr(lib.load(), f"famous_{name}")(
        code, *ptrs, page_table.data_ptr(), cache_len.data_ptr(),
        out.data_ptr(), ws.data_ptr(), R, H, KV, dh, ps, n_p, n_pages,
        rows_per_slot, L, float(scale), lib.stream_of(q))
    lib.check(name, err, ws)
    lib.STATS.launches[name] += 1
    return out


@functools.lru_cache(maxsize=None)
def paged_plan(rows: int, H: int, KV: int, dh: int, Skv: int, esize: int,
               sms: int) -> tuple[int, int]:
    """Keys per block range L of the paged kernels for a static shape (row
    count, query and kv heads, head dim, keys a slot's page table can hold
    ``n_p * page_size``, pool element bytes, SM count), and the f32
    elements of their workspace."""
    return lib.plan("famous_paged_decode_attention_plan", rows, H, KV, dh,
                    Skv, esize, sms)
