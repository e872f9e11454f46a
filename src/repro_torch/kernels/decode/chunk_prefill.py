"""Chunked-prefill attention kernel wrapper (the serving prefill hot loop).

On CUDA tensors ``chunk_prefill`` launches the hand-written kernel of
``kernels/csrc/chunk_prefill.cu`` (the port of the Pallas
``_chunk_prefill_kernel`` in ``repro/kernels/decode/chunk_prefill.py``):
in bf16, flash attention on tensor cores over blocks of (128 chunk rows,
one query head; 64 at dh 256), q and the slot's cache stripe read in
place by strides, each block's key loop ending at run time at the last
key its rows can see; f32 keeps the CUDA-core kernel.  ``q_offset`` is a
plain integer argument of the launch, so one build serves every offset.
The bf16 kernel may split each block's key range over several blocks
(:func:`plan`, from static shapes only); their f32 partials go to a
workspace allocated here and the kernel's second pass combines them in a
fixed order (one launch count per call, bit-identical relaunches).  On
CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.decode.ref` (where
``chunk_prefill_tc_reference`` mirrors the tensor-core algebra for the
tests).

``paged_chunk_prefill`` and ``paged_chunk_prefill_int8`` launch the
kernels of ``kernels/csrc/paged_chunk_prefill.cu`` (the ports of the
Pallas ``_paged_chunk_prefill_kernel`` and its int8 twin), reading each
key through the slot's page table from a shared (n_pages, page_size, KV,
dh) pool, bf16/f32 or int8 with f32 scales.  In bf16 they run the
contiguous kernel's tensor-core body (``kernels/csrc/chunk_tc.cuh``) with
paged addressing, split as :func:`plan` splits a cache of n_p * page_size
keys (int8 values exact in the bf16 tiles, the K scale on the scores, the
V scale on P's columns); f32 keeps the CUDA-core kernel.  On CPU tensors
they run the plain versions (``ref.paged_chunk_prefill_tc_reference``
and its int8 twin mirror the tensor-core algebra for the tests).
"""
from __future__ import annotations

import functools

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
    splits, n_ws = plan(code, B, C, H, KV, dh, Skv, lib.sm_count(q.device))
    # each split's (O, m, l) in f32, combined by the kernel's second pass
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    err = lib.load().famous_chunk_prefill(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), ws.data_ptr() if n_ws else None, splits, B, C, H,
        KV, dh, Skv, q_offset,
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        float(scale), lib.stream_of(q))
    lib.check(NAME, err)
    lib.STATS.launches[NAME] += 1
    return out


@functools.lru_cache(maxsize=None)
def plan(code: int, B: int, C: int, H: int, KV: int, dh: int, Skv: int,
         sms: int) -> tuple[int, int]:
    """Key-range splits of the bf16 kernel for a static shape
    (``lib.DTYPE_CODE`` dtype code, slots, chunk length, query and kv
    heads, head dim, cache length, SM count), and the f32 elements of its
    workspace (0 for one split; always 1 split in f32)."""
    return lib.plan("famous_chunk_prefill_plan", code, B, C, H, KV, dh, Skv,
                    sms)


PAGED = "paged_chunk_prefill"
PAGED_INT8 = "paged_chunk_prefill_int8"


def paged_chunk_prefill(q, k_pages, v_pages, page_table, q_offset: int, *,
                        scale: float):
    """q: (B, C, H, dh) at positions [q_offset, q_offset + C); pools:
    (n_pages, page_size, KV, dh) with the chunk rows already written;
    page_table: (B, n_p) int32 on the pools' device.  Returns
    (B, C, H, dh)."""
    if q.device.type == "cpu":
        return ref.paged_chunk_prefill_reference(q, k_pages, v_pages,
                                                 page_table, q_offset,
                                                 scale=scale)
    return _launch_paged(PAGED, q, k_pages, v_pages, None, None, page_table,
                         int(q_offset), scale)


def paged_chunk_prefill_int8(q, k_pages, v_pages, k_scale, v_scale,
                             page_table, q_offset: int, *, scale: float):
    """:func:`paged_chunk_prefill` on int8 pools with f32
    (n_pages, page_size, KV) scale pools, dequantized in the kernel's
    tiles."""
    if q.device.type == "cpu":
        return ref.paged_chunk_prefill_reference_int8(
            q, k_pages, v_pages, k_scale, v_scale, page_table, q_offset,
            scale=scale)
    return _launch_paged(PAGED_INT8, q, k_pages, v_pages, k_scale, v_scale,
                         page_table, int(q_offset), scale)


def _launch_paged(name, q, k_pages, v_pages, k_scale, v_scale, page_table,
                  q_offset, scale):
    int8 = k_scale is not None
    lib.require_cuda(name, q, k_pages, v_pages, page_table,
                     *((k_scale, v_scale) if int8 else ()))
    code = lib.require_dtype(name, q) if int8 else \
        lib.require_dtype(name, q, k_pages, v_pages)
    B, C, H, dh = q.shape
    n_pages, ps, KV, _ = k_pages.shape
    n_p = page_table.shape[-1]
    lib.require_pool(name, k_pages, v_pages, k_scale, v_scale, dh, H)
    if page_table.shape != (B, n_p):
        raise ValueError(f"{name}: q {tuple(q.shape)}, page_table "
                         f"{tuple(page_table.shape)}")
    lib.require_int32(name, page_table)
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset {q_offset} < 0")
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    out = torch.empty_like(q)
    # split as the contiguous kernel splits a cache of the table's keys
    splits, n_ws = plan(code, B, C, H, KV, dh, n_p * ps,
                        lib.sm_count(q.device))
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    so = lib.load()
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if int8:
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
    err = getattr(so, f"famous_{name}")(
        code, *ptrs, page_table.data_ptr(), out.data_ptr(),
        ws.data_ptr() if n_ws else None, splits, B, C, H, KV, dh, ps, n_p,
        n_pages, q_offset, float(scale), lib.stream_of(q))
    lib.check(name, err)
    lib.STATS.launches[name] += 1
    return out
