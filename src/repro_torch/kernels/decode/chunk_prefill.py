"""Chunked-prefill attention kernel wrapper (the serving prefill hot loop).

On CUDA tensors ``chunk_prefill`` launches the hand-written kernel of
``kernels/csrc/chunk_prefill.cu`` (the port of the Pallas
``_chunk_prefill_kernel`` in ``repro/kernels/decode/chunk_prefill.py``):
in bf16, flash attention on tensor cores over blocks of (128 chunk rows,
one query head; 64 at dh 256), q and the slot's stripe of the whole
batched cache read in place by strides, each block's key loop ending at
run time at the last key its rows can see; f32 keeps the CUDA-core
kernel.  The slot and ``q_offset`` are int32 scalars in device memory
that each block reads, as the Pallas kernel reads ``q_offset`` from SMEM:
a Python int becomes one by ``torch.full``, a one-element int tensor on
the device is read as it is, so one captured CUDA graph of the launch
serves every slot and offset.  The bf16 kernel may split each block's key
range over several blocks (:func:`plan`, from static shapes only); their
f32 partials go to a workspace allocated here and the kernel's second
pass combines them in a fixed order (one launch count per call,
bit-identical relaunches).  On CPU tensors it runs the plain version in
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


def chunk_prefill(q, k_cache, v_cache, q_offset, *, scale: float,
                  slot=None):
    """q: (B, C, H, dh) at positions [q_offset, q_offset + C); caches:
    (n_slots, Skv, KV, dh) with the chunk rows already written; q's row b
    reads stripe b (``slot`` None, n_slots == B), or q is one slot's chunk
    (B = 1) and reads stripe ``slot``.  ``q_offset`` and ``slot``: ints or
    one-element int tensors on q's device, read by the kernel; the caller
    keeps a tensor's values in range (ints are checked here).  Returns
    (B, C, H, dh)."""
    if q.device.type == "cpu":
        return ref.chunk_prefill_reference(q, k_cache, v_cache, q_offset,
                                           scale=scale, slot=slot)
    return _launch(q, k_cache, v_cache, q_offset, slot, scale)


def _check_scalars(name, q_offset, slot, C, keys, slots, B):
    """The slot form's shape check and the range checks of the scalars
    given as host integers (a device value is the caller's to keep in
    range)."""
    if slot is not None and B != 1:
        raise ValueError(f"{name}: one slot's chunk is one row of q, got {B}")
    if not isinstance(q_offset, torch.Tensor) and \
            not 0 <= q_offset <= keys - C:
        raise ValueError(f"{name}: chunk [{q_offset}, {q_offset + C}) "
                         f"outside {keys} keys")
    if slot is not None and not isinstance(slot, torch.Tensor) and \
            not 0 <= slot < slots:
        raise ValueError(f"{name}: slot {slot} outside {slots} slots")


def _device_scalars(name, q_offset, slot, device):
    """The kernel's (slot, q_offset) as device scalars (slot None stays
    None: the kernel reads stripe or table row b for q's row b)."""
    return (None if slot is None else lib.device_scalar(name, slot, device),
            lib.device_scalar(name, q_offset, device))


def _launch(q, k_cache, v_cache, q_offset, slot, scale):
    lib.require_cuda(NAME, q, k_cache, v_cache)
    code = lib.require_dtype(NAME, q, k_cache, v_cache)
    B, C, H, dh = q.shape
    n_slots, Skv, KV, _ = k_cache.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[3] != dh
            or H % KV or (slot is None and n_slots != B)):
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    _check_scalars(NAME, q_offset, slot, C, Skv, n_slots, B)
    if not q.is_contiguous():
        raise ValueError(f"{NAME}: q must be contiguous")
    if k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError(f"{NAME}: caches need a contiguous head dim")
    out = torch.empty_like(q)
    splits, n_ws = plan(code, B, C, H, KV, dh, Skv, lib.sm_count(q.device))
    # each split's (O, m, l) in f32, combined by the kernel's second pass
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    sl, off = _device_scalars(NAME, q_offset, slot, q.device)
    err = lib.load().famous_chunk_prefill(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), ws.data_ptr() if n_ws else None, splits, B, C, H,
        KV, dh, Skv, sl if sl is None else sl.data_ptr(), off.data_ptr(),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        float(scale), lib.stream_of(q))
    lib.check(NAME, err, ws)
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


def paged_chunk_prefill(q, k_pages, v_pages, page_table, q_offset, *,
                        scale: float, slot=None):
    """q: (B, C, H, dh) at positions [q_offset, q_offset + C); pools:
    (n_pages, page_size, KV, dh) with the chunk rows already written;
    page_table: (n_slots, n_p) int32 on the pools' device, q's row b
    reading table row b (``slot`` None, n_slots == B) or, for one slot's
    chunk (B = 1), row ``slot``.  ``q_offset`` and ``slot`` as in
    :func:`chunk_prefill`.  Returns (B, C, H, dh)."""
    if q.device.type == "cpu":
        return ref.paged_chunk_prefill_reference(q, k_pages, v_pages,
                                                 page_table, q_offset,
                                                 scale=scale, slot=slot)
    return _launch_paged(PAGED, q, k_pages, v_pages, None, None, page_table,
                         q_offset, slot, scale)


def paged_chunk_prefill_int8(q, k_pages, v_pages, k_scale, v_scale,
                             page_table, q_offset, *, scale: float,
                             slot=None):
    """:func:`paged_chunk_prefill` on int8 pools with f32
    (n_pages, page_size, KV) scale pools, dequantized in the kernel's
    tiles."""
    if q.device.type == "cpu":
        return ref.paged_chunk_prefill_reference_int8(
            q, k_pages, v_pages, k_scale, v_scale, page_table, q_offset,
            scale=scale, slot=slot)
    return _launch_paged(PAGED_INT8, q, k_pages, v_pages, k_scale, v_scale,
                         page_table, q_offset, slot, scale)


def _launch_paged(name, q, k_pages, v_pages, k_scale, v_scale, page_table,
                  q_offset, slot, scale):
    int8 = k_scale is not None
    lib.require_cuda(name, q, k_pages, v_pages, page_table,
                     *((k_scale, v_scale) if int8 else ()))
    code = lib.require_dtype(name, q) if int8 else \
        lib.require_dtype(name, q, k_pages, v_pages)
    B, C, H, dh = q.shape
    n_pages, ps, KV, _ = k_pages.shape
    n_slots, n_p = page_table.shape
    lib.require_pool(name, k_pages, v_pages, k_scale, v_scale, dh, H)
    if slot is None and n_slots != B:
        raise ValueError(f"{name}: q {tuple(q.shape)}, page_table "
                         f"{tuple(page_table.shape)}")
    lib.require_int32(name, page_table)
    # keys end at the table's n_p * ps; a chunk may run past them (its
    # pad rows' writes went to the null page)
    _check_scalars(name, q_offset, slot, 0, n_p * ps, n_slots, B)
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
    sl, off = _device_scalars(name, q_offset, slot, q.device)
    err = getattr(so, f"famous_{name}")(
        code, *ptrs, page_table.data_ptr(), out.data_ptr(),
        ws.data_ptr() if n_ws else None, splits, B, C, H, KV, dh, ps, n_p,
        n_pages, sl if sl is None else sl.data_ptr(), off.data_ptr(),
        float(scale), lib.stream_of(q))
    lib.check(name, err, ws)
    lib.STATS.launches[name] += 1
    return out
