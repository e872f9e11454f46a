"""Tiled QKV-projection kernel wrappers — FAMOUS Algorithm 1 on Hopper.

``matmul_tiled`` computes X(T, D) @ W(D, F) with an f32 accumulator and one
cast to the operands' dtype.  On CUDA tensors it launches the hand-written
kernel of ``kernels/csrc/matmul_tiled.cu`` (the port of the Pallas
``_proj_kernel`` in ``repro/kernels/qkv/qkv_proj.py``): bf16 on tensor cores
(``mma.sync`` with a ``cp.async`` ring), f32 on the CUDA cores in full f32.
At T <= 32 (decode, verify) the bf16 kernel splits D across blocks so that
W streams from every SM; the f32 partials go to a workspace allocated here
and the kernel's second pass sums them in a fixed order (one launch count
per call, bit-identical relaunches).  The split count comes from the
static shape and the SM count (:func:`_plan`, which also sizes the
workspace).  On CPU tensors it runs
the plain version in :mod:`repro_torch.kernels.qkv.ref`.

Differentiable, as the JAX custom VJP is: the backward of a matmul is two
matmuls, and both run through the same kernel (or the same plain version
on the CPU): dX = g·Wᵀ is (T, F) @ (F, D) and dW = Xᵀ·g is (D, T) @ (T, F).
The transposed operands are contiguous copies, not a strided kernel
argument: the kernel's tile loads are coalesced along the contiguous dim,
which a transposed view would turn into a stride of D (or T) between
neighbouring threads, and one copy of W or X is one pass over T·D or D·F
elements against the product's T·D·F multiply-adds.  A call that needs no
gradient (the serving path) launches the kernel directly.

``matmul_tiled_int8`` is the paper's 8-bit fixed point: int8 X and W, an
exact integer accumulator and the per-token x per-column dequantize on
flush, f32 out.  On CUDA tensors it launches
``kernels/csrc/matmul_tiled_int8.cu`` (the port of the Pallas
``_proj_kernel_int8``), which at T <= 32 splits D across blocks as its C
plan says (:func:`_plan_int8`), with int32 partials in a workspace
allocated here and added exactly by the kernel's second pass.  It takes W
**transposed**, as (F, D): the model
quantizes the fused W once at load and stores it so (see
``models/attention.quantize_qkv``).  On CPU tensors it runs the plain
version, which keeps JAX's (D, F) signature.  No gradient: the JAX kernel
has none either, and ``round`` has none.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import lib
from repro_torch.kernels.qkv import ref

NAME = "matmul_tiled"
NAME_INT8 = "matmul_tiled_int8"


def matmul_tiled(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (T, D) @ w: (D, F) -> (T, F) in ``x.dtype``; differentiable."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MatmulTiled.apply(x, w)
    return _matmul(x, w)


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ref.matmul_reference(x, w)
    return _launch(x, w)


class _MatmulTiled(torch.autograd.Function):
    """The kernel with its VJP: dX and dW through the same kernel."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = _matmul(g, w.t().contiguous()) if ctx.needs_input_grad[0] else None
        dw = _matmul(x.t().contiguous(), g) if ctx.needs_input_grad[1] else None
        return dx, dw


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    lib.require_cuda(NAME, x, w)
    code = lib.require_dtype(NAME, x, w)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{NAME}: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{NAME}: row-major contiguous operands required")
    T, D = x.shape
    F = w.shape[1]
    out = torch.empty((T, F), dtype=x.dtype, device=x.device)
    splits, n_ws = _plan(code, T, D, F, lib.sm_count(x.device))
    # split-K partials, summed in order by the kernel's second pass
    part = (torch.empty(n_ws, dtype=torch.float32, device=x.device)
            if n_ws else None)
    err = lib.load().famous_matmul_tiled(
        code, x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), splits, T, D, F,
        lib.stream_of(x))
    lib.check(NAME, err, part)
    lib.STATS.launches[NAME] += 1
    return out


@functools.lru_cache(maxsize=None)
def _plan(code: int, T: int, D: int, F: int, sms: int) -> tuple[int, int]:
    """The kernel's split-K count for a static shape (1: no split) and
    the f32 elements of its partials' workspace (0: none)."""
    return lib.plan("famous_matmul_tiled_plan", code, T, D, F, sms)


@functools.lru_cache(maxsize=None)
def _plan_int8(T: int, D: int, F: int, sms: int) -> tuple[int, int]:
    """The int8 kernel's split-K count for a static shape (1: no split)
    and the int32 elements of its partials' workspace (0: none)."""
    return lib.plan("famous_matmul_tiled_int8_plan", T, D, F, sms)


def matmul_tiled_int8(xq: torch.Tensor, wqt: torch.Tensor, sx: torch.Tensor,
                      sw: torch.Tensor) -> torch.Tensor:
    """xq: (T, D) int8; wqt: (F, D) int8, the quantized W transposed; sx:
    (T, 1) and sw: (1, F) f32 scales.  Returns (T, F) f32
    ``(xq @ wqt.T) * sx * sw``."""
    if xq.device.type == "cpu" and wqt.device.type == "cpu":
        return ref.matmul_int8_reference(xq, wqt.t(), sx, sw)
    return _launch_int8(xq, wqt, sx, sw)


def _launch_int8(xq, wqt, sx, sw):
    lib.require_cuda(NAME_INT8, xq, wqt, sx, sw)
    if xq.dtype != torch.int8 or wqt.dtype != torch.int8:
        raise ValueError(f"{NAME_INT8}: int8 operands, got {xq.dtype}, "
                         f"{wqt.dtype}")
    if xq.ndim != 2 or wqt.ndim != 2 or xq.shape[1] != wqt.shape[1]:
        raise ValueError(f"{NAME_INT8}: shapes {tuple(xq.shape)} @ "
                         f"{tuple(wqt.shape)}^T")
    T, D = xq.shape
    F = wqt.shape[0]
    if (sx.dtype != torch.float32 or sw.dtype != torch.float32
            or sx.numel() != T or sw.numel() != F):
        raise ValueError(f"{NAME_INT8}: f32 scales of {T} and {F} entries, "
                         f"got {sx.dtype} {tuple(sx.shape)}, {sw.dtype} "
                         f"{tuple(sw.shape)}")
    if not all(t.is_contiguous() for t in (xq, wqt, sx, sw)):
        raise ValueError(f"{NAME_INT8}: contiguous operands required")
    out = torch.empty((T, F), dtype=torch.float32, device=xq.device)
    splits, n_ws = _plan_int8(T, D, F, lib.sm_count(xq.device))
    # split-K int32 partials, added in order by the kernel's second pass
    part = (torch.empty(n_ws, dtype=torch.int32, device=xq.device)
            if n_ws else None)
    err = lib.load().famous_matmul_tiled_int8(
        xq.data_ptr(), wqt.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), splits,
        T, D, F, lib.stream_of(xq))
    lib.check(NAME_INT8, err, part)
    lib.STATS.launches[NAME_INT8] += 1
    return out
