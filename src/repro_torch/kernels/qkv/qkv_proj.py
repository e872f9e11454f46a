"""Tiled QKV-projection kernel wrapper — FAMOUS Algorithm 1 on Hopper.

``matmul_tiled`` computes X(T, D) @ W(D, F) with an f32 accumulator and one
cast to the operands' dtype.  On CUDA tensors it launches the hand-written
kernel of ``kernels/csrc/matmul_tiled.cu`` (the port of the Pallas
``_proj_kernel`` in ``repro/kernels/qkv/qkv_proj.py``); on CPU tensors it
runs the plain version in :mod:`repro_torch.kernels.qkv.ref`.

Differentiable, as the JAX custom VJP is: the backward of a matmul is two
matmuls, and both run through the same kernel (or the same plain version
on the CPU): dX = g·Wᵀ is (T, F) @ (F, D) and dW = Xᵀ·g is (D, T) @ (T, F).
The transposed operands are contiguous copies, not a strided kernel
argument: the kernel's tile loads are coalesced along the contiguous dim,
which a transposed view would turn into a stride of D (or T) between
neighbouring threads, and one copy of W or X is one pass over T·D or D·F
elements against the product's T·D·F multiply-adds.  A call that needs no
gradient (the serving path) launches the kernel directly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lib
from repro_torch.kernels.qkv import ref

NAME = "matmul_tiled"


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
    so = lib.load()
    err = so.famous_matmul_tiled(code, x.data_ptr(), w.data_ptr(),
                                 out.data_ptr(), T, D, F, lib.stream_of(x))
    lib.check(NAME, err)
    lib.STATS.launches[NAME] += 1
    return out
