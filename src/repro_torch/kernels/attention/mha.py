"""Fused MHA kernel wrappers: the FAMOUS QK_PM -> softmax -> SV_PM forward
and its flash backward, on the flat ``(B·H, S, dh)`` layout.

On CUDA tensors ``mha_forward`` launches the hand-written kernel of
``kernels/csrc/mha_forward.cu`` (the port of the Pallas ``_mha_kernel`` in
``repro/kernels/attention/mha.py``), and ``mha_backward`` computes
``delta = sum_d dO * O`` and runs ``mha_bwd_dq`` and ``mha_bwd_dkv``,
which launch ``kernels/csrc/mha_bwd_dq.cu`` and
``kernels/csrc/mha_bwd_dkv.cu`` (the ports of ``_mha_bwd_dq_kernel`` and
``_mha_bwd_dkv_kernel``).  Each block
walks its own key (or query) tiles, so the block sizes need not divide the
sequence lengths, and the dk/dv kernel sums over the GQA group itself.
``causal``, ``window`` and ``q_offset`` are plain launch arguments.  On CPU
tensors both run the plain versions in
:mod:`repro_torch.kernels.attention.ref`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import lib
from repro_torch.kernels.attention import ref

MAX_HEAD_DIM = 128


def _scale(scale, dh):
    return float(scale) if scale is not None else 1.0 / math.sqrt(dh)


def mha_forward(q, k, v, *, causal: bool = True, window: int = 0,
                scale: float | None = None, q_offset: int = 0,
                return_lse: bool = False):
    """q: (BH, Sq, dh); k, v: (BKV, Skv, dh) with BH = BKV * group.
    Returns (BH, Sq, dh) in q's dtype, plus the f32 row log-sum-exp
    (BH, Sq) when ``return_lse`` (the flash backward residual)."""
    args = dict(causal=bool(causal), window=int(window),
                scale=_scale(scale, q.shape[-1]), q_offset=int(q_offset))
    if q.device.type == "cpu":
        out, lse = ref.mha_forward_reference(q, k, v, **args)
    else:
        out, lse = _launch_forward(q, k, v, **args)
    return (out, lse) if return_lse else out


def mha_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                 window: int = 0, scale: float | None = None,
                 q_offset: int = 0):
    """Flash backward.  q/out/dout: (BH, Sq, dh); k, v: (BKV, Skv, dh);
    lse: (BH, Sq) f32.  Returns f32 (dq (BH, Sq, dh), dk, dv (BKV, Skv,
    dh)), the GQA group sum already taken."""
    args = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    # D_i = sum_d dO_i * O_i, once, outside the kernels (as in JAX)
    delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(-1)
    lse = lse.to(torch.float32)
    return (mha_bwd_dq(q, k, v, dout, lse, delta, **args),
            *mha_bwd_dkv(q, k, v, dout, lse, delta, **args))


def mha_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
               window: int = 0, scale: float | None = None,
               q_offset: int = 0):
    """The dq kernel: f32 dq (BH, Sq, dh) from the saved LSE and
    ``delta = sum_d dO * O`` (both (BH, Sq) f32)."""
    args = dict(causal=bool(causal), window=int(window),
                scale=_scale(scale, q.shape[-1]), q_offset=int(q_offset))
    if q.device.type == "cpu":
        return ref.mha_bwd_dq_reference(q, k, v, dout, lse, delta, **args)
    return _launch_dq(q, k, v, dout, lse, delta, **args)


def mha_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                window: int = 0, scale: float | None = None,
                q_offset: int = 0):
    """The dk/dv kernel: f32 (dk, dv), each (BKV, Skv, dh), summed over
    each kv head's group of query heads."""
    args = dict(causal=bool(causal), window=int(window),
                scale=_scale(scale, q.shape[-1]), q_offset=int(q_offset))
    if q.device.type == "cpu":
        return ref.mha_bwd_dkv_reference(q, k, v, dout, lse, delta, **args)
    return _launch_dkv(q, k, v, dout, lse, delta, **args)


def _check(name, q, k, v, *rows):
    """Device, dtype, shape and layout checks of the launch path; returns
    (dtype code, BH, BKV, Sq, Skv, dh)."""
    lib.require_cuda(name, q, k, v, *rows)
    code = lib.require_dtype(name, q, k, v, *rows[:1])
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    BH, Sq, dh = q.shape
    BKV, Skv, _ = k.shape
    if k.shape[2] != dh or BKV == 0 or BH % BKV or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: q {tuple(q.shape)} against kv "
                         f"{tuple(k.shape)} (head dim at most "
                         f"{MAX_HEAD_DIM}, BH a multiple of BKV)")
    for t in (q, k, v, *rows):
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous operands required")
    return code, BH, BKV, Sq, Skv, dh


def _launch_forward(q, k, v, *, causal, window, scale, q_offset):
    name = "mha_forward"
    code, BH, BKV, Sq, Skv, dh = _check(name, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    err = lib.load().famous_mha_forward(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), BH, BKV, Sq, Skv, dh, int(causal), window, q_offset,
        scale, lib.stream_of(q))
    lib.check(name, err)
    lib.STATS.launches[name] += 1
    return out, lse


def _check_bwd(name, q, k, v, dout, lse, delta):
    """:func:`_check` plus the backward's cotangent and f32 row inputs."""
    dims = _check(name, q, k, v, dout, lse, delta)
    BH, Sq = dims[1], dims[3]
    if dout.shape != q.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} vs q "
                         f"{tuple(q.shape)}")
    for t in (lse, delta):
        if t.dtype != torch.float32 or t.shape != (BH, Sq):
            raise ValueError(f"{name}: lse/delta must be f32 ({BH}, {Sq}), "
                             f"got {t.dtype} {tuple(t.shape)}")
    return dims


def _launch_dq(q, k, v, dout, lse, delta, *, causal, window, scale,
               q_offset):
    name = "mha_bwd_dq"
    code, BH, BKV, Sq, Skv, dh = _check_bwd(name, q, k, v, dout, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = lib.load().famous_mha_bwd_dq(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, BKV, Sq, Skv,
        dh, int(causal), window, q_offset, scale, lib.stream_of(q))
    lib.check(name, err)
    lib.STATS.launches[name] += 1
    return dq


def _launch_dkv(q, k, v, dout, lse, delta, *, causal, window, scale,
                q_offset):
    name = "mha_bwd_dkv"
    code, BH, BKV, Sq, Skv, dh = _check_bwd(name, q, k, v, dout, lse, delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    err = lib.load().famous_mha_bwd_dkv(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH,
        BKV, Sq, Skv, dh, int(causal), window, q_offset, scale,
        lib.stream_of(q))
    lib.check(name, err)
    lib.STATS.launches[name] += 1
    return dk, dv
