"""Linear-recurrence kernel wrappers (RG-LRU and RWKV-6 wkv).

``rglru_scan`` computes h_t = a_t ⊙ h_{t-1} + b_t over (B, S, R) from a
zero state.  On CUDA tensors it launches the hand-written kernel of
``kernels/csrc/rglru_scan.cu`` (the port of the Pallas ``_rglru_kernel`` in
``repro/kernels/scan/linear_scan.py``): blocks of features by time
segments, every segment's loads in flight at once, the segments running
the recurrence in order, bit-equal to the plain version.

``wkv6_scan`` computes the RWKV-6 wkv recurrence in chunked form over
(BH, S, dh), from an optional carried state ``s0``, and returns the output
and the final state.  On CUDA tensors it launches
``kernels/csrc/wkv6_scan.cu`` (the port of the Pallas ``_wkv6_kernel``):
a first pass over every (batch·head, chunk) does the state-free work of
each chunk into an f32 workspace allocated here (sized by the kernel's C
plan, :func:`wkv6_plan`), and a second pass per (batch·head, value
columns) walks the chunks in order through the state; every product an
exact f32 multiply-add.

On CPU tensors both run their plain versions in
:mod:`repro_torch.kernels.scan.ref`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import lib
from repro_torch.kernels.scan import ref

RGLRU = "rglru_scan"
WKV6 = "wkv6_scan"
WKV6_MAX = 64   # the kernel's largest chunk and head dim


def wkv6_workspace_elems(BH: int, S: int, dh: int, chunk: int) -> int:
    """The f32 workspace of one ``wkv6_scan`` launch, as its C plan sizes
    it: per (batch·head, chunk) the chunk's state increment (dh x dh), its
    decay exp(cw_C) (dh) and qexp transposed (dh x chunk), which the
    first pass writes and the second reads."""
    return BH * (S // chunk) * (dh * dh + dh + chunk * dh)


@functools.lru_cache(maxsize=None)
def wkv6_plan(BH: int, S: int, dh: int, chunk: int) -> tuple[int, int]:
    """The kernel's plan for a static shape: (chunks a batch·head, f32
    workspace elements)."""
    return lib.plan("famous_wkv6_scan_plan", BH, S, dh, chunk)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, R) -> h: (B, S, R) f32 with h_t = a_t h_{t-1} + b_t,
    h_{-1} = 0."""
    if a.device.type == "cpu":
        return ref.rglru_reference(a, b)
    lib.require_cuda(RGLRU, a, b)
    code = lib.require_dtype(RGLRU, a, b)
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"{RGLRU}: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{RGLRU}: contiguous operands required")
    B, S, R = a.shape
    out = torch.empty((B, S, R), dtype=torch.float32, device=a.device)
    err = lib.load().famous_rglru_scan(code, a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), B, S, R,
                                       lib.stream_of(a))
    lib.check(RGLRU, err)
    lib.STATS.launches[RGLRU] += 1
    return out


def wkv6_scan(r, k, v, logw, u, s0=None, *, chunk: int = 64):
    """r, k, v, logw: (BH, S, dh) with logw <= 0; u: (BH, dh); s0: optional
    (BH, dh, dh) f32 carried state.  Returns (out (BH, S, dh) f32, s_final
    (BH, dh, dh) f32).  ``chunk`` is clamped to S and must divide it."""
    if r.device.type == "cpu":
        return ref.wkv6_chunked_reference(r, k, v, logw, u, s0, chunk=chunk)
    extra = (s0,) if s0 is not None else ()
    lib.require_cuda(WKV6, r, k, v, logw, u, *extra)
    code = lib.require_dtype(WKV6, r, k, v)
    wcode = lib.require_dtype(WKV6, logw)
    if r.ndim != 3:
        raise ValueError(f"{WKV6}: r {tuple(r.shape)} is not (BH, S, dh)")
    BH, S, dh = r.shape
    chunk = min(chunk, S)
    if (k.shape != r.shape or v.shape != r.shape
            or logw.shape != r.shape or u.shape != (BH, dh)
            or (s0 is not None and s0.shape != (BH, dh, dh))):
        raise ValueError(f"{WKV6}: r/k/v/logw {tuple(r.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)}/"
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}, s0 "
                         f"{None if s0 is None else tuple(s0.shape)}")
    if dh > WKV6_MAX or chunk > WKV6_MAX or chunk < 1 or S % chunk:
        raise ValueError(f"{WKV6}: dh={dh} and chunk={chunk} must be at most "
                         f"{WKV6_MAX}, and chunk must divide S={S}")
    if u.dtype != torch.float32 or (s0 is not None
                                    and s0.dtype != torch.float32):
        raise ValueError(f"{WKV6}: u and s0 must be float32")
    if not all(x.is_contiguous() for x in (r, k, v, logw, u, *extra)):
        raise ValueError(f"{WKV6}: contiguous operands required")
    out = torch.empty((BH, S, dh), dtype=torch.float32, device=r.device)
    s_final = torch.empty((BH, dh, dh), dtype=torch.float32, device=r.device)
    _, n_ws = wkv6_plan(BH, S, dh, chunk)
    ws = torch.empty(n_ws, dtype=torch.float32, device=r.device)
    err = lib.load().famous_wkv6_scan(
        code, wcode, r.data_ptr(), k.data_ptr(), v.data_ptr(),
        logw.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), out.data_ptr(),
        s_final.data_ptr(), ws.data_ptr(), BH, S, dh, chunk,
        lib.stream_of(r))
    lib.check(WKV6, err, ws)
    lib.STATS.launches[WKV6] += 1
    return out, s_final
