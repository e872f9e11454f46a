"""Plain PyTorch versions of the linear-recurrence kernels, at the kernels'
own layouts: straight sequential scans (the ground truth, as
``repro.kernels.scan.ref``) and the chunked wkv6 form the kernel computes.

The kernel wrappers run :func:`rglru_reference` and
:func:`wkv6_chunked_reference` for tensors on the CPU; ``chip_smoke.py``
holds the CUDA kernels against them on the card.  The serving path never
calls them on CUDA tensors (``lib.STATS.plain_on_cuda`` counts any such
call)."""
from __future__ import annotations

import torch

from repro_torch.kernels.lib import STATS

f32 = torch.float32


def _count(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        STATS.plain_on_cuda[name] += 1


def rglru_reference(a, b):
    """h_t = a_t h_{t-1} + b_t from h = 0; a, b: (B, S, R) -> (B, S, R)
    f32."""
    _count("rglru_scan", a)
    a, b = a.to(f32), b.to(f32)
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def wkv6_reference(r, k, v, logw, u):
    """Sequential wkv6 from a zero state. r, k, v, logw: (BH, S, dh); u:
    (BH, dh).  Returns (BH, S, dh) f32:
    ``out_t = r_t (S_{t-1} + diag(u) k_t v_tᵀ)``, ``S_t = diag(exp(logw_t))
    S_{t-1} + k_t v_tᵀ``."""
    _count("wkv6_scan", r)
    r, k, v, logw, u = (x.to(f32) for x in (r, k, v, logw, u))
    BH, S, dh = r.shape
    s = torch.zeros((BH, dh, dh), dtype=f32, device=r.device)
    out = torch.empty_like(r)
    for t in range(S):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out[:, t] = torch.einsum("bd,bde->be", r[:, t], s + u[..., None] * kv)
        s = torch.exp(logw[:, t])[..., None] * s + kv
    return out


def wkv6_chunked_reference(r, k, v, logw, u, s0=None, chunk: int = 64):
    """The chunked wkv6 of ``repro.models.rwkv6.wkv6_chunked`` (and of the
    Pallas kernel) at the kernel's layout.  r, k, v, logw: (BH, S, dh) with
    logw <= 0; u: (BH, dh); s0: optional (BH, dh, dh) carried state.
    Returns (out (BH, S, dh) f32, s_final (BH, dh, dh) f32).  Within a
    chunk of C steps the decays become cumulative log-decay masks and the
    work dense products; the state crosses chunks."""
    _count("wkv6_scan", r)
    BH, S, dh = r.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"wkv6: S={S} is not a multiple of chunk={chunk}")
    r, k, v, logw, u = (x.to(f32) for x in (r, k, v, logw, u))
    s = (torch.zeros((BH, dh, dh), dtype=f32, device=r.device) if s0 is None
         else s0.to(f32))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=r.device),
                     diagonal=-1)                          # strict lower
    out = torch.empty_like(r)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        rb, kb, vb, wb = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        cw = torch.cumsum(wb, dim=1)                       # inclusive logW_t
        cw_prev = cw - wb
        qexp = rb * torch.exp(cw_prev)
        inter = qexp @ s
        kexp = kb * torch.exp(-cw)
        att = (qexp @ kexp.transpose(1, 2)) * tri          # (BH, C, C)
        diag = ((rb * u[:, None, :]) * kb).sum(-1)         # (BH, C)
        intra = att @ vb + diag[..., None] * vb
        out[:, sl] = inter + intra
        k_dec = kb * torch.exp(cw[:, -1:, :] - cw)
        s = torch.exp(cw[:, -1])[..., None] * s + k_dec.transpose(1, 2) @ vb
    return out, s
