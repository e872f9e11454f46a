"""Plain PyTorch versions of the fused MHA kernels (the FAMOUS QK_PM ->
softmax -> SV_PM forward and its two flash-backward kernels), at the
kernels' flat ``(B·H, S, dh)`` / ``(B·KV, S, dh)`` layout.

:func:`mha_reference` is the materialised-S oracle (a port of
``repro.kernels.attention.ref``).  The other three repeat the kernels'
arithmetic densely in f32: masked scores at -1e30, ``l`` clamped at 1e-30
(a row with no visible key gives 0 and an LSE of about -1e30), and the
backward's probabilities recomputed from the saved LSE, with the scale
placed where the TPU kernels place it.  The kernel wrappers run them for
tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernels against them
on the card.  The training path never calls them on CUDA tensors
(``lib.STATS.plain_on_cuda`` counts any such call)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.lib import STATS

NEG_INF = -1e30


def visible(Sq: int, Skv: int, *, causal: bool, window: int, q_offset: int,
            device) -> torch.Tensor:
    """(Sq, Skv) bool: key j is visible to query i (at absolute position
    ``q_offset + i``), the TPU kernels' ``_tile_mask``."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Skv, device=device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    return ok


def _expand(x: torch.Tensor, group: int) -> torch.Tensor:
    """(BKV, S, dh) -> (BH, S, dh) f32: row bh reads kv row bh // group."""
    return x.to(torch.float32).repeat_interleave(group, dim=0)


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None, q_offset: int = 0):
    """q: (BH, Sq, dh); k, v: (BKV, Skv, dh), BH = BKV * group.
    Materialised-S softmax attention; a fully masked row gives 0."""
    BH, Sq, dh = q.shape
    group = BH // k.shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    s = (q.to(torch.float32) @ _expand(k, group).transpose(1, 2)) * scale
    ok = visible(Sq, k.shape[1], causal=causal, window=window,
                 q_offset=q_offset, device=q.device)
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    return (p @ _expand(v, group)).to(q.dtype)


def mha_forward_reference(q, k, v, *, causal: bool, window: int,
                          scale: float, q_offset: int):
    """The forward kernel's function: returns (out (BH, Sq, dh) in q's
    dtype, lse (BH, Sq) f32)."""
    if q.is_cuda:
        STATS.plain_on_cuda["mha_forward"] += 1
    BH, Sq, dh = q.shape
    group = BH // k.shape[0]
    s = (q.to(torch.float32) * scale) @ _expand(k, group).transpose(1, 2)
    ok = visible(Sq, k.shape[1], causal=causal, window=window,
                 q_offset=q_offset, device=q.device)
    s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (p @ _expand(v, group)) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, dout, lse, delta, *, causal, window, scale,
                  q_offset):
    """Recomputed P and dS = P * (dO V^T - delta), (BH, Sq, Skv) f32."""
    BH, Sq, _ = q.shape
    group = BH // k.shape[0]
    s = (q.to(torch.float32) @ _expand(k, group).transpose(1, 2)) * scale
    ok = visible(Sq, k.shape[1], causal=causal, window=window,
                 q_offset=q_offset, device=q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = dout.to(torch.float32) @ _expand(v, group).transpose(1, 2)
    return p, p * (dp - delta[..., None])


def mha_bwd_dq_reference(q, k, v, dout, lse, delta, *, causal: bool,
                         window: int, scale: float, q_offset: int):
    """The dq kernel's function: dq = scale * dS K, (BH, Sq, dh) f32."""
    if q.is_cuda:
        STATS.plain_on_cuda["mha_bwd_dq"] += 1
    group = q.shape[0] // k.shape[0]
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal=causal,
                          window=window, scale=scale, q_offset=q_offset)
    return (ds @ _expand(k, group)) * scale


def mha_bwd_dkv_reference(q, k, v, dout, lse, delta, *, causal: bool,
                          window: int, scale: float, q_offset: int):
    """The dk/dv kernel's function: per query head dv = P^T dO and
    dk = scale * dS^T Q, summed over each kv head's group.  Returns f32
    (dk, dv), each (BKV, Skv, dh)."""
    if q.is_cuda:
        STATS.plain_on_cuda["mha_bwd_dkv"] += 1
    BKV, Skv, dh = k.shape
    group = q.shape[0] // BKV
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal=causal,
                          window=window, scale=scale, q_offset=q_offset)
    dv = p.transpose(1, 2) @ dout.to(torch.float32)
    dk = (ds.transpose(1, 2) @ q.to(torch.float32)) * scale
    return (dk.reshape(BKV, group, Skv, dh).sum(1),
            dv.reshape(BKV, group, Skv, dh).sum(1))
