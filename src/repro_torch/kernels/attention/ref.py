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
(``lib.STATS.plain_on_cuda`` counts any such call).

:func:`mha_forward_tc_reference`, :func:`mha_bwd_dq_tc_reference` and
:func:`mha_bwd_dkv_tc_reference` restate the same three functions as the
bf16 tensor-core kernels compute them (blocks, tiles, splits and the
roundings to bf16), for the tests and ``chip_smoke.py`` only;
:func:`dq_runs` and :func:`dkv_runs` enumerate the runs the two backward
kernels cut their sums into, whose lengths their plans cap at
:data:`DQ_RUN_KEYS` keys and :data:`DKV_RUN_ROWS` query rows
(:func:`dkv_run_items` items of a geometry's rows).  The same functions
express the geometries above head dim 128 (``mha.dq_tiles``,
``mha.dkv_tiles``): those kernels split the head dim's columns across
warps, which changes no sum."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode import ref as dec_ref
from repro_torch.kernels.lib import STATS

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# the longest run of the tensor-core backward kernels' plans: keys a dq run
# (mha_bwd_dq.cu's kDqRunKeys), query rows a dk/dv run (mha_bwd_dkv.cu's
# kDkvRunRows: 64 items of 64 rows)
DQ_RUN_KEYS = 4096
DKV_RUN_ROWS = 4096


def dkv_run_items(block_q: int = 64) -> int:
    """The longest dk/dv run in work items of ``block_q`` rows."""
    return DKV_RUN_ROWS // block_q


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


def mha_forward_tc_reference(q, k, v, *, causal: bool, window: int,
                             scale: float, q_offset: int, splits: int = 1,
                             block_rows: int = 128, tile_keys: int = 64,
                             round_out: bool = True):
    """The bf16 tensor-core forward's algebra, in f32: the chunk kernels'
    mirror (``decode/ref.chunk_prefill_tc_reference``) on the flat query
    side, as ``chunk_tc.cuh`` runs the same body.  Each query head's rows
    go in blocks of ``block_rows``; a block's keys start at its first row's
    window tile and end at its last row's diagonal (causal; else at Skv),
    cut into tiles of ``tile_keys`` shared by ``splits`` blocks; per tile
    the scale after Q K^T, masks at -1e30, the online update in log2 units
    with an f32 l and, for bf16 inputs, P rounded to bf16 for P V; splits
    combine in order.  Returns (O / max(l, 1e-30) in q's dtype, or in f32
    without ``round_out`` (the value the kernel rounds once on the way
    out), and the f32 LSE max m ln 2 + log(l), or -1e30 where l = 0)."""
    if q.is_cuda:
        STATS.plain_on_cuda["mha_forward"] += 1
    BH, Sq, dh = q.shape
    BKV, Skv, _ = k.shape
    g = BH // BKV

    def keys(k0, k1):
        return (k[:, k0:k1, None].to(torch.float32),
                v[:, k0:k1, None].to(torch.float32), None, None)

    # the flat rows (BKV, g, Sq) as the chunk layout (B, C, H) over one kv
    # head each
    out, lse = dec_ref._chunk_tc(
        q.reshape(BKV, g, Sq, dh).transpose(1, 2), keys, Skv, 1, q_offset,
        scale, splits, block_rows, tile_keys, causal=causal, window=window,
        round_out=round_out)
    return (out.transpose(1, 2).reshape(BH, Sq, dh),
            lse.transpose(1, 2).reshape(BH, Sq))


def _hi_lo(x):
    """x as the sum of two bf16 values (hi = bf16(x), lo = bf16(x - hi)),
    each back in f32."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def dkv_runs(Sq: int, Skv: int, group: int, *, causal: bool, window: int,
             q_offset: int, splits: int, block_keys: int = 64,
             block_q: int = 64):
    """The bf16 dk/dv kernel's work: for each key block ``(kb0, kb1, qt_lo,
    nqt, runs)``, where the block's work items are the (query head of its
    group, query tile of ``block_q`` rows) pairs whose rows can see one of
    its keys, head-major (item ``it`` is head ``it // nqt``, tile ``qt_lo +
    it % nqt``), and run z owns items ``runs[z] = (i_lo, i_hi)``."""
    out = []
    for kb0 in range(0, Skv, block_keys):
        kb1 = min(Skv, kb0 + block_keys)
        qbeg = max(0, kb0 - q_offset) if causal else 0
        qend = min(Sq, kb1 - 1 + window - q_offset) if window > 0 else Sq
        qt_lo = qbeg // block_q
        nqt = max(0, -(-qend // block_q) - qt_lo) if qend > 0 else 0
        items = group * nqt
        ips = -(-items // splits)
        runs = []
        for z in range(splits):
            i_lo = min(items, z * ips)
            runs.append((i_lo, min(items, i_lo + ips)))
        out.append((kb0, kb1, qt_lo, nqt, runs))
    return out


def mha_bwd_dkv_tc_reference(q, k, v, dout, lse, delta, *, causal: bool,
                             window: int, scale: float, q_offset: int,
                             splits: int = 1, block_keys: int = 64,
                             block_q: int = 64):
    """The bf16 tensor-core dk/dv kernel's algebra, in f32:
    :func:`mha_bwd_dkv_reference` computed as that kernel computes it.
    Keys go in blocks of ``block_keys``; a key block's work items are the
    (query head of its group, query tile of ``block_q`` rows) pairs whose
    rows can see one of its keys, head-major, and ``splits`` runs share
    them (items [z * ips, (z + 1) * ips), ips = ceil(items / splits);
    :func:`dkv_runs`).  Per
    item: P^T = 2^(scale log2(e) S^T - log2(e) lse) on the mask (0 off it)
    with S^T = K Q^T, and dS^T = P^T (V dO^T - delta); for bf16 inputs each
    of P^T and dS^T enters its product as hi + lo (:func:`_hi_lo`), so dV
    += hi(P^T) dO + lo(P^T) dO and dK += hi(dS^T) Q + lo(dS^T) Q.  The runs'
    partials are summed in order, then dk is scaled.  Returns f32 (dk,
    dv), each (BKV, Skv, dh)."""
    if q.is_cuda:
        STATS.plain_on_cuda["mha_bwd_dkv"] += 1
    BH, Sq, dh = q.shape
    BKV, Skv, _ = k.shape
    group = BH // BKV
    split = _hi_lo if q.dtype == torch.bfloat16 else (
        lambda x: (x, torch.zeros_like(x)))
    sl = scale * LOG2E
    f = torch.float32
    qf = q.to(f).reshape(BKV, group, Sq, dh)
    of = dout.to(f).reshape(BKV, group, Sq, dh)
    lse2 = (lse.to(f) * LOG2E).reshape(BKV, group, Sq)
    dl = delta.to(f).reshape(BKV, group, Sq)
    kf, vf = k.to(f), v.to(f)
    ok_all = visible(Sq, Skv, causal=causal, window=window,
                     q_offset=q_offset, device=q.device)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for kb0, kb1, qt_lo, nqt, runs in dkv_runs(
            Sq, Skv, group, causal=causal, window=window, q_offset=q_offset,
            splits=splits, block_keys=block_keys, block_q=block_q):
        kt, vt = kf[:, kb0:kb1], vf[:, kb0:kb1]
        acc_k = torch.zeros((BKV, kb1 - kb0, dh), device=q.device)
        acc_v = torch.zeros_like(acc_k)
        for i_lo, i_hi in runs:
            pk = torch.zeros_like(acc_k)
            pv = torch.zeros_like(acc_k)
            for it in range(i_lo, i_hi):
                hg = it // nqt
                q0 = (qt_lo + it % nqt) * block_q
                q1 = min(Sq, q0 + block_q)
                qt, ot = qf[:, hg, q0:q1], of[:, hg, q0:q1]
                st = (kt @ qt.transpose(1, 2)) * sl      # (BKV, keys, rows)
                ok = ok_all[q0:q1, kb0:kb1].transpose(0, 1)
                p = torch.where(ok, torch.exp2(st - lse2[:, hg, None, q0:q1]),
                                0.0)
                ds = p * (vt @ ot.transpose(1, 2) - dl[:, hg, None, q0:q1])
                ph, plo = split(p)
                dh_, dlo = split(ds)
                pv = pv + (ph @ ot + plo @ ot)
                pk = pk + (dh_ @ qt + dlo @ qt)
            acc_k = acc_k + pk
            acc_v = acc_v + pv
        dk[:, kb0:kb1] = acc_k * scale
        dv[:, kb0:kb1] = acc_v
    return dk, dv


def dq_runs(Sq: int, Skv: int, *, causal: bool, window: int, q_offset: int,
            splits: int, block_q: int = 64, tile_keys: int = 64):
    """The bf16 dq kernel's work: for each row block of ``block_q`` rows
    ``(q0, q1, runs)``, where the block's keys [kbeg, kend) end at its last
    row's diagonal (causal; else at Skv) and start at the tile of its first
    row's window edge, cut into tiles of ``tile_keys``, and run z owns the
    keys ``runs[z] = (k_lo, k_hi)`` of tiles [t_lo, t_hi) (t_lo = tb + z *
    tps, tps = ceil(tiles / splits)), clipped to kend."""
    out = []
    for q0 in range(0, Sq, block_q):
        q1 = min(Sq, q0 + block_q)
        kend = min(Skv, q_offset + q1) if causal else Skv
        tb = (max(0, q_offset + q0 - window + 1) // tile_keys
              if window > 0 else 0)
        nt = max(tb, -(-kend // tile_keys))
        tps = -(-(nt - tb) // splits)
        runs = []
        for z in range(splits):
            t_lo = min(nt, tb + z * tps)
            t_hi = min(nt, t_lo + tps)
            runs.append((t_lo * tile_keys, min(kend, t_hi * tile_keys)))
        out.append((q0, q1, runs))
    return out


def mha_bwd_dq_tc_reference(q, k, v, dout, lse, delta, *, causal: bool,
                            window: int, scale: float, q_offset: int,
                            splits: int = 1, block_q: int = 64,
                            tile_keys: int = 64):
    """The bf16 tensor-core dq kernel's algebra, in f32:
    :func:`mha_bwd_dq_reference` computed as that kernel computes it.  Each
    query head's rows go in blocks of ``block_q``; a block's key tiles are
    cut into ``splits`` ordered runs (:func:`dq_runs`).  Per run: P = 2^(
    scale log2(e) S - log2(e) lse) on the mask (0 off it) with S = Q K^T,
    dS = P (dO V^T - delta); for bf16 inputs dS enters dS K as hi + lo
    (:func:`_hi_lo`), so the run's partial is hi(dS) K + lo(dS) K.  The
    runs' partials are summed in order, then scaled.  Returns f32 dq (BH,
    Sq, dh)."""
    if q.is_cuda:
        STATS.plain_on_cuda["mha_bwd_dq"] += 1
    BH, Sq, dh = q.shape
    Skv = k.shape[1]
    group = BH // k.shape[0]
    split = _hi_lo if q.dtype == torch.bfloat16 else (
        lambda x: (x, torch.zeros_like(x)))
    sl = scale * LOG2E
    f = torch.float32
    qf, of = q.to(f), dout.to(f)
    kf, vf = _expand(k, group), _expand(v, group)
    lse2 = lse.to(f) * LOG2E
    dl = delta.to(f)
    ok_all = visible(Sq, Skv, causal=causal, window=window,
                     q_offset=q_offset, device=q.device)
    dq = torch.empty_like(qf)
    for q0, q1, runs in dq_runs(Sq, Skv, causal=causal, window=window,
                                q_offset=q_offset, splits=splits,
                                block_q=block_q, tile_keys=tile_keys):
        qt, ot = qf[:, q0:q1], of[:, q0:q1]
        acc = torch.zeros((BH, q1 - q0, dh), device=q.device)
        for k0, k1 in runs:
            if k1 <= k0:
                continue    # an empty run's partial is 0
            kt, vt = kf[:, k0:k1], vf[:, k0:k1]
            st = (qt @ kt.transpose(1, 2)) * sl          # (BH, rows, keys)
            p = torch.where(ok_all[q0:q1, k0:k1],
                            torch.exp2(st - lse2[:, q0:q1, None]), 0.0)
            ds = p * (ot @ vt.transpose(1, 2) - dl[:, q0:q1, None])
            hi, lo = split(ds)
            acc = acc + (hi @ kt + lo @ kt)
        dq[:, q0:q1] = acc * scale
    return dq
