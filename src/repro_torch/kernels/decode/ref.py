"""Plain PyTorch versions of the decode and chunked-prefill attention
kernels, contiguous and paged (fp and int8 pools), at the kernels' own
layouts.

The kernel wrappers run them for tensors on the CPU; ``chip_smoke.py`` holds
the CUDA kernels against them on the card.  Like the kernels they give a
row with no visible key an output of 0 (the dense ``famous`` oracles give
NaN there).  The serving path never calls them on CUDA tensors
(``lib.STATS.plain_on_cuda`` counts any such call)."""
from __future__ import annotations

import torch

from repro_torch.kernels.lib import STATS


def _softmax_pv(s: torch.Tensor, ok: torch.Tensor, v: torch.Tensor):
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    return p @ v


def _count(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        STATS.plain_on_cuda[name] += 1


def slot_rows(x: torch.Tensor, slot) -> torch.Tensor:
    """Row ``slot`` of ``x``'s leading axis, kept as a leading axis of 1
    (a gather, never a host read of a tensor ``slot``), or ``x`` itself
    when ``slot`` is None.  ``slot``: an int or a one-element int
    tensor."""
    if slot is None:
        return x
    idx = torch.as_tensor(slot, device=x.device).reshape(1).to(torch.int64)
    return x.index_select(0, idx)


def chunk_positions(q_offset, n: int, device) -> torch.Tensor:
    """Positions [q_offset, q_offset + n): ``q_offset`` an int or a
    one-element int tensor, added on the device."""
    off = torch.as_tensor(q_offset, device=device).reshape(-1)
    return off.to(torch.int64) + torch.arange(n, device=device)


def decode_reference(q, k_cache, v_cache, cache_len, *, scale: float,
                     rows_per_slot: int = 1):
    """q: (R, H, dh); caches: (R / rows_per_slot, Skv, KV, dh); cache_len:
    (R,) int.  Returns (R, H, dh): row r, query head h attends kv head
    h // (H // KV) of slot r // rows_per_slot at positions < cache_len[r]."""
    _count("decode_attention", q)
    if rows_per_slot > 1:
        k_cache = k_cache.repeat_interleave(rows_per_slot, dim=0)
        v_cache = v_cache.repeat_interleave(rows_per_slot, dim=0)
    return _decode(q, k_cache, v_cache, cache_len, scale)


def _decode(q, k_cache, v_cache, cache_len, scale):
    B, H, dh = q.shape
    Skv, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qf = q.to(torch.float32).reshape(B, KV, g, dh) * scale
    kf = k_cache.to(torch.float32).permute(0, 2, 3, 1)        # (B, KV, dh, Skv)
    vf = v_cache.to(torch.float32).permute(0, 2, 1, 3)        # (B, KV, Skv, dh)
    s = qf @ kf                                               # (B, KV, g, Skv)
    pos = torch.arange(Skv, device=q.device)
    ok = (pos[None, :] < cache_len.to(q.device)[:, None])[:, None, None, :]
    out = _softmax_pv(s, ok, vf)                              # (B, KV, g, dh)
    return out.reshape(B, H, dh).to(q.dtype)


def decode_split_reference(q, k_cache, v_cache, cache_len, *, scale: float,
                           keys_per_split: int, rows_per_slot: int = 1,
                           stream_tiles: tuple[int, int] | None = None):
    """The contiguous decode kernel's split-and-combine algebra, in f32:
    :func:`decode_reference` computed as the kernel computes it.  The key
    axis is cut into ranges of ``keys_per_split`` keys; each range that
    starts below a row's length gives a partial (m, l, acc): the max of its
    live scores, the sum of exp(s - m) and exp(s - m) @ V.  The live ranges
    are then combined in order, ``M = max m_s``, ``out = sum e^(m_s - M)
    acc_s / max(sum e^(m_s - M) l_s, 1e-30)``; a row with no live range
    (length 0) comes out exactly 0.

    ``stream_tiles`` = (W, TK): the stream design's partials
    (``decode_stream_kernel``, the launches :func:`decode_attn.design`
    names "stream"): the range is cut into tiles of TK keys, warp w takes
    tiles w, w + W, ... as an online softmax, and the W warps' partials
    are merged in warp order (:func:`_stream_partial`).  None: the split
    design's one softmax over the range.  Used by the tests and
    ``chip_smoke.py`` only, never on the serving path."""
    _count("decode_attention", q)
    if rows_per_slot > 1:
        k_cache = k_cache.repeat_interleave(rows_per_slot, dim=0)
        v_cache = v_cache.repeat_interleave(rows_per_slot, dim=0)

    def keys(lo, hi):
        return (k_cache[:, lo:hi].to(torch.float32),
                v_cache[:, lo:hi].to(torch.float32))

    return _split_combine(q, keys, cache_len, k_cache.shape[1],
                          keys_per_split, scale, stream_tiles)


def paged_decode_split_reference(q, k_pages, v_pages, page_table, cache_len,
                                 *, scale: float, keys_per_split: int,
                                 rows_per_slot: int = 1, k_scale=None,
                                 v_scale=None):
    """The paged decode kernels' split-and-combine algebra, in f32: the
    algebra of :func:`decode_split_reference`, each range's keys read
    through the page table as the kernels read them.  Row r reads slot
    ``r // rows_per_slot``'s row of ``page_table`` ((slots, n_p) page ids
    into (n_pages, page_size, KV, dh) pools); an id outside [0, n_pages)
    reads the null page 0; with ``k_scale``/``v_scale`` (f32 (n_pages,
    page_size, KV)) the pools are int8 and each row is dequantized, int8
    times its scale, before any product.  Used by the tests and
    ``chip_smoke.py`` only, never on the serving path."""
    _count("paged_decode_attention" + ("" if k_scale is None else "_int8"),
           q)
    n_pages, ps = k_pages.shape[:2]
    pt = page_table.to(device=q.device, dtype=torch.long)
    pt = pt.repeat_interleave(rows_per_slot, dim=0)
    pt = torch.where((pt >= 0) & (pt < n_pages), pt, 0)

    def rows(pool, scales, pos):
        ids, off = pt[:, pos // ps], pos % ps                 # (R, n)
        x = pool[ids, off].to(torch.float32)                  # (R, n, KV, dh)
        return x if scales is None else x * scales[ids, off][..., None]

    def keys(lo, hi):
        pos = torch.arange(lo, hi, device=q.device)
        return rows(k_pages, k_scale, pos), rows(v_pages, v_scale, pos)

    return _split_combine(q, keys, cache_len, pt.shape[1] * ps,
                          keys_per_split, scale)


def _split_combine(q, keys, cache_len, Skv, L, scale, stream_tiles=None):
    """Partials over ranges of L keys and their ordered combine (see
    :func:`decode_split_reference`); ``keys(lo, hi)`` gives the range's f32
    K and V rows, (R, hi - lo, KV, dh) each."""
    R, H, dh = q.shape
    lens = cache_len.to(device=q.device, dtype=torch.long).clamp(0, Skv)
    qf = None
    parts = []
    for lo in range(0, Skv, L):
        hi = min(lo + L, Skv)
        k, v = keys(lo, hi)
        KV = k.shape[2]
        pos = torch.arange(lo, hi, device=q.device)
        ok = (pos[None, :] < lens[:, None])[:, None, None, :]
        if stream_tiles is not None:
            q32 = q.to(torch.float32).reshape(R, KV, H // KV, dh)
            parts.append((lens > lo, *_stream_partial(q32, k, v, ok, scale,
                                                      *stream_tiles)))
            continue
        if qf is None:
            qf = q.to(torch.float32).reshape(R, KV, H // KV, dh) * scale
        s = qf @ k.permute(0, 2, 3, 1)                        # (R, KV, g, n)
        s = s.masked_fill(~ok, -1e30)
        m = s.amax(-1)
        p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        parts.append((lens > lo, m, p.sum(-1), p @ v.permute(0, 2, 1, 3)))
    live_m = [torch.where(live[:, None, None], m, -1e30)
              for live, m, _, _ in parts]
    M = torch.stack(live_m).amax(0)
    l = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][3])
    for (live, m, ls, a), lm in zip(parts, live_m):
        w = torch.where(live[:, None, None], torch.exp(lm - M), 0.0)
        l = l + w * ls
        acc = acc + w[..., None] * a
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(R, H, dh).to(q.dtype)


def _stream_partial(q32, k, v, ok, scale, W, TK):
    """One range's partial (m, l, acc) as ``decode_stream_kernel`` forms
    it: q32 (R, KV, g, dh) unscaled, the range's K and V (R, n, KV, dh),
    ok (R, 1, 1, n) its live keys.  Tile t (keys [t TK, t TK + TK)) goes to
    warp t % W, whose running (m, l, acc) rescales by e^(m - m') as each
    tile raises its max m' (scores (q . k) * scale, dead keys at -1e30 and
    weight 0); the warps then merge in order w = 0, 1, ...: M = max m_w,
    l = sum e^(m_w - M) l_w, acc likewise.  A warp with no live key keeps
    (-1e30, 0, 0) and weighs 0."""
    n = k.shape[1]
    kt, vt = k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3)
    warps = []
    for w in range(W):
        m = torch.full(q32.shape[:3], -1e30, device=q32.device)
        l, acc = torch.zeros_like(m), torch.zeros_like(q32)
        for t in range(w, -(-n // TK), W):
            sl = slice(t * TK, min(t * TK + TK, n))
            okt = ok[..., sl]
            s = ((q32 @ kt[..., sl]) * scale).masked_fill(~okt, -1e30)
            mn = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mn)
            p = torch.where(okt, torch.exp(s - mn[..., None]), 0.0)
            m, l = mn, l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vt[:, :, sl]
        warps.append((m, l, acc))
    M = torch.stack([m for m, _, _ in warps]).amax(0)
    ls, a = torch.zeros_like(M), torch.zeros_like(q32)
    for m, l, acc in warps:
        wt = torch.exp(m - M)
        ls = ls + wt * l
        a = a + wt[..., None] * acc
    return M, ls, a


def chunk_prefill_reference(q, k_cache, v_cache, q_offset, *, scale: float,
                            slot=None):
    """q: (B, C, H, dh) at positions [q_offset, q_offset + C); caches:
    (B, Skv, KV, dh) with the chunk rows already written, or, given
    ``slot``, the whole (n_slots, Skv, KV, dh) cache of which q (B = 1)
    reads stripe ``slot``.  ``q_offset`` and ``slot``: ints or one-element
    int tensors (never read on the host).  Row c sees cache position j iff
    j <= q_offset + c.  Returns (B, C, H, dh)."""
    _count("chunk_prefill", q)
    return _chunk(q, slot_rows(k_cache, slot), slot_rows(v_cache, slot),
                  q_offset, scale)


def _chunk(q, k_cache, v_cache, q_offset, scale):
    B, C, H, dh = q.shape
    Skv, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qf = (q.to(torch.float32).reshape(B, C, KV, g, dh).permute(0, 2, 3, 1, 4)
          * scale)                                            # (B, KV, g, C, dh)
    kf = k_cache.to(torch.float32).permute(0, 2, 3, 1)[:, :, None]
    vf = v_cache.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    s = qf @ kf                                               # (B, KV, g, C, Skv)
    ok = (torch.arange(Skv, device=q.device)[None, :]
          <= chunk_positions(q_offset, C, q.device)[:, None])
    out = _softmax_pv(s, ok, vf)                              # (B, KV, g, C, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, dh).to(q.dtype)


def chunk_prefill_tc_reference(q, k_cache, v_cache, q_offset: int, *,
                               scale: float, splits: int = 1,
                               block_rows: int = 128, tile_keys: int = 64,
                               round_out: bool = True):
    """The bf16 tensor-core chunk kernel's algebra, in f32:
    :func:`chunk_prefill_reference` computed as that kernel computes it.
    Chunk rows go in blocks of ``block_rows``; a block's keys end at its
    last row's diagonal and are cut into tiles of ``tile_keys``, and
    ``splits`` blocks share them (tiles [z * tps, (z + 1) * tps), tps =
    ceil(tiles / splits)).  Per tile: S = (Q K^T) * scale * log2(e) (the
    scale after the product), causal mask at -1e30, then the online update
    m' = max(m, max S), l = l 2^(m - m') + sum P, O = O 2^(m - m') + P V
    with P = 2^(S - m') (0 where masked) in f32 for l and, for bf16 inputs,
    rounded to bf16 for P V.  Splits combine in order, w_z = 2^(m_z - max
    m); the result is O / max(l, 1e-30), in q's dtype (f32, unrounded,
    without ``round_out``).  Used by the tests and ``chip_smoke.py`` only,
    never on the serving path."""
    _count("chunk_prefill", q)

    def keys(k0, k1):
        return (k_cache[:, k0:k1].to(torch.float32),
                v_cache[:, k0:k1].to(torch.float32), None, None)

    return _chunk_tc(q, keys, k_cache.shape[1], k_cache.shape[2], q_offset,
                     scale, splits, block_rows, tile_keys,
                     round_out=round_out)[0]


def _chunk_tc(q, keys, Skv, KV, q_offset, scale, splits, block_rows,
              tile_keys, *, causal=True, window=0, round_out=True):
    """The tensor-core chunk algebra (see :func:`chunk_prefill_tc_reference`)
    over a key source: ``keys(k0, k1)`` gives keys [k0, k1) as f32 K and V
    rows (B, k1 - k0, KV, dh) and, for int8 pools, their f32 K and V scales
    (B, k1 - k0, KV), else None: the K scale multiplies the scores after
    Q K^T, the V scale P's columns before P is rounded for P V.  The flat
    query side of the MHA forward (``attention/ref.py``) adds full
    attention (``causal=False``, keys to Skv) and a sliding ``window``
    (key j visible to position p iff j > p - window; a block's tiles start
    at its first row's window tile).  Returns the output in q's dtype (f32
    without ``round_out``) and the f32 LSE (B, C, H), max m ln 2 + log(l),
    -1e30 where l = 0."""
    B, C, H, dh = q.shape
    g = H // KV
    rnd = q.dtype == torch.bfloat16
    sl = scale * 1.4426950408889634
    qf = q.to(torch.float32).reshape(B, C, KV, g, dh).permute(0, 2, 3, 1, 4)
    out = torch.empty_like(qf)                            # (B, KV, g, C, dh)
    lse = torch.empty(qf.shape[:4], device=q.device)
    for c0 in range(0, C, block_rows):
        c1 = min(C, c0 + block_rows)
        kend = min(Skv, q_offset + c1) if causal else Skv
        tb = max(0, q_offset + c0 - window + 1) // tile_keys if window > 0 \
            else 0
        nt = max(tb, -(-kend // tile_keys))
        tps = -(-(nt - tb) // splits)
        qpos = q_offset + torch.arange(c0, c1, device=q.device)[:, None]
        parts = []
        for z in range(splits):
            m = torch.full(qf.shape[:3] + (c1 - c0,), -1e30, device=q.device)
            l = torch.zeros_like(m)
            o = torch.zeros(m.shape + (dh,), device=q.device)
            t_lo = min(nt, tb + z * tps)
            for t in range(t_lo, min(nt, t_lo + tps)):
                k0, k1 = t * tile_keys, min(kend, (t + 1) * tile_keys)
                k, v, ks, vs = keys(k0, k1)
                s = qf[..., c0:c1, :] @ k.permute(0, 2, 3, 1)[:, :, None]
                if ks is not None:
                    s = s * ks.permute(0, 2, 1)[:, :, None, None]
                s = s * sl
                kpos = torch.arange(k0, k1, device=q.device)[None, :]
                ok = kpos <= qpos if causal else torch.ones_like(kpos > qpos)
                if window > 0:
                    ok = ok & (kpos > qpos - window)
                s = torch.where(ok, s, -1e30)
                mx = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - mx)
                p = torch.where(ok, torch.exp2(s - mx[..., None]), 0.0)
                l = l * corr + p.sum(-1)
                if vs is not None:
                    p = p * vs.permute(0, 2, 1)[:, :, None, None]
                if rnd:
                    p = p.to(torch.bfloat16).to(torch.float32)
                o = (o * corr[..., None]
                     + p @ v.permute(0, 2, 1, 3)[:, :, None])
                m = mx
            parts.append((m, l, o))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        l = torch.zeros_like(M)
        acc = torch.zeros_like(parts[0][2])
        for mz, lz, oz in parts:
            w = torch.exp2(mz - M)
            l = l + w * lz
            acc = acc + w[..., None] * oz
        out[..., c0:c1, :] = acc / torch.clamp(l, min=1e-30)[..., None]
        lse[..., c0:c1] = torch.where(
            l > 0, M * 0.6931471805599453 + torch.log(torch.clamp(
                l, min=1e-30)), -1e30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, C, H, dh)
    return (out.to(q.dtype) if round_out else out,
            lse.permute(0, 3, 1, 2).reshape(B, C, H))


# ---------------------------------------------------------------------------
# paged pools: (n_pages, page_size, KV, dh), addressed by (B, n_p) page ids
# ---------------------------------------------------------------------------


def gather_pages(pages, page_table):
    """Flatten a page pool into per-slot contiguous caches.

    pages: (n_pages, page_size, KV, dh); page_table: (B, n_p) int.
    Returns (B, n_p * page_size, KV, dh)."""
    n_p, ps = page_table.shape[1], pages.shape[1]
    g = pages[page_table.long()]                  # (B, n_p, ps, KV, dh)
    return g.reshape(g.shape[0], n_p * ps, *pages.shape[2:])


def gather_pages_int8(pages, scale_pool, page_table):
    """Dequantizing gather of an int8 pool: int8 (n_pages, ps, KV, dh) rows
    times their f32 (n_pages, ps, KV) scales.  Returns f32 (B, n_p * ps,
    KV, dh): what the int8 kernels compute tile by tile, made whole."""
    g = gather_pages(pages, page_table).to(torch.float32)
    s = gather_pages(scale_pool[..., None], page_table)
    return g * s.to(torch.float32)


def paged_decode_reference(q, k_pages, v_pages, page_table, cache_len, *,
                           scale: float, rows_per_slot: int = 1):
    """q: (R, H, dh); pools: (n_pages, ps, KV, dh); page_table:
    (R / rows_per_slot, n_p); cache_len: (R,).  Row r reads slot
    ``r // rows_per_slot``.  Returns (R, H, dh)."""
    _count("paged_decode_attention", q)
    pt = page_table.repeat_interleave(rows_per_slot, dim=0)
    return _decode(q, gather_pages(k_pages, pt), gather_pages(v_pages, pt),
                   cache_len, scale)


def paged_decode_reference_int8(q, k_pages, v_pages, k_scale, v_scale,
                                page_table, cache_len, *, scale: float,
                                rows_per_slot: int = 1):
    """:func:`paged_decode_reference` on int8 pools with f32 scale pools."""
    _count("paged_decode_attention_int8", q)
    pt = page_table.repeat_interleave(rows_per_slot, dim=0)
    return _decode(q, gather_pages_int8(k_pages, k_scale, pt),
                   gather_pages_int8(v_pages, v_scale, pt), cache_len, scale)


def paged_chunk_prefill_reference(q, k_pages, v_pages, page_table,
                                  q_offset, *, scale: float, slot=None):
    """q: (B, C, H, dh) at positions [q_offset, q_offset + C); pools as
    :func:`paged_decode_reference`, the chunk rows already written; q's
    row b reads table row b, or, given ``slot``, q (B = 1) reads row
    ``slot``.  ``q_offset`` and ``slot`` as in
    :func:`chunk_prefill_reference`.  Returns (B, C, H, dh)."""
    _count("paged_chunk_prefill", q)
    page_table = slot_rows(page_table, slot)
    return _chunk(q, gather_pages(k_pages, page_table),
                  gather_pages(v_pages, page_table), q_offset, scale)


def paged_chunk_prefill_reference_int8(q, k_pages, v_pages, k_scale,
                                       v_scale, page_table, q_offset, *,
                                       scale: float, slot=None):
    """:func:`paged_chunk_prefill_reference` on int8 pools."""
    _count("paged_chunk_prefill_int8", q)
    page_table = slot_rows(page_table, slot)
    return _chunk(q, gather_pages_int8(k_pages, k_scale, page_table),
                  gather_pages_int8(v_pages, v_scale, page_table),
                  q_offset, scale)


def paged_chunk_prefill_tc_reference(q, k_pages, v_pages, page_table,
                                     q_offset: int, *, scale: float,
                                     splits: int = 1, block_rows: int = 128,
                                     tile_keys: int = 64,
                                     round_out: bool = True):
    """The bf16 paged chunk kernel's algebra, in f32: the algebra of
    :func:`chunk_prefill_tc_reference` over the n_p * page_size keys of
    each slot's row of ``page_table`` ((B, n_p) page ids into (n_pages,
    page_size, KV, dh) pools), as the kernel reads them: key pos is row
    pos % page_size of page page_table[b, pos // page_size], an id outside
    [0, n_pages) reads the null page 0; f32, unrounded, without
    ``round_out``.  Used by the tests and ``chip_smoke.py`` only, never on
    the serving path."""
    _count("paged_chunk_prefill", q)
    return _paged_chunk_tc(q, k_pages, v_pages, None, None, page_table,
                           q_offset, scale, splits, block_rows, tile_keys,
                           round_out)


def paged_chunk_prefill_tc_reference_int8(q, k_pages, v_pages, k_scale,
                                          v_scale, page_table, q_offset: int,
                                          *, scale: float, splits: int = 1,
                                          block_rows: int = 128,
                                          tile_keys: int = 64,
                                          round_out: bool = True):
    """:func:`paged_chunk_prefill_tc_reference` on int8 pools with f32
    (n_pages, page_size, KV) scale pools, as the int8 kernel applies the
    scales: the int8 values enter Q K^T and P V exactly, each key's K scale
    multiplies its score column after Q K^T (before the softmax scale),
    and its V scale multiplies P's column before P is rounded to bf16 for
    P V; l sums the unscaled P."""
    _count("paged_chunk_prefill_int8", q)
    return _paged_chunk_tc(q, k_pages, v_pages, k_scale, v_scale, page_table,
                           q_offset, scale, splits, block_rows, tile_keys,
                           round_out)


def _paged_chunk_tc(q, k_pages, v_pages, k_scale, v_scale, page_table,
                    q_offset, scale, splits, block_rows, tile_keys,
                    round_out):
    n_pages, ps = k_pages.shape[:2]
    pt = page_table.to(device=q.device, dtype=torch.long)
    pt = torch.where((pt >= 0) & (pt < n_pages), pt, 0)

    def keys(k0, k1):
        pos = torch.arange(k0, k1, device=q.device)
        ids, off = pt[:, pos // ps], pos % ps                 # (B, n)

        def scales(sc):
            return None if sc is None else sc[ids, off].to(torch.float32)
        return (k_pages[ids, off].to(torch.float32),
                v_pages[ids, off].to(torch.float32), scales(k_scale),
                scales(v_scale))

    return _chunk_tc(q, keys, pt.shape[1] * ps, k_pages.shape[2], q_offset,
                     scale, splits, block_rows, tile_keys,
                     round_out=round_out)[0]


def mla_decode_reference(q, kv, lens, *, scale: float, dv: int):
    """The absorbed latent decode (``mla_decode``): q (R, H, dk); kv
    (slots >= R, Skv, dk) latent rows, row r reading slot r; lens (R,)
    int.  Softmax of ``scale`` q.row over the first lens[r] rows, times
    rows[..., :dv].  Returns (R, H, dv); a row with no visible key gives
    0."""
    _count("mla_decode", q)
    R = q.shape[0]
    rows = kv[:R].to(torch.float32)                          # (R, Skv, dk)
    s = (q.to(torch.float32) * scale) @ rows.transpose(1, 2)  # (R, H, Skv)
    pos = torch.arange(rows.shape[1], device=q.device)
    ok = (pos[None, :] < lens.to(q.device)[:, None])[:, None, :]
    return _softmax_pv(s, ok, rows[..., :dv]).to(q.dtype)


def mla_decode_split_reference(q, kv, lens, *, scale: float, dv: int,
                               L: int, tile: int = 64):
    """The ``mla_decode`` kernel's algebra, in f32 on the CPU: each row's
    keys cut into ranges of L, each range walked in tiles of ``tile``
    keys with a base-2 online softmax (running max, the accumulator and
    the sum rescaled by 2^(m - m') when a tile raises it), P rounded to
    bf16 before P V and before it is summed into l; each range's
    (m, l, acc) then combined in range order, out = sum_s e^(m_s - M)
    acc_s / max(sum_s e^(m_s - M) l_s, 1e-30), rounded to q's dtype."""
    R, H, _ = q.shape
    log2e = 1.4426950408889634
    out = []
    qf = q.to(torch.float32)
    for r in range(R):
        n = int(lens[r])
        rows = kv[r, :n].to(torch.float32)
        parts = []
        for k0 in range(0, n, L):
            m = torch.full((H,), -1e30, device=q.device)
            ls = torch.zeros(H, device=q.device)
            acc = torch.zeros(H, dv, device=q.device)
            for t0 in range(k0, min(n, k0 + L), tile):
                blk = rows[t0:min(n, k0 + L, t0 + tile)]
                s = (qf[r] @ blk.T) * (scale * log2e)        # (H, keys)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[:, None]).to(torch.bfloat16).to(
                    torch.float32)
                ls = ls * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + p @ blk[:, :dv].to(
                    torch.bfloat16).to(torch.float32)
                m = m_new
            parts.append((m * 0.6931471805599453, ls, acc))
        if not parts:
            out.append(torch.zeros(H, dv, device=q.device))
            continue
        M = torch.stack([p[0] for p in parts]).amax(0)
        w = [torch.exp(p[0] - M) for p in parts]
        lsum = sum(wi * p[1] for wi, p in zip(w, parts))
        a = sum(wi[:, None] * p[2] for wi, p in zip(w, parts))
        out.append(a / lsum.clamp_min(1e-30)[:, None])
    return torch.stack(out).to(q.dtype)
