"""Attention block: GQA dense MHA built on the FAMOUS core, with qwen3's
per-head qk RMSNorm where the config asks for it — full-sequence
attention for training and encoders, and for serving a contiguous
per-slot KV cache, a sliding-window ring, or a shared page pool, fp or
int8, by monolithic or chunked prefill, decode or speculative verify
(the port of ``repro.models.attention``).

Cache writes are **in place**: ``apply_attn_prefill`` writes a whole
prompt's K/V rows (or its ring), ``apply_attn_chunk`` writes the chunk's K/V
at ``(slot, offset + arange(C))`` (a fixed-shape ``index_put_`` whose
indices are computed on the device from the runtime scalars, so a CUDA
graph of the chunk serves every slot and offset), ``apply_attn_decode`` writes
each slot's new K/V at its ``cache_len``, ``apply_attn_verify`` the W
verify tokens at ``cache_len + j``, and the paged twins scatter rows into
the pool pages their page table names, mutating the tensors the caller
passed.  The JAX functions are functional (they return updated
copies); all return the cache so the call sites read alike.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import famous
from repro_torch.core import quant as quant_lib
from repro_torch.kernels import lib
from repro_torch.kernels.qkv import ops as qkv_ops
from repro_torch.models import layers
from repro_torch.models.module import ParamSpec, ShapeDtype, zeros_like_shapes


def attn_spec(cfg: ModelConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    spec = {
        "wq": ParamSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.attention_bias:
        spec["bq"] = ParamSpec((h, dh), ("heads", "head_dim"), init="zeros")
        spec["bk"] = ParamSpec((kv, dh), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = ParamSpec((kv, dh), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        spec["q_norm"] = ParamSpec((dh,), (None,), init="ones")
        spec["k_norm"] = ParamSpec((dh,), (None,), init="ones")
    return spec


def fuse_qkv(p: dict) -> dict:
    """One layer's attention params with [Wq|Wk|Wv] fused once into
    ``w_qkv`` (D, F); ``wq``/``wk``/``wv`` become views into it, so the
    fused copy costs no memory beyond the separate leaves it replaces."""
    D, H, dh = p["wq"].shape
    KV = p["wk"].shape[1]
    w = famous.fuse_qkv_weights(p["wq"], p["wk"], p["wv"]).contiguous()
    nq, nk = H * dh, KV * dh
    out = dict(p)
    out["w_qkv"] = w
    out["wq"] = w[:, :nq].unflatten(1, (H, dh))
    out["wk"] = w[:, nq:nq + nk].unflatten(1, (KV, dh))
    out["wv"] = w[:, nq + nk:].unflatten(1, (KV, dh))
    return out


def quantize_qkv(p: dict) -> dict:
    """One layer's attention params with the fused ``w_qkv`` also quantized
    once, for ``FamousConfig(quant="int8")`` on the kernels: ``w_qkv_q``
    int8 (F, D) (the int8 kernel's transposed layout) and ``w_qkv_s`` its
    f32 (1, F) per-column scale.  Quantized from the weights' own dtype, as
    JAX quantizes the fused W on every call, so the two agree bit for bit;
    at qwen2-7b this adds 28 x 3584 x 4608 bytes (462 MB) of int8.  A
    layer with no fused weight (a mesh gathers its leaves at each step)
    is returned as it is: the projection quantizes the gathered weight at
    each call, as JAX does."""
    if "w_qkv_q" in p or "w_qkv" not in p:
        return p
    out = dict(p)
    out["w_qkv_q"], out["w_qkv_s"] = qkv_ops.quantize_weight(p["w_qkv"])
    return out


def attn_cache_shape(cfg: ModelConfig, batch: int, max_seq: int, window: int,
                     dtype) -> dict:
    """The :class:`~repro_torch.models.module.ShapeDtype` of each buffer of
    :func:`make_attn_cache` (JAX's ``attn_cache_shape``)."""
    rows = min(max_seq, window) if window else max_seq
    sd = ShapeDtype((batch, rows, cfg.num_kv_heads, cfg.head_dim), dtype)
    return {"k": sd, "v": sd}


def make_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    device="cuda", window: int = 0) -> dict:
    """Contiguous (batch, max_seq, kv, dh) K/V buffers of one layer; a
    sliding-window layer keeps an O(window) ring of ``min(max_seq,
    window)`` rows instead, position p in row p % ring."""
    return zeros_like_shapes(
        attn_cache_shape(cfg, batch, max_seq, window, dtype), device)


# logical axes of the caches (``transformer.cache_axes``): contiguous
# stripes and rings are per slot; page pools have no slot axis, so tensor
# parallelism shards their kv-head dim (and the int8 scale pools' alike),
# and the page table stays one host copy for every rank
ATTN_CACHE_AXES = {"k": ("batch", None, "kv_heads", "head_dim"),
                   "v": ("batch", None, "kv_heads", "head_dim")}
PAGED_ATTN_CACHE_AXES = {"k": (None, None, "kv_heads", "head_dim"),
                         "v": (None, None, "kv_heads", "head_dim")}
PAGED_ATTN_CACHE_AXES_INT8 = {**PAGED_ATTN_CACHE_AXES,
                              "k_scale": (None, None, "kv_heads"),
                              "v_scale": (None, None, "kv_heads")}


def paged_attn_cache_shape(cfg: ModelConfig, n_pages: int, page_size: int,
                           dtype, kv_dtype: str = "fp") -> dict:
    """The :class:`~repro_torch.models.module.ShapeDtype` of each pool of
    :func:`make_paged_attn_cache` (JAX's ``paged_attn_cache_shape``)."""
    shape = (n_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        sd = ShapeDtype(shape, torch.int8)
        scale = ShapeDtype(shape[:3], torch.float32)
        return {"k": sd, "v": sd, "k_scale": scale, "v_scale": scale}
    sd = ShapeDtype(shape, dtype)
    return {"k": sd, "v": sd}


def make_paged_attn_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                          dtype, kv_dtype: str = "fp", device="cuda") -> dict:
    """Shared page pool of one global-attention layer: every slot's K/V
    live in fixed-size pages addressed through its page table (the pool
    has no slot axis).  ``kv_dtype="int8"`` stores int8 pools with f32
    ``k_scale``/``v_scale`` pools of shape (n_pages, page_size, kv), one
    symmetric scale per (token, kv head), written in the same scatter as
    the row, so a scale row shares its page's id and lifetime."""
    return zeros_like_shapes(
        paged_attn_cache_shape(cfg, n_pages, page_size, dtype, kv_dtype),
        device)


def _kv_quantize(x):
    """Per-(token, kv head) symmetric int8 over head_dim: x (..., kv, dh)
    -> (int8 (..., kv, dh), f32 scale (..., kv))."""
    q, s = quant_lib.quantize(x, axis=-1)
    return q, s[..., 0]


def _last_writer(pids, offs, page_size: int) -> torch.Tensor:
    """For each of the N rows of (pid, off) pairs, flattened, the index of
    the last row that names the same pool row (itself when it is alone):
    an (N, N) compare on the device, N at most a chunk."""
    dest = (pids * page_size + offs).reshape(-1)
    idx = torch.arange(dest.numel(), device=dest.device)
    return torch.where(dest[:, None] == dest[None, :], idx[None, :],
                       -1).amax(1)


def _paged_write(cache: dict, pids, offs, k, v) -> dict:
    """Write per-token K/V rows (..., kv, dh) into the pool at page
    ``pids``, row ``offs`` in place, quantizing when the pool is int8
    (``k_scale`` present).  Duplicate (pid, off) pairs only ever name the
    null page (pad rows of a chunk past the slot's pages, free slots in a
    decode step), which no real row reads; but a chunk's pad rows attend
    to it, and in an MoE layer their routing takes capacity from the real
    rows.  So every duplicate writes the last such row's values (the
    sequential order's result, as on the CPU and in JAX), and the pool's
    bits never depend on the order in which the device applies the
    writes."""
    last = _last_writer(pids, offs, cache["k"].shape[1])
    lead = pids.ndim

    def rows(x):
        flat = x.reshape((-1,) + x.shape[lead:])
        return flat.index_select(0, last).reshape(x.shape)

    if "k_scale" in cache:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        cache["k"][pids, offs] = rows(kq)
        cache["v"][pids, offs] = rows(vq)
        cache["k_scale"][pids, offs] = rows(ks)
        cache["v_scale"][pids, offs] = rows(vs)
    else:
        cache["k"][pids, offs] = rows(k.to(cache["k"].dtype))
        cache["v"][pids, offs] = rows(v.to(cache["v"].dtype))
    return cache


def _pool_scales(cache: dict) -> dict:
    """kwargs routing famous.* paged attention onto the int8 pools."""
    if "k_scale" in cache:
        return {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
    return {}


def _page_of(page_table, positions, page_size: int):
    """Page ids of ``positions`` (tensor, broadcast against the table's
    leading axes) from a (..., n_p) page table.  A position past the table
    maps to the null page: torch indexing raises where JAX's gather clamps,
    and a clamped write would land in the slot's last, possibly live,
    page."""
    n_p = page_table.shape[-1]
    blk = torch.div(positions, page_size, rounding_mode="floor")
    inside = blk < n_p
    pids = torch.gather(page_table, -1, blk.clamp(max=n_p - 1))
    return torch.where(inside, pids, torch.zeros_like(pids))


def _project(p, x, cfg: ModelConfig, fcfg: famous.FamousConfig, positions):
    w_int8 = (p["w_qkv_q"], p["w_qkv_s"]) if "w_qkv_q" in p else None
    q, k, v = famous.qkv_projection(
        x, p["wq"], p["wk"], p["wv"], p.get("bq"), p.get("bk"), p.get("bv"),
        cfg=fcfg, w_qkv=p.get("w_qkv"), w_int8=w_int8)
    if cfg.qk_norm:
        q = layers.rms_head_norm(q, p["q_norm"])
        k = layers.rms_head_norm(k, p["k_norm"])
    if cfg.rope:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    if "kv_head" in p:
        q = _spread_heads(q, p["kv_head"])
    return q, k, v


def head_spread(H: int, KV: int, lo: int, hi: int) -> tuple:
    """The kernels' head layout for a tensor-parallel rank that holds
    query heads [lo, hi) of H while the KV kv heads stay whole (groups of
    H / KV query heads): ``(KV, width, runs)``.  The rank's heads in kv
    head k's group form the run (k, n), n heads; each of the KV groups of
    the layout has ``width`` slots (the longest run), a run in the first
    slots of its group and zeros in the others, so the kernels' head map
    (q head j reads kv head ``j // width``) pairs every local head with
    its own kv head of the replicated cache, whether the rank's heads lie
    in one group or span several."""
    group = H // KV
    runs = tuple((k, min(hi, (k + 1) * group) - max(lo, k * group))
                 for k in range(lo // group, (hi - 1) // group + 1))
    return KV, max(n for _, n in runs), runs


def _spread_heads(q, kv_head):
    """A rank's q (..., Hl, dh) placed in the (..., KV * width, dh) layout
    of :func:`head_spread` (``kv_head``), zeros elsewhere.  The zero
    heads' outputs are dropped in :func:`_attn_out`."""
    KV, width, runs = kv_head
    z = q.new_zeros(q.shape[:-2] + (width, q.shape[-1]))
    pieces, at, nxt = [], 0, 0
    for k, n in runs:
        pieces += [z] * (k - nxt) + [q[..., at:at + n, :]]
        if n < width:
            pieces.append(z[..., :width - n, :])
        at, nxt = at + n, k + 1
    return torch.cat(pieces + [z] * (KV - nxt), dim=-2)


def _out_proj(out, wo):
    """einsum("bshe,hed->bsd") as one matmul."""
    B, S, H, dh = out.shape
    return out.reshape(B, S, H * dh) @ wo.to(out.dtype).reshape(H * dh, -1)


def _attn_out(out, p):
    """The attention output through ``wo``; under tensor parallelism the
    rank's heads' partial product summed over the "model" group
    (``tp_sum``, present only where the heads are sharded over more than
    one rank), after dropping the zero heads :func:`_spread_heads`
    added."""
    if "kv_head" in p:
        _, width, runs = p["kv_head"]
        out = torch.cat([out[..., k * width:k * width + n, :]
                         for k, n in runs], dim=-2)
    y = _out_proj(out, p["wo"])
    if "tp_sum" in p:
        y = p["tp_sum"](y)
    return y


def apply_attn(p: dict, x: torch.Tensor, cfg: ModelConfig,
               fcfg: famous.FamousConfig, *, window: int = 0,
               q_offset: int = 0) -> torch.Tensor:
    """Full-sequence attention (training / encoder). x: (B, S, D).  Head
    counts come from the weights, so a tensor-parallel rank runs its own
    heads; ``tp_in`` (sharded training's Megatron f) takes the input of
    its column-parallel projections."""
    if "tp_in" in p:
        x = p["tp_in"](x)
    S = x.shape[1]
    positions = q_offset + torch.arange(S, device=x.device)
    q, k, v = _project(p, x, cfg, fcfg, positions)
    out = famous.attention(q, k, v, causal=cfg.causal, window=window,
                           q_offset=q_offset, cfg=fcfg)
    return _attn_out(out, p)


def apply_attn_prefill(p: dict, x: torch.Tensor, cache: dict,
                       cfg: ModelConfig, fcfg: famous.FamousConfig, *,
                       window: int = 0):
    """Monolithic prefill: full-sequence attention over x (B, S, D) at
    positions [0, S) (``impl="pallas"``: the ``mha_forward`` kernel), and
    the K/V written into ``cache`` {"k", "v"} (B, rows, kv, dh) in place:
    rows [0, S) when the cache holds S rows, else, in a sliding-window
    ring, the last ``rows`` positions, position p in row p % rows (the
    layout the chunk and decode paths read).  Returns (out, cache)."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    q, k, v = _project(p, x, cfg, fcfg, positions)
    out = famous.attention(q, k, v, causal=cfg.causal, window=window,
                           cfg=fcfg)
    rows = cache["k"].shape[1]
    for name, new in (("k", k), ("v", v)):
        buf = cache[name]
        if rows >= S:
            buf[:, :S] = new.to(buf.dtype)
        else:
            buf[:, positions[S - rows:] % rows] = new[:, S - rows:].to(
                buf.dtype)
    return _attn_out(out, p), cache


def ring_write_source(ring: int, offset, n_valid, C: int):
    """Which chunk position writes each ring row, on the device: for row
    ``r`` the one position whose absolute position is ``r`` mod ``ring``
    among the last ``min(n_valid, ring)`` real ones, ``c = lo + ((r -
    offset - lo) mod ring)`` with ``lo = max(0, n_valid - ring)``, written
    when ``c < n_valid``.  ``offset``, ``n_valid``: one-element int
    tensors.  Returns (c clamped into [0, C) (ring,) int64, written (ring,)
    bool): pad junk never lands, older positions never alias newer ones
    (JAX redirects those writes out of bounds), and no index repeats, for
    any ``C`` against ``ring``."""
    r = torch.arange(ring, device=offset.device)
    lo = torch.clamp(n_valid.to(torch.int64) - ring, min=0)
    c = lo + torch.remainder(r - offset - lo, ring)
    return c.clamp(max=C - 1), c < n_valid


def apply_attn_chunk(p: dict, x: torch.Tensor, cache: dict, slot, offset,
                     n_valid, cfg: ModelConfig, fcfg: famous.FamousConfig, *,
                     window: int = 0):
    """Chunked prefill for one slot of the batched cache.

    x: (1, C, D) — the chunk at absolute positions [offset, offset+C), of
    which the first ``n_valid`` are real; ``slot``, ``offset``,
    ``n_valid``: runtime scalars (``lib.device_scalar``: ints, or
    one-element int tensors on x's device, which nothing here reads on the
    host); cache: {"k","v"} (n_slots, S |
    ring, kv, dh).  Global attention (``window`` 0) writes the chunk's K/V
    into the slot's stripe in place and attends against resident prefix +
    own chunk: the kernel reads the stripe of the whole cache at the
    device ``slot`` (no copy); pad positions at the chunk tail write junk
    K/V beyond the prompt, which is never read.

    A sliding-window layer keeps a ring (position p in row p % ring): the
    pre-chunk ring is gathered in position order (positions offset - ring
    .. offset - 1; negative, never-written positions are masked), the chunk
    attends over [ring ‖ chunk] through ``famous.attention_at_positions``,
    and then the ring is rewritten whole, as JAX rewrites ``row_k``: each
    row takes the chunk position :func:`ring_write_source` names, or keeps
    its contents.  Returns (out (1, C, D), cache)."""
    C = x.shape[1]
    slot, offset, n_valid = (lib.device_scalar("apply_attn_chunk", t,
                                               x.device)
                             for t in (slot, offset, n_valid))
    positions = offset + torch.arange(C, device=x.device)
    q, k, v = _project(p, x, cfg, fcfg, positions)
    if not window:
        rows = (slot.expand(C), positions)
        cache["k"].index_put_(rows, k[0].to(cache["k"].dtype))
        cache["v"].index_put_(rows, v[0].to(cache["v"].dtype))
        out = famous.chunked_prefill_attention(q, cache["k"], cache["v"],
                                               offset, cfg=fcfg, slot=slot)
        return _attn_out(out, p), cache
    ring = cache["k"].shape[1]
    prev_pos = offset - ring + torch.arange(ring, device=x.device)
    order = torch.remainder(prev_pos, ring)
    row_k = cache["k"].index_select(0, slot)[0]            # (ring, kv, dh)
    row_v = cache["v"].index_select(0, slot)[0]
    keys = torch.cat([row_k[order][None].to(k.dtype), k], dim=1)
    vals = torch.cat([row_v[order][None].to(v.dtype), v], dim=1)
    out = famous.attention_at_positions(q, keys, vals, positions,
                                        torch.cat([prev_pos, positions]),
                                        window=window)
    src, written = ring_write_source(ring, offset, n_valid, C)
    keep = written[:, None, None]
    for name, new, row in (("k", k, row_k), ("v", v, row_v)):
        buf = cache[name]
        buf.index_put_((slot,), torch.where(keep, new[0, src].to(buf.dtype),
                                            row)[None])
    return _attn_out(out, p), cache


def apply_attn_decode(p: dict, x: torch.Tensor, cache: dict,
                      cache_len: torch.Tensor, cfg: ModelConfig,
                      fcfg: famous.FamousConfig, *, window: int = 0):
    """One-token decode. x: (B, 1, D); cache_len: (B,) int32 valid entries
    BEFORE this token, on the device.  Every slot writes its new K/V at its
    ``cache_len`` (clamped to the last row, as JAX's dynamic_update_slice
    clamps), or, in a sliding-window ring, at ``cache_len % ring`` — and
    then attends over ``cache_len + 1`` rows (``min(cache_len + 1, ring)``
    in a ring, whose rows hold positions out of order: attention does not
    care).  Inactive slots write junk that the next chunk overwrites or
    that lies outside every later window.  Returns (out, cache)."""
    B = x.shape[0]
    positions = cache_len[:, None]                 # (B, 1) absolute positions
    q, k, v = _project(p, x, cfg, fcfg, positions)
    rows = torch.arange(B, device=x.device)
    n = cache["k"].shape[1]
    if window:
        at = torch.remainder(cache_len, n)
        valid = torch.clamp(cache_len + 1, max=n)
    else:
        at = cache_len.clamp(max=n - 1)
        valid = cache_len + 1
    cache["k"][rows, at] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, at] = v[:, 0].to(cache["v"].dtype)
    out = famous.decode_attention(q, cache["k"], cache["v"], valid, cfg=fcfg)
    return _attn_out(out, p), cache


def apply_attn_chunk_paged(p: dict, x: torch.Tensor, cache: dict,
                           page_table: torch.Tensor, slot, offset,
                           cfg: ModelConfig, fcfg: famous.FamousConfig):
    """Chunked prefill against the shared page pool.

    x: (1, C, D) at absolute positions [offset, offset+C); ``slot``,
    ``offset``: runtime scalars, as in :func:`apply_attn_chunk`; cache: pools
    (n_pages, page_size, kv, dh); page_table: (n_slots, n_p) int32 on the
    device.  The chunk's K/V go to page ``page_table[slot, p // ps]``, row
    ``p % ps`` (the slot's table row gathered on the device); pad
    positions past the slot's pages land on the null page.  With a
    prefix-cache hit ``offset`` starts past the slot's shared pages, so
    every write lands in a private page.  The kernel reads the whole table
    at the device ``slot``.  Returns (out, cache)."""
    C = x.shape[1]
    slot, offset = (lib.device_scalar("apply_attn_chunk_paged", t, x.device)
                    for t in (slot, offset))
    positions = offset + torch.arange(C, device=x.device)
    q, k, v = _project(p, x, cfg, fcfg, positions)
    ps = cache["k"].shape[1]
    pids = _page_of(page_table.index_select(0, slot)[0], positions, ps)
    _paged_write(cache, pids, positions % ps, k[0], v[0])
    out = famous.paged_chunked_prefill_attention(
        q, cache["k"], cache["v"], page_table, offset, cfg=fcfg, slot=slot,
        **_pool_scales(cache))
    return _attn_out(out, p), cache


def apply_attn_decode_paged(p: dict, x: torch.Tensor, cache: dict,
                            page_table: torch.Tensor, cache_len: torch.Tensor,
                            cfg: ModelConfig, fcfg: famous.FamousConfig):
    """One-token decode against the shared page pool.

    x: (B, 1, D); page_table: (B, n_p) int32 and cache_len: (B,) int32
    valid entries BEFORE this token, both on the device.  The new token's
    K/V go to page ``page_table[b, len // ps]``, row ``len % ps``: a
    private page of a decoding slot (aliased prefix pages lie before it),
    the null page of a free slot, the next private page of a slot mid
    prefill (its next chunk overwrites the junk).  Returns (out, cache)."""
    positions = cache_len[:, None]
    q, k, v = _project(p, x, cfg, fcfg, positions)
    ps = cache["k"].shape[1]
    pids = _page_of(page_table, positions.long(), ps)[:, 0]
    _paged_write(cache, pids, cache_len.long() % ps, k[:, 0], v[:, 0])
    out = famous.paged_decode_attention(q, cache["k"], cache["v"], page_table,
                                        cache_len + 1, cfg=fcfg,
                                        **_pool_scales(cache))
    return _attn_out(out, p), cache


def verify_writes(cache_len: torch.Tensor, W: int, max_seq: int):
    """Where the W verify tokens of each slot go in a contiguous cache, as
    fixed-shape (B, W) index tensors computed on the device (no host
    sync, so the verify step can be captured in a CUDA graph).

    Slot b writes the W rows ``start + i`` with ``start = min(cache_len,
    max_seq - W)``: a window that always lies inside the stripe, so no
    index is clamped and no two of a slot's indices are equal.  Row ``p``
    takes verify token ``j = p - cache_len`` where ``j >= 0`` (``fresh``);
    the rows of the window before ``cache_len`` (only when the slot is
    within W of ``max_seq``) get their own contents back.  So tokens at
    positions past ``max_seq`` are dropped, as JAX's ``.at[].set(mode=
    "drop")`` drops them, and no live row changes.  Returns (slot,
    position, token, fresh), ``token`` clamped into [0, W)."""
    if W > max_seq:
        raise ValueError(f"verify width {W} exceeds the cache's {max_seq} "
                         "rows")
    B = cache_len.shape[0]
    dev = cache_len.device
    cl = cache_len.to(torch.int64)
    start = cl.clamp(max=max_seq - W)
    pos = start[:, None] + torch.arange(W, device=dev)
    j = pos - cl[:, None]
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, W)
    return b_idx, pos, j.clamp(0, W - 1), j >= 0


def apply_attn_verify(p: dict, x: torch.Tensor, cache: dict,
                      cache_len: torch.Tensor, cfg: ModelConfig,
                      fcfg: famous.FamousConfig, writes):
    """Speculative verify: W tokens per slot in one forward.  x: (B, W, D)
    at absolute positions ``cache_len[b] + j``; cache_len: (B,) int32 valid
    entries BEFORE the first verify token, on the device.  The tokens' K/V
    are written in place at their positions (``writes``: the indices of
    :func:`verify_writes`, which drop positions past ``max_seq``).
    Rejected draft positions need no rollback: their K/V stay as junk past
    the accepted ``cache_len``, masked by every later read and overwritten
    before they become visible.  Returns (out, cache).
    """
    B, W = x.shape[:2]
    positions = cache_len[:, None] + torch.arange(W, device=x.device)
    q, k, v = _project(p, x, cfg, fcfg, positions)
    b_idx, pos, tok, fresh = writes
    keep = fresh[..., None, None]
    for name, new in (("k", k), ("v", v)):
        buf = cache[name]
        buf[b_idx, pos] = torch.where(keep, new[b_idx, tok].to(buf.dtype),
                                      buf[b_idx, pos])
    out = famous.verify_attention(q, cache["k"], cache["v"], cache_len,
                                  cfg=fcfg)
    return _attn_out(out, p), cache


def apply_attn_verify_paged(p: dict, x: torch.Tensor, cache: dict,
                            page_table: torch.Tensor, cache_len: torch.Tensor,
                            cfg: ModelConfig, fcfg: famous.FamousConfig):
    """Speculative verify against the shared page pool.  x: (B, W, D);
    page_table: (B, n_p) int32 and cache_len: (B,) int32 valid entries
    BEFORE the first verify token, both on the device.  Position p of slot
    b goes to page ``page_table[b, p // ps]``, row ``p % ps``, through
    :func:`_paged_write` (quantizing for int8 pools); a position past the
    table goes to the null page (a clamped page would alias a live one).
    Rollback of rejected tokens is the allocator's (``PageAllocator.
    shrink``); their junk in kept pages is masked and overwritten as in
    the contiguous case.  Returns (out, cache)."""
    B, W = x.shape[:2]
    positions = cache_len[:, None] + torch.arange(W, device=x.device)
    q, k, v = _project(p, x, cfg, fcfg, positions)
    ps = cache["k"].shape[1]
    pos = positions.long()
    pids = _page_of(page_table, pos, ps)
    _paged_write(cache, pids, pos % ps, k, v)
    out = famous.paged_verify_attention(q, cache["k"], cache["v"],
                                        page_table, cache_len, cfg=fcfg,
                                        **_pool_scales(cache))
    return _attn_out(out, p), cache
