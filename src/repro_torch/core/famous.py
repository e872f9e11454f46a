"""FAMOUS core on PyTorch: the serving half of ``repro.core.famous``.

The paper decomposes MHA into three processing modules — QKV_PM (Algorithm
1, the column-tiled projection), QK_PM (scores + softmax) and SV_PM — and
this module keeps the JAX package's three interchangeable implementations
of them, selected by ``FamousConfig.impl``:

  impl="reference"  paper-faithful eager oracle (explicit TS-tile loop).
  impl="xla"        plain torch ops: one fused projection, dense masked
                    attention.
  impl="pallas"     the hand-written Hopper kernels (kernels/qkv,
                    kernels/decode) on CUDA tensors; their plain versions
                    on CPU tensors.

Only the functions on the serving path are ported here: the projection,
chunked-prefill attention and decode attention.  Full-sequence attention
(``attention`` / ``mha_block``) comes with the next slice of the port.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class FamousConfig:
    """Tiling + dispatch knobs (the TS analogue and runtime maxima)."""

    tile_d: int = 512       # TS for the QKV_PM reduction dim (d_model)
    tile_q: int = 512       # query-tile rows held on-chip in QK/SV modules
    tile_k: int = 512       # key-tile columns streamed through QK/SV modules
    impl: str = "xla"       # reference | xla | pallas
    quant: str = "none"     # none | int8  (paper uses 8-bit fixed point)
    # Runtime-programmable maxima (paper §IV-C).
    max_heads: int = 0
    max_seq: int = 0
    max_d_model: int = 0


def _check_quant(cfg: FamousConfig) -> None:
    if cfg.quant != "none":
        raise NotImplementedError(
            "quant='int8' comes with the int8 slice of the port "
            "(ROADMAP Queue 2: matmul_tiled_int8)")


# ---------------------------------------------------------------------------
# QKV_PM — Algorithm 1
# ---------------------------------------------------------------------------


def qkv_projection_reference(x, wq, wk, wv, bq=None, bk=None, bv=None, *,
                             tile_d: int = 64):
    """Paper-faithful Algorithm 1: the projection tiled along D (the
    reduction dim) with partial sums accumulated in f32, the bias added at
    the end.  x: (..., S, D); w*: (D, H, dh)."""
    d = x.shape[-1]
    tile_d = min(tile_d, d)
    assert d % tile_d == 0, (d, tile_d)

    def one(w):
        acc = torch.zeros(x.shape[:-1] + w.shape[1:], dtype=torch.float32,
                          device=x.device)
        for t in range(d // tile_d):  # the (d_model / TS) BRAM reloads
            xs = x[..., t * tile_d:(t + 1) * tile_d].to(torch.float32)
            ws = w[t * tile_d:(t + 1) * tile_d].to(torch.float32)
            acc = acc + torch.einsum("...sd,dhe->...she", xs, ws)
        return acc

    q, k, v = one(wq), one(wk), one(wv)
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)


def fuse_qkv_weights(wq, wk, wv) -> torch.Tensor:
    """[Wq|Wk|Wv] as one (D, H*dh + 2*KV*dh) matrix."""
    D = wq.shape[0]
    return torch.cat([wq.reshape(D, -1), wk.reshape(D, -1),
                      wv.reshape(D, -1)], dim=-1)


def qkv_projection_xla(x, wq, wk, wv, bq=None, bk=None, bv=None, *,
                       w_qkv=None):
    """Fused projection in ``x.dtype``: one read of x feeds three matmuls,
    like the shared X BRAM in QKV_PM."""
    w = w_qkv if w_qkv is not None else fuse_qkv_weights(wq, wk, wv)
    qkv = x @ w.to(x.dtype)
    nq = wq.shape[1] * wq.shape[2]
    nk = wk.shape[1] * wk.shape[2]
    q = qkv[..., :nq].reshape(x.shape[:-1] + wq.shape[1:])
    k = qkv[..., nq:nq + nk].reshape(x.shape[:-1] + wk.shape[1:])
    v = qkv[..., nq + nk:].reshape(x.shape[:-1] + wv.shape[1:])
    if bq is not None:
        q, k, v = q + bq.to(q.dtype), k + bk.to(k.dtype), v + bv.to(v.dtype)
    return q, k, v


def qkv_projection(x, wq, wk, wv, bq=None, bk=None, bv=None, *,
                   cfg: FamousConfig = FamousConfig(), w_qkv=None):
    """x: (B, S, D); w*: (D, heads, dh).  ``w_qkv``: the fused matrix when
    the caller holds one (the model does: it is fused once at load time);
    otherwise it is concatenated here."""
    _check_quant(cfg)
    if cfg.impl == "reference":
        return qkv_projection_reference(x, wq, wk, wv, bq, bk, bv,
                                        tile_d=cfg.tile_d)
    if cfg.impl == "pallas":
        from repro_torch.kernels.qkv import ops as qkv_ops
        w = w_qkv if w_qkv is not None else fuse_qkv_weights(wq, wk, wv)
        shapes = (wq.shape[1:], wk.shape[1:], wv.shape[1:])
        return qkv_ops.qkv_projection(x, w.to(x.dtype).contiguous(), shapes,
                                      bq, bk, bv)
    return qkv_projection_xla(x, wq, wk, wv, bq, bk, bv, w_qkv=w_qkv)


# ---------------------------------------------------------------------------
# attention against a KV cache (serving)
# ---------------------------------------------------------------------------


def _broadcast_kv(x, num_q_heads):
    """GQA: repeat kv heads to match query heads. x: (B, S, KV, dh)."""
    kv = x.shape[-2]
    if kv == num_q_heads:
        return x
    return torch.repeat_interleave(x, num_q_heads // kv, dim=-2)


def _dense_masked(q, k, v, ok, scale):
    """Dense oracle: softmax over keys where ``ok`` (broadcast to
    (B, H, Sq, Skv)); a row with no visible key is NaN, as in JAX."""
    H = q.shape[2]
    k = _broadcast_kv(k, H)
    v = _broadcast_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale,
                     k.to(torch.float32))
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None,
                     cfg: FamousConfig = FamousConfig()):
    """One-token attention against a KV cache (serving decode step).

    q: (B, 1, H, dh); caches: (B, S_max, KV, dh); cache_len: (B,) int —
    number of valid cache entries (the new token's k/v already written)."""
    dh = q.shape[-1]
    Smax = k_cache.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    if cfg.impl == "pallas":
        from repro_torch.kernels.decode import ops as dec_ops
        return dec_ops.decode_attention(q, k_cache, v_cache, cache_len,
                                        scale=scale)
    pos = torch.arange(Smax, device=q.device)[None, :]
    ok = pos < cache_len.to(q.device)[:, None]                # (B, Smax)
    return _dense_masked(q, k_cache, v_cache, ok[:, None, None, :], scale)


def chunked_prefill_attention(q, k_cache, v_cache, q_offset: int, *,
                              scale=None, cfg: FamousConfig = FamousConfig()):
    """Chunked-prefill attention: a chunk of C query tokens at absolute
    positions ``[q_offset, q_offset + C)`` attends causally to the resident
    prefix plus its own chunk, both already written into the cache.

    q: (B, C, H, dh); caches: (B, S_max, KV, dh); ``q_offset`` a host
    integer — one kernel build serves every offset."""
    C, dh = q.shape[1], q.shape[-1]
    Skv = k_cache.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    if cfg.impl == "pallas":
        from repro_torch.kernels.decode import ops as dec_ops
        return dec_ops.chunk_prefill_attention(q, k_cache, v_cache, q_offset,
                                               scale=scale)
    q_pos = q_offset + torch.arange(C, device=q.device)
    ok = torch.arange(Skv, device=q.device)[None, :] <= q_pos[:, None]
    return _dense_masked(q, k_cache, v_cache, ok[None, None], scale)
