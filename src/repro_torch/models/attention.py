"""Attention block: GQA dense MHA built on the FAMOUS core — full-sequence
attention for training and encoders, and a contiguous per-slot KV cache
for serving (the port of ``repro.models.attention``, global-attention
branch).

Cache writes are **in place**: ``apply_attn_chunk`` writes the chunk's K/V
into ``cache["k"][slot, offset:offset+C]`` and ``apply_attn_decode`` writes
each slot's new K/V at its ``cache_len``, mutating the tensors the caller
passed.  The JAX functions are functional (they return updated copies);
both return the cache so the call sites read alike.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import famous
from repro_torch.models import layers
from repro_torch.models.module import ParamSpec


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


def make_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    device="cuda") -> dict:
    """Contiguous (batch, max_seq, kv, dh) K/V buffers of one layer."""
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _project(p, x, cfg: ModelConfig, fcfg: famous.FamousConfig, positions):
    q, k, v = famous.qkv_projection(
        x, p["wq"], p["wk"], p["wv"], p.get("bq"), p.get("bk"), p.get("bv"),
        cfg=fcfg, w_qkv=p.get("w_qkv"))
    if cfg.qk_norm:
        raise NotImplementedError(
            "qk_norm comes with the model-forward slice of the port "
            "(ROADMAP Queue 1)")
    if cfg.rope:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out, wo):
    """einsum("bshe,hed->bsd") as one matmul."""
    B, S, H, dh = out.shape
    return out.reshape(B, S, H * dh) @ wo.to(out.dtype).reshape(H * dh, -1)


def apply_attn(p: dict, x: torch.Tensor, cfg: ModelConfig,
               fcfg: famous.FamousConfig, *, window: int = 0,
               q_offset: int = 0) -> torch.Tensor:
    """Full-sequence attention (training / encoder). x: (B, S, D)."""
    S = x.shape[1]
    positions = q_offset + torch.arange(S, device=x.device)
    q, k, v = _project(p, x, cfg, fcfg, positions)
    out = famous.attention(q, k, v, causal=cfg.causal, window=window,
                           q_offset=q_offset, cfg=fcfg)
    return _out_proj(out, p["wo"])


def apply_attn_chunk(p: dict, x: torch.Tensor, cache: dict, slot: int,
                     offset: int, cfg: ModelConfig,
                     fcfg: famous.FamousConfig):
    """Chunked prefill for one slot of the batched cache.

    x: (1, C, D) — the chunk at absolute positions [offset, offset+C);
    cache: {"k","v"} (n_slots, S, kv, dh).  Writes the chunk's K/V into the
    slot in place and attends against resident prefix + own chunk, read
    from the slot's stripe as a view (no copy).  Pad positions at the
    chunk tail write junk K/V beyond the prompt, which is never read.
    Returns (out (1, C, D), cache)."""
    C = x.shape[1]
    positions = offset + torch.arange(C, device=x.device)
    q, k, v = _project(p, x, cfg, fcfg, positions)
    cache["k"][slot, offset:offset + C] = k[0].to(cache["k"].dtype)
    cache["v"][slot, offset:offset + C] = v[0].to(cache["v"].dtype)
    out = famous.chunked_prefill_attention(
        q, cache["k"][slot:slot + 1], cache["v"][slot:slot + 1], offset,
        cfg=fcfg)
    return _out_proj(out, p["wo"]), cache


def apply_attn_decode(p: dict, x: torch.Tensor, cache: dict,
                      cache_len: torch.Tensor, cfg: ModelConfig,
                      fcfg: famous.FamousConfig):
    """One-token decode. x: (B, 1, D); cache_len: (B,) int32 valid entries
    BEFORE this token, on the device.  Every slot writes its new K/V at its
    ``cache_len`` (clamped to the last row, as JAX's dynamic_update_slice
    clamps) — inactive slots write junk that the next chunk overwrites.
    Returns (out, cache)."""
    B = x.shape[0]
    positions = cache_len[:, None]                 # (B, 1) absolute positions
    q, k, v = _project(p, x, cfg, fcfg, positions)
    rows = torch.arange(B, device=x.device)
    at = cache_len.clamp(max=cache["k"].shape[1] - 1)
    cache["k"][rows, at] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, at] = v[:, 0].to(cache["v"].dtype)
    out = famous.decode_attention(q, cache["k"], cache["v"], cache_len + 1,
                                  cfg=fcfg)
    return _out_proj(out, p["wo"]), cache
