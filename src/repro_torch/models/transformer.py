"""Block-stack model (the port of ``repro.models.transformer``,
all-global-attention stacks with a dense FFN: decoders such as qwen2-7b
and the famous-bert encoder).

Parameters come in two layouts:

  * the **spec tree** of :func:`model_spec` — the JAX package's structure,
    stacked ``(num_units, ...)`` leaves included, as ``init_params`` and
    ``repro_torch.convert`` produce it.  :func:`forward` (training) takes
    this one, so gradients land in the stacked leaves;
  * the **serving layout** of :func:`prepare_params` — one dict per layer
    (views into the stacked leaves), ``[Wq|Wk|Wv]`` fused once per layer
    (and, by :func:`quantize_qkv`, quantized once for the int8 kernel),
    and one f32 copy of the LM head.  The serving step functions take it.

JAX's ``lax.scan`` over the stacked units becomes a loop over them; its
``jax.checkpoint`` around each unit becomes ``torch.utils.checkpoint``.
Caches are one ``{"k", "v"}`` pair per layer — contiguous per-slot stripes,
or a shared page pool (plus f32 scale pools when int8) that the serving
steps address through a ``page_table`` — written in place (see
``models/attention.py``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core.famous import FamousConfig
from repro_torch.models import attention, layers
from repro_torch.models.module import ParamSpec, stack_specs

# ---------------------------------------------------------------------------
# parameter spec
# ---------------------------------------------------------------------------


def _check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.pattern_unit) | set(cfg.tail_layers)
    if (kinds != {ATTN} or cfg.num_experts or cfg.qk_norm
            or cfg.norm not in ("rmsnorm", "layernorm")
            or cfg.act not in ("silu", "gelu")):
        raise NotImplementedError(
            f"{cfg.name}: the port runs all-global-attention stacks with "
            "RMSNorm or LayerNorm and a dense SiLU/GELU FFN; other blocks, "
            "MoE and qk_norm come with later slices (ROADMAP Queue 1)")


def _ffn_spec(cfg: ModelConfig):
    gated = cfg.act in ("silu", "gelu") and cfg.norm == "rmsnorm"
    return layers.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, gated=gated)


def block_spec(kind: str, cfg: ModelConfig) -> dict:
    if kind != ATTN:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    d = cfg.d_model
    return {
        "ln1": layers.norm_spec(d, cfg.norm),
        "attn": attention.attn_spec(cfg),
        "ln2": layers.norm_spec(d, cfg.norm),
        "ffn": _ffn_spec(cfg),
    }


def model_spec(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    unit = {f"pos{i}": block_spec(k, cfg)
            for i, k in enumerate(cfg.pattern_unit)}
    spec: dict[str, Any] = {
        "embed": layers.embed_spec(cfg.vocab_size, cfg.d_model),
        "blocks": stack_specs(unit, cfg.num_units),
        "final_norm": layers.norm_spec(cfg.d_model, cfg.norm),
    }
    for i, k in enumerate(cfg.tail_layers):
        spec[f"tail{i}"] = block_spec(k, cfg)
    if not cfg.tie_embeddings:
        spec["lm_head"] = {
            "w": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                           scale=0.02)
        }
    return spec


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def prepare_params(params: dict, cfg: ModelConfig) -> dict:
    """Spec tree -> serving layout (idempotent).

    The LM head is held once in f32 (``logits_fn`` computes in f32, as in
    JAX): for bf16 weights that is one extra ``d_model x vocab`` f32 tensor
    (2.2 GB at qwen2-7b's width) made here, instead of a fresh f32 copy of
    the head on every decode step."""
    if "layers" in params:
        return params
    _check_supported(cfg)
    per_layer = []
    for u in range(cfg.num_units):
        unit = _index_tree(params["blocks"], u)
        for i in range(len(cfg.pattern_unit)):
            per_layer.append(unit[f"pos{i}"])
    for i in range(len(cfg.tail_layers)):
        per_layer.append(params[f"tail{i}"])
    out_layers = []
    for blk in per_layer:
        blk = dict(blk)
        blk["attn"] = attention.fuse_qkv(blk["attn"])
        out_layers.append(blk)
    if cfg.tie_embeddings:
        unembed = params["embed"]["embedding"].to(torch.float32).t()
    else:
        unembed = params["lm_head"]["w"].to(torch.float32)
    return {"embed": params["embed"], "layers": out_layers,
            "final_norm": params["final_norm"], "unembed_f32": unembed}


def quantize_qkv(params: dict) -> dict:
    """The serving layout with every layer's fused QKV weight also
    quantized once to int8 (``attention.quantize_qkv``), for
    ``FamousConfig(impl="pallas", quant="int8")``.  Returns a new dict;
    the tensors it shares with ``params`` are not copied."""
    layers_q = [dict(blk, attn=attention.quantize_qkv(blk["attn"]))
                for blk in params["layers"]]
    return dict(params, layers=layers_q)


# ---------------------------------------------------------------------------
# block application (full sequence)
# ---------------------------------------------------------------------------


def apply_block(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
                fcfg: FamousConfig, q_offset: int = 0) -> torch.Tensor:
    """One attention block on the full sequence, x: (B, S, D).  (The JAX
    block's ``constrain_residual`` sharding hints have no meaning on one
    device and are dropped.)"""
    if kind != ATTN:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    x = x + attention.apply_attn(p["attn"],
                                 layers.apply_norm(p["ln1"], x, cfg.norm),
                                 cfg, fcfg, q_offset=q_offset)
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    return x + layers.apply_mlp(p["ffn"], h, cfg.act)


def forward(params: dict, inputs: torch.Tensor, cfg: ModelConfig,
            fcfg: FamousConfig = FamousConfig(), *, remat: bool = True,
            return_hidden: bool = False, compute_dtype=None) -> torch.Tensor:
    """inputs: int tokens (B, S), on the spec tree.  Returns f32 logits
    (B, S, vocab), or the final hidden states (B, S, D) when
    ``return_hidden`` (the chunked loss computes logits chunk by chunk).

    The loop over stacked units indexes the ``(num_units, ...)`` leaves,
    so gradients land in them.  ``remat=True`` recomputes each unit in the
    backward (``torch.utils.checkpoint``, non-reentrant), as
    ``jax.checkpoint`` does."""
    _check_supported(cfg)
    x = layers.embed_lookup(
        params["embed"], inputs,
        compute_dtype or params["final_norm"]["scale"].dtype)

    def unit_body(x, u):
        unit = _index_tree(params["blocks"], u)
        for i, kind in enumerate(cfg.pattern_unit):
            x = apply_block(kind, unit[f"pos{i}"], x, cfg, fcfg)
        return x

    for u in range(cfg.num_units):
        x = (checkpoint(unit_body, x, u, use_reentrant=False) if remat
             else unit_body(x, u))
    for i, kind in enumerate(cfg.tail_layers):
        x = apply_block(kind, params[f"tail{i}"], x, cfg, fcfg)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x
    return logits_fn(params, x, cfg)


# ---------------------------------------------------------------------------
# serving: caches, chunked prefill, decode
# ---------------------------------------------------------------------------


def logits_fn(params, x, cfg: ModelConfig):
    """f32 logits (..., vocab) from final hidden states, on either layout
    (the serving layout holds its f32 LM head once)."""
    if "unembed_f32" in params:
        return x.to(torch.float32) @ params["unembed_f32"]
    if cfg.tie_embeddings:
        return layers.unembed_logits(params["embed"], x)
    return x.to(torch.float32) @ params["lm_head"]["w"].to(torch.float32)


def _compute_dtype(params):
    return params["final_norm"]["scale"].dtype


def make_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                device="cuda", *, cache_kind: str = "contiguous",
                page_size: int = 0, n_pages: int = 0,
                kv_dtype: str = "fp") -> list:
    """One K/V cache per layer.

    cache_kind="contiguous": a ``(batch, max_seq, kv, dh)`` pair per layer.
    cache_kind="paged": a shared ``(n_pages, page_size, kv, dh)`` pool per
    layer, addressed through the page table that ``prefill_chunk`` and
    ``decode_step`` receive; memory then follows live tokens, not
    ``batch x max_seq`` (see ``serve/paged.py``).  kv_dtype="int8" (paged
    only) stores int8 pools with f32 per-token scale pools; writes
    quantize, the kernels dequantize in their tiles."""
    _check_supported(cfg)
    if cache_kind not in ("contiguous", "paged"):
        raise ValueError(f"cache_kind {cache_kind!r}")
    if kv_dtype not in ("fp", "int8"):
        raise ValueError(f"kv_dtype {kv_dtype!r}")
    if cache_kind == "contiguous":
        if kv_dtype != "fp":
            raise ValueError("kv_dtype='int8' requires paged caches")
        return [attention.make_attn_cache(cfg, batch, max_seq, dtype, device)
                for _ in range(cfg.num_layers)]
    if page_size <= 0 or n_pages <= 0:
        raise ValueError(f"paged caches need page_size and n_pages, got "
                         f"{page_size}, {n_pages}")
    return [attention.make_paged_attn_cache(cfg, n_pages, page_size, dtype,
                                            kv_dtype, device)
            for _ in range(cfg.num_layers)]


def prefill_chunk(params, tokens, caches, slot: int, offset: int,
                  n_valid: int, cfg: ModelConfig,
                  fcfg: FamousConfig = FamousConfig(), page_table=None):
    """One fixed-shape prefill chunk for a single slot of the batched caches.

    tokens: (1, C) int at absolute positions [offset, offset+C); only the
    first ``n_valid`` are real (the pad tail's junk K/V is never read).
    Writes K/V for ``slot`` into the caches in place — its contiguous
    stripe, or, given ``page_table`` ((n_slots, n_p) int32 on the device),
    its pages of the pools.  ``slot``, ``offset`` and ``n_valid`` are host
    integers.  Returns the caches only: prefill logits are dead weight
    (generation restarts by decoding the last prompt token), so the LM
    head is never computed."""
    del n_valid  # attention-only stacks mask the pad tail causally
    x = layers.embed_lookup(params["embed"], tokens, _compute_dtype(params))
    for p, cache in zip(params["layers"], caches):
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        if page_table is not None:
            a, _ = attention.apply_attn_chunk_paged(
                p["attn"], h, cache, page_table, slot, offset, cfg, fcfg)
        else:
            a, _ = attention.apply_attn_chunk(p["attn"], h, cache, slot,
                                              offset, cfg, fcfg)
        x = x + a
        x = x + layers.apply_mlp(
            p["ffn"], layers.apply_norm(p["ln2"], x, cfg.norm), cfg.act)
    return caches


def decode_step(params, tokens, caches, cache_len, cfg: ModelConfig,
                fcfg: FamousConfig = FamousConfig(), page_table=None):
    """tokens: (B,) int; cache_len: (B,) int32 on the device; page_table:
    optional (B, n_p) int32 on the device, given when the caches are page
    pools.  Runs over every slot (fixed batch): attention caches need no
    ``active`` mask, as the junk K/V of inactive slots is masked by
    ``cache_len`` and overwritten by the next chunk (or lands on the null
    page).  Returns (logits (B, vocab) f32, caches)."""
    x = layers.embed_lookup(params["embed"], tokens[:, None],
                            _compute_dtype(params))
    for p, cache in zip(params["layers"], caches):
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        if page_table is not None:
            a, _ = attention.apply_attn_decode_paged(
                p["attn"], h, cache, page_table, cache_len, cfg, fcfg)
        else:
            a, _ = attention.apply_attn_decode(p["attn"], h, cache,
                                               cache_len, cfg, fcfg)
        x = x + a
        x = x + layers.apply_mlp(
            p["ffn"], layers.apply_norm(p["ln2"], x, cfg.norm), cfg.act)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return logits_fn(params, x, cfg)[:, 0], caches


def verify_step(params, tokens, caches, cache_len, cfg: ModelConfig,
                fcfg: FamousConfig = FamousConfig(), page_table=None):
    """Speculative verify: decode W tokens per slot in ONE forward.

    tokens: (B, W) int — row b is ``[last_token, draft_1..draft_{W-1}]``
    at absolute positions ``cache_len[b] + j`` (pad rows past a short draft
    are ignored by the caller); cache_len: (B,) int32 valid entries BEFORE
    the first token, on the device; page_table as in :func:`decode_step`.
    Returns (logits (B, W, vocab) f32, caches): ``logits[b, j]`` is what
    the j+1-th of sequential :func:`decode_step` calls over ``tokens[b,
    :j+1]`` would give (causal attention makes the two identical), so the
    engine can accept the longest draft prefix the model agrees with and
    stay token-identical to plain decode.  Only global-attention stacks
    verify (the port runs no other kind)."""
    kinds = set(cfg.pattern_unit) | set(cfg.tail_layers)
    if kinds != {ATTN}:
        raise ValueError(f"verify_step only supports global-attention "
                         f"layers, got {sorted(kinds)}")
    x = layers.embed_lookup(params["embed"], tokens, _compute_dtype(params))
    writes = None
    if page_table is None:   # one host sync for every layer's write indices
        writes = attention.verify_writes(cache_len, tokens.shape[1],
                                         caches[0]["k"].shape[1])
    for p, cache in zip(params["layers"], caches):
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        if page_table is not None:
            a, _ = attention.apply_attn_verify_paged(
                p["attn"], h, cache, page_table, cache_len, cfg, fcfg)
        else:
            a, _ = attention.apply_attn_verify(p["attn"], h, cache,
                                               cache_len, cfg, fcfg,
                                               writes=writes)
        x = x + a
        x = x + layers.apply_mlp(
            p["ffn"], layers.apply_norm(p["ln2"], x, cfg.norm), cfg.act)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return logits_fn(params, x, cfg), caches


def clear_slot(caches, slot: int, paged: bool = False) -> list:
    """Zero slot ``slot``'s cache rows in place (stale-state hygiene for
    length-1 admissions that skip prefill).  Page pools have no slot axis
    (``buf[slot]`` would be page ``slot``, a live page) and are left
    alone: the slot's pages were freed, and any stale content is
    unreachable (its table row is null, reads are ``cache_len``-masked)."""
    if paged:
        return caches
    for cache in caches:
        for buf in cache.values():
            buf[slot].zero_()
    return caches
