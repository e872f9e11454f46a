"""Block-stack model (the port of ``repro.models.transformer``,
all-global-attention stacks with a dense FFN: decoders such as qwen2-7b
and the famous-bert encoder).

Parameters come in two layouts:

  * the **spec tree** of :func:`model_spec` — the JAX package's structure,
    stacked ``(num_units, ...)`` leaves included, as ``init_params`` and
    ``repro_torch.convert`` produce it.  :func:`forward` (training) takes
    this one, so gradients land in the stacked leaves;
  * the **serving layout** of :func:`prepare_params` — one dict per layer
    (views into the stacked leaves), ``[Wq|Wk|Wv]`` fused once per layer,
    and one f32 copy of the LM head.  The serving step functions take it.

JAX's ``lax.scan`` over the stacked units becomes a loop over them; its
``jax.checkpoint`` around each unit becomes ``torch.utils.checkpoint``.
Caches are one contiguous ``{"k", "v"}`` pair per layer, written in place
(see ``models/attention.py``).
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
                device="cuda") -> list:
    """One contiguous ``(batch, max_seq, kv, dh)`` K/V pair per layer."""
    _check_supported(cfg)
    return [attention.make_attn_cache(cfg, batch, max_seq, dtype, device)
            for _ in range(cfg.num_layers)]


def prefill_chunk(params, tokens, caches, slot: int, offset: int,
                  n_valid: int, cfg: ModelConfig,
                  fcfg: FamousConfig = FamousConfig()):
    """One fixed-shape prefill chunk for a single slot of the batched caches.

    tokens: (1, C) int at absolute positions [offset, offset+C); only the
    first ``n_valid`` are real (the pad tail's junk K/V is never read).
    Writes K/V for ``slot`` into the caches in place.  ``slot``, ``offset``
    and ``n_valid`` are host integers.  Returns the caches only: prefill
    logits are dead weight (generation restarts by decoding the last prompt
    token), so the LM head is never computed."""
    del n_valid  # attention-only stacks mask the pad tail causally
    x = layers.embed_lookup(params["embed"], tokens, _compute_dtype(params))
    for p, cache in zip(params["layers"], caches):
        a, _ = attention.apply_attn_chunk(
            p["attn"], layers.apply_norm(p["ln1"], x, cfg.norm), cache, slot,
            offset, cfg, fcfg)
        x = x + a
        x = x + layers.apply_mlp(
            p["ffn"], layers.apply_norm(p["ln2"], x, cfg.norm), cfg.act)
    return caches


def decode_step(params, tokens, caches, cache_len, cfg: ModelConfig,
                fcfg: FamousConfig = FamousConfig()):
    """tokens: (B,) int; cache_len: (B,) int32 on the device.  Runs over
    every slot (fixed batch): attention caches need no ``active`` mask, as
    the junk K/V of inactive slots is masked by ``cache_len`` and
    overwritten by the next chunk.  Returns (logits (B, vocab) f32,
    caches)."""
    x = layers.embed_lookup(params["embed"], tokens[:, None],
                            _compute_dtype(params))
    for p, cache in zip(params["layers"], caches):
        a, _ = attention.apply_attn_decode(
            p["attn"], layers.apply_norm(p["ln1"], x, cfg.norm), cache,
            cache_len, cfg, fcfg)
        x = x + a
        x = x + layers.apply_mlp(
            p["ffn"], layers.apply_norm(p["ln2"], x, cfg.norm), cfg.act)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return logits_fn(params, x, cfg)[:, 0], caches


def clear_slot(caches, slot: int) -> list:
    """Zero slot ``slot``'s cache rows in place (stale-state hygiene for
    length-1 admissions that skip prefill)."""
    for cache in caches:
        for buf in cache.values():
            buf[slot].zero_()
    return caches
