"""Modality frontend STUBS (the port of ``repro.models.frontends``): the
``[audio]`` / ``[vlm]`` configs specify the transformer backbone only, and
the model takes precomputed frame or patch embeddings (B, S, d_model)
where a decoder takes tokens.

The stubs document what the real frontend would be and make deterministic
synthetic embeddings of the right shape for smoke runs.  The random bits
come from a ``torch.Generator`` and differ from ``jax.random``'s; where the
two packages must agree, feed both the same numpy array (the data
pipeline's frontend batches are numpy Philox and bit-equal to JAX's).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

FRONTEND_DOC = {
    "audio": "HuBERT CNN waveform encoder: 7-layer conv stack, 20 ms stride "
             "-> frame embeddings (B, S, d_model).",
    "vlm": "LLaVA-NeXT anyres tiler + CLIP ViT + 2-layer MLP projector -> "
           "patch embeddings interleaved with text embeddings (B, S, d_model).",
}


def embed_shape(cfg: ModelConfig, batch: int, seq: int):
    return (batch, seq, cfg.d_model)


def input_struct(cfg: ModelConfig, batch: int, seq: int,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Shape-and-dtype stand-in for the frontend output: a tensor on the
    ``meta`` device, which holds no memory."""
    return torch.empty(embed_shape(cfg, batch, seq), dtype=dtype,
                       device="meta")


def synthetic_embeddings(cfg: ModelConfig, batch: int, seq: int,
                         gen: torch.Generator, dtype=torch.float32,
                         device="cuda") -> torch.Tensor:
    """Deterministic fake frontend output from ``gen`` (a generator on
    ``device``): 0.02 x a standard normal, drawn in f32."""
    x = torch.randn(embed_shape(cfg, batch, seq), generator=gen,
                    dtype=torch.float32, device=device)
    return (0.02 * x).to(dtype)
