"""Shared layers: norms, RoPE, MLPs, embeddings (the port of
``repro.models.layers``), plain functions on tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.module import ParamSpec

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_spec(d: int) -> dict:
    return {"scale": ParamSpec((d,), (None,), init="ones")}


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Dtype-preserving RMSNorm, as in the JAX package: the statistics
    accumulate in f32 (the square is taken in ``x.dtype``, the mean in f32)
    but the tensor itself is never upcast.  (LayerNorm comes with the slice
    that ports a model using it.)"""
    dt = x.dtype
    ms = torch.mean(x.square(), -1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(ms + eps).to(dt)
    return x * inv * p["scale"].to(dt)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split (not interleaved) RoPE with f32 angles.
    x: (B, S, H, dh), positions: (S,) or (B, S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.ndim == 1:
        ang = positions.to(torch.float32)[:, None] * freq[None, :]  # (S, half)
        ang = ang[None, :, None, :]
    else:
        ang = positions.to(torch.float32)[..., None] * freq        # (B, S, half)
        ang = ang[:, :, None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP / FFN (the paper's position-wise feed-forward network)
# ---------------------------------------------------------------------------


def mlp_spec(d: int, d_ff: int) -> dict:
    """The SiLU-gated FFN (the JAX ``mlp_spec`` with ``gated=True``)."""
    return {
        "w_in": ParamSpec((d, d_ff), ("embed", "mlp")),
        "w_out": ParamSpec((d_ff, d), ("mlp", "embed")),
        "w_gate": ParamSpec((d, d_ff), ("embed", "mlp")),
    }


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """silu(x W_gate) * (x W_in), then W_out (``jax.nn.silu`` is
    ``x * sigmoid(x)``, as ``F.silu``)."""
    h = x @ p["w_in"].to(x.dtype)
    g = x @ p["w_gate"].to(x.dtype)
    return (F.silu(g) * h) @ p["w_out"].to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def embed_spec(vocab: int, d: int) -> dict:
    return {"embedding": ParamSpec((vocab, d), ("vocab", "embed"),
                                   init="embed", scale=0.02)}


def embed_lookup(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["embedding"].to(dtype)[tokens]
