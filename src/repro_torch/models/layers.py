"""Shared layers: norms, RoPE, MLPs, embeddings (the port of
``repro.models.layers``), plain functions on tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.module import ParamSpec

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_spec(d: int, kind: str = "rmsnorm") -> dict:
    spec = {"scale": ParamSpec((d,), (None,), init="ones")}
    if kind == "layernorm":
        spec["bias"] = ParamSpec((d,), (None,), init="zeros")
    return spec


def apply_norm(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """Dtype-preserving RMSNorm or LayerNorm, as in the JAX package: the
    statistics accumulate in f32 (the square is taken in ``x.dtype``, the
    mean in f32) but the tensor itself is never upcast."""
    dt = x.dtype
    if kind == "rmsnorm":
        ms = torch.mean(x.square(), -1, keepdim=True, dtype=torch.float32)
        inv = torch.rsqrt(ms + eps).to(dt)
        return x * inv * p["scale"].to(dt)
    mu = torch.mean(x, -1, keepdim=True, dtype=torch.float32)
    xc = x - mu.to(dt)
    var = torch.mean(xc.square(), -1, keepdim=True, dtype=torch.float32)
    y = xc * torch.rsqrt(var + eps).to(dt)
    return y * p["scale"].to(dt) + p["bias"].to(dt)


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


def act_fn(name: str):
    """``jax.nn.gelu`` defaults to the tanh approximation, so gelu here is
    ``F.gelu(approximate="tanh")``; ``jax.nn.silu`` is ``F.silu``."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp_spec(d: int, d_ff: int, act: str = "silu", gated: bool = True) -> dict:
    del act  # the activation has no parameters
    spec = {
        "w_in": ParamSpec((d, d_ff), ("embed", "mlp")),
        "w_out": ParamSpec((d_ff, d), ("mlp", "embed")),
    }
    if gated:
        spec["w_gate"] = ParamSpec((d, d_ff), ("embed", "mlp"))
    return spec


def apply_mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """act(x W_gate) * (x W_in) when gated, else act(x W_in); then
    W_out."""
    h = x @ p["w_in"].to(x.dtype)
    if "w_gate" in p:
        h = act_fn(act)(x @ p["w_gate"].to(x.dtype)) * h
    else:
        h = act_fn(act)(h)
    return h @ p["w_out"].to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def embed_spec(vocab: int, d: int) -> dict:
    return {"embedding": ParamSpec((vocab, d), ("vocab", "embed"),
                                   init="embed", scale=0.02)}


def embed_lookup(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["embedding"].to(dtype)[tokens]


def unembed_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits through the tied embedding: x (..., d) @ embedding^T."""
    return x.to(torch.float32) @ p["embedding"].to(torch.float32).t()
