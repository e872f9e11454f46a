"""Carry weights and caches from the JAX package into the port.

Both directions go through numpy, so this module imports neither ``jax``
nor ``repro``: hand it the JAX trees as they are (``jax.Array`` leaves
convert with ``np.asarray``).  bf16 crosses as a uint16 view, because numpy
has no bf16 of its own and JAX hands out ``ml_dtypes`` arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.module import tree_map


def to_torch(a, device="cuda") -> torch.Tensor:
    """One array (numpy, ml_dtypes bf16, or anything ``np.asarray``
    accepts) as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def tree_from_jax(tree: dict, device="cuda") -> dict:
    """Any JAX tree of arrays, leaf for leaf, as tensors on ``device``
    (the spec-tree layout that ``transformer.forward`` takes)."""
    return tree_map(lambda a: to_torch(a, device), tree)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX parameter tree (``init_params(model_spec(cfg), ...)``,
    stacked leaves included; LayerNorm biases and ungated MLPs too) as the
    port's serving-layout params: every leaf crosses once, then
    ``[Wq|Wk|Wv]`` is fused per layer at load time
    (``transformer.prepare_params``)."""
    return transformer.prepare_params(tree_from_jax(tree, device), cfg)


def train_state_from_jax(state: dict, device="cuda") -> dict:
    """The JAX train state ``{"params", "opt": {"m", "v", "count"},
    "step"}`` as the port's (``repro_torch.train.step``): parameters and
    moments on ``device``, the parameters requiring grad; ``count`` and
    ``step`` as 0-dim int32 host tensors."""
    params = tree_from_jax(state["params"], device)
    tree_map(lambda p: p.requires_grad_(True), params)
    opt = state["opt"]
    return {"params": params,
            "opt": {"m": tree_from_jax(opt["m"], device),
                    "v": tree_from_jax(opt["v"], device),
                    "count": to_torch(opt["count"], "cpu").to(torch.int32)},
            "step": to_torch(state["step"], "cpu").to(torch.int32)}


def caches_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> list:
    """The JAX contiguous cache tree ``{"blocks": {"pos<i>": {"k", "v"}}}``
    (stacked ``(num_units, B, S, kv, dh)`` leaves, plus ``tail<i>``) as the
    port's per-layer caches."""
    out = []
    for u in range(cfg.num_units):
        for i in range(len(cfg.pattern_unit)):
            c = tree["blocks"][f"pos{i}"]
            out.append({n: to_torch(np.asarray(c[n])[u], device)
                        for n in ("k", "v")})
    for i in range(len(cfg.tail_layers)):
        c = tree[f"tail{i}"]
        out.append({n: to_torch(c[n], device) for n in ("k", "v")})
    return out
