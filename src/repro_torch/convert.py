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
    port's serving-layout params: every leaf crosses once in its own dtype
    (recurrent blocks' ``rec``/``tm``/``cm`` leaves too, and an MoE FFN's
    f32 ``router`` and its ``(E, d, f)`` / ``(E, f, d)`` expert stacks,
    which stay unfused), then ``[Wq|Wk|Wv]`` is fused in each attention
    layer at load time (``transformer.prepare_params``)."""
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
    """The JAX cache tree ``{"blocks": {"pos<i>": {...}}}`` (stacked
    ``(num_units, ...)`` leaves, plus ``tail<i>``) as the port's per-layer
    caches, every leaf carried: contiguous ``k``/``v`` stripes and
    sliding-window rings, paged pools and the int8 pools'
    ``k_scale``/``v_scale``, RG-LRU ``h``/``conv`` and RWKV-6
    ``s``/``x_tm``/``x_cm`` state."""
    out = []
    for u in range(cfg.num_units):
        for i in range(len(cfg.pattern_unit)):
            c = tree["blocks"][f"pos{i}"]
            out.append({n: to_torch(np.asarray(a)[u], device)
                        for n, a in c.items()})
    for i in range(len(cfg.tail_layers)):
        c = tree[f"tail{i}"]
        out.append({n: to_torch(a, device) for n, a in c.items()})
    return out
