"""AdamW (the port of ``repro.optim.adamw``): the same f32 moment math,
with a configurable moment dtype.

Unlike the JAX version, which returns new trees, :func:`apply_updates`
updates the parameters and both moments **in place** under
``torch.no_grad()`` (it still returns them, so call sites read alike): a
full-width model keeps one copy of each, not two.  The step counter
``count`` is a 0-dim int32 tensor on the host, so the bias corrections are
host scalars and the update never waits on the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.models.module import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: Any = torch.float32
    grad_clip: float = 1.0


def init_opt_state(params, cfg: AdamWConfig):
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-dim tensor on
    the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: AdamWConfig,
                  lr_scale: float = 1.0):
    """One AdamW step, in place.  Returns (params, opt_state, metrics)."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    count = int(opt_state["count"]) + 1
    # f32 bias corrections, as JAX computes them (b ** count in f32)
    b1c = float(1.0 - np.float32(cfg.b1) ** np.float32(count))
    b2c = float(1.0 - np.float32(cfg.b2) ** np.float32(count))
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        step = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * step)
        m.copy_(m_new)
        v.copy_(v_new)
    opt_state["count"] = torch.tensor(count, dtype=torch.int32)
    return params, opt_state, {"grad_norm": gnorm}


def cosine_schedule(step, *, base_lr_scale: float = 1.0, warmup: int = 100,
                    total: int = 10000, min_frac: float = 0.1) -> float:
    """Multiplier for cfg.lr: linear warmup + cosine decay (f32, as in
    JAX)."""
    f = np.float32
    step = f(int(step))
    warm = min(step / f(max(warmup, 1)), f(1.0))
    prog = np.clip((step - f(warmup)) / f(max(total - warmup, 1)), f(0), f(1))
    cos = f(min_frac) + f(1 - min_frac) * f(0.5) * (f(1) + np.cos(f(math.pi)
                                                               * prog))
    return float(f(base_lr_scale) * warm * cos)
