"""Training step (the port of ``repro.train.step``): microbatched gradient
accumulation, clipping, AdamW.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``.  The JAX step is a pure function; this one updates ``state``
in place (parameters and moments through ``adamw.apply_updates``) and
returns it.  The state tree is ``{"params", "opt": {"m", "v", "count"},
"step"}`` with the parameters on the device (leaves that require grad)
and ``count`` / ``step`` as 0-dim int32 host tensors.
``TrainConfig.grad_compression`` is accepted and, as in JAX, not read.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.famous import FamousConfig
from repro_torch.models import module, transformer
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.train import losses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    loss_chunk: int = 512
    z_loss: float = 0.0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16   # bf16 activations/matmuls
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    schedule_warmup: int = 100
    schedule_total: int = 10000
    # int8 error-feedback pod-axis reduction: JAX's make_train_step never
    # reads the flag, so a run with it on trains exactly as one with it off
    grad_compression: bool = False


def init_state(cfg: ModelConfig, tcfg: TrainConfig, gen: torch.Generator,
               device="cuda") -> dict:
    """Fresh state: parameters from ``gen`` (same init rules as JAX, other
    random bits), zero moments, step 0."""
    params = module.init_params(transformer.model_spec(cfg), gen,
                                tcfg.param_dtype, device)
    tree_map(lambda p: p.requires_grad_(True), params)
    return {"params": params,
            "opt": adamw.init_opt_state(params, tcfg.optimizer),
            "step": torch.zeros((), dtype=torch.int32)}


def state_logical_axes(cfg: ModelConfig) -> dict:
    """Logical-axis tree of the train state: the parameters' axes for the
    parameters and both moments, ``()`` for the scalars."""
    axes = module.logical_axes(transformer.model_spec(cfg))
    return {"params": axes, "opt": {"m": axes, "v": axes, "count": ()},
            "step": ()}


def make_train_step(cfg: ModelConfig, fcfg: FamousConfig, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics); batch holds
    int ``targets`` (B, S) and ``inputs``, int tokens (B, S) or a stub
    frontend's float embeddings (B, S, D), on the parameters' device.  As
    in JAX, the loss is the LM loss alone: no MoE load-balance term.
    ``train_step.grads_of(params, batch)`` is its (loss, grads) half."""
    if fcfg.quant != "none":
        raise ValueError(
            f"quant={fcfg.quant!r} cannot be trained: the int8 projection "
            "kernel has no gradient (neither has the JAX kernel: it defines "
            "no VJP) and rounding to int8 has none")

    def loss_fn(params, batch):
        return losses.lm_loss(params, batch, cfg, fcfg, remat=tcfg.remat,
                              chunk=tcfg.loss_chunk, z_loss=tcfg.z_loss,
                              compute_dtype=tcfg.compute_dtype)

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(params, batch)
        # a leaf the loss never reads (the token embedding of a stub
        # frontend fed embeddings) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), _unflatten(params, grads)

    def grads_of(params, batch):
        if tcfg.microbatches <= 1:
            return grad_fn(params, batch)
        n = tcfg.microbatches
        losses, acc = [], None
        for mb in zip(*(v.chunk(n) for v in batch.values())):
            loss, g = grad_fn(params, dict(zip(batch, mb)))
            losses.append(loss)
            g = tree_map(lambda x: x.to(torch.float32), g)
            acc = g if acc is None else tree_map_pair(torch.add, acc, g)
        inv = 1.0 / n
        return sum(losses) * inv, tree_map(lambda x: x * inv, acc)

    def train_step(state, batch):
        loss, grads = grads_of(state["params"], batch)
        lr_scale = adamw.cosine_schedule(
            int(state["step"]), warmup=tcfg.schedule_warmup,
            total=tcfg.schedule_total)
        _, _, om = adamw.apply_updates(state["params"], grads, state["opt"],
                                       tcfg.optimizer, lr_scale)
        state["step"] = state["step"] + 1
        metrics = {"loss": loss, "grad_norm": om["grad_norm"],
                   "lr_scale": lr_scale}
        return state, metrics

    train_step.grads_of = grads_of
    return train_step


def tree_map_pair(fn, a, b):
    """``fn`` over the leaves of two trees of one structure."""
    if isinstance(a, dict):
        return {k: tree_map_pair(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _unflatten(tree, leaves: list):
    """A tree of ``tree``'s structure holding ``leaves`` (sorted-key
    order, as :func:`tree_leaves` gives them)."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return leaves.pop(0)
