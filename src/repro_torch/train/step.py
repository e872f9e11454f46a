"""Training step (the port of ``repro.train.step``): microbatched gradient
accumulation, clipping, AdamW.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``.  The JAX step is a pure function; this one updates ``state``
in place (parameters and moments through ``adamw.apply_updates``) and
returns it.  The state tree is ``{"params", "opt": {"m", "v", "count"},
"step"}`` with the parameters on the device (leaves that require grad)
and ``count`` / ``step`` as 0-dim int32 host tensors.  The gradient
compression of the JAX step (a shard_map over the pod axis) comes with the
mesh slice of the port.
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
    grad_compression: bool = False   # int8 EF pod-axis reduction (not ported)


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


def make_train_step(cfg: ModelConfig, fcfg: FamousConfig, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics); batch holds
    int ``inputs`` and ``targets`` (B, S) on the parameters' device.
    ``train_step.grads_of(params, batch)`` is its (loss, grads) half."""
    if tcfg.grad_compression:
        raise NotImplementedError(
            "grad_compression=True comes with the mesh / gradient-"
            "compression slice of the port (ROADMAP Queue 1, slice 8)")

    def loss_fn(params, batch):
        return losses.lm_loss(params, batch, cfg, fcfg, remat=tcfg.remat,
                              chunk=tcfg.loss_chunk, z_loss=tcfg.z_loss,
                              compute_dtype=tcfg.compute_dtype)

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), _unflatten(params, list(grads))

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
