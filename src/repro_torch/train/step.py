"""Training step (the port of ``repro.train.step``): microbatched gradient
accumulation, clipping, AdamW.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``.  The JAX step is a pure function; this one updates ``state``
in place (parameters and moments through ``adamw.apply_updates``) and
returns it.  The state tree is ``{"params", "opt": {"m", "v", "count"},
"step"}`` with the parameters on the device (leaves that require grad)
and ``count`` / ``step`` as 0-dim int32 host tensors.
``TrainConfig.grad_compression`` is accepted and, as in JAX, not read
(``optim/compression.py`` has the int8 sum as a function of its own).

On a mesh (``mesh=``, a ``DeviceMesh`` over ``torch.distributed``, one
process a rank; ``rules`` a rule set of ``parallel/sharding.py``) the
state holds each rank's shard of every leaf under :func:`state_specs`,
the batch is the rank's rows (``pipeline.make_global_batch``), and the
step is the unsharded step's math, as GSPMD's is: each rank's gradient
is its slice of the unsharded gradient of the global batch's mean loss,
and every rank reports the same ``loss``, ``grad_norm`` and
``lr_scale`` (``models.transformer.TrainLayout`` says how).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.famous import FamousConfig
from repro_torch.models import module, transformer
from repro_torch.models.module import tree_leaves, tree_map, tree_map2
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
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
               device="cuda", mesh=None, rules=None) -> dict:
    """Fresh state: parameters from ``gen`` (same init rules as JAX, other
    random bits), zero moments, step 0.  On a ``mesh`` every rank draws
    the whole parameters from the same generator, then keeps (a copy of)
    its shards under :func:`state_specs`, so a mesh of one rank gives
    the ``mesh=None`` state bit for bit."""
    params = module.init_params(transformer.model_spec(cfg), gen,
                                tcfg.param_dtype, device)
    tree_map(lambda p: p.requires_grad_(True), params)
    state = {"params": params,
             "opt": adamw.init_opt_state(params, tcfg.optimizer),
             "step": torch.zeros((), dtype=torch.int32)}
    return state if mesh is None else shard_state(state, cfg, mesh, rules)


def state_shapes(cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """The :class:`~repro_torch.models.module.ShapeDtype` tree of
    :func:`init_state`'s state, allocating nothing (JAX's
    ``state_shapes``): parameters in ``tcfg.param_dtype``, both moments in
    ``tcfg.optimizer.moment_dtype``, ``count`` and ``step`` int32
    scalars (which :func:`init_state` keeps on the host: the step reads
    ``step`` there)."""
    p = module.param_shapes(transformer.model_spec(cfg), tcfg.param_dtype)
    mom = tree_map(lambda s: module.ShapeDtype(s.shape,
                                               tcfg.optimizer.moment_dtype), p)
    scalar = module.ShapeDtype((), torch.int32)
    return {"params": p, "opt": {"m": mom, "v": mom, "count": scalar},
            "step": scalar}


def shard_state(state: dict, cfg: ModelConfig, mesh, rules=None) -> dict:
    """This rank's shards of a whole train state on ``mesh`` under
    :func:`state_specs`: each leaf cut to (a copy of) its shard, so the
    whole leaf can be freed; parameters require grad as in ``state``."""
    coords = shd.mesh_coords(mesh)

    def own(t, spec):
        part = shd.local_shard(t, spec, mesh, coords)
        if part is t:
            return t
        return part.detach().clone().requires_grad_(t.requires_grad)

    return tree_map2(own, state, state_specs(cfg, mesh, rules))


def state_logical_axes(cfg: ModelConfig) -> dict:
    """Logical-axis tree of the train state: the parameters' axes for the
    parameters and both moments, ``()`` for the scalars."""
    axes = module.logical_axes(transformer.model_spec(cfg))
    return {"params": axes, "opt": {"m": axes, "v": axes, "count": ()},
            "step": ()}


def state_specs(cfg: ModelConfig, mesh, rules=None) -> dict:
    """The spec of every leaf of the train state on ``mesh`` under
    ``rules`` (default ``DEFAULT_RULES``), as JAX's launcher resolves
    :func:`state_logical_axes`: parameters and both moments alike,
    ``count`` and ``step`` replicated."""
    spec_tree = transformer.model_spec(cfg)
    specs = shd.tree_specs(mesh, module.logical_axes(spec_tree), rules,
                           module.param_shapes(spec_tree))
    return {"params": specs, "opt": {"m": specs, "v": specs, "count": ()},
            "step": ()}


def make_train_step(cfg: ModelConfig, fcfg: FamousConfig, tcfg: TrainConfig,
                    mesh=None, rules=None):
    """Returns train_step(state, batch) -> (state, metrics); batch holds
    int ``targets`` (B, S) and ``inputs``, int tokens (B, S) or a stub
    frontend's float embeddings (B, S, D), on the parameters' device.  As
    in JAX, the loss is the LM loss alone: no MoE load-balance term.
    ``train_step.grads_of(params, batch)`` is its (loss, grads) half.

    On a ``mesh`` the state is the rank's shards (:func:`init_state`) and
    ``batch`` the rank's rows; ``grads_of`` returns the rank's slice of
    the global gradient and the global loss; microbatches split the
    rank's rows, and rows that do not split into ``microbatches`` raise
    ``ValueError`` before any collective.  ``train_step.layout`` is the
    ``transformer.TrainLayout`` (None without a mesh) and
    ``train_step.state_specs`` the state's specs."""
    if fcfg.quant != "none":
        raise ValueError(
            f"quant={fcfg.quant!r} cannot be trained: the int8 projection "
            "kernel has no gradient (neither has the JAX kernel: it defines "
            "no VJP) and rounding to int8 has none")
    layout = None if mesh is None else transformer.TrainLayout(cfg, mesh,
                                                               rules)
    comm = None if layout is None else layout.comm

    def loss_fn(params, batch):
        return losses.lm_loss(params, batch, cfg, fcfg, remat=tcfg.remat,
                              chunk=tcfg.loss_chunk, z_loss=tcfg.z_loss,
                              compute_dtype=tcfg.compute_dtype, layout=layout)

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(params, batch)
        # a leaf the loss never reads (the token embedding of a stub
        # frontend fed embeddings) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), _unflatten(params, grads)

    def accumulate(params, batch):
        if tcfg.microbatches <= 1:
            return grad_fn(params, batch)
        n = tcfg.microbatches
        losses, acc = [], None
        for mb in zip(*(v.chunk(n) for v in batch.values())):
            loss, g = grad_fn(params, dict(zip(batch, mb)))
            losses.append(loss)
            g = tree_map(lambda x: x.to(torch.float32), g)
            acc = g if acc is None else tree_map2(torch.add, acc, g)
        inv = 1.0 / n
        return sum(losses) * inv, tree_map(lambda x: x * inv, acc)

    def grads_of(params, batch):
        if layout is None:
            return accumulate(params, batch)
        rows, n = batch["targets"].shape[0], max(tcfg.microbatches, 1)
        if rows % n:
            raise ValueError(
                f"global batch {rows * comm.dp} does not split over "
                f"{comm.dp} batch ranks x {n} microbatches")
        loss, grads = accumulate(params, batch)
        comm.reduce_grads(grads, layout.specs)
        return comm.sum_over(loss.reshape(1), comm.batch_axes)[0], grads

    def train_step(state, batch):
        loss, grads = grads_of(state["params"], batch)
        lr_scale = adamw.cosine_schedule(
            int(state["step"]), warmup=tcfg.schedule_warmup,
            total=tcfg.schedule_total)
        _, _, om = adamw.apply_updates(
            state["params"], grads, state["opt"], tcfg.optimizer, lr_scale,
            None if layout is None else layout.specs, comm)
        state["step"] = state["step"] + 1
        metrics = {"loss": loss, "grad_norm": om["grad_norm"],
                   "lr_scale": lr_scale}
        return state, metrics

    train_step.grads_of = grads_of
    train_step.layout = layout
    train_step.state_specs = (None if mesh is None
                              else state_specs(cfg, mesh, rules))
    return train_step


def _unflatten(tree, leaves: list):
    """A tree of ``tree``'s structure holding ``leaves`` (sorted-key
    order, as :func:`tree_leaves` gives them)."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return leaves.pop(0)
