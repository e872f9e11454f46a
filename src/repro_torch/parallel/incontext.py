"""In-graph sharding constraints from logical axis names (the port of
``repro.parallel.incontext``).

In JAX these pin an activation's layout for GSPMD inside a jitted
function and do nothing without an ambient mesh.  The port has no
partitioner, so each function here is the identity on its tensors: every
layout is explicit.  The serving engine splits every weight and cache
(``transformer.shard_params``) and sums the row-parallel products over the
"model" group itself (``parallel.sharding.model_sum``); the sharded train
step holds each rank's shards, gathers what a unit reads whole and runs
Megatron's f and g around the tensor-parallel products
(``transformer.TrainLayout``), and each rank's activations are its own
rows (``pipeline.make_global_batch``).  A constraint would have nothing
left to place.
"""
from __future__ import annotations

import contextlib
import contextvars

# Active rule set for in-graph constraints, as in JAX
_ACTIVE_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None)


@contextlib.contextmanager
def use_rules(rules):
    tok = _ACTIVE_RULES.set(rules)
    try:
        yield
    finally:
        _ACTIVE_RULES.reset(tok)


def constrain(x, axes, rules=None):
    """The identity: the port's engine splits explicitly."""
    return x


def reshard_fwd_bwd(x, fwd_axes, bwd_axes, rules=None):
    """The identity, forward and backward: the port's engine splits
    explicitly."""
    return x


def heads_divide_model(num_heads: int, mesh=None) -> bool:
    """True when head tensor parallelism is exact on ``mesh`` (or there is
    no mesh, or it has no "model" axis)."""
    if mesh is None:
        return True
    from repro_torch.parallel.sharding import axis_sizes
    return num_heads % axis_sizes(mesh).get("model", 1) == 0


def constrain_residual(x, num_heads: int, rules=None):
    """The identity: the port's engine splits explicitly."""
    return x


def constrain_attn_activations(q, k, v, num_heads: int, rules=None):
    """The identity on (q, k, v): the port's engine splits explicitly."""
    return q, k, v
