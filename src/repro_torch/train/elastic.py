"""Elastic scaling: resume a run on another mesh (the port of
``repro.train.elastic``).

Because (a) the "pod" axis carries only data parallelism, (b) checkpoints
store whole (unsharded) leaves, and (c) the data pipeline is
stateless-deterministic in (seed, step), changing the mesh is: build the
new mesh, resolve the specs from the same logical-axis tree, and restore
each rank's shard of every leaf.  The global batch stays fixed (each
batch rank's rows change), so training curves are reproducible across
resizes.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.parallel import sharding as shd
from repro_torch.train import checkpoint as ckpt_lib


def reshard_restore(ckpt_dir: str, state_like, mesh, logical_axes_tree,
                    rules=None, step: Optional[int] = None):
    """Restore the latest checkpoint (or ``step``) onto ``mesh`` (any
    shape): ``state_like`` holds this rank's shards on it (as
    ``step.init_state(mesh=)`` makes them), and the specs come from
    ``logical_axes_tree`` under ``rules`` with the checkpoint's whole
    shapes (so the divisibility fallback resolves as on the old mesh).
    Returns (state, step)."""
    shapes = ckpt_lib.checkpoint_shapes(ckpt_dir, state_like, step)
    specs = shd.tree_specs(mesh, logical_axes_tree, rules, shapes)
    return ckpt_lib.restore_checkpoint(ckpt_dir, state_like, step=step,
                                       specs=specs, mesh=mesh)


def validate_resize(old_mesh_shape: dict, new_mesh_shape: dict,
                    global_batch: int) -> list[str]:
    """Static checks before an elastic resize; returns problem list."""
    problems = []
    for ax in ("data", "model"):
        if old_mesh_shape.get(ax) != new_mesh_shape.get(ax):
            problems.append(
                f"{ax} axis changed {old_mesh_shape.get(ax)} -> "
                f"{new_mesh_shape.get(ax)}: TP/FSDP layout changes require "
                "a full reshard (supported, but not transparent)")
    dp = new_mesh_shape.get("data", 1) * new_mesh_shape.get("pod", 1)
    if global_batch % dp:
        problems.append(f"global batch {global_batch} not divisible by new "
                        f"DP degree {dp}")
    return problems
