"""Meshes (the port of ``repro.launch.mesh``).

JAX serves a mesh from one process; the port runs one process a rank over
``torch.distributed``, and a mesh is a ``DeviceMesh`` named ("data",
"model") (or ("pod", "data", "model")) over the default process group,
one rank a device.  The group comes from ``torchrun``'s environment
(``torchrun --nproc-per-node N -m repro_torch.launch.serve --tp N``, or
``... -m repro_torch.launch.train --mesh-shape data,model``), from
a caller that set it up already (the tests spawn gloo ranks over a
``FileStore``), or, for one rank, from a ``FileStore`` in a temporary
directory: nothing beyond loopback.

:func:`abstract_mesh` gives names and sizes only, with no process group,
for spec resolution; :func:`make_production_mesh` is abstract too (the
JAX package's 16 x 16 and 2 x 16 x 16 pod meshes).
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices (JAX's ``AbstractMesh``)."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def abstract_mesh(shape, axes) -> AbstractMesh:
    return AbstractMesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def default_backend(device_type: str) -> str:
    """NCCL where every rank has a card of its own, gloo otherwise (the
    CPU, or several ranks sharing one card, which NCCL refuses)."""
    import torch
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1")) if \
        not dist.is_initialized() else dist.get_world_size()
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_process_group(device_type: str = "cuda") -> None:
    """The default process group, once: from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) when it
    is set, else one rank over a ``FileStore`` in a temporary directory;
    over :func:`default_backend`."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = default_backend(device_type)
    if device_type == "cuda":
        # one rank a card; ranks that share a card all take it
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (set up here if needed), whose world size must be the
    mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    init_process_group(device_type)
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(
            f"mesh {tuple(shape)} needs {n} ranks but the process group "
            f"has {dist.get_world_size()}; start one process a rank "
            f"(torchrun --nproc-per-node {n} ...)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_smoke_mesh(data: int = 1, model: int = 1, pod: int = 0,
                    device_type: str = "cpu"):
    """A tiny mesh over however many ranks the group has (tests)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((data, model), ("data", "model"), device_type)


TRAIN_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def make_training_mesh(shape, device_type: str = "cuda"):
    """The mesh of the sharded train step (``launch/train.py
    --mesh-shape``): a 2-long ``shape`` names ("data", "model"), a 3-long
    one ("pod", "data", "model"), as JAX's production meshes do; one rank
    a device."""
    shape = tuple(int(n) for n in shape)
    if len(shape) not in TRAIN_AXES:
        raise ValueError(f"mesh shape {shape}: give data,model or "
                         f"pod,data,model")
    return make_mesh(shape, TRAIN_AXES[len(shape)], device_type)


def make_serving_mesh(tp: int = 1, dp: int = 1, device_type: str = "cuda"):
    """Inference mesh for ``ServingEngine(mesh=...)``: ``tp``-way tensor
    parallelism on the "model" axis (attention heads / kv heads / RWKV-6
    heads / FFN and LRU hidden / MoE experts), ``dp`` replica groups on
    "data"; ``tp * dp`` ranks, one process each."""
    return make_mesh((dp, tp), ("data", "model"), device_type)
