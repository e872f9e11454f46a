"""Logical-axis sharding: map model-declared axis names onto mesh axes (the
port of ``repro.parallel.sharding``).

The rule sets and :func:`spec_for_axes` are the JAX package's, down to the
divisibility fallback and its warning.  A spec is a tuple with one entry a
dim — a mesh axis name, a tuple of names, or ``None`` — so it compares
equal to JAX's ``PartitionSpec`` as a tuple.  A mesh is anything that names
its axes and their sizes: a ``torch.distributed.device_mesh.DeviceMesh``
(``launch.mesh.make_serving_mesh``) or a ``launch.mesh.AbstractMesh``.

Where JAX places arrays with ``NamedSharding``s and lets GSPMD insert the
collectives, the port slices each leaf to its rank (:func:`local_shard`),
one process a rank, and issues the collectives itself: the serving engine
sums the partial products of a row-parallel matmul over the "model" group
(:func:`model_sum`, in place; for the RWKV-6 output norm also its
statistics, for the RG-LRU gates a reduce-scatter, for a vocab-parallel
lookup its rows) and, through :class:`MeshComm`, gathers the leaves a
rule set cuts along dims a layer does not split, a vocab-parallel head's
logits and a replica group's slot rows; the sharded train
step gathers leaves, runs Megatron's f and g around tensor-parallel
products, sums the statistics and scatters the gates with gradients of
their own, and sums gradients over the batch axes through
:class:`MeshComm`, whose operations have gradients.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Optional, Sequence

import torch

from repro_torch.models.module import tree_map2

Rules = dict[str, Any]

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    # attention-region batch for archs whose head count does not divide the
    # model axis: pure data parallelism over every mesh axis
    "batch_attn": ("pod", "data", "model"),
    # context parallelism for the same fallback: the query-sequence dim
    # over the model axis
    "seq_tp": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "heads_flat": "model",
    "mlp": "model",
    "experts": "model",
    "expert_ff": "data",
    "embed": "data",        # FSDP / ZeRO-3
    "head_dim": None,
    "layers": None,
    "seq": None,
}

# pure tensor parallelism (no FSDP)
TP_ONLY_RULES: Rules = {**DEFAULT_RULES, "embed": None}

# serving tensor parallelism (``ServingEngine(mesh=...)``'s default):
# attention heads, kv heads, RWKV-6 heads, the FFN hidden and MoE experts
# shard over "model"; the embedding and the LM head stay replicated
# ("vocab" unsharded), so the logits need no gather over "model".  The
# only collectives over "model" are the sums after the row-parallel
# products (wo, w_out, an MoE rank's expert share; in an RG-LRU block
# also its gates, in an RWKV-6 block its output norm's statistics)
SERVE_TP_RULES: Rules = {**TP_ONLY_RULES, "vocab": None}

# ZeRO-3 + sequence sharding, no tensor parallelism
ZERO_SEQ_RULES: Rules = {
    **DEFAULT_RULES,
    "embed": ("pod", "data", "model"),
    "heads": None, "kv_heads": None, "heads_flat": None,
    "mlp": None, "experts": None, "vocab": "model",
}


def axis_sizes(mesh) -> dict[str, int]:
    """The mesh's axis names and sizes, in order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                  # torch DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _present(sizes: dict, axis) -> Any:
    """Drop mesh axes the mesh does not have (single-pod has no "pod");
    collapse empty tuples to None."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        kept = tuple(a for a in axis if a in sizes)
        return kept if kept else None
    return axis if axis in sizes else None


# (logical axis, dim size, resolved mesh axes, size) combos already warned
# about: a many-layer tree resolves the same non-divisible dim once a leaf
_REPLICATE_WARNED: set = set()


def _warn_replicated(name: str, dim: int, axis, size: int) -> None:
    key = (name, dim, axis, size)
    if key in _REPLICATE_WARNED:
        return
    _REPLICATE_WARNED.add(key)
    warnings.warn(
        f"logical axis {name!r} (dim {dim}) is not divisible by mesh "
        f"axis {axis!r} ({size}-way); replicating this dim instead of "
        f"letting the placement fail",
        RuntimeWarning, stacklevel=3)


def spec_for_axes(mesh, axes: Sequence[Optional[str]],
                  rules: Rules | None = None,
                  shape: Sequence[int] | None = None) -> tuple:
    """Resolve logical axes to a spec (a tuple, one entry a dim).

    When ``shape`` is given, a dim that its mesh-axis product does not
    divide falls back: shorter prefixes of a tuple rule first, then
    replication, with one :class:`RuntimeWarning` for each distinct
    fallback.  A mesh axis is used at most once in a spec."""
    rules = rules or DEFAULT_RULES
    sizes = axis_sizes(mesh)
    parts = []
    used: set = set()

    def axis_size(m) -> int:
        if m is None:
            return 1
        if isinstance(m, tuple):
            return math.prod(sizes[a] for a in m)
        return sizes[m]

    def usable(m):
        """A mesh axis may appear only once in a spec."""
        if m is None:
            return None
        if isinstance(m, tuple):
            kept = tuple(a for a in m if a not in used)
            used.update(kept)
            return kept if kept else None
        if m in used:
            return None
        used.add(m)
        return m

    for i, name in enumerate(axes):
        m = _present(sizes, rules.get(name)) if name else None
        if m is not None and shape is not None:
            ruled, ruled_size = m, axis_size(m)
            cands = [m]
            if isinstance(m, tuple):  # shorter prefixes before giving up
                cands = [m[:k] for k in range(len(m), 0, -1)]
            m = None
            for c in cands:
                if shape[i] % axis_size(c) == 0:
                    m = c if not isinstance(c, tuple) or len(c) > 1 else c[0]
                    break
            if m is None:
                _warn_replicated(name, shape[i], ruled, ruled_size)
        parts.append(usable(m))
    return tuple(parts)


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def axes_leaves(axes_tree) -> list:
    """The logical-axis tuples of a tree of nested dicts and lists."""
    if isinstance(axes_tree, dict):
        return [x for v in axes_tree.values() for x in axes_leaves(v)]
    if isinstance(axes_tree, list):
        return [x for v in axes_tree for x in axes_leaves(v)]
    return [axes_tree]


def tree_specs(mesh, axes_tree, rules: Rules | None = None,
               shapes_tree=None):
    """Map a tree (nested dicts and lists) of logical-axis tuples to specs,
    the counterpart of ``tree_shardings``.  ``shapes_tree``, a tree of the
    same structure whose leaves have a ``.shape`` (tensors,
    ``module.ShapeDtype``), enables the divisibility fallback."""
    def walk(axes, shapes):
        if isinstance(axes, dict):
            return {k: walk(v, None if shapes is None else shapes[k])
                    for k, v in axes.items()}
        if isinstance(axes, list):
            return [walk(a, None if shapes is None else s) for a, s in
                    zip(axes, shapes if shapes is not None
                        else [None] * len(axes))]
        assert is_axes_leaf(axes), axes
        return spec_for_axes(mesh, axes, rules,
                             None if shapes is None else tuple(shapes.shape))
    return walk(axes_tree, shapes_tree)


def batch_spec(mesh, ndim: int, rules: Rules | None = None,
               shape: Sequence[int] | None = None) -> tuple:
    """Batch-leading activation spec: (batch, ...) -> dp axes on dim 0."""
    return spec_for_axes(mesh, ["batch"] + [None] * (ndim - 1), rules, shape)


def replicated(mesh) -> tuple:
    """The fully replicated spec (JAX's ``P()``)."""
    return ()


def dp_axes(mesh) -> tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def sharded_size(spec_entry, mesh) -> int:
    """How many ways one spec entry splits its dim."""
    if spec_entry is None:
        return 1
    sizes = axis_sizes(mesh)
    names = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    return math.prod(sizes[a] for a in names)


def mesh_coords(mesh) -> dict[str, int]:
    """This process's index along every axis of a DeviceMesh."""
    return {n: mesh.get_local_rank(n) for n in axis_sizes(mesh)}


def _dim_index(entry, sizes: dict, coords: dict) -> tuple[int, int]:
    """(this rank's shard index, shard count) of one spec entry: the
    rank's coordinates along the entry's axes, major to minor."""
    names = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    idx, n = 0, 1
    for a in names:
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return idx, n


def rule_axes(mesh, rules: Rules, name: str):
    """The mesh axes ``rules`` give logical axis ``name`` on ``mesh`` (None,
    a name or a tuple), before any divisibility fallback."""
    return _present(axis_sizes(mesh), rules.get(name))


def shard_range(entry, n: int, mesh, coords: dict) -> tuple[int, int]:
    """[lo, hi) of this rank's shard of a dim of size ``n`` under one spec
    entry."""
    idx, parts = _dim_index(entry, axis_sizes(mesh), coords)
    return idx * (n // parts), (idx + 1) * (n // parts)


def local_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` leaf under ``spec``."""
    return tuple(d // sharded_size(s, mesh)
                 for d, s in zip(shape, tuple(spec) + (None,) * len(shape)))


def local_shard(t: torch.Tensor, spec: tuple, mesh,
                coords: dict | None = None) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec`` (a view; ``t`` itself when
    nothing is sharded).  ``coords`` names the rank's index along each mesh
    axis; by default, read from the DeviceMesh."""
    sizes = axis_sizes(mesh)
    if coords is None:
        coords = mesh_coords(mesh)
    for dim, entry in enumerate(spec):
        idx, n = _dim_index(entry, sizes, coords)
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t


class ModelSum:
    """The sum over ``mesh``'s "model" group of a row-parallel product's
    partial results, in place (``all_reduce``).  Every rank receives the
    same bits, so the ranks' host loops stay in lockstep.  The group is
    looked up at the first sum (an abstract mesh has none)."""

    def __init__(self, mesh):
        self.mesh = mesh

    @property
    def group(self):
        return self.mesh.get_group("model")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def scatter(self, x: torch.Tensor, ranges) -> tuple:
        """A reduce-scatter: the sum over the "model" group of ``x``'s
        partial products (in place), cut to this rank's ``ranges`` of the
        last dim, one view a range."""
        x = self(x)
        return tuple(x[..., lo:hi] for lo, hi in ranges)


def model_sum(mesh) -> Optional[ModelSum]:
    """The sum over ``mesh``'s "model" axis, or None where that axis has
    size 1 (or is absent): no collective there, as XLA drops one over a
    single device."""
    if mesh is None or axis_sizes(mesh).get("model", 1) == 1:
        return None
    return ModelSum(mesh)


# ---------------------------------------------------------------------------
# the sharded train step's collectives
# ---------------------------------------------------------------------------


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple (empty for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: tuple) -> set:
    """Every mesh axis a spec uses."""
    return {a for entry in spec for a in entry_axes(entry)}


def batch_ranks(mesh, rules: Rules | None = None) -> int:
    """How many ways ``rules`` split the batch on ``mesh``: the product of
    the sizes of the mesh axes "batch" resolves to."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in entry_axes(
        rule_axes(mesh, rules or DEFAULT_RULES, "batch")))


class MeshComm:
    """The collectives of the sharded train step on one rank of a
    ``DeviceMesh``.

    Every collective is an all-reduce: PyTorch's gloo backend gathers and
    reduce-scatters CPU tensors only, and the chip check runs several gloo
    ranks on one card's CUDA tensors.  A gather places the rank's shard in
    a zero-filled buffer of the whole leaf and sums it (exact: one rank
    contributes each element).  A spec entry or a group of several mesh
    axes ("pod" and "data", say) is summed one axis after another, nested:
    after the first sum the ranks that share the other coordinates hold
    equal values, so every rank ends with the same bits.

    ``batch_axes`` are the mesh axes ``rules`` give "batch" to: ranks that
    differ along them see different rows of the global batch; ranks that
    differ only along the others ("model") see the same rows and compute
    the same replicated values.  ``dp`` is the product of their sizes.
    Scalars (loss, flags) live on the mesh's device type."""

    def __init__(self, mesh, rules: Rules | None = None):
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        self.coords = mesh_coords(mesh)
        self.batch_axes = entry_axes(rule_axes(mesh, rules or DEFAULT_RULES,
                                               "batch"))
        self.dp = batch_ranks(mesh, rules)
        self.device = torch.device(mesh.device_type)
        # rank 0 of the mesh: the one that writes checkpoints
        self.lead = not any(self.coords.values())

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"):
        """``x`` reduced in place over each of ``axes`` in turn (axes of
        size 1 skipped).  ``x`` must be contiguous."""
        import torch.distributed as dist
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        for a in axes:
            if self.sizes[a] > 1:
                dist.all_reduce(x, op=red, group=self.mesh.get_group(a))
        return x

    def sum_over(self, x: torch.Tensor, axes) -> torch.Tensor:
        """A contiguous copy of ``x`` summed over ``axes``."""
        return self.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               axes)

    def replication(self, spec: tuple) -> int:
        """How many ranks hold each element of a leaf under ``spec``: the
        product of the sizes of the mesh axes the spec does not use."""
        used = spec_axes(spec)
        return math.prod(n for a, n in self.sizes.items() if a not in used)

    def sum_world(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum_over(x, tuple(self.sizes))

    def agree(self, *flags: bool) -> tuple[bool, ...]:
        """Each flag, true on every rank when it is true on any (one
        all-reduce)."""
        t = torch.tensor([int(f) for f in flags], dtype=torch.int32,
                         device=self.device)
        return tuple(bool(x) for x in
                     self.all_reduce(t, tuple(self.sizes), "max").tolist())

    def barrier(self) -> None:
        self.sum_world(torch.zeros(1, device=self.device))

    def gather(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The whole leaf from this rank's shard ``t`` under ``spec`` (``t``
        itself when nothing is sharded), one sharded dim at a time."""
        for dim, entry in enumerate(spec):
            idx, n = _dim_index(entry, self.sizes, self.coords)
            if n == 1:
                continue
            shape = list(t.shape)
            shape[dim] *= n
            full = t.new_zeros(shape)
            full.narrow(dim, idx * t.shape[dim], t.shape[dim]).copy_(t)
            t = self.all_reduce(full, entry_axes(entry))
        return t

    def gather_grad(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """:meth:`gather` with a gradient: the whole leaf's gradient summed
        over the batch axes the spec uses (their ranks saw other rows),
        then cut to this rank's shard (the other axes' ranks computed the
        same values, so their gradients are already whole).  ``t`` itself
        when nothing is sharded."""
        if all(_dim_index(e, self.sizes, self.coords)[1] == 1 for e in spec):
            return t
        return _Gather.apply(t, self, spec)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f, before a column-parallel product: the identity
        forward, the sum over "model" of the input's gradient backward."""
        return _CopyToModel.apply(x, self)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g, after a row-parallel product: the sum over
        "model" forward, the identity backward (the differentiable twin
        of :class:`ModelSum`, on a copy)."""
        return _ReduceFromModel.apply(x, self)

    def sum_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over "model" that every rank reads for its own share only
        (the RWKV-6 output norm's statistics, each rank's partial sums over
        its columns): the all-reduce forward and, since each rank's
        gradient of the sum holds only what its own columns contribute,
        the all-reduce of the gradients backward."""
        return _SumOverModel.apply(x, self)

    def scatter_to_model(self, x: torch.Tensor, ranges) -> tuple:
        """The RG-LRU gates' reduce-scatter: the sum over "model" of
        ``x``'s partial products, cut to this rank's ``ranges`` of the last
        dim (:meth:`ModelSum.scatter`'s twin).  Backward, the ranks'
        slices of the gradient gathered whole (each placed in zeros and
        summed): every rank's partial product reaches every channel."""
        return _ScatterToModel.apply(x, self, tuple(ranges))

    def reduce_grads(self, grads, specs) -> None:
        """Sum each gradient leaf in place over the batch axes its spec
        does not use (those its gather's backward did not sum)."""
        def one(g, spec):
            axes = [a for a in self.batch_axes if a not in spec_axes(spec)]
            if any(self.sizes[a] > 1 for a in axes):
                g.copy_(self.sum_over(g, axes))
        tree_map2(one, grads, specs)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, spec):
        ctx.comm, ctx.spec = comm, spec
        return comm.gather(t, spec)

    @staticmethod
    def backward(ctx, g):
        comm, spec = ctx.comm, ctx.spec
        g = comm.sum_over(g, [a for a in comm.batch_axes
                              if a in spec_axes(spec)])
        return local_shard(g, spec, comm.mesh, comm.coords).contiguous(), \
            None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.sum_over(g, ("model",)), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.sum_over(x, ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.sum_over(x, ("model",))

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.sum_over(g, ("model",)), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, ranges):
        ctx.comm, ctx.ranges, ctx.shape = comm, ranges, x.shape
        full = comm.sum_over(x, ("model",))
        return tuple(full[..., lo:hi].clone() for lo, hi in ranges)

    @staticmethod
    def backward(ctx, *gs):
        full = gs[0].new_zeros(ctx.shape)
        for (lo, hi), g in zip(ctx.ranges, gs):
            full[..., lo:hi] = g
        return ctx.comm.all_reduce(full, ("model",)), None, None
