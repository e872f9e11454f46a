"""Lightweight parameter-definition system (the port of ``repro.models.module``).

Parameter trees are *declared* as nested dicts of :class:`ParamSpec` (shape +
logical axis names + initializer), then materialised with
:func:`init_params`.  The trees have the same structure and leaf shapes as
the JAX package's, stacked ``(num_units, ...)`` leaves included, so a JAX
parameter tree carries over leaf for leaf (see ``repro_torch.convert``).
:func:`logical_axes` gives the tree of axis names that
``parallel.sharding`` resolves against a mesh, :func:`param_shapes` the
shapes without allocating.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of a single parameter tensor.

    Attributes:
      shape:  tensor shape.
      axes:   logical axis name per dim (None = replicated/unsharded dim).
      init:   "zeros" | "ones" | "fan_in" | "embed" | "uniform" (the kinds
              the ported specs use).
      scale:  multiplier applied to the random initializer.
      dtype:  parameter dtype; None -> use the model-wide default.
    """

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "fan_in"
    scale: float = 1.0
    dtype: Any = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_map2(fn: Callable, a: Tree, b: Tree) -> Tree:
    """Apply ``fn`` to the leaves of two trees of one structure (``a``'s
    dict keys), pairwise."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def tree_leaves(tree: Tree) -> list:
    """Leaves of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _materialise(spec: ParamSpec, gen: torch.Generator, default_dtype,
                 device) -> torch.Tensor:
    dtype = spec.dtype or default_dtype
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init in ("embed", "fan_in"):
        std = spec.scale
        if spec.init == "fan_in":
            # as in the JAX package: the fan-in of a stacked leaf includes
            # the stacking axis (every dim but the last)
            fan_in = shape[0] if len(shape) == 1 else int(np.prod(shape[:-1]))
            std = spec.scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(dtype)
    if spec.init == "uniform":
        x = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        return x.mul_(2.0).sub_(1.0).mul_(spec.scale).to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(spec_tree: Tree, gen: torch.Generator,
                default_dtype=torch.float32, device="cuda") -> Tree:
    """Materialise a tree of ParamSpec into tensors on ``device``.

    Same init rules and scales as the JAX package; the random bits come from
    ``gen`` (a ``torch.Generator`` on ``device``), so they differ from
    ``jax.random``'s — carry JAX weights over with ``repro_torch.convert``
    where the two must agree."""
    return tree_map(lambda s: _materialise(s, gen, default_dtype, device),
                    spec_tree)


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype, allocating nothing (JAX's
    ``ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: Any


def param_shapes(spec_tree: Tree, default_dtype=torch.float32) -> Tree:
    """:class:`ShapeDtype` tree of the parameters, same structure as the
    spec tree (no allocation)."""
    return tree_map(lambda s: ShapeDtype(tuple(s.shape),
                                         s.dtype or default_dtype),
                    spec_tree)


def logical_axes(spec_tree: Tree) -> Tree:
    """Tree of logical-axis tuples, same structure as the param tree."""
    return tree_map(lambda s: tuple(s.axes), spec_tree)


def count_params(spec_tree: Tree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(spec_tree))


def stack_specs(spec_tree: Tree, n: int,
                stack_axis_name: str | None = "layers") -> Tree:
    """Prepend a stacking dim of size ``n`` to every spec."""

    def _stack(s: ParamSpec) -> ParamSpec:
        return ParamSpec(shape=(n,) + s.shape, axes=(stack_axis_name,) + s.axes,
                         init=s.init, scale=s.scale, dtype=s.dtype)

    return tree_map(_stack, spec_tree)
