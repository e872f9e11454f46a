"""Random weights from ``--seed``, made on the device in the spec-tree
layout that the port's engine takes and that the reference reads; the
cell's model module (``perfbench/reference/``) gives the layout.

A frozen copy of the pattern of ``chip_smoke.random_params``: one
``torch.Generator`` on the device, one draw a stacked leaf (all layers of
a leaf in one call), made directly in the type the model is served in.
The scales are the benchmark's own, so a change to the program's
initialisers changes no weight here: each matrix has standard deviation
``1 / sqrt(its contracting width)`` (the embedding 1), norm scales are
``1 + 0.1 N(0, 1)`` so a fault in a scale shows in the logits, and the
router is float32 as the port keeps it.
"""
from __future__ import annotations

import math

import torch


def make(layout: dict, dtype: torch.dtype, seed: int, device) -> dict:
    """The spec tree of ``layout`` (a model module's ``layout(m)``: path
    to shape, contracting width and kind, in draw order), drawn from
    ``seed`` on ``device``; kind is ``"w"``, ``"scale"``, ``"embed"`` or
    ``"router"``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: dict = {}
    for path, (shape, fan_in, kind) in layout.items():
        dt = torch.float32 if kind == "router" else dtype
        x = torch.randn(shape, generator=gen, dtype=dt, device=device)
        if kind == "scale":
            x.mul_(0.1).add_(1.0)
        elif fan_in:
            x.mul_(1.0 / math.sqrt(fan_in))
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    return tree


def leaf(tree: dict, path: str):
    """The leaf of a nested dict at a ``/``-separated path."""
    for k in path.split("/"):
        tree = tree[k]
    return tree


def flat(tree: dict, pre: str = "") -> dict:
    """``{path: leaf}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out
