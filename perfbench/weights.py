"""Random weights from ``--seed``, made on the device in the spec-tree
layout that the port's engine takes and that the reference reads.

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


def layout(m: dict) -> dict:
    """``{path: (shape, contracting width or None, kind)}`` of the spec
    tree of model sizes ``m`` (a configuration file's ``model``); kind is
    ``"w"`` (a matrix), ``"scale"`` (a norm scale), ``"embed"`` or
    ``"router"``."""
    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    H, KV, dh, F = m["num_heads"], m["num_kv_heads"], m["head_dim"], m["d_ff"]
    E = m["num_experts"]
    blk = "blocks/pos0/"
    out = {"embed/embedding": ((V, D), None, "embed"),
           blk + "ln1/scale": ((L, D), None, "scale"),
           blk + "attn/wq": ((L, D, H, dh), D, "w"),
           blk + "attn/wk": ((L, D, KV, dh), D, "w"),
           blk + "attn/wv": ((L, D, KV, dh), D, "w"),
           blk + "attn/wo": ((L, H, dh, D), H * dh, "w"),
           blk + "ln2/scale": ((L, D), None, "scale")}
    if E:
        out.update({blk + "ffn/router": ((L, D, E), D, "router"),
                    blk + "ffn/w_in": ((L, E, D, F), D, "w"),
                    blk + "ffn/w_gate": ((L, E, D, F), D, "w"),
                    blk + "ffn/w_out": ((L, E, F, D), F, "w")})
    else:
        out.update({blk + "ffn/w_in": ((L, D, F), D, "w"),
                    blk + "ffn/w_gate": ((L, D, F), D, "w"),
                    blk + "ffn/w_out": ((L, F, D), F, "w")})
    out["final_norm/scale"] = ((D,), None, "scale")
    out["lm_head/w"] = ((D, V), D, "w")
    return out


def make(m: dict, dtype: torch.dtype, seed: int, device) -> dict:
    """The spec tree of sizes ``m``, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: dict = {}
    for path, (shape, fan_in, kind) in layout(m).items():
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
