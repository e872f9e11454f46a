"""Multi-pod dry run (the port of ``repro.launch.dryrun``): run every (arch x
shape x mesh) cell's step once on ``meta`` tensors, as one rank of JAX's
production mesh sees it, and report its memory a device, its cost and its
roofline on an H100.  Nothing is allocated and no card is needed.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh pod1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Where JAX lowers and compiles each cell's ``jax.jit`` for 256 or 512
placeholder devices and reads XLA's memory and cost analyses, the port
runs rank 0's step eagerly: the process joins a fake process group of the
mesh's size (``torch.distributed``'s "fake" backend, whose collectives
return at once), builds the mesh over it, cuts the state, parameters,
caches and inputs to rank 0's shard shapes under ``DEFAULT_RULES`` (JAX's
``rules=None``) as ``meta`` tensors, and runs the step under
:func:`~repro_torch.roofline.op_cost.analyse_ops`, which counts its FLOPs,
bytes, collectives and peak of live bytes.  The cells run ``impl="xla"``,
as JAX's do, so no kernel is on the path.  A step that reads a value back
to the host fails (a ``meta`` tensor has none): the dry run raises and the
cell fails; nothing is skipped.

Memory a device: the arguments' bytes (their distinct storages) plus the
peak of the bytes the step allocates.  JAX's ``argument + output + temp -
alias`` donates the state (train) or the caches (prefill, decode) to the
output; the port's steps update them in place, which allocates no second
copy, so the outputs that alias an argument add nothing, and every other
output is among the step's allocations.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Callable

import torch

from repro_torch.configs.base import (PORT_ONLY, SHAPES, get_config,
                                      list_configs, supported_cells)
from repro_torch.core.analytical import H100
from repro_torch.core.famous import FamousConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.models import module, transformer
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import op_cost
from repro_torch.train import step as step_lib

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "chiprun_out", "dryrun")


def train_cfgs(cfg) -> step_lib.TrainConfig:
    """Per-arch training precision policy: bf16 parameters and moments
    above 60e9 parameters, f32 below (JAX's ``train_cfgs``)."""
    big = cfg.param_count() > 60e9
    return step_lib.TrainConfig(
        param_dtype=torch.bfloat16 if big else torch.float32,
        optimizer=adamw.AdamWConfig(
            moment_dtype=torch.bfloat16 if big else torch.float32),
        remat=True)


@contextlib.contextmanager
def fake_world(size: int):
    """A default process group of ``size`` ranks, this process rank 0, on
    the "fake" backend (no peers: a collective returns at once, its tensor
    unchanged).  Destroyed on leaving.  Refuses a process that already has
    a default group."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("the dry run runs in a fake process group of its "
                           "own; this process already has a default group")
    # private to torch's tests, and so kept to this one import
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(multi_pod: bool):
    """JAX's production mesh (16 x 16 "data", "model"; 2 x 16 x 16 with
    "pod") as a ``DeviceMesh`` over the default process group."""
    m = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    return mesh_lib.make_mesh(m.axis_sizes, m.axis_names, "cpu")


@dataclasses.dataclass
class Lowered:
    """A step and its ``meta`` arguments (JAX's ``Lowered``): ``fn(*args)``
    runs it; ``parts`` names the arguments' bytes by kind."""

    fn: Callable
    args: tuple
    parts: dict


def _meta(shapes, specs=None, mesh=None):
    """``meta`` tensors of a ShapeDtype tree, each at its rank's shape
    under ``specs`` (whole without a mesh)."""
    def one(s, spec):
        shape = s.shape if mesh is None else shd.local_shape(s.shape, spec,
                                                             mesh)
        return torch.empty(shape, dtype=s.dtype, device="meta")
    if mesh is None:
        return module.tree_map(lambda s: one(s, None), shapes)
    return module.tree_map2(one, shapes, specs)


def _batch(specs: dict, mesh, rules) -> dict:
    """Rank-shaped ``meta`` inputs: each leaf's batch dim cut as JAX's
    ``batch_sharding`` cuts it."""
    return {k: _meta(v, None if mesh is None else
                     shd.batch_spec(mesh, len(v.shape), rules, v.shape), mesh)
            for k, v in specs.items()}


def _serving_params(cfg, mesh, rules):
    """The serving layout of rank-shaped ``meta`` bf16 weights (JAX's
    spec-tree ``param_shapes(spec, bf16)``), and the spec tree's bytes."""
    spec = transformer.model_spec(cfg)
    shapes = module.param_shapes(spec, torch.bfloat16)
    if mesh is None:
        tree = _meta(shapes)
        params = transformer.prepare_params(tree, cfg)
    else:
        tree = _meta(shapes, shd.tree_specs(mesh, module.logical_axes(spec),
                                            rules, shapes), mesh)
        params = transformer.shard_params(tree, cfg, mesh, rules)
    head = op_cost.argument_bytes(params["unembed_f32"])
    return params, {"param_bytes": op_cost.argument_bytes(tree),
                    "unembed_f32_bytes": head}


def lower_train(cfg, shape, mesh=None, rules=None, fcfg=None, tcfg=None):
    """The train step on its state's and batch's rank shards."""
    tcfg = tcfg or train_cfgs(cfg)
    fcfg = fcfg or FamousConfig(impl="xla")
    train_step = step_lib.make_train_step(cfg, fcfg, tcfg, mesh=mesh,
                                          rules=rules)
    shapes = step_lib.state_shapes(cfg, tcfg)
    specs = train_step.state_specs
    params = _meta(shapes["params"], specs and specs["params"], mesh)
    module.tree_map(lambda p: p.requires_grad_(True), params)
    moments = {k: _meta(shapes["opt"][k], specs and specs["opt"][k], mesh)
               for k in ("m", "v")}
    # count and step stay host scalars, as init_state makes them: the step
    # reads ``step`` on the host
    state = {"params": params,
             "opt": dict(moments, count=torch.zeros((), dtype=torch.int32)),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = _batch(specs_lib.train_input_specs(cfg, shape), mesh, rules)
    return Lowered(train_step, (state, batch),
                   {"state_bytes": op_cost.argument_bytes(state),
                    "input_bytes": op_cost.argument_bytes(batch)})


def lower_prefill(cfg, shape, mesh=None, rules=None, fcfg=None,
                  dtype=torch.bfloat16):
    """Inference prefill: the whole prompt's forward to last-token logits,
    filling the caches."""
    fcfg = fcfg or FamousConfig(impl="xla")
    rules = rules or shd.DEFAULT_RULES
    params, parts = _serving_params(cfg, mesh, rules)
    inputs = _batch(specs_lib.train_input_specs(cfg, shape), mesh,
                    rules)["inputs"]
    caches = transformer.make_caches(
        cfg, shape.global_batch, shape.seq_len, dtype, "meta", mesh=mesh,
        rules=rules)

    def prefill_step(params, inputs, caches):
        return transformer.prefill(params, inputs, caches, cfg, fcfg)

    parts.update(cache_bytes=op_cost.argument_bytes(caches),
                 input_bytes=op_cost.argument_bytes(inputs))
    return Lowered(prefill_step, (params, inputs, caches), parts)


def lower_serve(cfg, shape, mesh=None, rules=None, fcfg=None,
                dtype=torch.bfloat16):
    """One decode step over every slot of the rank's caches."""
    fcfg = fcfg or FamousConfig(impl="xla")
    rules = rules or shd.DEFAULT_RULES
    params, parts = _serving_params(cfg, mesh, rules)
    dec = specs_lib.decode_input_specs(cfg, shape, dtype)
    inputs = _batch({k: dec[k] for k in ("tokens", "cache_len")}, mesh,
                    rules)
    B = shape.global_batch
    caches = transformer.make_caches(cfg, B, shape.seq_len, dtype, "meta",
                                     mesh=mesh, rules=rules)
    kw = {}
    rows = None if mesh is None else transformer.slot_range(cfg, B, mesh,
                                                            rules)
    if rows is not None and cfg.num_experts:
        # as the engine runs a replica group's slots: MoE routes every
        # group's rows, gathered over the groups' axes
        comm = shd.MeshComm(mesh, rules)
        kw["slot_rows"] = (lambda x: comm.gather(
            x, (rows[2],) + (None,) * (x.ndim - 1)), rows[0], rows[1])

    def serve_step(params, tokens, caches, cache_len):
        return transformer.decode_step(params, tokens, caches, cache_len,
                                       cfg, fcfg, **kw)

    parts.update(cache_bytes=op_cost.argument_bytes(caches),
                 input_bytes=op_cost.argument_bytes(inputs))
    return Lowered(serve_step, (params, inputs["tokens"], caches,
                                inputs["cache_len"]), parts)


def lower(cfg, shape, mesh=None, rules=None, fcfg=None) -> Lowered:
    fn = {"train": lower_train, "prefill": lower_prefill,
          "decode": lower_serve}[shape.kind]
    return fn(cfg, shape, mesh, rules, fcfg=fcfg)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT_DIR, rules=None, tag: str = "",
             fcfg=None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2" if multi_pod else "pod1"
    chips = 512 if multi_pod else 256
    with fake_world(chips):
        mesh = production_mesh(multi_pod)
        t0 = time.time()
        low = lower(cfg, shape, mesh, rules, fcfg)
        t_lower = time.time() - t0
        t0 = time.time()
        cost = op_cost.analyse_ops(low.fn, *low.args)
        t_run = time.time() - t0
    args = op_cost.argument_bytes(low.args)
    per_dev = args + cost.peak_bytes
    rf = roofline.analyse(
        arch, shape_name, mesh_name, cost=cost, chips=chips,
        model_flops_total=roofline.model_flops(cfg, shape),
        memory_per_device=per_dev, hw=H100)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "ok": True, "hw": H100.name,
        "t_lower_s": round(t_lower, 1), "t_run_s": round(t_run, 1),
        "memory": {
            "argument_bytes": args,
            **low.parts,
            "peak_bytes": cost.peak_bytes,
            "per_device_bytes": per_dev,
            "per_device_gib": round(per_dev / 2**30, 3),
            "fits_80gb": bool(per_dev <= H100.hbm_bytes),
        },
        "cost": dataclasses.asdict(cost),
        "roofline": rf.row(),
    }
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{mesh_name}{('__' + tag) if tag else ''}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in list_configs():
        if arch == "famous-bert":
            continue  # paper topology exercised by benchmarks, not the grid
        if arch in PORT_ONLY:
            continue  # runs unsharded only: no mesh to dry-run it on
        for s in supported_cells(arch):
            cells.append((arch, s))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a, s in all_cells():
            print(f"{a} {s}")
        return

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "pod2" if mp else "pod1"
            fname = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(fname):
                print(f"SKIP {arch} {shape} {mesh_name}")
                continue
            try:
                r = run_cell(arch, shape, mp, args.out)
                rr = r["roofline"]
                print(f"OK   {arch:22s} {shape:12s} {mesh_name} "
                      f"run={r['t_run_s']:>6.1f}s "
                      f"mem/dev={r['memory']['per_device_gib']:>7.3f}GiB "
                      f"dom={rr['dominant']:10s} "
                      f"frac={rr['roofline_fraction']:.3f}", flush=True)
            except Exception as e:
                failures.append((arch, shape, mesh_name, repr(e)))
                print(f"FAIL {arch} {shape} {mesh_name}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print(" ", *f)
        raise SystemExit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()
