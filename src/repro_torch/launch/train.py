"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Wires the training path end to end on one device: config -> state ->
deterministic data pipeline -> train step -> fault-tolerant Trainer with
async checkpointing and SIGTERM-preemption handling.  It trains through
``FamousConfig(impl="pallas")``: on the GPU the hand-written kernels
(attention forward, dq and dk/dv, and the QKV projection with its VJP);
with ``--device cpu`` their plain PyTorch versions.  Every registered
config trains (``--arch``): the recurrent families recurrentgemma-2b and
rwkv6-1.6b through the models' differentiable torch scans, as JAX
differentiates its own; the MoE configs through ``models/moe.py``'s
einsums; hubert-xlarge and llava-next-34b on their stub frontends'
embeddings, which the data pipeline makes.  Without a GPU it raises unless ``--device cpu``
is given.  ``--smoke`` (the default, as in
the JAX launcher) shrinks the config; ``--full`` trains it at full size.

On a mesh, one process a rank: ``torchrun --nproc-per-node N -m
repro_torch.launch.train --mesh-shape data,model`` (or
``pod,data,model``) ``--rules {default,tp_only,zero_seq}`` cuts the state
to each rank's shards, feeds each rank its rows
(``pipeline.make_global_batch``) and runs the sharded step (data, FSDP
and tensor parallelism by the rule set; ``train/step.py``), with
checkpoints that restore onto any mesh.  Over NCCL where every rank has a
card, gloo otherwise (``--device cpu``: ranks on the CPU).  Without
``--mesh-shape`` it trains on one device as before.
"""
from __future__ import annotations

import argparse
import signal

import torch

from repro_torch.configs.base import (SHAPES, SMOKE_SHAPES, ShapeConfig,
                                      get_config, shrink)
from repro_torch.core.famous import FamousConfig
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_training_mesh
from repro_torch.parallel import sharding as shd
from repro_torch.serve.engine import resolve_device
from repro_torch.train import step as step_lib
from repro_torch.train import trainer as trainer_lib


RULES = {"default": shd.DEFAULT_RULES, "tp_only": shd.TP_ONLY_RULES,
         "zero_seq": shd.ZERO_SEQ_RULES}


def build(arch: str, shape: ShapeConfig, *, smoke: bool,
          tcfg: step_lib.TrainConfig | None = None,
          fcfg: FamousConfig | None = None, seed: int = 0, device="cuda",
          cfg=None, mesh=None, rules=None):
    """Returns (cfg, state, train_step, batch_fn).  ``cfg`` overrides the
    registered config (a depth cut, say).  On a ``mesh`` (``rules``,
    default ``DEFAULT_RULES``) the state is this rank's shards, the step
    the sharded one (``train_step.state_specs`` for the ``Trainer``) and
    each batch this rank's rows."""
    device = resolve_device(device)
    cfg = cfg or get_config(arch)
    if smoke:
        cfg = shrink(cfg)
    fcfg = fcfg or FamousConfig(impl="pallas")
    tcfg = tcfg or step_lib.TrainConfig(
        compute_dtype=torch.float32 if smoke else torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = step_lib.init_state(cfg, tcfg, gen, device, mesh, rules)
    train_step = step_lib.make_train_step(cfg, fcfg, tcfg, mesh, rules)

    def batch_fn(step: int):
        if mesh is not None:
            return pipeline.make_global_batch(cfg, shape, seed, step, mesh,
                                              rules, device)
        return pipeline.device_batch(cfg, shape, seed, step, device)

    return cfg, state, train_step, batch_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="famous-bert")
    ap.add_argument("--shape", default="smoke_train")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=trainer_lib.default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model or pod,data,model: train on a mesh, "
                         "one process a rank (torchrun)")
    ap.add_argument("--rules", default="default", choices=sorted(RULES))
    args = ap.parse_args(argv)

    shape = {**SHAPES, **SMOKE_SHAPES}[args.shape]
    device = resolve_device(args.device)
    mesh = None
    if args.mesh_shape:
        mesh = make_training_mesh(args.mesh_shape.split(","), device.type)
    cfg, state, train_step, batch_fn = build(
        args.arch, shape, smoke=args.smoke, seed=args.seed, device=device,
        mesh=mesh, rules=RULES[args.rules])
    tcfg = trainer_lib.TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir)
    tr = trainer_lib.Trainer(train_step, state, batch_fn, tcfg, mesh=mesh,
                             state_specs=train_step.state_specs)
    signal.signal(signal.SIGTERM, lambda *_: tr.request_stop())
    tr.run()
    if mesh is None or tr.comm.lead:
        if mesh is not None:
            print(f"mesh {dict(shd.axis_sizes(mesh))} rules {args.rules}")
        for m in tr.metrics_log[-5:]:
            print({k: round(v, 4) if isinstance(v, float) else v
                   for k, v in m.items()})
        print(f"done: arch={cfg.name} steps={int(tr.state['step'])} "
              f"restarts={tr.restarts} "
              f"stragglers={len(tr.straggler_events)}")
    return tr


if __name__ == "__main__":
    main()
