"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Wires the training path end to end on one device: config -> state ->
deterministic data pipeline -> train step -> fault-tolerant Trainer with
async checkpointing and SIGTERM-preemption handling.  It trains through
``FamousConfig(impl="pallas")``: on the GPU the hand-written kernels
(attention forward, dq and dk/dv, and the QKV projection with its VJP);
with ``--device cpu`` their plain PyTorch versions.  Without a GPU it
raises unless ``--device cpu`` is given.  ``--smoke`` (the default, as in
the JAX launcher) shrinks the config; ``--full`` trains it at full size.
"""
from __future__ import annotations

import argparse
import signal

import torch

from repro_torch.configs.base import (SHAPES, SMOKE_SHAPES, ShapeConfig,
                                      get_config, shrink)
from repro_torch.core.famous import FamousConfig
from repro_torch.data import pipeline
from repro_torch.serve.engine import resolve_device
from repro_torch.train import step as step_lib
from repro_torch.train import trainer as trainer_lib


def build(arch: str, shape: ShapeConfig, *, smoke: bool,
          tcfg: step_lib.TrainConfig | None = None,
          fcfg: FamousConfig | None = None, seed: int = 0, device="cuda",
          cfg=None):
    """Returns (cfg, state, train_step, batch_fn).  ``cfg`` overrides the
    registered config (a depth cut, say)."""
    device = resolve_device(device)
    cfg = cfg or get_config(arch)
    if smoke:
        cfg = shrink(cfg)
    fcfg = fcfg or FamousConfig(impl="pallas")
    tcfg = tcfg or step_lib.TrainConfig(
        compute_dtype=torch.float32 if smoke else torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = step_lib.init_state(cfg, tcfg, gen, device)
    train_step = step_lib.make_train_step(cfg, fcfg, tcfg)

    def batch_fn(step: int):
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
    args = ap.parse_args(argv)

    shape = {**SHAPES, **SMOKE_SHAPES}[args.shape]
    cfg, state, train_step, batch_fn = build(
        args.arch, shape, smoke=args.smoke, seed=args.seed,
        device=args.device)
    tcfg = trainer_lib.TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir)
    tr = trainer_lib.Trainer(train_step, state, batch_fn, tcfg)
    signal.signal(signal.SIGTERM, lambda *_: tr.request_stop())
    tr.run()
    for m in tr.metrics_log[-5:]:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in m.items()})
    print(f"done: arch={cfg.name} steps={int(tr.state['step'])} "
          f"restarts={tr.restarts} stragglers={len(tr.straggler_events)}")
    return tr


if __name__ == "__main__":
    main()
