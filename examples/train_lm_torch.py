"""End-to-end training example (the PyTorch twin of
``examples/train_lm.py``): train a small LM through the full training path
(deterministic pipeline, fault-tolerant trainer, checkpoints).

Default runs a ~20M model for 200 steps; pass ``--m100`` for the ~100M
model (same code path, ~40x more FLOPs).

    PYTHONPATH=src python examples/train_lm_torch.py [--m100] [--steps N] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.train import build
from repro_torch.train import trainer as trainer_lib
from repro_torch.train.step import TrainConfig


def lm_config(m100: bool) -> ModelConfig:
    if m100:  # ~103M params
        return ModelConfig(name="lm100m", family="dense", num_layers=12,
                           d_model=768, num_heads=12, num_kv_heads=12,
                           d_ff=2048, vocab_size=32768, tie_embeddings=True)
    return ModelConfig(name="lm20m", family="dense", num_layers=6,
                       d_model=384, num_heads=6, num_kv_heads=6,
                       d_ff=1024, vocab_size=16384, tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--m100", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=trainer_lib.default_ckpt_dir())
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    args = ap.parse_args(argv)

    cfg = lm_config(args.m100)
    shape = ShapeConfig("train_ex", args.seq, args.batch, "train")
    cfg, state, train_step, batch_fn = build(
        cfg.name, shape, smoke=False, seed=0, device=args.device, cfg=cfg,
        tcfg=TrainConfig(compute_dtype=torch.float32))
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params), "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens")

    tr = trainer_lib.Trainer(
        train_step, state, batch_fn,
        trainer_lib.TrainerConfig(total_steps=args.steps, ckpt_every=50,
                                  ckpt_dir=args.ckpt_dir))
    tr.run()
    log = tr.metrics_log
    for m in log[:: max(len(log) // 10, 1)]:
        print(f"  step {m['step']:>4d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  {m['dt']*1e3:.0f} ms")
    print(f"final loss: {log[-1]['loss']:.4f} (start {log[0]['loss']:.4f})")
    assert log[-1]["loss"] < log[0]["loss"]


if __name__ == "__main__":
    main()
