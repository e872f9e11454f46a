"""Shape stand-ins for every model input, allocating nothing (the port of
``repro.launch.specs``).  One entry point: ``input_specs(arch,
shape_name)``.

train   -> {"inputs": (B, S) int64 | (B, S, D) f32 stub-frontend
            embeddings, "targets": (B, S) int64}
prefill -> the train inputs
decode  -> {"tokens": (B,) int64 | (B, D) f32 embeddings,
            "cache_len": (B,) int32, "caches": make_caches(shapes_only=True)}

Shapes are JAX's.  Dtypes are what the port's steps are fed
(``data/pipeline.py``): int64 tokens where JAX's specs have int32, and f32
embeddings, which the step casts to its compute dtype, where JAX's have
the compute dtype.  ``dtype`` is the caches'.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config)
from repro_torch.models import transformer
from repro_torch.models.module import ShapeDtype


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend:
        inputs = ShapeDtype((B, S, cfg.d_model), torch.float32)
    else:
        inputs = ShapeDtype((B, S), torch.int64)
    return {"inputs": inputs, "targets": ShapeDtype((B, S), torch.int64)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                       dtype=torch.bfloat16) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend:
        tokens = ShapeDtype((B, cfg.d_model), torch.float32)
    else:
        tokens = ShapeDtype((B,), torch.int64)
    return {"tokens": tokens,
            "cache_len": ShapeDtype((B,), torch.int32),
            "caches": transformer.make_caches(cfg, B, S, dtype,
                                              shapes_only=True)}


def input_specs(arch: str, shape_name: str, dtype=torch.bfloat16) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return train_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape, dtype)
