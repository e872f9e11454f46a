"""Deterministic synthetic data pipeline (the port of
``repro.data.pipeline``).

The batch for a step is a pure function of (seed, step): each row comes
from its own numpy Philox stream, the generation copied as is from the JAX
package, so the port's batches are bit-identical to JAX's.  On one device
the JAX package's sharded ``make_global_batch`` becomes a transfer of the
host batch to the device (:func:`device_batch`).  Tokens cross as int64,
the index type torch's embedding lookup and gather take.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 0
    prefetch: int = 2


def _tokens_for(cfg: ModelConfig, seed: int, step: int, lo: int, hi: int,
                seq_len: int) -> np.ndarray:
    """Rows [lo, hi) of the global batch for ``step`` — pure per-row function
    (row r depends only on (seed, step, r), so any host can build any slice
    and slices compose exactly)."""
    v = cfg.vocab_size
    out = np.empty((hi - lo, seq_len + 1), np.int32)
    for i, row in enumerate(range(lo, hi)):
        rng = np.random.Generator(np.random.Philox(
            key=[(seed << 32) ^ step, row]))
        # a Zipfian-ish unigram mix makes loss curves non-degenerate
        z = rng.zipf(1.3, size=seq_len + 1).astype(np.int64)
        out[i] = (z % v).astype(np.int32)
    return out


def host_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int, step: int,
               lo: int = 0, hi: Optional[int] = None) -> dict:
    """Build rows [lo, hi) of step's global batch on this host (int32
    numpy ``inputs`` and ``targets``)."""
    if cfg.frontend:
        raise NotImplementedError(
            "stub frontends (audio / vlm embeddings) come with the model-zoo "
            "slice of the port (ROADMAP Queue 1, slice 7)")
    hi = shape.global_batch if hi is None else hi
    toks = _tokens_for(cfg, seed, step, lo, hi, shape.seq_len)
    return {"targets": toks[:, 1:], "inputs": toks[:, :-1]}


def device_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int, step: int,
                 device) -> dict:
    """Step's global batch as int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device=device, dtype=torch.int64)
            for k, v in host_batch(cfg, shape, seed, step).items()}


class PrefetchIterator:
    """Background-thread prefetch of batches (overlap data & compute)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig, device, start_step: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=data_cfg.prefetch)
        self._stop = threading.Event()
        self._args = (cfg, shape, data_cfg.seed)
        self._device = device
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        cfg, shape, seed = self._args
        step = self._step
        while not self._stop.is_set():
            batch = device_batch(cfg, shape, seed, step, self._device)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
