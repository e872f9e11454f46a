"""Deterministic synthetic data pipeline (the port of
``repro.data.pipeline``).

The batch for a step is a pure function of (seed, step): each row comes
from its own numpy Philox stream, the generation copied as is from the JAX
package, so the port's batches are bit-identical to JAX's.  On one device
the whole batch crosses to the device (:func:`device_batch`); on a mesh
each rank builds only its own rows of it (:func:`make_global_batch`, as
each JAX device builds its shard).  Tokens cross as int64,
the index type torch's embedding lookup and gather take; a stub
frontend's embeddings (audio frames, vlm patches: numpy Philox streams of
their own, as in JAX) as f32.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel import sharding as shd


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
    """Build rows [lo, hi) of step's global batch on this host: int32
    numpy ``targets``, and int32 ``inputs`` or, for a stub frontend, f32
    embeddings (B, S, d_model)."""
    hi = shape.global_batch if hi is None else hi
    toks = _tokens_for(cfg, seed, step, lo, hi, shape.seq_len)
    batch = {"targets": toks[:, 1:]}
    if cfg.frontend:
        emb = np.empty((hi - lo, shape.seq_len, cfg.d_model), np.float32)
        for i, row in enumerate(range(lo, hi)):
            rng = np.random.Generator(np.random.Philox(
                key=[(seed << 32) ^ step ^ 0x5EED, row]))
            emb[i] = 0.02 * rng.standard_normal(
                (shape.seq_len, cfg.d_model)).astype(np.float32)
        batch["inputs"] = emb
    else:
        batch["inputs"] = toks[:, :-1]
    return batch


def _to_device(batch: dict, device) -> dict:
    """A host batch on ``device``: tokens as int64, embeddings as f32."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device=device,
                dtype=torch.float32 if v.dtype == np.float32 else torch.int64)
            for k, v in batch.items()}


def device_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int, step: int,
                 device) -> dict:
    """Step's global batch on ``device``: tokens as int64, embeddings as
    f32."""
    return _to_device(host_batch(cfg, shape, seed, step), device)


def batch_rows(shape: ShapeConfig, mesh, rules=None) -> tuple[int, int]:
    """[lo, hi): this rank's rows of the global batch under ``batch_spec``
    on ``mesh``.  A global batch that the batch ranks do not divide
    raises ``ValueError`` (JAX's placement would replicate it)."""
    B = shape.global_batch
    dp = shd.batch_ranks(mesh, rules)
    if B % dp:
        raise ValueError(f"global batch {B} does not split over {dp} batch "
                         f"ranks")
    spec = shd.batch_spec(mesh, 2, rules, (B, shape.seq_len))
    return shd.shard_range(spec[0], B, mesh, shd.mesh_coords(mesh))


def make_global_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int,
                      step: int, mesh, rules=None, device="cuda") -> dict:
    """This rank's rows of step's global batch on ``device``, under
    ``batch_spec`` on ``mesh`` (``rules`` default ``DEFAULT_RULES``): built
    from :func:`host_batch` for those rows only, so no rank materialises
    the global batch (JAX's ``make_global_batch``, one process a rank)."""
    lo, hi = batch_rows(shape, mesh, rules)
    return _to_device(host_batch(cfg, shape, seed, step, lo, hi), device)


class PrefetchIterator:
    """Background-thread prefetch of batches (overlap data & compute).
    Given a ``mesh``, each batch is this rank's rows
    (:func:`make_global_batch`); the rows are fixed here, on the calling
    thread."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig, device, start_step: int = 0,
                 mesh=None, rules=None):
        self._q: queue.Queue = queue.Queue(maxsize=data_cfg.prefetch)
        self._stop = threading.Event()
        self._args = (cfg, shape, data_cfg.seed)
        self._rows = ((0, shape.global_batch) if mesh is None
                      else batch_rows(shape, mesh, rules))
        self._device = device
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        cfg, shape, seed = self._args
        step = self._step
        while not self._stop.is_set():
            batch = _to_device(host_batch(cfg, shape, seed, step,
                                          *self._rows), self._device)
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
