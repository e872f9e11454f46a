"""Roofline arithmetic on a :class:`~repro_torch.core.analytical.GpuSpec`
(the counterpart of ``repro.roofline.analysis``).

Terms per (arch x shape x mesh), all in seconds *per device*:

    compute    = FLOPs            / peak FLOP/s
    memory     = bytes            / HBM bytes/s
    collective = collective_bytes / link bytes/s

The moved bytes of a collective follow the ring algorithm
(:func:`moved_bytes`), ``b`` being the bytes of the op's result and ``n``
its group size:

    all-reduce          2 b (n-1)/n   (reduce-scatter + all-gather phases)
    all-gather            b (n-1)/n   (each device receives (n-1)/n of it)
    reduce-scatter        b (n-1)     (the input, n b, crosses the ring once)
    all-to-all            b
    collective-permute    b

:class:`Roofline` carries the spec it was built for and divides by that
spec's peak.  Reading the terms out of a compiled program (JAX's
``analyse`` and ``collective_bytes`` over XLA HLO text) belongs with the
dry run and has no counterpart here yet.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.analytical import H100, GpuSpec

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def moved_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes one device moves for a collective of ``kind`` whose result
    holds ``nbytes``, over a group of ``n`` devices (the ring model)."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}; one of {COLLECTIVES}")
    if kind == "all-reduce":
        return 2.0 * nbytes * max(n - 1, 0) / max(n, 1)
    if kind == "all-gather":
        return 1.0 * nbytes * max(n - 1, 0) / max(n, 1)
    if kind == "reduce-scatter":
        return float(nbytes) * max(n - 1, 0)
    return float(nbytes)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops: float            # per device
    bytes_accessed: float   # per device
    coll_bytes: float       # per device, moved
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops_total: float
    chips: int
    coll_detail: dict
    memory_per_device: float = 0.0
    hw: GpuSpec = H100

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the spec's bf16 peak the *useful* model FLOPs
        achieve when running at the bound:
        (model_flops / chips / peak) / t_bound."""
        if self.t_bound <= 0:
            return 0.0
        t_useful = self.model_flops_total / self.chips / self.hw.peak_bf16
        return t_useful / self.t_bound

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "hw": self.hw.name, "chips": self.chips,
            "flops_per_dev": self.flops,
            "bytes_per_dev": self.bytes_accessed,
            "coll_bytes_per_dev": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops_total": self.model_flops_total,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory_per_device_gib": self.memory_per_device / 2**30,
            "collectives": self.coll_detail.get("counts", {}),
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train (N = active params for MoE), 2·N·D
    prefill, 2·N·B decode (one token per sequence)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
