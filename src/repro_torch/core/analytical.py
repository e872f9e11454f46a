"""Analytical latency model: the paper's §VII (Eq. 3-14) on an NVIDIA H100
(the counterpart of ``repro.core.analytical``).

FAMOUS predicts per-module latency with the pipelined-loop model

    PLL = (TC - 1) · II + Pipeline_Depth          (Eq. 3)
    TL  = PLL · outer trip count                  (Eq. 4)

On the card the same structure is kept as the JAX package states it for a
tiled kernel: the trip count TC is the number of tiles a module walks,
the initiation interval II is ``max(tile compute time, tile memory
time)`` (copies overlap the products), and the pipeline depth is the
first tile's fill plus a fixed start cost, here the kernel launch.  The
per-module equations (Eq. 5-12: LI/LB/LIA/LWA for loads, SA/S/SV for the
three PMs) become per-module (operations, device-memory bytes, on-chip
working set) terms; the formulas are JAX's, term for term, and take the
hardware as ``hw``, so a :class:`GpuSpec` holding another part's numbers
reproduces that part's predictions.

The model serves the paper's two purposes:
  1. predict a module's latency from its shapes before any run;
  2. choose the tile size: :func:`autotune_tiles` rejects tilings whose
     double-buffered working set exceeds the shared memory a block may
     take and picks the latency-minimising (tile_q, tile_k, tile_d).

The candidates include 64 (``wgmma``'s M): on the H100 the double-buffered
QKV_PM working set at 128 x 128 x 128 is 2 · (2 · (128·128 + 128·128) +
4·128·128) = 262144 B, above the 232448 B a block may take, so without 64
no tiling fits.  A spec whose ``align`` is 128 never sees 64.
"""
from __future__ import annotations

import dataclasses
import itertools
import math


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """One card's numbers for the model.  :data:`H100` is the NVIDIA H100
    SXM, as ``nvidia-smi`` names the card the port runs on: "NVIDIA H100
    80GB HBM3" at a power limit of 700 W (the data-sheet rates assume that
    limit; a card set lower runs slower under load).  Rates are dense, from
    NVIDIA's data sheet."""

    name: str = "h100-sxm"
    peak_bf16: float = 989e12       # FLOP/s, tensor cores
    peak_int8: float = 1979e12      # OP/s, tensor cores
    peak_f32: float = 67e12         # FLOP/s, CUDA cores
    hbm_bw: float = 3.35e12         # B/s
    link_bw: float = 450e9          # B/s NVLink a direction (ICI's place)
    hbm_bytes: float = 80e9
    smem_bytes: float = 232448      # opt-in shared memory a block (VMEM's)
    sms: int = 132
    align: int = 64                 # tile alignment: wgmma's M (the MXU's)
    # s a kernel launch (the PD term): chip_smoke.py phase 21d times a tiny
    # kernel in a replayed CUDA graph at about this on the H100
    launch_latency: float = 4e-6


H100 = GpuSpec()


@dataclasses.dataclass
class ModuleLatency:
    """One FAMOUS processing module's predicted cost."""

    name: str
    flops: float
    hbm_bytes: float
    smem_bytes: float       # per-step working set (must fit shared memory)
    steps: int              # trip count TC (number of tiles)

    t_compute: float = 0.0
    t_memory: float = 0.0
    ii: float = 0.0         # initiation interval
    t_total: float = 0.0    # (TC-1)*II + PD

    def finalize(self, hw: GpuSpec, peak: float) -> "ModuleLatency":
        self.t_compute = self.flops / peak
        self.t_memory = self.hbm_bytes / hw.hbm_bw
        per_step_c = self.t_compute / max(self.steps, 1)
        per_step_m = self.t_memory / max(self.steps, 1)
        self.ii = max(per_step_c, per_step_m)
        pd = per_step_m + hw.launch_latency  # first-tile fill
        self.t_total = max(self.steps - 1, 0) * self.ii + pd + per_step_c
        return self


@dataclasses.dataclass
class MhaLatency:
    modules: list[ModuleLatency]

    @property
    def total(self) -> float:            # Eq. 13
        return sum(m.t_total for m in self.modules)

    @property
    def flops(self) -> float:
        return sum(m.flops for m in self.modules)

    @property
    def hbm_bytes(self) -> float:
        return sum(m.hbm_bytes for m in self.modules)

    def gops(self) -> float:
        """Throughput in GOPS as the paper reports (ops = 2*MACs)."""
        return self.flops / self.total / 1e9

    def table(self) -> str:
        rows = [f"{'module':<10}{'steps':>7}{'GFLOP':>10}{'MB':>10}"
                f"{'II(us)':>10}{'t(us)':>10}"]
        for m in self.modules:
            rows.append(
                f"{m.name:<10}{m.steps:>7}{m.flops/1e9:>10.3f}"
                f"{m.hbm_bytes/1e6:>10.3f}{m.ii*1e6:>10.3f}{m.t_total*1e6:>10.2f}")
        rows.append(f"{'TOTAL':<10}{'':>7}{self.flops/1e9:>10.3f}"
                    f"{self.hbm_bytes/1e6:>10.3f}{'':>10}{self.total*1e6:>10.2f}")
        return "\n".join(rows)


def mha_latency(*, batch: int, seq: int, heads: int, kv_heads: int,
                head_dim: int, d_model: int, tile_q: int = 512,
                tile_k: int = 512, tile_d: int = 512, dtype_bytes: int = 2,
                kv_seq: int | None = None, hw: GpuSpec = H100,
                quant: str = "none") -> MhaLatency:
    """Predict FAMOUS MHA latency for one (B, S, H, dh) problem.

    Mirrors Eq. 5-13: module terms for loading inputs and weights (folded
    into each module's device-memory bytes: loads are the copy half of the
    pipeline, not separate phases) and the three PMs.
    """
    kv_seq = kv_seq or seq
    peak = hw.peak_int8 if quant == "int8" else hw.peak_bf16
    in_bytes = 1 if quant == "int8" else dtype_bytes
    tile_q = min(tile_q, seq)
    tile_k = min(tile_k, kv_seq)
    tile_d = min(tile_d, d_model)
    proj = heads * head_dim

    # --- QKV_PM (Alg. 1): X (B,S,D) x W (D, proj_q + 2 kv_proj) ------------
    # Tiling-aware traffic: with an output-stationary (tile_q x tile_f)
    # accumulation over TS-sized reduction tiles, X is re-read once per
    # output-column block and W once per token block (the FPGA's "each tile
    # loaded (d_model/TS) times").
    kv_proj = kv_heads * head_dim
    w_cols = proj + 2 * kv_proj
    tile_f = min(tile_k, w_cols)
    flops = 2.0 * batch * seq * d_model * w_cols
    n_tiles_d = math.ceil(d_model / tile_d)                     # TS loop
    n_tiles_f = math.ceil(w_cols / tile_f)
    n_tiles_t = math.ceil(batch * seq / tile_q)
    hbm = (in_bytes * batch * seq * d_model * n_tiles_f         # X reloads
           + in_bytes * d_model * w_cols * n_tiles_t            # W reloads
           + dtype_bytes * batch * seq * w_cols)                # QKV out once
    smem = in_bytes * (tile_q * tile_d + tile_d * tile_f) \
        + 4 * tile_q * tile_f                                   # f32 acc
    steps = n_tiles_t * n_tiles_f * n_tiles_d
    qkv = ModuleLatency("QKV_PM", flops, hbm, smem, steps).finalize(hw, peak)

    # --- QK_PM (Alg. 2) + softmax ------------------------------------------
    # Q tile resident; K streams once per q block (flash ordering).
    n_q = max(1, seq // tile_q)
    n_k = max(1, kv_seq // tile_k)
    flops = 2.0 * batch * heads * seq * kv_seq * head_dim
    softmax_flops = 6.0 * batch * heads * seq * kv_seq          # exp/sum
    hbm = dtype_bytes * batch * (seq * proj                     # Q once
                                 + kv_seq * kv_proj * n_q)      # K per q-block
    smem = dtype_bytes * (tile_q * head_dim + tile_k * head_dim) \
        + 4 * tile_q * tile_k
    steps = n_q * n_k * batch * heads
    qk = ModuleLatency("QK_PM", flops + softmax_flops, hbm, smem,
                       steps).finalize(hw, peak)

    # --- SV_PM (Alg. 3) ------------------------------------------------------
    flops = 2.0 * batch * heads * seq * kv_seq * head_dim
    hbm = dtype_bytes * batch * (kv_seq * kv_proj * n_q          # V per q-blk
                                 + seq * proj)                   # O out
    smem = dtype_bytes * (tile_q * tile_k + tile_k * head_dim) \
        + 4 * tile_q * head_dim
    steps = n_q * n_k * batch * heads
    sv = ModuleLatency("SV_PM", flops, hbm, smem, steps).finalize(hw, peak)

    return MhaLatency([qkv, qk, sv])


def fits_smem(lat: MhaLatency, hw: GpuSpec = H100) -> bool:
    # double-buffered copies: 2x the working set must fit
    return all(2 * m.smem_bytes <= hw.smem_bytes for m in lat.modules)


def autotune_tiles(*, batch: int, seq: int, heads: int, kv_heads: int,
                   head_dim: int, d_model: int, dtype_bytes: int = 2,
                   kv_seq: int | None = None, hw: GpuSpec = H100,
                   quant: str = "none",
                   candidates=(64, 128, 256, 512, 1024, 2048)) -> dict:
    """Pick (tile_q, tile_k, tile_d) minimising predicted total latency
    under the shared-memory limit: the paper's TS sweep without the 36 h
    synthesis.  ``kv_seq``: keys a query sees when they are not ``seq``
    (a prefill chunk against its cache), as :func:`mha_latency` takes it.
    Raises ``ValueError`` when no candidate tiling fits."""
    best = None
    for tq, tk, td in itertools.product(candidates, repeat=3):
        if tq % hw.align or tk % hw.align or td % hw.align:
            continue
        lat = mha_latency(batch=batch, seq=seq, heads=heads,
                          kv_heads=kv_heads, head_dim=head_dim,
                          d_model=d_model, tile_q=tq, tile_k=tk, tile_d=td,
                          dtype_bytes=dtype_bytes, kv_seq=kv_seq, hw=hw,
                          quant=quant)
        if not fits_smem(lat, hw):
            continue
        if best is None or lat.total < best[0]:
            best = (lat.total, dict(tile_q=tq, tile_k=tk, tile_d=td), lat)
    if best is None:
        raise ValueError(f"no feasible tiling of {candidates} within "
                         f"{hw.smem_bytes} B of shared memory on {hw.name}")
    return {"tiles": best[1], "latency": best[2]}


def paper_gops(*, seq: int, d_model: int, heads: int) -> float:
    """Operation count (GOP) as the paper counts it: QKV + QK + SV MACs*2."""
    dh = d_model // heads
    qkv = 2 * seq * d_model * 3 * d_model
    qk = 2 * heads * seq * seq * dh
    sv = 2 * heads * seq * seq * dh
    return (qkv + qk + sv) / 1e9
