"""Fused MHA kernel wrappers: the FAMOUS QK_PM -> softmax -> SV_PM forward
and its flash backward, on the flat ``(B·H, S, dh)`` layout.

On CUDA tensors ``mha_forward`` launches the hand-written kernel of
``kernels/csrc/mha_forward.cu`` (the port of the Pallas ``_mha_kernel`` in
``repro/kernels/attention/mha.py``), and ``mha_backward`` computes
``delta = sum_d dO * O`` and runs ``mha_bwd_dq`` and ``mha_bwd_dkv``,
which launch ``kernels/csrc/mha_bwd_dq.cu`` and
``kernels/csrc/mha_bwd_dkv.cu`` (the ports of ``_mha_bwd_dq_kernel`` and
``_mha_bwd_dkv_kernel``).  Each block
walks its own key (or query) tiles, so the block sizes need not divide the
sequence lengths, and the dk/dv kernel sums over the GQA group itself.
``causal``, ``window`` and ``q_offset`` are plain launch arguments.  In
bf16 all three run on tensor cores (:func:`ref.mha_forward_tc_reference`,
:func:`ref.mha_bwd_dq_tc_reference` and
:func:`ref.mha_bwd_dkv_tc_reference` state their algebra); the forward
and the dq kernel may split a block's key range and the dk/dv kernel a
key block's work, as their C plans (:func:`forward_plan`,
:func:`dq_plan`, :func:`dkv_plan`) say from static shapes and the SM
count, into an f32 workspace allocated here.  Head dims run up to
:data:`MAX_HEAD_DIM`: above :data:`TC_MAX_HEAD_DIM` (recurrentgemma-2b's
256) the bf16 forward runs 64-row blocks (:func:`forward_block_rows`) and
dq and dk/dv their wide tensor-core geometries (:func:`dq_tiles`,
:func:`dkv_tiles`: two warps to each 16-row or 16-key strip, each owning
half the head dim's columns), split as :func:`dq_split_rule` and
:func:`dkv_split_rule` restate the C plans.  In f32 dq and dk/dv run
their CUDA-core kernels at every head dim.  On CPU tensors all three run
the plain versions in :mod:`repro_torch.kernels.attention.ref`.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import lib
from repro_torch.kernels.attention import ref

MAX_HEAD_DIM = 256
# the largest head dim of the bf16 dq and dk/dv tensor-core geometries
TC_MAX_HEAD_DIM = 128


def forward_block_rows(dh: int) -> int:
    """Query rows a block of the bf16 forward (``chunk_tc.cuh``'s
    ServeTiles): 128, or 64 above :data:`TC_MAX_HEAD_DIM`, where a warp's
    32 rows of f32 accumulators would not fit in registers."""
    return 128 if dh <= TC_MAX_HEAD_DIM else 64


def dq_tiles(dh: int) -> tuple[int, int]:
    """(query rows a block, keys a tile) of the bf16 dq kernel
    (``mha_bwd_dq.cu``'s DqServe): 64 x 64, or 64 x 32 above
    :data:`TC_MAX_HEAD_DIM` (DqWideServe: one stage of 32-key K and V
    tiles, so that two blocks fit an SM)."""
    return (64, 64) if dh <= TC_MAX_HEAD_DIM else (64, 32)


def dkv_tiles(dh: int) -> tuple[int, int]:
    """(keys a block, query rows an item) of the bf16 dk/dv kernel
    (``mha_bwd_dkv.cu``'s DkvServe, and DkvWideServe above
    :data:`TC_MAX_HEAD_DIM`): 64 x 64 at every head dim."""
    return 64, 64


# mha_bwd_dq.cu's kDqOccupancySplits / kDqWideFill / kDqWideOccupancySplits
# and mha_bwd_dkv.cu's kDkvOccupancySplits / kDkvWideFill /
# kDkvWideOccupancySplits: (row or key blocks an SM to fill, the most
# splits that fill may add), at dh <= TC_MAX_HEAD_DIM and above it
DQ_FILL = {False: (2, 8), True: (4, 8)}
DKV_FILL = {False: (4, 8), True: (2, 16)}


def dq_split_rule(BH: int, Sq: int, Skv: int, dh: int, sms: int) -> int:
    """The bf16 dq plan's split count (``mha_bwd_dq.cu``'s
    ``dq_split_rule``): runs of at most :data:`ref.DQ_RUN_KEYS` keys, and
    where the row blocks fill fewer than ``DQ_FILL`` blocks an SM, as many
    splits as bring them there, at most its cap."""
    bq, bk = dq_tiles(dh)
    per_sm, cap = DQ_FILL[dh > TC_MAX_HEAD_DIM]
    blocks = BH * -(-Sq // bq)
    tiles = -(-Skv // bk)
    run_tiles = ref.DQ_RUN_KEYS // bk
    splits = -(-tiles // run_tiles)
    if blocks < per_sm * sms:
        splits = max(splits, min(cap, per_sm * sms // blocks))
    return max(1, min(splits, tiles))


def dkv_split_rule(BH: int, BKV: int, Sq: int, Skv: int, dh: int,
                   sms: int) -> int:
    """The bf16 dk/dv plan's split count (``mha_bwd_dkv.cu``'s
    ``dkv_split_rule``): runs of at most :data:`ref.DKV_RUN_ROWS` query
    rows, and where the key blocks fill fewer than ``DKV_FILL`` blocks an
    SM, as many splits as bring them there, at most its cap."""
    bk, bq = dkv_tiles(dh)
    per_sm, cap = DKV_FILL[dh > TC_MAX_HEAD_DIM]
    blocks = BKV * -(-Skv // bk)
    items = BH // BKV * -(-Sq // bq)
    run_items = ref.DKV_RUN_ROWS // bq
    splits = -(-items // run_items)
    if blocks < per_sm * sms:
        splits = max(splits, min(cap, per_sm * sms // blocks))
    return max(1, min(splits, items))


def _scale(scale, dh):
    return float(scale) if scale is not None else 1.0 / math.sqrt(dh)


def mha_forward(q, k, v, *, causal: bool = True, window: int = 0,
                scale: float | None = None, q_offset: int = 0,
                return_lse: bool = False):
    """q: (BH, Sq, dh); k, v: (BKV, Skv, dh) with BH = BKV * group.
    Returns (BH, Sq, dh) in q's dtype, plus the f32 row log-sum-exp
    (BH, Sq) when ``return_lse`` (the flash backward residual)."""
    args = dict(causal=bool(causal), window=int(window),
                scale=_scale(scale, q.shape[-1]), q_offset=int(q_offset))
    if q.device.type == "cpu":
        out, lse = ref.mha_forward_reference(q, k, v, **args)
    else:
        out, lse = _launch_forward(q, k, v, **args)
    return (out, lse) if return_lse else out


def mha_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                 window: int = 0, scale: float | None = None,
                 q_offset: int = 0):
    """Flash backward.  q/out/dout: (BH, Sq, dh); k, v: (BKV, Skv, dh);
    lse: (BH, Sq) f32.  Returns f32 (dq (BH, Sq, dh), dk, dv (BKV, Skv,
    dh)), the GQA group sum already taken."""
    args = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    # D_i = sum_d dO_i * O_i, once, outside the kernels (as in JAX)
    delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(-1)
    lse = lse.to(torch.float32)
    return (mha_bwd_dq(q, k, v, dout, lse, delta, **args),
            *mha_bwd_dkv(q, k, v, dout, lse, delta, **args))


def mha_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
               window: int = 0, scale: float | None = None,
               q_offset: int = 0):
    """The dq kernel: f32 dq (BH, Sq, dh) from the saved LSE and
    ``delta = sum_d dO * O`` (both (BH, Sq) f32)."""
    args = dict(causal=bool(causal), window=int(window),
                scale=_scale(scale, q.shape[-1]), q_offset=int(q_offset))
    if q.device.type == "cpu":
        return ref.mha_bwd_dq_reference(q, k, v, dout, lse, delta, **args)
    return _launch_dq(q, k, v, dout, lse, delta, **args)


def mha_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                window: int = 0, scale: float | None = None,
                q_offset: int = 0):
    """The dk/dv kernel: f32 (dk, dv), each (BKV, Skv, dh), summed over
    each kv head's group of query heads."""
    args = dict(causal=bool(causal), window=int(window),
                scale=_scale(scale, q.shape[-1]), q_offset=int(q_offset))
    if q.device.type == "cpu":
        return ref.mha_bwd_dkv_reference(q, k, v, dout, lse, delta, **args)
    return _launch_dkv(q, k, v, dout, lse, delta, **args)


def _check(name, q, k, v, *rows):
    """Shape, device, dtype and layout checks of the launch path; returns
    (dtype code, BH, BKV, Sq, Skv, dh)."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    BH, Sq, dh = q.shape
    BKV, Skv, _ = k.shape
    if k.shape[2] != dh or BKV == 0 or BH % BKV or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: q {tuple(q.shape)} against kv "
                         f"{tuple(k.shape)} (head dim at most "
                         f"{MAX_HEAD_DIM}, BH a multiple of BKV)")
    lib.require_cuda(name, q, k, v, *rows)
    code = lib.require_dtype(name, q, k, v, *rows[:1])
    for t in (q, k, v, *rows):
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous operands required")
    return code, BH, BKV, Sq, Skv, dh


@functools.lru_cache(maxsize=None)
def forward_plan(code: int, BH: int, BKV: int, Sq: int, Skv: int, dh: int,
                 sms: int) -> tuple[int, int]:
    """Key-range splits of the bf16 forward for a static shape
    (``lib.DTYPE_CODE`` dtype code, query and kv rows, lengths, head dim,
    SM count) and the f32 elements of its workspace (0 for one split;
    always 1 split in f32)."""
    return lib.plan("famous_mha_forward_plan", code, BH, BKV, Sq, Skv, dh,
                    sms)


@functools.lru_cache(maxsize=None)
def dq_plan(code: int, BH: int, BKV: int, Sq: int, Skv: int, dh: int,
            sms: int) -> tuple[int, int]:
    """Splits of the bf16 dq kernel (each row block's key tiles cut into
    that many runs, whose f32 partials are summed in order;
    :func:`dq_split_rule`) and the f32 elements of their workspace (0 for
    one split; always 1 in f32)."""
    return lib.plan("famous_mha_bwd_dq_plan", code, BH, BKV, Sq, Skv, dh,
                    sms)


@functools.lru_cache(maxsize=None)
def dkv_plan(code: int, BH: int, BKV: int, Sq: int, Skv: int, dh: int,
             sms: int) -> tuple[int, int]:
    """Splits of the bf16 dk/dv kernel (each key block's work items cut
    into that many runs, whose f32 partials are summed in order;
    :func:`dkv_split_rule`) and the f32 elements of their workspace (0 for
    one split; always 1 in f32)."""
    return lib.plan("famous_mha_bwd_dkv_plan", code, BH, BKV, Sq, Skv, dh,
                    sms)


def _launch_forward(q, k, v, *, causal, window, scale, q_offset):
    name = "mha_forward"
    code, BH, BKV, Sq, Skv, dh = _check(name, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    splits, n_ws = forward_plan(code, BH, BKV, Sq, Skv, dh,
                                lib.sm_count(q.device))
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    err = lib.load().famous_mha_forward(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), ws.data_ptr() if n_ws else None, splits, BH, BKV, Sq,
        Skv, dh, int(causal), window, q_offset, scale, lib.stream_of(q))
    lib.check(name, err, ws)
    lib.STATS.launches[name] += 1
    return out, lse


def _check_bwd(name, q, k, v, dout, lse, delta):
    """:func:`_check` plus the backward's cotangent and f32 row inputs."""
    dims = _check(name, q, k, v, dout, lse, delta)
    BH, Sq = dims[1], dims[3]
    if dout.shape != q.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} vs q "
                         f"{tuple(q.shape)}")
    for t in (lse, delta):
        if t.dtype != torch.float32 or t.shape != (BH, Sq):
            raise ValueError(f"{name}: lse/delta must be f32 ({BH}, {Sq}), "
                             f"got {t.dtype} {tuple(t.shape)}")
    return dims


def _launch_dq(q, k, v, dout, lse, delta, *, causal, window, scale,
               q_offset):
    name = "mha_bwd_dq"
    code, BH, BKV, Sq, Skv, dh = _check_bwd(name, q, k, v, dout, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    splits, n_ws = dq_plan(code, BH, BKV, Sq, Skv, dh, lib.sm_count(q.device))
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    err = lib.load().famous_mha_bwd_dq(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        ws.data_ptr() if n_ws else None, splits, BH, BKV, Sq, Skv, dh,
        int(causal), window, q_offset, scale, lib.stream_of(q))
    lib.check(name, err, ws)
    lib.STATS.launches[name] += 1
    return dq


def _launch_dkv(q, k, v, dout, lse, delta, *, causal, window, scale,
                q_offset):
    name = "mha_bwd_dkv"
    code, BH, BKV, Sq, Skv, dh = _check_bwd(name, q, k, v, dout, lse, delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    splits, n_ws = dkv_plan(code, BH, BKV, Sq, Skv, dh,
                            lib.sm_count(q.device))
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    err = lib.load().famous_mha_bwd_dkv(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ws.data_ptr() if n_ws else None, splits, BH, BKV, Sq, Skv, dh,
        int(causal), window, q_offset, scale, lib.stream_of(q))
    lib.check(name, err, ws)
    lib.STATS.launches[name] += 1
    return dk, dv
