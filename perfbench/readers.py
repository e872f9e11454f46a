"""The metric arithmetic the readers under ``perfbench/end_to_end/`` and
``perfbench/metrics/`` share.  Each reader takes the run's record
(``bench.Window.record``) and returns a number, or None where the run
gives it nothing to read.

Percentiles are taken over every sample of the window (numpy's linear
interpolation), never as a median of chunks.  Operations and bytes are
counted by the cell's model module, which the record names
(``rec["reference"]``; ``perfbench/reference/``).
"""
from __future__ import annotations

import numpy as np

from perfbench import costs, reference


def _window(rec):
    return rec["t_open"], rec["t_close"]


def out_tok_s(rec):
    """Output tokens emitted in the window over the window's seconds."""
    t0, t1 = _window(rec)
    n = sum(sum(1 for t in r["times"] if t0 <= t < t1)
            for r in rec["requests"].values())
    return n / (t1 - t0) if n else None


def itl_ms(rec, q=95.0):
    """The q-th percentile of every gap between consecutive output tokens
    of one request, over the gaps that end in the window."""
    t0, t1 = _window(rec)
    gaps = [b - a for r in rec["requests"].values()
            for a, b in zip(r["times"], r["times"][1:]) if t0 <= b < t1]
    return 1e3 * float(np.percentile(gaps, q)) if gaps else None


def ttft_ms(rec, q=95.0):
    """The q-th percentile, over every request due in the window, of its
    first token less its due time; a request that failed or never got a
    token counts as infinitely late."""
    t0, t1 = _window(rec)
    xs = [(r["times"][0] - r["due"]) if r["times"] and "error" not in r
          else float("inf")
          for r in rec["requests"].values() if t0 <= r["due"] < t1]
    if not xs:
        return None
    v = float(np.percentile(xs, q, method="higher"))
    return 1e3 * v


def setup_s(rec):
    return rec["setup_s"]


def _unprofiled(rec):
    return [s for s in rec["steps"] if not s["profiled"]]


def decode_batch(rec):
    """Slots decoding per decode step, mean over the window's steps."""
    n = [len(s["decode_slots"]) for s in rec["steps"] if s["decode_slots"]]
    return float(np.mean(n)) if n else None


def queue_wait_ms(rec, q=50.0):
    """Due time to ``add_request``, the q-th percentile over the requests
    due in the window."""
    t0, t1 = _window(rec)
    xs = [r["admit"] - r["due"] for r in rec["requests"].values()
          if t0 <= r["due"] < t1 and r["admit"] is not None]
    return 1e3 * float(np.percentile(xs, q)) if xs else None


def decode_step_ms(rec):
    """The decode phase (staging, replay and the step's one sync), mean
    over the unprofiled steps that ran no chunk."""
    xs = [s["decode_ms"] for s in _unprofiled(rec)
          if s["decode_ms"] is not None and not s["chunks"]]
    return float(np.mean(xs)) if xs else None


def prefill_chunk_ms(rec):
    """A chunk's device time between CUDA events at the prefill_chunk
    phase's enter and exit, mean over the unprofiled steps."""
    xs = [ms for s in _unprofiled(rec) for ms in s["chunk_event_ms"]]
    return float(np.mean(xs)) if xs else None


def _model(rec):
    return reference.named(rec.get("reference", reference.DEFAULT))


def _prof(rec):
    p = rec.get("profile") or {}
    return p if p.get("steps") else None


def group_ms_per_step(rec, group):
    """Profiled device ms of a kernel group per engine step."""
    p = _prof(rec)
    if p is None or group not in p["groups_ms"]:
        return None
    return p["groups_ms"][group] / p["steps"]


def step_idle_pct(rec):
    p = _prof(rec)
    return None if p is None else p["step_idle_pct"]


def decode_attention_roofline_pct(rec):
    """The byte bound of the sub-window's decode_attention calls (what
    their inputs need, the model module's ``decode_attention_bytes``) at
    the HBM peak, over the kernel group's profiled time."""
    p = _prof(rec)
    if p is None or not p["groups_ms"].get("decode_attention"):
        return None
    count = _model(rec).decode_attention_bytes
    nbytes = sum(count(rec["model"], s["cache_len"])
                 for s in rec["steps"] if s["profiled"])
    bound_s = nbytes / costs.HBM_BYTES_PER_S
    return 100.0 * bound_s / (p["groups_ms"]["decode_attention"] / 1e3)


def mfu_pct(rec):
    """Model FLOPs of the window's unprofiled steps (the model module's
    ``chunk_flops`` and ``decode_flops``: real prefill tokens and decoding
    slots) over their summed engine-step time (host spans, each ending in
    the step's sync) at the bf16 peak."""
    steps = _unprofiled(rec)
    if not steps:
        return None
    m, mod = rec["model"], _model(rec)
    flops = sum(sum(mod.chunk_flops(m, start, n)
                    for _slot, start, n in s["chunks"])
                + mod.decode_flops(m, s["cache_len"]) for s in steps)
    seconds = sum(s["t1"] - s["t0"] for s in steps)
    return 100.0 * flops / (seconds * costs.PEAK_BF16_FLOPS)
