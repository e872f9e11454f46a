"""Reduction of a ``torch.profiler`` trace of the steady sub-window to
per-layer numbers.

Kernel grouping is a frozen copy of ``chip_smoke.kernel_group`` /
``profile_groups``: each of the port's kernels by its symbol, library
GEMMs by the library's kernel names, everything else "other".  Host
spans come from ``record_function`` marks the harness and its observer
put on the same timeline: ``perfbench.step`` around each engine step and
``host.<what>`` around each host phase (``host.decode``,
``host.prefill_chunk``, ``host.admit``, ``host.wait``).
"""
from __future__ import annotations

STEP = "perfbench.step"
GEMM_WORDS = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")


def _mark(name: str) -> bool:
    return name == STEP or name.startswith("host.")


def kernel_group(key: str, names) -> str | None:
    """The port kernel a device op belongs to (see the module doc)."""
    if "matmul_int8_kernel" in key:
        return "matmul_tiled_int8"
    if "wkv6_chunk_kernel" in key or "wkv6_state_kernel" in key:
        return "wkv6_scan"
    if "FlatQ" in key:
        return "mha_forward"
    for sym, name in (("PagedRows", "paged_decode_attention"),
                      ("PagedKV", "paged_chunk_prefill"),
                      ("paged_chunk_prefill_kernel", "paged_chunk_prefill")):
        if sym in key:
            return name + ("_int8" if "signed char" in key else "")
    if "ContigRows" in key:
        return "decode_attention"
    if "ContigKV" in key:
        return "chunk_prefill"
    return next((k for k in names if k in key), None)


def group_of(key: str, names) -> str:
    g = kernel_group(key, names)
    if g is not None:
        return g
    return "library GEMM" if any(w in key.lower() for w in GEMM_WORDS) \
        else "other"


def union(intervals: list) -> list:
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def covered(merged: list, a: float, b: float) -> float:
    """Length of [a, b] that the merged intervals cover."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in merged)


def reduce(events, names) -> dict:
    """``events``: (name, is_device, start_us, end_us) of a trace.  Returns
    the steps' spans, device time by group, the traced window and the
    device's busy time in it, the steps' idle share, the top device ops
    and the longest idle gaps labelled by the host phase open at their
    start."""
    steps = [(s, e) for n, dev, s, e in events if not dev and n == STEP]
    if not steps:
        return {}
    w0, w1 = min(s for s, _ in steps), max(e for _, e in steps)
    # device rows named after a host mark are the profiler's annotations
    # of that mark on the device's timeline, not device work
    kern = [(n, s, e) for n, dev, s, e in events
            if dev and e > w0 and s < w1 and not _mark(n)]
    merged = union([(max(s, w0), min(e, w1)) for _, s, e in kern])
    groups, ops = {}, {}
    for n, s, e in kern:
        g = group_of(n, names)
        groups[g] = groups.get(g, 0.0) + (e - s) / 1e3
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
    step_us = sum(e - s for s, e in steps)
    busy_in_steps = sum(covered(merged, s, e) for s, e in steps)
    host = sorted((s, e, n[len("host."):]) for n, dev, s, e in events
                  if not dev and n.startswith("host."))
    gaps = []
    prev = w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    gaps.sort(reverse=True)

    def label(t):
        inside = [n for s, e, n in host if s <= t < e]
        return inside[-1] if inside else "between phases"

    return {
        "steps": len(steps),
        "step_s": step_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(e - s for s, e in merged) / 1e6,
        "step_idle_pct": 100.0 * (1.0 - busy_in_steps / step_us),
        "groups_ms": groups,
        "device_ops": sorted(([n, v] for n, v in ops.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[label(t), g / 1e6] for g, t in gaps[:10]],
    }


def trace_events(prof) -> list:
    """(name, is_device, start_us, end_us) of every event of a finished
    ``torch.profiler.profile``."""
    out = []
    for ev in prof.events():
        dev = str(getattr(ev, "device_type", "")).endswith("CUDA")
        tr = ev.time_range
        out.append((ev.name, dev, float(tr.start), float(tr.end)))
    return out
