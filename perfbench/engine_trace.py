"""The engine's own tracing beside one run of a cell: ``bench.run_cell``
with the engine's observer an ``Observer(trace=True)``, and what that
observer saw, read into numbers.

    python3 perfbench/engine_trace.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--observer traced|null] [--judge 0|1]

``perfbench/run.py`` builds the engine with ``NULL_OBSERVER`` and reads
none of this.  Here the harness's own window runs unchanged, except that
the observer it wraps traces (``--observer null`` keeps ``NULL_OBSERVER``,
for the cost of tracing), the tracer is anchored to the profiler's clock
when the profiler starts and stops, and the engine's MoE routing counts
are read at the window's open and close.  ``--judge 0`` leaves the
reference out (``correct`` prints null).  The output is run.py's: the
info line on standard error, then the result line, with these added:

- ``engine_idle_pct.<batch|rate>`` (%): 100 x (1 - the executables'
  device time, from the engine's CUDA events / the ``step`` spans' host
  time), over the window's unprofiled steps; none without device spans
  (the CPU);
- ``host_self_ms.<batch|rate>`` (ms): a ``step`` span less its ``wait``
  spans, mean over the same steps;
- ``expert_fill_pct.<batch|rate>`` (%, MoE cells): 100 x real tokens'
  choices kept / capacity rows computed, over the window;
- info ``idle_gaps_program``: the traced sub-window's 10 longest
  device-idle gaps, each labelled by the innermost program span open at
  its start; ``host_self_ms_by_span``: the mean self ms a step of
  ``step`` and each span inside it; ``moe_choices``;
  ``device_ms_by_exec`` (a call's event span by executable, in unprofiled
  and profiled steps); ``replay_vs_kernels`` (each executable's event
  span against the union of the kernels inside it); ``anchors`` (the
  anchored mapping checked against the profiler's own launch records,
  and the clocks' drift).

``<batch|rate>`` is the cell's loop: a backlog or arrivals.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from bisect import bisect_right  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MOE_KEYS = ("real", "kept", "dropped", "capacity_rows")
# runtime calls the profiler records where the host hands the device a
# kernel or a graph
LAUNCHES = ("cudaGraphLaunch", "cudaLaunchKernel", "cuLaunchKernel")


# -- readers: ``rec`` is a window's record with ``rec["engine"]`` -------------
def _host(rec):
    """(spans with absolute host times, their self times in seconds)."""
    from repro_torch.obs import trace
    eng = rec.get("engine") or {}
    sp = trace.spans(eng.get("events", []))
    t0 = eng.get("t0", 0.0)
    for s in sp:
        s["t"], s["t_end"] = t0 + s["ts"] / 1e6, t0 + s["end"] / 1e6
    return sp, [x / 1e6 for x in trace.self_times(sp)]


def _window_steps(rec, sp, profiled=False):
    """Indices of the engine's ``step`` spans inside the window's
    unprofiled (or profiled) steps, the harness's step brackets."""
    steps = sorted((s["t0"], s["t1"]) for s in rec["steps"]
                   if s["profiled"] == profiled)
    starts = [a for a, _ in steps]
    out = []
    for i, s in enumerate(sp):
        if s["name"] != "step":
            continue
        j = bisect_right(starts, s["t"]) - 1
        if j >= 0 and s["t_end"] <= steps[j][1]:
            out.append(i)
    return out


def _under(sp, roots):
    """Each span's root among ``roots`` (a span index), or None."""
    root = [None] * len(sp)
    rs = set(roots)
    for i, s in enumerate(sp):
        if i in rs:
            root[i] = i
        elif s["parent"] is not None:
            root[i] = root[s["parent"]]
    return root


def engine_idle_pct(rec):
    """100 x (1 - executables' device seconds / ``step`` host seconds)
    over the window's unprofiled steps; None where the engine recorded no
    device span."""
    dev = [e for e in (rec.get("engine") or {}).get("events", [])
           if e["ph"] == "X"]
    if not dev:
        return None
    sp, _ = _host(rec)
    roots = _window_steps(rec, sp)
    if not roots:
        return None
    numbers = {sp[i]["args"]["step"] for i in roots}
    busy = sum(e["dur"] for e in dev if e["args"]["step"] in numbers) / 1e6
    host = sum(sp[i]["t_end"] - sp[i]["t"] for i in roots)
    return 100.0 * (1.0 - busy / host)


def host_self_ms(rec):
    """A ``step`` span less the ``wait`` spans inside it (the host not
    blocked on the device), mean over the window's unprofiled steps."""
    sp, _ = _host(rec)
    roots = _window_steps(rec, sp)
    if not roots:
        return None
    root = _under(sp, roots)
    waits = {i: 0.0 for i in roots}
    for s, r in zip(sp, root):
        if r is not None and s["name"] == "wait":
            waits[r] += s["t_end"] - s["t"]
    return 1e3 * statistics.fmean(sp[i]["t_end"] - sp[i]["t"] - waits[i]
                                  for i in roots)


def host_self_ms_by_span(rec):
    """Mean self ms a window step of ``step`` and of each span inside it
    (``replay`` and ``wait`` by what they run or wait on)."""
    sp, own = _host(rec)
    roots = _window_steps(rec, sp)
    if not roots:
        return None
    out = {}
    for s, r, x in zip(sp, _under(sp, roots), own):
        if r is not None:
            k = _label(s)
            out[k] = out.get(k, 0.0) + x
    return {k: 1e3 * v / len(roots) for k, v in sorted(out.items())}


def _label(s):
    a = s["args"]
    return s["name"] + (":" + str(a.get("exec", a.get("on")))
                        if "exec" in a or "on" in a else "")


def device_ms_by_exec(rec):
    """Mean device ms of a call of each executable kind (its CUDA event
    pair) in the window's unprofiled and profiled steps, with the calls
    counted: what the profiler adds to a replay."""
    dev = [e for e in (rec.get("engine") or {}).get("events", [])
           if e["ph"] == "X"]
    if not dev:
        return None
    sp, _ = _host(rec)
    out = {}
    for profiled in (False, True):
        numbers = {sp[i]["args"]["step"]
                   for i in _window_steps(rec, sp, profiled)}
        for e in dev:
            if e["args"]["step"] in numbers:
                d = out.setdefault(e["name"], {"unprofiled": [],
                                               "profiled": []})
                d["profiled" if profiled else "unprofiled"].append(
                    e["dur"] / 1e3)
    return {name: {k: (statistics.fmean(v) if v else None)
                   for k, v in d.items()}
            | {"calls": [len(d["unprofiled"]), len(d["profiled"])]}
            for name, d in sorted(out.items())}


def moe_choices(rec):
    """The window's routing counts (close less open), or None."""
    m = (rec.get("engine") or {}).get("moe")
    if not m or None in m:
        return None
    return {k: m[1][k] - m[0][k] for k in MOE_KEYS}


def expert_fill_pct(rec):
    c = moe_choices(rec)
    if not c or not c["capacity_rows"]:
        return None
    return 100.0 * c["kept"] / c["capacity_rows"]


# -- the traced sub-window, on the profiler's timeline ------------------------
def _on_trace(rec):
    """The profiled sub-window's device ops, runtime launches, mapped
    host spans and device spans (us since the trace's start), or None."""
    from perfbench import devtrace
    from repro_torch.obs import trace
    eng = rec.get("engine") or {}
    ev = eng.get("trace")
    if not ev:
        return None
    steps = [(s, e) for n, dev, s, e in ev if not dev and n == devtrace.STEP]
    if not steps:
        return None
    w0, w1 = min(s for s, _ in steps), max(e for _, e in steps)
    kern = sorted((s, e) for n, dev, s, e in ev
                  if dev and e > w0 and s < w1 and not devtrace._mark(n))

    def us(t):
        return (trace.profiler_ns(eng["anchors"], t)
                - eng["trace_start_ns"]) / 1e3

    sp, _ = _host(rec)
    host = [(us(s["t"]), us(s["t_end"]), s) for s in sp]
    host = [h for h in host if h[1] > w0 and h[0] < w1]
    t0 = eng["t0"]
    devs = [(us(t0 + e["ts"] / 1e6), e["dur"], e["name"])
            for e in eng["events"] if e["ph"] == "X"]
    devs = [(s, s + d, n) for s, d, n in devs if w0 <= s < w1]
    launches = sorted(s for n, dev, s, _e in ev
                      if not dev and n in LAUNCHES and w0 <= s < w1)
    return {"w": (w0, w1), "kernels": kern, "host": host, "device": devs,
            "launches": launches}


def idle_gaps_program(rec, top=10):
    """The sub-window's ``top`` longest device-idle gaps [label, s], each
    labelled by the innermost engine span open at its start."""
    from perfbench import devtrace
    tr = _on_trace(rec)
    if tr is None:
        return None
    w0, w1 = tr["w"]
    merged = devtrace.union([(max(s, w0), min(e, w1))
                             for s, e in tr["kernels"]])
    gaps, prev = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    gaps.sort(reverse=True)

    def label(t):
        inside = [h for h in tr["host"] if h[0] <= t < h[1]]
        return _label(inside[-1][2]) if inside else "outside the engine"

    return [[label(t), g / 1e6] for g, t in gaps[:top]]


def replay_vs_kernels(rec):
    """Per executable kind in the sub-window: its calls, the mean event
    span (ms), the mean union of the kernels inside it (ms), their mean
    difference (ms) and share of the span (%), and the median from the
    span's start to its first kernel (us)."""
    from perfbench import devtrace
    tr = _on_trace(rec)
    if tr is None or not tr["device"]:
        return None
    kern = tr["kernels"]
    starts = [s for s, _ in kern]
    by = {}
    for s, e, name in tr["device"]:
        lo, hi = bisect_right(starts, s - 50.0), bisect_right(starts, e)
        inside = devtrace.union([(max(a, s), min(b, e))
                                 for a, b in kern[max(lo - 1, 0):hi]
                                 if b > s and a < e])
        cov = sum(b - a for a, b in inside)
        first = inside[0][0] - s if inside else None
        by.setdefault(name, []).append((e - s, cov, first))
    out = {}
    for name, xs in by.items():
        span = sum(x[0] for x in xs)
        firsts = [x[2] for x in xs if x[2] is not None]
        out[name] = {
            "calls": len(xs), "event_ms": span / len(xs) / 1e3,
            "kernel_union_ms": sum(x[1] for x in xs) / len(xs) / 1e3,
            "gap_ms": (span - sum(x[1] for x in xs)) / len(xs) / 1e3,
            "gap_pct": 100.0 * (1 - sum(x[1] for x in xs) / span),
            "first_kernel_us_median": (statistics.median(firsts)
                                       if firsts else None)}
    return out


def anchors(rec):
    """The anchored mapping checked in the sub-window: of the sampled
    ``replay`` spans, those holding the next launch the profiler recorded
    after their start, and of those the ones whose start lies before the
    first kernel after that launch; the median and largest time from a
    span's start to its launch (us); and the clocks' drift between the
    profiler's start and stop (us: profiler ns less host ns)."""
    eng = rec.get("engine") or {}
    pts = sorted(eng.get("anchors", []))
    drift = None
    if len(pts) >= 3:
        (p0, w0), (p1, w1) = pts[-2], pts[-1]
        drift = (w1 - w0) / 1e3 - (p1 - p0) * 1e6
    tr = _on_trace(rec)
    if tr is None:
        return {"drift_us": drift}
    starts = [s for s, _ in tr["kernels"]]
    reps = [h for h in tr["host"] if h[2]["name"] == "replay"]
    held, before, offs = 0, 0, []
    for s, e, _sp in reps:
        i = bisect_right(tr["launches"], s)
        if i == len(tr["launches"]) or tr["launches"][i] >= e:
            continue
        launch = tr["launches"][i]
        held += 1
        offs.append(launch - s)
        k = bisect_right(starts, launch)
        before += k < len(starts) and s <= starts[k]
    return {"replay_spans": len(reps), "holding_a_launch": held,
            "start_before_first_kernel": before,
            "launch_offset_us_median": (statistics.median(offs)
                                        if offs else None),
            "launch_offset_us_max": max(offs) if offs else None,
            "drift_us": drift}


NEW_METRICS = {"engine_idle_pct": ("%", engine_idle_pct),
               "host_self_ms": ("ms", host_self_ms),
               "expert_fill_pct": ("%", expert_fill_pct)}
NEW_INFO = {"idle_gaps_program": idle_gaps_program,
            "host_self_ms_by_span": host_self_ms_by_span,
            "moe_choices": moe_choices,
            "device_ms_by_exec": device_ms_by_exec,
            "replay_vs_kernels": replay_vs_kernels, "anchors": anchors}


# -- the run ------------------------------------------------------------------
def run(root, workload, seed, seconds, trace, t_start, observer="traced",
        judge=True, device="cuda", chips_check=True):
    """``bench.run_cell`` with the engine's observer traced (or not).
    Returns (result line, info, the window's record)."""
    import torch

    from perfbench import bench, observe
    from perfbench.reference import check
    from repro_torch.obs.runtime import Observer

    recs = []

    class Obs(observe.BenchObserver):
        def __init__(self, inner, requests, events=False):
            if observer == "traced":
                inner = Observer(trace=True)
            super().__init__(inner, requests, events)

    class Anchored(torch.profiler.profile):
        """The harness's profiler, anchoring the tracer at its start and
        its stop."""

        def __init__(self, tracer, **kw):
            super().__init__(**kw)
            self.tracer = tracer

        def start(self):
            super().start()
            if self.tracer is not None:
                self.tracer.anchor()

        def stop(self):
            if self.tracer is not None:
                self.tracer.anchor()
            super().stop()

    class Win(bench.Window):
        moe_open = moe_close = None

        def _profiler(self):
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            return Anchored(self.obs.inner.tracer, activities=acts)

        def _warm(self, now, t0):
            warm = super()._warm(now, t0)
            if warm and self.moe_open is None:
                self.moe_open = self.obs.inner.routing() or None
            return warm

        def _sync(self):
            super()._sync()
            # the window's close: the harness syncs there before the
            # profiler stops, and after the run's loop
            if getattr(self, "i_close", None) is not None \
                    and self.moe_close is None:
                self.moe_close = self.obs.inner.routing() or None

        def record(self):
            rec = super().record()
            tracer = self.obs.inner.tracer
            if tracer is not None:
                from perfbench import devtrace
                eng = {"events": list(tracer.events), "t0": tracer.t0,
                       "anchors": list(tracer.anchors),
                       "moe": [self.moe_open, self.moe_close]}
                if self.prof is not None:
                    eng["trace"] = devtrace.trace_events(self.prof)
                    eng["trace_start_ns"] = \
                        self.prof.profiler.kineto_results.trace_start_ns()
                rec["engine"] = eng
            recs.append(rec)
            return rec

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(observe, "BenchObserver", Obs))
        stack.enter_context(mock.patch.object(bench, "Window", Win))
        if not judge:
            stack.enter_context(mock.patch.object(
                check, "judge",
                lambda *a, **k: {"checks": {}, "sample": None}))
        line, info = bench.run_cell(root, workload, seed, seconds, trace,
                                    t_start, device=device,
                                    chips_check=chips_check)
    rec = recs[0]
    if not judge:
        line["correct"] = None
    info["observer"] = observer
    if trace:
        suffix = "batch" if rec["loop"] == "backlog" else "rate"
        for name, (unit, read) in NEW_METRICS.items():
            v = read(rec)
            if v is not None:
                line["metrics"][f"{name}.{suffix}"] = {"value": v,
                                                       "unit": unit}
        for name, read in NEW_INFO.items():
            info[name] = read(rec)
    return line, info, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--observer", choices=("traced", "null"),
                    default="traced")
    ap.add_argument("--judge", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench import run as runner
    runner._paths()
    import torch
    torch.set_num_threads(4)
    line, info, _ = run(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), T_START, args.observer,
                        bool(args.judge))
    print(json.dumps(runner.finite(info)), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(runner.finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
