"""Structured step tracing: one event per engine step phase, exported as
Chrome/Perfetto ``trace_event`` JSON.

The tracer records what the scheduler/runtime split actually *does* each
step — admit, prefill-chunk, decode, verify, preempt, retire, and the
allocator's page grow/shrink/publish/evict — each event carrying its
slot / request-id / step attribution in ``args``.  Phases and the spans
inside a step are duration pairs (``ph: "B"`` / ``"E"``) on the host
track (``tid`` 0), bookkeeping moments are instants (``ph: "i"``), the
executables' device time is complete events (``ph: "X"``) on the device
track (``tid`` 1), and the export is the ``{"traceEvents": [...]}`` JSON
object both ``chrome://tracing`` and https://ui.perfetto.dev load
directly.

This module also owns the repo's **clock sources**: :func:`now` is the
only ``time.perf_counter`` call site the serving stack uses.
``Request.t_submit`` / ``t_first`` / ``t_done`` and every trace timestamp
come from this one clock, so TTFT/TPOT computed from request marks, trace
durations, and benchmark timings can never disagree about what "a
millisecond" was.  :func:`profiler_clock_ns` is the second and last call
site: the clock ``torch.profiler`` stamps its events with, read only to
anchor :func:`now` onto it (:meth:`Tracer.anchor`,
:meth:`Tracer.profiler_ns`), so a span lands on a device trace's timeline.

Host-pure by contract (lint rule RA004 of ``repro_torch.analysis.lint``:
no torch or jax import): recording an event is a dict append — no numpy,
no torch, no jax, no device syncs.  The buffer is bounded
(``limit``); overflow drops *new* events and counts them in
``dropped`` rather than growing without bound under a long run.
"""
from __future__ import annotations

import json
import time

HOST, DEVICE = 0, 1     # the trace's tracks (``tid``)


def now() -> float:
    """The serving stack's one monotonic clock (seconds, float).

    Every wall-clock mark — request TTFT/TPOT fields, trace event
    timestamps, benchmark timing loops — reads this function, so there
    is exactly one ``time.perf_counter`` call site to reason about.
    """
    return time.perf_counter()


def profiler_clock_ns() -> int:
    """The clock ``torch.profiler`` stamps its events with (kineto's:
    the wall clock, ``time.time_ns``, in the installed torch), in ns.
    Read only by :meth:`Tracer.anchor`."""
    return time.time_ns()


class Tracer:
    """Bounded in-memory trace_event recorder.

    Events use the Trace Event Format's JSON array flavour: ``ts`` is
    microseconds relative to tracer construction, ``pid`` is always 0,
    and ``tid`` is :data:`HOST` for the host's phases and spans (engine
    phases are sequential on the host thread, so B/E pairs nest
    trivially) and :data:`DEVICE` for executables' device time.

    ``anchors`` pairs the two clocks: (:func:`now`, the profiler's clock
    in ns), one at construction and one a call of :meth:`anchor`.
    """

    def __init__(self, limit: int = 200_000):
        self.t0 = now()
        self.limit = limit
        self.events: list = []
        self.dropped = 0
        self._open = 0     # currently-open B events (for balance checks)
        self.anchors: list = []
        self.anchor()

    def _ts(self) -> float:
        return (now() - self.t0) * 1e6

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.limit:
            self.dropped += 1
            return
        self.events.append(ev)

    def begin(self, name: str, **args) -> None:
        """Open a duration event (phase start)."""
        self._open += 1
        self._duration(name, "B", args)

    def end(self, name: str, **args) -> None:
        """Close the most recent open duration event of ``name``."""
        self._open -= 1
        self._duration(name, "E", args)

    def span(self, name: str, **args) -> "_Span":
        """A duration event around a ``with`` block."""
        return _Span(self, name, args)

    def _duration(self, name: str, ph: str, args: dict) -> None:
        self._emit({"name": name, "ph": ph, "ts": self._ts(),
                    "pid": 0, "tid": HOST, "args": args})

    def complete(self, name: str, t: float, seconds: float,
                 **args) -> None:
        """A duration on the device track, known after the fact: it
        started at ``t`` (:func:`now`'s clock) and lasted ``seconds``."""
        self._emit({"name": name, "ph": "X", "ts": (t - self.t0) * 1e6,
                    "dur": seconds * 1e6, "pid": 0, "tid": DEVICE,
                    "args": args})

    def instant(self, name: str, **args) -> None:
        """A zero-duration bookkeeping moment (admit, retire, page op)."""
        self._emit({"name": name, "ph": "i", "ts": self._ts(),
                    "pid": 0, "tid": HOST, "s": "t", "args": args})

    def anchor(self) -> tuple:
        """Record and return one (:func:`now`, profiler clock ns) pair,
        the profiler's clock read between two reads of :func:`now`."""
        a = now()
        wall = profiler_clock_ns()
        pair = ((a + now()) / 2, wall)
        self.anchors.append(pair)
        return pair

    def profiler_ns(self, ts: float) -> float:
        """An event's ``ts`` (us since construction) on the profiler's
        clock (ns), through :attr:`anchors` (:func:`profiler_ns`)."""
        return profiler_ns(self.anchors, self.t0 + ts / 1e6)

    @property
    def balanced(self) -> bool:
        """True when every begun phase has been ended."""
        return self._open == 0

    def to_json(self) -> dict:
        """The Chrome/Perfetto trace object (JSON-serialisable)."""
        meta = {"clock": "time.perf_counter", "t0": self.t0,
                "dropped": self.dropped,
                "profiler_clock": "time.time_ns",
                "anchors": [list(a) for a in self.anchors]}
        names = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                  "args": {"name": name}}
                 for tid, name in ((HOST, "host"),
                                   (DEVICE, "device (CUDA events)"))]
        return {"traceEvents": names + list(self.events),
                "displayTimeUnit": "ms",
                "otherData": meta}

    def write(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f)


class _Span:
    """:meth:`Tracer.span`'s context manager (a class: cheaper to enter
    than a generator's)."""
    __slots__ = ("tracer", "name", "args")

    def __init__(self, tracer: Tracer, name: str, args: dict):
        self.tracer, self.name, self.args = tracer, name, args

    def __enter__(self):
        self.tracer._open += 1
        self.tracer._duration(self.name, "B", self.args)

    def __exit__(self, *exc):
        self.tracer._open -= 1
        self.tracer._duration(self.name, "E", {})


def profiler_ns(anchors: list, t: float) -> float:
    """``t`` (:func:`now`'s clock, s) on the profiler's clock (ns), given
    (now, profiler ns) ``anchors``: linear between the two anchors around
    it (beyond the first or last, along the nearest two), so the clocks'
    drift between anchors is taken out."""
    pts = sorted(anchors)
    if len(pts) == 1:
        return pts[0][1] + (t - pts[0][0]) * 1e9
    i = 0
    while i < len(pts) - 2 and t > pts[i + 1][0]:
        i += 1
    (p0, w0), (p1, w1) = pts[i], pts[i + 1]
    return w0 + (t - p0) * (w1 - w0) / (p1 - p0)


def spans(events: list) -> list:
    """The host track's closed spans, in the order they opened: dicts of
    ``name``, ``ts`` and ``end`` (us), ``args`` and ``parent`` (the
    index of the span open around it, or None).  A span still open at
    the end of ``events`` is left out."""
    out, stack = [], []
    for ev in events:
        if ev.get("tid", HOST) != HOST:
            continue
        if ev["ph"] == "B":
            out.append({"name": ev["name"], "ts": ev["ts"], "end": None,
                        "args": ev["args"],
                        "parent": stack[-1] if stack else None})
            stack.append(len(out) - 1)
        elif ev["ph"] == "E" and stack:
            out[stack.pop()]["end"] = ev["ts"]
    keep = [i for i, s in enumerate(out) if s["end"] is not None]
    index = {i: k for k, i in enumerate(keep)}
    return [dict(out[i], parent=index.get(out[i]["parent"])) for i in keep]


def self_times(sp: list) -> list:
    """Each span's self time (us): its duration less what its direct
    children cover (children on one thread do not overlap)."""
    own = [s["end"] - s["ts"] for s in sp]
    for s in sp:
        if s["parent"] is not None:
            own[s["parent"]] -= s["end"] - s["ts"]
    return own
