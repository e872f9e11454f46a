"""Structured step tracing: one event per engine step phase, exported as
Chrome/Perfetto ``trace_event`` JSON.

The tracer records what the scheduler/runtime split actually *does* each
step — admit, prefill-chunk, decode, verify, preempt, retire, and the
allocator's page grow/shrink/publish/evict — each event carrying its
slot / request-id / step attribution in ``args``.  Phases are duration
pairs (``ph: "B"`` / ``"E"``), bookkeeping moments are instants
(``ph: "i"``), and the export is the ``{"traceEvents": [...]}`` JSON
object both ``chrome://tracing`` and https://ui.perfetto.dev load
directly.

This module also owns the repo's **single monotonic clock source**:
:func:`now` is the only ``time.perf_counter`` call site the serving
stack uses.  ``Request.t_submit`` / ``t_first`` / ``t_done`` and every
trace timestamp come from this one clock, so TTFT/TPOT computed from
request marks, trace durations, and benchmark timings can never disagree
about what "a millisecond" was.

Host-pure by contract (lint rule RA004): recording an event is a dict
append — no numpy, no jax, no device syncs.  The buffer is bounded
(``limit``); overflow drops *new* events and counts them in
``dropped`` rather than growing without bound under a long run.
"""
from __future__ import annotations

import json
import time


def now() -> float:
    """The serving stack's one monotonic clock (seconds, float).

    Every wall-clock mark — request TTFT/TPOT fields, trace event
    timestamps, benchmark timing loops — reads this function, so there
    is exactly one ``time.perf_counter`` call site to reason about.
    """
    return time.perf_counter()


class Tracer:
    """Bounded in-memory trace_event recorder.

    Events use the Trace Event Format's JSON array flavour: ``ts`` is
    microseconds relative to tracer construction, ``pid`` is always 0,
    and ``tid`` defaults to 0 (engine phases are sequential on the host
    thread, so B/E pairs nest trivially).
    """

    def __init__(self, limit: int = 200_000):
        self.t0 = now()
        self.limit = limit
        self.events: list = []
        self.dropped = 0
        self._open = 0     # currently-open B events (for balance checks)

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
        self._emit({"name": name, "ph": "B", "ts": self._ts(),
                    "pid": 0, "tid": 0, "args": args})

    def end(self, name: str, **args) -> None:
        """Close the most recent open duration event of ``name``."""
        self._open -= 1
        self._emit({"name": name, "ph": "E", "ts": self._ts(),
                    "pid": 0, "tid": 0, "args": args})

    def instant(self, name: str, **args) -> None:
        """A zero-duration bookkeeping moment (admit, retire, page op)."""
        self._emit({"name": name, "ph": "i", "ts": self._ts(),
                    "pid": 0, "tid": 0, "s": "t", "args": args})

    @property
    def balanced(self) -> bool:
        """True when every begun phase has been ended."""
        return self._open == 0

    def to_json(self) -> dict:
        """The Chrome/Perfetto trace object (JSON-serialisable)."""
        meta = {"clock": "time.perf_counter", "t0": self.t0,
                "dropped": self.dropped}
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": meta}

    def write(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f)
