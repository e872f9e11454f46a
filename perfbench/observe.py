"""The benchmark's observer: wraps the engine's observer seam
(``ServingEngine(observer=)``), as ``chip_smoke._PhaseClock`` does, and
records what the window's metrics and the reference need, from outside
the program.

Per engine step it keeps (host clock, ``time.perf_counter``):

- the step's plan, read through a wrapper of the scheduler's ``plan``
  (chunks as (slot, start, n), the decode slots);
- the ``decode`` phase's span, which ends in the step's one
  device-to-host sync, with the slots' tokens and ``cache_len`` as they
  were staged (read from the engine when the phase opens);
- for each ``prefill_chunk`` phase, the chunk's tokens (pads as zeros,
  so the reference can run the program's steps again) and, when
  ``events`` is on, a CUDA event pair around it, read after the window
  (the phase itself only enqueues the chunk's work).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np


class StepLog:
    """What the observer saw of one engine step."""
    __slots__ = ("t0", "t1", "chunks", "decode_slots", "decode_span",
                 "tokens", "cache_len", "emit", "events",
                 "profiled", "chunk_rows")

    def __init__(self, t0):
        self.t0, self.t1 = t0, None
        self.chunks, self.decode_slots = [], []
        self.decode_span = None
        self.tokens = self.cache_len = None
        self.emit = []          # (slot, rid, index of the token emitted)
        self.events = []        # one CUDA event pair a chunk
        self.profiled = False
        self.chunk_rows = []    # one token row a chunk, pads as zeros


class BenchObserver:
    def __init__(self, inner, requests: dict, events: bool = False):
        self.inner = inner
        self.requests = requests          # rid -> Request
        self.events = events
        self.engine = None
        self.steps: list[StepLog] = []
        self.cur: StepLog | None = None
        self._plan = None
        # while a profiler records: name -> a context manager that marks
        # the host span on its timeline (``torch.profiler.record_function``)
        self.label = None

    def attach(self, engine) -> None:
        """Bind to ``engine``: its scheduler's plans pass through here."""
        self.engine = engine
        plan = engine.sched.plan

        def recording_plan():
            p = plan()
            self._plan = p
            return p

        engine.sched.plan = recording_plan

    # -- the harness's step bracket --------------------------------------------
    def begin_step(self) -> StepLog:
        self.cur = StepLog(time.perf_counter())
        return self.cur

    def end_step(self) -> StepLog:
        st = self.cur
        st.t1 = time.perf_counter()
        p = self._plan
        if p is not None:
            st.chunks = [(c.slot, c.start, c.n) for c in p.chunks]
            st.decode_slots = list(p.decode_slots)
        self._plan = None
        self.steps.append(st)
        self.cur = None
        return st

    # -- the engine's seam ------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name, **args):
        st, eng = self.cur, self.engine
        ev = None
        if name == "decode" and st is not None:
            st.tokens = eng.last_token.copy()
            st.cache_len = eng.cache_len.copy()
            st.emit = [(s, eng.sched.slots[s].req.rid,
                        len(eng.sched.slots[s].req.out))
                       for s in self._plan.decode_slots]
        if name == "prefill_chunk" and st is not None:
            req = self.requests[args["rid"]]
            row = np.zeros(eng.chunk, np.int64)
            row[:args["n"]] = req.tokens[args["start"]:
                                         args["start"] + args["n"]]
            st.chunk_rows.append(row)
            if self.events:
                import torch
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
        t = time.perf_counter()
        mark = self.label(name) if self.label else contextlib.nullcontext()
        with mark, self.inner.phase(name, **args):
            yield
        span = (t, time.perf_counter())
        if st is None:
            return
        if name == "decode":
            st.decode_span = span
        elif ev is not None:
            ev[1].record()
            st.events.append(ev)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def replay_steps(log: list[StepLog]) -> list[dict]:
    """The engine's steps as the reference's ``replay`` takes them: per
    step its chunk, then its decode over every slot row."""
    out = []
    for st in log:
        for (slot, start, _n), row in zip(st.chunks, st.chunk_rows):
            out.append({"kind": "chunk", "slot": slot, "start": start,
                        "tokens": row})
        if st.tokens is not None:
            out.append({"kind": "decode", "tokens": st.tokens.astype(np.int64),
                        "cache_len": st.cache_len.astype(np.int64),
                        "emit": st.emit})
    return out
