"""Retrace guard: fail when a steady-state region compiles anything new
(a copy of ``repro.analysis.retrace_guard``; it never imported JAX).

The serving engine's design is that after warm-up the hot loop runs a
fixed set of executables for *any* request mix; in the port an executable
is a captured CUDA graph (``repro_torch.serve.graphs``).  This context
manager snapshots a compilation census on entry and raises
:class:`RetraceError` on exit if anything grew — **a warm region must not
capture**:

    with retrace_guard(engine):          # engine already warmed
        engine.run(requests)             # steady-state: zero new captures

Any subject with a ``compilations`` attribute works: the engine (census
dict), :class:`repro_torch.core.flexible.FlexibleAttention` (int counter:
its captured padded programs), or a zero-arg callable returning either.  An
:class:`repro_torch.obs.runtime.Observer` (which exports the engine census
through its ``census()`` method) and a flat metrics-registry snapshot
(``Observer.snapshot()`` — the ``repro_engine_compilations{exec="..."}``
gauges are extracted) are also accepted, so a guard can read the census
through the observability seam instead of holding an engine reference.
``allow=`` admits a known number of deliberate compilations (e.g. a
first-use cold path inside an otherwise warm region).
"""
from __future__ import annotations

import contextlib
import re

# Observer.snapshot() key for one compilation gauge, e.g.
#   repro_engine_compilations{exec="decode"}
_SNAPSHOT_KEY = re.compile(r'^repro_engine_compilations\{exec="([^"]*)"\}$')


class RetraceError(AssertionError):
    """A guarded steady-state region compiled new executables."""


def _from_snapshot(snap: dict) -> dict | None:
    """Extract the compilation gauges from a flat metrics snapshot
    (``{'name{labels}': value}``); None when the dict is not one."""
    out = {}
    for key, value in snap.items():
        if not isinstance(key, str):
            return None
        m = _SNAPSHOT_KEY.match(key)
        if m:
            out[m.group(1)] = int(value)
    return out if out else None


def census(subject) -> dict:
    """Normalise a subject's compilation census to ``{key: count}``."""
    c = getattr(subject, "compilations", None)
    if c is None:
        # an Observer: its census() refreshes + returns the engine census
        cm = getattr(subject, "census", None)
        if callable(cm) and not isinstance(subject, dict):
            c = cm()
        elif isinstance(subject, dict):
            # a flat registry snapshot (Observer.snapshot()) — pull the
            # repro_engine_compilations{exec=...} gauges out of it.  A
            # snapshot with no census gauges registered is an empty census,
            # not a {exec: count} dict of unrelated metric samples.
            c = _from_snapshot(subject)
            if c is None:
                snapshot_like = any(isinstance(k, str) and "{" in k
                                    for k in subject)
                c = {} if snapshot_like else dict(subject)
        elif callable(subject):
            c = subject()
    if callable(c):
        c = c()
    if isinstance(c, dict):
        extracted = _from_snapshot(c)
        if extracted is not None:
            c = extracted
        return {str(k): int(v) for k, v in c.items()}
    if isinstance(c, (int, float)):
        return {"compilations": int(c)}
    raise TypeError(
        f"retrace_guard subject {subject!r} has no usable `compilations` "
        f"census (need an int, a dict, an Observer, a registry snapshot, "
        f"or a callable returning one)")


@contextlib.contextmanager
def retrace_guard(*subjects, allow: int = 0, label: str = ""):
    """Assert that no subject compiles more than ``allow`` new
    executables (total, across all subjects) inside the ``with`` body."""
    if not subjects:
        raise ValueError("retrace_guard needs at least one subject")
    before = [census(s) for s in subjects]
    yield
    grew = []
    total = 0
    for s, b in zip(subjects, before):
        a = census(s)
        for key in sorted(set(a) | set(b)):
            delta = a.get(key, 0) - b.get(key, 0)
            if delta > 0:
                total += delta
                grew.append(f"{type(s).__name__}.{key}: "
                            f"{b.get(key, 0)} -> {a.get(key, 0)}")
    if total > allow:
        where = f" [{label}]" if label else ""
        raise RetraceError(
            f"steady-state region{where} compiled {total} new "
            f"executable(s) (allow={allow}):\n  " + "\n  ".join(grew))
