"""The serving engine's executables: its step functions as CUDA graphs.

The JAX engine jits its hot paths and counts the executables it compiled
(``repro.serve.engine``, ``compilations``).  The port's executable is a
CUDA graph.  An :class:`Executable` holds one step function, which reads
only static input buffers (:class:`StaticInput`), and on a CUDA device one
captured graph per static key, as JAX keeps one executable per static
shape and static argument:

* the first call for a key runs the function eagerly.  That run is the
  real step, and it is also the warm-up: it builds the kernel library,
  cuBLAS's workspaces and the kernels' ``lru_cache``\\ d launch plans, none
  of which a capture may do for the first time;
* the second call captures the function on a side stream, into the memory
  pool of its :class:`GraphPool` (an engine gives its steps and samplers
  one pool, its prefill chunk and ``clear_slot`` another), then replays
  it.  A capture executes nothing, so no step runs twice and no
  K/V row or recurrent state is written twice;
* every later call only replays, and returns the same output tensors.

Warm-up and capture run under ``torch.cuda.set_sync_debug_mode("error")``
(:func:`no_host_sync`): a device->host copy inside a step, whose value a
graph would freeze, raises there.  A capture or replay that fails raises;
nothing falls back to eager.  A pool whose steps cannot be captured at all
(``GraphPool.blocker``: a mesh's collectives over a gloo group — the
"model" sums, the layout's gathers of sharded leaves, the logits gathers
over "model" and over the replica groups — which stage through the host)
raises at its first call with capture enabled; over NCCL they are
captured in the step like any kernel.  :func:`disable_capture` is the one switch to
the eager path, the counterpart of ``jax.disable_jit()``; on the CPU
nothing is captured.

The kernel wrappers count their launches in Python, which a replay does
not run: the counts a capture made are taken out of ``lib.STATS`` and added
back on every replay, so the counters read the same with graphs as
without.
"""
from __future__ import annotations

import contextlib
import contextvars
import gc
import time
from typing import Callable, Hashable

import numpy as np
import torch

from repro_torch.kernels import lib
from repro_torch.obs.trace import now

_CAPTURE = contextvars.ContextVar("repro_torch_graph_capture", default=True)


@contextlib.contextmanager
def disable_capture():
    """Run every :class:`Executable` eagerly inside the block."""
    token = _CAPTURE.set(False)
    try:
        yield
    finally:
        _CAPTURE.reset(token)


def capture_enabled(device) -> bool:
    """Whether step functions on ``device`` run as graphs: on a CUDA device
    outside :func:`disable_capture`."""
    return torch.device(device).type == "cuda" and _CAPTURE.get()


@contextlib.contextmanager
def no_host_sync(device):
    """Raise on any device->host synchronisation inside the block (CUDA;
    nothing elsewhere)."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class StaticInput:
    """A step's input at a fixed device address, fed from pinned host
    copies with ``non_blocking=True``.  ``depth`` host copies take turns,
    so the host may stage up to ``depth`` values ahead of the device (the
    prefill chunks of one step: each is staged after the previous chunk's
    replay was enqueued, and its transfer waits behind that replay).  The
    device copy is ordered on the stream, so a replay always reads the
    value staged just before it.  Before a host copy is overwritten, its
    previous transfer's event is waited on: ``stalls`` counts the waits
    that found it still pending and ``stall_s`` their host seconds, and
    ``wait()`` (a context manager factory: the engine's ``wait`` span) is
    open around each such wait."""

    def __init__(self, shape, dtype, device, depth: int = 1,
                 wait=contextlib.nullcontext):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.tensor = torch.zeros(shape, dtype=dtype, device=self.device)
        self._hosts = [torch.zeros(shape, dtype=dtype, pin_memory=cuda)
                       for _ in range(depth)]
        self._copied = [torch.cuda.Event() if cuda else None
                        for _ in range(depth)]
        self._pending = [False] * depth
        self._next = 0
        self.stalls = 0
        self.stall_s = 0.0
        self.wait = wait

    def put(self, values) -> torch.Tensor:
        i = self._next
        self._next = (i + 1) % len(self._hosts)
        if self._pending[i] and not self._copied[i].query():
            t0 = time.perf_counter()
            with self.wait():
                self._copied[i].synchronize()
            self.stalls += 1
            self.stall_s += time.perf_counter() - t0
        self._hosts[i].numpy()[...] = np.asarray(values)
        self.tensor.copy_(self._hosts[i], non_blocking=True)
        if self._copied[i] is not None:
            self._copied[i].record(torch.cuda.current_stream(self.device))
            self._pending[i] = True
        return self.tensor


class ExecTimer:
    """Device time of executable calls: a CUDA event pair around each
    (:meth:`start`, :meth:`stop`), read only after a host sync the caller
    already makes (:meth:`synced`), and handed to ``observer.device_span``
    on the host clock.  An anchor event recorded just after each sync,
    when the stream is idle, ties the device's clock to the host's: a pair
    recorded after it starts at the anchor's host time plus the time
    between the two events.  The first anchor is taken at the first call,
    before any sync, and sits early by whatever the device still had
    queued then.  Events around a replay count the gaps between the
    graph's kernels as busy.  Read events go back to a free list, so a
    step creates none once warm."""

    def __init__(self, device, observer):
        self.device = torch.device(device)
        self.obs = observer
        self._anchor = None     # (event, host seconds)
        self._pairs: list = []  # (name, step, start, end) since the anchor
        self._free: list = []

    def _record(self) -> torch.cuda.Event:
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def start(self) -> torch.cuda.Event:
        """Record a call's start (and, before the first sync, the first
        anchor)."""
        if self._anchor is None:
            self._anchor = (self._record(), now())
        return self._record()

    def stop(self, name: str, step: int, start: torch.cuda.Event) -> None:
        self._pairs.append((name, step, start, self._record()))

    def synced(self) -> None:
        """Right after a host sync: read every pair, then anchor anew."""
        if self._anchor is not None:
            anchor, t = self._anchor
            for name, step, start, end in self._pairs:
                self.obs.device_span(
                    name, t + anchor.elapsed_time(start) / 1e3,
                    start.elapsed_time(end) / 1e3, step=step)
                self._free += (start, end)
            self._pairs.clear()
            self._free.append(anchor)
        self._anchor = (self._record(), now())


class GraphPool:
    """The memory pool and capture stream that one engine's graphs share,
    with what their captures cost: ``bytes`` of device memory reserved
    during captures and ``capture_s`` seconds of host time."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.handle = None
        self.stream = None
        self.bytes = 0
        self.capture_s = 0.0
        self.blocker: str | None = None   # why no step here can be captured

    def ensure(self) -> None:
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)


def capture(fn: Callable, pool: GraphPool):
    """Capture ``fn()`` into a new CUDA graph in ``pool``.  Returns (graph,
    outputs): ``graph.replay()`` runs the step again and rewrites
    ``outputs`` in place.

    Unreachable objects are collected first: an engine dropped earlier
    sits in a reference cycle, and if the collector freed its graphs in
    the middle of this capture, their teardown would end the capture.
    Calls from other threads (the profiler's) are not held against it
    (``capture_error_mode="thread_local"``)."""
    pool.ensure()
    gc.collect()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool.handle, stream=pool.stream,
                          capture_error_mode="thread_local"):
        reserved = torch.cuda.memory_reserved(pool.device)
        with no_host_sync(pool.device):
            out = fn()
    pool.bytes += torch.cuda.memory_reserved(pool.device) - reserved
    return graph, out


class Executable:
    """One step function ``fn(key)`` over static input buffers, as one
    CUDA graph per static key (see the module docstring).  ``outputs[key]``
    is the key's last result: on a replay, the graph's own output
    tensors."""

    def __init__(self, fn: Callable, pool: GraphPool):
        self.fn = fn
        self.pool = pool
        self.outputs: dict = {}
        self.replays = 0
        self._warm: set = set()
        self._graphs: dict = {}     # key -> (graph, outputs, counts)

    @property
    def graph_keys(self) -> list:
        """The keys captured so far, in capture order."""
        return list(self._graphs)

    @property
    def keys(self) -> list:
        """Every key called so far, captured or not, in first-call
        order."""
        return list(self.outputs)

    def __call__(self, key: Hashable):
        if not capture_enabled(self.pool.device):
            out = self.outputs[key] = self.fn(key)
            return out
        if key not in self._graphs:
            if self.pool.blocker:
                raise RuntimeError(self.pool.blocker)
            if key not in self._warm:
                with no_host_sync(self.pool.device):
                    out = self.fn(key)
                self._warm.add(key)
                self.outputs[key] = out
                return out
            self._capture(key)
        graph, out, counts = self._graphs[key]
        graph.replay()
        lib.STATS.add(counts)
        self.replays += 1
        self.outputs[key] = out
        return out

    def _capture(self, key: Hashable) -> None:
        t0 = time.perf_counter()
        before = lib.STATS.snapshot()
        try:
            graph, out = capture(lambda: self.fn(key), self.pool)
        finally:
            counts = lib.STATS.take_since(before)
        self.pool.capture_s += time.perf_counter() - t0
        self._graphs[key] = (graph, out, counts)
