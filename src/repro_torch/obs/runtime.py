"""The Observer: one injectable object the whole serving stack reports to.

FAMOUS's evaluation is per-module accounting — latency and GOPS per
attention module, tile-level utilisation — and the serving analogue is a
single seam that surfaces what each layer of the engine is doing:

  * **Runtime** (``ServingEngine``): step phases (prefill-chunk / decode /
    verify) as trace spans + duration histograms, TTFT/TPOT per retired
    request, speculation drafted/accepted, the executable census.
  * **Scheduler**: admissions, queue depth, prefill/decode token counts,
    preemptions.
  * **PageAllocator**: page grow/shrink/free/publish/evict, pool
    utilisation, prefix-cache hits/misses and pages saved.
  * **Drafter** (``PromptLookupDrafter``): lookup hit rate and proposed
    token volume.

Everything is *host-side and pull-based*: hooks take plain python ints
already on the host (the engine's one device→host sync per decode step is
unchanged), counters are dict adds, and reading happens only when someone
calls :meth:`Observer.snapshot` / :meth:`prometheus_text` /
:meth:`trace_json`.  The module is contractually jax-free (lint rule
RA004) so observability can never introduce a device sync.  Measured
overhead of an enabled Observer is ≤2% tok/s on the serving benchmark's
``obs_on`` / ``obs_off`` row pair (gated at 5% in CI; see
docs/observability.md for the catalog and the contract).

``observer=None`` (every constructor's default) resolves to
:data:`NULL_OBSERVER`, whose hooks are empty methods — the off state
costs one no-op call per event.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, now

# engine step phases the tracer records (docs/observability.md schema)
PHASES = ("prefill_chunk", "decode", "verify")


class Observer:
    """Metrics + (optional) tracing over one serving engine.

    Construct with ``trace=True`` to also record per-phase trace events;
    metrics are always collected.  One Observer belongs to one engine —
    the census registration and step attribution are per-engine state.
    """

    def __init__(self, trace: bool = False, trace_limit: int = 200_000):
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(limit=trace_limit) if trace else None
        self.step = 0                       # engine step, for attribution
        self._census_source = None
        m = self.metrics
        # -- request lifecycle ----------------------------------------------
        self._enqueued = m.counter(
            "repro_requests_enqueued_total", "requests entering the queues")
        self._admitted = m.counter(
            "repro_requests_admitted_total", "requests bound to a slot")
        self._retired = m.counter(
            "repro_requests_retired_total",
            "requests leaving the engine", ("status",))
        self._ttft = m.histogram(
            "repro_request_ttft_seconds",
            "time from submit to first emitted token")
        self._tpot = m.histogram(
            "repro_request_tpot_seconds",
            "mean per-token time after the first token, per request")
        # -- engine step ----------------------------------------------------
        self._steps = m.counter("repro_engine_steps_total",
                                "scheduler plans executed")
        self._phase_s = m.histogram(
            "repro_step_phase_seconds",
            "host-observed duration of one engine step phase", ("phase",))
        self._queue_depth = m.gauge(
            "repro_queue_depth", "queued requests (pending + resume)")
        self._slots_occ = m.gauge(
            "repro_slots_occupied", "slots holding a request")
        self._tokens = m.counter("repro_tokens_generated_total",
                                 "decode/verify tokens emitted")
        self._prefill_tokens = m.counter(
            "repro_prefill_tokens_total", "prompt tokens prefilled (chunked)")
        self._preempts = m.counter("repro_preemptions_total",
                                   "sequences evicted for re-admission")
        # -- paged pool / prefix cache --------------------------------------
        self._pages = m.counter(
            "repro_pages_total", "page-allocator operations, in pages "
            "(publish counts blocks; evict counts index evictions)", ("op",))
        self._pages_free = m.gauge(
            "repro_pages_free", "allocatable pages (incl. cached-free)")
        self._pages_cached = m.gauge(
            "repro_pages_cached_free", "warm refcount-0 pages on the LRU")
        self._prefix = m.counter(
            "repro_prefix_lookups_total",
            "prefix-cache admission probes", ("result",))
        self._prefix_pages = m.counter(
            "repro_prefix_pages_saved_total",
            "pages aliased from the prefix cache instead of prefilled")
        self._prefix_tokens = m.counter(
            "repro_prefix_tokens_saved_total",
            "prompt tokens whose prefill was skipped by a prefix hit")
        # -- speculation ----------------------------------------------------
        self._spec_steps = m.counter("repro_spec_verify_steps_total",
                                     "verify steps executed")
        self._spec_drafted = m.counter(
            "repro_spec_drafted_total", "draft tokens proposed for verify")
        self._spec_accepted = m.counter(
            "repro_spec_accepted_total",
            "draft tokens accepted (bonus excluded)")
        self._draft_lookups = m.counter(
            "repro_draft_lookups_total", "drafter probes", ("result",))
        self._draft_proposed = m.counter(
            "repro_draft_proposed_tokens_total", "tokens drafters proposed")
        # -- executables ----------------------------------------------------
        self._compilations = m.gauge(
            "repro_engine_compilations",
            "compiled executables per step kind (pull-refreshed from the "
            "engine census)", ("exec",))

    # -- engine hooks --------------------------------------------------------
    def register_census(self, source) -> None:
        """``source()`` -> ``{exec_kind: count}``; re-read at every pull."""
        self._census_source = source

    def census(self) -> dict:
        """Refresh the compilation gauges from the registered source and
        return the census dict (the engine's ``compilations`` property,
        exported).  :func:`repro.analysis.retrace_guard.census` accepts
        an Observer (or its :meth:`snapshot`) directly."""
        if self._census_source is None:
            return {}
        c = {str(k): int(v) for k, v in self._census_source().items()}
        for k, v in c.items():
            self._compilations.set(v, exec=k)
        return c

    def on_step(self, queue_depth: int, occupied: int) -> None:
        self.step += 1
        self._steps.inc()
        self._queue_depth.set(queue_depth)
        self._slots_occ.set(occupied)

    @contextlib.contextmanager
    def phase(self, name: str, **args):
        """Trace span + duration histogram around one step phase."""
        t0 = now()
        if self.tracer is not None:
            self.tracer.begin(name, step=self.step, **args)
        try:
            yield
        finally:
            if self.tracer is not None:
                self.tracer.end(name, step=self.step)
            self._phase_s.observe(now() - t0, phase=name)

    def on_enqueue(self, rid) -> None:
        self._enqueued.inc()

    def on_queue_depth(self, depth: int) -> None:
        self._queue_depth.set(depth)

    def on_admit(self, rid, slot: int, n_tokens: int, cached: int) -> None:
        self._admitted.inc()
        if self.tracer is not None:
            self.tracer.instant("admit", step=self.step, rid=rid, slot=slot,
                                n_tokens=n_tokens, cached=cached)

    def on_prefix_lookup(self, rid, hit_pages: int, hit_tokens: int) -> None:
        self._prefix.inc(result="hit" if hit_pages else "miss")
        if hit_pages:
            self._prefix_pages.inc(hit_pages)
            self._prefix_tokens.inc(hit_tokens)

    def on_prefill_tokens(self, n: int) -> None:
        self._prefill_tokens.inc(n)

    def on_tokens(self, n: int) -> None:
        self._tokens.inc(n)

    def on_preempt(self, rid, slot: int) -> None:
        self._preempts.inc()
        if self.tracer is not None:
            self.tracer.instant("preempt", step=self.step, rid=rid, slot=slot)

    def on_retire(self, req, slot: int = -1) -> None:
        """Request leaving the engine (retired, failed, or swept at
        ``max_steps``): TTFT/TPOT from its clock marks, status counter,
        and the retire trace instant."""
        status = "error" if req.error is not None else "ok"
        self._retired.inc(status=status)
        if req.t_first is not None and req.t_submit is not None:
            self._ttft.observe(req.t_first - req.t_submit)
            if req.t_done is not None and len(req.out) > 1:
                self._tpot.observe((req.t_done - req.t_first)
                                   / (len(req.out) - 1))
        if self.tracer is not None:
            self.tracer.instant("retire", step=self.step, rid=req.rid,
                                slot=slot, n_out=len(req.out), status=status)

    def on_spec_step(self) -> None:
        self._spec_steps.inc()

    def on_draft_verified(self, rid, drafted: int, accepted: int) -> None:
        self._spec_drafted.inc(drafted)
        self._spec_accepted.inc(accepted)

    # -- allocator hooks -----------------------------------------------------
    def on_page_event(self, op: str, slot: int, n: int) -> None:
        if n:
            self._pages.inc(n, op=op)
            if self.tracer is not None:
                self.tracer.instant(f"page_{op}", step=self.step, slot=slot,
                                    pages=n)

    def on_pool(self, free: int, cached_free: int) -> None:
        self._pages_free.set(free)
        self._pages_cached.set(cached_free)

    # -- drafter hooks -------------------------------------------------------
    def on_draft_lookup(self, hit: bool, n_proposed: int) -> None:
        self._draft_lookups.inc(result="hit" if hit else "miss")
        if n_proposed:
            self._draft_proposed.inc(n_proposed)

    # -- pull side -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat ``{"name{labels}": value}`` view (census refreshed)."""
        self.census()
        return self.metrics.snapshot()

    def prometheus_text(self) -> str:
        """Text exposition dump (census refreshed first)."""
        self.census()
        return self.metrics.prometheus_text()

    def trace_json(self) -> dict:
        assert self.tracer is not None, "Observer built with trace=False"
        return self.tracer.to_json()

    def write_trace(self, path: str) -> None:
        assert self.tracer is not None, "Observer built with trace=False"
        self.tracer.write(path)


class NullObserver:
    """The off state: every hook is an empty method, ``phase`` yields a
    shared no-op context.  Engines call hooks unconditionally; this keeps
    the disabled cost at one attribute lookup + no-op call per event."""

    tracer = None
    step = 0
    _NULL_CTX = contextlib.nullcontext()

    def phase(self, name: str, **args):
        return self._NULL_CTX

    def register_census(self, source) -> None: pass
    def census(self) -> dict: return {}
    def on_step(self, queue_depth: int, occupied: int) -> None: pass
    def on_enqueue(self, rid) -> None: pass
    def on_queue_depth(self, depth: int) -> None: pass
    def on_admit(self, rid, slot, n_tokens, cached) -> None: pass
    def on_prefix_lookup(self, rid, hit_pages, hit_tokens) -> None: pass
    def on_prefill_tokens(self, n) -> None: pass
    def on_tokens(self, n) -> None: pass
    def on_preempt(self, rid, slot) -> None: pass
    def on_retire(self, req, slot=-1) -> None: pass
    def on_spec_step(self) -> None: pass
    def on_draft_verified(self, rid, drafted, accepted) -> None: pass
    def on_page_event(self, op, slot, n) -> None: pass
    def on_pool(self, free, cached_free) -> None: pass
    def on_draft_lookup(self, hit, n_proposed) -> None: pass


NULL_OBSERVER = NullObserver()
