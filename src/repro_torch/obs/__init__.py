"""Host-pure observability for the serving stack: metrics, tracing, and
the injectable :class:`~repro_torch.obs.runtime.Observer` the engine reports to.

Three pieces (see docs/observability.md):

  * :mod:`repro_torch.obs.metrics` — a low-overhead registry of counters /
    gauges / histograms (fixed log-spaced buckets) with a Prometheus
    text-exposition renderer and format validator.
  * :mod:`repro_torch.obs.trace` — a structured per-step-phase event tracer
    exporting Chrome/Perfetto ``trace_event`` JSON, and the repo's single
    monotonic clock source (:func:`repro_torch.obs.trace.now`).
  * :mod:`repro_torch.obs.runtime` — the :class:`Observer` seam wired through
    ``ServingEngine`` / ``Scheduler`` / ``PageAllocator`` /
    ``PromptLookupDrafter``, plus the zero-cost :data:`NULL_OBSERVER`
    default.

Like the Scheduler, every module here is contractually jax-free (lint
rule RA004, ``repro.analysis.lint.PURE_MODULES``): observability can
never add a device sync or an executable to the hot loop.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               validate_prometheus_text)
from repro_torch.obs.runtime import NULL_OBSERVER, NullObserver, Observer
from repro_torch.obs.trace import Tracer, now

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "validate_prometheus_text",
    "Tracer", "now",
    "Observer", "NullObserver", "NULL_OBSERVER",
]
