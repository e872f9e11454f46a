"""Low-overhead metrics registry: counters, gauges, log-bucket histograms.

The serving hot loop runs at ~millisecond step granularity, so the
instruments here are built for cheap host-side updates: a counter
increment is one dict lookup plus a float add, a histogram observation is
one ``bisect`` into a *fixed* tuple of log-spaced bucket bounds (no numpy,
no allocation, no device anything — the module is contractually jax-free,
lint rule RA004).  Reading is pull-based: :meth:`MetricsRegistry.collect`
/ :meth:`snapshot` walk the instruments on demand, and
:meth:`prometheus_text` renders the standard text exposition format
(``# HELP`` / ``# TYPE`` / escaped labels / cumulative ``_bucket`` lines)
that the async front-end will eventually serve from ``/metrics``.

Histograms use fixed log-spaced buckets (default ``LOG_BUCKETS``:
20 buckets per decade over 1e-5..1e5, ~12% relative resolution) so any
two histograms of the same schema are mergeable and a quantile is
reconstructible from the bucket counts alone —
:meth:`Histogram.quantile` does the same linear-within-bucket
interpolation as PromQL's ``histogram_quantile``.  The serving benchmark
reports its TTFT/TPOT percentiles through this exact class
(:meth:`Histogram.of`), so bench rows and live metrics can never
disagree about what a percentile means.

:func:`validate_prometheus_text` is the golden-format checker used by the
tests and the CI observability stage: it re-parses an exposition dump and
verifies sample syntax, label escaping, ``TYPE`` declarations, and
histogram invariants (cumulative buckets, ``+Inf`` == ``_count``).
"""
from __future__ import annotations

import math
import re
from bisect import bisect_left


def log_buckets(lo: float = 1e-5, hi: float = 1e5,
                per_decade: int = 20) -> tuple:
    """Fixed log-spaced bucket upper bounds covering ``[lo, hi]``."""
    assert 0 < lo < hi and per_decade >= 1
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


LOG_BUCKETS = log_buckets()


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return format(v, ".9g")


_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")


class _Instrument:
    """Shared label plumbing: values live in ``_data[label_values]``."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: tuple = ()):
        assert _NAME_RE.match(name), name
        assert all(_LABEL_RE.match(l) for l in label_names), label_names
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._data: dict = {}

    def _key(self, labels: dict) -> tuple:
        if not self.label_names:
            assert not labels, (self.name, labels)
            return ()
        return tuple(str(labels[l]) for l in self.label_names)

    def _label_str(self, key: tuple, extra: tuple = ()) -> str:
        pairs = [f'{l}="{_escape(v)}"'
                 for l, v in tuple(zip(self.label_names, key)) + extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def label_keys(self) -> list:
        return sorted(self._data)


class Counter(_Instrument):
    """Monotonically increasing count (resets only with the registry)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        key = self._key(labels)
        self._data[key] = self._data.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return self._data.get(self._key(labels), 0.0)

    def samples(self):
        for key in sorted(self._data):
            yield self.name, self._label_str(key), self._data[key]


class Gauge(_Instrument):
    """A value that goes up and down (queue depth, free pages, ...)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._data[self._key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = self._key(labels)
        self._data[key] = self._data.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return self._data.get(self._key(labels), 0.0)

    samples = Counter.samples


class Histogram(_Instrument):
    """Fixed-bucket histogram; ``observe`` is one bisect, no allocation.

    ``buckets`` are *upper bounds* (an implicit ``+Inf`` bucket is always
    appended).  The default log-spaced schema trades ~12% relative
    quantile resolution for mergeability and O(1) hot-path cost.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, label_names: tuple = (),
                 buckets: tuple = LOG_BUCKETS):
        super().__init__(name, help, label_names)
        assert buckets and tuple(buckets) == tuple(sorted(buckets))
        self.buckets = tuple(float(b) for b in buckets)

    def _cell(self, labels: dict) -> list:
        key = self._key(labels)
        cell = self._data.get(key)
        if cell is None:
            # [counts per bucket ..., +Inf count, sum]
            cell = self._data[key] = [0] * (len(self.buckets) + 1) + [0.0]
        return cell

    def observe(self, value: float, **labels) -> None:
        cell = self._cell(labels)
        cell[bisect_left(self.buckets, value)] += 1
        cell[-1] += value

    def count(self, **labels) -> int:
        cell = self._data.get(self._key(labels))
        return sum(cell[:-1]) if cell else 0

    def sum(self, **labels) -> float:
        cell = self._data.get(self._key(labels))
        return cell[-1] if cell else 0.0

    def quantile(self, q: float, **labels) -> float:
        """PromQL ``histogram_quantile`` semantics: find the bucket the
        q-th observation falls in and interpolate linearly inside it
        (values in the ``+Inf`` bucket clamp to the highest finite
        bound; an empty histogram returns NaN)."""
        assert 0.0 <= q <= 1.0, q
        cell = self._data.get(self._key(labels))
        if not cell:
            return math.nan
        total = sum(cell[:-1])
        if total == 0:
            return math.nan
        rank = q * total
        cum = 0
        for i, n in enumerate(cell[:-2]):
            prev, cum = cum, cum + n
            if cum >= rank and n:
                lo = self.buckets[i - 1] if i else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * ((rank - prev) / n)
        return self.buckets[-1]   # +Inf bucket: clamp to the last bound

    def percentile(self, p: float, **labels) -> float:
        return self.quantile(p / 100.0, **labels)

    @classmethod
    def of(cls, values, buckets: tuple = LOG_BUCKETS) -> "Histogram":
        """Standalone histogram over ``values`` — the shared percentile
        implementation benchmarks use, so offline rows and live metrics
        agree by construction."""
        h = cls("adhoc", "ad-hoc value summary", buckets=buckets)
        for v in values:
            h.observe(v)
        return h

    def samples(self):
        for key in sorted(self._data):
            cell = self._data[key]
            cum = 0
            for i, bound in enumerate(self.buckets):
                cum += cell[i]
                yield (self.name + "_bucket",
                       self._label_str(key, (("le", _fmt(bound)),)), cum)
            cum += cell[len(self.buckets)]
            yield (self.name + "_bucket",
                   self._label_str(key, (("le", "+Inf"),)), cum)
            yield self.name + "_sum", self._label_str(key), cell[-1]
            yield self.name + "_count", self._label_str(key), cum


class MetricsRegistry:
    """Name-keyed instrument registry with a text-exposition renderer."""

    def __init__(self):
        self._metrics: dict = {}

    def _register(self, cls, name, help, label_names, **kw):
        m = self._metrics.get(name)
        if m is not None:
            assert type(m) is cls and m.label_names == tuple(label_names), \
                f"metric {name!r} re-registered with a different schema"
            return m
        m = self._metrics[name] = cls(name, help, tuple(label_names), **kw)
        return m

    def counter(self, name: str, help: str, label_names=()) -> Counter:
        return self._register(Counter, name, help, label_names)

    def gauge(self, name: str, help: str, label_names=()) -> Gauge:
        return self._register(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str, label_names=(),
                  buckets: tuple = LOG_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, label_names,
                              buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def collect(self):
        """Yield ``(sample_name, label_str, value)`` for every sample."""
        for name in sorted(self._metrics):
            yield from self._metrics[name].samples()

    def snapshot(self) -> dict:
        """Flat pull-based view ``{"name{labels}": value}`` — the census
        source :func:`repro.analysis.retrace_guard.census` understands."""
        return {name + labels: value for name, labels, value in self.collect()}

    def prometheus_text(self) -> str:
        out = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out.append(f"# HELP {m.name} {_escape(m.help)}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for sname, labels, value in m.samples():
                out.append(f"{sname}{labels} {_fmt(value)}")
        return "\n".join(out) + "\n"


# --------------------------------------------------------------------------
# exposition-format validation (the golden checker for tests and CI)
# --------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>[^ ]+)$")
_LABEL_PAIR_RE = re.compile(
    r'\s*(?P<label>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"\s*'
    r"(?:,|$)")


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    return float(text)   # ValueError propagates to the caller


def _parse_labels(text: str) -> dict:
    labels, pos = {}, 0
    while pos < len(text):
        m = _LABEL_PAIR_RE.match(text, pos)
        if m is None:
            raise ValueError(f"malformed label pair at {text[pos:]!r}")
        labels[m.group("label")] = m.group("value")
        pos = m.end()
    return labels


def validate_prometheus_text(text: str) -> int:
    """Validate a text-exposition dump; returns the number of samples.

    Checks: sample-line syntax, metric/label name charsets, parseable
    (escaped) label values, every sample preceded by a ``# TYPE`` line of
    a known type, and histogram structure — cumulative non-decreasing
    ``_bucket`` counts per label set, a ``+Inf`` bucket equal to
    ``_count``.  Raises :class:`ValueError` on the first violation.
    """
    types: dict = {}
    hist: dict = {}   # (base name, frozen non-le labels) -> [(le, cum)]
    hist_count: dict = {}
    n_samples = 0
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) < 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: bad TYPE line {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        name = m.group("name")
        labels = _parse_labels(m.group("labels") or "")
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            raise ValueError(f"line {lineno}: bad value {m.group('value')!r}")
        n_samples += 1
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        declared = types.get(name) or types.get(base)
        if declared is None:
            raise ValueError(f"line {lineno}: sample {name!r} has no "
                             f"preceding # TYPE line")
        if declared == "histogram" and name.endswith("_bucket"):
            if "le" not in labels:
                raise ValueError(f"line {lineno}: histogram bucket without "
                                 f"an le label")
            key = (base, frozenset((k, v) for k, v in labels.items()
                                   if k != "le"))
            hist.setdefault(key, []).append(
                (_parse_value(labels["le"]), value))
        elif declared == "histogram" and name.endswith("_count"):
            hist_count[(base, frozenset(labels.items()))] = value
    for (base, labelset), buckets in hist.items():
        les = [le for le, _ in buckets]
        cums = [c for _, c in buckets]
        if les != sorted(les):
            raise ValueError(f"{base}: bucket le bounds not sorted")
        if cums != sorted(cums):
            raise ValueError(f"{base}: bucket counts not cumulative")
        if not les or les[-1] != math.inf:
            raise ValueError(f"{base}: missing +Inf bucket")
        count = hist_count.get((base, labelset))
        if count is not None and count != cums[-1]:
            raise ValueError(f"{base}: _count {count} != +Inf bucket "
                             f"{cums[-1]}")
    return n_samples
