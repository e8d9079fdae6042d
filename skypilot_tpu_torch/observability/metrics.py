"""The port's copy of the JAX package's ``observability/metrics.py`` (it imports
nothing of that package): the registry and ``render``, as there; the
load balancer's ``merge_text`` and the textfile ``dump_to_file`` are not
copied.

Thread-safe metrics registry with Prometheus text exposition.

Reference analog: prometheus_client's Counter/Gauge/Histogram — but
stdlib-only (the container bakes no client library) and deliberately
small: label children are plain dicts keyed by the label-value tuple,
every update takes only that child's lock for the duration of the
arithmetic, and exposition renders the whole registry under the
registry lock. No background threads, no process collectors.

Usage:

    from skypilot_tpu_torch.observability import metrics
    REQS = metrics.counter("stpu_lb_requests_total",
                           "Proxied requests.", ("method", "code"))
    REQS.labels(method="GET", code="200").inc()
    text = metrics.render()          # Prometheus text format 0.0.4

Families are created once per (registry, name): calling a factory again
with the same name returns the existing family, so module-level
declarations stay idempotent across re-imports and tests.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Latency-in-seconds oriented defaults: sub-5ms local proxying through
# multi-minute cold model compiles (serve upstream timeout is 120s+).
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

# Tail-latency-SLO bucket set for TTFT-class histograms. DEFAULT_BUCKETS
# jumps 1.0 -> 2.5 -> 5 -> 10 -> 30: a p99 TTFT anywhere past ~1s lands
# in a bucket 2.5-20s wide and interpolated quantiles are mush — useless
# for a "p99 TTFT < 2s" SLO verdict. This set keeps ~1.5x spacing
# through the 0.1s-20s band where serving TTFT tails actually live,
# while still covering cold-compile outliers at the top.
LATENCY_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.15, 0.25, 0.4, 0.6, 0.9,
                   1.3, 2.0, 3.0, 4.5, 6.5, 10.0, 15.0, 22.5, 35.0,
                   50.0, 75.0, 120.0, 300.0)


def quantile_from_cumulative(bounds: Sequence[float],
                             cumulative: Sequence[float],
                             q: float) -> float:
    """Quantile ``q`` in [0, 1] from cumulative bucket counts, linearly
    interpolated within the winning bucket (PromQL histogram_quantile
    semantics): the first bucket interpolates from 0, and a quantile
    landing in the +Inf bucket returns the highest finite bound — the
    histogram cannot resolve beyond it. ``cumulative`` has one more
    entry than ``bounds`` (the +Inf bucket). NaN when empty.

    Shared by Histogram.quantile (live registry) and
    promtext.HistogramSnapshot.quantile (scraped exposition), so the
    two can never diverge on what a percentile means."""
    if not cumulative:
        return math.nan
    total = cumulative[-1]
    if total <= 0:
        return math.nan
    q = min(max(float(q), 0.0), 1.0)
    rank = q * total
    for i, bound in enumerate(bounds):
        if cumulative[i] >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            below = cumulative[i - 1] if i > 0 else 0.0
            in_bucket = cumulative[i] - below
            if in_bucket <= 0:
                return bound
            return lo + (bound - lo) * (rank - below) / in_bucket
    return bounds[-1] if bounds else math.nan


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _format_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class _Child:
    """One (label-values) series of a Counter/Gauge."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def get(self) -> float:
        with self._lock:
            return self.value


class _HistogramChild:
    """One (label-values) series of a Histogram.

    Bucket counts are stored NON-cumulative (observe = one bisect + one
    increment under the child lock); cumulation happens at render time,
    off the hot path.
    """

    __slots__ = ("_lock", "_bounds", "_counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...]):
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # +1 for +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self.sum += value
            self.count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total, cumulative = 0, []
            for c in counts:
                total += c
                cumulative.append(total)
            return cumulative, self.sum, self.count


class _MetricFamily:
    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            # Label-less family IS its single child.
            self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **kwvalues):
        if kwvalues:
            if values:
                raise ValueError("pass label values either positionally "
                                 "or by keyword, not both")
            try:
                values = tuple(kwvalues[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e.args[0]!r} "
                    f"(expects {self.labelnames})") from e
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(values)} label values, "
                f"expects {len(self.labelnames)} {self.labelnames}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values,
                                                  self._new_child())
        return child

    def _samples(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._children.items())
        for values, child in items:
            yield (f"{self.name}"
                   f"{_format_labels(self.labelnames, values)} "
                   f"{_format_value(child.get())}")

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        lines.extend(self._samples())
        return "\n".join(lines)


class Counter(_MetricFamily):
    kind = "counter"

    def _new_child(self) -> _Child:
        return _Child()

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def get(self) -> float:
        return self.labels().get()


class Gauge(_MetricFamily):
    kind = "gauge"

    def _new_child(self) -> _Child:
        return _Child()

    def set(self, value: float) -> None:
        self.labels().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def get(self) -> float:
        return self.labels().get()


class Histogram(_MetricFamily):
    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        super().__init__(name, help_text, labelnames)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def quantile(self, q: float, **labelkw) -> float:
        """Interpolated quantile of one series' observations so far
        (label-less family by default). NaN while empty. SLO-grade
        accuracy depends on the bucket layout — see LATENCY_BUCKETS."""
        cumulative, _, _ = self.labels(**labelkw).snapshot()
        return quantile_from_cumulative(self.buckets, cumulative, q)

    def _samples(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._children.items())
        for values, child in items:
            cumulative, total, count = child.snapshot()
            bounds = list(self.buckets) + [math.inf]
            for bound, cum in zip(bounds, cumulative):
                names = self.labelnames + ("le",)
                vals = values + (_format_value(bound),)
                yield (f"{self.name}_bucket"
                       f"{_format_labels(names, vals)} {cum}")
            labels = _format_labels(self.labelnames, values)
            yield f"{self.name}_sum{labels} {_format_value(total)}"
            yield f"{self.name}_count{labels} {count}"


class Registry:
    """Named metric families; renders them in one exposition document."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _MetricFamily] = {}

    def _get_or_create(self, cls, name: str, help_text: str,
                       labelnames: Sequence[str], **kwargs):
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or \
                        existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"different type or label set")
                return existing
            family = cls(name, help_text, labelnames, **kwargs)
            self._families[name] = family
            return family

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help_text,
                                   labelnames, buckets=buckets)

    def render(self) -> str:
        with self._lock:
            families = sorted(self._families.values(),
                              key=lambda f: f.name)
        out = [f.render() for f in families]
        return "\n".join(out) + "\n" if out else ""


# Default process-wide registry: module-level instrumentation in the
# LB/controller/daemon all lands here, so one render() is the whole
# process's exposition.
REGISTRY = Registry()


def counter(name: str, help_text: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help_text, labelnames)


def gauge(name: str, help_text: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help_text, labelnames)


def histogram(name: str, help_text: str = "",
              labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help_text, labelnames,
                              buckets=buckets)


def render(registry: Optional[Registry] = None) -> str:
    return (registry or REGISTRY).render()
