"""The port's copy of the JAX package's ``observability/tracing.py`` (it imports
nothing of that package): spans, their context and its propagation, as
there; the trace readers and exporters the CLI uses (``read``,
``list_traces``, ``assemble``, ``critical_path``, ``to_perfetto``) and
the launch-side ``from_env``, ``set_env_context`` and ``adopt_ctx`` are
not copied.

End-to-end distributed tracing: request + launch spans.

PR-1 gave stpu aggregate metrics ("how many requests were slow") and
lifecycle events ("what state changed"); neither answers "why was THIS
request's TTFT 4s". This module adds the causal, per-request view: a
span is one timed hop (LB proxy attempt, replica generate, engine
prefill, gang launch), spans share a ``trace_id``, and parent links
reassemble them into a tree — LB root → replica → engine children for
a request, jobs controller → gang driver → hosts for a launch.

Reference analog: the reference leans on Ray's dashboard timeline for
this; a TPU-native stack needs its own. Deliberately NOT OpenTelemetry
(the container bakes no SDK): the same ids/parenting model, stdlib
only; the JAX package's ``stpu trace`` CLI reads the records.

Record shape (one JSON object per line in ``traces.jsonl``, written on
span END so every record is complete):

    {"trace_id": <32 hex>, "span_id": <16 hex>, "parent_id": ...|null,
     "name": "lb.request", "kind": "lb", "ts": <wall start seconds>,
     "dur": <monotonic-clock seconds>, "status": "ok",
     "pid": ..., "tid": ..., "run_id": ...,
     "attrs": {...}, "events": [{"name": "retry", "at": <sec offset>}]}

``ts`` is wall clock for cross-host alignment; ``dur`` (and event
offsets) come from ``time.perf_counter()`` so an NTP step mid-span
cannot produce a negative duration (the stpu-wallclock rule of `stpu check`).

Context propagation:

  * HTTP hop (LB → replica): the ``X-STPU-Trace`` header carries
    ``<trace_id>-<span_id>-<01|00>`` (last field: sampled flag);
    ``extract(headers)`` / ``format_ctx(span.context())`` are the two
    ends.
  * host-to-host (jobs controller → gang driver → job env): the
    ``STPU_TRACE_CTX`` env var carries the same string, the exact
    pattern ``STPU_RUN_ID`` uses (events.py) — child_env() stamps a
    subprocess environment.

Overhead discipline (mirror of utils/fault_injection.py): tracing is
OFF by default; hot call sites guard with the module attribute
``ENABLED`` (``if tracing.ENABLED: ...``) so the unarmed cost is one
global load and a falsy branch — no span objects, no clock reads, no
allocation. Arm with ``STPU_TRACE=1`` (every process in the stack picks
it up at import) or ``arm()`` in tests. ``STPU_TRACE_SAMPLE`` in [0, 1]
samples at ROOT-span granularity; a child follows its parent's sampled
decision (carried in the header/env flag — including the NEGATIVE
decision, via an unsampled carrier span), so a trace is always whole
or absent, never torn. Disabled paths get the ``NOOP`` span: every
method a no-op, usable as a context manager, ``context()`` is None.

Span emission must never break the instrumented call: all sink I/O
errors are swallowed, exactly like events.emit.
"""
from __future__ import annotations

import json
import os
import random
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Mapping, Optional

ENABLE_ENV = "STPU_TRACE"
SAMPLE_ENV = "STPU_TRACE_SAMPLE"
ENV_CTX = "STPU_TRACE_CTX"
HEADER = "X-STPU-Trace"

# Hot-path guard (see module docstring). Call sites read this module
# attribute before paying for anything else.
ENABLED = False

# Traces are per-request (not per-transition like events), so the cap
# is larger; one generation (.1) kept, same policy as events.jsonl.
_MAX_BYTES = 16 * 1024 * 1024

_lock = threading.Lock()
_rng = random.Random()
_sample_rate = 1.0

_CTX_RE = re.compile(r"^([0-9a-f]{32})-([0-9a-f]{16})-(0[01])$")


def trace_path() -> "os.PathLike[str]":
    from skypilot_tpu_torch.utils import paths
    return paths.logs_dir() / "traces.jsonl"


# ------------------------------------------------------------- arming
def arm(sample: Optional[float] = None) -> None:
    """Turn tracing on (idempotent). ``sample`` overrides the
    STPU_TRACE_SAMPLE root-span sampling rate for this process."""
    global ENABLED, _sample_rate
    if sample is None:
        try:
            sample = float(os.environ.get(SAMPLE_ENV, "1"))
        except ValueError:
            sample = 1.0
    _sample_rate = min(max(float(sample), 0.0), 1.0)
    ENABLED = True


def disarm() -> None:
    global ENABLED
    ENABLED = False


# ------------------------------------------------------------ context
class SpanContext:
    """The propagatable identity of a span: what a child (possibly in
    another process/host) needs to attach itself to the trace."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)


def format_ctx(ctx: Optional[SpanContext]) -> Optional[str]:
    """Wire form: ``<trace_id>-<span_id>-<01|00>`` (01 = sampled)."""
    if ctx is None:
        return None
    return (f"{ctx.trace_id}-{ctx.span_id}-"
            f"{'01' if ctx.sampled else '00'}")


def parse_ctx(value: Optional[str]) -> Optional[SpanContext]:
    if not value:
        return None
    m = _CTX_RE.match(value.strip())
    if m is None:
        return None
    return SpanContext(m.group(1), m.group(2), m.group(3) == "01")


def extract(headers: Mapping[str, str]) -> Optional[SpanContext]:
    """Parse the ``X-STPU-Trace`` header out of an incoming request
    (http.server's case-insensitive message mapping works directly)."""
    try:
        return parse_ctx(headers.get(HEADER))
    except (AttributeError, TypeError):
        return None


def env_context() -> Optional[str]:
    """The serialized context children should inherit, or None when
    tracing is off (a stale env var must not smuggle trace ids into an
    untraced launch)."""
    if not ENABLED:
        return None
    return os.environ.get(ENV_CTX) or None


def child_env() -> Dict[str, str]:
    """Env-var stamp for a subprocess/remote-host environment: the
    current context plus the arming flag, so job-side telemetry both
    CAN trace and knows WHERE to attach."""
    ctx = env_context()
    if not ctx:
        return {}
    return {ENV_CTX: ctx, ENABLE_ENV: "1"}


# --------------------------------------------------------------- spans
class Span:
    """One timed hop. Created by start_span(); emitted by end().

    Not thread-safe by design: a span belongs to the one logical
    operation it times (event/attr appends from its owning thread).
    """

    __slots__ = ("name", "kind", "trace_id", "span_id", "parent_id",
                 "ts", "_mono", "attrs", "events", "_ended")

    def __init__(self, name: str, kind: str, trace_id: str,
                 parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.kind = kind
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.ts = time.time()
        self._mono = time.perf_counter()
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.events: List[Dict[str, Any]] = []
        self._ended = False

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, True)

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def event(self, name: str, **fields: Any) -> None:
        """A timestamped annotation WITHIN the span (retry, breaker
        ejection, policy decision); ``at`` is the offset from span
        start in monotonic seconds."""
        rec = {"name": name,
               "at": round(time.perf_counter() - self._mono, 6)}
        rec.update(fields)
        self.events.append(rec)

    def end(self, status: str = "ok", **attrs: Any) -> None:
        """Close the span and write its record. Idempotent — the
        second end() is a no-op, so an error path and a finally block
        can both call it safely."""
        if self._ended:
            return
        self._ended = True
        if attrs:
            self.attrs.update(attrs)
        _write(_record(self.name, self.kind, self.trace_id,
                       self.span_id, self.parent_id, self.ts,
                       time.perf_counter() - self._mono, status,
                       self.attrs, self.events))

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end(status="error" if exc_type is not None else "ok",
                 **({"error": f"{exc_type.__name__}: {exc}"}
                    if exc_type is not None else {}))


class _NoopSpan:
    """The zero-cost stand-in when tracing is disabled. Every method is
    a no-op; context() is None so children naturally no-op too."""

    __slots__ = ()

    def context(self) -> Optional[SpanContext]:
        return None

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def event(self, name: str, **fields: Any) -> None:
        pass

    def end(self, status: str = "ok", **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


class _UnsampledSpan(_NoopSpan):
    """Records nothing, but still CARRIES a context whose sampled flag
    is False: the root's not-sampled decision must propagate (header
    flag ``00``) or a downstream armed hop would open its own root and
    record a torn, rootless partial trace. Whole-or-absent means the
    negative decision travels too."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx: SpanContext):
        self._ctx = ctx

    def context(self) -> SpanContext:
        return self._ctx


NOOP = _NoopSpan()


def _parent_ids(parent):
    """(trace_id, parent_span_id, sampled) for a Span, a span-like
    (NOOP/unsampled), a SpanContext, or None parent."""
    if isinstance(parent, _NoopSpan):
        parent = parent.context()   # None for NOOP, ctx for unsampled
    if parent is None:
        return None, None, None
    if isinstance(parent, Span):
        return parent.trace_id, parent.span_id, True
    if isinstance(parent, SpanContext):
        return parent.trace_id, parent.span_id, parent.sampled
    return None, None, None


def start_span(name: str, kind: str = "span", parent=None,
               attrs: Optional[Dict[str, Any]] = None):
    """Open a span. ``parent`` is a Span, a SpanContext (extracted from
    a header / the env), or None for a root. Roots make the sampling
    decision; children inherit the parent's — a not-sampled root/parent
    yields an unsampled carrier span that records nothing but still
    propagates the decision, so traces are whole or absent, never torn.
    Returns NOOP when tracing is off. Callers never need to branch."""
    if not ENABLED:
        return NOOP
    trace_id, parent_id, sampled = _parent_ids(parent)
    if trace_id is None:
        if _sample_rate < 1.0 and _rng.random() >= _sample_rate:
            return _UnsampledSpan(SpanContext(
                uuid.uuid4().hex, uuid.uuid4().hex[:16], False))
        trace_id = uuid.uuid4().hex
    elif not sampled:
        return _UnsampledSpan(SpanContext(
            trace_id, uuid.uuid4().hex[:16], False))
    return Span(name, kind, trace_id, parent_id, attrs)


def record_span(name: str, kind: str, parent, start_mono: float,
                end_mono: Optional[float] = None, status: str = "ok",
                attrs: Optional[Dict[str, Any]] = None,
                events: Optional[List[Dict[str, Any]]] = None) -> None:
    """Emit a RETROACTIVE span from monotonic bounds — for phases whose
    boundaries are only known after the fact (engine queue wait:
    submit stamp → admission stamp) where holding an open Span object
    across scheduler iterations would be a leak hazard. The wall start
    is reconstructed from the current wall/monotonic pair, so the
    record aligns with live-span records on the timeline."""
    if not ENABLED:
        return
    trace_id, parent_id, sampled = _parent_ids(parent)
    if trace_id is None or not sampled:
        return
    now_wall = time.time()
    now_mono = time.perf_counter()
    if end_mono is None:
        end_mono = now_mono
    ts = now_wall - (now_mono - start_mono)
    _write(_record(name, kind, trace_id, uuid.uuid4().hex[:16],
                   parent_id, ts, end_mono - start_mono, status,
                   dict(attrs or {}), list(events or [])))


# ---------------------------------------------------------------- sink
def _record(name, kind, trace_id, span_id, parent_id, ts, dur, status,
            attrs, events) -> Dict[str, Any]:
    from skypilot_tpu_torch.observability import events as events_lib
    return {
        "trace_id": trace_id, "span_id": span_id,
        "parent_id": parent_id, "name": name, "kind": kind,
        "ts": ts, "dur": max(dur, 0.0), "status": status,
        "pid": os.getpid(),
        "tid": threading.get_ident() & 0x7FFFFFFF,
        "run_id": events_lib.run_id(),
        "attrs": attrs, "events": events,
    }


def _write(record: Dict[str, Any]) -> None:
    """Append one span record (shared rotate+append path with the
    event log: observability/jsonl_log.py). Never raises."""
    from skypilot_tpu_torch.observability import jsonl_log
    try:
        line = json.dumps(record, default=str)
    except (TypeError, ValueError):
        return
    try:
        path = trace_path()
    except OSError:
        return
    jsonl_log.append_line(path, line, _MAX_BYTES, _lock)


# Arm from the environment at import: operators export STPU_TRACE=1 (or
# a launch carries it host-to-host via child_env) and every process in
# the stack picks it up.
if os.environ.get(ENABLE_ENV, "0") == "1":
    arm()
