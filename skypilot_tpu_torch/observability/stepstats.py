"""Per-engine-step performance telemetry + crash flight recorder: the
port's copy of the JAX package's ``observability/stepstats.py``, with two
changes. ``sampled_sync`` waits on a step's CUDA work (a
``torch.cuda.Event`` the engine records after the step) in place of
``block_until_ready``, and ``capture_profile`` runs ``torch.profiler`` in
place of ``jax.profiler``. The ring, ``snapshot``, ``record``,
``record_admission`` and ``dump_flight`` are as there.

PR-1 gave aggregate request metrics, PR-5 per-request spans. Neither
answers the questions the next performance levers ask: *where does one
engine step's time actually go* (queue vs prefill chunk vs decode
dispatch vs device execution vs host work), and *what did the
slots/pool look like at that instant*? The attention-constant
autotuner needs a per-(batch-band) step-time objective; disaggregated
prefill/decode autoscaling needs the prefill-vs-decode time split;
speculative decoding needs a steady-state decode baseline to beat.
This module is that measurement substrate.

Three layers:

* **Step ring** — a fixed-size ring buffer of per-engine-step records,
  recorded from the decode engine's supervisor loop (one record per
  iteration that did work). Each record:

      {"seq": N, "ts": <wall s>, "mono": <perf_counter s>,
       "dur": <step seconds>, "phase": "prefill"|"decode"|"mixed",
       "live_slots": L, "queue_depth": Q,
       "prefill_tokens": P,   # prompt tokens processed this step
       "decode_tokens": D,    # tokens emitted by the batched step
       "paged": 0|1, "kv_free": F|None, "kv_usable": U|None,
       "dispatch_s": <host dispatch seconds>|None,
       "device_s": <sampled device-wait seconds>|None,
       "spec_drafted": D,     # speculative tokens drafted this step
       "spec_accepted": A}    # ... and accepted by verification

  ``ts`` is wall clock (cross-host alignment); ``dur`` and ``mono``
  come from ``time.perf_counter()`` so an NTP step cannot corrupt a
  window (the stpu-wallclock rule). A small companion ring keeps the
  last admissions (prompt/budget/cached tokens, queue wait) — the
  workload context a post-mortem needs next to the step timings.

* **Derived metrics** — while armed, each record feeds the process
  registry (rides the replica ``/metrics`` → LB merge):
  ``stpu_engine_step_seconds{phase}``, ``stpu_engine_busy_fraction``,
  ``stpu_engine_slot_occupancy``,
  ``stpu_engine_phase_tokens_per_sec{phase}``, and the sampled
  dispatch/device split histograms. ``snapshot()`` renders the same
  ring as one JSON document — the replica's ``GET /perf``.

* **Flight recorder** — ``dump_flight(reason, error=...)`` writes the
  ring (steps + admissions + aggregate snapshot + the terminal
  exception) atomically to ``~/.stpu/logs/flightrec/``; the engine
  crash path, supervisor/gang restart paths and SIGTERM handlers call
  it, and the resulting path is stamped into the matching ``engine_*``
  lifecycle event. The JAX package's ``stpu perf dump|show`` read the
  dumps back (its ``list_dumps``/``read_dump`` are not copied here).

Overhead discipline (mirror of ``tracing``/``fault_injection``): OFF
by default; hot call sites guard with the module attribute ``ENABLED``
(``if stepstats.ENABLED: ...``) so the disarmed cost is one global
load and a falsy branch — no records, no clock reads, no allocation
(pinned by the monkeypatch-bomb test). Arm with ``STPU_STEPSTATS=1``
(ring size ``STPU_STEPSTATS_RING``) or ``arm()`` in tests.

Dispatch-vs-device split: CUDA work returns host-side as soon as it
is *queued*; the gap to the result being *ready* is device execution.
Forcing that boundary costs a sync, so it is SAMPLED: every
``STPU_STEPSTATS_SYNC_EVERY``-th step (default 0 = off) the engine
calls :func:`sampled_sync` — one timed ``synchronize()`` of the CUDA
event it recorded after that step — and the steady-state path stays
sync-free.

Stdlib-only: no torch import (``sampled_sync`` duck-types the event).
Recording must never break the engine: all sink I/O errors are
swallowed, exactly like events/tracing.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.observability import metrics

ENABLE_ENV = "STPU_STEPSTATS"
RING_ENV = "STPU_STEPSTATS_RING"
SYNC_ENV = "STPU_STEPSTATS_SYNC_EVERY"

DEFAULT_RING = 1024
# Admission companion ring: fixed (no knob) — post-mortems want the
# recent workload shape, not an unbounded history.
ADMIT_RING = 256
# Retention: newest dumps kept on disk. Crash/restart paths dump
# unconditionally (the terminal exception matters even disarmed), so
# without a cap weeks of replica churn would fill the disk.
KEEP_DUMPS = 32

# Hot-path guard (module docstring): call sites read this module
# attribute before paying for anything else.
ENABLED = False

_PHASES = ("prefill", "decode", "mixed")

# ------------------------------------------------------------- metrics
_STEP_SECONDS = metrics.histogram(
    "stpu_engine_step_seconds",
    "Engine supervisor-loop step duration by phase (prefill = chunk "
    "prefill only, decode = batched decode only, mixed = both in one "
    "iteration). Recorded only while STPU_STEPSTATS=1.",
    ("phase",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0))
_BUSY_FRACTION = metrics.gauge(
    "stpu_engine_busy_fraction",
    "Fraction of wall time the engine spent doing prefill/decode work "
    "over the step-ring window (1.0 = fully busy).")
_OCCUPANCY = metrics.histogram(
    "stpu_engine_slot_occupancy",
    "Live slots observed per working engine step.",
    buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128))
_PHASE_TOK_S = metrics.gauge(
    "stpu_engine_phase_tokens_per_sec",
    "Token throughput by phase over the step-ring window (prefill = "
    "prompt tokens processed, decode = tokens emitted).",
    ("phase",))
_DISPATCH_SECONDS = metrics.histogram(
    "stpu_engine_step_dispatch_seconds",
    "Host time to dispatch one batched step (the call returning, "
    "device still executing).",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.5, 2.0))
_DEVICE_SECONDS = metrics.histogram(
    "stpu_engine_step_device_seconds",
    "Sampled device-execution wait per batched step (a timed wait "
    "on the step's CUDA event every STPU_STEPSTATS_SYNC_EVERY steps).",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 10.0))
_DUMPS = metrics.counter(
    "stpu_engine_flightrec_dumps_total",
    "Flight-recorder dumps written, by trigger.", ("reason",))


class _Ring:
    """Fixed-size step ring with running aggregates, so the per-record
    cost is O(1): evicted records subtract their contribution, the
    gauges re-render from the sums."""

    def __init__(self, size: int):
        self.size = max(int(size), 1)
        self.buf: List[Optional[Dict[str, Any]]] = [None] * self.size
        self.idx = 0
        self.count = 0
        self.seq = 0
        self.dur_sum = 0.0
        self.occ_sum = 0
        self.phase_dur = {p: 0.0 for p in _PHASES}
        self.phase_steps = {p: 0 for p in _PHASES}
        self.tok_sum = {"prefill": 0, "decode": 0}
        self.spec_sum = {"drafted": 0, "accepted": 0}
        self.dispatch_sum = 0.0
        self.dispatch_n = 0
        self.device_sum = 0.0
        self.device_n = 0

    def _account(self, rec: Dict[str, Any], sign: int) -> None:
        self.dur_sum += sign * rec["dur"]
        self.occ_sum += sign * rec["live_slots"]
        phase = rec["phase"]
        self.phase_dur[phase] += sign * rec["dur"]
        self.phase_steps[phase] += sign
        self.tok_sum["prefill"] += sign * rec["prefill_tokens"]
        self.tok_sum["decode"] += sign * rec["decode_tokens"]
        self.spec_sum["drafted"] += sign * rec.get("spec_drafted", 0)
        self.spec_sum["accepted"] += sign * rec.get("spec_accepted", 0)
        if rec.get("dispatch_s") is not None:
            self.dispatch_sum += sign * rec["dispatch_s"]
            self.dispatch_n += sign
        if rec.get("device_s") is not None:
            self.device_sum += sign * rec["device_s"]
            self.device_n += sign

    def append(self, rec: Dict[str, Any]) -> None:
        evicted = self.buf[self.idx]
        if evicted is not None:
            self._account(evicted, -1)
        self.buf[self.idx] = rec
        self.idx = (self.idx + 1) % self.size
        self.count = min(self.count + 1, self.size)
        self.seq += 1
        self._account(rec, +1)

    def ordered(self) -> List[Dict[str, Any]]:
        """Oldest → newest."""
        if self.count < self.size:
            return [r for r in self.buf[:self.count] if r is not None]
        return [r for r in (self.buf[self.idx:] + self.buf[:self.idx])
                if r is not None]

    def window_s(self) -> float:
        """Wall window covered by the ring, monotonic-clock based:
        oldest record's start → newest record's end. O(1) — called on
        every armed record."""
        if self.count == 0:
            return 0.0
        oldest = (self.buf[self.idx] if self.count == self.size
                  else self.buf[0])
        newest = self.buf[(self.idx - 1) % self.size]
        return max(newest["mono"] - (oldest["mono"] - oldest["dur"]),
                   1e-9)


_lock = threading.Lock()
_ring = _Ring(DEFAULT_RING)
_admits: List[Dict[str, Any]] = []
_sync_every = 0
_sync_count = 0
_dump_seq = 0


# -------------------------------------------------------------- arming
def arm(ring: Optional[int] = None,
        sync_every: Optional[int] = None) -> None:
    """Turn step recording on (idempotent). ``ring`` overrides
    STPU_STEPSTATS_RING, ``sync_every`` overrides
    STPU_STEPSTATS_SYNC_EVERY for this process."""
    global ENABLED, _ring, _sync_every
    with _lock:
        if ring is None:
            try:
                ring = int(os.environ.get(RING_ENV, "1024"))
            except ValueError:
                ring = DEFAULT_RING
        if sync_every is None:
            try:
                sync_every = int(os.environ.get(SYNC_ENV, "0"))
            except ValueError:
                sync_every = 0
        if _ring.size != int(ring):
            _ring = _Ring(int(ring))
        _sync_every = max(int(sync_every), 0)
        ENABLED = True


def disarm() -> None:
    global ENABLED
    ENABLED = False


def reset() -> None:
    """Drop all recorded state (tests)."""
    global _ring, _admits, _sync_count
    with _lock:
        _ring = _Ring(_ring.size)
        _admits = []
        _sync_count = 0


# ----------------------------------------------------------- recording
def record(*, dur: float, phase: str, live_slots: int,
           queue_depth: int, prefill_tokens: int = 0,
           decode_tokens: int = 0, paged: bool = False,
           kv_free: Optional[int] = None,
           kv_usable: Optional[int] = None,
           dispatch_s: Optional[float] = None,
           device_s: Optional[float] = None,
           spec_drafted: int = 0, spec_accepted: int = 0) -> None:
    """Append one engine-step record (engine compute thread only) and
    refresh the derived metrics. Callers guard on ``ENABLED``.
    ``spec_drafted``/``spec_accepted`` are the speculative-decoding
    draft/accept token counts of a verify step (0 on plain steps)."""
    if phase not in _PHASES:
        phase = "mixed"
    rec = {
        "ts": time.time(),
        "mono": time.perf_counter(),
        "dur": float(dur),
        "phase": phase,
        "live_slots": int(live_slots),
        "queue_depth": int(queue_depth),
        "prefill_tokens": int(prefill_tokens),
        "decode_tokens": int(decode_tokens),
        "paged": int(bool(paged)),
        "kv_free": kv_free if kv_free is None else int(kv_free),
        "kv_usable": (kv_usable if kv_usable is None
                      else int(kv_usable)),
        "dispatch_s": dispatch_s,
        "device_s": device_s,
        "spec_drafted": int(spec_drafted),
        "spec_accepted": int(spec_accepted),
    }
    with _lock:
        rec["seq"] = _ring.seq
        _ring.append(rec)
        window = _ring.window_s()
        busy = min(_ring.dur_sum / window, 1.0) if window else 0.0
        tok_rates = {p: _ring.tok_sum[p] / window if window else 0.0
                     for p in ("prefill", "decode")}
    _STEP_SECONDS.labels(phase=phase).observe(rec["dur"])
    _OCCUPANCY.observe(rec["live_slots"])
    _BUSY_FRACTION.set(busy)
    for p, rate in tok_rates.items():
        _PHASE_TOK_S.labels(phase=p).set(rate)
    if dispatch_s is not None:
        _DISPATCH_SECONDS.observe(dispatch_s)
    if device_s is not None:
        _DEVICE_SECONDS.observe(device_s)


def record_admission(*, slot: int, prompt_tokens: int, max_tokens: int,
                     cached_tokens: int = 0,
                     queue_wait_s: float = 0.0) -> None:
    """Append one admission record (workload context for post-mortems).
    Callers guard on ``ENABLED``."""
    rec = {
        "ts": time.time(),
        "mono": time.perf_counter(),
        "slot": int(slot),
        "prompt_tokens": int(prompt_tokens),
        "max_tokens": int(max_tokens),
        "cached_tokens": int(cached_tokens),
        "queue_wait_s": round(float(queue_wait_s), 6),
    }
    with _lock:
        _admits.append(rec)
        if len(_admits) > ADMIT_RING:
            del _admits[:len(_admits) - ADMIT_RING]


# -------------------------------------------------------- sampled sync
def sync_due() -> bool:
    """True on every STPU_STEPSTATS_SYNC_EVERY-th call (0 = never).
    The engine asks once per decode step; the module owns the counter
    so restarted engines keep the cadence."""
    global _sync_count
    if _sync_every <= 0:
        return False
    _sync_count += 1
    if _sync_count >= _sync_every:
        _sync_count = 0
        return True
    return False


def sampled_sync(value: Any) -> float:
    """THE sanctioned device sync of the serve hot path: one timed wait
    on a step's CUDA work, returning the wait in seconds (device
    execution still outstanding when the step returned). ``value`` is
    the ``torch.cuda.Event`` the engine recorded after the step, or
    None where there is no device work to wait on (a CPU engine)."""
    t0 = time.perf_counter()
    sync = getattr(value, "synchronize", None)
    if callable(sync):
        sync()
    return time.perf_counter() - t0


# ------------------------------------------------------------ snapshot
def snapshot() -> Dict[str, Any]:
    """One JSON-ready document over the current ring: phase breakdown,
    occupancy, throughput, sampled dispatch/device split. Served as
    the replica's ``GET /perf`` and embedded in flight dumps."""
    with _lock:
        window = _ring.window_s()
        steps = _ring.count
        last = _ring.ordered()[-1] if steps else None
        phases = {}
        for p in _PHASES:
            n = _ring.phase_steps[p]
            if not n:
                continue
            phases[p] = {
                "steps": n,
                "seconds": round(_ring.phase_dur[p], 6),
            }
        if window:
            for p in phases:
                phases[p]["share"] = round(
                    _ring.phase_dur[p] / max(_ring.dur_sum, 1e-12), 4)
        doc: Dict[str, Any] = {
            "armed": ENABLED,
            "ring_size": _ring.size,
            "steps": steps,
            "total_steps": _ring.seq,
            "window_s": round(window, 6),
            "busy_fraction": round(
                min(_ring.dur_sum / window, 1.0) if window else 0.0,
                4),
            "phases": phases,
            "tokens_per_sec": {
                "prefill": round(_ring.tok_sum["prefill"] / window, 1)
                if window else 0.0,
                "decode": round(_ring.tok_sum["decode"] / window, 1)
                if window else 0.0,
            },
            "occupancy": {
                "mean": round(_ring.occ_sum / steps, 2) if steps
                else 0.0,
                "last": last["live_slots"] if last else 0,
            },
            "queue_depth": last["queue_depth"] if last else 0,
            "admissions": len(_admits),
        }
        if _ring.spec_sum["drafted"]:
            drafted = _ring.spec_sum["drafted"]
            accepted = _ring.spec_sum["accepted"]
            doc["spec"] = {
                "drafted": drafted,
                "accepted": accepted,
                "accept_rate": round(accepted / drafted, 4),
            }
        if _ring.dispatch_n:
            doc["dispatch_ms_mean"] = round(
                _ring.dispatch_sum / _ring.dispatch_n * 1e3, 3)
        if _ring.device_n:
            doc["sync"] = {
                "samples": _ring.device_n,
                "device_ms_mean": round(
                    _ring.device_sum / _ring.device_n * 1e3, 3),
                "every": _sync_every,
            }
        if last is not None:
            doc["paged"] = bool(last["paged"])
            if last["kv_usable"] is not None:
                doc["kv_pool"] = {"free": last["kv_free"],
                                  "usable": last["kv_usable"]}
        return doc


def steps_tail(n: int = 0) -> List[Dict[str, Any]]:
    """The last ``n`` step records, oldest first (0 = whole ring)."""
    with _lock:
        recs = _ring.ordered()
    return recs[-n:] if n else recs


def admissions_tail(n: int = 0) -> List[Dict[str, Any]]:
    with _lock:
        recs = list(_admits)
    return recs[-n:] if n else recs


# ------------------------------------------------------ flight recorder
def flightrec_dir() -> "os.PathLike[str]":
    from skypilot_tpu_torch.utils import paths
    d = paths.logs_dir() / "flightrec"
    d.mkdir(parents=True, exist_ok=True)
    return d


def profiles_dir() -> "os.PathLike[str]":
    from skypilot_tpu_torch.utils import paths
    d = paths.logs_dir() / "profiles"
    d.mkdir(parents=True, exist_ok=True)
    return d


def dump_flight(reason: str, error: Optional[str] = None,
                extra: Optional[Dict[str, Any]] = None
                ) -> Optional[str]:
    """Write the ring + admissions + terminal exception atomically to
    ``~/.stpu/logs/flightrec/`` (temp + ``os.replace`` so a concurrent
    reader never sees a torn dump). Returns the path, or None on any
    I/O failure — a post-mortem artifact must never crash the crash
    path it documents."""
    global _dump_seq
    from skypilot_tpu_torch.observability import events
    with _lock:
        _dump_seq += 1
        seq = _dump_seq
    doc = {
        "version": 1,
        "reason": reason,
        "ts": time.time(),
        "run_id": events.run_id(),
        "pid": os.getpid(),
        "error": error,
        "snapshot": snapshot(),
        "steps": steps_tail(),
        "admissions": admissions_tail(),
    }
    if extra:
        doc.update(extra)
    # Names must sort chronologically (the retention prune and
    # a reader's "newest" pick both rely on it), so the time prefix
    # carries microseconds — a second-granularity stamp would fall
    # back to comparing reason/pid for same-second dumps (e.g. a
    # gang_restart dump and the replacement engine's crash dump).
    now = doc["ts"]
    stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
    micros = int(now % 1.0 * 1e6)
    name = (f"{stamp}.{micros:06d}-{reason}-{os.getpid()}"
            f"-{seq:06d}.json")
    try:
        path = os.path.join(str(flightrec_dir()), name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
    except OSError:
        return None
    _DUMPS.labels(reason=reason).inc()
    _prune_dumps()
    return path


def _prune_dumps(keep: Optional[int] = None) -> None:
    """Drop the oldest dumps past the retention cap (stamped names
    sort chronologically). Best-effort, like every sink here."""
    if keep is None:
        keep = KEEP_DUMPS
    if keep <= 0:
        return
    try:
        root = str(flightrec_dir())
        names = sorted(n for n in os.listdir(root)
                       if n.endswith(".json"))
        for name in names[:-keep]:
            os.unlink(os.path.join(root, name))
    except OSError:
        pass


# ------------------------------------------------------------ profiler
_profile_lock = threading.Lock()
_profile_active = False


def begin_profile() -> bool:
    """Atomically claim the one-capture-at-a-time slot. The replica's
    POST /profile handler claims BEFORE answering 202 — two concurrent
    requests racing an unlocked flag would both be told a capture
    started while one silently did nothing."""
    global _profile_active
    with _profile_lock:
        if _profile_active:
            return False
        _profile_active = True
        return True


def capture_profile(seconds: float, out_dir: Optional[str] = None,
                    claimed: bool = False) -> Dict[str, Any]:
    """On-demand ``torch.profiler`` trace capture (the replica's ``POST
    /profile`` seam). Starts the trace, sleeps ``seconds`` (clamped to
    [0.05, 120]), stops it. One capture at a time per process —
    ``claimed=True`` means the caller already holds the slot via
    :func:`begin_profile`; otherwise it is claimed here and a
    concurrent capture raises cleanly. Blocking: callers run it on
    their own thread. The slot is released on every exit path."""
    seconds = min(max(float(seconds), 0.05), 120.0)
    if not claimed and not begin_profile():
        raise RuntimeError("a profile capture is already running")
    if out_dir is None:
        out_dir = os.path.join(str(profiles_dir()),
                               time.strftime("%Y%m%d-%H%M%S"))
    try:
        import torch
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            time.sleep(seconds)
        prof.export_chrome_trace(os.path.join(str(out_dir), "trace.json"))
    finally:
        global _profile_active
        with _profile_lock:
            _profile_active = False
    from skypilot_tpu_torch.observability import events
    events.emit("engine", "profiler", "profile_captured",
                seconds=seconds, out_dir=str(out_dir))
    return {"profile_dir": str(out_dir), "seconds": seconds}


# Arm from the environment at import: operators export STPU_STEPSTATS=1
# and every process in the serving stack picks it up.
if os.environ.get(ENABLE_ENV, "0") == "1":
    arm()
