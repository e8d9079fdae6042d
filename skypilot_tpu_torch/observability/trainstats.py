"""Per-train-step goodput telemetry + gang straggler detection: the
port's copy of the JAX package's ``observability/trainstats.py``, with the
same metric names, files and ``STPU_TRAINSTATS*`` env contract, so a
scraper, the jobs controller or the JAX package's ``dump_dir_flight`` /
``read_dump`` read either package's trainstats directory alike. Three
parts change for torch:

* ``peak_flops_for_device`` matches a CUDA card's name
  (``torch.cuda.get_device_name``) against ``PEAK_FLOPS``, NVIDIA's dense
  bf16 rate for each H100 form; an unknown name or the CPU gives 0.0,
  and MFU is then None.
* ``detect_peak_flops(device)`` is that rate for the recipe's own device,
  times one: one process drives one card here (JAX multiplies by the
  local device count).
* ``sampled_sync`` waits on a CUDA tensor with a timed
  ``torch.cuda.synchronize`` of its device, and on anything else not at
  all (JAX's duck-typed ``block_until_ready``).

What "dispatch" means in eager torch: the JAX loop's dispatch is one jitted
call returning while the device runs it; here it is the host enqueuing
every launch of a step (forward, backward, optimizer) one op at a time.
When the CUDA launch queue is full the host blocks inside that enqueue,
waiting on the device, so ``dispatch_s`` can approach the whole step and
``device_s`` (the wait left after it) shrink toward zero. A large
``dispatch_s`` beside a small ``device_s`` is therefore not proof of a
host-bound step; the device's idle share (a profiler trace) tells the two
apart.

The JAX module's text follows.

The serving path has four observability layers (metrics, tracing, the
stepstats flight recorder, the fleet/SLO store); training — the half
of the north star whose headline number is MFU — had none. This module
is the training twin of :mod:`stepstats`: a fixed-size ring of
per-train-step records plus derived gauges (live MFU, a goodput
breakdown), per-host JSONL sinks for multi-host gangs, host-0
straggler aggregation, and the same crash flight recorder.

Three layers:

* **Step ring** — one record per optimizer step, recorded from the
  recipe train loop:

      {"seq": N, "step": S, "ts": <wall s>, "mono": <perf_counter s>,
       "dur": <step seconds, exclusive of the stalls below>,
       "tokens": T,
       "data_wait_s": <input-pipeline wait>, "ckpt_s": <ckpt stall>,
       "dispatch_s": <host dispatch seconds>|None,
       "device_s": <sampled device-wait seconds>|None,
       "loss": L|None, "grad_norm": G|None}

  ``loss``/``grad_norm`` arrive ONE STEP LATE: the loop reads the
  previous step's loss tensor on the host only after the next step has
  been dispatched (``trainer.DelayedFetch``), so logging never syncs the
  hot loop. ``record_step(delayed=...)`` attaches the
  fetched values to the *previous* ring record.

* **Derived gauges** — live MFU from the model's ``flops_per_token()``
  against the ring's token rate and the configured peak FLOP/s, and a
  goodput breakdown: productive / data-wait / ckpt-stall /
  restart-downtime fractions of the observed window. ``snapshot()``
  renders one JSON document; armed multi-host runs also append every
  record to ``<out_dir>/host-{rank}.jsonl`` and host 0 writes an
  aggregate ``snapshot.json`` the jobs controller scrapes each watch
  tick into its ``TimeSeriesStore``.

* **Straggler detection** — host 0 tails the peer JSONL files: a host
  whose newest step completion lags the gang median by more than
  ``STPU_TRAIN_STRAGGLER_SECONDS`` raises an edge-triggered
  ``train_straggler`` event and sets ``stpu_train_host_skew_seconds``.

Flight recorder: ``dump_flight(reason, error=...)`` writes this
process's ring atomically (stepstats naming + retention);
``dump_dir_flight`` synthesizes a gang-wide dump from the host JSONL
tails — the jobs controller calls it on preemption/recovery so
post-mortems show the last N steps of every host even though the
training processes are already dead.

Overhead discipline (mirror of stepstats): OFF by default; hot call
sites guard with ``if trainstats.ENABLED:`` so the disarmed cost is
one global load and a falsy branch (pinned by the monkeypatch-bomb
test). Arm with ``STPU_TRAINSTATS=1`` (ring ``STPU_TRAINSTATS_RING``)
or ``arm()`` in tests. The sampled dispatch-vs-device split reuses the
stepstats contract: :func:`sampled_sync` is the ONLY sanctioned sync
in the train hot loops, beside the one-step-delayed loss read.

Stdlib-only on the hot path: ``sampled_sync`` and
``peak_flops_for_device`` import torch inside the call (configure time
or a tensor already on hand), never at import. Recording must never break training: all sink I/O errors are
swallowed, exactly like events/tracing.
"""
from __future__ import annotations

import json
import os
import statistics
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from skypilot_tpu_torch.observability import metrics

ENABLE_ENV = "STPU_TRAINSTATS"
RING_ENV = "STPU_TRAINSTATS_RING"
SYNC_ENV = "STPU_TRAINSTATS_SYNC_EVERY"
DIR_ENV = "STPU_TRAINSTATS_DIR"
STRAGGLER_ENV = "STPU_TRAIN_STRAGGLER_SECONDS"

DEFAULT_RING = 512
DEFAULT_STRAGGLER_S = 2.0
KEEP_DUMPS = 32
# Host-0 aggregate snapshot.json cadence (steps) and the minimum gap
# between straggler scans — both bound the armed steady-state I/O.
SNAPSHOT_EVERY = 5
STRAGGLER_SCAN_MIN_S = 0.5

# Hot-path guard (module docstring): call sites read this module
# attribute before paying for anything else.
ENABLED = False

# Peak dense bf16 FLOP/s per card (no sparsity), by the name
# torch.cuda.get_device_name reports, from NVIDIA's H100 datasheet. Lives
# here because live MFU is a first-class gauge.
PEAK_FLOPS = {
    # H100 SXM5: 1,979 TFLOP/s bf16 with sparsity, 989 dense.
    "NVIDIA H100 80GB HBM3": 989e12,
    # H100 PCIe: 1,513 TFLOP/s bf16 with sparsity, 756 dense.
    "NVIDIA H100 PCIe": 756e12,
    # H100 NVL, per card: 1,671 TFLOP/s bf16 with sparsity, 835 dense.
    "NVIDIA H100 NVL": 835e12,
}

# ------------------------------------------------------------- metrics
_STEP_SECONDS = metrics.histogram(
    "stpu_train_step_seconds",
    "Optimizer step duration (dispatch + sampled device wait; input "
    "wait and ckpt stalls are recorded separately). Recorded only "
    "while STPU_TRAINSTATS=1.",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 15.0, 60.0))
_MFU = metrics.gauge(
    "stpu_train_mfu",
    "Live model FLOPs utilization over the step-ring window: "
    "tokens/s x flops_per_token / configured peak FLOP/s.")
_TOK_S = metrics.gauge(
    "stpu_train_tokens_per_sec",
    "Training token throughput over the step-ring window.")
_GOODPUT = metrics.gauge(
    "stpu_train_goodput_fraction",
    "Goodput breakdown over the step-ring window + recorded restart "
    "downtime: productive / data_wait / ckpt / restart fractions.",
    ("component",))
_HOST_SKEW = metrics.gauge(
    "stpu_train_host_skew_seconds",
    "Worst host step-completion lag behind the gang median (host-0 "
    "aggregation over the per-host JSONL sinks).")
_DISPATCH_SECONDS = metrics.histogram(
    "stpu_train_step_dispatch_seconds",
    "Host time to dispatch one train step (every launch of the step "
    "enqueued, device still executing; the host blocks inside it when "
    "the CUDA launch queue is full).",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.5, 2.0))
_DEVICE_SECONDS = metrics.histogram(
    "stpu_train_step_device_seconds",
    "Sampled device-execution wait per train step (a timed "
    "torch.cuda.synchronize every STPU_TRAINSTATS_SYNC_EVERY steps).",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 10.0))
_DUMPS = metrics.counter(
    "stpu_train_flightrec_dumps_total",
    "Training flight-recorder dumps written, by trigger.", ("reason",))


def _device_name(device: Any) -> str:
    """The card's name for a torch device (``"cuda:0"`` or a
    ``torch.device``) as ``torch.cuda.get_device_name`` reports it; ""
    for a device that is not a card. A string that names no device is
    taken as a card's name already."""
    import torch
    if isinstance(device, str):
        try:
            device = torch.device(device)
        except RuntimeError:
            return device
    if device.type != "cuda":
        return ""
    return torch.cuda.get_device_name(device)


def peak_flops_for_device(device: Any) -> float:
    """Per-card peak dense bf16 FLOP/s for a torch device or a card's
    name (0.0 = unknown, e.g. the CPU or a card missing from
    ``PEAK_FLOPS``): MFU is then None, never a guess."""
    return PEAK_FLOPS.get(_device_name(device), 0.0)


def detect_peak_flops(device: Any) -> float:
    """This process's peak FLOP/s: the recipe's own device's rate times
    one (one process drives one card). 0.0 on the CPU (MFU = None)."""
    return peak_flops_for_device(device)


class _Ring:
    """Fixed-size step ring with running aggregates so the per-record
    cost is O(1): evicted records subtract their contribution, the
    gauges re-render from the sums."""

    def __init__(self, size: int):
        self.size = max(int(size), 1)
        self.buf: List[Optional[Dict[str, Any]]] = [None] * self.size
        self.idx = 0
        self.count = 0
        self.seq = 0
        self.dur_sum = 0.0
        self.tok_sum = 0
        self.data_wait_sum = 0.0
        self.ckpt_sum = 0.0
        self.dispatch_sum = 0.0
        self.dispatch_n = 0
        self.device_sum = 0.0
        self.device_n = 0

    def _account(self, rec: Dict[str, Any], sign: int) -> None:
        self.dur_sum += sign * rec["dur"]
        self.tok_sum += sign * rec["tokens"]
        self.data_wait_sum += sign * rec["data_wait_s"]
        self.ckpt_sum += sign * rec["ckpt_s"]
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

    def newest(self) -> Optional[Dict[str, Any]]:
        if self.count == 0:
            return None
        return self.buf[(self.idx - 1) % self.size]

    def ordered(self) -> List[Dict[str, Any]]:
        """Oldest → newest."""
        if self.count < self.size:
            return [r for r in self.buf[:self.count] if r is not None]
        return [r for r in (self.buf[self.idx:] + self.buf[:self.idx])
                if r is not None]

    def window_s(self) -> float:
        """Wall window covered by the ring, monotonic-clock based:
        oldest record's start → newest record's end."""
        if self.count == 0:
            return 0.0
        oldest = (self.buf[self.idx] if self.count == self.size
                  else self.buf[0])
        newest = self.buf[(self.idx - 1) % self.size]
        return max(newest["mono"] - (oldest["mono"] - oldest["dur"]),
                   1e-9)


_lock = threading.Lock()
_ring = _Ring(DEFAULT_RING)
_sync_every = 0
_sync_count = 0
_dump_seq = 0

# Run context set by configure(): identity in a gang, the MFU inputs,
# and the shared output directory (``$STPU_JOB_CKPT_DIR/trainstats``
# under a managed job, so controller + all hosts agree on it).
_host = 0
_hosts = 1
_job: Optional[str] = None
_flops_per_token: Optional[float] = None
_peak_flops: float = 0.0
_out_dir: Optional[str] = None
_straggler_s = DEFAULT_STRAGGLER_S
_downtime_s = 0.0
_straggling: set = set()
_last_scan_mono = 0.0
_host_skew_s = 0.0
# This host's JSONL sink, opened by configure() and kept open: (path,
# file), closed by disarm(), reset() or a change of path.
_sink: Optional[Tuple[str, Any]] = None


# -------------------------------------------------------------- arming
def arm(ring: Optional[int] = None,
        sync_every: Optional[int] = None) -> None:
    """Turn train-step recording on (idempotent). ``ring`` overrides
    STPU_TRAINSTATS_RING, ``sync_every`` overrides
    STPU_TRAINSTATS_SYNC_EVERY for this process."""
    global ENABLED, _ring, _sync_every
    with _lock:
        if ring is None:
            try:
                ring = int(os.environ.get(RING_ENV, "512"))
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
    _close_sink()


def reset() -> None:
    """Drop all recorded state and run context (tests)."""
    global _ring, _sync_count, _host, _hosts, _job
    global _flops_per_token, _peak_flops, _out_dir, _straggler_s
    global _downtime_s, _straggling, _last_scan_mono, _host_skew_s
    with _lock:
        _ring = _Ring(_ring.size)
        _sync_count = 0
        _host = 0
        _hosts = 1
        _job = None
        _flops_per_token = None
        _peak_flops = 0.0
        _out_dir = None
        _straggler_s = DEFAULT_STRAGGLER_S
        _downtime_s = 0.0
        _straggling = set()
        _last_scan_mono = 0.0
        _host_skew_s = 0.0
        _close_sink()


def configure(*, flops_per_token: Optional[float] = None,
              peak_flops: Optional[float] = None,
              host: int = 0, hosts: int = 1,
              out_dir: Optional[str] = None,
              job: Optional[str] = None,
              straggler_s: Optional[float] = None) -> None:
    """Set the run context: MFU inputs (model flops/token + this
    process's peak FLOP/s), gang identity, and the shared output
    directory for the per-host JSONL sinks. Recipes call it once
    after building the model, guarded on ``ENABLED``.

    ``out_dir`` default: ``STPU_TRAINSTATS_DIR``, else
    ``$STPU_JOB_CKPT_DIR/trainstats`` under a managed job (the one
    directory every gang host and the controller know), else no
    sink (ring-only, single-process mode)."""
    global _flops_per_token, _peak_flops, _host, _hosts, _out_dir
    global _job, _straggler_s
    with _lock:
        if flops_per_token is not None:
            _flops_per_token = float(flops_per_token)
        if peak_flops is not None:
            _peak_flops = float(peak_flops)
        _host = int(host)
        _hosts = max(int(hosts), 1)
        if job is not None:
            _job = str(job)
        if straggler_s is None:
            try:
                straggler_s = float(
                    os.environ.get(STRAGGLER_ENV, "2.0"))
            except ValueError:
                straggler_s = DEFAULT_STRAGGLER_S
        _straggler_s = max(float(straggler_s), 0.0)
        if out_dir is None:
            out_dir = os.environ.get(DIR_ENV)
        if out_dir is None:
            ckpt_dir = os.environ.get("STPU_JOB_CKPT_DIR")
            if ckpt_dir:
                out_dir = os.path.join(ckpt_dir, "trainstats")
        if out_dir:
            _out_dir = str(out_dir)
            try:
                os.makedirs(_out_dir, exist_ok=True)
            except OSError:
                _out_dir = None
        _open_sink()


def note_downtime(seconds: float) -> None:
    """Account restart/startup downtime against goodput — recipes call
    it after a checkpoint restore with the wall seconds the process
    spent getting back to the training loop."""
    global _downtime_s
    with _lock:
        _downtime_s += max(float(seconds), 0.0)


# ----------------------------------------------------------- recording
def record_step(*, step: int, dur: float, tokens: int,
                data_wait_s: float = 0.0, ckpt_s: float = 0.0,
                dispatch_s: Optional[float] = None,
                device_s: Optional[float] = None,
                delayed: Optional[Dict[str, Any]] = None) -> None:
    """Append one train-step record and refresh the derived gauges.
    Callers guard on ``ENABLED``.

    ``delayed`` carries the PREVIOUS step's host-fetched values
    (``{"loss": ..., "grad_norm": ...}`` from the DelayedFetch
    rotation) — they attach to the previous ring record, keeping the
    record's timing fields and its loss about the same step."""
    rec = {
        "ts": time.time(),
        "mono": time.perf_counter(),
        "step": int(step),
        "dur": float(dur),
        "tokens": int(tokens),
        "data_wait_s": float(data_wait_s),
        "ckpt_s": float(ckpt_s),
        "dispatch_s": dispatch_s,
        "device_s": device_s,
        "loss": None,
        "grad_norm": None,
    }
    with _lock:
        if delayed:
            prev = _ring.newest()
            if prev is not None:
                for key in ("loss", "grad_norm"):
                    if delayed.get(key) is not None:
                        prev[key] = float(delayed[key])
        rec["seq"] = _ring.seq
        _ring.append(rec)
        window = _ring.window_s()
        tok_s = _ring.tok_sum / window if window else 0.0
        mfu = None
        if _flops_per_token and _peak_flops > 0:
            mfu = tok_s * _flops_per_token / _peak_flops
        denom = window + _downtime_s
        goodput = _goodput_locked(window, denom)
        write_snapshot = (_out_dir is not None
                          and _ring.seq % SNAPSHOT_EVERY == 0)
    _STEP_SECONDS.observe(rec["dur"])
    _TOK_S.set(tok_s)
    if mfu is not None:
        _MFU.set(mfu)
    for component, frac in goodput.items():
        _GOODPUT.labels(component=component).set(frac)
    if dispatch_s is not None:
        _DISPATCH_SECONDS.observe(dispatch_s)
    if device_s is not None:
        _DEVICE_SECONDS.observe(device_s)
    _append_jsonl(rec)
    if write_snapshot and _host == 0:
        _write_snapshot()
        check_stragglers()


def _goodput_locked(window: float, denom: float) -> Dict[str, float]:
    """Goodput fractions over window + downtime. Caller holds _lock.
    ``dur`` is pure step work (the loops time it EXCLUSIVE of the
    input wait and the checkpoint stall), so the components partition
    the window without double-counting; the remainder is untracked
    loop overhead."""
    if denom <= 0:
        return {"productive": 0.0, "data_wait": 0.0, "ckpt": 0.0,
                "restart": 0.0}
    productive = max(_ring.dur_sum, 0.0)
    return {
        "productive": round(min(productive / denom, 1.0), 4),
        "data_wait": round(min(_ring.data_wait_sum / denom, 1.0), 4),
        "ckpt": round(min(_ring.ckpt_sum / denom, 1.0), 4),
        "restart": round(min(_downtime_s / denom, 1.0), 4),
    }


def _host_jsonl(host: Optional[int] = None) -> Optional[str]:
    if _out_dir is None:
        return None
    return os.path.join(_out_dir,
                        f"host-{_host if host is None else host}.jsonl")


def _close_sink() -> None:
    global _sink
    if _sink is not None:
        try:
            _sink[1].close()
        except OSError:
            pass
        _sink = None


def _open_sink() -> None:
    """Open this host's JSONL sink unless it is the one open already."""
    global _sink
    path = _host_jsonl()
    if path is None or (_sink is not None and _sink[0] == path):
        return
    _close_sink()
    try:
        _sink = (path, open(path, "a"))
    except OSError:
        pass


def _append_jsonl(rec: Dict[str, Any]) -> None:
    """Append one step record to this host's JSONL sink. The line is
    written at step boundary WITHOUT the delayed loss (timing is what
    straggler detection and crash forensics need; the loss lands in
    the next snapshot). The file is opened before the loop and stays
    open, and each line is flushed as it is written, so readers see it
    at once: an open and a close per step cost milliseconds on a
    network filesystem, in the loop's moments outside every timed
    span. Best-effort: OSError swallowed (and the sink reopened at the
    next record)."""
    _open_sink()
    if _sink is None:
        return
    try:
        _sink[1].write(json.dumps(
            {k: rec[k] for k in ("seq", "step", "ts", "mono", "dur",
                                 "tokens", "data_wait_s", "ckpt_s")})
            + "\n")
        _sink[1].flush()
    except OSError:
        _close_sink()


def _write_snapshot() -> None:
    """Atomically write host 0's aggregate ``snapshot.json`` next to
    the JSONL sinks — the document the jobs controller scrapes."""
    if _out_dir is None:
        return
    path = os.path.join(_out_dir, "snapshot.json")
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snapshot(), f, default=str)
        os.replace(tmp, path)
    except OSError:
        pass


def flush() -> None:
    """Force-write the aggregate snapshot (end of run / tests)."""
    if _host == 0:
        _write_snapshot()


# ------------------------------------------------------- straggler scan
def _tail_record(path: str) -> Optional[Dict[str, Any]]:
    """Newest JSONL record of one host sink: seek to the last ~4KB and
    parse the final complete line. Best-effort."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(size - 4096, 0))
            chunk = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    for line in reversed(chunk.strip().splitlines()):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "ts" in rec:
            return rec
    return None


def check_stragglers(now: Optional[float] = None) -> Dict[int, float]:
    """Host-0 aggregation: tail every ``host-*.jsonl``, compare each
    host's newest step-completion wall time against the gang median,
    and flag hosts lagging by more than the straggler threshold —
    edge-triggered ``train_straggler`` event + the worst lag on
    ``stpu_train_host_skew_seconds``. Returns {host: lag_s} for hosts
    currently over threshold. Rate-limited to one scan per
    ``STRAGGLER_SCAN_MIN_S`` when called from the hot recorder."""
    global _last_scan_mono, _host_skew_s, _straggling
    with _lock:
        out_dir = _out_dir
        threshold = _straggler_s
        hosts = _hosts
        job = _job
        mono = time.perf_counter()
        if now is None and mono - _last_scan_mono < STRAGGLER_SCAN_MIN_S:
            return {}
        _last_scan_mono = mono
    if out_dir is None or hosts < 2 or threshold <= 0:
        return {}
    latest: Dict[int, Dict[str, Any]] = {}
    try:
        names = os.listdir(out_dir)
    except OSError:
        return {}
    for name in names:
        if not (name.startswith("host-") and name.endswith(".jsonl")):
            continue
        try:
            rank = int(name[len("host-"):-len(".jsonl")])
        except ValueError:
            continue
        rec = _tail_record(os.path.join(out_dir, name))
        if rec is not None:
            latest[rank] = rec
    if len(latest) < 2:
        return {}
    median_ts = statistics.median(r["ts"] for r in latest.values())
    lagging: Dict[int, float] = {}
    worst = 0.0
    for rank, rec in latest.items():
        lag = median_ts - float(rec["ts"])
        worst = max(worst, lag)
        if lag > threshold:
            lagging[rank] = round(lag, 3)
    with _lock:
        _host_skew_s = max(worst, 0.0)
        fresh = set(lagging) - _straggling
        _straggling = set(lagging)
    _HOST_SKEW.set(max(worst, 0.0))
    if fresh:
        from skypilot_tpu_torch.observability import events
        for rank in sorted(fresh):
            events.emit("train", job or "train", "train_straggler",
                        host=rank, lag_s=lagging[rank],
                        step=latest[rank].get("step"))
    return lagging


# -------------------------------------------------------- sampled sync
def sync_due() -> bool:
    """True on every STPU_TRAINSTATS_SYNC_EVERY-th call (0 = never).
    The train loop asks once per step; the module owns the counter so
    restarted loops keep the cadence."""
    global _sync_count
    if _sync_every <= 0:
        return False
    _sync_count += 1
    if _sync_count >= _sync_every:
        _sync_count = 0
        return True
    return False


def sampled_sync(value: Any) -> float:
    """THE sanctioned device sync of the train hot loop: one timed wait
    for a step's output, returning the wait in seconds. A CUDA tensor
    waits on ``torch.cuda.synchronize`` of its device (everything queued
    there, the step whose output it is included); a CPU tensor or a
    non-tensor waits on nothing (tests, the CPU path)."""
    t0 = time.perf_counter()
    device = getattr(value, "device", None)
    if getattr(device, "type", None) == "cuda":
        import torch
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


# ------------------------------------------------------------ snapshot
def snapshot() -> Dict[str, Any]:
    """One JSON-ready document over the current ring: step/token
    rates, live MFU, the goodput breakdown, gang skew. Written as
    ``snapshot.json`` for the jobs controller and embedded in flight
    dumps."""
    with _lock:
        window = _ring.window_s()
        steps = _ring.count
        last = _ring.newest()
        tok_s = _ring.tok_sum / window if window else 0.0
        mfu = None
        if _flops_per_token and _peak_flops > 0:
            mfu = round(tok_s * _flops_per_token / _peak_flops, 4)
        denom = window + _downtime_s
        doc: Dict[str, Any] = {
            "armed": ENABLED,
            "ring_size": _ring.size,
            "steps": steps,
            "total_steps": _ring.seq,
            "window_s": round(window, 6),
            "step_seconds_mean": round(_ring.dur_sum / steps, 6)
            if steps else 0.0,
            "steps_per_sec": round(steps / window, 3) if window
            else 0.0,
            "tokens_per_sec": round(tok_s, 1),
            "mfu": mfu,
            "goodput": _goodput_locked(window, denom),
            "downtime_s": round(_downtime_s, 3),
            "host": _host,
            "hosts": _hosts,
            "job": _job,
            "host_skew_s": round(_host_skew_s, 3),
            "stragglers": sorted(_straggling),
        }
        if last is not None:
            # The delayed fetch attaches loss/grad_norm one step late,
            # so the NEWEST record never has them yet — surface the
            # newest record that does (normally the one before last).
            lossy = next((r for r in reversed(_ring.ordered())
                          if r["loss"] is not None
                          or r["grad_norm"] is not None), None)
            doc["last"] = {
                "step": last["step"],
                "loss": lossy["loss"] if lossy else None,
                "grad_norm": lossy["grad_norm"] if lossy else None,
            }
            if lossy is not None:
                doc["last"]["loss_step"] = lossy["step"]
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
        return doc


def steps_tail(n: int = 0) -> List[Dict[str, Any]]:
    """The last ``n`` step records, oldest first (0 = whole ring)."""
    with _lock:
        recs = _ring.ordered()
    return recs[-n:] if n else recs


# ------------------------------------------------------ flight recorder
def flightrec_dir(dir_path: Optional[str] = None) -> str:
    """Dump directory: inside the configured out_dir when the run has
    one (so a managed job's dumps survive under its ckpt dir for the
    controller and CLI), else ``~/.stpu/logs/flightrec_train/``."""
    if dir_path is None:
        dir_path = (os.path.join(_out_dir, "flightrec") if _out_dir
                    else None)
    if dir_path is None:
        from skypilot_tpu_torch.utils import paths
        dir_path = str(paths.logs_dir() / "flightrec_train")
    os.makedirs(dir_path, exist_ok=True)
    return str(dir_path)


def _dump_doc(doc: Dict[str, Any], reason: str,
              dir_path: Optional[str]) -> Optional[str]:
    global _dump_seq
    with _lock:
        _dump_seq += 1
        seq = _dump_seq
    now = doc["ts"]
    stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
    micros = int(now % 1.0 * 1e6)
    name = (f"{stamp}.{micros:06d}-{reason}-{os.getpid()}"
            f"-{seq:06d}.json")
    try:
        root = flightrec_dir(dir_path)
        path = os.path.join(root, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
    except OSError:
        return None
    _DUMPS.labels(reason=reason).inc()
    _prune_dumps(dir_path=root)
    return path


def dump_flight(reason: str, error: Optional[str] = None,
                extra: Optional[Dict[str, Any]] = None
                ) -> Optional[str]:
    """Write this process's ring + aggregate snapshot + terminal
    exception atomically (temp + ``os.replace``). The recipe crash
    paths and SIGTERM handlers call it; returns the path, or None on
    any I/O failure — a post-mortem artifact must never crash the
    crash path it documents."""
    from skypilot_tpu_torch.observability import events
    doc = {
        "version": 1,
        "reason": reason,
        "ts": time.time(),
        "run_id": events.run_id(),
        "pid": os.getpid(),
        "host": _host,
        "error": error,
        "snapshot": snapshot(),
        "steps": steps_tail(),
    }
    if extra:
        doc.update(extra)
    return _dump_doc(doc, reason, None)


def dump_dir_flight(reason: str, dir_path: str,
                    tail: int = 64) -> Optional[str]:
    """Synthesize a gang-wide flight dump from a trainstats directory
    (``host-*.jsonl`` tails + the last ``snapshot.json``) — the jobs
    controller's post-mortem path when a task is preempted/killed and
    the training processes can no longer dump themselves. Written to
    ``<dir_path>/flightrec/``."""
    hosts: Dict[str, List[Dict[str, Any]]] = {}
    try:
        names = os.listdir(dir_path)
    except OSError:
        return None
    for name in sorted(names):
        if not (name.startswith("host-") and name.endswith(".jsonl")):
            continue
        rank = name[len("host-"):-len(".jsonl")]
        recs: List[Dict[str, Any]] = []
        try:
            with open(os.path.join(dir_path, name)) as f:
                for line in f:
                    try:
                        recs.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
        hosts[rank] = recs[-tail:] if tail else recs
    snap = None
    try:
        with open(os.path.join(dir_path, "snapshot.json")) as f:
            snap = json.load(f)
    except (OSError, ValueError):
        pass
    if not hosts and snap is None:
        return None
    doc = {
        "version": 1,
        "reason": reason,
        "ts": time.time(),
        "pid": os.getpid(),
        "synthesized": True,
        "snapshot": snap,
        "hosts": hosts,
    }
    return _dump_doc(doc, reason,
                     os.path.join(dir_path, "flightrec"))


def _prune_dumps(keep: Optional[int] = None,
                 dir_path: Optional[str] = None) -> None:
    """Drop the oldest dumps past the retention cap (stamped names
    sort chronologically). Best-effort, like every sink here."""
    if keep is None:
        keep = KEEP_DUMPS
    if keep <= 0:
        return
    try:
        root = flightrec_dir(dir_path)
        names = sorted(n for n in os.listdir(root)
                       if n.endswith(".json"))
        for name in names[:-keep]:
            os.unlink(os.path.join(root, name))
    except OSError:
        pass


def list_dumps(dir_path: Optional[str] = None) -> List[str]:
    """Recorded training flight dumps, oldest first (file names)."""
    try:
        names = sorted(os.listdir(flightrec_dir(dir_path)))
    except OSError:
        return []
    return [n for n in names if n.endswith(".json")]


def read_dump(name: Optional[str] = None,
              dir_path: Optional[str] = None) -> Dict[str, Any]:
    """Load one dump by file name, path, or unique prefix; ``None`` =
    the newest. Raises FileNotFoundError/ValueError on no/ambiguous
    match (the CLI turns these into clean errors)."""
    if name and os.path.sep in str(name) and os.path.exists(name):
        path = str(name)
    else:
        dumps = list_dumps(dir_path)
        if not dumps:
            raise FileNotFoundError(
                "no training flight dumps recorded (arm "
                f"{ENABLE_ENV}=1 and crash/restart a train loop)")
        if name is None:
            target = dumps[-1]
        else:
            matches = [d for d in dumps if d.startswith(str(name))]
            if not matches:
                raise FileNotFoundError(f"no dump matches {name!r}")
            if len(matches) > 1:
                raise ValueError(
                    f"{name!r} is ambiguous ({len(matches)} dumps)")
            target = matches[0]
        path = os.path.join(flightrec_dir(dir_path), target)
    with open(path) as f:
        doc = json.load(f)
    doc.setdefault("path", path)
    return doc


# Arm from the environment at import: operators export
# STPU_TRAINSTATS=1 and every host in the gang picks it up.
if os.environ.get(ENABLE_ENV, "0") == "1":
    arm()
