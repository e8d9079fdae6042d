"""The port's copy of the JAX package's ``observability/reqlog.py`` (it imports
nothing of that package): arming, the sampling rule, the record writer
and ``read`` (the load balancer's ``/requests``), as there; the CLI's
``is_slow`` is not copied.

Wide-event request analytics: ONE joined record per served request.

Every observability layer so far is aggregate (metrics), sampled
(tracing), or per-step (stepstats/trainstats); none answers "what
happened to THIS request" or "what does our real traffic look like".
This module is the per-request substrate: the LB and the engine each
assemble their half of a wide event, the engine ships its half to the
LB as a trailing ``stats`` SSE frame (stripped before the client sees
the stream), and the LB writes ONE joined JSONL record to
``~/.stpu/logs/requests.jsonl`` keyed by the trace id that already
rides ``X-STPU-Trace`` (reqlog mints ids itself when tracing is
disarmed, so the two layers arm independently).

Record shape (one JSON object per line; engine-half fields absent when
the replica predates the stats frame — LB-only degradation):

    {"request_id": <32 hex>, "ts": <wall arrival>, "status": "200",
     "error": null, "method": "POST", "path": "/generate",
     "replica": "http://...", "policy": "...", "attempts": 1,
     "retries": 0, "resumed": false, "resume_outcome": null,
     "ttft_s": ..., "e2e_s": ..., "bytes_streamed": ...,
     "prompt_tokens": ..., "max_tokens": ..., "prefix_hash": <16 hex>,
     "trace_sampled": false, "run_id": ...,
     "engine": {"queue_wait_s": ..., "prompt_tokens": ...,
                "cached_prompt_tokens": ..., "generated_tokens": ...,
                "kv_tier": "hbm|host|miss", "spec_drafted": ...,
                "spec_accepted": ..., "ttft_s": ...,
                "device_time_s": ..., "kv_quant": ...,
                "weight_quant": ..., "restarts": ...}}

``prefix_hash`` is a hash of the request's LEADING prompt chunk — the
log never stores prompt text/tokens, yet ``loadgen.derive_spec`` can
still recover the prefix-reuse structure (how many distinct prefixes,
how shared) for replay. ``engine.device_time_s`` is the request's
device-time share, accumulated host-side as ``step_dur/live_slots``
per decode step — the cost-attribution number multi-tenant billing
needs.

Tail-biased sampling (the write-time contract): ``STPU_REQLOG_SAMPLE``
in [0, 1] thins SUCCESSFUL requests only. Errors, resumed streams, and
requests whose TTFT/e2e exceed ``STPU_REQLOG_SLOW_TTFT`` /
``STPU_REQLOG_SLOW_E2E`` seconds are ALWAYS written — the tail is the
point of a request log, so it is never sampled away. A kept-for-cause
record carries ``keep`` ("error" | "resumed" | "slow_ttft" |
"slow_e2e") so readers can distinguish biased keeps from the uniform
sample.

Overhead discipline (mirror of tracing.py / fault_injection.py):
reqlog is OFF by default; hot call sites guard with the module
attribute ``ENABLED`` (``if reqlog.ENABLED: ...``) so the unarmed cost
is one global load and a falsy branch — no record dicts, no clock
reads, no hashing. Arm with ``STPU_REQLOG=1`` (every process picks it
up at import) or ``arm()`` in tests. Sink I/O failures are swallowed,
exactly like events.emit — analytics must never break the request.
"""
from __future__ import annotations

import json
import os
import random
import threading
import uuid
from typing import Any, Dict, List, Optional

ENABLE_ENV = "STPU_REQLOG"
SAMPLE_ENV = "STPU_REQLOG_SAMPLE"
SLOW_TTFT_ENV = "STPU_REQLOG_SLOW_TTFT"
SLOW_E2E_ENV = "STPU_REQLOG_SLOW_E2E"

# Hot-path guard (see module docstring). Call sites read this module
# attribute before paying for anything else.
ENABLED = False

# Requests are higher-volume than events but each record is small; same
# cap + one-generation policy as traces.jsonl.
_MAX_BYTES = 16 * 1024 * 1024

_lock = threading.Lock()
_rng = random.Random()
_sample_rate = 1.0
_slow_ttft_s = 1.0
_slow_e2e_s = 10.0


def requests_path() -> "os.PathLike[str]":
    from skypilot_tpu_torch.utils import paths
    return paths.logs_dir() / "requests.jsonl"


def _env_float(env: str, default: str) -> float:
    try:
        return float(os.environ.get(env, default))
    except ValueError:
        return float(default)


# ------------------------------------------------------------- arming
def arm(sample: Optional[float] = None,
        slow_ttft: Optional[float] = None,
        slow_e2e: Optional[float] = None) -> None:
    """Turn the request log on (idempotent). Keyword overrides beat the
    STPU_REQLOG_SAMPLE / _SLOW_TTFT / _SLOW_E2E env knobs for this
    process (tests)."""
    global ENABLED, _sample_rate, _slow_ttft_s, _slow_e2e_s
    if sample is None:
        sample = _env_float(SAMPLE_ENV, "1")
    _sample_rate = min(max(float(sample), 0.0), 1.0)
    _slow_ttft_s = (float(slow_ttft) if slow_ttft is not None
                    else _env_float(SLOW_TTFT_ENV, "1.0"))
    _slow_e2e_s = (float(slow_e2e) if slow_e2e is not None
                   else _env_float(SLOW_E2E_ENV, "10.0"))
    ENABLED = True


def disarm() -> None:
    global ENABLED
    ENABLED = False


def slow_thresholds() -> "tuple[float, float]":
    """(slow_ttft_s, slow_e2e_s) currently in force — the CLI's
    ``--slow`` filter uses the same line the writer drew."""
    return _slow_ttft_s, _slow_e2e_s


# ---------------------------------------------------------------- ids
def mint_id() -> str:
    """A fresh request id, same shape as a trace id (32 hex) so the two
    key spaces interchange: when tracing is armed the trace id IS the
    request id; when only reqlog is armed the LB mints one here and
    still rides it on X-STPU-Trace (sampled flag 00) so the engine half
    joins by the same key."""
    return uuid.uuid4().hex


# ------------------------------------------------------------ sampling
def keep_reason(record: Dict[str, Any]) -> Optional[str]:
    """Why this record bypasses sampling, or None for a plain success
    (which is subject to the uniform sample). Pure — decided from the
    record alone, so the contract is testable without I/O."""
    status = str(record.get("status", ""))
    if record.get("error") or status not in ("ok", "200"):
        return "error"
    if record.get("resumed"):
        return "resumed"
    ttft = record.get("ttft_s")
    if isinstance(ttft, (int, float)) and ttft >= _slow_ttft_s:
        return "slow_ttft"
    e2e = record.get("e2e_s")
    if isinstance(e2e, (int, float)) and e2e >= _slow_e2e_s:
        return "slow_e2e"
    return None


def write_record(record: Dict[str, Any]) -> bool:
    """Append one joined request record, applying the tail-biased
    sampling contract at this single write point. Returns whether the
    record was written (tests pin the always-keep classes on this).
    Never raises."""
    if not ENABLED:
        return False
    reason = keep_reason(record)
    if reason is not None:
        record["keep"] = reason
    elif _sample_rate < 1.0 and _rng.random() >= _sample_rate:
        return False
    _write(record)
    return True


# ---------------------------------------------------------------- sink
def _write(record: Dict[str, Any]) -> None:
    """Shared rotate+append path with the event/trace logs
    (observability/jsonl_log.py). Never raises."""
    from skypilot_tpu_torch.observability import jsonl_log
    try:
        line = json.dumps(record, default=str)
    except (TypeError, ValueError):
        return
    try:
        path = requests_path()
    except OSError:
        return
    jsonl_log.append_line(path, line, _MAX_BYTES, _lock)


# -------------------------------------------------------------- reading
def read(path: Optional[str] = None,
         request_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """All request records (rotated generation included, oldest first);
    garbage lines skipped — a crash mid-append leaves at most one
    truncated line. ``request_id`` accepts an unambiguous prefix (the
    trace-id abbreviation convention)."""
    target = str(path or requests_path())
    out: List[Dict[str, Any]] = []
    for p in (target + ".1", target):
        try:
            with open(p, "r", errors="replace") as f:
                data = f.read()
        except OSError:
            continue
        for line in data.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict) or "request_id" not in rec:
                continue
            if (request_id is not None
                    and not str(rec["request_id"]).startswith(request_id)):
                continue
            out.append(rec)
    return out


# Arm from the environment at import: operators export STPU_REQLOG=1
# and every process in the serving stack picks it up.
if os.environ.get(ENABLE_ENV, "0") == "1":
    arm()
