"""The port's copy of the JAX package's ``observability/events.py`` (it imports
nothing of that package): ``emit`` and ``run_id``, as there; its readers
(``read``, ``last``, the CLI's ``--since`` parser) are not copied.

Structured JSONL lifecycle-event log.

Reference analog: the reference scatters lifecycle breadcrumbs across
per-subsystem logs (skylet events log, serve controller prints,
jobs controller prints); here every state transition lands in ONE
append-only JSONL file so `stpu status --events` / `stpu serve status`
can answer "what just happened" without grepping five logs.

Record shape (one JSON object per line):

    {"ts": <wall seconds>, "mono": <perf_counter seconds>,
     "run_id": "abc123def456", "kind": "replica",
     "name": "svc/3", "event": "READY", ...free-form fields}

``ts`` is wall clock for cross-host alignment; ``mono`` is the
process-local monotonic stamp so in-process durations between two
events survive NTP steps. ``run_id`` identifies the originating CLI
invocation and propagates through ``STPU_RUN_ID`` (subprocess env) and
the gang job spec, CLI -> controller -> gang driver -> job env.

Emission must never break the instrumented call: all I/O errors are
swallowed. Disable entirely with ``STPU_DISABLE_EVENTS=1``.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Dict

DISABLE_ENV = "STPU_DISABLE_EVENTS"
RUN_ID_ENV = "STPU_RUN_ID"

# Rotate past this size: events.jsonl -> events.jsonl.1 (one generation
# kept). Lifecycle transitions are low-rate; 4 MB is months of them.
_MAX_BYTES = 4 * 1024 * 1024

_lock = threading.Lock()


def _enabled() -> bool:
    return os.environ.get(DISABLE_ENV, "0") != "1"


def run_id() -> str:
    """This invocation's run ID. First call generates one and exports it
    via the environment so every child process (serve controller, LB,
    jobs controller, gang driver) inherits the same ID."""
    rid = os.environ.get(RUN_ID_ENV)
    if not rid:
        rid = uuid.uuid4().hex[:12]
        os.environ[RUN_ID_ENV] = rid
    return rid


def log_path() -> "os.PathLike[str]":
    from skypilot_tpu_torch.utils import paths
    return paths.logs_dir() / "events.jsonl"


def emit(kind: str, name: str, event: str, **fields: Any) -> None:
    """Append one lifecycle record. Never raises."""
    if not _enabled():
        return
    record: Dict[str, Any] = {
        "ts": time.time(),
        "mono": time.perf_counter(),
        "run_id": run_id(),
        "kind": kind,
        "name": name,
        "event": event,
    }
    record.update(fields)
    try:
        line = json.dumps(record, default=str)
    except (TypeError, ValueError):
        return
    from skypilot_tpu_torch.observability import jsonl_log
    try:
        path = log_path()
    except OSError:
        return
    jsonl_log.append_line(path, line, _MAX_BYTES, _lock)
