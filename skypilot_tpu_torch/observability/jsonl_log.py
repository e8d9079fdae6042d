"""The port's copy of the JAX package's ``observability/jsonl_log.py`` (it imports
nothing of that package); names and behaviour are as there.

Shared append path for the observability JSONL logs.

The lifecycle event log (events.py) and the trace sink (tracing.py)
both append one JSON object per line to a log under
``~/.stpu/logs/``, rotate at a size cap keeping exactly ONE ``.1``
generation, and must never raise into the instrumented call. That
durability-critical write path lives HERE once, so a fix to it
(rotation policy, fsync discipline) cannot land in one log and
silently miss the other. The readers stay per-module: their access
patterns genuinely differ (events tails bounded byte windows and
filters by kind/name/time; tracing reads whole generations and groups
by trace id).
"""
from __future__ import annotations

import os


def rotate_if_needed(path, max_bytes: int) -> None:
    """current -> current.1 once the size cap is crossed (the previous
    ``.1`` is overwritten: one retained generation). Never raises."""
    try:
        if path.stat().st_size < max_bytes:
            return
        os.replace(path, str(path) + ".1")
    except OSError:
        pass


def append_line(path, line: str, max_bytes: int, lock) -> None:
    """Append one record line under ``lock`` (the caller's module
    lock), rotating first if needed. I/O failures are swallowed —
    telemetry must never break the instrumented call."""
    try:
        with lock:
            rotate_if_needed(path, max_bytes)
            with open(path, "a") as f:
                f.write(line + "\n")
    except OSError:
        pass
