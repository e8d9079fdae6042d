"""Training-loop hooks of the port: the counterpart of
``skypilot_tpu/callbacks.py``, its step recorder and its
``device_profile``.

The step recorder feeds a benchmark harness, as the JAX package's does. A
recipe calls::

    from skypilot_tpu_torch import callbacks
    callbacks.init(total_steps=...)      # no-op unless benchmarking
    for batch in callbacks.step_iterator(batches):
        ...

When the harness launched the task it exports ``STPU_BENCHMARK_LOG_DIR``;
the recorder then writes ``benchmark_summary.json`` there (the JAX
module's fields, its seconds per step excluding the first step) for the
harness to collect. Outside a benchmark the calls cost one env lookup and
do nothing, so recipes keep them unconditionally.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import time
from typing import Iterable, Iterator, Optional

import torch

ENV_LOG_DIR = "STPU_BENCHMARK_LOG_DIR"
SUMMARY_NAME = "benchmark_summary.json"
PROFILE_DIR_ENV = "STPU_PROFILE_DIR"

_state: Optional["_Recorder"] = None


class _Recorder:
    def __init__(self, log_dir: str, total_steps: Optional[int],
                 write_every: int = 10):
        self.path = os.path.join(os.path.expanduser(log_dir),
                                 SUMMARY_NAME)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.total_steps = total_steps
        self.write_every = write_every
        self.t0 = time.time()
        self.num_steps = 0
        self.first_step_done: Optional[float] = None
        self.last_step_done: Optional[float] = None

    def step_begin(self) -> None:
        # Timing derives from step_end timestamps only (steady-state
        # rate); step_begin exists for the API's symmetry.
        pass

    def step_end(self) -> None:
        now = time.time()
        self.num_steps += 1
        if self.first_step_done is None:
            self.first_step_done = now
        self.last_step_done = now
        if self.num_steps % self.write_every == 0:
            self.flush()

    def summary(self) -> dict:
        # Steady-state seconds/step excludes the first step (warm-up).
        steady = None
        if (self.num_steps > 1 and self.first_step_done is not None
                and self.last_step_done is not None):
            steady = ((self.last_step_done - self.first_step_done) /
                      (self.num_steps - 1))
        return {
            "num_steps": self.num_steps,
            "total_steps": self.total_steps,
            "started_at": self.t0,
            "first_step_done_at": self.first_step_done,
            "last_step_done_at": self.last_step_done,
            "seconds_per_step": steady,
        }

    def flush(self) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.summary(), f)
        os.replace(tmp, self.path)


def init(total_steps: Optional[int] = None,
         log_dir: Optional[str] = None) -> bool:
    """Arm the recorder. Returns True when benchmarking is active."""
    global _state
    log_dir = log_dir or os.environ.get(ENV_LOG_DIR)
    if not log_dir:
        _state = None
        return False
    _state = _Recorder(log_dir, total_steps)
    _state.flush()
    return True


def step_begin() -> None:
    if _state is not None:
        _state.step_begin()


def step_end() -> None:
    if _state is not None:
        _state.step_end()


def step_iterator(iterable: Iterable) -> Iterator:
    """Wrap a batch iterator, timing each loop body as one step."""
    for item in iterable:
        step_begin()
        yield item
        step_end()


def flush() -> None:
    if _state is not None:
        _state.flush()


@contextlib.contextmanager
def device_profile() -> Iterator[None]:
    """Profile the wrapped loop with ``torch.profiler`` (CPU and, when a
    card is present, CUDA activity) when ``STPU_PROFILE_DIR`` is set, and
    write a Chrome trace there on exit, also when the loop raises; a no-op
    otherwise, so recipes leave it on."""
    target = os.environ.get(PROFILE_DIR_ENV)
    if not target:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(target)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    try:
        with prof:
            yield
    finally:
        prof.export_chrome_trace(str(out / f"trace-{os.getpid()}.json"))
