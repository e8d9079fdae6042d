"""Training-loop hooks of the port: the counterpart of
``skypilot_tpu/callbacks.py``'s ``device_profile``.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
from typing import Iterator

import torch


PROFILE_DIR_ENV = "STPU_PROFILE_DIR"


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
