"""Train-step integration for the benchmark harness: the counterpart of
the JAX package's ``integrations/flax.py`` (``wrap_train_step``, which
wraps a jitted flax/optax step there; here any step function, a torch
step or a compiled one).

    step = wrap_train_step(make_train_step(...), total_steps=1000)
    for batch in loader:
        state, metrics = step(state, batch)

Timing: a step on the card returns once its work is queued, but the
steady-state seconds a step the recorder computes is still the device's
rate: the queue fills and dispatch waits for the device, so the wall
time between completed calls converges to the device's step time. The
recorder leaves the first (warm-up) step out.
"""
from __future__ import annotations

import atexit
import functools
from typing import Callable, Optional

from skypilot_tpu_torch import callbacks


def wrap_train_step(step_fn: Callable, *,
                    total_steps: Optional[int] = None) -> Callable:
    """Wrap a train step so each call is one benchmark step.

    Arms the recorder on the first call (``callbacks.init`` is a no-op
    outside a benchmark run, so wrapping is always safe). A recorder
    already live is kept (wrapping a second function, an eval step say,
    must not reset its timings), and an armed one is flushed at exit, so
    short runs (fewer steps than the recorder's ``write_every``) still
    land their summary without the user calling ``flush``.
    """
    armed = []

    @functools.wraps(step_fn)
    def wrapped(*args, **kwargs):
        if not armed:
            if callbacks._state is None:  # noqa: SLF001 - arm once
                if callbacks.init(total_steps=total_steps):
                    atexit.register(callbacks.flush)
            armed.append(True)
        callbacks.step_begin()
        out = step_fn(*args, **kwargs)
        callbacks.step_end()
        return out

    return wrapped
