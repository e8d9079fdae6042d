"""HF transformers ``Trainer`` integration for the benchmark harness: the
counterpart of the JAX package's ``integrations/transformers.py``. Add it
to any Trainer and the harness times the steps of the user's training
code unchanged:

    from skypilot_tpu_torch.integrations.transformers import (
        SkyTransformersCallback)
    trainer = Trainer(model=..., args=...,
                      callbacks=[SkyTransformersCallback()])

A no-op unless the harness exported ``STPU_BENCHMARK_LOG_DIR``. Without
``transformers`` installed the module still imports, and the callback is
a plain class.
"""
from __future__ import annotations

from skypilot_tpu_torch import callbacks

try:
    from transformers import TrainerCallback as _TrainerCallback
except ImportError:  # transformers not installed: a plain base class,
    _TrainerCallback = object  # so that importing this module works


class SkyTransformersCallback(_TrainerCallback):
    """TrainerCallback bridging the Trainer's step events to the port's
    step recorder."""

    def on_train_begin(self, args, state, control, **kwargs):
        callbacks.init(total_steps=getattr(state, "max_steps", None) or None)

    def on_step_begin(self, args, state, control, **kwargs):
        callbacks.step_begin()

    def on_step_end(self, args, state, control, **kwargs):
        callbacks.step_end()

    def on_train_end(self, args, state, control, **kwargs):
        callbacks.flush()
