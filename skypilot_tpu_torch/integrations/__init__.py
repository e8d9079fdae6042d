"""Step-callback integrations for the benchmark harness: the counterpart
of the JAX package's ``integrations/`` (its ``flax.py`` is
``train_step.py`` here, its ``transformers.py`` is ``transformers.py``).

They let the harness time a user's own training loop unchanged, over the
port's step recorder (``skypilot_tpu_torch.callbacks``)::

    # any python loop:
    from skypilot_tpu_torch import callbacks
    for batch in callbacks.step_iterator(loader): ...

    # a train-step function (a torch step, compiled or not):
    from skypilot_tpu_torch.integrations.train_step import wrap_train_step
    train_step = wrap_train_step(train_step)

    # HF transformers Trainer:
    from skypilot_tpu_torch.integrations.transformers import (
        SkyTransformersCallback)
    trainer = Trainer(..., callbacks=[SkyTransformersCallback()])

All of them are no-ops unless the harness exported
``STPU_BENCHMARK_LOG_DIR`` (``callbacks.init``'s contract).
"""
