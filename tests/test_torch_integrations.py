"""The port's step-callback integrations (``skypilot_tpu_torch.
integrations``) over its step recorder (``skypilot_tpu_torch.callbacks``):
the JAX package's ``tests/test_benchmark.py`` integration tests, on the
port's modules. The train-step wrapper times each call and writes the
summary; the transformers callback drives the same recorder through the
``TrainerCallback`` events; both are no-ops without the harness's env.
The mnist recipe writes the summary through ``step_iterator``.
"""
import json

import pytest

from skypilot_tpu_torch import callbacks
from skypilot_tpu_torch.integrations.train_step import wrap_train_step


@pytest.fixture
def recorder(monkeypatch):
    """An isolated recorder: none armed before or after the test."""
    monkeypatch.setattr(callbacks, "_state", None)
    yield
    callbacks._state = None


def test_wrap_train_step_records(tmp_path, monkeypatch, recorder):
    monkeypatch.setenv(callbacks.ENV_LOG_DIR, str(tmp_path))
    calls = []

    def step(state, batch):
        calls.append(batch)
        return state

    wrapped = wrap_train_step(step, total_steps=5)
    assert wrapped.__name__ == "step"
    s = 0
    for i in range(5):
        s = wrapped(s, i)
    callbacks.flush()
    summary = json.loads((tmp_path / callbacks.SUMMARY_NAME).read_text())
    assert summary["num_steps"] == 5
    assert summary["total_steps"] == 5
    assert calls == [0, 1, 2, 3, 4]


def test_second_wrapper_keeps_the_live_recorder(tmp_path, monkeypatch,
                                                recorder):
    monkeypatch.setenv(callbacks.ENV_LOG_DIR, str(tmp_path))
    train = wrap_train_step(lambda s: s, total_steps=3)
    for _ in range(3):
        train(0)
    live = callbacks._state
    wrap_train_step(lambda s: s)(0)
    assert callbacks._state is live and live.num_steps == 4


def test_transformers_callback_records(tmp_path, monkeypatch, recorder):
    pytest.importorskip("transformers")  # not a declared dependency
    from transformers import TrainerCallback

    from skypilot_tpu_torch.integrations.transformers import (
        SkyTransformersCallback)
    monkeypatch.setenv(callbacks.ENV_LOG_DIR, str(tmp_path))
    cb = SkyTransformersCallback()
    assert isinstance(cb, TrainerCallback)

    class _State:
        max_steps = 3

    cb.on_train_begin(None, _State(), None)
    for _ in range(3):
        cb.on_step_begin(None, _State(), None)
        cb.on_step_end(None, _State(), None)
    cb.on_train_end(None, _State(), None)
    summary = json.loads((tmp_path / callbacks.SUMMARY_NAME).read_text())
    assert summary["num_steps"] == 3
    assert summary["total_steps"] == 3


def test_integrations_noop_without_env(monkeypatch, tmp_path, recorder):
    monkeypatch.delenv(callbacks.ENV_LOG_DIR, raising=False)
    wrapped = wrap_train_step(lambda s, b: s)
    for i in range(3):
        wrapped(0, i)
    assert callbacks._state is None
    assert not list(tmp_path.iterdir())


def test_mnist_writes_the_benchmark_summary(tmp_path, monkeypatch,
                                            recorder):
    from skypilot_tpu_torch.recipes import mnist
    monkeypatch.setenv(callbacks.ENV_LOG_DIR, str(tmp_path))
    mnist.main(["--device", "cpu", "--steps", "12", "--batch-size", "16"])
    summary = json.loads((tmp_path / callbacks.SUMMARY_NAME).read_text())
    assert summary["num_steps"] == 12 and summary["total_steps"] == 12
    assert summary["seconds_per_step"] > 0
