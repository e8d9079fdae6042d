"""The port's checkpoints (skypilot_tpu_torch.train.checkpoint) and the
port's LoRA recipe's resume, on the CPU.

* A tree with bf16, f32 and int64 tensors, a numpy scalar and None
  round-trips byte for byte, dtypes included (bf16 read back as
  ``torch.bfloat16``).
* A checkpoint written by the port is restored by the JAX package's
  ``checkpoint.restore_latest``, and one written by the JAX package by the
  port's, every leaf's bytes equal (bf16 as its 16 bits either way).
* A torn ``.tmp`` (the payload write killed between the bytes and the
  rename, through the ``ckpt.write`` seam) and a payload whose sha256 no
  longer matches are skipped for the newest valid checkpoint.
* The recipe on the CPU: 6 steps then resumed to 10 writes the same final
  payload (adapters, optimizer state, step, data position, RNG state) as
  10 steps uninterrupted; a run killed by ``train.step:kill`` after step 5
  resumes from step 4 to the same payload and final loss. Its state tree
  has the JAX recipe's keys, shapes and dtypes (the RNG leaf aside).
* SIGTERM: the grace handler's flag, and the recipe's save-then-exit-143.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap

import jax
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.recipes import llama_lora as lora_jax
from skypilot_tpu.train import checkpoint as ck_jax
from skypilot_tpu_torch.recipes import llama_lora as lora_torch
from skypilot_tpu_torch.train import checkpoint as ck
from skypilot_tpu_torch.utils import fault_injection as fi

REPO = pathlib.Path(__file__).resolve().parent.parent
RECIPE_ARGS = ["--device", "cpu", "--model", "tiny", "--batch-size", "2",
               "--seq-len", "32", "--ckpt-every", "2", "--ckpt-sync"]


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "opt": [torch.randn(4, generator=g),
                    (torch.arange(6, dtype=torch.int64).reshape(2, 3),
                     None)],
            "step": np.int64(7)}


def _bytes(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def test_roundtrip_bit_identical(tmp_path):
    tree = _tree()
    ck.save(tmp_path, 3, tree)
    got = ck.restore_latest(tmp_path, like=tree)
    assert got.step == 3
    want = dict(ck.flatten_tree(tree))
    for key, leaf in ck.flatten_tree(got.tree):
        if want[key] is None:
            assert leaf is None
            continue
        assert isinstance(leaf, torch.Tensor), key
        ref_dtype = (want[key].dtype if isinstance(want[key], torch.Tensor)
                     else torch.int64)
        assert leaf.dtype == ref_dtype, key
        assert _bytes(leaf) == _bytes(want[key]), key


def test_port_checkpoint_read_by_jax(tmp_path):
    tree = _tree()
    ck.save(tmp_path, 5, tree, meta={"by": "port"})
    got = ck_jax.restore_latest(tmp_path)
    assert got.step == 5 and got.meta == {"by": "port"}
    flat = dict(ck.flatten_tree(tree))
    assert set(got.tree) == set(flat)
    assert got.tree["w"].dtype == ml_dtypes.bfloat16
    for key, arr in got.tree.items():
        if flat[key] is None:
            assert arr is None
            continue
        assert arr.tobytes() == _bytes(flat[key]), key


def test_jax_checkpoint_read_by_port(tmp_path):
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
            "b": rng.standard_normal(5).astype(np.float32),
            "c": (np.arange(4, dtype=np.int64), np.uint32([0, 42]))}
    ck_jax.save(tmp_path, 9, tree)
    got = ck.restore_latest(tmp_path)
    assert got.step == 9
    assert got.tree["a"].dtype == torch.bfloat16
    assert got.tree["b"].dtype == torch.float32
    for key, arr in ck_jax.flatten_tree(tree):
        assert _bytes(got.tree[key]) == arr.tobytes(), key
    # Payloads of the same tree are the same bytes from either package.
    port_dir = tmp_path / "port"
    ck.save(port_dir, 9, got.tree)
    assert (port_dir / "ckpt-00000009.bin").read_bytes() == (
        tmp_path / "ckpt-00000009.bin").read_bytes()


def test_restore_skips_torn_and_corrupt(tmp_path):
    ck.save(tmp_path, 1, {"w": torch.arange(8)})
    ck.save(tmp_path, 2, {"w": torch.arange(8) * 2})
    ck.save(tmp_path, 3, {"w": torch.arange(8) * 3})
    payload = tmp_path / "ckpt-00000003.bin"
    data = bytearray(payload.read_bytes())
    data[0] ^= 0xFF
    payload.write_bytes(bytes(data))           # sha256 no longer matches
    (tmp_path / "ckpt-00000002.bin").write_bytes(b"torn")  # short payload
    (tmp_path / "ckpt-00000004.bin.tmp-1").write_bytes(b"x")
    got = ck.restore_latest(tmp_path)
    assert got.step == 1
    assert torch.equal(got.tree["w"], torch.arange(8))


def test_kill_mid_save_leaves_latest_valid(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        from skypilot_tpu_torch.train import checkpoint as ck
        from skypilot_tpu_torch.utils import fault_injection as fi
        d = {str(tmp_path)!r}
        ck.save(d, 1, {{"w": torch.arange(8)}})
        fi.activate("ckpt.write", mode="kill")
        ck.save(d, 2, {{"w": torch.arange(8) * 2}})
        raise SystemExit("unreachable: kill fired")
    """)
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    names = sorted(os.listdir(tmp_path))
    assert any(".tmp-" in n for n in names), names
    assert not (tmp_path / "ckpt-00000002.json").exists()
    got = ck.restore_latest(tmp_path)
    assert got.step == 1 and torch.equal(got.tree["w"], torch.arange(8))


def test_checkpointer_async_matches_sync(tmp_path):
    tree = _tree()
    saver = ck.Checkpointer(tmp_path / "async", keep=2)
    saver.save(4, tree)
    tree["opt"][0].add_(1.0)  # an in-place update after save returns
    saver.save(5, tree)
    saver.wait()
    assert saver.last_saved_step == 5
    assert ck.steps(tmp_path / "async") == [4, 5]
    ck.save(tmp_path / "sync", 5, tree)
    assert (tmp_path / "async" / "ckpt-00000005.bin").read_bytes() == (
        tmp_path / "sync" / "ckpt-00000005.bin").read_bytes()
    four = ck._load_one(tmp_path / "async", 4).tree
    assert torch.equal(four["opt/0"] + 1.0, tree["opt"][0])


@pytest.fixture
def sigterm_restored():
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)
    fi.clear()


def _payload(ckpt_dir, step):
    return (pathlib.Path(ckpt_dir) / f"ckpt-{step:08d}.bin").read_bytes()


def test_recipe_resume_is_byte_identical(tmp_path, sigterm_restored):
    plain = lora_torch.main(RECIPE_ARGS + [
        "--steps", "10", "--checkpoint-dir", str(tmp_path / "plain")])
    first = lora_torch.main(RECIPE_ARGS + [
        "--steps", "6", "--checkpoint-dir", str(tmp_path / "resumed")])
    assert first["resumed_from"] == 0 and first["lora_params"] > 0
    resumed = lora_torch.main(RECIPE_ARGS + [
        "--steps", "10", "--checkpoint-dir", str(tmp_path / "resumed")])
    assert resumed["resumed_from"] == 6
    assert resumed["final_loss"] == plain["final_loss"]
    assert _payload(tmp_path / "plain", 10) == _payload(
        tmp_path / "resumed", 10)


def test_recipe_kill_and_resume(tmp_path, sigterm_restored):
    plain = lora_torch.main(RECIPE_ARGS + [
        "--steps", "6", "--checkpoint-dir", str(tmp_path / "plain")])
    env = dict(os.environ, STPU_FAULTS="train.step:kill:skip=4,times=1",
               PYTHONPATH=str(REPO))
    killed = subprocess.run(
        [sys.executable, "-m", "skypilot_tpu_torch.recipes.llama_lora",
         *RECIPE_ARGS, "--steps", "6", "--checkpoint-dir",
         str(tmp_path / "chaos")], capture_output=True, text=True, env=env,
        timeout=300, cwd=REPO)
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    assert ck.latest_step(tmp_path / "chaos") == 4
    resumed = lora_torch.main(RECIPE_ARGS + [
        "--steps", "6", "--checkpoint-dir", str(tmp_path / "chaos")])
    assert resumed["resumed_from"] == 4
    assert resumed["final_loss"] == plain["final_loss"]
    assert _payload(tmp_path / "plain", 6) == _payload(tmp_path / "chaos", 6)


def test_recipe_state_has_the_jax_layout(tmp_path, sigterm_restored):
    lora_torch.main(RECIPE_ARGS + [
        "--steps", "2", "--checkpoint-dir", str(tmp_path)])
    port = {e["key"]: (e["dtype"], e["shape"]) for e in json.loads(
        (tmp_path / "ckpt-00000002.json").read_text())["leaves"]}
    cfg = lora_jax.llama.LlamaConfig.tiny()
    lora = lora_jax.init_lora(cfg, 8, jax.random.PRNGKey(1))
    tree = {"lora": lora, "opt_state": optax.adamw(1e-3).init(lora),
            "step": np.int64(2), "data_pos": np.int64(2),
            "rng": np.asarray(jax.random.PRNGKey(2))}
    want = {k: (np.asarray(v).dtype.name, list(np.shape(v)))
            for k, v in ck_jax.flatten_tree(tree)}
    assert set(port) == set(want)
    for key in want:
        if key != "rng":  # a torch generator's state here
            assert port[key] == want[key], key


def _send_sigterm():
    """SIGTERM to this process, only once a GraceHandler holds it (off
    the main thread none is installed, and the signal would kill the
    test process)."""
    handler = getattr(signal.getsignal(signal.SIGTERM), "__self__", None)
    assert isinstance(handler, ck.GraceHandler), "no grace handler"
    signal.raise_signal(signal.SIGTERM)


def test_grace_handler_flags_sigterm(sigterm_restored):
    grace = ck.GraceHandler.install()
    assert not grace.triggered
    _send_sigterm()
    assert grace.triggered and grace.signum == signal.SIGTERM


def test_recipe_grace_saves_and_exits_143(tmp_path, monkeypatch,
                                          sigterm_restored):
    # SIGTERM lands during step 3: the loop finishes it, saves, exits 143.
    def deliver(point, step, **_):
        if point == "train.step" and step == 3:
            _send_sigterm()
    fi.activate("train.step", mode="delay", delay=0.0)
    monkeypatch.setattr(lora_torch.fault_injection, "fire", deliver)
    with pytest.raises(SystemExit) as exc:
        lora_torch.main(RECIPE_ARGS + ["--steps", "50", "--ckpt-every", "10",
                                       "--checkpoint-dir", str(tmp_path)])
    assert exc.value.code == ck.GraceHandler.GRACE_EXIT_CODE
    assert ck.latest_step(tmp_path) == 3
    assert ck.restore_latest(tmp_path) is not None



def test_recipe_needs_a_card_or_cpu_and_one_node(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lora_torch.main(["--steps", "1"])
    monkeypatch.setenv(lora_torch.NUM_NODES_ENV, "2")
    with pytest.raises(NotImplementedError, match="multi-node"):
        lora_torch.main(RECIPE_ARGS + ["--steps", "1"])


def test_device_profile_writes_a_trace(tmp_path, monkeypatch):
    from skypilot_tpu_torch import callbacks
    monkeypatch.setenv("STPU_PROFILE_DIR", str(tmp_path))
    with callbacks.device_profile():
        torch.ones(8).sum()
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())
    monkeypatch.delenv("STPU_PROFILE_DIR")
    with callbacks.device_profile():  # unarmed: writes nothing
        torch.ones(8).sum()
    assert list(tmp_path.glob("trace-*.json")) == traces
