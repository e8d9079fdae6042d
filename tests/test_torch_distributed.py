"""The port's bring-up from the env contract
(skypilot_tpu_torch/train/distributed.py) against the JAX package's: two
gloo processes launched with the SKYPILOT_* env on a free port
(``tests/torch_rank_worker.py env``) report their context, meet at a
barrier, read each other's keys, average a tree of numpy arrays and
tensors, and build the hybrid and flat meshes from the env; one node, or
no coordinator, is JAX's uninitialised context."""
import dataclasses
import pathlib
import pickle

import numpy as np
import pytest

from skypilot_tpu.train import distributed as distributed_jax
from skypilot_tpu_torch.train import distributed as distributed_torch
from torch_rank_worker import launch

WORLD = 2


@pytest.fixture(scope="module")
def env_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("env")
    launch(lambda r: ["env", str(root)], WORLD)
    return [pickle.loads((root / f"env_{r}.pkl").read_bytes())
            for r in range(WORLD)]


def test_context_barrier_and_store(env_run):
    for r, out in enumerate(env_run):
        assert out["ctx"] == dict(rank=r, num_nodes=WORLD,
                                  coordinator=out["ctx"]["coordinator"],
                                  initialized=True, federated=True,
                                  world_size=WORLD, local_rank=0)
        assert out["kv"] == [f"from {i}" for i in range(WORLD)]


def test_allreduce_mean_matches_numpy(env_run):
    trees = [out["tree"] for out in env_run]
    for out in env_run:
        mean = out["mean"]
        want_a = np.mean([t["a"] for t in trees], axis=0)
        np.testing.assert_allclose(mean["a"], want_a, rtol=1e-6)
        assert mean["a"].dtype == np.float32
        want_b0 = np.mean([t["b"][0] for t in trees], axis=0)
        # Integers come back in their dtype (the f32 mean cast back).
        np.testing.assert_array_equal(mean["b"][0],
                                      want_b0.astype(np.int32))
        assert mean["b"][0].dtype == np.int32
        np.testing.assert_allclose(
            mean["b"][1], np.mean([t["b"][1] for t in trees], axis=0),
            rtol=1e-6)
        assert mean["types"] == ["ndarray", "Tensor", "torch.float64"]
    # Bit-equal on every process.
    np.testing.assert_array_equal(env_run[0]["mean"]["a"],
                                  env_run[1]["mean"]["a"])


def test_mesh_from_env(env_run):
    for out in env_run:
        assert out["slices_mesh"] == (("dp", "fsdp"), (WORLD, 1))
        assert out["flat_mesh"] == (("fsdp",), (WORLD,))


@pytest.mark.parametrize("env", [
    {"SKYPILOT_NUM_NODES": "1", "SKYPILOT_NODE_RANK": "0",
     "SKYPILOT_COORDINATOR_ADDR": "127.0.0.1:1"},
    {"SKYPILOT_NUM_NODES": "2", "SKYPILOT_NODE_RANK": "1"},
    {}])
def test_single_process_context_matches_jax(env, monkeypatch):
    for key in ("SKYPILOT_NUM_NODES", "SKYPILOT_NODE_RANK",
                "SKYPILOT_COORDINATOR_ADDR", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = distributed_torch.initialize_from_env()
    want = distributed_jax.initialize_from_env()
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == getattr(want, field.name), field
    assert not got.is_multiprocess and not got.initialized
    tree = {"x": np.ones(3, np.float32)}
    assert distributed_torch.kv_allreduce_mean(tree, got, "t") is tree
