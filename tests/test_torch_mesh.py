"""The port's mesh and sharding rules (skypilot_tpu_torch/parallel/mesh.py)
against the JAX package's, with no process group: the axis-size rule and
its errors, every leaf's PartitionSpec for Llama's and Gemma's
param_specs (plain and int8) on five meshes, the DTensor placements that
spec means (each process's block of every leaf equal to JAX's device
index map), and make_mesh_from_env on one process."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from skypilot_tpu.models import gemma as gemma_jax
from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.parallel import mesh as mesh_jax
from skypilot_tpu.train import distributed as distributed_jax
from skypilot_tpu_torch.models import gemma as gemma_torch
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.parallel import mesh as mesh_torch
from skypilot_tpu_torch.parallel import placement
from skypilot_tpu_torch.train import distributed as distributed_torch

# (axes, n): sizes that resolve, and ones that raise, with JAX's message.
AXIS_CASES = [({"dp": 2, "tp": 4}, 8), ({"dp": -1, "tp": 2}, 8),
              ({"fsdp": -1}, 1), ({"a": 1, "b": -1, "c": 2}, 6),
              ({"dp": -1, "tp": -1}, 8), ({"dp": 3, "tp": -1}, 8),
              ({"dp": 2, "tp": 2}, 8), ({"dp": 0, "tp": 2}, 8)]
# (name, axes, slices, rules): the meshes of the spec comparison.
MESHES = [("dp2_tp4", {"dp": 2, "tp": 4}, None, "DEFAULT_RULES"),
          ("dp2_fsdp2_tp2", {"dp": 2, "fsdp": 2, "tp": 2}, None,
           "DEFAULT_RULES"),
          ("pp4_tp2", {"pp": 4, "tp": 2}, None, "PIPELINE_RULES"),
          ("sp8", {"sp": 8}, None, "DEFAULT_RULES"),
          ("multislice_fsdp4x2", {"fsdp": 4}, 2, "DEFAULT_RULES")]
MODELS = {"llama": (llama_jax, llama_torch, llama_jax.LlamaConfig.tiny,
                    llama_torch.LlamaConfig.tiny),
          "gemma": (gemma_jax, gemma_torch, gemma_jax.GemmaConfig.tiny,
                    gemma_torch.GemmaConfig.tiny)}


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("axes,n", AXIS_CASES)
def test_resolve_axis_sizes_matches_jax(axes, n):
    assert (_outcome(mesh_torch._resolve_axis_sizes, axes, n) ==
            _outcome(mesh_jax._resolve_axis_sizes, axes, n))


def _jax_mesh(axes, slices):
    if slices:
        return mesh_jax.make_multislice_mesh(axes, slices)
    return mesh_jax.make_mesh(axes)


def _sizes(jmesh):
    return dict(zip(jmesh.axis_names, jmesh.devices.shape))


def _leaves(specs_j, specs_t):
    """(path, JAX spec, port spec, is a layer leaf) for every leaf."""
    for name, spec in specs_j.items():
        if name == "layers":
            for lname, lspec in spec.items():
                yield (f"layers.{lname}", lspec, specs_t["layers"][lname],
                       True)
        else:
            yield name, spec, specs_t[name], False


def _shape(params_np, path):
    node = params_np
    for key in path.split("."):
        node = node[key]
    return node.shape


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("family", list(MODELS))
@pytest.mark.parametrize("mesh_name,axes,slices,rules_name", MESHES)
def test_specs_and_placements_match_jax(family, quantized, mesh_name, axes,
                                        slices, rules_name):
    mod_j, mod_t, tiny_j, tiny_t = MODELS[family]
    cfg_j, cfg_t = tiny_j(vocab_size=256), tiny_t(vocab_size=256)
    jmesh = _jax_mesh(axes, slices)
    sizes = _sizes(jmesh)
    rules_j = getattr(mesh_jax, rules_name)
    rules_t = getattr(mesh_torch, rules_name)
    specs_j = mod_j.param_specs(cfg_j, quantized=quantized)
    specs_t = mod_t.param_specs(cfg_t, quantized=quantized)
    params = mod_j.init(cfg_j, jax.random.key(0))
    if quantized:
        params = mod_j.quantize_params(cfg_j, params)
    params_np = jax.tree.map(np.asarray, params)
    leaves = list(_leaves(specs_j, specs_t))
    assert len(leaves) == len(jax.tree.leaves(params_np))
    n_layers = cfg_t.n_layers
    for path, spec_j, spec_t, is_layer in leaves:
        want = tuple(rules_j.spec(spec_j, jmesh))
        got = rules_t.spec(spec_t, sizes)
        if is_layer:
            # The port holds one module per layer: the stacked axis
            # becomes the layer's pipeline stage.
            lead = want[0] if want else None
            assert got == want[1:], (path, got, want)
            stage = placement.layer_stage(rules_t, sizes, n_layers - 1,
                                          n_layers)
            assert (stage is not None) == (lead == "pp"), path
            assert rules_t.resolve_axis("layers", sizes) == lead, path
        else:
            assert got == want, (path, got, want)
        shape = _shape(params_np, path)
        _check_blocks(jmesh, sizes, rules_t.placements(spec_t, sizes),
                      rules_j.sharding(spec_j, jmesh), shape, is_layer)


def _block(shape, sizes, placements, coord):
    """The index block a process at mesh coordinate ``coord`` holds under
    DTensor placements: the mesh axes on one tensor dim split it in mesh
    order, row-major (even shapes)."""
    names = list(sizes)
    out = []
    for d, n in enumerate(shape):
        axes = [i for i, pl in enumerate(placements) if pl == Shard(d)]
        parts = math.prod(sizes[names[i]] for i in axes)
        idx = 0
        for i in axes:
            idx = idx * sizes[names[i]] + coord[i]
        out.append((idx * n // parts, (idx + 1) * n // parts))
    return tuple(out)


def _check_blocks(jmesh, sizes, placements, sharding_j, shape, is_layer):
    """Each mesh coordinate's block under the port's placements equals
    JAX's device index map (a layer without its stacked axis)."""
    assert all(isinstance(p, (Shard, Replicate)) for p in placements)
    indices = sharding_j.devices_indices_map(tuple(shape))
    for coord in np.ndindex(jmesh.devices.shape):
        want = tuple((s.start or 0, n if s.stop is None else s.stop)
                     for s, n in zip(indices[jmesh.devices[coord]], shape))
        if is_layer:
            want, shape_t = want[1:], shape[1:]
        else:
            shape_t = shape
        got = _block(shape_t, sizes, placements, coord)
        assert got == want, (coord, got, want)


@pytest.fixture
def one_process_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_from_env_one_process(monkeypatch, one_process_group):
    monkeypatch.setenv("SKYPILOT_NUM_SLICES", "1")
    mesh = distributed_torch.make_mesh_from_env({"fsdp": -1}, device="cpu")
    jmesh = distributed_jax.make_mesh_from_env({"fsdp": -1})
    assert mesh.mesh_dim_names == ("fsdp",) == jmesh.axis_names
    assert dist.get_backend() == "gloo" and mesh.size() == 1
    # Two slices need at least two processes (JAX's error for a device
    # count that does not split).
    monkeypatch.setenv("SKYPILOT_NUM_SLICES", "2")
    with pytest.raises(ValueError, match="divisible"):
        distributed_torch.make_mesh_from_env({"fsdp": -1}, device="cpu")
    with pytest.raises(ValueError, match="also named"):
        mesh_torch.make_multislice_mesh({"dp": -1}, num_slices=1,
                                        device="cpu")


def test_rules_drop_absent_axes_and_reuse():
    rules = mesh_torch.DEFAULT_RULES
    sizes = {"dp": 2, "tp": 4}
    assert rules.spec(("batch", "act_seq", "heads"), sizes) == (
        "dp", None, "tp")
    # A mesh axis shards at most one tensor dim: the second goes whole.
    assert rules.spec(("heads", "kv_heads"), sizes) == ("tp",)
    assert rules.placements(("batch", "heads"), sizes) == (Shard(0),
                                                           Shard(1))
    dp_fsdp = {"dp": 2, "fsdp": 2}
    assert rules.placements(("batch",), dp_fsdp) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="axis order"):
        rules.placements(("batch",), {"fsdp": 2, "dp": 2})
    got = mesh_torch.tree_shardings(sizes, rules, {"a": ("batch", None)})
    assert got["a"].placements == (Shard(0), Replicate())


def test_world_one_step_carries_a_placed_adamw_state(one_process_group):
    """place_state after a step keeps the optimizer's count and moments:
    one plain step, then two on a world-1 mesh of every training axis,
    equal the plain step's three (the CPU twin of chip_smoke's
    [parallel] step)."""
    import torch

    from skypilot_tpu_torch.train import trainer

    cfg = dataclasses.replace(llama_torch.LlamaConfig.tiny(vocab_size=64),
                              dtype=torch.float32, n_layers=2)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (2, 32))).long()
    tcfg = trainer.TrainConfig(warmup_steps=1, total_steps=10,
                               learning_rate=1e-2)

    def fresh():
        params = llama_torch.init(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
        tx = trainer.make_optimizer(tcfg)
        return tx, trainer.init_train_state(params, tx)

    def plain_step(tx):
        return trainer.make_train_step(
            lambda p, t: llama_torch.forward(cfg, p, t), tx)

    tx, want = fresh()
    step = plain_step(tx)
    losses = [step(want, {"tokens": tokens})[1]["loss"].item()
              for _ in range(3)]
    tx, got = fresh()
    got_losses = [plain_step(tx)(got, {"tokens": tokens})[1]["loss"].item()]
    mesh = mesh_torch.make_mesh({"dp": 1, "fsdp": 1, "sp": 1, "tp": 1},
                                device="cpu")
    rules = mesh_torch.DEFAULT_RULES
    got = trainer.place_state(got, trainer.state_shardings(
        mesh, rules, llama_torch.param_specs(cfg), got), tx)
    assert got.opt_state.count == 1
    step = trainer.make_train_step(
        lambda p, t: llama_torch.forward(cfg, p, t), tx, mesh=mesh,
        rules=rules)
    got_losses += [step(got, {"tokens": tokens})[1]["loss"].item()
                   for _ in range(2)]
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    for (name, a), b in zip(got.params.named_parameters(),
                            want.params.parameters()):
        np.testing.assert_allclose(a.full_tensor().detach().numpy(),
                                   b.detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
