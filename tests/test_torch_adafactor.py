"""The port's adafactor (skypilot_tpu_torch.train.trainer.Adafactor)
against the JAX package's optax chain, on the CPU in f32.

The optimizer alone: five updates from fixed gradients, at scales on both
sides of the global clip, on four trees, each held against ``optax.chain(clip_by_global_norm,
adafactor(schedule, weight_decay_rate=wd * lr))`` on the same numbers laid
out as JAX lays them (a layer weight stacked on axis 0):

* a tree that factors: a stacked (3, 256, 384) leaf, an unstacked
  (384, 256) one, and a stacked leaf whose layer axis is one of its two
  largest, (130, 4, 150), so the statistics mix layers;
* the tiny Llama's tree (wq and the embedding factor, wk and the norms do
  not);
* a 4-D expert leaf, stacked (2, 4, 128, 256).

Parameters after each step within 1e-5 of how far they moved
(norm-relative, per leaf), statistics within 1e-5 of their norm.

The train step: the tiny Llama under ``TrainConfig(optimizer="adafactor")``
for five steps against JAX's ``make_train_step``, as
test_torch_trainer.py holds adamw: losses and grad norms within 2e-3,
final parameters within 2e-3 of how far they moved.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import trainer as trainer_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.train import trainer as trainer_torch

OPT_TOL = 1e-5
LOSS_TOL = 2e-3
MOVE_TOL = 2e-3
TCFG = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
            optimizer="adafactor")


class _Layer(nn.Module):
    def __init__(self, shapes, rng):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))))


class _Tree(nn.Module):
    """``layers.<i>.<name>`` (stacked in JAX) and top-level tensors."""

    def __init__(self, n_layers, layer_shapes, top_shapes, seed):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.layers = nn.ModuleList(_Layer(layer_shapes, rng)
                                    for _ in range(n_layers))
        for name, shape in top_shapes.items():
            setattr(self, name, nn.Parameter(torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))))


def _as_jax(leaves, tensors):
    """{leaf key: array} with a stacked leaf's tensors stacked on axis 0."""
    out = {}
    for leaf in leaves:
        arrs = [tensors[i].detach().numpy().copy() for i in leaf.index]
        out[leaf.key] = np.stack(arrs) if leaf.stacked else arrs[0]
    return out


TREES = {
    "factored": lambda: _Tree(3, {"w": (256, 384), "tall": (4, 150)},
                              {"embed": (384, 256)}, 0),
    "factored_layer_axis": lambda: _Tree(130, {"tall": (4, 150)}, {}, 1),
    "tiny_llama": lambda: llama_torch.init(
        dataclasses.replace(llama_torch.LlamaConfig.tiny(vocab_size=256),
                            dtype=torch.float32, n_layers=2),
        torch.Generator().manual_seed(2), "cpu"),
    "expert_4d": lambda: _Tree(2, {"w_gate": (4, 128, 256)}, {}, 3),
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_optimizer_matches_optax(tree):
    module = TREES[tree]()
    params = list(module.parameters())
    cfg = trainer_torch.TrainConfig(max_grad_norm=50.0, **TCFG)
    tx_t = trainer_torch.make_optimizer(cfg)
    state_t = tx_t.init(module)
    leaves = state_t.leaves
    init = _as_jax(leaves, params)
    tx_j = trainer_jax.make_optimizer(trainer_jax.TrainConfig(
        **dataclasses.asdict(cfg)))
    p_j = {k: jnp.asarray(v) for k, v in init.items()}
    opt_j = tx_j.init(p_j)
    update_j = jax.jit(tx_j.update)
    rng = np.random.default_rng(4)
    for step, scale in enumerate((0.1, 3.0, 0.01, 1.0, 0.3)):
        grads = [(rng.standard_normal(p.shape) * scale).astype(np.float32)
                 for p in params]
        g_j = {k: jnp.asarray(v) for k, v in _as_jax(
            leaves, [torch.from_numpy(g) for g in grads]).items()}
        upd, opt_j = update_j(g_j, opt_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        tx_t.update_(params, [torch.from_numpy(g) for g in grads], state_t)
        got = _as_jax(leaves, params)
        for key, want in p_j.items():
            want = np.asarray(want)
            moved = np.linalg.norm(want - init[key])
            assert moved > 0, key
            assert np.linalg.norm(got[key] - want) <= OPT_TOL * moved, (
                step, key)
    factored = opt_j[1][0]
    assert state_t.count == int(factored.count) == 5
    for k, leaf in enumerate(leaves):
        for name in ("v_row", "v_col", "v"):
            want = np.asarray(getattr(factored, name)[leaf.key])
            got = getattr(state_t, name)[k].numpy()
            assert got.shape == want.shape, (leaf.key, name)
            assert np.linalg.norm(got - want) <= OPT_TOL * np.linalg.norm(
                want) + 1e-30, (leaf.key, name)


@pytest.mark.parametrize("shape,dims", [
    ((4, 128, 32), None), ((32, 4096, 4096), (1, 2)), ((32, 4096, 8), None),
    ((32, 8, 4096, 14336), (2, 3)), ((4, 128, 128), (1, 2)),
    ((130, 4, 150), (0, 2)), ((7,), None), ((128, 128), (0, 1))])
def test_factored_dims_as_optax(shape, dims):
    from optax._src import factorized
    assert trainer_torch.factored_dims(shape) == dims
    assert factorized._factored_dims(shape, True, 128) == dims


def test_leaves_follow_the_stacked_tree():
    cfg = dataclasses.replace(llama_torch.LlamaConfig.tiny(vocab_size=256),
                              dtype=torch.float32)
    params = llama_torch.init(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = trainer_torch.jax_leaves(params)
    plist = list(params.parameters())
    by_key = {leaf.key: leaf for leaf in leaves}
    assert set(by_key) == {"embed", "final_norm", "lm_head"} | {
        f"layers.{n}" for n in llama_torch.layer_shapes(cfg)}
    assert by_key["layers.wq"].stacked and not by_key["embed"].stacked
    assert by_key["layers.wq"].shape(plist) == (4, 128, 128)
    assert sorted(i for leaf in leaves for i in leaf.index) == list(
        range(len(plist)))


def test_no_decay_stage_when_rate_is_zero():
    # weight_decay * lr == 0 drops the stage, as the JAX package's
    # ``wd or None`` does.
    tx = trainer_torch.make_optimizer(trainer_torch.TrainConfig(
        optimizer="adafactor", weight_decay=0.0))
    assert tx.weight_decay is None


@pytest.mark.parametrize("jax_impl", ["pallas", "reference"])
def test_train_step_matches_jax(jax_impl):
    impl = {"pallas": "kernel", "reference": "reference"}[jax_impl]
    cfg_j = dataclasses.replace(llama_jax.LlamaConfig.tiny(vocab_size=256),
                                dtype=jnp.float32, attention_impl=jax_impl)
    cfg_t = dataclasses.replace(llama_torch.LlamaConfig.tiny(vocab_size=256),
                                dtype=torch.float32, attention_impl=impl)
    params_j = llama_jax.init(cfg_j, jax.random.key(0))
    init_np = jax.tree.map(np.asarray, params_j)
    params_t = convert.llama_params_from_jax(cfg_t, init_np, "cpu")
    tokens = np.random.default_rng(7).integers(0, 256, (2, 64),
                                               dtype=np.int32)
    mesh = mesh_lib.make_mesh({"dp": 1}, devices=[jax.devices()[0]])
    tx_j = trainer_jax.make_optimizer(trainer_jax.TrainConfig(**TCFG))
    state_j = trainer_jax.init_train_state(params_j, tx_j)
    step_j = trainer_jax.make_train_step(
        lambda p, t, constrain: llama_jax.forward(cfg_j, p, t,
                                                  constrain=constrain),
        tx_j, mesh, mesh_lib.DEFAULT_RULES)
    tx_t = trainer_torch.make_optimizer(trainer_torch.TrainConfig(**TCFG))
    state_t = trainer_torch.init_train_state(params_t, tx_t)
    step_t = trainer_torch.make_train_step(
        lambda p, t: llama_torch.forward(cfg_t, p, t), tx_t)
    batch_j = {"tokens": jnp.asarray(tokens)}
    batch_t = {"tokens": torch.from_numpy(tokens).long()}
    losses = []
    for i in range(5):
        state_j, m_j = step_j(state_j, batch_j)
        state_t, m_t = step_t(state_t, batch_t)
        losses.append(m_t["loss"].item())
        np.testing.assert_allclose(m_t["loss"].item(), float(m_j["loss"]),
                                   rtol=LOSS_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(m_t["grad_norm"].item(),
                                   float(m_j["grad_norm"]), rtol=LOSS_TOL)
    assert losses[-1] < losses[0]
    final_t = convert.llama_params_to_numpy(state_t.params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(state_j.params):
        got, init = final_t, init_np
        for key in path:
            got, init = got[key.key], init[key.key]
        want = np.asarray(leaf)
        moved = np.linalg.norm(want - init)
        assert np.linalg.norm(got - want) <= MOVE_TOL * moved, path
