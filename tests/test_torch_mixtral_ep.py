"""Mixtral with expert parallelism in the port against the JAX package,
on the CPU in f32.

Four gloo processes (``tests/torch_rank_worker.py``, spawned once for the
file) run the port's sharded ``make_train_step`` on the tiny Mixtral at
{dp 2, ep 2}, {ep 4} (one expert a rank) and {ep 2, tp 2} (the expert
``mlp`` axis split over tp too). The reference is JAX's step on one
device: XLA's SPMD partition does not change what it computes; {sp 2,
ep 2} splits each row's sequence over sp as well. Two adamw
steps: loss, aux loss and grad norm per step within ``LOSS_TOL``, final
parameters within ``MOVE_TOL`` of the distance moved
(``tests/test_torch_parallel_step.py``'s tolerances).

The batch drops tokens (each layer's dropped share of token choices is
asserted > 0; ``_tokens``), so routing each data rank's tokens on their
own (capacity from the local count, positions from a local cumsum)
would dispatch differently: ``test_per_shard_routing_differs`` shows it
on the same gates. A spy in the worker shows that no expert tensor is gathered over
``ep``: every expert view holds ``E / ep`` experts, and no tensor split
over ``ep`` is redistributed off it or gathered whole during a step.
``mixtral_ep.main`` runs at world 1 on the CPU and prints JAX's keys.
"""
import ast
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import mixtral as mixtral_jax
from skypilot_tpu.parallel import mesh as mesh_jax
from skypilot_tpu.recipes import mixtral_ep as mixtral_ep_jax
from skypilot_tpu.train import trainer as trainer_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import mixtral as mixtral_torch
from skypilot_tpu_torch.recipes import mixtral_ep
from test_torch_parallel_step import LOSS_TOL, LR, MOVE_TOL, TCFG, _Run

STEPS = 2
VOCAB = 256
TOKENS_SHAPE = (4, 64)
DROP_IDS = 16
EP_MESHES = {
    "dp2_ep2": {"dp": 2, "ep": 2},
    "ep4": {"ep": 4},
    "ep2_tp2": {"ep": 2, "tp": 2},
    # Each row's sequence split over sp: routing continues the (b, s)
    # order of the whole batch across the chunks (_BatchShare), and
    # attention gathers the chunks (parallel/seq_gather.py).
    "sp2_ep2": {"sp": 2, "ep": 2},
}


def _jax_cfg():
    return dataclasses.replace(mixtral_jax.MixtralConfig.tiny(VOCAB),
                               dtype=jnp.float32,
                               attention_impl="reference")


def _port_cfg():
    return dataclasses.replace(mixtral_torch.MixtralConfig.tiny(VOCAB),
                               dtype=torch.float32,
                               attention_impl="reference")


def _init():
    return jax.tree.map(np.asarray, mixtral_jax.init(_jax_cfg(),
                                                     jax.random.key(0)))


def _tokens():
    """A batch over 16 token ids: repeated tokens pile their choices onto
    a few experts, and every layer drops some (over the whole vocabulary
    the first layer drops none at these weights)."""
    return np.random.default_rng(11).integers(0, DROP_IDS, TOKENS_SHAPE,
                                              dtype=np.int32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases = {name: dict(kind="train", family="mixtral", axes=axes,
                        vocab=VOCAB, cfg={"attention_impl": "reference"},
                        init=_init(), tokens=_tokens(), tcfg=dict(TCFG),
                        steps=STEPS)
             for name, axes in EP_MESHES.items()}
    r = _Run(tmp_path_factory.mktemp("ep_ranks"), cases)
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_run():
    """JAX's step on one device: losses, aux, grad norms, final params."""
    cfg = _jax_cfg()
    mesh = mesh_jax.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    rules = mesh_jax.DEFAULT_RULES
    tx = trainer_jax.make_optimizer(trainer_jax.TrainConfig(**TCFG))
    state = trainer_jax.init_train_state(
        mixtral_jax.init(cfg, jax.random.key(0)), tx)
    step = trainer_jax.make_train_step(
        lambda p, t, constrain: mixtral_jax.forward(cfg, p, t,
                                                    constrain=constrain),
        tx, mesh, rules)
    batch = {"tokens": jnp.asarray(_tokens())}
    out = {"loss": [], "aux_loss": [], "grad_norm": []}
    for _ in range(STEPS):
        state, m = step(state, batch)
        for k in out:
            out[k].append(float(m[k]))
    out["final"] = jax.tree.map(np.asarray, state.params)
    return out


def _layer_gates(params, tokens):
    """Each layer's router gates at ``params`` on ``tokens`` (the port's
    one-device forward), with the layer's capacity on the whole batch."""
    cfg = _port_cfg()
    out = []
    with torch.no_grad():
        x = mixtral_torch.llama.embed_tokens(params, tokens)
        positions = torch.arange(tokens.shape[1]).expand(tokens.shape)
        for lp in params.layers:
            y = mixtral_torch.llama.rms_norm(
                mixtral_torch.llama.attention_block(cfg, x, lp, positions),
                lp.mlp_norm, cfg.norm_eps)
            out.append(mixtral_torch.router_gates(y, lp))
            x, _ = lp(cfg, x, positions)
    return out


def _port_params():
    return convert.mixtral_params_from_jax(_port_cfg(), _init(), "cpu")


def test_inputs_drop_tokens():
    cfg = _port_cfg()
    tokens = torch.from_numpy(_tokens()).long()
    cap = mixtral_torch.capacity(cfg, tokens.numel())
    for gates in _layer_gates(_port_params(), tokens):
        dispatch, _, _ = mixtral_torch._top2_dispatch(gates, cap)
        dropped = 1.0 - float(dispatch.sum()) / (cfg.top_k * tokens.numel())
        assert dropped > 0, "no token choice dropped: the test needs drops"


@pytest.mark.parametrize("shards", [2, 4])
def test_per_shard_routing_differs(shards):
    """Routing each data rank's rows on their own keeps other tokens than
    the whole batch's routing does, on the same gates."""
    cfg = _port_cfg()
    tokens = torch.from_numpy(_tokens()).long()
    t = tokens.numel()
    gates = _layer_gates(_port_params(), tokens)[0]
    whole, _, aux = mixtral_torch._top2_dispatch(
        gates, mixtral_torch.capacity(cfg, t))
    parts = [mixtral_torch._top2_dispatch(
        g, mixtral_torch.capacity(cfg, t // shards))
        for g in gates.chunk(shards)]
    kept_whole = whole.any(dim=-1)
    kept_shards = torch.cat([d.any(dim=-1) for d, _, _ in parts])
    assert not torch.equal(kept_whole, kept_shards)
    mean_aux = sum(float(a) for _, _, a in parts) / shards
    assert abs(mean_aux - float(aux)) > 1e-6


@pytest.mark.parametrize("name", list(EP_MESHES))
def test_ep_steps_match_jax(run, jax_run, name):
    got = run.get(name)
    for key in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(got[key], jax_run[key], rtol=LOSS_TOL,
                                   err_msg=key)
    assert all(a > 0 for a in got["aux_loss"])
    init = _init()
    for path, want in jax.tree_util.tree_leaves_with_path(jax_run["final"]):
        a, i0 = got["final"], init
        for key in path:
            a, i0 = a[key.key], i0[key.key]
        moved = np.linalg.norm(want - i0)
        assert np.linalg.norm(a - want) <= MOVE_TOL * moved, path
        np.testing.assert_allclose(a, want, rtol=0, atol=LR / 2,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", list(EP_MESHES))
def test_no_expert_tensor_gathered_over_ep(run, name):
    got = run.get(name)
    cfg = _port_cfg()
    ep = EP_MESHES[name]["ep"]
    tp = EP_MESHES[name].get("tp", 1)
    assert got["ep_views"], "no expert view was taken"
    for whole, local in got["ep_views"]:
        assert whole[0] == cfg.n_experts
        assert local[0] == cfg.n_experts // ep
        assert local[1] * local[2] * tp == whole[1] * whole[2]
    assert got["ep_gathers"] == [[] for _ in range(4)]


def _jax_out_keys():
    """The keys of the JAX recipe's ``out`` dict, read from its source."""
    tree = ast.parse(inspect.getsource(mixtral_ep_jax.main).lstrip())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "out"
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "out"):
            keys.add(node.targets[0].slice.value)
    return keys


def test_recipe_runs_at_world_one(monkeypatch):
    from skypilot_tpu_torch.observability import trainstats
    monkeypatch.setattr(mixtral_torch.MixtralConfig, "tiny", staticmethod(
        lambda vocab_size=256: dataclasses.replace(
            mixtral_torch.MixtralConfig(), vocab_size=vocab_size, dim=64,
            n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=128, n_experts=4,
            max_seq_len=256, dtype=torch.float32)))
    trainstats.arm(sync_every=1)
    try:
        out = mixtral_ep.main(["--device", "cpu", "--steps", "3",
                               "--batch-size", "2", "--seq-len", "32"])
    finally:
        trainstats.disarm()
    assert set(out) == _jax_out_keys()
    assert out["recipe"] == "mixtral_ep" and out["model"] == "tiny"
    assert out["mesh"] == {"dp": 1, "ep": 1}
    assert out["steps"] == 3
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["final_loss"])
    assert out["aux_loss"] > 0
    assert out["train_step_seconds"] > 0
