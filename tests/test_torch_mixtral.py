"""The port's Mixtral training half (skypilot_tpu_torch.models.mixtral)
against the JAX package's, on the CPU in f32.

* ``_top2_dispatch`` on the same gates, with a capacity that every expert
  fits and with one that several overflow: dispatch equal, combine and aux
  within 1e-6.
* The tiny Mixtral (converted from JAX's init): logits within 2e-3, the
  aux loss within 2e-3, every gradient of CE + aux within 5e-3; the JAX
  side through its Pallas kernels in interpret mode, the port's through
  its plain versions; with and without per-layer remat.
* One adafactor step of ``make_train_step`` on both sides: loss within
  2e-3, parameters within 2e-3 of how far they moved.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import mixtral as mixtral_jax
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import trainer as trainer_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import mixtral as mixtral_torch
from skypilot_tpu_torch.train import trainer as trainer_torch

DISPATCH_TOL = 1e-6
OUT_TOL = 2e-3
GRAD_TOL = 5e-3
MOVE_TOL = 2e-3


def _configs(remat=True):
    cfg_j = dataclasses.replace(mixtral_jax.MixtralConfig.tiny(),
                                dtype=jnp.float32, attention_impl="pallas",
                                remat=remat)
    cfg_t = dataclasses.replace(mixtral_torch.MixtralConfig.tiny(),
                                dtype=torch.float32, attention_impl="kernel",
                                remat=remat)
    return cfg_j, cfg_t


def _params():
    cfg_j, cfg_t = _configs()
    params_j = mixtral_jax.init(cfg_j, jax.random.key(0))
    params_t = convert.mixtral_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return params_j, params_t


def _tokens(b=2, s=32):
    return np.random.default_rng(5).integers(0, 256, (b, s), dtype=np.int32)


@pytest.mark.parametrize("capacity", [64, 9])
def test_top2_dispatch_matches_jax(capacity):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((64, 4)).astype(np.float32) * 2.0
    logits[:, 1] += 1.0  # expert 1 oversubscribed
    gates = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    d_j, c_j, a_j = mixtral_jax._top2_dispatch(jnp.asarray(gates), capacity)
    d_t, c_t, a_t = mixtral_torch._top2_dispatch(torch.from_numpy(gates),
                                                 capacity)
    assert d_t.dtype == torch.bool and c_t.dtype == torch.float32
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0,
                               atol=DISPATCH_TOL)
    np.testing.assert_allclose(a_t.item(), float(a_j), rtol=DISPATCH_TOL)
    kept = int(d_t.sum())
    if capacity == 9:
        assert kept < 2 * 64, "no token overflowed"
    else:
        assert kept == 2 * 64


def test_capacity_and_size_as_jax():
    cfg = mixtral_torch.MixtralConfig.mixtral_8x7b()
    assert mixtral_torch.capacity(cfg, 4096) == 1280
    assert mixtral_torch.capacity(cfg, 3) == 2
    shapes = jax.eval_shape(lambda: mixtral_jax.init(
        mixtral_jax.MixtralConfig(), jax.random.key(0)))
    assert cfg.num_params() == sum(int(np.prod(x.shape))
                                   for x in jax.tree.leaves(shapes))
    assert cfg.flops_per_token() == mixtral_jax.MixtralConfig(
        ).flops_per_token()


@pytest.mark.parametrize("remat", [True, False])
def test_forward_and_grads_match_jax(remat):
    cfg_j, cfg_t = _configs(remat)
    params_j, params_t = _params()
    tokens = _tokens()

    def loss_jax(p):
        logits, aux = mixtral_jax.forward(cfg_j, p, jnp.asarray(tokens))
        ce = trainer_jax.cross_entropy_loss(logits[:, :-1],
                                            jnp.asarray(tokens)[:, 1:])
        return ce + aux, (logits, aux)

    (_, (logits_j, aux_j)), grads_j = jax.value_and_grad(
        loss_jax, has_aux=True)(params_j)
    tok = torch.from_numpy(tokens).long()
    logits_t, aux_t = mixtral_torch.forward(cfg_t, params_t, tok)
    loss_t = trainer_torch.cross_entropy_loss(logits_t[:, :-1],
                                              tok[:, 1:]) + aux_t
    loss_t.backward()
    assert float(aux_j) > 0
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=OUT_TOL)
    got = _grads_np(params_t)
    for path, want in jax.tree_util.tree_leaves_with_path(grads_j):
        g = got
        for key in path:
            g = g[key.key]
        want = np.asarray(want)
        np.testing.assert_allclose(g, want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=str(path))


def _grads_np(params):
    """The gradients in the JAX tree's layout."""
    out = {n: getattr(params, n).grad.numpy()
           for n in ("embed", "final_norm", "lm_head")}
    out["layers"] = {n: np.stack([getattr(lp, n).grad.numpy()
                                  for lp in params.layers])
                     for n in mixtral_torch.layer_shapes(
                         mixtral_torch.MixtralConfig.tiny())}
    return out


def test_adafactor_step_matches_jax():
    cfg_j, cfg_t = _configs()
    params_j, params_t = _params()
    init_np = jax.tree.map(np.asarray, params_j)
    tokens = _tokens()
    tcfg = dict(learning_rate=1e-2, warmup_steps=0, total_steps=10,
                optimizer="adafactor")
    mesh = mesh_lib.make_mesh({"dp": 1}, devices=[jax.devices()[0]])
    tx_j = trainer_jax.make_optimizer(trainer_jax.TrainConfig(**tcfg))
    state_j = trainer_jax.init_train_state(params_j, tx_j)
    step_j = trainer_jax.make_train_step(
        lambda p, t, constrain: mixtral_jax.forward(cfg_j, p, t,
                                                    constrain=constrain),
        tx_j, mesh, mesh_lib.DEFAULT_RULES)
    tx_t = trainer_torch.make_optimizer(trainer_torch.TrainConfig(**tcfg))
    state_t = trainer_torch.init_train_state(params_t, tx_t)
    step_t = trainer_torch.make_train_step(
        lambda p, t: mixtral_torch.forward(cfg_t, p, t), tx_t)
    state_j, m_j = step_j(state_j, {"tokens": jnp.asarray(tokens)})
    state_t, m_t = step_t(state_t,
                          {"tokens": torch.from_numpy(tokens).long()})
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(m_t[key].item(), float(m_j[key]),
                                   rtol=OUT_TOL, err_msg=key)
    final_t = convert.mixtral_params_to_numpy(state_t.params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(state_j.params):
        got, init = final_t, init_np
        for key in path:
            got, init = got[key.key], init[key.key]
        want = np.asarray(leaf)
        moved = np.linalg.norm(want - init)
        assert moved > 0, path
        assert np.linalg.norm(got - want) <= MOVE_TOL * moved, path


def test_router_stays_f32_in_bf16():
    cfg = mixtral_torch.MixtralConfig.tiny()
    params = mixtral_torch.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params.layers[0].router.dtype == torch.float32
    assert params.layers[0].w_gate.dtype == torch.bfloat16
    logits, aux = mixtral_torch.forward(
        cfg, params, torch.from_numpy(_tokens(1, 16)).long())
    assert logits.shape == (1, 16, cfg.vocab_size)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert aux.item() > 0


def test_init_without_device_raises_on_cpu_only_machine(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mixtral_torch.init(mixtral_torch.MixtralConfig.tiny(),
                           torch.Generator().manual_seed(0))
