"""The port's trainer (skypilot_tpu_torch.train.trainer) against the JAX
package's optax step, on the CPU in f32.

Five steps from the same converted init and tokens, through the Pallas
path in interpret mode on the JAX side and the kernel op's plain versions
on the port side, then the same through both references. Loss and grad
norm per step agree to 2e-3, as the forward does. Final parameters are
held two ways. Per tensor, the difference is at most 2e-3 of how far the
parameter moved (measured: <= 2e-4). Per element, it is at most lr / 2:
adam divides each update by its own |g|, so an element whose gradient is
near 0 takes a step of up to lr from summation-order noise alone
(measured: <= 6.3e-4 on 3e-5 of the elements, after five steps at lr 1e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import trainer as trainer_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.train import trainer as trainer_torch

LOSS_TOL = 2e-3
MOVE_TOL = 2e-3
LR = 1e-2
IMPLS = {"pallas": "kernel", "reference": "reference"}


@pytest.mark.parametrize("jax_impl", ["pallas", "reference"])
def test_five_steps_match_jax(jax_impl):
    cfg_j = dataclasses.replace(llama_jax.LlamaConfig.tiny(vocab_size=256),
                                dtype=jnp.float32, attention_impl=jax_impl)
    cfg_t = dataclasses.replace(llama_torch.LlamaConfig.tiny(vocab_size=256),
                                dtype=torch.float32,
                                attention_impl=IMPLS[jax_impl])
    tcfg = dict(warmup_steps=2, total_steps=10, learning_rate=LR)
    params_j = llama_jax.init(cfg_j, jax.random.key(0))
    init_np = jax.tree.map(np.asarray, params_j)
    params_t = convert.llama_params_from_jax(cfg_t, init_np, "cpu")
    tokens = np.random.default_rng(7).integers(0, 256, (2, 64),
                                               dtype=np.int32)

    mesh = mesh_lib.make_mesh({"dp": 1}, devices=[jax.devices()[0]])
    tx_j = trainer_jax.make_optimizer(trainer_jax.TrainConfig(**tcfg))
    state_j = trainer_jax.init_train_state(params_j, tx_j)
    step_j = trainer_jax.make_train_step(
        lambda p, t, constrain: llama_jax.forward(cfg_j, p, t,
                                                  constrain=constrain),
        tx_j, mesh, mesh_lib.DEFAULT_RULES)
    tx_t = trainer_torch.make_optimizer(trainer_torch.TrainConfig(**tcfg))
    state_t = trainer_torch.init_train_state(params_t, tx_t)
    step_t = trainer_torch.make_train_step(
        lambda p, t: llama_torch.forward(cfg_t, p, t), tx_t)

    batch_j = {"tokens": jnp.asarray(tokens)}
    batch_t = {"tokens": torch.from_numpy(tokens).long()}
    for i in range(5):
        state_j, m_j = step_j(state_j, batch_j)
        state_t, m_t = step_t(state_t, batch_t)
        np.testing.assert_allclose(m_t["loss"].item(), float(m_j["loss"]),
                                   rtol=LOSS_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(m_t["grad_norm"].item(),
                                   float(m_j["grad_norm"]), rtol=LOSS_TOL)
    assert state_t.step == int(state_j.step) == 5
    final_t = convert.llama_params_to_numpy(state_t.params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(state_j.params):
        got, init = final_t, init_np
        for key in path:
            got, init = got[key.key], init[key.key]
        want = np.asarray(leaf)
        moved = np.linalg.norm(want - init)
        assert np.linalg.norm(got - want) <= MOVE_TOL * moved, path
        np.testing.assert_allclose(got, want, rtol=0, atol=LR / 2,
                                   err_msg=str(path))


@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 8), (3, 12), (5, 5)])
def test_schedule_matches_optax(warmup, total):
    cfg = trainer_torch.TrainConfig(learning_rate=3e-4, warmup_steps=warmup,
                                    total_steps=total)
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1))
    sched = trainer_torch.warmup_cosine_schedule(cfg)
    for count in range(total + 3):
        np.testing.assert_allclose(sched(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-12)
    if warmup:
        assert sched(0) == 0.0


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(8)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((4, 3), (7,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    out = trainer_torch.clip_by_global_norm(
        [torch.from_numpy(g) for g in grads], max_norm)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_adamw_steps_match_optax():
    # Three updates of the full chain on fixed gradients, one of them past
    # the clip threshold, with weight decay on every leaf.
    cfg = trainer_torch.TrainConfig(learning_rate=1e-2, warmup_steps=1,
                                    total_steps=6, max_grad_norm=3.0)
    rng = np.random.default_rng(9)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((5, 4),
                                                                  (6,))]
    grad_seq = [[rng.standard_normal(p.shape).astype(np.float32) * scale
                 for p in params] for scale in (0.1, 5.0, 0.3)]
    tx_j = trainer_jax.make_optimizer(trainer_jax.TrainConfig(
        **dataclasses.asdict(cfg)))
    p_j = [jnp.asarray(p) for p in params]
    opt_j = tx_j.init(p_j)
    tx_t = trainer_torch.make_optimizer(cfg)
    p_t = [torch.from_numpy(p.copy()) for p in params]
    opt_t = tx_t.init(p_t)
    for grads in grad_seq:
        upd, opt_j = tx_j.update([jnp.asarray(g) for g in grads], opt_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        tx_t.update_(p_t, [torch.from_numpy(g) for g in grads], opt_t)
        for a, b in zip(p_t, p_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("name,error", [("adafactor", None),
                                        ("sgd", ValueError)])
def test_optimizer_names(name, error):
    cfg = trainer_torch.TrainConfig(optimizer=name)
    if error is None:
        assert isinstance(trainer_torch.make_optimizer(cfg),
                          trainer_torch.Adafactor)
        return
    with pytest.raises(error):
        trainer_torch.make_optimizer(cfg)


def test_delayed_fetch_hands_back_previous():
    fetch = trainer_torch.DelayedFetch()
    assert fetch.rotate(torch.tensor(1.0)) is None
    assert float(fetch.rotate(torch.tensor(2.0))) == 1.0
    assert float(fetch.drain()) == 2.0
    assert fetch.drain() is None
