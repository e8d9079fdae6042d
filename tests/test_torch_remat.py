"""The port's remat policies (skypilot_tpu_torch.models.llama, remat_policy
"save_flash", "save_flash_qkv", "save_flash_offload_qkv") against the JAX
package's, on the CPU in f32, and the work each one saves, counted.

The loss is the long-context route: ``forward_trunk`` then
``chunked_cross_entropy_loss`` over ``head_weights``, chunk width 16 on
both sides. The JAX side runs its Pallas kernels in interpret mode under
the same policy; the port side runs the flash op (its plain versions on a
CPU tensor). Tolerance is test_torch_llama.py's 2e-3.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.ops.pallas import flash_attention as fa_jax
from skypilot_tpu.train import trainer as trainer_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.ops import flash_attention as fa_torch
from skypilot_tpu_torch.train import trainer as trainer_torch

TOL = 2e-3
POLICIES = ["save_flash", "save_flash_qkv", "save_flash_offload_qkv"]
ALL_POLICIES = ["full"] + POLICIES


@pytest.fixture
def past_budget(monkeypatch):
    """Both packages past the resident budget. JAX keeps traces of its
    flash op keyed on the function, not on the patched budget, so its
    caches are cleared on entry and on exit: no trace of one family meets
    the other's backward, here or in a later test."""
    jax.clear_caches()
    monkeypatch.setattr(fa_jax, "_use_resident", lambda s, d: False)
    monkeypatch.setattr(fa_torch, "_use_resident", lambda s, d: False)
    yield
    jax.clear_caches()


def _configs(policy):
    cfg_j = dataclasses.replace(llama_jax.LlamaConfig.tiny(vocab_size=256),
                                dtype=jnp.float32, attention_impl="pallas",
                                remat_policy=policy)
    cfg_t = dataclasses.replace(llama_torch.LlamaConfig.tiny(vocab_size=256),
                                dtype=torch.float32, attention_impl="kernel",
                                remat_policy=policy)
    return cfg_j, cfg_t


def _tokens(b=2, s=64):
    return np.random.default_rng(11).integers(0, 256, (b, s), dtype=np.int32)


def _torch_step(cfg_t, params_t, tokens):
    tok = torch.from_numpy(tokens).long()
    hidden = llama_torch.forward_trunk(cfg_t, params_t, tok)
    loss = trainer_torch.chunked_cross_entropy_loss(
        hidden[:, :-1], llama_torch.head_weights(params_t), tok[:, 1:])
    loss.backward()
    return loss.item()


def _check_against_jax(policy, monkeypatch):
    monkeypatch.setattr(trainer_jax, "CE_CHUNK", 16)
    monkeypatch.setattr(trainer_torch, "CE_CHUNK", 16)
    cfg_j, cfg_t = _configs(policy)
    params_j = llama_jax.init(cfg_j, jax.random.key(0))
    params_t = convert.llama_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    tokens = _tokens()

    def loss_jax(p):
        toks = jnp.asarray(tokens)
        hidden = llama_jax.forward_trunk(cfg_j, p, toks)
        return trainer_jax.chunked_cross_entropy_loss(
            hidden[:, :-1], llama_jax.head_weights(p), toks[:, 1:])

    loss_j, grads_j = jax.value_and_grad(loss_jax)(params_j)
    loss_t = _torch_step(cfg_t, params_t, tokens)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=TOL)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(getattr(params_t, name).grad.numpy(),
                                   np.asarray(grads_j[name]), rtol=TOL,
                                   atol=TOL, err_msg=name)
    for i, lp in enumerate(params_t.layers):
        for name in llama_torch.layer_shapes(cfg_t):
            np.testing.assert_allclose(
                getattr(lp, name).grad.numpy(),
                np.asarray(grads_j["layers"][name][i]), rtol=TOL, atol=TOL,
                err_msg=f"layer {i} {name}")


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax(policy, monkeypatch):
    _check_against_jax(policy, monkeypatch)


@pytest.mark.parametrize("policy", ["save_flash", "save_flash_offload_qkv"])
def test_policy_matches_jax_triangular_family(policy, monkeypatch,
                                              past_budget):
    # The policy carries the base-2 lse of the triangular family from the
    # forward to the backward.
    _check_against_jax(policy, monkeypatch)


def _count_calls(monkeypatch, module, name, record=None):
    calls = collections.Counter()
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        calls[name] += 1
        if record is not None:
            record.append(args)
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, wrapped)
    return calls


def _torch_only_step(policy):
    _, cfg_t = _configs(policy)
    params_t = llama_torch.init(cfg_t, torch.Generator().manual_seed(0),
                                "cpu")
    _torch_step(cfg_t, params_t, _tokens())
    return cfg_t


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_flash_forward_runs_once_per_layer(policy, monkeypatch):
    # "full" re-runs the layer in the backward, flash forward included;
    # every save_flash* policy keeps o and lse and never re-runs it.
    fwd = _count_calls(monkeypatch, fa_torch, "flash_fwd_plain")
    bwd = _count_calls(monkeypatch, fa_torch, "flash_bwd_plain")
    n = _torch_only_step(policy).n_layers
    assert fwd["flash_fwd_plain"] == (2 * n if policy == "full" else n)
    assert bwd["flash_bwd_plain"] == n


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_qkv_proj_runs_once_per_layer_under_qkv_policies(policy,
                                                         monkeypatch):
    calls = _count_calls(monkeypatch, llama_torch, "qkv_proj")
    n = _torch_only_step(policy).n_layers
    keeps_qkv = policy.endswith("_qkv")
    assert calls["qkv_proj"] == (n if keeps_qkv else 2 * n)


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_offload_hook_selects_exactly_qkv(policy, monkeypatch):
    parked = []
    offload = _count_calls(monkeypatch, llama_torch, "offload_to_host",
                           parked)
    reload = _count_calls(monkeypatch, llama_torch, "reload_from_host")
    cfg = _torch_only_step(policy)
    if policy != "save_flash_offload_qkv":
        assert not offload and not reload
        return
    b, s = _tokens().shape
    hd = cfg.head_dim
    want = [(b, s, cfg.n_heads, hd), (b, s, cfg.n_kv_heads, hd),
            (b, s, cfg.n_kv_heads, hd)] * cfg.n_layers
    assert [tuple(args[0].shape) for args in parked] == want
    assert reload["reload_from_host"] == 3 * cfg.n_layers


def test_qkv_proj_backward_is_the_autograd_transpose():
    # The *_qkv policies' hand-written transpose of norm + projection +
    # rope against autograd through the same forward.
    _, cfg = _configs("save_flash_qkv")
    params = llama_torch.init(cfg, torch.Generator().manual_seed(3), "cpu")
    lp = params.layers[0]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.dim)).astype(
        np.float32)).requires_grad_()
    pos = torch.arange(16).expand(2, 16)
    y = llama_torch.rms_norm(x, lp.attn_norm, cfg.norm_eps)
    qkv = llama_torch.qkv_proj(cfg, y, lp, pos)
    cot = [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
           for t in qkv]
    names = ["attn_norm", "wq", "wk", "wv"]
    ref = torch.autograd.grad(qkv, [x] + [getattr(lp, n) for n in names],
                              cot)
    got = llama_torch._qkv_proj_backward(cfg, lp, x.detach().requires_grad_(),
                                         pos, *cot)
    for name, want in zip(["x"] + names, ref):
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
