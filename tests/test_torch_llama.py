"""The port's Llama (skypilot_tpu_torch.models.llama) against the JAX
package's, on the CPU in f32, from the same converted init and tokens.

Attention on the JAX side is either its Pallas kernels in interpret mode
or its XLA reference; on the port side the matching path is the kernel op
(its plain versions on a CPU tensor) or the reference. Logit and loss
tolerances are the JAX flash tests' 2e-3 (f32, summation order only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.train import trainer as trainer_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.train import trainer as trainer_torch

TOL = 2e-3
# JAX attention_impl -> the port's name for the same path.
IMPLS = {"pallas": "kernel", "reference": "reference"}


def _configs(jax_impl="reference", jax_dtype=jnp.float32, **kw):
    cfg_j = dataclasses.replace(llama_jax.LlamaConfig.tiny(vocab_size=256),
                                dtype=jax_dtype, attention_impl=jax_impl,
                                **kw)
    torch_dtype = {jnp.float32: torch.float32,
                   jnp.bfloat16: torch.bfloat16}[jax_dtype]
    cfg_t = dataclasses.replace(llama_torch.LlamaConfig.tiny(vocab_size=256),
                                dtype=torch_dtype,
                                attention_impl=IMPLS[jax_impl], **kw)
    return cfg_j, cfg_t


def _init_both(cfg_j, cfg_t, seed=0):
    params_j = llama_jax.init(cfg_j, jax.random.key(seed))
    params_np = jax.tree.map(np.asarray, params_j)
    return params_j, convert.llama_params_from_jax(cfg_t, params_np, "cpu")


def _tokens(seed=1, b=2, s=64, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


@pytest.mark.parametrize("jax_dtype", [jnp.float32, jnp.bfloat16])
def test_convert_round_trip(jax_dtype):
    cfg_j, cfg_t = _configs(jax_dtype=jax_dtype)
    params_j, params_t = _init_both(cfg_j, cfg_t)
    assert params_t.embed.dtype == cfg_t.dtype
    assert tuple(params_t.layers[0].wq.shape) == (cfg_t.dim, cfg_t.dim)
    back = convert.llama_params_to_numpy(params_t)
    flat_j = jax.tree_util.tree_leaves_with_path(params_j)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        got = flat_b[path]
        assert got.shape == leaf.shape and got.dtype == leaf.dtype, path
        np.testing.assert_array_equal(got.view(np.uint8),
                                      np.asarray(leaf).view(np.uint8))
    if jax_dtype == jnp.bfloat16:
        assert back["embed"].dtype == ml_dtypes.bfloat16


@pytest.mark.parametrize("jax_impl", ["pallas", "reference"])
def test_forward_matches_jax(jax_impl):
    cfg_j, cfg_t = _configs(jax_impl)
    params_j, params_t = _init_both(cfg_j, cfg_t)
    tokens = _tokens()
    ref = np.asarray(llama_jax.forward(cfg_j, params_j, jnp.asarray(tokens)))
    with torch.no_grad():
        out = llama_torch.forward(cfg_t, params_t,
                                  torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_trunk_chunked_loss_matches_jax(monkeypatch):
    # Chunk width 16 so the 63-token loss runs four chunks, the last one
    # short; a mask drops some positions.
    monkeypatch.setattr(trainer_jax, "CE_CHUNK", 16)
    monkeypatch.setattr(trainer_torch, "CE_CHUNK", 16)
    cfg_j, cfg_t = _configs()
    params_j, params_t = _init_both(cfg_j, cfg_t)
    tokens = _tokens(2)
    mask = (np.random.default_rng(3).random(tokens.shape) > 0.2).astype(
        np.float32)

    def loss_jax(p):
        hidden = llama_jax.forward_trunk(cfg_j, p, jnp.asarray(tokens))
        return trainer_jax.chunked_cross_entropy_loss(
            hidden[:, :-1], llama_jax.head_weights(p),
            jnp.asarray(tokens)[:, 1:], jnp.asarray(mask)[:, 1:])

    loss_j, grads_j = jax.value_and_grad(loss_jax)(params_j)
    tok_t = torch.from_numpy(tokens).long()
    hidden = llama_torch.forward_trunk(cfg_t, params_t, tok_t)
    loss_t = trainer_torch.chunked_cross_entropy_loss(
        hidden[:, :-1], llama_torch.head_weights(params_t), tok_t[:, 1:],
        torch.from_numpy(mask)[:, 1:])
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=TOL)
    np.testing.assert_allclose(params_t.lm_head.grad.numpy(),
                               np.asarray(grads_j["lm_head"]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(params_t.layers[1].wq.grad.numpy(),
                               np.asarray(grads_j["layers"]["wq"][1]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches_jax(offset):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    ref = llama_jax.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)
    out = llama_torch.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                               1e-5, offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_rope_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 16)).astype(np.int32)
    ref = llama_jax.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    out = llama_torch.rope(torch.from_numpy(x), torch.from_numpy(pos),
                           500000.0)
    # fp32 angles up to 4096 rad: cos/sin of large arguments differ by a
    # few ulps of the angle between the two libraries.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["llama3_8b", "tiny"])
def test_config_counts_match_jax(name):
    cfg_j = getattr(llama_jax.LlamaConfig, name)()
    cfg_t = getattr(llama_torch.LlamaConfig, name)()
    assert cfg_t.num_params() == cfg_j.num_params()
    assert cfg_t.flops_per_token() == cfg_j.flops_per_token()
    assert cfg_t.flops_per_token(2048) == cfg_j.flops_per_token(2048)
    assert cfg_t.head_dim == cfg_j.head_dim


# The save_flash* policies run (tests/test_torch_remat.py); a misspelt
# name raises rather than silently degrading to full remat.
@pytest.mark.parametrize("policy,error", [("save_flsh", ValueError)])
def test_remat_policies_beyond_full_raise(policy, error):
    _, cfg_t = _configs(remat_policy=policy)
    params_t = llama_torch.init(cfg_t, torch.Generator().manual_seed(0),
                                "cpu")
    with pytest.raises(error):
        llama_torch.forward(cfg_t, params_t, torch.zeros(1, 8,
                                                         dtype=torch.long))
