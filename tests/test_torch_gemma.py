"""The port's Gemma (skypilot_tpu_torch.models.gemma, recipes.gemma_lora)
against the JAX package's, on the CPU in f32 from the same converted
weights and numpy tokens.

* Config accounting (num_params, flops_per_token) equal to JAX's.
* The init tree: llama's module at gemma's shapes, zero norms, no
  ``lm_head`` unless ``tie_embeddings=False``; the convert round trip is
  byte-exact, and an untied head is the one the logits read.
* Logits and the gradients of a loss at ``GemmaConfig.tiny()`` (head_dim
  32) and at a head_dim-256 config (Gemma-2B's MQA head, the flash
  kernels' width 256), with JAX's attention both its Pallas kernels in
  interpret mode and its XLA reference: logits within 2e-3, gradients
  within 5e-3 (the JAX flash tests' own tolerances: f32, summation order
  only).
* The serving embed: ``_decode_embed`` and ``forward_with_cache`` apply
  the sqrt(dim) multiplier as JAX's do, in bf16 and on the int8 tree
  (the tied table's per-row scale times the multiplier).
* The LoRA loss and adapter gradients at the head_dim-256 config past
  the resident budget, where both packages take their triangular flash
  family (Gemma-2B past seq 2048), within the same tolerances.
* A few trainer steps whose loss falls; the LoRA recipe's step against
  the JAX recipe's ``step_fn`` logic, and ``gemma_lora.main`` against
  JAX's on what both report.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import gemma as gemma_jax
from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.ops.pallas import flash_attention as fa_jax
from skypilot_tpu.recipes import gemma_lora as gemma_lora_jax
from skypilot_tpu.recipes import llama_lora as lora_jax
from skypilot_tpu.train import trainer as trainer_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import gemma as gemma_torch
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.ops import flash_attention as fa_torch
from skypilot_tpu_torch.recipes import gemma_lora as gemma_lora_torch
from skypilot_tpu_torch.recipes import llama_lora as lora_torch
from skypilot_tpu_torch.recipes import synthetic_data as data_torch
from skypilot_tpu_torch.train import trainer as trainer_torch

TOL = 2e-3
GRAD_TOL = 5e-3
# bf16 serving logits: two libraries' bf16 roundings over 2 layers.
BF16_TOL = 3e-2
IMPLS = {"pallas": "kernel", "reference": "reference"}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (name, config fields, seq): the tiny config at 2 layers, and Gemma-2B's
# attention head (MQA, head_dim 256) at a small width.
CONFIGS = {
    "tiny": (dict(vocab_size=256, n_layers=2), 64),
    "d256": (dict(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                  n_kv_heads=1, head_dim_=256, mlp_dim=512), 128),
}


def _configs(name="tiny", jax_impl="reference", dtype="f32", **kw):
    fields, _ = CONFIGS[name]
    jdt, tdt = DTYPES[dtype]
    cfg_j = dataclasses.replace(gemma_jax.GemmaConfig.tiny(), **fields,
                                dtype=jdt, attention_impl=jax_impl, **kw)
    cfg_t = dataclasses.replace(gemma_torch.GemmaConfig.tiny(), **fields,
                                dtype=tdt, attention_impl=IMPLS[jax_impl],
                                **kw)
    return cfg_j, cfg_t


def _init_both(cfg_j, cfg_t, seed=0):
    params_j = gemma_jax.init(cfg_j, jax.random.key(seed))
    # Nonzero norm deltas, so the (1 + w) scale is exercised.
    keys = jax.random.split(jax.random.key(seed + 100), 3)
    params_j["final_norm"] = (0.1 * jax.random.normal(
        keys[0], params_j["final_norm"].shape)).astype(cfg_j.dtype)
    for k, name in zip(keys[1:], ("attn_norm", "mlp_norm")):
        leaf = params_j["layers"][name]
        params_j["layers"][name] = (0.1 * jax.random.normal(
            k, leaf.shape)).astype(cfg_j.dtype)
    params_t = convert.gemma_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return params_j, params_t


def _tokens(name="tiny", seed=1, b=2):
    fields, s = CONFIGS[name]
    return np.random.default_rng(seed).integers(
        0, fields["vocab_size"], (b, s), dtype=np.int32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------- the config

@pytest.mark.parametrize("name", ["tiny", "gemma_2b", "gemma_7b",
                                  "single_chip_bench"])
def test_config_counts_match_jax(name):
    cfg_j = getattr(gemma_jax.GemmaConfig, name)()
    cfg_t = getattr(gemma_torch.GemmaConfig, name)()
    for c_j, c_t in ((cfg_j, cfg_t),
                     (dataclasses.replace(cfg_j, tie_embeddings=False),
                      dataclasses.replace(cfg_t, tie_embeddings=False))):
        assert c_t.num_params() == c_j.num_params()
        assert c_t.flops_per_token() == c_j.flops_per_token()
        assert c_t.flops_per_token(2048) == c_j.flops_per_token(2048)
        assert c_t.head_dim == c_j.head_dim
        assert c_t.embed_multiplier == c_j.embed_multiplier


def test_gemma_2b_is_the_published_size():
    cfg = gemma_torch.GemmaConfig.gemma_2b()
    assert (cfg.n_layers, cfg.vocab_size, cfg.head_dim) == (18, 256000, 256)
    assert round(cfg.num_params() / 1e9, 3) == 2.506


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_init_tree_matches_jax_shapes(tied):
    cfg_j, cfg_t = _configs(tie_embeddings=tied)
    params_t = gemma_torch.init(cfg_t, torch.Generator().manual_seed(0),
                                "cpu")
    want = jax.tree.map(np.shape, gemma_jax.init(cfg_j, jax.random.key(0)))
    got = convert.gemma_params_to_numpy(params_t)
    assert jax.tree.map(np.shape, got) == want
    assert all(x.dtype == np.float32 for x in jax.tree.leaves(got))
    assert (params_t.lm_head is None) == tied
    for name in ("attn_norm", "mlp_norm"):
        assert not got["layers"][name].any(), name
    assert not got["final_norm"].any()
    assert sum(p.numel() for p in params_t.parameters()) == \
        cfg_t.num_params()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_convert_round_trip(dtype, tied):
    cfg_j, cfg_t = _configs(dtype=dtype, tie_embeddings=tied)
    params_j, params_t = _init_both(cfg_j, cfg_t)
    back = convert.gemma_params_to_numpy(params_t)
    flat_j = jax.tree_util.tree_leaves_with_path(params_j)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        got = flat_b[path]
        assert got.shape == leaf.shape and got.dtype == leaf.dtype, path
        np.testing.assert_array_equal(got.view(np.uint8),
                                      np.asarray(leaf).view(np.uint8))
    # A tree whose head does not match the config's is refused.
    other = dataclasses.replace(cfg_t, tie_embeddings=not tied)
    with pytest.raises(ValueError, match="lm_head"):
        convert.gemma_params_from_jax(other, back, "cpu")


def test_untied_head_honoured():
    # tie_embeddings=False: the logits read lm_head, not embed^T, as JAX's
    # do (tests/test_gemma.py::test_untied_head_honored).
    cfg_j, cfg_t = _configs(tie_embeddings=False)
    params_j, params_t = _init_both(cfg_j, cfg_t)
    tokens = _tokens()
    ref = np.asarray(gemma_jax.forward(cfg_j, params_j, jnp.asarray(tokens)))
    tok_t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        out = gemma_torch.forward(cfg_t, params_t, tok_t)
        np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
        params_t.lm_head.mul_(2.0)
        doubled = gemma_torch.forward(cfg_t, params_t, tok_t)
    np.testing.assert_allclose(doubled.numpy(), 2 * out.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------- forward and gradients

def _loss_jax(cfg_j, tokens):
    def loss(p):
        logits = gemma_jax.forward(cfg_j, p, jnp.asarray(tokens))
        return trainer_jax.cross_entropy_loss(logits[:, :-1],
                                              jnp.asarray(tokens)[:, 1:])
    return loss


@pytest.mark.parametrize("jax_impl", ["pallas", "reference"])
@pytest.mark.parametrize("name", ["tiny", "d256"])
def test_forward_matches_jax(name, jax_impl):
    cfg_j, cfg_t = _configs(name, jax_impl)
    params_j, params_t = _init_both(cfg_j, cfg_t)
    tokens = _tokens(name)
    ref = np.asarray(gemma_jax.forward(cfg_j, params_j, jnp.asarray(tokens)))
    with torch.no_grad():
        out = gemma_torch.forward(cfg_t, params_t,
                                  torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("jax_impl", ["pallas", "reference"])
@pytest.mark.parametrize("name", ["tiny", "d256"])
def test_gradients_match_jax(name, jax_impl):
    cfg_j, cfg_t = _configs(name, jax_impl)
    params_j, params_t = _init_both(cfg_j, cfg_t)
    tokens = _tokens(name, seed=2)
    loss_j, grads_j = jax.value_and_grad(_loss_jax(cfg_j, tokens))(params_j)
    tok_t = torch.from_numpy(tokens).long()
    logits = gemma_torch.forward(cfg_t, params_t, tok_t)
    loss_t = trainer_torch.cross_entropy_loss(logits[:, :-1], tok_t[:, 1:])
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=TOL)
    for path, g in jax.tree_util.tree_leaves_with_path(grads_j):
        keys = [k.key for k in path]
        if keys[0] == "layers":
            t = torch.stack([getattr(lp, keys[1]).grad
                             for lp in params_t.layers])
        else:
            t = getattr(params_t, keys[0]).grad
        np.testing.assert_allclose(t.numpy(), np.asarray(g), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=str(keys))


@pytest.fixture
def past_budget(monkeypatch):
    """Both packages past the resident flash budget. JAX keeps traces of
    its flash op keyed on the function, not on the patched budget, so its
    caches are cleared on entry and on exit."""
    jax.clear_caches()
    monkeypatch.setattr(fa_jax, "_use_resident", lambda s, d: False)
    monkeypatch.setattr(fa_torch, "_use_resident", lambda s, d: False)
    yield
    jax.clear_caches()


def test_d256_lora_past_budget_matches_jax(monkeypatch, past_budget):
    # Gemma-2B's attention head (MQA, head_dim 256) past the budget, as at
    # seq 4096-8192: JAX's Pallas triangular kernels (interpret mode)
    # against the port's triangular family on the converted base and
    # adapters (B nonzero, so both adapters have gradients): the recipe's
    # loss and the adapters' gradients.
    cfg_j, cfg_t = _configs("d256", "pallas")
    base_j, base_t = _init_both(cfg_j, cfg_t)
    base_t.requires_grad_(False)
    lora_j = lora_jax.init_lora(cfg_j, 4, jax.random.key(3))
    lora_j["layers"] = {
        name: (0.05 * jax.random.normal(jax.random.key(4 + i), a.shape)
               ).astype(a.dtype) if name.endswith("_lora_b") else a
        for i, (name, a) in enumerate(sorted(lora_j["layers"].items()))}
    lora_t = convert.lora_from_jax(cfg_t, jax.tree.map(np.asarray, lora_j),
                                   "cpu")
    params_t = lora_torch.merge_params(base_t, lora_t)
    tokens = _tokens("d256", seed=5)

    def loss_j(lora):
        base = jax.tree.map(jax.lax.stop_gradient, base_j)
        logits = gemma_jax.forward(cfg_j, lora_jax.merge_params(base, lora),
                                   jnp.asarray(tokens))
        return trainer_jax.cross_entropy_loss(logits[:, :-1],
                                              jnp.asarray(tokens)[:, 1:])

    value_j, grads_j = jax.value_and_grad(loss_j)(lora_j)
    calls = []
    for name in ("flash_fwd_plain", "flash_bwd_plain", "flash_fwd_tri_plain",
                 "flash_bwd_tri_plain"):
        fn = getattr(fa_torch, name)
        monkeypatch.setattr(fa_torch, name, lambda *a, _n=name, _f=fn: (
            calls.append(_n) or _f(*a)))
    tok_t = torch.from_numpy(tokens).long()
    logits = gemma_torch.forward(cfg_t, params_t, tok_t)
    loss_t = trainer_torch.cross_entropy_loss(logits[:, :-1], tok_t[:, 1:])
    loss_t.backward()
    assert set(calls) == {"flash_fwd_tri_plain", "flash_bwd_tri_plain"}
    assert calls.count("flash_bwd_tri_plain") == cfg_t.n_layers
    np.testing.assert_allclose(loss_t.item(), float(value_j), rtol=TOL)
    for name, g in grads_j["layers"].items():
        t = torch.stack([getattr(lp, name).grad for lp in lora_t.layers])
        assert float(np.abs(np.asarray(g)).max()) > 0, name
        np.testing.assert_allclose(t.numpy(), np.asarray(g), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


# ----------------------------------------------------------- serving embed

def _serving_pair(dtype, quantized):
    """(cfg_j, cfg_t, params_j, params_t) for the serving paths: the tiny
    config, and with ``quantized`` JAX's int8 tree carried over as it is,
    so both sides read the same codes and scales."""
    cfg_j, cfg_t = _configs(dtype=dtype)
    params_j, params_t = _init_both(cfg_j, cfg_t)
    if quantized:
        params_j = llama_jax.quantize_params(cfg_j, params_j)
        params_t = convert.gemma_params_from_jax(
            cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


@pytest.mark.parametrize("dtype,quantized", [("bf16", False),
                                             ("f32", True)],
                         ids=["bf16", "int8"])
def test_decode_embed_applies_the_multiplier_as_jax(dtype, quantized):
    # JAX scales the gathered rows by sqrt(dim) (times the int8 table's
    # per-row scale, in f32, then one cast); so must the port, or every
    # served token reads embeddings sqrt(dim) too small.
    cfg_j, cfg_t, params_j, params_t = _serving_pair(dtype, quantized)
    tokens = _tokens(seed=3)
    want = llama_jax._decode_embed(cfg_j, params_j, jnp.asarray(tokens))
    with torch.no_grad():
        got = llama_torch._decode_embed(cfg_t, params_t,
                                        torch.from_numpy(tokens).long())
    assert got.dtype == cfg_t.dtype
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("dtype,quantized,tol", [("bf16", False, BF16_TOL),
                                                 ("f32", True, TOL)],
                         ids=["bf16", "int8"])
@torch.no_grad()
def test_forward_with_cache_matches_jax(dtype, quantized, tol):
    # A ragged prefill then one decode step through the dense cache.
    cfg_j, cfg_t, params_j, params_t = _serving_pair(dtype, quantized)
    b, max_seq = 2, 32
    prompt = _tokens(seed=4)[:, :12]
    lens = np.array([12, 7])
    cache_j = gemma_jax.init_cache(cfg_j, b, max_seq)
    cache_t = gemma_torch.init_cache(cfg_t, b, max_seq, "cpu")
    out_j, cache_j = gemma_jax.forward_with_cache(
        cfg_j, params_j, jnp.asarray(prompt), cache_j, 0,
        valid_len=jnp.asarray(lens))
    out_t, cache_t = gemma_torch.forward_with_cache(
        cfg_t, params_t, torch.from_numpy(prompt).long(), cache_t, 0,
        valid_len=lens)
    step = np.array([[5], [9]], np.int32)
    z_j, _ = gemma_jax.forward_with_cache(cfg_j, params_j,
                                          jnp.asarray(step), cache_j,
                                          jnp.asarray(lens))
    z_t, _ = gemma_torch.forward_with_cache(
        cfg_t, params_t, torch.from_numpy(step).long(), cache_t, lens)
    for a, ref in ((out_t, out_j), (z_t, z_j)):
        ref = np.asarray(ref.astype(jnp.float32))
        mask = np.arange(ref.shape[1])[None, :] < lens[:, None]
        if ref.shape[1] == 1:
            mask = np.ones(ref.shape[:2], bool)
        assert _rel(a.float().numpy()[mask], ref[mask]) < tol


# --------------------------------------------------------------- training

def test_training_steps_lower_the_loss():
    _, cfg_t = _configs("tiny")
    params = gemma_torch.init(cfg_t, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens(seed=5)).long()
    tx = trainer_torch.make_optimizer(trainer_torch.TrainConfig(
        warmup_steps=1, total_steps=100, learning_rate=1e-2))
    state = trainer_torch.init_train_state(params, tx)
    step = trainer_torch.make_train_step(
        lambda p, t: gemma_torch.forward(cfg_t, p, t), tx,
        with_grad_norm=False)
    losses = []
    for _ in range(6):
        state, metrics = step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_recipe_steps_match_jax():
    # The recipe's step on the converted base and adapters against the
    # JAX recipe's step_fn logic (merge, stop_gradient on the base,
    # value_and_grad over the adapters, optax.adamw) on the same batches.
    lr = 1e-2
    cfg_j, cfg_t = _configs("tiny")
    base_j, _ = _init_both(cfg_j, cfg_t)
    lora_j = lora_jax.init_lora(cfg_j, 4, jax.random.key(1))
    base_t = convert.gemma_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, base_j), "cpu")
    base_t.requires_grad_(False)
    lora_t = convert.lora_from_jax(cfg_t, jax.tree.map(np.asarray, lora_j),
                                   "cpu")
    params_t = lora_torch.merge_params(base_t, lora_t)
    init = convert.lora_to_numpy(lora_t)
    tx = optax.adamw(lr)
    opt_j = tx.init(lora_j)

    @jax.jit
    def step_j(lora, opt_state, tokens):
        base = jax.tree.map(jax.lax.stop_gradient, base_j)

        def loss(lo):
            logits = gemma_jax.forward(
                cfg_j, lora_jax.merge_params(base, lo), tokens)
            return trainer_jax.cross_entropy_loss(logits[:, :-1],
                                                  tokens[:, 1:])
        value, grads = jax.value_and_grad(loss)(lora)
        updates, opt_state = tx.update(grads, opt_state, lora)
        return optax.apply_updates(lora, updates), opt_state, value

    step_t = lora_torch.make_step_fn(gemma_torch, cfg_t, params_t, lora_t,
                                     lora_torch.make_adamw(lora_t, lr))
    data = data_torch.lm_tokens(0, 256, 32, cfg_t.vocab_size)
    for (tokens,) in data_torch.batches((data,), 2, 0, 3):
        lora_j, opt_j, loss_j = step_j(lora_j, opt_j, jnp.asarray(tokens))
        loss_t = step_t(torch.from_numpy(tokens).long())
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=TOL)
    got = convert.lora_to_numpy(lora_t)["layers"]
    for name, want in lora_j["layers"].items():
        want = np.asarray(want)
        moved = np.linalg.norm(want - init["layers"][name])
        assert moved > 0, name
        assert np.linalg.norm(got[name] - want) <= TOL * moved, name


def test_recipe_main_reports_as_jax(tmp_path):
    # The two recipes' own mains on --model tiny: the same adapters and
    # base counted, finite losses, and a checkpoint at the last step that
    # the port resumes from.
    argv = ["--model", "tiny", "--steps", "2", "--batch-size", "2",
            "--seq-len", "32", "--ckpt-every", "2"]
    with contextlib.redirect_stdout(io.StringIO()):
        want = gemma_lora_jax.main(argv)
        got = gemma_lora_torch.main(
            argv + ["--device", "cpu", "--checkpoint-dir", str(tmp_path)])
        again = gemma_lora_torch.main(
            ["--model", "tiny", "--steps", "3", "--batch-size", "2",
             "--seq-len", "32", "--device", "cpu", "--checkpoint-dir",
             str(tmp_path)])
    for key in ("recipe", "model", "lora_params", "base_params", "steps"):
        assert got[key] == want[key], key
    assert got["recipe"] == "gemma_lora"
    assert np.isfinite([got["first_loss"], got["final_loss"]]).all()
    assert got["last_ckpt_step"] == 2 and again["resumed_from"] == 2
