"""The port's LoRA path (skypilot_tpu_torch.models.llama.lora_dense, the
adapters under every remat policy, and recipes.llama_lora's step) against
the JAX package's, on the CPU in f32.

* ``lora_dense`` in its three forms (plain, with adapters, int8 weight
  with a per-output-channel scale) on the same numbers: within 1e-5
  (f32), and in bf16 within bf16's rounding of the output (2e-2).
* The tiny Llama (2 layers) with adapters under ``full``, ``save_flash``,
  ``save_flash_qkv`` and ``save_flash_offload_qkv``, on a float base and
  on an int8 one (codes and per-output-channel scales): the loss within
  2e-3 of JAX's (its Pallas kernels in interpret mode, the port's plain
  versions on the CPU), each adapter's (and each trained scale's)
  gradient within 5e-3, and no other base weight gets a gradient.
* Three steps of the recipe's step function against the JAX recipe's
  ``step_fn`` (merge, stop_gradient on the base, value_and_grad over the
  adapters, ``optax.adamw(lr)``) from the same converted base and
  adapters on the same ``synthetic_data`` batches, which are first held
  equal: losses within 2e-3, adapters within 2e-3 of how far they moved.
* The recipe's training telemetry (``observability/trainstats``), armed
  on the CPU: the four ``train_*`` keys (MFU None: the CPU has no peak),
  the delayed losses in the ring, the host JSONL and ``snapshot.json``;
  a crash leaves a ``train_crash`` flight dump with the steps before it;
  disarmed, the loop touches no trainstats function and writes no file.
"""
import dataclasses
import json
import os
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.recipes import llama_lora as lora_jax
from skypilot_tpu.recipes import synthetic_data as data_jax
from skypilot_tpu.train import trainer as trainer_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.observability import trainstats
from skypilot_tpu_torch.recipes import llama_lora as lora_torch
from skypilot_tpu_torch.recipes import synthetic_data as data_torch

LOSS_TOL = 2e-3
GRAD_TOL = 5e-3
MOVE_TOL = 2e-3
POLICIES = ["full", "save_flash", "save_flash_qkv", "save_flash_offload_qkv"]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("form", ["plain", "adapters", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_dense_matches_jax(form, dtype):
    rng = np.random.default_rng(0)
    y = rng.standard_normal((2, 5, 48)).astype(np.float32)
    lp = {"wq": (rng.standard_normal((48, 40)) * 0.2).astype(np.float32)}
    if form == "adapters":
        lp["wq_lora_a"] = rng.standard_normal((48, 4)).astype(np.float32)
        lp["wq_lora_b"] = rng.standard_normal((4, 40)).astype(np.float32)
    if form == "int8":
        lp["wq"] = rng.integers(-127, 128, (48, 40)).astype(np.int8)
        lp["wq_scale"] = (rng.random(40) * 0.01).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def cast_j(k, v):
        return v if k.endswith("_scale") or v.dtype == np.int8 else \
            jnp.asarray(v).astype(jdt)

    def cast_t(k, v):
        t = torch.from_numpy(v)
        return t if k.endswith("_scale") or v.dtype == np.int8 else \
            t.to(tdt)

    want = llama_jax.lora_dense(jnp.asarray(y).astype(jdt),
                                {k: cast_j(k, v) for k, v in lp.items()},
                                "wq")
    got = llama_torch.lora_dense(
        torch.from_numpy(y).to(tdt),
        types.SimpleNamespace(**{k: cast_t(k, v) for k, v in lp.items()}),
        "wq")
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _tiny(policy, impl_j="pallas", impl_t="kernel", n_layers=2):
    cfg_j = dataclasses.replace(llama_jax.LlamaConfig.tiny(vocab_size=256),
                                dtype=jnp.float32, attention_impl=impl_j,
                                remat_policy=policy, n_layers=n_layers)
    cfg_t = dataclasses.replace(llama_torch.LlamaConfig.tiny(vocab_size=256),
                                dtype=torch.float32, attention_impl=impl_t,
                                remat_policy=policy, n_layers=n_layers)
    return cfg_j, cfg_t


def _base_and_lora(cfg_j, cfg_t, random_b):
    base_j = llama_jax.init(cfg_j, jax.random.key(0))
    lora_j = lora_jax.init_lora(cfg_j, 4, jax.random.key(1))
    if random_b:  # B = 0 at init would give A no gradient
        keys = jax.random.split(jax.random.key(2), len(lora_j["layers"]))
        lora_j = {"layers": {
            n: (jax.random.normal(k, v.shape, v.dtype) * 0.1
                if n.endswith("_lora_b") else v)
            for k, (n, v) in zip(keys, sorted(lora_j["layers"].items()))}}
    base_t = convert.llama_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, base_j), "cpu")
    base_t.requires_grad_(False)
    lora_t = convert.lora_from_jax(cfg_t, jax.tree.map(np.asarray, lora_j),
                                   "cpu")
    return base_j, lora_j, lora_torch.merge_params(base_t, lora_t), lora_t


def _ce_jax(cfg_j, base_j, lora_j, tokens):
    logits = llama_jax.forward(cfg_j, lora_jax.merge_params(base_j, lora_j),
                               tokens)
    return trainer_jax.cross_entropy_loss(logits[:, :-1], tokens[:, 1:])


def _quantize_layers(base_j, params_t):
    """Every layer weight of both trees becomes int8 codes with a
    per-output-channel f32 scale (the JAX package's ``_quantize_weight``,
    the codes shared); the port's scales require a gradient. Returns the
    JAX tree and its scales."""
    layers = dict(base_j["layers"])
    scales = {}
    for name in llama_jax.QUANT_LAYER_WEIGHTS:
        layers[name], scales[name + "_scale"] = llama_jax._quantize_weight(
            layers[name], -2)
        codes, sc = np.asarray(layers[name]), np.asarray(scales[name +
                                                                "_scale"])
        for i, lp in enumerate(params_t.layers):
            setattr(lp, name, torch.nn.Parameter(
                torch.from_numpy(codes[i].copy()), requires_grad=False))
            setattr(lp, name + "_scale",
                    torch.nn.Parameter(torch.from_numpy(sc[i].copy())))
    return {**base_j, "layers": {**layers, **scales}}, scales


@pytest.mark.parametrize("base", ["float", "int8"])
@pytest.mark.parametrize("policy", POLICIES)
def test_adapter_grads_match_jax(policy, base, monkeypatch):
    """With an int8 base, the scales are trained beside the adapters, so
    the transpose that save_flash_qkv takes by hand covers every branch
    of ``lora_dense``."""
    calls = []
    apply = llama_torch._FlashRematLayer.apply

    def spy(cfg, pol, *args):
        calls.append(pol)
        return apply(cfg, pol, *args)
    monkeypatch.setattr(llama_torch._FlashRematLayer, "apply", spy)
    cfg_j, cfg_t = _tiny(policy)
    base_j, lora_j, params_t, lora_t = _base_and_lora(cfg_j, cfg_t, True)
    trained = set(lora_t.names())
    if base == "int8":
        base_j, scales = _quantize_layers(base_j, params_t)
        lora_j = {"layers": {**lora_j["layers"], **scales}}
        trained |= set(scales)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 32),
                                               dtype=np.int32)
    base_j = jax.tree.map(jax.lax.stop_gradient, base_j)
    loss_j, grads_j = jax.value_and_grad(
        lambda lo: _ce_jax(cfg_j, base_j, lo, jnp.asarray(tokens)))(lora_j)
    tok = torch.from_numpy(tokens).long()
    logits = llama_torch.forward(cfg_t, params_t, tok)
    loss_t = lora_torch.trainer.cross_entropy_loss(logits[:, :-1],
                                                   tok[:, 1:])
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_TOL)
    for name, p in params_t.named_parameters():
        if name.split(".")[-1] not in trained:
            assert p.grad is None, name
    # The save_flash* policies ran their own layer Function, not "full".
    assert calls == ([] if policy == "full" else [policy] * cfg_t.n_layers)
    assert set(grads_j["layers"]) == trained
    for name, want in grads_j["layers"].items():
        want = np.asarray(want)
        got = np.stack([getattr(lp, name).grad.numpy()
                        for lp in params_t.layers])
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=name)


def test_synthetic_data_as_jax():
    data_j = data_jax.lm_tokens(5, 16, 24, 300)
    data_t = data_torch.lm_tokens(5, 16, 24, 300)
    np.testing.assert_array_equal(data_t, data_j)
    for skip in (0, 3):
        got = list(data_torch.batches((data_t,), 4, 9, 5, skip=skip))
        want = list(data_jax.batches((data_j,), 4, 9, 5, skip=skip))
        assert len(got) == len(want) == 5
        for (a,), (b,) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_recipe_steps_match_jax():
    lr = 1e-2
    cfg_j, cfg_t = _tiny("full", impl_j="reference", impl_t="reference")
    base_j, lora_j, params_t, lora_t = _base_and_lora(cfg_j, cfg_t, False)
    init = convert.lora_to_numpy(lora_t)
    tx = optax.adamw(lr)
    opt_j = tx.init(lora_j)

    @jax.jit
    def step_j(lora, opt_state, tokens):
        base = jax.tree.map(jax.lax.stop_gradient, base_j)
        loss, grads = jax.value_and_grad(
            lambda lo: _ce_jax(cfg_j, base, lo, tokens))(lora)
        updates, opt_state = tx.update(grads, opt_state, lora)
        return optax.apply_updates(lora, updates), opt_state, loss

    opt_t = lora_torch.make_adamw(lora_t, lr)
    step_t = lora_torch.make_step_fn(llama_torch, cfg_t, params_t, lora_t,
                                     opt_t)
    data = data_torch.lm_tokens(0, 256, 32, cfg_t.vocab_size)
    np.testing.assert_array_equal(
        data, data_jax.lm_tokens(0, 256, 32, cfg_j.vocab_size))
    for (tokens,) in data_torch.batches((data,), 2, 0, 3):
        lora_j, opt_j, loss_j = step_j(lora_j, opt_j, jnp.asarray(tokens))
        loss_t = step_t(torch.from_numpy(tokens).long())
        np.testing.assert_allclose(loss_t.item(), float(loss_j),
                                   rtol=LOSS_TOL)
    got = convert.lora_to_numpy(lora_t)["layers"]
    for name, want in lora_j["layers"].items():
        want = np.asarray(want)
        moved = np.linalg.norm(want - init["layers"][name])
        assert moved > 0, name
        assert np.linalg.norm(got[name] - want) <= MOVE_TOL * moved, name


# ------------------------------------------------------ trainstats
RECIPE_ARGS = ["--device", "cpu", "--model", "tiny", "--batch-size", "2",
               "--seq-len", "32"]
TRAIN_KEYS = {"train_mfu", "train_goodput", "train_step_seconds",
              "train_tokens_per_sec"}


@pytest.fixture
def recipe_env(tmp_state_dir):
    """The recipe installs a SIGTERM handler and may arm fault injection;
    put both back, and leave trainstats disarmed and empty."""
    from skypilot_tpu_torch.utils import fault_injection
    old = signal.getsignal(signal.SIGTERM)
    yield tmp_state_dir
    signal.signal(signal.SIGTERM, old)
    fault_injection.clear()
    trainstats.disarm()
    trainstats.reset()


def test_armed_recipe_reports_train_keys(recipe_env, tmp_path,
                                         monkeypatch):
    out_dir = str(tmp_path / "ts")
    monkeypatch.setenv(trainstats.DIR_ENV, out_dir)
    trainstats.arm(ring=128, sync_every=1)
    trainstats.reset()
    metrics = lora_torch.main(RECIPE_ARGS + [
        "--steps", "3", "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--ckpt-every", "2"])
    assert TRAIN_KEYS <= set(metrics)
    assert metrics["train_mfu"] is None          # the CPU: no peak
    assert metrics["train_tokens_per_sec"] > 0
    assert metrics["train_step_seconds"] > 0
    goodput = metrics["train_goodput"]
    assert 0 < goodput["productive"] <= 1.0 and goodput["ckpt"] > 0
    snap = trainstats.snapshot()
    assert snap["total_steps"] == 3 and snap["job"] == "llama_lora"
    assert snap["sync"]["samples"] == 3 and snap["dispatch_ms_mean"] > 0
    # One step late: steps 1-2 carry their loss, the last is drained
    # into the metrics line only.
    recs = trainstats.steps_tail()
    assert [r["loss"] is not None for r in recs] == [True, True, False]
    assert recs[0]["loss"] == metrics["first_loss"]
    with open(os.path.join(out_dir, "snapshot.json")) as f:
        assert json.load(f)["job"] == "llama_lora"
    with open(os.path.join(out_dir, "host-0.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3]
    # A resumed run books its setup as restart downtime.
    trainstats.reset()
    resumed = lora_torch.main(RECIPE_ARGS + [
        "--steps", "4", "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert resumed["resumed_from"] == 3
    assert trainstats.snapshot()["downtime_s"] > 0
    assert resumed["train_goodput"]["restart"] > 0


def test_recipe_crash_dumps_flight(recipe_env, tmp_path, monkeypatch):
    from skypilot_tpu_torch.utils import fault_injection
    out_dir = str(tmp_path / "ts")
    monkeypatch.setenv(trainstats.DIR_ENV, out_dir)
    trainstats.arm(ring=128, sync_every=0)
    trainstats.reset()
    fault_injection.configure("train.step:raise:skip=2")
    with pytest.raises(fault_injection.InjectedFault):
        lora_torch.main(RECIPE_ARGS + ["--steps", "6"])
    dumps = trainstats.list_dumps(os.path.join(out_dir, "flightrec"))
    assert any("train_crash" in d for d in dumps)
    doc = trainstats.read_dump(dir_path=os.path.join(out_dir, "flightrec"))
    assert doc["reason"] == "train_crash"
    assert "InjectedFault" in doc["error"]
    assert [r["step"] for r in doc["steps"]] == [1, 2]


def test_disarmed_recipe_is_trainstats_free(recipe_env, tmp_path,
                                            monkeypatch):
    def _boom(*a, **k):
        raise AssertionError("trainstats touched while disarmed")

    out_dir = tmp_path / "ts"
    monkeypatch.setenv(trainstats.DIR_ENV, str(out_dir))
    trainstats.disarm()
    for name in ("configure", "record_step", "sampled_sync", "sync_due",
                 "snapshot", "flush", "dump_flight", "note_downtime",
                 "check_stragglers"):
        monkeypatch.setattr(trainstats, name, _boom)
    metrics = lora_torch.main(RECIPE_ARGS + ["--steps", "3"])
    assert metrics["steps"] == 3
    assert not TRAIN_KEYS & set(metrics)
    assert not out_dir.exists()


# ------------------------------------------------------ across ranks
MULTI_ARGS = ["--device", "cpu", "--model", "tiny", "--batch-size", "2",
              "--seq-len", "32", "--steps", "3", "--lr", "1e-2",
              "--ckpt-sync"]


def _tiny_f32():
    return dataclasses.replace(llama_torch.LlamaConfig.tiny(),
                               dtype=torch.float32)


def _ckpt_lora(path) -> dict:
    from skypilot_tpu_torch.train import checkpoint as ck
    tree = ck.restore_latest(path).tree
    return {k: np.asarray(v) for k, v in tree.items()
            if k.startswith("lora/")}


def _joined_run(args, ranks):
    """The one-process step fed, each step, every rank's batch joined."""
    cfg = _tiny_f32()
    base, lora = lora_torch.init_model(llama_torch, cfg, args,
                                       torch.device("cpu"))
    opt = lora_torch.make_adamw(lora, args.lr)
    step = lora_torch.make_step_fn(llama_torch, cfg,
                                   lora_torch.merge_params(base, lora), lora,
                                   opt)
    streams = [lora_torch.train_batches(cfg, args, args.steps, rank=r)
               for r in range(ranks)]
    for parts in zip(*streams):
        step(torch.from_numpy(np.concatenate([t for (t,) in parts])).long())
    return {f"lora/layers/{k}": v
            for k, v in convert.lora_to_numpy(lora)["layers"].items()}


def test_recipe_on_two_ranks_equals_the_joined_batch(tmp_path):
    from torch_rank_worker import launch
    outs = launch(lambda r: ["lora", str(tmp_path), *MULTI_ARGS,
                             "--checkpoint-dir", str(tmp_path / f"r{r}")],
                  2)
    assert "rank=0/2" in outs[0] and "rank=1/2" in outs[1]
    got = [_ckpt_lora(tmp_path / f"r{r}") for r in range(2)]
    assert set(got[0]) == set(got[1]) and got[0]
    for key in got[0]:
        np.testing.assert_array_equal(got[0][key], got[1][key])
    args = lora_torch.build_arg_parser(["tiny"], "tiny").parse_args(
        MULTI_ARGS)
    want = _joined_run(args, 2)
    init = _joined_run(_zero_steps(args), 2)
    for key, w in want.items():
        moved = np.linalg.norm(w - init[key])
        assert moved > 0, key
        assert np.linalg.norm(got[0][key] - w) <= MOVE_TOL * moved, key
        np.testing.assert_allclose(got[0][key], w, rtol=0,
                                   atol=args.lr / 2, err_msg=key)


def _zero_steps(args):
    out = type(args)(**vars(args))
    out.steps = 0
    return out


def test_one_rank_recipe_is_the_plain_step(tmp_path, monkeypatch,
                                           recipe_env):
    """With one process the recipe builds no mesh and makes no collective:
    its adapters are bit for bit those of the plain step loop."""
    tiny = llama_torch.LlamaConfig.tiny
    monkeypatch.setattr(llama_torch.LlamaConfig, "tiny", staticmethod(
        lambda vocab_size=512: dataclasses.replace(tiny(vocab_size),
                                                   dtype=torch.float32)))
    monkeypatch.setattr(torch.distributed, "all_reduce", None)
    lora_torch.main(MULTI_ARGS + ["--checkpoint-dir", str(tmp_path)])
    args = lora_torch.build_arg_parser(["tiny"], "tiny").parse_args(
        MULTI_ARGS)
    want = _joined_run(args, 1)
    got = _ckpt_lora(tmp_path)
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w)
