"""The port's small recipes (``recipes/{mnist,glue_imdb,resnet_ddp}.py``)
against the JAX package's, on the CPU in f32.

* ``synthetic_data.mnist_like`` / ``imdb_like``: the same arrays, bit for
  bit, for a seed.
* From the flax variables carried across (``convert.*_from_flax``), the
  CNN, ``TextClassifier`` and the tiny ``ResNet`` give JAX's logits, and
  JAX's gradients and parameters after one optimizer step of the
  recipe's (adam, adamw at decay 1e-4, SGD with momentum 0.9), within
  ``TOL`` (the attention's key bias, whose gradient is zero, and an
  element whose gradient is rounding, by its gradient: ``_check``). flax's
  ``"SAME"`` padding against ``lax.padtype_to_pads``, asymmetric cases
  included.
* The recipes' gates at the JAX tests' step counts: mnist 120 steps >
  0.8, glue_imdb 80 steps > 0.75.
* ``resnet_ddp --tiny`` on two gloo ranks (``tests/torch_rank_worker.py``
  under the SKYPILOT_* env, each with a timeout): equal digests, and
  parameters within ``TOL`` of one process's run on the joined batch.
"""
import copy
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from skypilot_tpu.recipes import glue_imdb as glue_jax
from skypilot_tpu.recipes import mnist as mnist_jax
from skypilot_tpu.recipes import resnet_ddp as resnet_jax
from skypilot_tpu.recipes import synthetic_data as data_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.recipes import glue_imdb, layers, mnist, resnet_ddp
from skypilot_tpu_torch.recipes import synthetic_data

TOL = 1e-5
# Gradients agree with JAX's to ~6e-8 in f32 here; below this an
# element's gradient is rounding on either side.
GRAD_NOISE = 1e-7
NOISE_SHARE = 1e-2
DDP_ARGS = ["--device", "cpu", "--tiny", "--steps", "3", "--batch-size",
            "4"]


def test_synthetic_data_bit_equal_to_jax():
    for got, want in ((synthetic_data.mnist_like(3, 64),
                       data_jax.mnist_like(3, 64)),
                      (synthetic_data.imdb_like(3, 32, seq_len=64),
                       data_jax.imdb_like(3, 32, seq_len=64))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,k,s", [(224, 7, 2), (112, 3, 2), (56, 3, 2),
                                   (32, 7, 2), (7, 3, 2), (28, 3, 1),
                                   (9, 1, 2)])
def test_same_padding_as_lax(n, k, s):
    assert list(layers.same_pads(n, k, s)) == list(
        jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(module, x):
    return _np(jax.jit(module.init)(jax.random.PRNGKey(0), x))


def _one_step(module, variables, tx, x, y):
    """JAX's logits, gradients and parameters after one step of ``tx``."""
    def loss_fn(params):
        logits = module.apply(params, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    @jax.jit
    def step(variables):
        grads = jax.grad(loss_fn)(variables)
        updates, _ = tx.update(grads, tx.init(variables), variables)
        return (module.apply(variables, x), grads,
                optax.apply_updates(variables, updates))
    return _np(step(variables))


def _check(model, load, jax_out, opt, x, y, zero_grad=()):
    """The port's logits, gradients and parameters after one step of
    ``opt`` against JAX's (read into the port's layout through ``load``).

    A parameter whose gradient is zero in exact arithmetic (named by a
    suffix in ``zero_grad``) and an element whose gradient is not zero
    but below the gradients' rounding (``GRAD_NOISE``; fewer than
    ``NOISE_SHARE`` of a parameter's) are held by their gradient only:
    Adam divides each side's rounding noise by its own magnitude, so
    their update is noise."""
    jax_logits, jax_grads, jax_after = jax_out
    logits = model(x)
    np.testing.assert_allclose(logits.detach().numpy(), jax_logits,
                               rtol=TOL, atol=TOL)
    loss = F.cross_entropy(logits, y)
    opt.zero_grad()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()
    grad_ref = load(copy.deepcopy(model), jax_grads)
    ref = load(copy.deepcopy(model), jax_after)
    for (name, got), exp, g_exp in zip(model.named_parameters(),
                                       ref.parameters(),
                                       grad_ref.parameters()):
        np.testing.assert_allclose(grads[name].numpy(),
                                   g_exp.detach().numpy(), rtol=0,
                                   atol=TOL, err_msg=name)
        if name.endswith(zero_grad):
            assert g_exp.abs().max() < TOL, name
            continue
        held = (g_exp.abs() >= GRAD_NOISE) | (g_exp == 0)
        assert (~held).float().mean() < NOISE_SHARE, name
        np.testing.assert_allclose(got.detach()[held].numpy(),
                                   exp.detach()[held].numpy(), rtol=0,
                                   atol=TOL, err_msg=name)


def test_cnn_matches_flax():
    x, y = data_jax.mnist_like(0, 16)
    variables = _init(mnist_jax.CNN(), jnp.zeros((1, 28, 28, 1)))
    out = _one_step(mnist_jax.CNN(), variables, optax.adam(1e-3),
                    jnp.asarray(x), jnp.asarray(y))
    model = convert.cnn_from_flax(mnist.CNN(), variables)
    _check(model, convert.cnn_from_flax, out,
           torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8),
           torch.from_numpy(x), torch.from_numpy(y).long())


def test_text_classifier_matches_flax():
    x, y = data_jax.imdb_like(0, 8, seq_len=32)
    module = glue_jax.TextClassifier()
    variables = _init(module, jnp.zeros((1, 32), jnp.int32))
    out = _one_step(module, variables, optax.adamw(3e-4), jnp.asarray(x),
                    jnp.asarray(y))
    model = convert.text_classifier_from_flax(glue_imdb.TextClassifier(32),
                                              variables)
    # Softmax is invariant to a constant added to one query's scores,
    # which is what the key bias adds: its gradient is zero.
    _check(model, convert.text_classifier_from_flax, out,
           glue_imdb.make_optimizer(model, 3e-4),
           torch.from_numpy(x).long(), torch.from_numpy(y).long(),
           zero_grad=("attn.key_bias",))


def test_resnet_matches_flax():
    module = resnet_jax.ResNet(stage_sizes=(1, 1), width=8, n_classes=10)
    r = np.random.RandomState(0)
    x = r.randn(4, 32, 32, 3).astype(np.float32)
    y = r.randint(0, 10, size=(4,)).astype(np.int32)
    variables = _init(module, jnp.zeros((1, 32, 32, 3)))
    out = _one_step(module, variables, optax.sgd(1e-1, momentum=0.9),
                    jnp.asarray(x), jnp.asarray(y))
    model = convert.resnet_from_flax(resnet_ddp.ResNet(**resnet_ddp.TINY),
                                     variables)
    _check(model, convert.resnet_from_flax, out,
           torch.optim.SGD(model.parameters(), lr=1e-1, momentum=0.9),
           torch.from_numpy(x), torch.from_numpy(y).long())


def test_mnist_converges():
    metrics = mnist.main(["--device", "cpu", "--steps", "120"])
    assert metrics["test_accuracy"] > 0.8


def test_glue_imdb_converges():
    metrics = glue_imdb.main(["--device", "cpu", "--steps", "80"])
    assert metrics["test_accuracy"] > 0.75


def _joined_run(argv):
    """One process, no group: every step on the two ranks' batches
    joined, with the recipe's model, data and optimizer."""
    args = resnet_ddp.build_arg_parser().parse_args(argv)
    args.image_size = resnet_ddp.TINY_IMAGE
    model = resnet_ddp.make_model(args, torch.device("cpu"))
    opt = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    for i in range(args.steps):
        parts = [resnet_ddp.sample_batch(args, i, r, 2, 10)
                 for r in range(2)]
        x = np.concatenate([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
        loss = F.cross_entropy(model(torch.from_numpy(x)),
                               torch.from_numpy(y).long())
        opt.zero_grad()
        loss.backward()
        opt.step()
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def test_resnet_ddp_two_ranks_equal_the_joined_batch(tmp_path):
    from torch_rank_worker import launch
    outs = launch(lambda r: ["resnet", str(tmp_path), *DDP_ARGS,
                             "--out-file", str(tmp_path / f"out_{r}.json")],
                  2)
    assert "rank=0/2" in outs[0] and "rank=1/2" in outs[1]
    assert "backend=gloo" in outs[0]
    got = [json.loads((tmp_path / f"out_{r}.json").read_text())
           for r in range(2)]
    assert got[0]["param_digest"] == got[1]["param_digest"]
    assert [g["rank"] for g in got] == [0, 1]
    assert set(got[0]) == {"recipe", "rank", "num_nodes", "steps",
                           "final_loss", "p50_iter_seconds",
                           "examples_per_second", "param_digest"}
    params = pickle.loads((tmp_path / "params_0.pkl").read_bytes())
    want = _joined_run(DDP_ARGS)
    assert set(params) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(params[name], w, rtol=0, atol=TOL,
                                   err_msg=name)


def test_resnet_ddp_world_one_writes_its_out_file(tmp_path):
    out = tmp_path / "m.json"
    metrics = resnet_ddp.main(DDP_ARGS + ["--out-file", str(out)])
    assert json.loads(out.read_text()) == metrics
    assert metrics["rank"] == 0 and np.isfinite(metrics["final_loss"])
