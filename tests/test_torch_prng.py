"""The port's threefry sampling keys (skypilot_tpu_torch.serve.prng) against
jax.random (JAX 0.9.0: threefry2x32, jax_threefry_partitionable on), on
the CPU.

Keys, bits and uniforms are held bit-equal. The gumbel transform runs
torch's log, which may round differently from XLA's: the draws are held
within 1e-6 absolute of JAX's, and a sampled token may differ from JAX's
only at a near-tie, where JAX's own two best perturbed logits lie within
NEAR_TIE of each other; such rows are counted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.serve import decode_engine as engine_jax
from skypilot_tpu_torch.serve import prng

SEEDS = (0, 1, 17, 2**31 + 5, 2**32 - 1)
POSITIONS = (0, 1, 63, 1023, 4095)
GUMBEL_TOL = 1e-6
NEAR_TIE = 1e-5


def _jax_keys():
    root = jax.random.key(0)
    return [jax.random.fold_in(jax.random.fold_in(root, s), p)
            for s in SEEDS for p in POSITIONS]


def _torch_keys():
    seeds = torch.tensor([s for s in SEEDS for _ in POSITIONS])
    pos = torch.tensor([p for _ in SEEDS for p in POSITIONS])
    return prng.fold_in(prng.fold_in(prng.key(0), seeds), pos)


def test_fold_in_chain_keys_equal_jax():
    got = _torch_keys().numpy()
    want = np.stack([np.asarray(jax.random.key_data(k)) for k in
                     _jax_keys()]).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_key_and_split_equal_jax():
    for seed in (0, 7, 2**32 - 1):
        want = np.asarray(jax.random.key_data(jax.random.key(seed)))
        np.testing.assert_array_equal(prng.key(seed).numpy(), want)
        want = np.asarray(jax.random.key_data(
            jax.random.split(jax.random.key(seed), 3)))
        np.testing.assert_array_equal(prng.split(prng.key(seed), 3).numpy(),
                                      want)


@pytest.mark.parametrize("vocab", [512, 128256])
def test_bits_and_uniform_bit_equal_jax(vocab):
    keys_t = _torch_keys()
    keys_j = _jax_keys()
    bits_t = prng.random_bits(keys_t, (vocab,)).numpy()
    unif_t = prng.uniform(keys_t, (vocab,)).numpy()
    bits_fn = jax.jit(jax.vmap(lambda k: jax.random.bits(k, (vocab,),
                                                         jnp.uint32)))
    unif_fn = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, (vocab,))))
    stacked = jnp.stack(keys_j)
    np.testing.assert_array_equal(bits_t,
                                  np.asarray(bits_fn(stacked)).astype(
                                      np.int64))
    np.testing.assert_array_equal(unif_t.view(np.uint32),
                                  np.asarray(unif_fn(stacked)).view(
                                      np.uint32))


def test_gumbel_within_rounding_of_jax():
    keys_t = _torch_keys()
    got = prng.gumbel(keys_t, (4096,)).numpy()
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.gumbel(k, (4096,))))(jnp.stack(_jax_keys())))
    assert np.abs(got - want).max() <= GUMBEL_TOL


def _draws(n, vocab, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, vocab)) * 3).astype(np.float32)
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pos = rng.integers(0, 8192, n).astype(np.int32)
    temps = np.round(rng.uniform(0.0, 2.0, n), 1).astype(np.float32)
    temps[::5] = 0.0
    return logits, seeds, pos, temps


def _near_tie(logits, seeds, pos, temps):
    """Per row: whether JAX's two best perturbed logits lie within
    NEAR_TIE (greedy rows never tie here)."""
    def perturbed(lg, s, p, t):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), s), p)
        return jax.random.gumbel(k, lg.shape) + lg / jnp.maximum(t, 1e-4)
    z = np.asarray(jax.jit(jax.vmap(perturbed))(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(pos),
        jnp.asarray(temps)))
    top2 = np.sort(z, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0] < NEAR_TIE) & (temps > 0)


@pytest.mark.parametrize("n,vocab", [(512, 512), (32, 128256)])
def test_sample_matches_jax_but_near_ties(n, vocab):
    """The engine's sampler over (seed, position, temperature) draws,
    greedy rows included: tokens equal to JAX decode_engine._sample's
    except at counted near-ties."""
    logits, seeds, pos, temps = _draws(n, vocab, seed=vocab)
    want = np.asarray(engine_jax._sample(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(pos),
        jnp.asarray(temps)))
    got = prng._sample(torch.from_numpy(logits), seeds, pos, temps).numpy()
    differ = got != want
    ties = _near_tie(logits, seeds, pos, temps)
    assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)
    assert differ.sum() <= ties.sum()


def test_sample_greedy_rows_are_argmax():
    logits, seeds, pos, _ = _draws(64, 512, seed=3)
    got = prng._sample(torch.from_numpy(logits), seeds, pos,
                       np.zeros(64, np.float32))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))
