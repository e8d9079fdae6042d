"""Counter-based sampling keys for the serving path, bit-exact with
``jax.random``'s threefry-2x32 (JAX 0.9.0, ``jax_default_prng_impl =
threefry2x32``, ``jax_threefry_partitionable = True``): the counterpart of
what ``decode_engine._sample`` in the JAX package takes from
``jax.random``. A request's token at position p is drawn with the key
``fold_in(fold_in(key(0), seed), p)`` in either package, so a seeded
stream resumes on either kind of replica.

``jax_threefry_partitionable`` decides the counter layout of
``random_bits``: with it on (as here), element i of a draw of shape S is
``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))`` with the two output
words xor-ed, i the element's row-major index in S. With it off JAX
hashes one flat counter array split in halves, a different stream;
``split`` likewise follows the partitionable (fold-like) layout.

Keys are int64 tensors of shape (..., 2) holding uint32 words, on the
device of the draw; every word operation masks with 0xFFFFFFFF, since
torch has no general uint32 arithmetic. Uniforms are built from the bits
as JAX builds them (23 mantissa bits under exponent 0, minus one), so
the bits and the uniforms are equal to JAX's. The gumbel transform
``-log(-log(u))`` goes through torch's ``log``, which rounds differently
from XLA's in the last bits (the draws agree within 5e-7); so a sampled
token differs from JAX's only where two perturbed logits tie to within
that rounding (a near-tie). Within the port, seeded streams are
bit-exact on one device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from skypilot_tpu_torch import to_device

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32 bit pattern of 1.0: uniforms are built in [1, 2) and shifted.
_ONE_BITS = 0x3F800000
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2); all int64 holding uint32, broadcastable."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for 0 <= seed < 2**64: the words (seed >>
    32, seed & 0xFFFFFFFF)."""
    words = np.array([(seed >> 32) & MASK, seed & MASK], np.int64)
    return to_device(words, torch.device(device or "cpu"))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter (0, data) under
    each key. ``keys`` (..., 2); ``data`` an int or an int tensor that
    broadcasts against keys[..., 0] (taken mod 2**32, as JAX's uint32
    cast). Returns keys of the broadcast shape."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=keys.device, dtype=torch.int64)
    else:
        data = torch.full((), data, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data & MASK)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one key (2,) into (num, 2) keys."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): keys (*K, 2) -> (*K, *shape) int64
    holding uint32, each key drawing its own array of ``shape``."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    lead = keys.shape[:-1]
    k1 = keys[..., 0].reshape(*lead, 1)
    k2 = keys[..., 1].reshape(*lead, 1)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape(*lead, *shape)


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: keys (*K, 2) -> (*K, *shape)."""
    bits = random_bits(keys, shape)
    floats = (((bits >> 9) | _ONE_BITS).to(torch.int32)
              .view(torch.float32) - 1.0)
    lo = torch.full((), minval, dtype=torch.float32, device=keys.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low", the default), float32."""
    u = uniform(keys, shape, minval=_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis with replacement
    (the Gumbel-max trick). With one key (2,) the draw covers all of
    ``logits``; with keys (*K, 2) and logits (*K, V), each row draws with
    its own key."""
    if keys.dim() == 1:
        g = gumbel(keys, logits.shape)
    else:
        g = gumbel(keys, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)


def _sample(logits: torch.Tensor, seeds, positions,
            temps) -> torch.Tensor:
    """The engine's per-slot sampler (JAX ``decode_engine._sample``):
    row b draws with the key ``fold_in(fold_in(key(0), seeds[b]),
    positions[b])`` from ``categorical(logits[b] / max(temps[b], 1e-4))``
    where ``temps[b] > 0``, and is the argmax where it is 0.

    ``logits`` (B, ..., V) float32 on the device; ``seeds``, ``positions``
    and ``temps`` are host sequences (or numpy arrays) of shape (B, ...),
    so the greedy-only batch skips the draw without a device read. Both
    divisions are by device tensors: a CUDA division by a host scalar is
    a multiply by its reciprocal, which is not JAX's rounding.
    Returns int64 tokens (B, ...)."""
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temps, np.float32)
    if not (temps > 0).any():
        return greedy
    dev = logits.device
    pos = to_device(np.asarray(positions, np.int64), dev)
    seeds = to_device(np.asarray(seeds, np.int64) & MASK, dev).reshape(
        pos.shape[:1] + (1,) * (pos.dim() - 1))
    keys = fold_in(fold_in(key(0, dev), seeds), pos)
    t = torch.maximum(to_device(temps, dev),
                      torch.full((), 1e-4, dtype=torch.float32, device=dev))
    scaled = logits / t.reshape(t.shape + (1,) * (logits.dim() - t.dim()))
    sampled = categorical(keys, scaled)
    hot = to_device(temps > 0, dev)
    return torch.where(hot.reshape(hot.shape + (1,) * (
        sampled.dim() - hot.dim())), sampled, greedy)
