"""Deterministic synthetic data for the port's recipes: the JAX package's
``recipes/synthetic_data.py`` generators, in numpy ``RandomState`` as
there, so a seed gives the same arrays bit for bit, and the same batches
(and the same ``skip`` replay on resume), in either package: images for
``recipes/mnist.py``, sentiment token sequences for
``recipes/glue_imdb.py``, token streams for the language models.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def mnist_like(seed: int, n: int, image_size: int = 28,
               n_classes: int = 10, template_seed: int = 1234
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Images whose class is a fixed random template plus noise: (n, H, W,
    1) f32 images (NHWC, as the JAX package's) and (n,) int32 labels.

    Templates come from `template_seed` so train/eval splits (different
    `seed`) share the same class structure; linearly separable but noisy
    enough that a small CNN shows a real training curve.
    """
    templates = np.random.RandomState(template_seed).randn(
        n_classes, image_size, image_size)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, size=(n,))
    noise = rng.randn(n, image_size, image_size) * 1.5
    images = templates[labels] + noise
    return images[..., None].astype(np.float32), labels.astype(np.int32)


def imdb_like(seed: int, n: int, seq_len: int = 128,
              vocab_size: int = 1000) -> Tuple[np.ndarray, np.ndarray]:
    """Token sequences with sentiment-bearing tokens.

    Tokens [10, 30) lean positive, [30, 50) negative; the label is which
    group dominates. A pooled classifier must learn token identity ->
    sentiment, the same shape as bag-of-words IMDB.
    """
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, size=(n,)).astype(np.int32)
    tokens = rng.randint(50, vocab_size, size=(n, seq_len))
    n_signal = seq_len // 8
    for i in range(n):
        lo = 10 if labels[i] == 1 else 30
        pos = rng.choice(seq_len, size=n_signal, replace=False)
        tokens[i, pos] = rng.randint(lo, lo + 20, size=n_signal)
    return tokens.astype(np.int32), labels


def lm_tokens(seed: int, n_seqs: int, seq_len: int,
              vocab_size: int) -> np.ndarray:
    """Markov-ish token streams: next token correlates with the previous
    one, so a language model has a learnable (non-uniform) target."""
    rng = np.random.RandomState(seed)
    out = np.empty((n_seqs, seq_len), dtype=np.int32)
    cur = rng.randint(0, vocab_size, size=(n_seqs,))
    for t in range(seq_len):
        out[:, t] = cur
        jump = rng.random(n_seqs) < 0.15
        cur = np.where(jump, rng.randint(0, vocab_size, size=(n_seqs,)),
                       (cur * 31 + 7) % vocab_size)
    return out


def batches(arrays: Tuple[np.ndarray, ...], batch_size: int, seed: int,
            steps: int, skip: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
    """Shuffled minibatches (indices drawn with replacement), ``steps`` of
    them.

    ``skip`` is the data-position half of checkpoint/resume: drawing and
    discarding the first ``skip`` index batches advances the RNG exactly
    as the original run did, so a run resumed at step k sees the same
    batch at step k+1 that an uninterrupted run would.
    """
    n = arrays[0].shape[0]
    rng = np.random.RandomState(seed)
    for _ in range(skip):
        rng.randint(0, n, size=(batch_size,))
    for _ in range(steps):
        idx = rng.randint(0, n, size=(batch_size,))
        yield tuple(a[idx] for a in arrays)
