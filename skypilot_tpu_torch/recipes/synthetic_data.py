"""Deterministic synthetic data for the port's recipes: the JAX package's
``recipes/synthetic_data.py`` generators, in numpy ``RandomState`` as
there, so a seed gives the same token stream and the same batches (and the
same ``skip`` replay on resume) in either package.

Only the language-model stream is here; ``mnist_like`` and ``imdb_like``
come with their recipes.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


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
