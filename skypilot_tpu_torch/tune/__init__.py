"""Engine autotuner of the port: the JAX package's ``tune`` package for
the port's decode engine.

* :mod:`skypilot_tpu_torch.tune.manifest` — the sha256-pinned JSON
  manifest (``~/.stpu/tuning/manifest.json`` or ``STPU_TUNE_MANIFEST``)
  mapping a tuning key ``(family, batch-band, tp-degree, quant-mode)`` to
  tuned engine constants with their provenance; the same file format as
  the JAX package's, so either package reads the other's.
* :mod:`skypilot_tpu_torch.tune.parity` — the correctness gate: a winner
  is persisted only after the greedy and seeded engine streams at the
  tuned constants equal the default engine's and ``models.decode``'s.
* :mod:`skypilot_tpu_torch.tune.sweep` — the offline sweep
  (``python -m skypilot_tpu_torch.tune.sweep``, the JAX CLI's ``stpu
  tune``): candidates measured through the port's
  ``decode_bench.measure_engine_{ragged,paged,spec,q8}`` on the card,
  losers pruned at a small budget, the winner parity-gated and saved.

``serve/decode_engine.resolve_kv_geometry`` reads the manifest when an
engine starts; its tag rides the geometry dict and the replica's stats.
"""
from skypilot_tpu_torch.tune import manifest  # noqa: F401  (re-export)
