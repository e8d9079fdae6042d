"""The autotuner's correctness gate: parity AT the tuned constants, the
port's copy of the JAX package's ``tune/parity.py`` for the port's engine
and models.

A tile/chunk/window/spec change is only bit-identical when the tile
boundaries align with what the online-softmax and block-table paths
assume — the sweep must PROVE a winner preserves output, never assume
it. At an explicit candidate geometry this runs:

* greedy: every engine stream equals the request's own
  ``models.decode`` fixed-path reference token for token (for int8 KV
  the reference is the default-constants quantized engine: q8 is not
  bit-identical to the bf16 models path by design, so the gate holds the
  GEOMETRY fixed point instead);
* seeded: a temperature > 0 request at the tuned constants reproduces
  the default-constants engine's stream bit for bit — the sampling keys
  depend on (seed, position) only, so any divergence means the tuned
  geometry changed the math, not the sampler.

Equality is exact, on the card too: a tile width that reorders a
reduction there can flip a near-tied argmax, and the gate then rejects
that candidate; that is the gate working, not noise to tolerate.
``tune/sweep.py`` calls :func:`check_parity` on every winner before the
manifest entry is persisted, on the device it measured on.
"""
from __future__ import annotations

import random
from typing import Any, Dict, Optional

import torch

from skypilot_tpu_torch import DeviceLike, resolve_device


class ParityError(AssertionError):
    """A tuned geometry changed engine output."""


def _tiny_model(family: str, device: torch.device):
    if family == "mixtral":
        from skypilot_tpu_torch.models import mixtral as mdl
        cfg = mdl.MixtralConfig.tiny()
    elif family == "gemma":
        from skypilot_tpu_torch.models import gemma as mdl
        cfg = mdl.GemmaConfig.tiny(vocab_size=128)
    else:
        from skypilot_tpu_torch.models import llama as mdl
        cfg = mdl.LlamaConfig.tiny(vocab_size=128)
    gen = torch.Generator(device=device).manual_seed(0)
    return mdl, cfg, mdl.init(cfg, gen, device)


def _engine(cfg, params, device, *, paged: bool, kv_quant: bool,
            max_seq: int, engine_kw: Optional[Dict[str, Any]] = None):
    from skypilot_tpu_torch.serve.decode_engine import DecodeEngine
    return DecodeEngine(cfg, params, slots=2, max_seq=max_seq,
                        paged=paged, kv_quant=kv_quant,
                        use_manifest=False, device=device,
                        **(engine_kw or {})).start()


def _drain(engine, specs):
    reqs = [engine.submit(p, max_tokens=mt, temperature=t, seed=s)
            for p, mt, t, s in specs]
    return [r.result(timeout=600.0) for r in reqs]


def _run(cfg, params, device, specs, **kw):
    engine = _engine(cfg, params, device, **kw)
    try:
        return _drain(engine, specs)
    finally:
        engine.shutdown()
        engine.release()


def check_parity(family: str, *, block: int = 0, chunk: int = 0,
                 window_blocks: int = 0, spec_k: int = 0,
                 paged: bool = False, kv_quant: bool = False,
                 max_seq: int = 64, n_requests: int = 4,
                 max_tokens: int = 6, device: DeviceLike = None) -> None:
    """Raise :class:`ParityError` unless the engine at the candidate
    constants reproduces reference output, greedy AND seeded, on
    ``device`` (the card by default; ``"cpu"`` on request).

    Zero-valued knobs mean "default" (the candidate does not tune
    them). Runs on tiny models — the gate checks NUMERICS of the
    geometry, which is model-size independent, so it stays cheap
    enough to run per winner inside the sweep.
    """
    device = resolve_device(device)
    mdl, cfg, params = _tiny_model(family, device)
    tuned_kw: Dict[str, Any] = {}
    if block:
        tuned_kw["block"] = int(block)
    if chunk:
        tuned_kw["prefill_chunk"] = int(chunk)
        if paged:
            tuned_kw["kv_block_tokens"] = int(chunk)
    if window_blocks:
        tuned_kw["window_blocks"] = int(window_blocks)
    if spec_k:
        tuned_kw["spec_k"] = int(spec_k)

    rng = random.Random(1234)
    vocab = cfg.vocab_size
    # Ragged lengths spanning chunk boundaries, greedy + seeded rows.
    specs = []
    for i in range(n_requests):
        prompt = [rng.randint(1, vocab - 1)
                  for _ in range(rng.randint(3, max_seq // 2))]
        seeded = i % 2 == 1
        specs.append((prompt, max_tokens,
                      0.8 if seeded else 0.0, 40 + i))

    geo = dict(paged=paged, kv_quant=kv_quant, max_seq=max_seq)
    got = _run(cfg, params, device, specs, engine_kw=tuned_kw, **geo)
    want = _run(cfg, params, device, specs, **geo)

    label = (f"{family} block={block or 'dflt'} chunk={chunk or 'dflt'}"
             f" window_blocks={window_blocks or 'dflt'}"
             f" spec_k={spec_k or 'dflt'} paged={paged}"
             f" kv_quant={kv_quant}")
    for i, ((prompt, mt, temp, _seed), g, w) in enumerate(
            zip(specs, got, want)):
        if g != w:
            raise ParityError(
                f"tuned vs default-engine stream diverged ({label}), "
                f"request {i} temp={temp}: {g} != {w}")
        if temp == 0.0 and not kv_quant:
            with torch.inference_mode():
                ref = mdl.decode(cfg, params,
                                 torch.tensor([prompt], device=device),
                                 len(prompt), mt, max_seq)
            ref = [int(t) for t in ref[0].tolist()]
            if g != ref:
                raise ParityError(
                    f"tuned engine vs models.decode diverged "
                    f"({label}), request {i}: {g} != {ref}")
