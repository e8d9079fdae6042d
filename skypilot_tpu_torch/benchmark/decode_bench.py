"""Serving-decode measurement core of the port: the counterpart of the JAX
package's ``benchmark/decode_bench.py`` for the port's models and
DecodeEngine, with its single-process modes.

  * ``measure_decode``: fixed-batch prefill + KV-cached decode
    (``<model>.decode``; dense top-2 routing for Mixtral), end to end in
    tokens/s, and the prefill and the steady-state decode step timed
    apart;
  * ``measure_engine_ragged``: the continuous-batching engine under a
    ragged mix of prompt lengths and token budgets;
  * ``measure_engine_paged``: the engine on the paged pool sized to half
    the dense budget, under the same mix (tok/s, pool high-water
    utilization, peak live slots);
  * ``measure_engine_q8``: the paged engine with int8 KV and weights, and
    the bf16-to-int8 block-capacity ratio at one byte budget (>= 1.8x);
  * ``measure_engine_spec``: n-gram speculative decoding on the
    shared-prefix chat mix against the same mix without it, the two
    runs' streams asserted identical;
  * ``measure_engine_prefix``: shared-prefix traffic through the prefix
    cache (warm/cold TTFT, hit rate, prefill tokens saved);
  * ``measure_engine_tier``: the host-RAM spill tier under a prefix
    working set twice the pool (cold vs re-hit TTFT);
  * ``measure_ckpt``: checkpoint save/restore latency of a family's whole
    parameter tree (``train/checkpoint.py``);
  * ``measure_engine_slo``: a serve_llm replica behind the port's load
    balancer, driven over HTTP by the open-loop load generator
    (``benchmark/loadgen.py``, Poisson arrivals, the chat mix) and graded
    against TTFT/TPOT SLOs (``slo_goodput``, ``p99_ttft_s``,
    ``loadgen_tok_s``);
  * ``measure_engine_chaos``: the same data plane with two replicas, the
    schedule run kill-free and then with replica A torn down mid-run: the
    balancer's stream journal resumes A's streams on B
    (``chaos_goodput_ratio``, ``resumed_streams``).

Each returns the JAX function's dict and takes ``device`` (the card by
default; ``"cpu"`` on request, with ``tiny=True`` for plumbing runs). The
JAX package compiles and donates; the port runs eagerly, so JAX's "compile
+ warm" run is a warm-up run here, and ``torch.cuda.synchronize`` brackets
every timed span. Every engine here is built with ``use_manifest=False``,
as in the JAX bench: a leg measures its explicit constants (the tuning
sweep's candidates among them), and an ambient tuning manifest never
leaks into a measurement; the SLO and chaos legs serve through
serve_llm's engines, which read the manifest as a replica does (as in the
JAX bench). Not ported yet: the gang and tensor-parallel mode
(``measure_engine_tp``).

    python -m skypilot_tpu_torch.benchmark.decode_bench --family mixtral \\
        --mode paged           # one JSON line, as tools/bench_moe_decode.py
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pickle
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Any, Dict, Optional

import torch

from skypilot_tpu_torch import DeviceLike, resolve_device


def build(family: str, dim: int = 1024, layers: int = 8,
          experts: int = 8, tiny: bool = False):
    """(module, config) of the JAX bench's single-chip model of the family,
    field for field; ``tiny=True`` the families' test configs (plumbing
    runs: their numbers compare with nothing)."""
    if family == "llama":
        from skypilot_tpu_torch.models import llama as mdl
        if tiny:
            return mdl, mdl.LlamaConfig.tiny(vocab_size=128)
        return mdl, mdl.LlamaConfig(
            vocab_size=32768, dim=2048, n_heads=16, n_kv_heads=8,
            mlp_dim=8192, n_layers=16, max_seq_len=2048)
    if family == "mixtral":
        from skypilot_tpu_torch.models import mixtral as mdl
        if tiny:
            return mdl, mdl.MixtralConfig.tiny()
        return mdl, dataclasses.replace(
            mdl.MixtralConfig.mixtral_8x7b(), vocab_size=32768, dim=dim,
            n_layers=layers, n_heads=16, n_kv_heads=8, mlp_dim=3584,
            n_experts=experts, max_seq_len=2048)
    if family == "gemma":
        from skypilot_tpu_torch.models import gemma as mdl
        if tiny:
            return mdl, mdl.GemmaConfig.tiny(vocab_size=128)
        return mdl, mdl.GemmaConfig.single_chip_bench()
    raise ValueError(f"unknown family {family!r}")


def _model_info(family: str, cfg, params) -> Dict[str, Any]:
    return {"family": family, "dim": cfg.dim,
            "layers": cfg.n_layers,
            "experts": getattr(cfg, "n_experts", 0),
            "mlp_dim": cfg.mlp_dim,
            "params": sum(p.numel() for p in params.parameters())}


def _setup(family: str, device: DeviceLike, shape_kw, config=None):
    """(module, config, device, params): the family's bench model (or
    ``config``) with weights drawn from seed 0 on ``device``."""
    device = resolve_device(device)
    mdl, cfg = build(family, **shape_kw)
    cfg = config or cfg
    gen = torch.Generator(device=device).manual_seed(0)
    return mdl, cfg, device, mdl.init(cfg, gen, device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device: torch.device, fn):
    """(fn(), its wall seconds), the device synchronised on both sides."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _ragged_specs(cfg, n_requests: int, max_prompt: int, max_tokens: int):
    """The seeded mixed-length mix the ragged, paged and q8 legs share:
    prompts of 8..max_prompt tokens, budgets of 8..max_tokens."""
    rng = random.Random(0)
    return [([rng.randint(1, cfg.vocab_size - 1)
              for _ in range(rng.randint(8, max_prompt))],
             rng.randint(8, max_tokens))
            for _ in range(n_requests)]


def _engine(cfg, params, device, **kw):
    """A started, warmed engine at exactly ``kw``'s constants: the
    tuning manifest is never read (``use_manifest=False``)."""
    from skypilot_tpu_torch.serve.decode_engine import DecodeEngine
    engine = DecodeEngine(cfg, params, device=device, use_manifest=False,
                          **kw)
    engine.start()
    engine.warmup()
    return engine


def _close(engine) -> None:
    engine.shutdown()
    engine.release()


@contextlib.contextmanager
def _step_telemetry():
    """Step telemetry armed (and reset) for the block, disarmed after
    unless it was armed before."""
    from skypilot_tpu_torch.observability import stepstats
    was_armed = stepstats.ENABLED
    stepstats.arm(ring=8192, sync_every=16)
    stepstats.reset()
    try:
        yield stepstats
    finally:
        if not was_armed:
            stepstats.disarm()


def _submit_all(engine, specs, **kw):
    """Every (prompt, max_tokens) submitted at once; (generated tokens,
    wall seconds, the requests)."""
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_tokens=mt, **kw) for p, mt in specs]
    total = sum(len(r.result(timeout=1800.0)) for r in reqs)
    return total, time.perf_counter() - t0, reqs


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def measure_decode(family: str, batch: int = 8, prompt_len: int = 128,
                   tokens: int = 128, repeats: int = 3,
                   device: DeviceLike = None, **shape_kw) -> Dict[str, Any]:
    """Best-of-``repeats`` fixed-batch decode (``<model>.decode``, the
    cache allocated outside and filled in place) after one warm-up run;
    then the prefill alone and the steady-state T = 1 step against the
    warm cache, each timed apart: TTFT and tokens/s are different SLOs,
    and one end-to-end figure hides which of them moved."""
    mdl, cfg, device, params = _setup(family, device, shape_kw)
    b, s = batch, prompt_len
    gen = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=device)
    max_seq = s + tokens

    @torch.inference_mode()
    def run():
        cache = mdl.init_cache(cfg, b, max_seq, device)
        out = mdl.decode(cfg, params, prompt, s, tokens, max_seq,
                         cache=cache)
        return int(out[0, -1])

    @torch.inference_mode()
    def run_prefill():
        cache = mdl.init_cache(cfg, b, max_seq, device)
        logits, cache = mdl.forward_with_cache(
            cfg, params, prompt, cache, 0, valid_len=s, logits_at=s - 1)
        return cache

    run()                                       # warm-up
    best = min(_timed(device, run)[1] for _ in range(repeats))
    cache = run_prefill()
    best_prefill = float("inf")
    for _ in range(repeats):
        cache, dt = _timed(device, run_prefill)
        best_prefill = min(best_prefill, dt)

    # Steady-state per-token decode: single steps against the warm cache,
    # the frontier advancing each step as in a live serving loop.
    tok = torch.zeros((b, 1), dtype=torch.long, device=device)
    with torch.inference_mode():
        mdl.forward_with_cache(cfg, params, tok, cache, s)      # warm
        n_steps = min(max(tokens // 4, 8), tokens - 1)

        def steps():
            for i in range(n_steps):
                mdl.forward_with_cache(cfg, params, tok, cache, s + 1 + i)

        _, dt = _timed(device, steps)
    steady = dt / n_steps
    toks = b * tokens
    return {
        "model": _model_info(family, cfg, params),
        "batch": b,
        "prompt_len": s,
        "decode_tokens": tokens,
        "decode_seconds": round(best, 3),
        "tokens_per_sec": round(toks / best, 1),
        "ms_per_token_per_seq": round(best / tokens * 1e3, 2),
        "prefill_ms": round(best_prefill * 1e3, 2),
        "decode_ms_per_token_steady": round(steady * 1e3, 3),
        "steady_tokens_per_sec": round(b / steady, 1),
    }


def measure_engine_ragged(family: str, slots: int = 8,
                          n_requests: int = 32, max_prompt: int = 192,
                          max_tokens: int = 64,
                          engine_kw: Optional[Dict[str, Any]] = None,
                          device: DeviceLike = None, config=None,
                          **shape_kw) -> Dict[str, Any]:
    """The engine under ragged arrivals: the seeded mixed-length mix
    submitted at once, generated tokens over the whole wall (prefill
    included). With tracing armed every request carries a trace context,
    so the run measures the armed overhead. Step telemetry is armed and
    its phase breakdown reported. ``config`` replaces ``build``'s model
    (``measure_engine_tp``'s one-card counterpart)."""
    from skypilot_tpu_torch.observability import tracing
    mdl, cfg, device, params = _setup(family, device, shape_kw, config)
    kw = dict(prefill_chunk=64)
    kw.update(engine_kw or {})
    engine = _engine(cfg, params, device, slots=slots,
                     max_seq=max_prompt + max_tokens, **kw)
    specs = _ragged_specs(cfg, n_requests, max_prompt, max_tokens)
    span = tracing.start_span("bench.engine_ragged", kind="bench",
                              attrs={"requests": n_requests})
    trace_ctx = span.context()          # None unless tracing is armed
    try:
        with _step_telemetry() as stepstats:
            total, dt, _ = _submit_all(engine, specs, trace=trace_ctx)
            snap = stepstats.snapshot()
    finally:
        span.end()
        _close(engine)
    return {
        "model": _model_info(family, cfg, params),
        "slots": slots,
        "requests": n_requests,
        "max_prompt": max_prompt,
        "max_tokens": max_tokens,
        "traced": trace_ctx is not None,
        "generated_tokens": total,
        "wall_seconds": round(dt, 3),
        "engine_ragged_tok_s": round(total / dt, 1),
        "phase_breakdown": snap.get("phases", {}),
        "busy_fraction": snap.get("busy_fraction"),
        "dispatch_ms_mean": snap.get("dispatch_ms_mean"),
        "device_ms_mean": (snap.get("sync") or {}).get("device_ms_mean"),
    }


def _tp_engine(job: Dict[str, Any], rank: int):
    """(config, tp group, engine) of rank ``rank`` of measure_engine_tp's
    job: the job's model from seed 0 on the rank's device, sharded over
    its group (joined here), and the engine at the job's constants."""
    from skypilot_tpu_torch.serve import gang_replica
    from skypilot_tpu_torch.serve.decode_engine import DecodeEngine
    cfg, tp = job["cfg"], job["tp"]
    device = resolve_device(job["device"] if job["device"] is not None
                            else f"cuda:{rank}")
    mdl = __import__(f"skypilot_tpu_torch.models.{job['family']}",
                     fromlist=["init"])
    params = mdl.init(cfg, torch.Generator(device=device).manual_seed(0),
                      device)
    group = gang_replica.TpGroup(tp=tp, rank=rank, addr=job["addr"],
                                 device=device, backend=job["backend"])
    topology = gang_replica.ReplicaTopology(ici_axes={"tp": tp})
    mesh, rules = gang_replica.build_mesh(topology, group)
    params = gang_replica.shard_params(cfg, params, mesh, rules)
    engine = DecodeEngine(cfg, params, mesh=mesh, rules=rules,
                          device=device, use_manifest=False, **job["engine"])
    return cfg, topology, group, engine


def _tp_rank_main(job_path: str, rank: int) -> None:
    """One of measure_engine_tp's spawned ranks: serve rank 0's plans
    until its engine closes."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    _, _, group, engine = _tp_engine(job, rank)
    engine.work()
    group.close()


def measure_engine_tp(family: str, tp: int = 2, slots: int = 8,
                      n_requests: int = 24, max_prompt: int = 192,
                      max_tokens: int = 64, device: DeviceLike = None,
                      backend: Optional[str] = None, config=None,
                      **shape_kw) -> Dict[str, Any]:
    """Tensor-parallel engine throughput under the ragged mix: the
    sharded-replica serving path (``serve/gang_replica.py``) over a
    ``tp``-rank group, under the JAX bench's keys. This process is rank
    0 and spawns the other ranks itself (rank r on ``cuda:r``, or every
    rank on ``device`` when given; ``backend`` as ``TpGroup``'s: gloo
    for ranks sharing one card), where JAX forces a CPU mesh. ``config``
    replaces ``build``'s model (e.g. a wider one); weights from seed 0.
    The figure tracks the sharded path's cost, not a card's speed alone:
    on one card its ranks share it."""
    from skypilot_tpu_torch.serve import gang_replica
    if torch.distributed.is_initialized():
        raise RuntimeError("measure_engine_tp makes this process a tp "
                           "group's rank 0: it already has a group")
    mdl, cfg = build(family, **shape_kw)
    job = {"family": family, "cfg": config or cfg, "tp": int(tp),
           "device": device, "backend": backend,
           "addr": gang_replica.free_addr(),
           "engine": dict(slots=slots, max_seq=max_prompt + max_tokens,
                          prefill_chunk=64)}
    with tempfile.TemporaryDirectory() as tmp:
        job_path = f"{tmp}/job.pkl"
        with open(job_path, "wb") as f:
            pickle.dump(job, f)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "skypilot_tpu_torch.benchmark."
             "decode_bench", "--tp-worker", job_path, str(r)])
            for r in range(1, int(tp))]
        group = None
        try:
            cfg, topology, group, engine = _tp_engine(job, 0)
            engine.start()
            engine.warmup()
            specs = _ragged_specs(cfg, n_requests, max_prompt, max_tokens)
            try:
                total, dt, _ = _submit_all(engine, specs)
            finally:
                _close(engine)
            for proc in procs:
                if proc.wait(timeout=120) != 0:
                    raise RuntimeError(f"tp rank exited {proc.returncode}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if group is not None and group.connected:
                group.close()
    return {
        "model": {"family": family, "dim": cfg.dim,
                  "layers": cfg.n_layers,
                  "experts": getattr(cfg, "n_experts", 0),
                  "mlp_dim": cfg.mlp_dim},
        "slots": slots,
        "requests": n_requests,
        "tp": int(tp),
        "topology": topology.label(),
        "generated_tokens": total,
        "wall_seconds": round(dt, 3),
        "engine_tp_tok_s": round(total / dt, 1),
    }


def _paged_geometry(max_prompt: int, max_tokens: int, slots: int,
                    pool_tokens: int, block_tokens: int):
    """(chunk, max_seq, token budget): max_seq rounded up to whole
    chunks, the budget half the dense one unless given."""
    chunk = block_tokens or 64
    max_seq = max_prompt + max_tokens
    max_seq += (-max_seq) % chunk       # keep chunk | max_seq
    return chunk, max_seq, pool_tokens or (slots * max_seq) // 2


def measure_engine_paged(family: str, slots: int = 16,
                         n_requests: int = 48, max_prompt: int = 192,
                         max_tokens: int = 64, pool_tokens: int = 0,
                         block_tokens: int = 0,
                         engine_kw: Optional[Dict[str, Any]] = None,
                         device: DeviceLike = None,
                         **shape_kw) -> Dict[str, Any]:
    """The paged engine under the ragged leg's mix, its pool sized to half
    the dense budget for ``slots`` rows: generated tok/s, the pool's
    high-water utilization, peak live slots and the phase breakdown."""
    mdl, cfg, device, params = _setup(family, device, shape_kw)
    chunk, max_seq, budget = _paged_geometry(max_prompt, max_tokens, slots,
                                             pool_tokens, block_tokens)
    kw = dict(prefill_chunk=chunk, paged=True,
              kv_pool_blocks=budget // chunk + 1)
    kw.update(engine_kw or {})
    engine = _engine(cfg, params, device, slots=slots, max_seq=max_seq,
                     **kw)
    specs = _ragged_specs(cfg, n_requests, max_prompt, max_tokens)
    try:
        with _step_telemetry() as stepstats:
            total, dt, _ = _submit_all(engine, specs)
            snap = stepstats.snapshot()
        pool = engine._pool
        utilization = pool.peak_in_use / max(pool.usable_blocks, 1)
        zero_copy = engine.prefix_cache.stats()["zero_copy_hits"]
    finally:
        _close(engine)
    return {
        "model": _model_info(family, cfg, params),
        "slots": slots,
        "requests": n_requests,
        "max_prompt": max_prompt,
        "max_tokens": max_tokens,
        "pool_blocks": pool.num_blocks,
        "block_tokens": pool.block_tokens,
        "generated_tokens": total,
        "wall_seconds": round(dt, 3),
        "engine_paged_tok_s": round(total / dt, 1),
        "kv_pool_utilization": round(utilization, 3),
        "peak_live_slots": engine.peak_live_slots,
        "zero_copy_hits": zero_copy,
        "phase_breakdown": snap.get("phases", {}),
        "busy_fraction": snap.get("busy_fraction"),
    }


def measure_engine_q8(family: str, slots: int = 16,
                      n_requests: int = 48, max_prompt: int = 192,
                      max_tokens: int = 64, pool_tokens: int = 0,
                      block_tokens: int = 0,
                      engine_kw: Optional[Dict[str, Any]] = None,
                      device: DeviceLike = None,
                      **shape_kw) -> Dict[str, Any]:
    """int8 serving: the capacity ratio it exists for, then its throughput.

    Capacity: bytes per block of a bf16 pool and of an int8 + scale pool,
    read from real two-block pools on the device and checked against
    ``kv_pool.block_bytes``; the ratio must reach 1.8x (the scale tax
    keeps it under 2). Throughput: the ragged mix through a kv_quant +
    weight_quant paged engine whose pool holds the int8 block count of
    the bf16 pool's byte budget. Output is not held to bf16's here
    (quantization changes numerics by design)."""
    from skypilot_tpu_torch.serve import kv_pool
    mdl, cfg, device, params = _setup(family, device, shape_kw)
    chunk, max_seq, budget = _paged_geometry(max_prompt, max_tokens, slots,
                                             pool_tokens, block_tokens)
    bf16_blocks = budget // chunk + 1

    def per_block(quantized):
        pool = mdl.init_paged_cache(cfg, 2, chunk, quantized=quantized,
                                    device=device)
        return sum(v.numel() * v.element_size() for v in pool.values()) // 2

    bb_bf16, bb_q8 = per_block(False), per_block(True)
    kv_bytes = torch.empty((), dtype=cfg.dtype).element_size()
    assert bb_bf16 == kv_pool.block_bytes(
        chunk, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
        kv_dtype_bytes=kv_bytes), "bf16 block-byte math drifted"
    assert bb_q8 == kv_pool.block_bytes(
        chunk, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
        quantized=True), "int8 block-byte math drifted"
    byte_budget = bf16_blocks * bb_bf16
    q8_blocks = byte_budget // bb_q8
    ratio = bb_bf16 / bb_q8
    if ratio < 1.8:
        raise RuntimeError(
            f"quantized pool fits only {ratio:.2f}x the bf16 blocks "
            f"({bb_q8} vs {bb_bf16} bytes/block) at the same byte "
            f"budget: below the 1.8x capacity gate")
    kw = dict(prefill_chunk=chunk, paged=True, kv_pool_blocks=q8_blocks,
              kv_quant=True, weight_quant=True)
    kw.update(engine_kw or {})
    engine = _engine(cfg, params, device, slots=slots, max_seq=max_seq,
                     **kw)
    specs = _ragged_specs(cfg, n_requests, max_prompt, max_tokens)
    try:
        with _step_telemetry() as stepstats:
            total, dt, _ = _submit_all(engine, specs)
            snap = stepstats.snapshot()
        pool = engine._pool
        utilization = pool.peak_in_use / max(pool.usable_blocks, 1)
    finally:
        _close(engine)
    return {
        "model": _model_info(family, cfg, params),
        "slots": slots,
        "requests": n_requests,
        "max_prompt": max_prompt,
        "max_tokens": max_tokens,
        "block_tokens": chunk,
        "byte_budget": byte_budget,
        "block_bytes_bf16": bb_bf16,
        "block_bytes_q8": bb_q8,
        "kv_pool_capacity_blocks_bf16": bf16_blocks,
        "kv_pool_capacity_blocks": q8_blocks,
        "kv_capacity_ratio": round(ratio, 3),
        "generated_tokens": total,
        "wall_seconds": round(dt, 3),
        "engine_q8_tok_s": round(total / dt, 1),
        "kv_pool_utilization": round(utilization, 3),
        "peak_live_slots": engine.peak_live_slots,
        "phase_breakdown": snap.get("phases", {}),
        "busy_fraction": snap.get("busy_fraction"),
    }


def measure_engine_spec(family: str, slots: int = 8,
                        n_requests: int = 32, shared_prefix: int = 128,
                        max_unique: int = 32, max_tokens: int = 64,
                        spec_k: int = 4, spec_ngram: int = 3,
                        device: DeviceLike = None,
                        **shape_kw) -> Dict[str, Any]:
    """Speculative decoding on the chat mix (one shared system prompt,
    seeded templated tails, greedy), run twice through the paged engine:
    drafting off, then ``spec_k`` drafts per slot per step. The streams
    must be identical, so the leg cannot win by changing tokens. Reports
    both tok/s, their ratio and the acceptance rate (tokens per verify
    pass ~= 1 + accept_rate * k)."""
    mdl, cfg, device, params = _setup(family, device, shape_kw)
    chunk = 64
    max_seq = shared_prefix + max_unique + max_tokens
    max_seq += (-max_seq) % chunk       # keep chunk | max_seq
    rng = random.Random(0)
    shared = [rng.randint(1, cfg.vocab_size - 1)
              for _ in range(shared_prefix)]

    def tail():
        # A short per-request motif repeated with noise: the few-shot /
        # structured-format shape prompt-lookup drafting exists for.
        motif = [rng.randint(1, cfg.vocab_size - 1) for _ in range(4)]
        out: list = []
        while len(out) < max_unique:
            out += motif + [rng.randint(1, cfg.vocab_size - 1)]
        return out[:rng.randint(8, max_unique)]

    specs = [(shared + tail(), rng.randint(16, max_tokens))
             for _ in range(n_requests)]

    def run(k):
        engine = _engine(cfg, params, device, slots=slots, max_seq=max_seq,
                         prefill_chunk=chunk, paged=True, spec_k=k,
                         spec_ngram=spec_ngram)
        try:
            if k:
                # The verify path's first call outside the timed window
                # (a prompt whose repetition makes the matcher draft on
                # the first decode step), as warmup() does for the rest.
                engine.submit([7, 8, 9] * 6, max_tokens=6).result(
                    timeout=1800.0)
            t0 = time.perf_counter()
            reqs = [engine.submit(p, max_tokens=mt) for p, mt in specs]
            streams = [r.result(timeout=1800.0) for r in reqs]
            dt = time.perf_counter() - t0
        finally:
            _close(engine)
        return (streams, sum(map(len, streams)), dt,
                sum(r.spec_drafted for r in reqs),
                sum(r.spec_accepted for r in reqs))

    with _step_telemetry() as stepstats:
        base_streams, base_total, base_dt, _, _ = run(0)
        stepstats.reset()
        streams, total, dt, drafted, accepted = run(spec_k)
        snap = stepstats.snapshot()
    if streams != base_streams:
        raise AssertionError(
            "speculative streams diverged from the non-speculative "
            "baseline: the bit-identity contract is broken")
    return {
        "model": _model_info(family, cfg, params),
        "slots": slots,
        "requests": n_requests,
        "shared_prefix": shared_prefix,
        "spec_k": spec_k,
        "spec_ngram": spec_ngram,
        "generated_tokens": total,
        "wall_seconds": round(dt, 3),
        "engine_spec_tok_s": round(total / dt, 1),
        "engine_spec_baseline_tok_s": round(base_total / base_dt, 1),
        "spec_speedup": round(base_dt / dt, 3),
        "drafted_tokens": drafted,
        "accepted_tokens": accepted,
        "spec_accept_rate": round(accepted / max(drafted, 1), 3),
        "phase_breakdown": snap.get("phases", {}),
        "busy_fraction": snap.get("busy_fraction"),
    }


def measure_engine_prefix(family: str, slots: int = 8,
                          n_requests: int = 24, shared_prefix: int = 256,
                          max_unique: int = 32, max_tokens: int = 48,
                          device: DeviceLike = None,
                          **shape_kw) -> Dict[str, Any]:
    """Shared-prefix traffic through the paged pool's prefix cache: one
    cold request prefills the system prompt and publishes its blocks,
    then ``n_requests`` concurrent ones alias them. TTFT split cold/warm
    in wall seconds and in steps to the first token (the prefill-chunk
    count: deterministic); hit rate and tokens saved from the engine's
    own pool stats."""
    mdl, cfg, device, params = _setup(family, device, shape_kw)
    chunk = 64
    max_seq = shared_prefix + max_unique + max_tokens
    max_seq += (-max_seq) % chunk       # keep chunk | max_seq
    engine = _engine(cfg, params, device, slots=slots, max_seq=max_seq,
                     prefill_chunk=chunk, paged=True)
    rng = random.Random(0)
    shared = [rng.randint(1, cfg.vocab_size - 1)
              for _ in range(shared_prefix)]

    def tail():
        return [rng.randint(1, cfg.vocab_size - 1)
                for _ in range(rng.randint(1, max_unique))]

    try:
        cold = engine.submit(shared + tail(),
                             max_tokens=rng.randint(16, max_tokens))
        cold.result(timeout=1800.0)
        ttft_cold = cold.first_token_at - cold.submitted_at
        # The hit rate over the warm phase only (the cold request and the
        # warm-up are misses by construction).
        stats0 = engine.prefix_cache.stats()
        total, dt, reqs = _submit_all(
            engine, [(shared + tail(), rng.randint(16, max_tokens))
                     for _ in range(n_requests)])
    finally:
        stats = engine.prefix_cache.stats()
        _close(engine)
    hits = stats["hits"] - stats0["hits"]
    misses = stats["misses"] - stats0["misses"]
    return {
        "model": _model_info(family, cfg, params),
        "slots": slots,
        "requests": n_requests,
        "shared_prefix": shared_prefix,
        "generated_tokens": total,
        "wall_seconds": round(dt, 3),
        "engine_prefix_tok_s": round(total / dt, 1),
        "prefix_hit_rate": round(hits / max(hits + misses, 1), 3),
        "prefill_tokens_saved": stats["tokens_saved"],
        "ttft_cold_s": round(ttft_cold, 4),
        # Median: warm requests queue behind each other on the slots, so
        # the tail reflects queueing, not the cache.
        "ttft_warm_s": round(_median(r.first_token_at - r.submitted_at
                                     for r in reqs), 4),
        "steps_to_first_token_cold": cold.prefill_chunks,
        "steps_to_first_token_warm": max(r.prefill_chunks for r in reqs),
    }


def measure_engine_tier(family: str, slots: int = 8,
                        n_requests: int = 12, prompt_blocks: int = 2,
                        max_tokens: int = 8, host_cache_mb: float = 64.0,
                        engine_kw: Optional[Dict[str, Any]] = None,
                        device: DeviceLike = None,
                        **shape_kw) -> Dict[str, Any]:
    """The host-RAM KV tier: ``n_requests`` distinct prompts of
    ``prompt_blocks`` blocks into a pool holding about half that working
    set, run one at a time (cold: evictions spill D2H); every published
    block then drained to the host tier, and every prompt again (warm: a
    hit costs one H2D restore per chunk instead of a prefill). Cold vs
    re-hit median TTFT in wall seconds and steps to the first token, the
    tier hit rate and the host pool's own counters."""
    mdl, cfg, device, params = _setup(family, device, shape_kw)
    chunk = 64
    # Tail tokens past the last full block, so all prompt_blocks blocks
    # can be re-admitted (an exact multiple keeps its last for prefill).
    prompt_len = prompt_blocks * chunk + 7
    max_seq = prompt_len + max_tokens
    max_seq += (-max_seq) % chunk       # keep chunk | max_seq
    # Half the published working set, plus room for the live slots' rows.
    pool_blocks = (n_requests * prompt_blocks // 2 +
                   2 * (max_seq // chunk) + 1)
    kw = dict(prefill_chunk=chunk, paged=True, kv_pool_blocks=pool_blocks,
              prefix_cache_mb=host_cache_mb)
    kw.update(engine_kw or {})
    engine = _engine(cfg, params, device, slots=slots, max_seq=max_seq,
                     **kw)
    rng = random.Random(0)
    prompts = [[rng.randint(1, cfg.vocab_size - 1)
                for _ in range(prompt_len)] for _ in range(n_requests)]

    def one_by_one():
        out, n = [], 0
        for p in prompts:
            r = engine.submit(p, max_tokens=max_tokens)
            n += len(r.result(timeout=1800.0))
            out.append(r)
        return out, n

    def quiesce(deadline_s: float = 30.0) -> None:
        t_end = time.perf_counter() + deadline_s
        while (engine.spill_in_flight() > 0
               and time.perf_counter() < t_end):
            time.sleep(0.005)

    try:
        t0 = time.perf_counter()
        cold_reqs, total = one_by_one()
        # Drain the published blocks to the host tier, paced so the
        # bounded spill queue never overflows into drop-on-evict.
        while True:
            while engine.spill_in_flight() >= 16:
                time.sleep(0.001)
            if not engine.prefix_cache.evict_one():
                break
        quiesce()
        warm_reqs, n = one_by_one()
        total += n
        dt = time.perf_counter() - t0
    finally:
        tier = engine.host_tier_stats()
        _close(engine)
    hits = sum(1 for r in warm_reqs if r.cached_prompt_tokens > 0)
    return {
        "model": _model_info(family, cfg, params),
        "slots": slots,
        "requests": n_requests,
        "prompt_blocks": prompt_blocks,
        "pool_blocks": pool_blocks,
        "host_cache_mb": host_cache_mb,
        "generated_tokens": total,
        "wall_seconds": round(dt, 3),
        "engine_tier_tok_s": round(total / dt, 1),
        "tier_cold_ttft_s": round(_median(
            r.first_token_at - r.submitted_at for r in cold_reqs), 4),
        "tier_rehit_ttft_s": round(_median(
            r.first_token_at - r.submitted_at for r in warm_reqs), 4),
        "tier_hit_rate": round(hits / max(n_requests, 1), 3),
        "steps_to_first_token_cold": max(r.prefill_chunks
                                         for r in cold_reqs),
        "steps_to_first_token_rehit": max(r.prefill_chunks
                                          for r in warm_reqs),
        "host_tier": tier,
    }


def _param_tree(params) -> Dict[str, Any]:
    """The JAX tree layout of a model's parameters, layers stacked on a
    new axis 0: the tree the JAX bench checkpoints."""
    tree = {name: getattr(params, name) for name in
            ("embed", "embed_scale", "final_norm", "lm_head",
             "lm_head_scale") if getattr(params, name, None) is not None}
    names = [n for n, _ in params.layers[0].named_parameters()]
    tree["layers"] = {n: torch.stack([getattr(lp, n).detach()
                                      for lp in params.layers])
                      for n in names}
    return tree


def measure_ckpt(family: str, repeats: int = 3, device: DeviceLike = None,
                 **shape_kw) -> Dict[str, Any]:
    """Checkpoint save and restore latency of a family's whole parameter
    tree through ``train/checkpoint.py`` (atomic rename, checksummed
    manifest) in a throwaway directory, best of ``repeats``: what a
    synchronous save costs the step path, and how long a recovery stalls
    before its first step."""
    from skypilot_tpu_torch.train import checkpoint as checkpoint_lib
    mdl, cfg, device, params = _setup(family, device, shape_kw)
    tree = {"params": _param_tree(params)}
    _sync(device)
    ckpt_dir = tempfile.mkdtemp(prefix=f"stpu-ckpt-bench-{family}-")
    try:
        save_s = restore_s = float("inf")
        for i in range(repeats):
            _, dt = _timed(device, lambda: checkpoint_lib.save(
                ckpt_dir, i, tree, keep=1))
            save_s = min(save_s, dt)
            restored, dt = _timed(device, lambda: checkpoint_lib.
                                  restore_latest(ckpt_dir, like=tree))
            restore_s = min(restore_s, dt)
            assert restored is not None and restored.step == i
        manifest = checkpoint_lib.latest_step(ckpt_dir)
        with open(f"{ckpt_dir}/ckpt-{manifest:08d}.json") as f:
            nbytes = json.load(f)["payload_bytes"]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {
        "ckpt_save_s": round(save_s, 4),
        "ckpt_restore_s": round(restore_s, 4),
        "ckpt_bytes": nbytes,
        "repeats": repeats,
        "model": _model_info(family, cfg, params),
    }


def _slo_spec(cfg, qps, duration_s, seed, max_tokens):
    """The SLO and chaos legs' workload: the shared-prefix chat mix under
    Poisson arrivals."""
    from skypilot_tpu_torch.benchmark import loadgen
    return loadgen.LoadSpec(
        mix="chat", arrival="poisson", qps=qps, duration_s=duration_s,
        seed=seed, max_tokens=max_tokens,
        vocab=min(cfg.vocab_size, 32000))


def _post(url: str, doc: Dict[str, Any], timeout: float = 600.0) -> bytes:
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def _stop_replica(httpd) -> None:
    """Engine and server down, the engine's KV pool freed; a replica
    already torn down passes through."""
    httpd.engine.shutdown()
    httpd.shutdown()
    httpd.server_close()
    httpd.engine.engine.release()


@contextlib.contextmanager
def _data_plane(cfg, params, device, slots: int, n_replicas: int, spec):
    """``n_replicas`` serve_llm replicas on one parameter tree (each with
    its own engine and KV pool), warmed, behind the port's load balancer
    (PrefixAffinityPolicy, 300 s upstream timeout). Yields the balancer's
    URL and the replica servers; tears every one down on exit."""
    from skypilot_tpu_torch.benchmark import loadgen
    from skypilot_tpu_torch.recipes import serve_llm
    from skypilot_tpu_torch.serve import load_balancer as lb_lib
    from skypilot_tpu_torch.serve.load_balancing_policies import (
        PrefixAffinityPolicy)
    servers, lb = [], None
    try:
        readies = []
        for _ in range(n_replicas):
            ready = threading.Event()
            httpd = serve_llm.serve(cfg, params, 0, ready_event=ready,
                                    engine_slots=slots, device=device)
            servers.append(httpd)
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
            readies.append(ready)
        if not all(r.wait(timeout=600) for r in readies):
            raise RuntimeError("replica never became healthy")
        urls = [f"http://127.0.0.1:{h.server_address[1]}" for h in servers]
        # Warm each replica's whole serving path before the clock starts:
        # beyond engine.warmup()'s request, the first shared-prefix traffic
        # publishes prefix blocks (a slot's free) and aliases them (a hit),
        # and the first calls of those paths pay the CUDA allocator's and
        # cuBLAS's one-time costs (JAX's bench warms its XLA compiles
        # here). Two sequential requests sharing the trace's first prefix
        # run each path once.
        warm_prefix = loadgen._prefixes(spec)[0]
        for url in urls:
            for i in range(2):
                _post(url, {"prompt": warm_prefix + [17 + i],
                            "max_tokens": 2})
        policy = PrefixAffinityPolicy()
        policy.set_ready_replicas(urls)
        lb = lb_lib.run_load_balancer(0, policy, lb_lib.RequestRecorder())
        # Tail requests queue behind slot contention under load; the LB's
        # default 120 s first-byte timeout would turn a saturated but live
        # engine into 502s mid-leg.
        lb.RequestHandlerClass.upstream_timeout = 300.0
        yield f"http://127.0.0.1:{lb.server_address[1]}", servers
    finally:
        if lb is not None:
            lb.shutdown()
            lb.server_close()
        for httpd in servers:
            _stop_replica(httpd)


def measure_engine_slo(family: str, *, slots: int = 8,
                       qps: float = 6.0, duration_s: float = 8.0,
                       seed: int = 0, slo_ttft_s: float = 3.0,
                       slo_tpot_s: float = 0.5, max_tokens: int = 16,
                       device: DeviceLike = None,
                       **shape_kw) -> Dict[str, Any]:
    """SLO-graded serving leg: the family's engine behind a serve_llm
    replica and the port's load balancer, driven by the open-loop load
    generator under the shared-prefix chat mix. Unlike the engine legs
    (the engine alone, everything submitted at once) it measures what a
    user sees through the whole data plane (HTTP, the balancer's hop,
    queueing under Poisson arrivals) and grades it against the TTFT and
    TPOT SLOs: ``slo_goodput``, ``p99_ttft_s`` and ``loadgen_tok_s``. A
    regression that shows only under concurrent load lands here, where
    the isolated-engine legs stay green."""
    from skypilot_tpu_torch.benchmark import loadgen
    mdl, cfg, device, params = _setup(family, device, shape_kw)
    spec = _slo_spec(cfg, qps, duration_s, seed, max_tokens)
    with _data_plane(cfg, params, device, slots, 1, spec) as (target, _):
        report = loadgen.run(
            target, spec, slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
            scrape_interval=1.0,
            out_dir=tempfile.mkdtemp(
                prefix=f"stpu-loadgen-bench-{family}-"),
            request_timeout=300.0)
    ttft = report["latency_s"]["ttft"] or {}
    return {
        "model": _model_info(family, cfg, params),
        "slots": slots,
        "offered_qps": report["qps"]["offered"],
        "achieved_qps": report["qps"]["achieved"],
        "requests": report["requests"]["scheduled"],
        "errors": report["requests"]["error"],
        "slo_ttft_s": slo_ttft_s,
        "slo_tpot_s": slo_tpot_s,
        "slo_goodput": report["goodput"]["fraction"],
        "p99_ttft_s": ttft.get("p99"),
        "p50_ttft_s": ttft.get("p50"),
        "loadgen_tok_s": report["tokens"]["tok_s"],
        "schedule_sha256": report["schedule_sha256"],
        "report_dir": report["out_dir"],
    }


def measure_engine_chaos(family: str, *, slots: int = 8,
                         qps: float = 6.0, duration_s: float = 8.0,
                         seed: int = 0, slo_ttft_s: float = 3.0,
                         slo_tpot_s: float = 0.5, max_tokens: int = 16,
                         kill_at_frac: float = 0.5,
                         device: DeviceLike = None,
                         **shape_kw) -> Dict[str, Any]:
    """Durable-streams chaos leg: the SLO leg's data plane with two
    replicas, the schedule run twice: kill-free (the baseline), then with
    replica A's engine and HTTP server torn down ``kill_at_frac`` into
    the run (in-flight streams drop without ``[DONE]``, new connects are
    refused). The balancer's stream journal resumes the broken streams on
    B and its breaker ejects A for the traffic before a first byte, so
    goodput should barely move: ``chaos_goodput_ratio`` (chaos over
    baseline goodput) is the within-5%-of-kill-free contract, beside the
    absolute ``chaos_slo_goodput``. ``resumed_streams`` > 0 tells "healed
    by resume" from "nothing was in flight when A died"."""
    from skypilot_tpu_torch.benchmark import loadgen
    mdl, cfg, device, params = _setup(family, device, shape_kw)
    spec = _slo_spec(cfg, qps, duration_s, seed, max_tokens)
    kill_at = max(duration_s * kill_at_frac, 0.1)
    with _data_plane(cfg, params, device, slots, 2, spec) as (target,
                                                              servers):
        def _kill_replica_a() -> None:
            # The in-process stand-in for a SIGKILL: the engine's shutdown
            # drops every in-flight stream mid-token (no [DONE]), and the
            # closed server refuses new connects. No drain, no notice.
            victim = servers[0]
            victim.engine.shutdown()
            victim.shutdown()
            victim.server_close()

        killer = threading.Timer(kill_at, _kill_replica_a)
        killer.daemon = True
        try:
            baseline = loadgen.run(
                target, spec, slo_ttft_s=slo_ttft_s,
                slo_tpot_s=slo_tpot_s, scrape_interval=1.0,
                out_dir=tempfile.mkdtemp(
                    prefix=f"stpu-chaos-base-{family}-"),
                request_timeout=300.0)
            killer.start()
            chaos = loadgen.run(
                target, spec, slo_ttft_s=slo_ttft_s,
                slo_tpot_s=slo_tpot_s, scrape_interval=1.0,
                out_dir=tempfile.mkdtemp(
                    prefix=f"stpu-chaos-kill-{family}-"),
                request_timeout=300.0)
        finally:
            killer.cancel()
            if killer.is_alive():
                killer.join()
    base_frac = baseline["goodput"]["fraction"]
    chaos_frac = chaos["goodput"]["fraction"]
    server = chaos.get("server", {})
    return {
        "model": _model_info(family, cfg, params),
        "slots": slots,
        "replicas": 2,
        "offered_qps": chaos["qps"]["offered"],
        "requests": chaos["requests"]["scheduled"],
        "kill_at_s": round(kill_at, 3),
        "slo_ttft_s": slo_ttft_s,
        "slo_tpot_s": slo_tpot_s,
        "baseline_slo_goodput": base_frac,
        "chaos_slo_goodput": chaos_frac,
        "chaos_goodput_ratio": round(
            chaos_frac / max(base_frac, 1e-9), 4),
        "chaos_errors": chaos["requests"]["error"],
        "resumed_streams": server.get("resumed_streams", 0.0),
        "lb_stream_resumes": server.get("lb_stream_resumes", {}),
        "resume_gap": server.get("resume_gap"),
        "schedule_sha256": chaos["schedule_sha256"],
        "baseline_report_dir": baseline["out_dir"],
        "chaos_report_dir": chaos["out_dir"],
    }


MODES = ("fixed", "engine", "paged", "q8", "spec", "prefix", "ckpt",
         "loadgen", "chaos", "tier", "tp")


def main(argv=None) -> None:
    """``tools/bench_moe_decode.py``'s flags for the ported modes; prints
    the mode's dict as one JSON line. (``--tp-worker JOB RANK`` is a
    rank that ``--mode tp`` spawned.)"""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--tp-worker"]:
        _tp_rank_main(argv[1], int(argv[2]))
        return
    p = argparse.ArgumentParser()
    p.add_argument("--family", choices=("mixtral", "llama", "gemma"),
                   default="mixtral")
    p.add_argument("--mode", choices=MODES, default="fixed",
                   help="fixed: batch decode; engine: the engine under "
                        "ragged arrivals; paged: the paged pool at half "
                        "the dense budget; q8: int8 KV and weights with "
                        "the capacity ratio; spec: speculative decoding "
                        "vs none on the chat mix; prefix: shared-prefix "
                        "traffic; ckpt: checkpoint save/restore; "
                        "loadgen: a replica behind the load balancer "
                        "under the load generator, SLO-graded; chaos: "
                        "two replicas, one killed mid-run; tier: the "
                        "host-RAM spill tier; tp: the engine over --tp "
                        "ranks it spawns")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--tokens", type=int, default=128)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--slots", type=int, default=8,
                   help="engine modes: concurrent decode slots")
    p.add_argument("--requests", type=int, default=32,
                   help="engine modes: requests submitted")
    p.add_argument("--shared-prefix", type=int, default=256,
                   help="prefix mode: shared system-prompt tokens")
    p.add_argument("--spec-k", type=int, default=4,
                   help="spec mode: drafted tokens per slot per step")
    p.add_argument("--qps", type=float, default=6.0,
                   help="loadgen mode: offered Poisson arrival rate")
    p.add_argument("--duration", type=float, default=8.0,
                   help="loadgen mode: trace length in seconds")
    p.add_argument("--slo-ttft", type=float, default=3.0,
                   help="loadgen mode: TTFT SLO in seconds")
    p.add_argument("--slo-tpot", type=float, default=0.5,
                   help="loadgen mode: per-output-token SLO in seconds")
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--experts", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device; default the card, 'cpu' on request")
    p.add_argument("--tp", type=int, default=2,
                   help="tp mode: ranks (one process each)")
    p.add_argument("--tp-backend", choices=("nccl", "gloo"), default=None,
                   help="tp mode: the group's backend")
    args = p.parse_args(argv)
    shape_kw = {k: v for k, v in (("dim", args.dim),
                                  ("layers", args.layers),
                                  ("experts", args.experts))
                if v is not None}
    if shape_kw and args.family != "mixtral":
        p.error("--dim/--layers/--experts only apply to --family mixtral "
                "(llama/gemma shapes are fixed)")
    shape_kw["device"] = args.device
    engine = dict(slots=args.slots, n_requests=args.requests)
    if args.mode == "engine":
        result = measure_engine_ragged(args.family, **engine, **shape_kw)
    elif args.mode == "paged":
        result = measure_engine_paged(args.family, **engine, **shape_kw)
    elif args.mode == "q8":
        result = measure_engine_q8(args.family, **engine, **shape_kw)
    elif args.mode == "spec":
        result = measure_engine_spec(args.family, spec_k=args.spec_k,
                                     **engine, **shape_kw)
    elif args.mode == "prefix":
        result = measure_engine_prefix(args.family, slots=args.slots,
                                       shared_prefix=args.shared_prefix,
                                       **shape_kw)
    elif args.mode == "ckpt":
        result = measure_ckpt(args.family, repeats=args.repeats, **shape_kw)
    elif args.mode in ("loadgen", "chaos"):
        measure = (measure_engine_slo if args.mode == "loadgen"
                   else measure_engine_chaos)
        result = measure(args.family, slots=args.slots, qps=args.qps,
                         duration_s=args.duration,
                         slo_ttft_s=args.slo_ttft,
                         slo_tpot_s=args.slo_tpot, **shape_kw)
    elif args.mode == "tier":
        result = measure_engine_tier(args.family, **engine, **shape_kw)
    elif args.mode == "tp":
        result = measure_engine_tp(args.family, tp=args.tp,
                                   backend=args.tp_backend, **engine,
                                   **shape_kw)
    else:
        result = measure_decode(args.family, batch=args.batch,
                                prompt_len=args.prompt_len,
                                tokens=args.tokens, repeats=args.repeats,
                                **shape_kw)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
