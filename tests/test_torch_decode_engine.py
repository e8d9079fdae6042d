"""The port's continuous-batching DecodeEngine
(skypilot_tpu_torch.serve.decode_engine) against the JAX package's engine
on the same converted weights, on the CPU in f32: greedy and seeded
streams token for token, for the dense and the paged cache, prefix hit and
miss, speculative decoding off and on (spec_k 0 and 4), int8 weights with
int8 KV, and the host spill tier (spill, then re-admit on a warm match);
then the supervisor's restart after an injected fault, kv_config against
JAX's, and the paged step's write targets.

The JAX engine's streams are the same in every one of these modes (its
own tests hold dense == paged == spec on == spec off, and a re-admitted
block equal to a cold prefill), so each mode of the port is held to one
JAX run per numeric mode (f32, int8). The stream checks run again on two
Gemma configs (``test_gemma_engine_matches_jax``): the tiny one and
Gemma-2B's MQA head at head_dim 256.
"""
import dataclasses
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import gemma as gemma_jax
from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.serve import decode_engine as engine_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import gemma as gemma_torch
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.models import mixtral as mixtral_torch
from skypilot_tpu_torch.observability import metrics as metrics_torch
from skypilot_tpu_torch.serve import decode_engine as engine_torch
from skypilot_tpu_torch.utils import fault_injection

VOCAB = 128
GEOMETRY = dict(slots=2, max_seq=64, prefill_chunk=8)


def _requests():
    """(prompt, max_tokens, temperature, seed): two greedy, two seeded;
    the two repetitive prompts settle into cycles the n-gram drafter
    (spec_ngram 2) proposes from."""
    rng = random.Random(1)
    rand = [rng.randint(1, VOCAB - 1) for _ in range(17)]
    loop = [5, 6, 7] * 6
    return [(rand, 6, 0.0, 0), (loop, 10, 0.2, 17), (loop, 10, 0.0, 0),
            (rand[:9], 6, 0.7, 5)]


# Shares the first two 8-token blocks of request 0's prompt.
PREFIXED = (_requests()[0][0] + [3, 1, 4, 1, 5], 6, 0.0, 0)


@pytest.fixture(scope="module")
def model():
    cfg_j = dataclasses.replace(llama_jax.LlamaConfig.tiny(VOCAB),
                                n_layers=2, dtype=jnp.float32)
    cfg_t = dataclasses.replace(llama_torch.LlamaConfig.tiny(VOCAB),
                                n_layers=2, dtype=torch.float32)
    params_j = llama_jax.init(cfg_j, jax.random.key(0))
    params_t = convert.llama_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _run(engine, reqs):
    try:
        handles = [engine.submit(p, max_tokens=m, temperature=t, seed=s)
                   for p, m, t, s in reqs]
        return [h.result(timeout=300.0) for h in handles]
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def jax_streams(model):
    return _jax_streams(model)


def _jax_streams(model):
    """The JAX engine's streams: {"f32": ..., "int8": ...}, each the
    requests' streams followed by PREFIXED's."""
    cfg_j, _, params_j, _ = model
    reqs = _requests() + [PREFIXED]
    out = {}
    for mode, quant in (("f32", False), ("int8", True)):
        eng = engine_jax.DecodeEngine(
            cfg_j, params_j, paged=True, kv_quant=quant, weight_quant=quant,
            use_manifest=False, **GEOMETRY).start()
        out[mode] = _run(eng, reqs)
    return out


def _port_engine(model, **kw):
    _, cfg_t, _, params_t = model
    return engine_torch.DecodeEngine(cfg_t, params_t, device="cpu",
                                     **GEOMETRY, **kw).start()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("spec_k", [0, 4], ids=["spec0", "spec4"])
def test_engine_matches_jax(model, jax_streams, paged, spec_k):
    eng = _port_engine(model, paged=paged, spec_k=spec_k, spec_ngram=2)
    drafted = metrics_torch.REGISTRY.counter(
        "stpu_engine_spec_drafted_tokens_total")
    before = drafted.get()
    assert _run(eng, _requests()) == jax_streams["f32"][:4]
    if spec_k:
        assert drafted.get() > before


@pytest.mark.parametrize("spec_k", [0, 4], ids=["spec0", "spec4"])
def test_engine_int8_weights_and_kv_match_jax(model, jax_streams, spec_k):
    eng = _port_engine(model, paged=True, kv_quant=True, weight_quant=True,
                       spec_k=spec_k, spec_ngram=2)
    assert eng.kv_config()["kv_quant"] == eng.kv_config()["weight_quant"] \
        == 1
    assert _run(eng, _requests()) == jax_streams["int8"][:4]


def test_prefix_hit_matches_jax(model, jax_streams):
    """A request sharing two whole blocks with a finished one aliases
    them (a zero-copy hit) and still streams JAX's cold tokens; the miss
    before it streams JAX's too."""
    hits = metrics_torch.REGISTRY.counter(
        "stpu_engine_prefix_cache_hits_total")
    before = hits.get()
    eng = _port_engine(model, paged=True)
    try:
        first = eng.submit(_requests()[0][0], max_tokens=6)
        assert first.result(timeout=300.0) == jax_streams["f32"][0]
        assert first.cached_prompt_tokens == 0
        warm = eng.submit(PREFIXED[0], max_tokens=6)
        assert warm.result(timeout=300.0) == jax_streams["f32"][4]
        assert warm.cached_prompt_tokens == 16
    finally:
        eng.shutdown()
    assert hits.get() == before + 1


def _drain_to_host(eng, timeout=30.0):
    """Spill every evictable device block to the host tier and wait for
    the copies to land."""
    while True:
        out = eng.prefix_cache.evict_one()
        if not out:
            break
        assert out == "spilled", out
    deadline = time.monotonic() + timeout
    while eng.spill_in_flight() > 0:
        assert time.monotonic() < deadline, "spill drain never landed"
        time.sleep(0.005)


def test_host_tier_readmit_matches_jax(model, jax_streams):
    """Cold streams, every prefix block spilled to the host tier, then
    the same requests again: re-admitted blocks give JAX's streams, in
    fewer prefill chunks."""
    reqs = _requests()[:2]
    eng = _port_engine(model, paged=True, prefix_cache_mb=8)
    try:
        cold = [eng.submit(p, max_tokens=m, temperature=t, seed=s)
                for p, m, t, s in reqs]
        assert [h.result(timeout=300.0) for h in cold] == \
            jax_streams["f32"][:2]
        _drain_to_host(eng)
        assert eng.prefix_cache.stats()["host_chunks"] >= 4
        warm = [eng.submit(p, max_tokens=m, temperature=t, seed=s)
                for p, m, t, s in reqs]
        assert [h.result(timeout=300.0) for h in warm] == \
            jax_streams["f32"][:2]
        assert all(w.prefill_chunks < c.prefill_chunks
                   for w, c in zip(warm, cold))
        assert eng.host_tier_stats()["readmitted_blocks"] >= 4
    finally:
        eng.shutdown()


def test_supervisor_restarts_after_step_fault(model):
    """An injected fault at engine.step kills the loop: the request in
    flight fails cleanly, the supervisor rebuilds the engine (the dead
    one's cache released), and the next request streams."""
    _, cfg_t, _, params_t = model
    sup = engine_torch.EngineSupervisor(
        lambda: engine_torch.DecodeEngine(cfg_t, params_t, device="cpu",
                                          **GEOMETRY),
        backoff_base=0.01, poll_interval=0.01).start()
    try:
        first = sup.engine
        with fault_injection.inject("engine.step", mode="raise", times=1):
            with pytest.raises(engine_torch.EngineError):
                sup.submit([1, 2, 3], max_tokens=4).result(timeout=60.0)
        deadline = time.monotonic() + 30.0
        while sup.restarts < 1 or not sup.healthy():
            assert time.monotonic() < deadline, "no restart"
            time.sleep(0.01)
        assert sup.engine is not first and first._cache == {}
        assert len(sup.submit([1, 2, 3], max_tokens=4).result(
            timeout=60.0)) == 4
    finally:
        sup.shutdown()


@pytest.mark.parametrize("kw", [
    dict(slots=4, max_seq=1280),
    dict(slots=8, max_seq=1280, paged=True, prefill_chunk=64),
    dict(slots=2, max_seq=64, paged=True, kv_quant=True, weight_quant=True,
         spec_k=4, host_cache_mb=8.0),
    dict(slots=3, max_seq=100, paged=True, block=48, window_blocks=3),
], ids=["dense", "paged-8x1280", "int8-spec", "odd-geometry"])
def test_kv_config_equals_jax(kw, monkeypatch):
    """The effective geometry (auto-sized pool, shrunk chunk, window,
    table length) is JAX's dict for the same arguments, with no tuning
    manifest: "manifest": "default"."""
    monkeypatch.setenv("STPU_TUNE_MANIFEST", "0")
    want = engine_jax.resolve_kv_geometry(family="llama", **kw)
    assert engine_torch.resolve_kv_geometry(**kw) == want
    assert want["manifest"] == "default"


def test_engine_kv_config_is_the_geometry(model):
    eng = _port_engine(model, paged=True, spec_k=4)
    eng.shutdown()
    assert eng.kv_config() == engine_torch.resolve_kv_geometry(
        paged=True, spec_k=4, **GEOMETRY)


def test_live_blocks_written_once_per_step(model, monkeypatch):
    """No live pool block receives two writes in one batched step or
    verify window: every (block, offset) a live slot writes is its own
    (free slots write the scratch block 0)."""
    seen = []
    bt = GEOMETRY["prefill_chunk"]

    def targets(pos, table, spans):
        out = []
        for b, (p, n) in enumerate(zip(pos, spans)):
            for q in range(int(p), int(p) + int(n)):
                blk = int(table[b, q // bt])
                if blk:
                    out.append((blk, q % bt))
        return out

    step, spec_step = engine_torch._paged_step, engine_torch._paged_spec_step

    def spy_step(cfg, params, cache, toks, pos, table, *rest):
        seen.append(targets(pos, table, np.ones_like(pos)))
        return step(cfg, params, cache, toks, pos, table, *rest)

    def spy_spec(cfg, params, cache, toks, pos, spec_len, table, *rest):
        seen.append(targets(pos, table, spec_len + 1))
        return spec_step(cfg, params, cache, toks, pos, spec_len, table,
                         *rest)

    monkeypatch.setattr(engine_torch, "_paged_step", spy_step)
    monkeypatch.setattr(engine_torch, "_paged_spec_step", spy_spec)
    _run(_port_engine(model, paged=True, spec_k=4, spec_ngram=2),
         _requests())
    assert seen and any(len(s) > 1 for s in seen)
    for writes in seen:
        assert len(writes) == len(set(writes)), writes


def test_engine_refuses_what_is_not_ported(model, monkeypatch):
    _, cfg_t, _, params_t = model
    with pytest.raises(ValueError, match="mixtral serving is not ported"):
        engine_torch.DecodeEngine(mixtral_torch.MixtralConfig.tiny(),
                                  params_t, device="cpu")
    with pytest.raises(ValueError, match="tensor-parallel"):
        engine_torch.DecodeEngine(cfg_t, params_t, device="cpu",
                                  mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_torch.DecodeEngine(cfg_t, params_t)


def test_stepstats_times_the_port_engine_steps(model):
    """The port's stepstats copy, armed with a sync every step: the
    engine's decode steps land in the ring with a sampled device wait
    (no CUDA event on the CPU: the wait is measured around nothing),
    and the /perf snapshot counts them."""
    from skypilot_tpu_torch.observability import stepstats
    stepstats.arm(ring=256, sync_every=1)
    stepstats.reset()
    try:
        _run(_port_engine(model, paged=True), _requests()[:2])
        recs = stepstats.steps_tail()
        snap = stepstats.snapshot()
    finally:
        stepstats.arm(sync_every=0)      # the module's defaults again
        stepstats.disarm()
        stepstats.reset()
    decode = [r for r in recs if r["phase"] == "decode"]
    assert decode and all(r["device_s"] is not None for r in decode)
    assert snap["steps"] == len(recs) and "decode" in snap["phases"]
    assert stepstats.sampled_sync(None) >= 0.0

    class _Event:
        waited = False

        def synchronize(self):
            self.waited = True

    ev = _Event()
    stepstats.sampled_sync(ev)
    assert ev.waited


def test_capture_profile_writes_a_torch_trace(tmp_path, monkeypatch):
    from skypilot_tpu_torch.observability import stepstats
    monkeypatch.setenv("STPU_DISABLE_EVENTS", "1")
    out = stepstats.capture_profile(0.05, out_dir=str(tmp_path / "prof"))
    assert out["profile_dir"] == str(tmp_path / "prof")
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert stepstats.begin_profile()      # the slot was released
    stepstats.capture_profile(0.05, out_dir=str(tmp_path / "p2"),
                              claimed=True)


# Gemma's tiny config, and Gemma-2B's attention (MQA, head_dim 256) at a
# small width; 2 layers, f32.
GEMMA_FIELDS = {"tiny": dict(n_layers=2),
                "d256": dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=1,
                             head_dim_=256, mlp_dim=512)}


@pytest.fixture(scope="module", params=list(GEMMA_FIELDS))
def gemma_streams(request):
    """(model, the JAX engine's streams) for one Gemma config."""
    fields = GEMMA_FIELDS[request.param]
    cfg_j = dataclasses.replace(gemma_jax.GemmaConfig.tiny(VOCAB),
                                dtype=jnp.float32, **fields)
    cfg_t = dataclasses.replace(gemma_torch.GemmaConfig.tiny(VOCAB),
                                dtype=torch.float32, **fields)
    params_j = gemma_jax.init(cfg_j, jax.random.key(0))
    params_t = convert.gemma_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    model = (cfg_j, cfg_t, params_j, params_t)
    return model, _jax_streams(model)


GEMMA_CHECKS = {
    "dense": lambda m, s: test_engine_matches_jax(m, s, False, 0),
    "paged-spec4": lambda m, s: test_engine_matches_jax(m, s, True, 4),
    "int8": lambda m, s: test_engine_int8_weights_and_kv_match_jax(m, s, 0),
    "prefix-hit": test_prefix_hit_matches_jax,
    "host-tier": test_host_tier_readmit_matches_jax,
}


@pytest.mark.parametrize("check", list(GEMMA_CHECKS))
def test_gemma_engine_matches_jax(gemma_streams, check):
    GEMMA_CHECKS[check](*gemma_streams)
