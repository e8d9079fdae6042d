"""The port's tensor-parallel engine (a DecodeEngine on a tp mesh,
skypilot_tpu_torch/serve/gang_replica.py) against the port's one-process
engine and the JAX package's one-process DecodeEngine on the same
converted weights, on the CPU in f32. Two gloo ranks of
``tests/torch_rank_worker.py tp`` (one spawn for the file, 60 s group
timeouts) run every case: rank 0 schedules and plans each call, rank 1
makes it on its shard. Token streams, greedy and seeded, for the dense
and paged caches, int8 weights and KV, speculative decoding on the paged
pool, a host-tier spill and re-admit, Mixtral (its MoE split on ``mlp``
per expert), and Gemma's single KV head read whole on both ranks; the
tp cache paths' logits against the one-process forward within 1e-5.

JAX's own tests hold dense, paged, speculative and re-admitted streams
equal to one another in f32, so one JAX run per numeric mode (f32, int8)
and family stands for them."""
import dataclasses
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import gemma as gemma_jax
from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.models import mixtral as mixtral_jax
from skypilot_tpu.serve import decode_engine as engine_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import gemma as gemma_torch
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.models import mixtral as mixtral_torch
from skypilot_tpu_torch.serve import decode_engine as engine_torch
from skypilot_tpu_torch.serve import gang_replica
from torch_rank_worker import launch

VOCAB = 128
TP = 2
GEOMETRY = dict(slots=2, max_seq=64, prefill_chunk=8)
MODES = {
    "dense": dict(),
    "paged": dict(paged=True),
    "int8": dict(paged=True, kv_quant=True, weight_quant=True),
    "spec": dict(paged=True, spec_k=4, spec_ngram=2),
    "tier": dict(paged=True, prefix_cache_mb=8),
    # A host tier of two blocks: spills drop others, and rank 0 forwards
    # each drop to rank 1.
    "tier_lru": dict(paged=True, prefix_cache_mb=0.01),
    "mixtral": dict(paged=True),
    "gemma": dict(paged=True),
}
LOGITS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def no_tuning_manifest():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STPU_TUNE_MANIFEST", "0")
        yield


def _requests():
    """Two greedy and two seeded requests (the repetitive prompts give
    the n-gram drafter something to propose)."""
    rng = random.Random(1)
    rand = [rng.randint(1, VOCAB - 1) for _ in range(17)]
    loop = [5, 6, 7] * 6
    return [(rand, 6, 0.0, 0), (loop, 10, 0.2, 17), (loop, 10, 0.0, 0),
            (rand[:9], 6, 0.7, 5)]


def _family(mode):
    return mode if mode in ("mixtral", "gemma") else "llama"


@pytest.fixture(scope="module")
def models():
    """{family: (jax cfg, torch cfg, jax params, numpy tree)}, f32."""
    out = {}
    for family, mod_j, mod_t, cls_j, cls_t, from_jax, layers in (
            ("llama", llama_jax, llama_torch, llama_jax.LlamaConfig,
             llama_torch.LlamaConfig, convert.llama_params_from_jax, 2),
            ("gemma", gemma_jax, gemma_torch, gemma_jax.GemmaConfig,
             gemma_torch.GemmaConfig, convert.gemma_params_from_jax, 2),
            ("mixtral", mixtral_jax, mixtral_torch,
             mixtral_jax.MixtralConfig, mixtral_torch.MixtralConfig,
             convert.mixtral_params_from_jax, 2)):
        cfg_j = dataclasses.replace(cls_j.tiny(VOCAB), n_layers=layers,
                                    dtype=jnp.float32)
        cfg_t = dataclasses.replace(cls_t.tiny(VOCAB), n_layers=layers,
                                    dtype=torch.float32)
        params_j = mod_j.init(cfg_j, jax.random.key(0))
        out[family] = (cfg_j, cfg_t, params_j,
                       jax.tree.map(np.asarray, params_j), from_jax, mod_t)
    return out


@pytest.fixture(scope="module")
def tp_run(models, tmp_path_factory):
    """Every case through the two ranks; {case: rank 0's result}."""
    root = tmp_path_factory.mktemp("tp_serve")
    cases = {}
    for mode, kw in MODES.items():
        family = _family(mode)
        cases[mode] = dict(kind="tp_engine", family=family, vocab=VOCAB,
                           cfg=dict(n_layers=2), init=models[family][3],
                           engine={**GEOMETRY, **kw},
                           requests=_requests()[:2] if "tier" in mode
                           else _requests(),
                           quantize=mode == "int8", evict="tier" in mode)
    tokens = np.random.default_rng(3).integers(0, VOCAB, (2, 16))
    for family in ("llama", "mixtral"):
        cases[f"logits_{family}"] = dict(
            kind="tp_logits", family=family, vocab=VOCAB,
            cfg=dict(n_layers=2), init=models[family][3], tokens=tokens,
            block_tokens=8)
    (root / "cases.pkl").write_bytes(pickle.dumps(cases))
    addr = gang_replica.free_addr()
    try:
        launch(lambda r: ["tp", str(root), str(r), str(TP), addr], TP)
    finally:
        for err in sorted(root.glob("error_*.txt")):
            print(err.name, err.read_text())
    out = pickle.loads((root / "results.pkl").read_bytes())
    for name, res in pickle.loads(
            (root / "results_1.pkl").read_bytes()).items():
        out[name]["rank1"] = res
    return out


def _run(engine, reqs):
    try:
        handles = [engine.submit(p, max_tokens=m, temperature=t, seed=s)
                   for p, m, t, s in reqs]
        return [h.result(timeout=120.0) for h in handles]
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engine's streams per (family, numeric mode)."""
    out = {}
    for family, quant in (("llama", False), ("llama", True),
                          ("mixtral", False), ("gemma", False)):
        cfg_j, _, params_j = models[family][:3]
        eng = engine_jax.DecodeEngine(
            cfg_j, params_j, paged=True, kv_quant=quant,
            weight_quant=quant, use_manifest=False, **GEOMETRY).start()
        out[family, quant] = _run(eng, _requests())
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_tp_engine_streams_equal_one_process_and_jax(mode, models, tp_run,
                                                      jax_streams):
    """The tp-2 engine's greedy and seeded streams equal the port's
    one-process engine's and the JAX engine's on the same weights."""
    res = tp_run[mode]
    assert "error" not in res, res.get("error")
    family = _family(mode)
    _, cfg_t, _, tree, from_jax, _ = models[family]
    reqs = _requests()[:2] if "tier" in mode else _requests()
    engine = engine_torch.DecodeEngine(
        cfg_t, from_jax(cfg_t, tree, "cpu"), device="cpu",
        use_manifest=False, **GEOMETRY, **MODES[mode])
    one = _run(engine.start(), reqs)
    want = jax_streams[family, mode == "int8"][:len(reqs)]
    for streams in res["streams"]:
        assert streams == one == want
    # The geometry the welcome compares: one process's, and the tp.
    assert res["kv"] == {**engine.kv_config(), "tp": TP}


@pytest.mark.parametrize("mode", ["tier", "tier_lru"])
def test_tp_host_tier_readmits_every_rank_shard(mode, tp_run):
    """Every prefix block spilled to the host tier (each rank its own
    shard), then the same requests again: re-admitted on both ranks, the
    cold streams again, in fewer prefill chunks. In a tier of two blocks
    the spills drop older ones, and rank 1 keeps exactly the blocks rank
    0's tier still holds."""
    res = tp_run[mode]
    cold, warm = res["streams"]
    assert warm == cold
    cold_chunks, warm_chunks = res["chunks"]
    if mode == "tier":
        assert all(w < c for w, c in zip(warm_chunks, cold_chunks))
    assert sum(warm_chunks) < sum(cold_chunks)
    tier = res["tier"]
    assert tier["readmitted_blocks"] >= (4 if mode == "tier" else 1)
    assert (tier["lru_dropped"] > 0) == (mode == "tier_lru")
    assert res["rank1"]["tp_host"] == tier["blocks"] > 0


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_tp_cache_paths_match_the_one_process_forward(family, models,
                                                      tp_run):
    """Teacher-forced logits of the tp tree's dense and paged cache
    paths (vocab shards gathered) within 1e-5 of the one-process
    forward's (Mixtral's with no token dropped: dense routing)."""
    res = tp_run[f"logits_{family}"]
    assert "error" not in res, res.get("error")
    _, cfg_t, _, tree, from_jax, mod_t = models[family]
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, VOCAB, (2, 16)))
    fwd_cfg = dataclasses.replace(cfg_t, remat=False)
    if family == "mixtral":
        # Capacity n_experts / top_k drops no token: dense routing.
        fwd_cfg = dataclasses.replace(
            fwd_cfg, capacity_factor=cfg_t.n_experts / cfg_t.top_k)
    with torch.inference_mode():
        want = mod_t.forward(fwd_cfg, from_jax(cfg_t, tree, "cpu"), tokens)
    if isinstance(want, tuple):
        want = want[0]
    for path in ("dense", "paged"):
        np.testing.assert_allclose(res[path], want.numpy(), rtol=0,
                                   atol=LOGITS_TOL, err_msg=path)
