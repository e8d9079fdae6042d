"""The port's engine tuner (skypilot_tpu_torch.tune and the engine's manifest
lookup) against the JAX package's, on the CPU.

* The manifest contract: the schema constants, ``tuning_key``,
  ``payload_sha`` and the canonical bytes equal JAX's; a manifest written
  by either package loads in the other; ``validate`` accepts and rejects
  the same documents with the same messages; ``resolve_path``'s env
  contract and the corrupt/stale fallback (one warning, then defaults)
  behave as JAX's.
* ``resolve_kv_geometry`` returns JAX's dict, the manifest tag included,
  for the same arguments and manifest file: with and without an entry,
  with knobs the caller set (which the manifest must not override), with
  the lookup off and without a family.
* A CPU engine loads the manifest's constants; a ``decode_bench`` leg
  built beside the same manifest runs (and reports) the defaults.
* ``check_parity`` passes per family, dense and paged, at a non-default
  tile and chunk on the CPU, and catches a planted divergence.
* ``run_sweep`` with ``_measure`` stubbed (and the real gate) writes a
  valid manifest that the JAX package loads, the sweep's grids equal
  JAX's and hold the defaults, and the command line runs it.
"""
import json

import pytest
import torch

from skypilot_tpu.serve import decode_engine as engine_jax
from skypilot_tpu.tune import manifest as manifest_jax
from skypilot_tpu.tune import sweep as sweep_jax
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.serve import decode_engine
from skypilot_tpu_torch.tune import manifest as tune_manifest
from skypilot_tpu_torch.tune import parity
from skypilot_tpu_torch.tune import sweep as tune_sweep

PROV = {"device_kind": "NVIDIA H100 80GB HBM3", "commit": "abc1234",
        "created": "2026-08-06T00:00:00+0000"}
ENTRY = {"llama|b1-4|tp1|bf16": {"block": 32, "chunk": 16,
                                 "window_blocks": 2, "spec_k": 2,
                                 "parity": "pass"}}


@pytest.fixture
def manifest_env(tmp_state_dir, monkeypatch):
    """Hermetic manifest state: ~/.stpu in a tmpdir (both packages' default
    path), no ambient STPU_TUNE_MANIFEST, both caches cleared."""
    monkeypatch.delenv(tune_manifest.ENV_MANIFEST, raising=False)
    for mod in (tune_manifest, manifest_jax):
        mod.reset_for_tests()
    yield tmp_state_dir
    for mod in (tune_manifest, manifest_jax):
        mod.reset_for_tests()


# ==================================================== the contract
def test_schema_constants_equal_jax():
    for name in ("SCHEMA_VERSION", "ENTRY_KNOBS", "REQUIRED_PROVENANCE",
                 "ENV_MANIFEST", "_BANDS", "_BAND_OVERFLOW"):
        assert getattr(tune_manifest, name) == getattr(manifest_jax, name)


@pytest.mark.parametrize("args", [
    ("llama", 2), ("llama", 4), ("gemma", 5), ("mixtral", 16),
    ("mixtral", 8, 4, True, True), ("llama", 17, 1, True, False),
    ("gemma", 1, 2, False, True)])
def test_tuning_key_equals_jax(args):
    assert tune_manifest.tuning_key(*args) == manifest_jax.tuning_key(*args)


def test_payload_sha_and_bytes_equal_jax():
    payload = {"provenance": dict(PROV, tool="x"),
               "entries": {**ENTRY, "gemma|b5-16|tp1|q8kvw": {
                   "chunk": 128, "parity": "pass",
                   "objective": {"tok_s": 1234.5, "note": "é"}}}}
    assert (tune_manifest.canonical_payload_bytes(payload) ==
            manifest_jax.canonical_payload_bytes(payload))
    assert tune_manifest.payload_sha(payload) == \
        manifest_jax.payload_sha(payload)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manifest_written_by_either_loads_in_the_other(manifest_env,
                                                       writer):
    path = manifest_env / "m.json"
    mods = {"port": tune_manifest, "jax": manifest_jax}
    doc = mods[writer].save(ENTRY, PROV, path=path)
    text = path.read_text()
    for mod in mods.values():
        payload, tag = mod.load(path)
        assert payload == doc["payload"] and tag == doc["sha256"][:12]
    # Byte-identical files from the same entries.
    other = mods["jax" if writer == "port" else "port"]
    other.save(ENTRY, PROV, path=manifest_env / "o.json")
    assert (manifest_env / "o.json").read_text() == text


def _valid_doc(entries=None):
    payload = {"provenance": dict(PROV),
               "entries": entries if entries is not None else {
                   "llama|b1-4|tp1|bf16": {"block": 128,
                                           "parity": "pass"}}}
    return {"schema": 1, "sha256": tune_manifest.payload_sha(payload),
            "payload": payload}


def _resha(doc):
    doc["sha256"] = tune_manifest.payload_sha(doc["payload"])
    return doc


def _edit(fn):
    doc = _valid_doc()
    fn(doc)
    return doc


DOCS = {
    "valid": _valid_doc(),
    "spec_k_zero": _valid_doc({"llama|b1-4|tp1|bf16": {
        "spec_k": 0, "parity": "pass"}}),
    "stale": _edit(lambda d: d.update(schema=99)),
    "sha": _edit(lambda d: d["payload"]["entries"][
        "llama|b1-4|tp1|bf16"].update(block=256)),
    "key": _valid_doc({"llama|bf16": {"block": 128, "parity": "pass"}}),
    "no_knob": _valid_doc({"llama|b1-4|tp1|bf16": {"parity": "pass"}}),
    "bool": _valid_doc({"llama|b1-4|tp1|bf16": {"block": True,
                                                "parity": "pass"}}),
    "range": _valid_doc({"llama|b1-4|tp1|bf16": {"chunk": 0,
                                                 "parity": "pass"}}),
    "ungated": _valid_doc({"llama|b1-4|tp1|bf16": {"block": 128}}),
    "provenance": _resha(_edit(
        lambda d: d["payload"]["provenance"].pop("commit"))),
    "root": [],
}


@pytest.mark.parametrize("case", list(DOCS))
def test_validate_accepts_and_rejects_as_jax(case):
    def outcome(mod):
        try:
            return ("ok", mod.validate(json.loads(json.dumps(DOCS[case]))))
        except ValueError as err:
            assert type(err).__name__ == "ManifestError"
            return ("error", str(err))
    got, want = outcome(tune_manifest), outcome(manifest_jax)
    assert got == want
    assert (got[0] == "ok") == (case in ("valid", "spec_k_zero"))


def test_resolve_path_env_contract_as_jax(manifest_env, monkeypatch):
    def both():
        got = tune_manifest.resolve_path()
        assert got == manifest_jax.resolve_path()
        return got

    assert both() is None                      # unset, no file
    tune_manifest.save(ENTRY, PROV)
    assert tune_manifest.default_path() == manifest_jax.default_path()
    assert both() == tune_manifest.default_path()
    for off in ("0", "", " 0 "):
        monkeypatch.setenv("STPU_TUNE_MANIFEST", off)
        assert both() is None
        assert tune_manifest.entry_for(family="llama", slots=2) == (
            None, "default")
    other = manifest_env / "other.json"
    tune_manifest.save({"llama|b1-4|tp1|bf16": {"block": 512,
                                                "parity": "pass"}},
                       PROV, path=other, merge=False)
    monkeypatch.setenv("STPU_TUNE_MANIFEST", str(other))
    assert both() == other
    assert tune_manifest.entry_for(family="llama", slots=2) == \
        manifest_jax.entry_for(family="llama", slots=2)
    assert tune_manifest.entry_for(family="llama", slots=2)[0]["block"] \
        == 512


def test_save_merges_as_jax(manifest_env):
    tune_manifest.save(ENTRY, PROV)
    tune_manifest.save({"gemma|b1-4|tp1|bf16": {"chunk": 32,
                                                "parity": "pass"}}, PROV)
    payload, _ = manifest_jax.load(manifest_jax.default_path())
    assert set(payload["entries"]) == {"llama|b1-4|tp1|bf16",
                                       "gemma|b1-4|tp1|bf16"}
    tune_manifest.save({"mixtral|b1-4|tp1|bf16": {"spec_k": 2,
                                                  "parity": "pass"}},
                       PROV, merge=False)
    payload, _ = tune_manifest.load(tune_manifest.default_path())
    assert set(payload["entries"]) == {"mixtral|b1-4|tp1|bf16"}


@pytest.mark.parametrize("corruption", ["garbage", "sha", "stale"])
def test_corrupt_or_stale_manifest_falls_back(manifest_env, capsys,
                                              corruption):
    path = tune_manifest.default_path()
    doc = json.loads(json.dumps(tune_manifest.save(ENTRY, PROV)))
    if corruption == "garbage":
        path.write_text("{not json")
    elif corruption == "sha":
        doc["payload"]["entries"]["llama|b1-4|tp1|bf16"]["block"] = 16
        path.write_text(json.dumps(doc))
    else:
        doc["schema"] = 0
        path.write_text(json.dumps(doc))
    tune_manifest.reset_for_tests()
    assert tune_manifest.entry_for(family="llama", slots=2) == (
        None, "default")
    assert "ignoring manifest" in capsys.readouterr().err
    tune_manifest.entry_for(family="llama", slots=2)
    assert capsys.readouterr().err == ""       # warned once per path
    geo = decode_engine.resolve_kv_geometry(slots=2, max_seq=64,
                                            family="llama")
    assert geo == engine_jax.resolve_kv_geometry(slots=2, max_seq=64,
                                                 family="llama")
    assert geo["manifest"] == "default" and geo["block"] == 64


# ============================================== geometry resolution
GEOMETRY = {
    "tuned_paged": dict(slots=2, max_seq=64, paged=True, family="llama"),
    "tuned_dense": dict(slots=3, max_seq=64, family="llama"),
    "tuned_q8_no_entry": dict(slots=2, max_seq=64, paged=True,
                              kv_quant=True, weight_quant=True,
                              family="llama"),
    "other_family": dict(slots=2, max_seq=64, paged=True, family="gemma"),
    "other_band": dict(slots=8, max_seq=128, paged=True, family="llama"),
    "caller_chunk": dict(slots=2, max_seq=64, paged=True, prefill_chunk=8,
                         family="llama"),
    "caller_block_tokens": dict(slots=2, max_seq=64, paged=True,
                                kv_block_tokens=8, family="llama"),
    "caller_all": dict(slots=2, max_seq=64, paged=True, block=16,
                       window_blocks=1, spec_k=3, prefill_chunk=32,
                       family="llama"),
    "no_family": dict(slots=2, max_seq=64, paged=True),
    "host_tier": dict(slots=4, max_seq=256, paged=True, host_cache_mb=64.0,
                      kv_pool_blocks=20, family="llama"),
}


@pytest.mark.parametrize("with_file", [True, False],
                         ids=["manifest", "no_manifest"])
@pytest.mark.parametrize("case", list(GEOMETRY))
def test_resolve_kv_geometry_equals_jax(manifest_env, case, with_file):
    if with_file:
        tune_manifest.save(ENTRY, PROV)
    got = decode_engine.resolve_kv_geometry(**GEOMETRY[case])
    assert got == engine_jax.resolve_kv_geometry(**GEOMETRY[case])
    tuned = with_file and case in ("tuned_paged", "tuned_dense",
                                   "caller_chunk", "caller_block_tokens",
                                   "caller_all", "host_tier")
    assert (got["manifest"] != "default") == tuned
    if tuned:
        assert got["manifest"] == tune_manifest.entry_for(
            family="llama", slots=GEOMETRY[case]["slots"])[1]
    if case == "tuned_paged" and with_file:
        assert (got["block"], got["chunk"], got["window"],
                got["spec_k"]) == (32, 16, 32, 2)
    if case == "caller_all" and with_file:   # every knob the caller's
        assert (got["block"], got["chunk"], got["window"],
                got["spec_k"]) == (16, 32, 32, 3)


def _tiny_params():
    cfg = llama.LlamaConfig.tiny(vocab_size=128)
    return cfg, llama.init(cfg, torch.Generator().manual_seed(0), "cpu")


def test_engine_startup_loads_manifest_constants(manifest_env):
    tune_manifest.save(ENTRY, PROV)
    cfg, params = _tiny_params()
    eng = decode_engine.DecodeEngine(cfg, params, slots=2, max_seq=64,
                                     paged=True, device="cpu")
    kv = eng.kv_config()
    assert kv == engine_jax.resolve_kv_geometry(
        slots=2, max_seq=64, paged=True, family="llama")
    assert (kv["block"], kv["chunk"], kv["spec_k"]) == (32, 16, 2)
    assert kv["manifest"] != "default"
    assert eng._spec_k == 2 and eng._block == 32
    ref = decode_engine.DecodeEngine(cfg, params, slots=2, max_seq=64,
                                     paged=True, use_manifest=False,
                                     device="cpu")
    assert ref.kv_config()["manifest"] == "default"
    assert ref.kv_config() != kv


def test_decode_bench_legs_ignore_the_manifest(manifest_env, monkeypatch):
    from skypilot_tpu_torch.benchmark import decode_bench
    path = manifest_env / "tuned.json"
    tune_manifest.save(ENTRY, PROV, path=path)
    monkeypatch.setenv("STPU_TUNE_MANIFEST", str(path))
    cfg, params = _tiny_params()
    engine = decode_bench._engine(cfg, params, torch.device("cpu"),
                                  slots=2, max_seq=64, paged=True)
    try:
        kv = engine.kv_config()
    finally:
        decode_bench._close(engine)
    assert kv["manifest"] == "default"
    assert (kv["block"], kv["chunk"], kv["spec_k"]) == (64, 64, 0)


# ============================================ parity at tuned constants
FAMILIES = ["llama", "gemma", "mixtral"]


@pytest.mark.parametrize("family", FAMILIES)
def test_parity_at_tuned_constants_dense(family):
    parity.check_parity(family, block=32, chunk=16, paged=False,
                        n_requests=2, max_tokens=4, device="cpu")


@pytest.mark.parametrize("family", FAMILIES)
def test_parity_at_tuned_constants_paged(family):
    parity.check_parity(family, chunk=16, window_blocks=2, paged=True,
                        n_requests=2, max_tokens=4, device="cpu")


def test_parity_gate_catches_a_planted_divergence(monkeypatch):
    real = parity._drain
    calls = {"n": 0}

    def crooked(engine, specs):
        out = real(engine, specs)
        calls["n"] += 1
        if calls["n"] == 2:                   # corrupt the reference run
            out = [list(s) for s in out]
            out[0][0] = (out[0][0] + 1) % 100
        return out

    monkeypatch.setattr(parity, "_drain", crooked)
    with pytest.raises(parity.ParityError, match="diverged"):
        parity.check_parity("llama", block=32, n_requests=1, max_tokens=3,
                            device="cpu")


def test_parity_gate_catches_a_decode_mismatch(monkeypatch):
    """Greedy streams are also held to models.decode, not only to the
    default engine: a decode that disagrees fails the gate."""
    real = llama.decode

    def shifted(*a, **k):
        return (real(*a, **k) + 1) % 128

    monkeypatch.setattr(llama, "decode", shifted)
    with pytest.raises(parity.ParityError, match="models.decode"):
        parity.check_parity("llama", chunk=16, n_requests=1, max_tokens=3,
                            device="cpu")


# ========================================================= the sweep
def test_candidate_grids_equal_jax_and_include_defaults():
    assert tune_sweep.SEARCH_SPACE == sweep_jax.SEARCH_SPACE
    assert tune_sweep.DEFAULTS == sweep_jax.DEFAULTS
    assert tune_sweep._budgets(True) == sweep_jax._budgets(True)
    assert tune_sweep._budgets(False) == sweep_jax._budgets(False)
    for mode in tune_sweep.MODES:
        cands = tune_sweep._candidates(mode)
        assert cands == sweep_jax._candidates(mode)
        assert tune_sweep.DEFAULTS[mode] in cands
        assert len(cands) == len({tuple(sorted(c.items()))
                                  for c in cands})


def _stub_measure(calls):
    """A leg that prefers chunk 32 / window 2 and records every call."""
    def measure(mode, family, cand, budget, slots, shape_kw, device=None):
        calls.append((mode, family, dict(cand), dict(budget), device))
        score = 100.0 + (50.0 if cand.get("chunk") == 32 else 0.0) \
            + (10.0 if cand.get("window_blocks") == 2 else 0.0)
        return {sweep_jax._LEG_KEY[mode]: score, "dispatch_ms_mean": 1.0}
    return measure


def test_run_sweep_writes_a_valid_manifest(manifest_env, monkeypatch):
    calls = []
    monkeypatch.setattr(tune_sweep, "_measure", _stub_measure(calls))
    out = manifest_env / "sweep.json"
    logs = []
    doc = tune_sweep.run_sweep(families=("llama",), modes=("paged",),
                               quick=True, out_path=out, log=logs.append,
                               device="cpu")
    assert tune_manifest.validate(doc) == manifest_jax.validate(doc)
    entry = doc["payload"]["entries"]["llama|b5-16|tp1|bf16"]
    assert (entry["chunk"], entry["window_blocks"]) == (32, 2)
    assert entry["parity"] == "pass"
    objective = entry["objective"]["engine_paged_tok_s"]
    assert (objective["tok_s"], objective["default_tok_s"]) == (160.0,
                                                                100.0)
    prov = doc["payload"]["provenance"]
    assert prov["device_kind"] == "cpu" and prov["legs"] == "llama/paged"
    # Every probe, then the survivors (the default among them).
    probes = [c[2] for c in calls[:9]]
    assert probes == tune_sweep._candidates("paged")
    assert tune_sweep.DEFAULTS["paged"] in [c[2] for c in calls[9:]]
    assert {c[4] for c in calls} == {torch.device("cpu")}
    assert any("winner" in line for line in logs)
    # The JAX package reads it, and an engine at that band takes it.
    monkeypatch.setenv("STPU_TUNE_MANIFEST", str(out))
    payload, tag = manifest_jax.load(out)
    assert tag == doc["sha256"][:12]
    geo = decode_engine.resolve_kv_geometry(slots=8, max_seq=128,
                                            paged=True, family="llama")
    assert (geo["chunk"], geo["window"], geo["manifest"]) == (32, 64, tag)


def test_sweep_keeps_defaults_when_the_gate_rejects_all(manifest_env,
                                                        monkeypatch):
    monkeypatch.setattr(tune_sweep, "_measure", _stub_measure([]))

    def reject(*a, **k):
        raise parity.ParityError("planted")

    monkeypatch.setattr(tune_sweep, "check_parity", reject)
    logs = []
    assert tune_sweep.sweep_one("llama", "paged", quick=True,
                                log=logs.append, device="cpu") is None
    # Every survivor is gated: the three best and the default.
    assert sum("REJECTED" in line for line in logs) == 4
    assert "keeping defaults" in logs[-1]


def test_sweep_command_line(manifest_env, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(tune_sweep, "_measure", _stub_measure(calls))
    out = manifest_env / "cli.json"
    doc = tune_sweep.main(["--family", "llama", "--mode", "spec", "--quick",
                           "--tiny", "--slots", "2", "--device", "cpu",
                           "--out", str(out)])
    assert set(doc["payload"]["entries"]) == {"llama|b1-4|tp1|bf16"}
    assert {c[0] for c in calls} == {"spec"}
    assert f"manifest sha {doc['sha256'][:12]}" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tune_sweep.main(["--family", "gpt"])
