"""The port's serving measurements (skypilot_tpu_torch.benchmark.decode_bench)
against the JAX package's: ``build`` gives the JAX bench's configs field
for field for all three families (the bench shapes and the tiny ones), and
each ported mode runs on the CPU at the tiny configs and returns exactly
the key set of the JAX function's result dict, read from the JAX module's
source (its ``return {...}``), so no JAX bench runs here. The speculative
mode's identity check fires when the two runs' streams part."""
import ast
import dataclasses
import inspect
import json
import pathlib

import pytest

from skypilot_tpu.benchmark import decode_bench as bench_jax
from skypilot_tpu_torch.benchmark import decode_bench as bench_torch
from skypilot_tpu_torch.serve import decode_engine as engine_torch


@pytest.fixture(scope="module", autouse=True)
def no_tuning_manifest():
    """Every engine here runs the default constants: no ambient tuning
    manifest (STPU_TUNE_MANIFEST=0), set before the module's engines."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STPU_TUNE_MANIFEST", "0")
        yield


FAMILIES = ("llama", "mixtral", "gemma")


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}


@pytest.mark.parametrize("tiny", [False, True], ids=["bench", "tiny"])
@pytest.mark.parametrize("family", FAMILIES)
def test_build_matches_jax_configs(family, tiny):
    """Every field of the JAX config equal in the port's (the dtype aside:
    jnp's and torch's bfloat16); the port's only field JAX lacks is the
    dense families' remat_policy."""
    _, cfg_j = bench_jax.build(family, tiny=tiny)
    mdl, cfg_t = bench_torch.build(family, tiny=tiny)
    assert mdl.__name__ == f"skypilot_tpu_torch.models.{family}"
    assert str(cfg_t.dtype).endswith("bfloat16")
    want, got = _fields(cfg_j), _fields(cfg_t)
    assert {k: got.get(k) for k in want} == want
    assert set(got) - set(want) <= {"remat_policy"}


def test_build_takes_mixtral_shapes():
    _, cfg_j = bench_jax.build("mixtral", dim=512, layers=2, experts=4)
    _, cfg_t = bench_torch.build("mixtral", dim=512, layers=2, experts=4)
    assert _fields(cfg_t) == _fields(cfg_j)
    with pytest.raises(ValueError, match="unknown family"):
        bench_torch.build("gpt")


def _jax_keys(name: str) -> set:
    """The string keys of the dict the JAX function returns last."""
    src = pathlib.Path(inspect.getsourcefile(bench_jax)).read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)
           and isinstance(n.value, ast.Dict)][-1]
    return {k.value for k in ret.value.keys}


TINY = dict(tiny=True, device="cpu")
MODES = {
    "measure_decode": dict(batch=2, prompt_len=16, tokens=8, repeats=1),
    "measure_engine_ragged": dict(slots=4, n_requests=6, max_prompt=40,
                                  max_tokens=12),
    "measure_engine_paged": dict(slots=4, n_requests=6, max_prompt=40,
                                 max_tokens=12),
    "measure_engine_q8": dict(slots=4, n_requests=6, max_prompt=40,
                              max_tokens=12),
    "measure_engine_spec": dict(slots=4, n_requests=8, shared_prefix=32,
                                max_unique=16, max_tokens=64),
    "measure_engine_prefix": dict(slots=4, n_requests=4, shared_prefix=128,
                                  max_unique=8, max_tokens=16),
    "measure_engine_tier": dict(slots=2, n_requests=4, max_tokens=4,
                                host_cache_mb=8.0),
    "measure_ckpt": dict(repeats=1),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_returns_the_jax_keys(mode):
    out = getattr(bench_torch, mode)("mixtral", **MODES[mode], **TINY)
    assert set(out) == _jax_keys(mode)
    assert set(out["model"]) == {"family", "dim", "layers", "experts",
                                 "mlp_dim", "params"}
    assert out["model"]["experts"] == 4


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_decode_and_paged_run_every_family(family):
    out = bench_torch.measure_decode(family, **MODES["measure_decode"],
                                     **TINY)
    assert out["tokens_per_sec"] > 0 and out["model"]["experts"] == 0
    out = bench_torch.measure_engine_paged(
        family, **MODES["measure_engine_paged"], **TINY)
    assert out["generated_tokens"] > 0
    assert 0 < out["kv_pool_utilization"] <= 1


def test_spec_mode_asserts_identical_streams(monkeypatch):
    """Accepting every draft (a broken verifier) parts the speculative
    streams from the baseline's, and the mode raises; the sound run
    drafts and returns."""
    out = bench_torch.measure_engine_spec(
        "mixtral", **MODES["measure_engine_spec"], **TINY)
    assert out["drafted_tokens"] > 0
    monkeypatch.setattr(engine_torch, "_accept_counts",
                        lambda toks, targets, spec_len: spec_len)
    with pytest.raises(AssertionError, match="bit-identity"):
        bench_torch.measure_engine_spec(
            "mixtral", **MODES["measure_engine_spec"], **TINY)


def test_q8_capacity_ratio_and_cli(capsys, monkeypatch):
    out = bench_torch.measure_engine_q8("mixtral",
                                        **MODES["measure_engine_q8"], **TINY)
    assert out["kv_capacity_ratio"] >= 1.8
    assert (out["kv_pool_capacity_blocks"] >
            out["kv_pool_capacity_blocks_bf16"])
    build = bench_torch.build
    monkeypatch.setattr(bench_torch, "build",
                        lambda family, **kw: build(family, tiny=True))
    bench_torch.main(["--family", "gemma", "--mode", "ckpt", "--repeats",
                      "1", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(json.loads(line)) == _jax_keys("measure_ckpt")
    with pytest.raises(SystemExit):
        bench_torch.main(["--family", "llama", "--dim", "512"])
