"""The port's replica (skypilot_tpu_torch.recipes.serve_llm) in-process on
the CPU beside the JAX package's replica on converted weights: SSE
``data:`` frames byte-equal for a greedy and a seeded request (and the
non-streamed JSON), the trailing stats frame with the same keys, a
``resume`` giving the uninterrupted continuation, /health, /drain,
/metrics and the 400s on bad bodies; the port's replica behind the JAX
package's load balancer; the same bytes from a Gemma replica pair (its
tiny config); the --model choices built through their family's init; a
mixtral-tiny replica on the CPU; ``--lb-port``/``--lb-policy`` parsed and
refused as JAX's, and main fronting its replica with the port's balancer;
and the sharded configurations a replica cannot serve refusing before any
rank starts."""
import dataclasses
import http.client
import json
import socket
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import gemma as gemma_jax
from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.observability import reqlog as reqlog_jax
from skypilot_tpu.recipes import serve_llm as serve_jax
from skypilot_tpu.serve import load_balancer as lb_lib
from skypilot_tpu.serve.load_balancing_policies import RoundRobinPolicy
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import gemma as gemma_torch
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.models import mixtral as mixtral_torch
from skypilot_tpu_torch.models import family_name
from skypilot_tpu_torch.observability import reqlog as reqlog_torch
from skypilot_tpu_torch.recipes import serve_llm as serve_torch


@pytest.fixture(scope="module", autouse=True)
def no_tuning_manifest():
    """Every engine here runs the default constants: no ambient tuning
    manifest (STPU_TUNE_MANIFEST=0), set before the module's engines."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STPU_TUNE_MANIFEST", "0")
        yield


VOCAB = 128


def _start(module, cfg, params, **kw):
    ready = threading.Event()
    httpd = module.serve(cfg, params, 0, ready_event=ready, engine_slots=2,
                         **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    assert ready.wait(timeout=120)
    return httpd


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()
    httpd.engine.shutdown()


def _replica_pair(jax_mod, torch_mod, from_jax):
    """(JAX replica, port replica) on the same tiny f32 weights of one
    family, 2 layers."""
    cfg_j = dataclasses.replace(jax_mod.tiny(VOCAB), n_layers=2,
                                dtype=jnp.float32)
    cfg_t = dataclasses.replace(torch_mod.tiny(VOCAB), n_layers=2,
                                dtype=torch.float32)
    params_j = {llama_jax.LlamaConfig: llama_jax,
                gemma_jax.GemmaConfig: gemma_jax}[jax_mod].init(
                    cfg_j, jax.random.key(0))
    params_t = from_jax(cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return (_start(serve_jax, cfg_j, params_j),
            _start(serve_torch, cfg_t, params_t, device="cpu"))


@pytest.fixture(scope="module")
def replicas():
    pair = _replica_pair(llama_jax.LlamaConfig, llama_torch.LlamaConfig,
                         convert.llama_params_from_jax)
    yield pair
    for httpd in pair:
        _stop(httpd)


@pytest.fixture(scope="module")
def gemma_replicas():
    pair = _replica_pair(gemma_jax.GemmaConfig, gemma_torch.GemmaConfig,
                         convert.gemma_params_from_jax)
    yield pair
    for httpd in pair:
        _stop(httpd)


def _call(httpd, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                      timeout=120)
    conn.request(method, path, body=None if body is None else
                 json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _frames(data: bytes):
    return [ln for ln in data.decode().split("\n\n") if ln]


GREEDY = {"prompt": [1, 2, 3, 4, 5], "max_tokens": 8, "stream": True}
SEEDED = {"prompt": [7, 8, 9], "max_tokens": 8, "temperature": 0.8,
          "seed": 5, "stream": True}


@pytest.mark.parametrize("body", [GREEDY, SEEDED,
                                  dict(SEEDED, stream=False)],
                         ids=["greedy-sse", "seeded-sse", "seeded-json"])
def test_generate_bytes_equal_jax(replicas, body):
    jax_r, port_r = replicas
    want = _call(jax_r, "POST", "/generate", body)
    got = _call(port_r, "POST", "/generate", body)
    assert got == want
    assert got[0] == 200
    if body["stream"]:
        assert _frames(got[1])[-1] == "data: [DONE]"
        assert len(_frames(got[1])) == body["max_tokens"] + 1


@pytest.mark.parametrize("body", [GREEDY, SEEDED,
                                  dict(SEEDED, stream=False)],
                         ids=["greedy-sse", "seeded-sse", "seeded-json"])
def test_gemma_generate_bytes_equal_jax(gemma_replicas, body):
    # --model gemma-tiny's replica: the same bytes as JAX's on the same
    # weights (its serving embed scaled by sqrt(dim) as JAX's is).
    test_generate_bytes_equal_jax(gemma_replicas, body)


@pytest.mark.parametrize("model,family", [("gemma-tiny", "gemma"),
                                          ("llama-tiny", "llama")])
def test_build_model_inits_through_the_family(model, family):
    args = types.SimpleNamespace(model=model, dtype="float32", seed=0,
                                 weight_quant=None)
    cfg, params = serve_torch._build_model(args, torch.device("cpu"))
    assert family_name(cfg) == family and cfg.dtype == torch.float32
    norm = float(params.final_norm.detach().abs().sum())
    # gemma's (1 + w) norms start at zero, llama's at one.
    assert norm == (0.0 if family == "gemma" else cfg.dim)
    assert (params.lm_head is None) == cfg.tie_embeddings


def test_stats_frame_keys_equal_jax(replicas, monkeypatch):
    """With the request log armed, both replicas end a stream with an
    ``event: stats`` frame before [DONE]; its keys are the same."""
    monkeypatch.setattr(reqlog_jax, "ENABLED", True)
    monkeypatch.setattr(reqlog_torch, "ENABLED", True)
    frames = []
    for httpd in replicas:
        status, data = _call(httpd, "POST", "/generate", GREEDY)
        assert status == 200
        got = _frames(data)
        assert got[-1] == "data: [DONE]"
        assert got[-2].startswith("event: stats\ndata: ")
        frames.append(got)
    keys = [set(json.loads(f[-2].split("data: ", 1)[1])) for f in frames]
    assert keys[0] == keys[1]
    assert frames[0][:-2] == frames[1][:-2]


def test_resume_gives_the_uninterrupted_continuation(replicas):
    """A seeded stream cut after 3 tokens and resumed with them emits
    exactly the uninterrupted stream's remaining tokens, as JAX's does."""
    jax_r, port_r = replicas
    _, full = _call(port_r, "POST", "/generate", SEEDED)
    tokens = [json.loads(f[len("data: "):])["token"]
              for f in _frames(full)[:-1]]
    body = dict(SEEDED, resume={"emitted": tokens[:3], "pos": 3})
    status, data = _call(port_r, "POST", "/generate", body)
    assert status == 200
    rest = [json.loads(f[len("data: "):])["token"]
            for f in _frames(data)[:-1]]
    assert rest == tokens[3:]
    assert _call(jax_r, "POST", "/generate", body) == (status, data)


@pytest.mark.parametrize("body", [
    {"prompt": []}, {"bad": 1}, {"prompt": [1] * 1025},
    {"prompt": [1, 2], "resume": {"emitted": [], "pos": 0}},
    {"prompt": [1, 2], "max_tokens": 4, "resume": {"emitted": [3],
                                                   "pos": 2}},
    {"prompt": [1, 2], "max_tokens": 2, "resume": {"emitted": [3, 4],
                                                   "pos": 2}},
], ids=["empty", "no-prompt", "too-long", "empty-resume", "bad-pos",
        "resume-covers"])
def test_bad_bodies_400_as_jax(replicas, body):
    jax_r, port_r = replicas
    want = _call(jax_r, "POST", "/generate", body)
    assert want[0] == 400
    assert _call(port_r, "POST", "/generate", body) == want


def test_health_drain_perf_and_metrics_as_jax(replicas):
    jax_r, port_r = replicas
    for path in ("/health", "/drain", "/gang", "/nope"):
        assert _call(port_r, "GET", path) == _call(jax_r, "GET", path), path
    perf = [json.loads(_call(h, "GET", "/perf")[1]) for h in replicas]
    assert set(perf[0]) == set(perf[1])
    for key in ("engine", "quant", "tuning", "tier"):
        assert set(perf[0][key]) == set(perf[1][key]), key
    assert perf[1]["tuning"]["manifest"] == "default"
    status, text = _call(port_r, "GET", "/metrics")
    assert status == 200
    for name in ("stpu_engine_slots_total", "stpu_engine_up",
                 "stpu_engine_decode_tokens_total",
                 "stpu_replica_topology_info"):
        assert name.encode() in text


def _read_chunks(httpd_port, body):
    conn = http.client.HTTPConnection("127.0.0.1", httpd_port, timeout=60)
    conn.request("POST", "/generate", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    chunks = []
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        chunks.append(chunk)
    conn.close()
    return resp.status, chunks


def test_port_replica_behind_the_jax_load_balancer(replicas):
    """The JAX package's LB fronts the port's replica unchanged: the SSE
    stream arrives in more than one chunk, ends in [DONE], and carries
    the replica's own tokens."""
    _, port_r = replicas
    policy = RoundRobinPolicy()
    policy.set_ready_replicas(
        [f"http://127.0.0.1:{port_r.server_address[1]}"])
    lb = lb_lib.run_load_balancer(0, policy, lb_lib.RequestRecorder())
    try:
        status, chunks = _read_chunks(lb.server_address[1], GREEDY)
        assert status == 200
        assert len(chunks) > 1, "SSE stream arrived as one blob"
        text = b"".join(chunks).decode()
        events = [ln[len("data: "):] for ln in text.splitlines()
                  if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        direct = _frames(_call(port_r, "POST", "/generate", GREEDY)[1])
        assert [f"data: {e}" for e in events] == direct
    finally:
        lb.shutdown()


def test_post_drain_refuses_new_work_as_jax():
    """POST /drain on a fresh pair: the same payload, then 503s."""
    cfg_j = dataclasses.replace(llama_jax.LlamaConfig.tiny(VOCAB),
                                n_layers=1, dtype=jnp.float32)
    cfg_t = dataclasses.replace(llama_torch.LlamaConfig.tiny(VOCAB),
                                n_layers=1, dtype=torch.float32)
    params_j = llama_jax.init(cfg_j, jax.random.key(1))
    params_t = convert.llama_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    pair = (_start(serve_jax, cfg_j, params_j),
            _start(serve_torch, cfg_t, params_t, device="cpu"))
    try:
        got = [_call(h, "POST", "/drain") for h in pair]
        assert got[0] == got[1]
        assert json.loads(got[1][1]) == {"draining": True, "in_flight": 0}
        gen = [_call(h, "POST", "/generate", GREEDY) for h in pair]
        assert gen[0] == gen[1] and gen[1][0] == 503
    finally:
        for httpd in pair:
            _stop(httpd)


def test_legacy_locked_path_streams_jax_tokens():
    """engine_slots=0 serves through the locked fixed-batch path: its
    greedy and seeded SSE streams and JSON bodies equal JAX's."""
    cfg_j = dataclasses.replace(llama_jax.LlamaConfig.tiny(VOCAB),
                                n_layers=1, dtype=jnp.float32)
    cfg_t = dataclasses.replace(llama_torch.LlamaConfig.tiny(VOCAB),
                                n_layers=1, dtype=torch.float32)
    params_j = llama_jax.init(cfg_j, jax.random.key(2))
    params_t = convert.llama_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    pair = []
    for module, cfg, params, kw in (
            (serve_jax, cfg_j, params_j, {}),
            (serve_torch, cfg_t, params_t, {"device": "cpu"})):
        ready = threading.Event()
        httpd = module.serve(cfg, params, 0, ready_event=ready,
                             engine_slots=0, **kw)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        assert ready.wait(timeout=120)
        pair.append(httpd)
    try:
        for body in (GREEDY, SEEDED, dict(SEEDED, stream=False)):
            want = _call(pair[0], "POST", "/generate", body)
            assert _call(pair[1], "POST", "/generate", body) == want
            assert want[0] == 200
    finally:
        for httpd in pair:
            httpd.shutdown()
            httpd.server_close()


@pytest.mark.parametrize("argv,match", [
    (["--lb-port", "9", "--tp", "2", "--engine-slots", "0"],
     "decode engine"),
    (["--replica-hosts", "2", "--tp", "3"], "n_heads=8 not divisible"),
    (["--tp", "2", "--tp-backend", "nccl"], "NCCL"),
], ids=["lb-port", "replica-hosts", "tp"])
def test_main_refuses_what_is_not_ported(argv, match):
    """What a gang or tensor-parallel replica cannot serve raises before
    any rank is spawned: tp over the legacy locked path (with a
    co-located load balancer asked for too), a tp that does not divide
    the model's heads, NCCL on the CPU. The replicas themselves serve
    (tests/test_torch_gang_replica.py)."""
    with pytest.raises(ValueError, match=match):
        serve_torch.main(argv + ["--device", "cpu", "--port", "0"])


@pytest.mark.parametrize("argv", [
    ["--lb-port", "9"], ["--lb-port", "9", "--lb-policy", "round_robin"],
    ["--lb-port", "9", "--lb-policy", "prefix_affinity"]])
def test_lb_flags_parse_as_jax(argv):
    args = serve_torch._parser().parse_args(argv)
    assert (args.lb_port, args.lb_policy) == (
        9, argv[-1] if "--lb-policy" in argv else None)


@pytest.mark.parametrize("argv", [["--lb-policy", "round_robin"],
                                  ["--lb-port", "9", "--lb-policy", "x"]],
                         ids=["policy-without-port", "unknown-policy"])
def test_lb_flag_errors_equal_jax(argv, capsys):
    """--lb-policy without --lb-port, and an unknown policy, exit 2 with
    JAX's parser error."""
    errors = []
    for module in (serve_jax, serve_torch):
        with pytest.raises(SystemExit) as e:
            module.main(argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1]
    assert "--lb-policy" in errors[1]


def test_main_fronts_the_replica_with_its_balancer(monkeypatch, capsys):
    """``--lb-port N --lb-policy prefix_affinity``: main starts the port's
    balancer on N in front of the replica, prints JAX's line, and a
    request through it gets the replica's own bytes."""
    from skypilot_tpu_torch.serve import load_balancer as lb_torch
    served, lbs = [], []
    real_serve, real_lb = serve_torch.serve, lb_torch.run_load_balancer

    def spy(cfg, params, port, **kw):
        ready = threading.Event()
        served.append((ready, real_serve(cfg, params, port,
                                         ready_event=ready, **kw)))
        return served[-1][-1]

    def lb_spy(*a, **kw):
        lbs.append(real_lb(*a, **kw))
        return lbs[-1]

    monkeypatch.setattr(serve_torch, "serve", spy)
    monkeypatch.setattr(lb_torch, "run_load_balancer", lb_spy)
    monkeypatch.setattr(serve_torch.signal, "signal", lambda *a: None)
    port, lb_port = _free_port(), _free_port()
    main = threading.Thread(target=serve_torch.main, daemon=True, args=(
        ["--device", "cpu", "--port", str(port), "--engine-slots", "2",
         "--lb-port", str(lb_port), "--lb-policy", "prefix_affinity"],))
    main.start()
    try:
        for _ in range(1200):
            if lbs or not main.is_alive():
                break
            time.sleep(0.1)
        ready, httpd = served[0]
        assert ready.wait(timeout=120)
        assert type(lbs[0].RequestHandlerClass.policy).__name__ == \
            "PrefixAffinityPolicy"
        body = dict(GREEDY, max_tokens=4)
        via = _call(lbs[0], "POST", "/generate", body)
        assert via == _call(httpd, "POST", "/generate", body)
        assert via[0] == 200
    finally:
        for lb in lbs:
            lb.shutdown()
            lb.server_close()
        if served:
            _stop(served[0][1])
    main.join(timeout=60)
    assert not main.is_alive()
    assert f"serve_llm: LB (prefix_affinity) on :{lb_port}" in \
        capsys.readouterr().out


@pytest.mark.parametrize("weight_quant", ["0", "1"])
def test_main_serves_mixtral_on_the_cpu(monkeypatch, weight_quant):
    """``--model mixtral-tiny --device cpu``: main builds the tree through
    _build_model (under --weight-quant 1 drawn int8 a layer at a time,
    the engine serving it as it is) and its replica answers /generate."""
    served = []
    real_serve = serve_torch.serve

    def spy(cfg, params, port, **kw):
        ready = threading.Event()
        served.append((cfg, params, ready,
                       real_serve(cfg, params, port, ready_event=ready,
                                  **kw)))
        return served[-1][-1]
    monkeypatch.setattr(serve_torch, "serve", spy)
    monkeypatch.setattr(serve_torch.signal, "signal", lambda *a: None)
    main = threading.Thread(target=serve_torch.main, daemon=True, args=(
        ["--model", "mixtral-tiny", "--device", "cpu", "--port", "0",
         "--engine-slots", "2", "--weight-quant", weight_quant],))
    main.start()
    for _ in range(1200):
        if served or not main.is_alive():
            break
        time.sleep(0.1)
    cfg, params, ready, httpd = served[0]
    try:
        assert ready.wait(timeout=120)
        status, data = _call(httpd, "POST", "/generate",
                             {"prompt": [1, 2, 3], "max_tokens": 4})
    finally:
        _stop(httpd)
    main.join(timeout=60)
    assert not main.is_alive()
    assert family_name(cfg) == "mixtral"
    assert mixtral_torch.params_quantized(params) == (weight_quant == "1")
    assert httpd.engine.kv_config()["weight_quant"] == int(weight_quant)
    assert status == 200
    toks = json.loads(data)["tokens"]
    assert [0 <= t < cfg.vocab_size for t in toks] == [True] * 4


@pytest.mark.parametrize("model,weight_quant,free,match", [
    ("mixtral-8x7b", None, 80e9, "93.4 GB in torch.bfloat16.*--weight-quant 1"),
    ("mixtral-8x7b", 1, 40e9, "46.7 GB in int8"),
    ("llama3-8b", 1, 10e9, "16.1 GB in torch.bfloat16, more than the 10.0 GB"),
])
def test_build_model_refuses_a_tree_the_card_cannot_hold(
        monkeypatch, model, weight_quant, free, match):
    """A --model tree larger than the card's free memory raises before
    anything is drawn; mixtral in bf16 names --weight-quant 1."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (int(free), int(80e9)))
    args = types.SimpleNamespace(model=model, dtype=None, seed=0,
                                 weight_quant=weight_quant)
    with pytest.raises(ValueError, match=match):
        serve_torch._build_model(args, torch.device("cuda"))


def test_serve_refuses_mixtral_and_needs_a_card(monkeypatch):
    """A mixtral-tiny replica, once refused, serves on the CPU when asked
    (its tokens through the engine); without a card every model raises."""
    cfg = mixtral_torch.MixtralConfig.tiny(VOCAB)
    params = mixtral_torch.init(cfg, torch.Generator().manual_seed(0), "cpu")
    httpd = _start(serve_torch, cfg, params, device="cpu")
    try:
        status, data = _call(httpd, "POST", "/generate",
                             {"prompt": [1, 2, 3], "max_tokens": 4})
    finally:
        _stop(httpd)
    assert status == 200
    assert [0 <= t < VOCAB for t in json.loads(data)["tokens"]] == [True] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_torch.main(["--model", "mixtral-tiny", "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_torch.main(["--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_torch.serve(llama_torch.LlamaConfig.tiny(), None, 0)
