"""The port's gang and tensor-parallel replica (skypilot_tpu_torch/serve/
gang_replica.py, serve_llm --replica-hosts/--tp) against the JAX
package's: the topology contract (YAML block, env round trip, label,
validation errors), the env names, wire protocol, metric and event names;
each rank's local cache geometry for the three families at tp 2 (the
kv-head split, Gemma's whole single head); the gang welcome's geometry
check, which kills a member whose KV geometry, int8 flags or tuning
manifest drifted (JAX test_paged_kv.py, test_quant.py, test_tune.py);
the topology gauge; and one end-to-end session of a four-process
``serve_llm --replica-hosts 2 --tp 2 --device cpu`` gang behind the port's
load balancer: parity with the one-process engine, a follower killed
through the ``gang.host`` fault seam (503, whole-gang restart, 200 with
new member processes), a gang-wide drain and a SIGTERM that leaves no
rank behind (JAX test_sharded_replica.py, test_fault_tolerance.py)."""
import argparse
import inspect
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from skypilot_tpu.models import gemma as gemma_jax
from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.models import mixtral as mixtral_jax
from skypilot_tpu.observability import metrics as metrics_jax
from skypilot_tpu.recipes import serve_llm as serve_jax
from skypilot_tpu.serve import decode_engine as engine_jax
from skypilot_tpu.serve import gang_replica as gang_jax
from skypilot_tpu_torch.models import gemma as gemma_torch
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.models import mixtral as mixtral_torch
from skypilot_tpu_torch.observability import metrics as metrics_torch
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.recipes import serve_llm as serve_torch
from skypilot_tpu_torch.serve import decode_engine as engine_torch
from skypilot_tpu_torch.serve import gang_replica as gang_torch
from skypilot_tpu_torch.serve import load_balancer as lb_torch
from skypilot_tpu_torch.serve import load_balancing_policies as policies
from skypilot_tpu_torch.tune import manifest as tune_manifest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def no_tuning_manifest(monkeypatch):
    monkeypatch.setenv("STPU_TUNE_MANIFEST", "0")
    tune_manifest.reset_for_tests()
    yield
    tune_manifest.reset_for_tests()


# ================================================ topology and contract
@pytest.mark.parametrize("config", [
    {"hosts": 2, "ici_axes": {"tp": 2}}, {"hosts": 1},
    {"hosts": 3, "ici_axes": {"tp": 4}}, {"ici_axes": {"tp": 8}}])
def test_topology_config_env_and_label_equal_jax(config, monkeypatch):
    got = gang_torch.ReplicaTopology.from_config(config)
    want = gang_jax.ReplicaTopology.from_config(config)
    assert (got.hosts, dict(got.ici_axes), got.tp, got.is_sharded,
            got.label(), got.to_config(), got.to_env_json()) == \
        (want.hosts, dict(want.ici_axes), want.tp, want.is_sharded,
         want.label(), want.to_config(), want.to_env_json())
    assert got.processes == got.hosts * got.tp
    monkeypatch.setenv(gang_torch.TOPOLOGY_ENV, want.to_env_json())
    assert gang_torch.ReplicaTopology.from_env() == got
    assert gang_torch.ReplicaTopology.from_config(None) is None


@pytest.mark.parametrize("config", [
    {"hosts": 0}, {"hosts": 2, "ici_axes": {"tp": 0}}, "{not json"])
def test_topology_validation_errors(config, monkeypatch):
    if isinstance(config, str):
        monkeypatch.setenv(gang_torch.TOPOLOGY_ENV, config)
        for mod in (gang_torch, gang_jax):
            with pytest.raises(mod.GangError, match="JSON"):
                mod.ReplicaTopology.from_env()
        return
    for mod in (gang_torch, gang_jax):
        with pytest.raises(mod.GangError, match="must be >= 1"):
            mod.ReplicaTopology.from_config(config)


def test_resolve_topology_flags_then_env(monkeypatch):
    """serve_llm's flags win over STPU_REPLICA_TOPOLOGY, as JAX's."""
    args = argparse.Namespace(replica_hosts=2, tp=2)
    assert serve_torch._resolve_topology(args) == \
        gang_torch.ReplicaTopology(hosts=2, ici_axes={"tp": 2})
    monkeypatch.setenv(gang_torch.TOPOLOGY_ENV,
                       json.dumps({"hosts": 3, "ici_axes": {"tp": 4}}))
    args = argparse.Namespace(replica_hosts=None, tp=None)
    assert serve_torch._resolve_topology(args).label() == "3x4"
    monkeypatch.delenv(gang_torch.TOPOLOGY_ENV)
    assert not serve_torch._resolve_topology(args).is_sharded


def test_env_names_and_protocol_constants_equal_jax():
    for name in ("TOPOLOGY_ENV", "GANG_ADDR_ENV", "GANG_PORT_OFFSET",
                 "HEARTBEAT_SECONDS", "HEARTBEAT_TIMEOUT_SECONDS",
                 "MAX_GANG_RESTARTS"):
        assert getattr(gang_torch, name) == getattr(gang_jax, name), name
    # The wire ops: the port's sources speak JAX's.
    for src in (inspect.getsource(gang_torch), inspect.getsource(gang_jax)):
        for op in ('"hello"', '"hb"', '"welcome"', '"generate"',
                   '"drain"', '"restart"', '"shutdown"', '"kv"'):
            assert op in src, op
    assert '"gang.host"' in inspect.getsource(gang_torch.follower_serve)


def test_metric_and_event_names_equal_jax():
    names = ("stpu_gang_members_alive", "stpu_gang_restarts_total",
             "stpu_gang_up", "stpu_replica_topology_info")
    assert serve_jax._TOPOLOGY_INFO is not None   # registers JAX's gauge
    rendered = [m.render() for m in (metrics_torch, metrics_jax)]
    for name in names:
        helps = [[line for line in text.splitlines()
                  if line.startswith(f"# HELP {name} ")]
                 for text in rendered]
        assert helps[0] and helps[0] == helps[1], name
    for mod in (gang_torch, gang_jax):
        src = inspect.getsource(mod)
        assert src.count('events.emit("gang_replica"') >= 6


def test_topology_gauge_in_replica_metrics():
    """A replica served with a 2x4 topology exports the JAX gauge line."""
    cfg = llama_torch.LlamaConfig.tiny(vocab_size=128)
    params = llama_torch.init(cfg, torch.Generator().manual_seed(0), "cpu")
    httpd = serve_torch.serve(
        cfg, params, 0, engine_slots=0, device="cpu",
        topology=gang_torch.ReplicaTopology(hosts=2, ici_axes={"tp": 4}))
    try:
        assert 'stpu_replica_topology_info{hosts="2",tp="4"} 1' in \
            metrics_torch.render()
    finally:
        httpd.server_close()


# ============================================= local cache geometry
def _families():
    return [("llama", llama_jax, llama_torch.LlamaConfig.tiny()),
            ("mixtral", mixtral_jax, mixtral_torch.MixtralConfig.tiny()),
            ("gemma", gemma_jax, gemma_torch.GemmaConfig.tiny())]


@pytest.mark.parametrize("family", ["llama", "mixtral", "gemma"])
def test_cache_geometry_at_tp2(family):
    """A rank's cache at tp 2: half the kv heads where tp divides them
    (llama tiny 4 -> 2, mixtral tiny 2 -> 1), the whole single head of
    Gemma's MQA on every rank (JAX splits head_dim there); the logical
    specs are JAX's cache_specs."""
    _, mdl_jax, cfg = dict((f, (f, m, c)) for f, m, c in _families())[
        family]
    api = {"llama": llama_torch, "mixtral": mixtral_torch,
           "gemma": gemma_torch}[family]
    assert api.cache_specs(cfg) == mdl_jax.cache_specs(cfg)
    assert api.paged_cache_specs(cfg) == mdl_jax.paged_cache_specs(cfg)
    geo = gang_torch.cache_shardings(cfg, {"tp": 2}, mesh_lib.DEFAULT_RULES)
    assert set(geo) == {"k", "v", "k_scale", "v_scale"}
    want_kv = {"llama": 2, "mixtral": 1, "gemma": 1}[family]
    want_split = "whole_head" if family == "gemma" else "kv_heads"
    for leaf in geo.values():
        assert (leaf["kv_heads"], leaf["split"]) == (want_kv, want_split)
    assert geo["k"]["spec"] == mdl_jax.cache_specs(cfg)["k"]
    one = gang_torch.cache_shardings(cfg, None, mesh_lib.DEFAULT_RULES)
    assert (one["k"]["kv_heads"], one["k"]["split"]) == (cfg.n_kv_heads,
                                                         None)
    cache = api.init_paged_cache(cfg, 3, 8, device="cpu",
                                 kv_heads=want_kv, quantized=True)
    assert cache["k"].shape[3] == want_kv and \
        cache["k_scale"].shape[2] == want_kv
    with pytest.raises(gang_torch.GangError, match="neither"):
        gang_torch.local_kv_heads(
            llama_torch.LlamaConfig.tiny(), 3)


@pytest.mark.parametrize("quantized", [False, True])
def test_mixtral_param_specs_equal_jax(quantized):
    """The port's Mixtral specs are JAX's without the stacked layer axis
    (int8 scales: the weight's axes minus its in-features axis)."""
    cfg = mixtral_torch.MixtralConfig.tiny()
    got = mixtral_torch.param_specs(cfg, quantized=quantized)
    want = mixtral_jax.param_specs(mixtral_jax.MixtralConfig.tiny(),
                                   quantized=quantized)
    assert {k: v for k, v in got.items() if k != "layers"} == \
        {k: v for k, v in want.items() if k != "layers"}
    assert got["layers"] == {k: v[1:] for k, v in want["layers"].items()}


def test_kv_config_carries_tp():
    """The tp degree keys the manifest lookup and rides the geometry
    dict above 1 (the welcome compares it); at tp 1 the dict is JAX's."""
    kw = dict(slots=2, max_seq=64, paged=True, family="llama")
    one = engine_torch.resolve_kv_geometry(**kw)
    assert one == engine_jax.resolve_kv_geometry(**kw) and "tp" not in one
    two = engine_torch.resolve_kv_geometry(tp=2, **kw)
    assert two == {**engine_jax.resolve_kv_geometry(tp=2, **kw), "tp": 2}


# ===================================================== the welcome
class _StubEngine:
    def start(self):
        return self

    def shutdown(self):
        pass

    def work(self):
        raise AssertionError("a mismatched member never serves")


def _geometry(case):
    base = dict(slots=4, max_seq=64, prefill_chunk=8, paged=True,
                family="llama")
    if case == "paged":
        return (engine_torch.resolve_kv_geometry(**base),
                engine_torch.resolve_kv_geometry(**{**base, "slots": 8}))
    if case == "int8":
        quant = dict(kv_quant=True, weight_quant=True)
        return (engine_torch.resolve_kv_geometry(**base, **quant),
                engine_torch.resolve_kv_geometry(**base))
    if case == "tp":
        return (engine_torch.resolve_kv_geometry(**base, tp=2),
                engine_torch.resolve_kv_geometry(**base))
    # A tuning manifest the leader resolved and the member did not.
    tune_manifest.save(
        {"llama|b1-4|tp1|bf16": {"block": 32, "chunk": 16,
                                 "parity": "pass"}},
        {"device_kind": "cpu", "commit": "abc1234",
         "created": "2026-08-06T00:00:00+0000"},
        path=pathlib.Path(os.environ["STPU_TUNE_MANIFEST"]))
    tune_manifest.reset_for_tests()
    leader = engine_torch.resolve_kv_geometry(**base)
    assert leader["manifest"] != "default"
    os.environ["STPU_TUNE_MANIFEST"] = "0"
    tune_manifest.reset_for_tests()
    return leader, engine_torch.resolve_kv_geometry(**base)


@pytest.mark.parametrize("member", ["follower", "tp"])
@pytest.mark.parametrize("case", ["paged", "int8", "manifest", "tp"])
def test_member_with_drifted_geometry_dies_at_join(case, member, tmp_path,
                                                   monkeypatch):
    """The leader stamps its effective geometry into every welcome, and a
    member whose own differs (pool size, int8 flags, a tuning manifest,
    the tp degree) returns 1 at join instead of serving out of
    lockstep."""
    monkeypatch.setenv("STPU_TUNE_MANIFEST", str(tmp_path / "m.json"))
    leader_kv, member_kv = _geometry(case)
    assert leader_kv != member_kv
    topo = gang_torch.ReplicaTopology(hosts=2, ici_axes={"tp": 2})
    leader = gang_torch.GangLeader(topo, port=0, kv_config=leader_kv)
    try:
        sock = socket.create_connection(("127.0.0.1", leader.port),
                                        timeout=5.0)
        wf, rf = sock.makefile("wb"), sock.makefile("rb")
        gang_torch._send_line(wf, {"op": "hello", "rank": 3, "pid": 1})
        assert json.loads(rf.readline())["kv"] == leader_kv
        sock.close()
        serve_fn = (gang_torch.follower_serve if member == "follower"
                    else gang_torch.tp_worker_serve)
        rc_box = []
        thread = threading.Thread(target=lambda: rc_box.append(serve_fn(
            _StubEngine, topo, f"127.0.0.1:{leader.port}",
            2 if member == "follower" else 1, kv_config=member_kv)),
            daemon=True)
        thread.start()
        thread.join(timeout=30.0)
        assert rc_box == [1]
    finally:
        leader.shutdown()


# ====================================== end to end: a 2 x 2 CPU gang
def _get_code(url, timeout=5):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code
    except (urllib.error.URLError, ConnectionError, OSError):
        return None


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wait_code(url, want, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _get_code(url) == want:
            return True
        time.sleep(0.1)
    return False


def _gang(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/gang",
                                timeout=10) as resp:
        return json.loads(resp.read())


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


ARGS = ["--model", "llama-tiny", "--dtype", "float32", "--device", "cpu",
        "--engine-slots", "2", "--seed", "0"]
GREEDY = {"prompt": [1, 2, 3, 4], "max_tokens": 8}
SAMPLED = {"prompt": [9, 8, 7], "max_tokens": 8, "temperature": 0.7,
           "seed": 42}


def test_gang_e2e_parity_failover_drain_and_no_orphans():
    """serve_llm --replica-hosts 2 --tp 2 --device cpu (four processes)
    behind the port's balancer: the one-process engine's greedy and
    seeded tokens; the follower killed by the gang.host seam at its first
    mirrored admission flips /health to 503, the whole gang restarts
    (stpu_gang_restarts_total, new member pids) and the next request
    returns the same tokens; a drain refuses new work gang-wide, and
    SIGTERM ends every rank (rc 143, no member left)."""
    cfg, params = serve_torch._build_model(
        serve_torch._parser().parse_args(ARGS), torch.device("cpu"))
    ref = engine_torch.DecodeEngine(
        cfg, params, slots=2, max_seq=serve_torch.MAX_PROMPT_TOKENS +
        serve_torch.MAX_GEN_TOKENS, paged=True, device="cpu").start()
    try:
        want = [ref.submit(b["prompt"], max_tokens=b["max_tokens"],
                           temperature=b.get("temperature", 0.0),
                           seed=b.get("seed", 0)).result(timeout=120)
                for b in (GREEDY, SAMPLED)]
    finally:
        ref.shutdown()
    port = _free_port()
    env = {**os.environ, "STPU_FAULTS": "gang.host:kill:times=1",
           "STPU_GANG_HB_TIMEOUT": "3", "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "skypilot_tpu_torch.recipes.serve_llm",
         *ARGS, "--port", str(port), "--replica-hosts", "2", "--tp", "2"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True)
    policy = policies.RoundRobinPolicy()
    policy.set_ready_replicas([f"http://127.0.0.1:{port}"])
    lb = lb_torch.run_load_balancer(_free_port(), policy,
                                    lb_torch.RequestRecorder())
    base = f"http://127.0.0.1:{lb.server_address[1]}"
    health = f"http://127.0.0.1:{port}/health"
    pids = []
    try:
        assert _wait_code(health, 200), "the gang never became healthy"
        gang = _gang(port)
        assert gang["label"] == "2x2"
        roles = sorted(m["role"] for m in gang["members"])
        assert roles == ["follower", "leader", "tp", "tp"]
        before = {m["rank"]: m["pid"] for m in gang["members"]}
        # The broadcast of this admission kills the follower; host 0's
        # group still answers it.
        assert _post(base + "/generate", GREEDY) == (200,
                                                     {"tokens": want[0]})
        assert _wait_code(health, 503, timeout=30), "/health never 503"
        assert _wait_code(health, 200), "the gang never restarted"
        gang = _gang(port)
        after = {m["rank"]: m["pid"] for m in gang["members"]}
        assert gang["restarts"] >= 1
        assert all(after[r] != before[r] for r in (1, 2, 3)), (before,
                                                               after)
        assert not any(_alive(before[r]) for r in (1, 2, 3))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            assert "stpu_gang_restarts_total 1" in resp.read().decode()
        assert _post(base + "/generate", SAMPLED) == (200,
                                                      {"tokens": want[1]})
        # That admission killed the new follower too: once the gang is
        # back, drain it and end it.
        assert _wait_code(health, 503, timeout=30)
        assert _wait_code(health, 200), "the second restart never ended"
        pids = [m["pid"] for m in _gang(port)["members"]]
        status, doc = _post(f"http://127.0.0.1:{port}/drain", {})
        assert status == 200 and doc["draining"] is True
        assert _post(f"http://127.0.0.1:{port}/generate", GREEDY)[0] == 503
        os.kill(proc.pid, signal.SIGTERM)
        assert proc.wait(timeout=30) == 143
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and any(map(_alive, pids[1:])):
            time.sleep(0.1)
        assert not [p for p in pids[1:] if _alive(p)], "orphaned ranks"
    finally:
        lb.shutdown()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        for pid in pids[1:]:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
