"""The port's load generator (skypilot_tpu_torch.benchmark.loadgen), its
exposition parser (observability/promtext.py) and decode_bench's SLO and
chaos legs against the JAX package's: promtext's parse, render, values and
quantiles on the same documents; schedules, digests and schedule files
equal for every mix and arrival (each package's ``load_schedule`` reading
the other's file); ``derive_spec`` on the same records; both generators'
reports with the same keys through the port's load balancer; the
balancer's in-flight slots returned on every exit path under a burst,
and one dominant prefix spilling off its ring owner; and
``measure_engine_slo`` / ``measure_engine_chaos`` end to end on the CPU at
a tiny Llama, returning the JAX functions' keys."""
import ast
import dataclasses
import http.server
import inspect
import itertools
import json
import math
import pathlib
import socket
import socketserver
import threading
import time
import urllib.error
import urllib.request

import pytest

from skypilot_tpu.benchmark import decode_bench as bench_jax
from skypilot_tpu.benchmark import loadgen as loadgen_jax
from skypilot_tpu.observability import promtext as promtext_jax
from skypilot_tpu_torch.benchmark import decode_bench as bench_torch
from skypilot_tpu_torch.benchmark import loadgen as loadgen_torch
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import promtext as promtext_torch
from skypilot_tpu_torch.serve import decode_engine
from skypilot_tpu_torch.serve import load_balancer as lb_lib
from skypilot_tpu_torch.serve.load_balancing_policies import (
    PrefixAffinityPolicy, RoundRobinPolicy)
from skypilot_tpu_torch.utils import fault_injection as fi


@pytest.fixture(scope="module", autouse=True)
def no_tuning_manifest():
    """Every engine here runs the default constants: no ambient tuning
    manifest (STPU_TUNE_MANIFEST=0), set before the module's engines."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STPU_TUNE_MANIFEST", "0")
        yield


@pytest.fixture(autouse=True)
def _clear_faults():
    fi.clear()
    yield
    fi.clear()


# ============================================================ promtext
def _registry_doc() -> str:
    reg = metrics.Registry()
    c = reg.counter("rt_total", "Req.", ("method", "code"))
    c.labels(method="GET", code="200").inc(3)
    c.labels(method="POST", code="502").inc()
    g = reg.gauge("rt_gauge", "G.", ("k",))
    g.labels(k='a"b\\c\nd, e').set(-math.inf)
    g.labels(k="frac").set(0.125)
    h = reg.histogram("rt_seconds", "L.", ("svc",),
                      buckets=(0.1, 1.0, 2.5))
    for v in (0.05, 0.5, 0.7, 2.0, 7.0):
        h.labels(svc="x").observe(v)
    h.labels(svc="y").observe(0.2)
    return reg.render()


DOCS = {
    "registry": _registry_doc(),
    "handwritten": ("# A comment line\n"
                    "# HELP up Is it up.\n# TYPE up gauge\nup 1\n"
                    "loose_sample{a=\"1\"} +Inf\n"
                    "# HELP lat Latency.\n# TYPE lat histogram\n"
                    "lat_bucket{le=\"0.5\"} 2\nlat_bucket{le=\"+Inf\"} 3\n"
                    "lat_sum 4.5\nlat_count 3\n"),
}


def _fams(families):
    return {n: (f.kind, f.help, [(s.name, s.labels, s.value)
                                 for s in f.samples])
            for n, f in families.items()}


@pytest.mark.parametrize("doc", sorted(DOCS))
def test_promtext_equal_jax(doc):
    text = DOCS[doc]
    got, want = promtext_torch.parse(text), promtext_jax.parse(text)
    assert _fams(got) == _fams(want)
    assert promtext_torch.render_families(got) == \
        promtext_jax.render_families(want)
    for name in want:
        assert promtext_torch.value(got, name) == \
            promtext_jax.value(want, name)
        assert promtext_torch.counter_total(got, name) == \
            promtext_jax.counter_total(want, name)
        h_t = promtext_torch.histogram(got, name)
        h_j = promtext_jax.histogram(want, name)
        assert (h_t is None) == (h_j is None)
        if h_j is not None:
            assert dataclasses.asdict(h_t) == dataclasses.asdict(h_j)
            assert [h_t.quantile(q) for q in (0.5, 0.9, 0.99)] == \
                [h_j.quantile(q) for q in (0.5, 0.9, 0.99)]
            assert dataclasses.asdict(h_t.delta(h_t)) == \
                dataclasses.asdict(h_j.delta(h_j))
    if doc == "registry":
        assert promtext_torch.render_families(got) == text
        assert promtext_torch.value(got, "rt_gauge",
                                    k='a"b\\c\nd, e') == -math.inf
        x_t = promtext_torch.histogram(got, "rt_seconds", svc="x")
        x_j = promtext_jax.histogram(want, "rt_seconds", svc="x")
        assert dataclasses.asdict(x_t) == dataclasses.asdict(x_j)


@pytest.mark.parametrize("text", [
    "bad line without value\n", "x{a=\"1\" 2\n", "# TYPE x\n",
    "x{a=\"unterminated} 1\n"])
def test_promtext_parse_errors_equal_jax(text):
    errors = []
    for mod in (promtext_jax, promtext_torch):
        with pytest.raises(mod.ParseError) as e:
            mod.parse(text)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ========================================================== schedules
def _rows(schedule):
    return [dataclasses.astuple(r) for r in schedule]


@pytest.mark.parametrize("arrival", loadgen_jax.ARRIVALS)
@pytest.mark.parametrize("mix", loadgen_jax.MIXES)
def test_schedules_and_files_equal_jax(mix, arrival, tmp_path):
    kw = dict(mix=mix, arrival=arrival, qps=20.0, duration_s=2.0, seed=7,
              max_tokens=12)
    spec_t, spec_j = loadgen_torch.LoadSpec(**kw), loadgen_jax.LoadSpec(**kw)
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)
    sched_t = loadgen_torch.build_schedule(spec_t)
    sched_j = loadgen_jax.build_schedule(spec_j)
    assert len(sched_j) > 10
    assert _rows(sched_t) == _rows(sched_j)
    digest = loadgen_jax.schedule_digest(sched_j)
    assert loadgen_torch.schedule_digest(sched_t) == digest
    paths = {name: str(tmp_path / f"{name}.json") for name in ("t", "j")}
    assert loadgen_torch.save_schedule(paths["t"], spec_t, sched_t) == \
        loadgen_jax.save_schedule(paths["j"], spec_j, sched_j)
    assert pathlib.Path(paths["t"]).read_bytes() == \
        pathlib.Path(paths["j"]).read_bytes()
    for load, path in ((loadgen_jax.load_schedule, paths["t"]),
                       (loadgen_torch.load_schedule, paths["j"])):
        spec, sched, got = load(path)
        assert got == digest and _rows(sched) == _rows(sched_j)
        assert dataclasses.asdict(spec) == dataclasses.asdict(spec_j)


def _record(i, ts, plen, prefix="aa" * 8):
    return {"request_id": f"{i:04x}" * 8, "ts": ts, "path": "/generate",
            "prompt_tokens": plen, "max_tokens": 8, "temperature": 0.0,
            "prefix_hash": prefix, "status": "200"}


def _bursty():
    ts = [c * 3.0 + k * 0.01 for c in range(8) for k in range(5)]
    return [_record(i, 100.0 + t, 80) for i, t in enumerate(ts)]


RECORDS = {
    "chat": [_record(i, 100.0 + i * 0.1, 68 + (i % 2) * 28,
                     prefix="aa" * 8 if i % 2 else "bb" * 8)
             for i in range(40)],
    "bursty": _bursty(),
    "long_context": [_record(i, 100.0 + i * 0.1, 600) for i in range(20)],
}


@pytest.mark.parametrize("case", sorted(RECORDS))
def test_derive_spec_equal_jax(case):
    got = loadgen_torch.derive_spec(RECORDS[case])
    want = loadgen_jax.derive_spec(RECORDS[case])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mix == case
    errors = []
    for mod in (loadgen_jax, loadgen_torch):
        with pytest.raises(ValueError) as e:
            mod.derive_spec([{"path": "/metrics", "ts": 1.0}])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ============================================= the generator, through an LB
class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class _SSEReplica(http.server.BaseHTTPRequestHandler):
    """A stub replica: min(max_tokens, token_cap) token events ``delay``
    s apart, then [DONE] (or, with ``abort_after``, the connection
    dropped after that many; with ``served`` too, a count of its streams,
    only every second stream it serves is dropped); its first token
    observed into the port's engine TTFT histogram, which the balancer's
    merged /metrics carries; /metrics is the port's registry. ``hits``
    records each /generate's port."""
    protocol_version = "HTTP/1.1"
    delay, token_cap, abort_after, hits, served = 0.002, 6, None, None, None

    def log_message(self, *a):
        pass

    def do_GET(self):
        body = metrics.render().encode()
        self.send_response(200)
        self.send_header("Content-Type", metrics.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        req = json.loads(self.rfile.read(
            int(self.headers.get("Content-Length") or 0)))
        if self.hits is not None:
            self.hits.append(self.server.server_address[1])
        drop = self.abort_after is not None and (
            self.served is None or next(self.served) % 2 == 0)
        t0 = time.perf_counter()
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for i in range(min(int(req["max_tokens"]), self.token_cap)):
            time.sleep(self.delay)
            if i == 0:
                decode_engine._TTFT.observe(time.perf_counter() - t0)
            if drop and i >= self.abort_after:
                self.wfile.flush()          # no [DONE], no terminator
                self.connection.close()
                return
            lb_lib.write_chunk(self.wfile,
                               f'data: {{"token": {i}}}\n\n'.encode())
        lb_lib.write_chunk(self.wfile, b"data: [DONE]\n\n")
        lb_lib.end_chunks(self.wfile)


@pytest.fixture
def stack():
    """The stub replica behind the port's balancer; yields its URL."""
    replica = _Server(("127.0.0.1", 0), _SSEReplica)
    threading.Thread(target=replica.serve_forever, daemon=True).start()
    policy = RoundRobinPolicy()
    policy.set_ready_replicas(
        [f"http://127.0.0.1:{replica.server_address[1]}"])
    lb = lb_lib.run_load_balancer(0, policy, lb_lib.RequestRecorder())
    try:
        yield f"http://127.0.0.1:{lb.server_address[1]}"
    finally:
        for srv in (lb, replica):
            srv.shutdown()
            srv.server_close()


def _keys(doc):
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    if isinstance(doc, list) and doc and isinstance(doc[0], dict):
        return [_keys(doc[0])]
    return None


SPEC = dict(mix="chat", qps=10.0, duration_s=0.8, seed=3, max_tokens=4)


def test_run_report_keys_equal_jax(stack, tmp_path, monkeypatch):
    """Both generators through the port's balancer: the same schedule,
    every request served, and reports with the same keys; with no
    out_dir the port's run lands under runs_root (STPU_HOME)."""
    monkeypatch.setenv("STPU_HOME", str(tmp_path / "home"))
    reports = []
    for mod, out in ((loadgen_jax, str(tmp_path / "jax")),
                     (loadgen_torch, None)):
        reports.append(mod.run(stack, mod.LoadSpec(**SPEC),
                               slo_ttft_s=30.0, slo_tpot_s=30.0,
                               scrape_interval=0.2, out_dir=out))
    want, got = reports
    assert _keys(got) == _keys(want)
    assert got["schedule_sha256"] == want["schedule_sha256"]
    assert got["requests"]["error"] == 0 and got["goodput"]["good"] == \
        got["requests"]["scheduled"] > 0
    # The scrape read the balancer's own families and the engine's
    # through it. The balancer counts a request after its last byte went
    # out, so the last ones may land after the closing scrape.
    assert got["server"]["scrapes"] >= 2
    assert 0 < got["server"]["lb_requests_by_code"]["200"] <= \
        got["requests"]["scheduled"]
    assert got["server"]["engine_ttft"]["count"] == \
        got["requests"]["scheduled"]
    assert got["out_dir"].startswith(loadgen_torch.runs_root())
    assert loadgen_torch.latest_run_dir() == got["out_dir"]
    assert json.loads((pathlib.Path(got["out_dir"]) /
                       "report.json").read_text())["schedule_sha256"] == \
        got["schedule_sha256"]
    text = loadgen_torch.format_report(got)
    assert text == loadgen_jax.format_report(got)
    assert "goodput" in text


def test_run_faults_hook_arms_the_port_points(stack, tmp_path):
    """``faults=`` arms the port's fault points for the run and clears
    them after: every upstream connect failing reads as 502s."""
    report = loadgen_torch.run(
        stack, loadgen_torch.LoadSpec(**SPEC), faults="lb.upstream:raise",
        scrape_interval=0.2, out_dir=str(tmp_path / "faults"))
    n = report["requests"]["scheduled"]
    assert n > 0 and report["requests"]["errors_by_kind"] == {
        "http_502": n}
    assert report["goodput"]["fraction"] == 0.0
    assert report["faults"] == "lb.upstream:raise"
    assert not fi.ENABLED


def _start_stubs(*attrs):
    servers = []
    for i, kw in enumerate(attrs):
        srv = _Server(("127.0.0.1", 0),
                      type(f"Stub{i}", (_SSEReplica,), kw))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
    return servers


def _drained(policy, timeout=30.0):
    """Every in-flight slot returned. The balancer returns a request's
    slot after its last byte went out, so the state is waited for,
    bounded, rather than read the moment the client finishes."""
    deadline = time.monotonic() + timeout
    while True:
        with policy._lock:
            if all(v == 0 for v in policy._inflight.values()):
                return True
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)


def test_inflight_slots_return_under_burst_failures(tmp_path):
    """Every exit path returns its in-flight slot (clean streams, retries
    off a dead replica, mid-stream aborts, a 413) under the generator's
    open-loop burst, as the JAX package's balancer does. The policy's
    ring hangs on the replicas' URLs, whose ports the OS picks, so which
    live replica takes the burst varies: each serves clean streams and
    drops every second one."""
    servers = _start_stubs(*({"abort_after": 1, "served": itertools.count(1)}
                             for _ in range(2)))
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    # Bound and never listening: connects are refused, and no other
    # server can take the port while the burst runs.
    dead = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    dead.bind(("127.0.0.1", 0))
    urls.append(f"http://127.0.0.1:{dead.getsockname()[1]}")
    policy = PrefixAffinityPolicy()
    policy.set_ready_replicas(urls)
    # No resume: the aborts must stay aborts here (the resume ladder's
    # slot returns are tests/test_torch_stream_resume.py's).
    lb = lb_lib.run_load_balancer(0, policy, lb_lib.RequestRecorder())
    lb.RequestHandlerClass.max_stream_resumes = 0
    lb.RequestHandlerClass.max_body_bytes = 64 * 1024
    target = f"http://127.0.0.1:{lb.server_address[1]}"
    try:
        report = loadgen_torch.run(
            target, loadgen_torch.LoadSpec(
                mix="chat", arrival="uniform", qps=40, duration_s=1.0,
                seed=9, max_tokens=4),
            scrape_interval=0.5, out_dir=str(tmp_path / "burst"))
        big = json.dumps({"prompt": [1] * 40000, "max_tokens": 1})
        req = urllib.request.Request(target + "/generate",
                                     data=big.encode(), method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 413
        e.value.read()
        assert _drained(policy), policy._inflight
    finally:
        for srv in [lb] + servers:
            srv.shutdown()
            srv.server_close()
        dead.close()
    reqs = report["requests"]
    assert reqs["ok"] > 0 and reqs["error"] > 0
    assert set(reqs["errors_by_kind"]) & {"truncated_stream",
                                          "IncompleteRead"}


def test_prefix_affinity_spills_under_burst(tmp_path):
    """One system prompt under a burst spills off its saturated ring
    owner to at least one successor (bounded load), and every slot
    returns."""
    hits = []
    servers = _start_stubs(*[{"delay": 0.03, "token_cap": 4,
                              "hits": hits}] * 3)
    policy = PrefixAffinityPolicy()
    policy.set_ready_replicas(
        [f"http://127.0.0.1:{s.server_address[1]}" for s in servers])
    lb = lb_lib.run_load_balancer(0, policy, lb_lib.RequestRecorder())
    try:
        report = loadgen_torch.run(
            f"http://127.0.0.1:{lb.server_address[1]}",
            loadgen_torch.LoadSpec(mix="chat", arrival="uniform", qps=50,
                                   duration_s=1.0, seed=6, n_prefixes=1,
                                   max_tokens=4),
            scrape_interval=0.5, out_dir=str(tmp_path / "spill"))
        assert _drained(policy), policy._inflight
    finally:
        for srv in [lb] + servers:
            srv.shutdown()
            srv.server_close()
    assert report["requests"]["ok"] == report["requests"]["scheduled"]
    assert len(set(hits)) >= 2, f"no spill: every hit on {set(hits)}"


# ============================================== decode_bench's legs
def _jax_keys(name: str) -> set:
    """The string keys of the dict the JAX function returns last."""
    src = pathlib.Path(inspect.getsourcefile(bench_jax)).read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)
           and isinstance(n.value, ast.Dict)][-1]
    return {k.value for k in ret.value.keys}


@pytest.mark.parametrize("mode", ["measure_engine_slo",
                                  "measure_engine_chaos"])
def test_serving_legs_return_the_jax_keys(mode):
    out = getattr(bench_torch, mode)(
        "llama", slots=2, qps=4.0, duration_s=1.5, slo_ttft_s=30.0,
        slo_tpot_s=30.0, max_tokens=4, tiny=True, device="cpu")
    assert set(out) == _jax_keys(mode)
    sig_t = inspect.signature(getattr(bench_torch, mode)).parameters
    sig_j = inspect.signature(getattr(bench_jax, mode)).parameters
    assert {k: v.default for k, v in sig_t.items() if k != "device"} == \
        {k: v.default for k, v in sig_j.items()}
    if mode == "measure_engine_slo":
        assert out["errors"] == 0 and out["slo_goodput"] == 1.0
        assert out["p99_ttft_s"] > 0 and out["loadgen_tok_s"] > 0
    else:
        assert out["baseline_slo_goodput"] == 1.0
        assert out["replicas"] == 2 and out["kill_at_s"] == 0.75
