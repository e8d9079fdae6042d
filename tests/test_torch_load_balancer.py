"""The port's load balancer (skypilot_tpu_torch.serve.load_balancer) and
its routing policies against the JAX package's: the same picks for the
same seeded request streams and replica-set changes, the same breaker
transitions under the same failure sequences (a fake clock in both
modules), the same journal bytes and accounting, the same metric
families and defaults; each balancer in front of one port replica (a
tiny f32 Llama on the CPU) returning the same bytes; and run_lb_process
following a stub controller's /sync, keeping its last replica set and
re-queueing the request timestamps while the controller is down."""
import dataclasses
import http.client
import http.server
import json
import random
import socket
import socketserver
import threading
import time
import types

import pytest
import torch

from skypilot_tpu.observability import metrics as metrics_jax
from skypilot_tpu.observability import promtext as promtext_jax
from skypilot_tpu.serve import load_balancer as lb_jax
from skypilot_tpu.serve import load_balancing_policies as pol_jax
from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.observability import metrics as metrics_torch
from skypilot_tpu_torch.observability import promtext as promtext_torch
from skypilot_tpu_torch.recipes import serve_llm as serve_torch
from skypilot_tpu_torch.serve import load_balancer as lb_torch
from skypilot_tpu_torch.serve import load_balancing_policies as pol_torch


@pytest.fixture(scope="module", autouse=True)
def no_tuning_manifest():
    """Every engine here runs the default constants: no ambient tuning
    manifest (STPU_TUNE_MANIFEST=0), set before the module's engines."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STPU_TUNE_MANIFEST", "0")
        yield


# ============================================================ policies
def _picks(pol_mod, name: str, seed: int):
    """A seeded stream of 300 picks: shared 64-token prefixes with unique
    tails, unparseable and empty bodies, random exclusions, slots returned
    at random, a replica added at step 100 and one removed at step 200."""
    policy = pol_mod.make_policy(name)
    rng = random.Random(seed)
    urls = [f"http://10.0.0.{i}:8080" for i in range(3)]
    policy.set_ready_replicas(urls)
    prefixes = [[rng.randrange(1, 500) for _ in range(64)]
                for _ in range(4)]
    picks, live = [], []
    for step in range(300):
        if step == 100:
            urls = urls + ["http://10.0.0.9:8080"]
            policy.set_ready_replicas(urls)
        if step == 200:
            urls = urls[1:]
            policy.set_ready_replicas(urls)
        kind = rng.random()
        if kind < 0.7:
            body = json.dumps({"prompt": rng.choice(prefixes) + [
                rng.randrange(500) for _ in range(rng.randint(0, 8))]
            }).encode()
        elif kind < 0.8:
            body = b"not json"
        elif kind < 0.9:
            body = json.dumps({"prompt": []}).encode()
        else:
            body = None
        exclude = None
        if rng.random() < 0.2:
            exclude = set(rng.sample(urls, rng.randint(0, len(urls))))
        pick = policy.select_replica({"path": "/generate", "body": body},
                                     exclude=exclude)
        picks.append(pick)
        if pick is not None:
            live.append(pick)
        while live and rng.random() < 0.45:
            policy.report_done(live.pop(rng.randrange(len(live))))
    return picks, policy.ready_replicas()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(pol_jax.POLICIES))
def test_policy_picks_equal_jax(name, seed):
    want = _picks(pol_jax, name, seed)
    got = _picks(pol_torch, name, seed)
    assert got == want
    assert len(set(want[0])) >= 3         # the stream reaches the fleet


def test_policy_names_and_refusal_equal_jax():
    assert sorted(pol_torch.POLICIES) == sorted(pol_jax.POLICIES)
    assert pol_torch.DEFAULT_POLICY == pol_jax.DEFAULT_POLICY
    assert type(pol_torch.make_policy(None)).__name__ == \
        type(pol_jax.make_policy(None)).__name__
    errors = []
    for mod in (pol_jax, pol_torch):
        with pytest.raises(ValueError) as e:
            mod.make_policy("random")
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert pol_torch.PrefixAffinityPolicy.VNODES == \
        pol_jax.PrefixAffinityPolicy.VNODES
    assert pol_torch.PrefixAffinityPolicy.LOAD_FACTOR == \
        pol_jax.PrefixAffinityPolicy.LOAD_FACTOR


# ============================================================= breaker
BREAKER_OPS = {
    # Three connect failures open the circuit; it stays blocked until the
    # backoff ends, turns half-open, a failed probe re-opens it with the
    # backoff doubled, and a success closes it.
    "eject-probe-close": [("fail", "a"), ("fail", "a"), ("blocked",),
                          ("fail", "a"), ("blocked",), ("tick", 1.0),
                          ("blocked",), ("tick", 2.0), ("blocked",),
                          ("fail", "a"), ("blocked",), ("tick", 6.0),
                          ("blocked",), ("ok", "a"), ("blocked",)],
    # A success in between resets the consecutive count.
    "success-resets": [("fail", "b"), ("fail", "b"), ("ok", "b"),
                       ("fail", "b"), ("fail", "b"), ("blocked",),
                       ("fail", "b"), ("blocked",), ("ok", "a")],
    # Failed probes double the backoff up to the cap.
    "backoff-cap": [("fail", "a"), ("fail", "a"), ("fail", "a")] + [
        op for _ in range(4) for op in (("tick", 40.0), ("blocked",),
                                        ("fail", "a"))] + [("blocked",)],
    # Pruned replicas are forgotten and read closed.
    "prune": [("fail", "a"), ("fail", "a"), ("fail", "a"), ("fail", "b"),
              ("prune", "b"), ("blocked",), ("fail", "a"), ("tick", 3.0),
              ("blocked",)],
}


def _breaker_trace(lb_mod, ops, tag, monkeypatch):
    clock = types.SimpleNamespace(t=1000.0)
    monkeypatch.setattr(lb_mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock.t, perf_counter=time.perf_counter,
        time=time.time))
    breaker = lb_mod.CircuitBreaker(threshold=3, backoff_base=2.0,
                                    backoff_cap=10.0, seed=7)
    urls = [f"http://{tag}-{r}" for r in "ab"]
    ejected0 = [lb_mod._BREAKER_EJECTIONS.labels(replica=u).get()
                for u in urls]
    trace = []
    for op in ops:
        url = f"http://{tag}-{op[1]}" if len(op) > 1 and \
            isinstance(op[1], str) else None
        if op[0] == "fail":
            breaker.record_failure(url)
        elif op[0] == "ok":
            breaker.record_success(url)
        elif op[0] == "tick":
            clock.t += op[1]
        elif op[0] == "prune":
            breaker.prune([u for u in urls if u != url])
        trace.append((
            sorted(breaker.blocked(urls)) if op[0] == "blocked" else None,
            [breaker.state(u) for u in urls],
            {u: list(e) for u, e in breaker._replicas.items()},
            [lb_mod._BREAKER_STATE.labels(replica=u).get() for u in urls],
            [lb_mod._BREAKER_EJECTIONS.labels(replica=u).get() - e0
             for u, e0 in zip(urls, ejected0)]))
    return trace


@pytest.mark.parametrize("case", sorted(BREAKER_OPS))
def test_breaker_transitions_equal_jax(case, monkeypatch):
    ops = BREAKER_OPS[case]
    want = _breaker_trace(lb_jax, ops, f"jax-{case}", monkeypatch)
    got = _breaker_trace(lb_torch, ops, f"jax-{case}", monkeypatch)
    assert got == want
    assert any("open" in t[1] for t in want)


# ============================================================= journal
JOURNAL_DOCS = {
    "greedy": {"prompt": [1, 2, 3], "max_tokens": 8, "stream": True},
    "seeded": {"prompt": [9, 8], "max_tokens": 6, "stream": True,
               "temperature": 0.7, "seed": 11},
    "extra-fields": {"stream": True, "prompt": list(range(40)),
                     "max_tokens": 32, "user": "x", "stop": None},
}


def _journal_run(lb_mod, doc, cap):
    body = json.dumps(doc).encode()
    account = lb_mod.JournalAccount(cap_bytes=cap)
    journal = lb_mod.StreamJournal({"path": "/generate", "body": body},
                                   doc, 1, account)
    out = [(journal.resume_body(), account.used(), journal.evicted)]
    for tok in (5, 17, 250, 3, 3):
        journal.append(tok)
        out.append((journal.resume_body(), account.used(),
                    journal.evicted, journal.can_resume()))
    journal.release()
    out.append(account.used())
    return out


@pytest.mark.parametrize("tokens", [None, -1, 2],
                         ids=["roomy", "evicted-at-birth", "evicted-late"])
@pytest.mark.parametrize("doc", sorted(JOURNAL_DOCS))
def test_journal_bytes_and_accounting_equal_jax(doc, tokens):
    """A cap with room, one a byte short of the request's own charge, and
    one that runs out after two tokens."""
    doc = JOURNAL_DOCS[doc]
    cap = 10 * 1024 if tokens is None else (
        len(json.dumps(doc)) + 64 + tokens * lb_jax.StreamJournal.TOKEN_BYTES)
    assert _journal_run(lb_torch, doc, cap) == _journal_run(lb_jax, doc,
                                                             cap)
    assert lb_torch.StreamJournal.TOKEN_BYTES == \
        lb_jax.StreamJournal.TOKEN_BYTES


@pytest.mark.parametrize("event", [
    b'data: {"token": 42}\n\n', b"data: [DONE]\n\n", b": keepalive\n\n",
    b"data: not-json\n\n", b'data: {"text": "hi"}\n\n',
    b'event: stats\ndata: {"ttft_s": 1}\n\n'])
def test_sse_token_equal_jax(event):
    assert lb_torch._sse_token(event) == lb_jax._sse_token(event)


def _families(registry):
    return {f.name: (f.kind, f.help, f.labelnames,
                     tuple(getattr(f, "buckets", ())))
            for f in registry._families.values()
            if f.name.startswith("stpu_lb_")}


def test_metric_families_and_defaults_equal_jax():
    """The stpu_lb_* families (kind, help, labels, buckets) and the
    STPU_LB_* defaults are JAX's, so scrapers read either balancer."""
    want = _families(metrics_jax.REGISTRY)
    assert len(want) == 9
    assert _families(metrics_torch.REGISTRY) == want
    for name in ("DEFAULT_MAX_RETRIES", "DEFAULT_MAX_BODY_BYTES",
                 "DEFAULT_STREAM_RESUMES", "DEFAULT_RESUME_JOURNAL_MB",
                 "_PREFIX_HASH_TOKENS", "_HOP_HEADERS"):
        assert getattr(lb_torch, name) == getattr(lb_jax, name), name
    b_t, b_j = lb_torch.CircuitBreaker(), lb_jax.CircuitBreaker()
    assert (b_t.threshold, b_t.backoff_base, b_t.backoff_cap,
            b_t.jitter) == (b_j.threshold, b_j.backoff_base,
                            b_j.backoff_cap, b_j.jitter)
    assert lb_torch._ProxyHandler.upstream_timeout == \
        lb_jax._ProxyHandler.upstream_timeout


# ======================================== both balancers, one replica
VOCAB = 128


@pytest.fixture(scope="module")
def replica():
    cfg = dataclasses.replace(llama_torch.LlamaConfig.tiny(VOCAB),
                              n_layers=2, dtype=torch.float32)
    params = llama_torch.init(cfg, torch.Generator().manual_seed(0), "cpu")
    ready = threading.Event()
    httpd = serve_torch.serve(cfg, params, 0, ready_event=ready,
                              engine_slots=2, device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert ready.wait(timeout=120)
        yield httpd
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.engine.shutdown()


@pytest.fixture(scope="module")
def balancers(replica):
    """(JAX's balancer, the port's), each fronting the port replica."""
    url = f"http://127.0.0.1:{replica.server_address[1]}"
    servers = []
    try:
        for lb_mod, pol_mod in ((lb_jax, pol_jax), (lb_torch, pol_torch)):
            policy = pol_mod.PrefixAffinityPolicy()
            policy.set_ready_replicas([url])
            servers.append(lb_mod.run_load_balancer(
                0, policy, lb_mod.RequestRecorder()))
        yield servers
    finally:
        for lb in servers:
            lb.shutdown()
            lb.server_close()


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


GREEDY = {"prompt": [1, 2, 3, 4, 5], "max_tokens": 8, "stream": True}
SEEDED = {"prompt": [7, 8, 9], "max_tokens": 8, "temperature": 0.8,
          "seed": 5, "stream": True}
CALLS = {
    "greedy-sse": ("POST", "/generate", GREEDY),
    "seeded-sse": ("POST", "/generate", SEEDED),
    "greedy-json": ("POST", "/generate", dict(GREEDY, stream=False)),
    "seeded-json": ("POST", "/generate", dict(SEEDED, stream=False)),
    "bad-body": ("POST", "/generate", {"prompt": []}),
    "health": ("GET", "/health", None),
    "not-found": ("GET", "/nope", None),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_balancer_bytes_equal_jax(replica, balancers, call):
    method, path, body = CALLS[call]
    direct = _call(replica.server_address[1], method, path, body)
    via = [_call(lb.server_address[1], method, path, body)
           for lb in balancers]
    assert via[1] == via[0] == direct
    if body is not None and body.get("stream") and body["prompt"]:
        frames = via[1][1].decode().split("\n\n")
        assert frames[-2] == "data: [DONE]"
        assert len(frames) == body["max_tokens"] + 2


def test_merged_metrics_family_names_equal_jax(replica, balancers):
    """One scrape of either balancer carries its stpu_lb_* families and
    every family of the replica's own /metrics."""
    _call(balancers[1].server_address[1], "POST", "/generate", GREEDY)
    names = []
    for lb, promtext in zip(balancers, (promtext_jax, promtext_torch)):
        status, text = _call(lb.server_address[1], "GET", "/metrics")
        assert status == 200
        names.append(set(promtext.parse(text.decode())))
    _, own = _call(replica.server_address[1], "GET", "/metrics")
    own = set(promtext_torch.parse(own.decode()))
    assert {n for n in names[1] if n.startswith("stpu_lb_")} == \
        {n for n in names[0] if n.startswith("stpu_lb_")}
    assert own <= names[0] and own <= names[1]
    assert "stpu_engine_decode_tokens_total" in own
    status, doc = _call(balancers[1].server_address[1], "GET", "/perf")
    assert status == 200
    assert json.loads(doc)["aggregate"]["replicas"] == 1


# ========================================= run_lb_process + /sync stub
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class _Ping(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_GET(self):
        body = b"pong"
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _Controller(http.server.BaseHTTPRequestHandler):
    """A /sync stub: answers with ``ready`` while ``up``, 503 otherwise,
    and records every call (whether it answered, the timestamps sent)."""
    protocol_version = "HTTP/1.1"
    state = None

    def log_message(self, *a):
        pass

    def do_POST(self):
        doc = json.loads(self.rfile.read(
            int(self.headers.get("Content-Length") or 0)))
        st = self.state
        with st.cond:
            up = st.up
            st.calls.append((up, doc["request_timestamps"]))
            st.cond.notify_all()
        body = json.dumps({
            "ready_urls": st.ready, "upstream_timeout": 30.0,
            "metrics_text": "# HELP stpu_ctl_probe stub\n"
                            "# TYPE stpu_ctl_probe gauge\n"
                            "stpu_ctl_probe 1\n"}).encode()
        self.send_response(200 if up else 503)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_run_lb_process_follows_the_controller():
    state = types.SimpleNamespace(cond=threading.Condition(), up=True,
                                  calls=[], ready=[])
    ping = _Server(("127.0.0.1", 0), _Ping)
    ctl = _Server(("127.0.0.1", 0),
                  type("Ctl", (_Controller,), {"state": state}))
    servers = [ping, ctl]
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    state.ready = [f"http://127.0.0.1:{ping.server_address[1]}"]
    port, stop = _free_port(), threading.Event()
    lb = threading.Thread(target=lb_torch.run_lb_process, args=(
        port, f"http://127.0.0.1:{ctl.server_address[1]}", 0.02),
        kwargs={"policy_name": "prefix_affinity", "stop": stop},
        daemon=True)

    def wait(pred):
        with state.cond:
            assert state.cond.wait_for(lambda: pred(state.calls),
                                       timeout=30)
            return len(state.calls)

    try:
        lb.start()
        # The loop is sequential: a second call means the first answer
        # was adopted.
        wait(lambda calls: sum(up for up, _ in calls) >= 2)
        # The adopted set serves; /metrics carries the controller's
        # snapshot.
        assert _call(port, "GET", "/ping") == (200, b"pong")
        status, text = _call(port, "GET", "/metrics")
        assert status == 200 and b"stpu_ctl_probe 1" in text
        with state.cond:
            state.up = False
            n = len(state.calls)
        wait(lambda calls: any(not up for up, _ in calls[n:]))
        t0 = time.time()
        for _ in range(2):         # the last set still serves
            assert _call(port, "GET", "/ping") == (200, b"pong")
        t1 = time.time()

        def ours(tss):
            return len([t for t in tss if t0 <= t <= t1]) == 2

        # Drained into a refused sync, then re-queued: the first answered
        # sync carries them again.
        wait(lambda calls: any(not up and ours(tss)
                               for up, tss in calls[n:]))
        with state.cond:
            state.up = True
            n = len(state.calls)
        wait(lambda calls: any(up for up, _ in calls[n:]))
        with state.cond:
            first_ok = next(tss for up, tss in state.calls[n:] if up)
        assert ours(first_ok)
    finally:
        stop.set()
        lb.join(timeout=30)
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    assert not lb.is_alive()


def test_main_parses_the_jax_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr(lb_torch, "run_lb_process",
                        lambda *a, **kw: seen.update(args=a, kw=kw))
    monkeypatch.setattr("sys.argv", [
        "load_balancer", "--port", "9000", "--controller-url",
        "http://127.0.0.1:9001", "--lb-policy", "prefix_affinity"])
    lb_torch.main()
    assert seen == {"args": (9000, "http://127.0.0.1:9001", 2.0),
                    "kw": {"policy_name": "prefix_affinity"}}
