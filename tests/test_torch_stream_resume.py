"""Durable streams on the port: the port's load balancer in front of port
replicas (tiny f32 Llamas on the CPU). When a replica's stream dies mid-
flight (the balancer's ``lb.stream`` fault point, or a replica's engine
torn down under a live stream) the balancer resumes it on a peer and the
client's bytes equal the uninterrupted stream's, greedy and seeded; a
peer that replays from position 0 is deduplicated, and one that diverges
is refused; the resume budget and the journal's byte cap degrade to the
plain abort; a client that hangs up is neither resumed nor charged to
the replica. The JAX package's tests hold its own balancer to the same
contract (tests/test_stream_resume.py)."""
import dataclasses
import http.client
import io
import json
import socket
import struct
import threading
import time

import pytest
import torch

from skypilot_tpu_torch.models import llama as llama_torch
from skypilot_tpu_torch.recipes import serve_llm as serve_torch
from skypilot_tpu_torch.serve import load_balancer as lb_lib
from skypilot_tpu_torch.serve.load_balancing_policies import (
    LoadBalancingPolicy)
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


VOCAB = 128
MT = 12
GREEDY = {"prompt": [3, 1, 4, 1, 5], "max_tokens": MT, "stream": True}
SEEDED = dict(GREEDY, temperature=0.9, seed=21)


def _replay_from_zero(handler_cls):
    """A replica handler that drops the ``resume`` extension, as a replica
    without resume admission would: it replays the stream from position
    0, with no X-STPU-Resume header."""
    class ReplayFromZero(handler_cls):
        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            doc = json.loads(self.rfile.read(length) or b"{}")
            doc.pop("resume", None)
            raw = json.dumps(doc).encode()
            self.headers.replace_header("Content-Length", str(len(raw)))
            self.rfile = io.BytesIO(raw)
            super().do_POST()
    return ReplayFromZero


def _start_replica(seed=0, replay=False):
    cfg = dataclasses.replace(llama_torch.LlamaConfig.tiny(VOCAB),
                              n_layers=2, dtype=torch.float32)
    params = llama_torch.init(cfg, torch.Generator().manual_seed(seed),
                              "cpu")
    ready = threading.Event()
    httpd = serve_torch.serve(cfg, params, 0, ready_event=ready,
                              engine_slots=2, device="cpu")
    if replay:
        httpd.RequestHandlerClass = _replay_from_zero(
            httpd.RequestHandlerClass)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    assert ready.wait(timeout=120)
    return httpd


def _stop_replica(httpd):
    httpd.shutdown()
    httpd.server_close()
    httpd.engine.shutdown()


def _url(httpd):
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def fleet():
    """a, b, c: one set of weights; replay: the same weights without
    resume admission; divergent: other weights without it."""
    names = ("a", "b", "c", "replay", "divergent")
    servers = {}
    try:
        for name in names:
            servers[name] = _start_replica(
                seed=1 if name == "divergent" else 0,
                replay=name in ("replay", "divergent"))
        yield servers
    finally:
        for httpd in servers.values():
            _stop_replica(httpd)


class _OrderedPolicy(LoadBalancingPolicy):
    """The first URL not excluded, in a fixed order: the stream starts on
    the first replica and resumes on the next."""

    def __init__(self, urls):
        self._urls = list(urls)

    def set_ready_replicas(self, urls):
        self._urls = list(urls)

    def select_replica(self, request=None, exclude=None):
        excl = exclude or ()
        return next((u for u in self._urls if u not in excl), None)

    def ready_replicas(self):
        return list(self._urls)


def _start_lb(urls, **handler_attrs):
    handler_attrs.setdefault("journal_account", lb_lib.JournalAccount())
    handler_attrs.setdefault("breaker", lb_lib.CircuitBreaker())
    handler = type("Handler", (lb_lib._ProxyHandler,), {
        "policy": _OrderedPolicy(urls),
        "recorder": lb_lib.RequestRecorder(), **handler_attrs})
    server = lb_lib._ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _stop_lb(server):
    server.shutdown()
    server.server_close()


def _stream(port, doc, on_frame=None):
    """POST a streaming /generate and read to EOF: (status, bytes,
    truncated), truncated meaning the chunked body died before its
    terminator. ``on_frame(n)`` runs after each complete SSE frame."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/generate", body=json.dumps(doc),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        chunks, truncated = [], False
        try:
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    break
                chunks.append(chunk)
                if on_frame is not None:
                    on_frame(b"".join(chunks).count(b"\n\n"))
        except (http.client.HTTPException, OSError) as e:
            truncated = True
            if getattr(e, "partial", None):
                chunks.append(e.partial)
        return resp.status, b"".join(chunks), truncated
    finally:
        conn.close()


def _await(predicate, timeout=30.0):
    """The balancer's handler thread settles its counters just after the
    client reads the terminator: wait for the state, bounded."""
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _resumes(outcome):
    return lb_lib._RESUMES.labels(outcome=outcome).get()


def _code(code):
    return lb_lib._REQUESTS.labels(method="POST", code=code).get()


def _reference(fleet, doc):
    status, body, truncated = _stream(fleet["b"].server_address[1], doc)
    assert status == 200 and not truncated
    assert body.endswith(b"data: [DONE]\n\n")
    assert body.count(b'data: {"token"') == MT
    return body


def _tokens(body):
    return [json.loads(f[len(b"data: "):])["token"]
            for f in body.split(b"\n\n") if f.startswith(b'data: {')]


def _is_prefix_at_event(body, ref):
    return ref.startswith(body) and body.endswith(b"\n\n") and \
        b"[DONE]" not in body


@pytest.mark.parametrize("doc", [GREEDY, SEEDED], ids=["greedy", "seeded"])
def test_resume_splice_bit_identical(fleet, doc, monkeypatch):
    """The stream dies on a after 3 frames; b is asked to resume at
    position 3 with a's three tokens, and the client's bytes equal the
    uninterrupted stream's."""
    ref = _reference(fleet, doc)
    lb = _start_lb([_url(fleet["a"]), _url(fleet["b"])])
    ok, gaps = _resumes("ok"), lb_lib._RESUME_GAP.labels().snapshot()[2]
    engine_b, resumes = fleet["b"].engine, []
    submit = engine_b.submit

    def spy(prompt, **kw):
        resumes.append(kw.get("resume"))
        return submit(prompt, **kw)

    monkeypatch.setattr(engine_b, "submit", spy)
    try:
        fi.activate("lb.stream", times=1, skip=3)
        status, body, truncated = _stream(lb.server_address[1], doc)
        assert fi.fires("lb.stream") == 1
        assert status == 200 and not truncated
        assert body == ref
        assert resumes == [_tokens(ref)[:3]]
        assert _await(lambda: _resumes("ok") == ok + 1)
        assert lb_lib._RESUME_GAP.labels().snapshot()[2] == gaps + 1
    finally:
        _stop_lb(lb)


def test_resume_dedupes_a_replay_from_zero_peer(fleet):
    """A peer without resume admission replays from 0: the balancer drops
    and checks the overlap, and the client still sees one stream."""
    ref = _reference(fleet, SEEDED)
    lb = _start_lb([_url(fleet["a"]), _url(fleet["replay"])])
    ok = _resumes("ok")
    try:
        fi.activate("lb.stream", times=1, skip=4)
        status, body, truncated = _stream(lb.server_address[1], SEEDED)
        assert status == 200 and not truncated
        assert body == ref
        assert _await(lambda: _resumes("ok") == ok + 1)
    finally:
        _stop_lb(lb)


def test_divergent_peer_aborts_instead_of_corrupting(fleet):
    """A peer whose replayed overlap differs (other weights) is not
    spliced: the client keeps the correct frames it had, cut at an event
    boundary, with no [DONE]."""
    ref = _reference(fleet, GREEDY)
    _, other, _ = _stream(fleet["divergent"].server_address[1], GREEDY)
    assert _tokens(other)[:3] != _tokens(ref)[:3]
    lb = _start_lb([_url(fleet["a"]), _url(fleet["divergent"])])
    before = {k: _resumes(k) for k in ("failed", "exhausted", "ok")}
    aborted = _code("upstream_aborted")
    try:
        fi.activate("lb.stream", times=1, skip=3)
        status, body, truncated = _stream(lb.server_address[1], GREEDY)
        assert status == 200 and truncated
        assert _is_prefix_at_event(body, ref)
        assert body.count(b"\n\n") == 3
        assert _await(lambda: _resumes("failed") == before["failed"] + 1)
        assert _await(
            lambda: _resumes("exhausted") == before["exhausted"] + 1)
        assert _await(lambda: _code("upstream_aborted") == aborted + 1)
        assert _resumes("ok") == before["ok"]
    finally:
        _stop_lb(lb)


@pytest.mark.parametrize("budget", [1, 2], ids=["exhausted", "double-death"])
def test_resume_budget(fleet, budget):
    """The continuation dies too (the fault fires again on b's first
    read): with one resume the stream ends cleanly truncated; with two, c
    carries it to the uninterrupted bytes."""
    ref = _reference(fleet, SEEDED)
    lb = _start_lb([_url(fleet[n]) for n in "abc"],
                   max_stream_resumes=budget)
    before = {k: _resumes(k) for k in ("failed", "exhausted", "ok")}
    try:
        fi.activate("lb.stream", times=2, skip=3)
        status, body, truncated = _stream(lb.server_address[1], SEEDED)
        assert fi.fires("lb.stream") == 2
        assert status == 200
        assert _await(lambda: _resumes("failed") == before["failed"] + 1)
        if budget == 1:
            assert truncated and _is_prefix_at_event(body, ref)
            assert body.count(b"\n\n") == 3
            assert _await(
                lambda: _resumes("exhausted") == before["exhausted"] + 1)
        else:
            assert not truncated and body == ref
            assert _await(lambda: _resumes("ok") == before["ok"] + 1)
    finally:
        _stop_lb(lb)


def test_journal_cap_eviction_degrades_to_plain_abort(fleet):
    """A journal cap the stream outgrows after two tokens evicts it: the
    death after six frames is a plain abort, and every charged byte is
    released."""
    ref = _reference(fleet, GREEDY)
    acct = lb_lib.JournalAccount(
        cap_bytes=len(json.dumps(GREEDY)) + 64 +
        2 * lb_lib.StreamJournal.TOKEN_BYTES)
    lb = _start_lb([_url(fleet["a"]), _url(fleet["b"])],
                   journal_account=acct)
    evicted, ok = _resumes("evicted"), _resumes("ok")
    aborted = _code("upstream_aborted")
    try:
        fi.activate("lb.stream", times=1, skip=6)
        status, body, truncated = _stream(lb.server_address[1], GREEDY)
        assert status == 200 and truncated
        assert _is_prefix_at_event(body, ref)
        assert _await(lambda: _resumes("evicted") == evicted + 1)
        assert _await(lambda: _code("upstream_aborted") == aborted + 1)
        assert _await(lambda: acct.used() == 0)
        assert _resumes("ok") == ok
    finally:
        _stop_lb(lb)


def test_client_disconnect_is_not_resumed_and_not_charged(fleet):
    """The client hanging up mid-stream is no replica failure: no resume,
    no breaker charge, and the request counts as client_closed."""
    lb = _start_lb([_url(fleet["a"]), _url(fleet["b"])])
    before = {k: _resumes(k) for k in ("ok", "failed", "no_replica")}
    closed, aborted = _code("client_closed"), _code("upstream_aborted")
    fi.activate("engine.step", mode="delay", delay=0.05)
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          lb.server_address[1], timeout=30)
        conn.request("POST", "/generate",
                     body=json.dumps(dict(GREEDY, max_tokens=100)),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read1(1)                       # the stream is live
        # SO_LINGER 0: the close sends RST, so the balancer's next write
        # fails (a plain close leaves the socket open under resp).
        conn.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
        resp.close()
        conn.close()
        assert _await(lambda: _code("client_closed") == closed + 1)
        assert _code("upstream_aborted") == aborted
        for k, v in before.items():
            assert _resumes(k) == v, k
        assert lb.RequestHandlerClass.breaker.blocked(
            [_url(fleet["a"]), _url(fleet["b"])]) == set()
    finally:
        fi.clear()
        _stop_lb(lb)


def test_replica_death_mid_stream_splices_bit_identical(fleet):
    """A real death: a fresh replica's engine is shut down under a live
    seeded stream once three frames reached the client; b resumes it and
    the bytes equal the uninterrupted stream's."""
    ref = _reference(fleet, SEEDED)
    victim = _start_replica()
    lb = _start_lb([_url(victim), _url(fleet["b"])], breaker=None)
    ok = _resumes("ok")
    killed = []

    def kill_after_three(frames):
        if frames >= 3 and not killed:
            killed.append(frames)
            victim.engine.shutdown()

    fi.activate("engine.step", mode="delay", delay=0.05)
    try:
        status, body, truncated = _stream(lb.server_address[1], SEEDED,
                                          on_frame=kill_after_three)
        assert killed and killed[0] < MT
        assert status == 200 and not truncated
        assert body == ref
        assert _await(lambda: _resumes("ok") == ok + 1)
    finally:
        fi.clear()
        _stop_lb(lb)
        _stop_replica(victim)
