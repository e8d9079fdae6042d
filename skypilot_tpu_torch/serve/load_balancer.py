"""The port's load balancer: the JAX package's ``serve/load_balancer.py``
(standard library only) on the port's metrics, request log, tracing and
fault points; it imports nothing of that package. Its metric families,
buckets, ``STPU_LB_*`` defaults, fault points and HTTP surface are
JAX's, so scrapers and tooling read either package's balancer the same
way, and either fronts either package's replicas. ``run_lb_process``
also takes a ``stop`` event, so a caller can end its sync loop.

    python -m skypilot_tpu_torch.serve.load_balancer --port 8000 \
        --controller-url http://127.0.0.1:8001 [--lb-policy prefix_affinity]

Load balancer: STREAMING HTTP reverse proxy over ready replicas.

Reference analog: sky/serve/load_balancer.py (FastAPI + httpx proxy,
RoundRobin select, request-rate reporting to the controller). Stdlib
implementation: ThreadingHTTPServer + urllib forwarding; the controller
runs in the same process, so replica sync and QPS reporting are shared
memory instead of the reference's periodic HTTP sync.

Responses are passed through CHUNK BY CHUNK as the replica produces
them — token streaming / SSE is table stakes for LLM serving, so the
proxy must never buffer a whole response: a replica response with a
Content-Length streams under it; one without (chunked upstream, e.g.
SSE) is re-chunked to the client with a flush per chunk.
"""
from __future__ import annotations

import hashlib
import http.client
import http.server
import json
import os
import random
import socketserver
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Set

from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import reqlog
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.serve.load_balancing_policies import LoadBalancingPolicy
from skypilot_tpu_torch.utils import fault_injection

_HOP_HEADERS = {"connection", "keep-alive", "transfer-encoding",
                "te", "trailer", "upgrade", "proxy-authorization",
                "proxy-authenticate", "host", "content-length"}

# Leading-chunk width for the request-record prefix hash — matches the
# loadgen shared-prefix granularity so derive_spec's reuse structure
# lines up with how schedules are built.
_PREFIX_HASH_TOKENS = 64

# Proxy-path metrics. Observed AFTER the upstream response completes —
# no metric lock is ever held during upstream I/O; the per-request cost
# on the hot path is the label-child dict lookup plus the observe.
_REQUESTS = metrics.counter(
    "stpu_lb_requests_total",
    "Requests proxied by the serve load balancer.",
    ("method", "code"))
_LATENCY = metrics.histogram(
    "stpu_lb_request_duration_seconds",
    "Wall time from request receipt to last proxied byte.",
    ("code",))
# Service-edge TTFT: receipt → FIRST upstream byte proxied. This is
# what a streaming client experiences as time-to-first-token —
# including LB queueing, retries, and upstream delays the replica's
# own stpu_engine_ttft_seconds cannot see — so the SLO ttft objective
# (observability/slo.py) evaluates THIS family. Buckets match the
# engine family so fleet-store quantiles stay comparable.
_TTFB = metrics.histogram(
    "stpu_lb_ttfb_seconds",
    "Wall time from request receipt to first proxied response byte "
    "(the service-edge TTFT a streaming client observes).",
    buckets=metrics.LATENCY_BUCKETS)
_STREAMED = metrics.histogram(
    "stpu_lb_streamed_bytes",
    "Response bytes streamed to the client per request.",
    buckets=(256, 1024, 4096, 16384, 65536, 262144, 1048576,
             4194304, 16777216))
_RETRIES = metrics.counter(
    "stpu_lb_upstream_retries_total",
    "Upstream attempts re-routed to another replica after a "
    "pre-first-byte failure.")
_RESUMES = metrics.counter(
    "stpu_lb_stream_resumes_total",
    "Mid-stream resume outcomes: ok (continuation spliced to [DONE]), "
    "failed (a resume attempt died), exhausted (budget spent without "
    "completing), no_replica (no peer left to resume on), evicted "
    "(journal over the byte cap — stream degraded to plain abort), "
    "client_closed (client died mid-splice).", ("outcome",))
_RESUME_GAP = metrics.histogram(
    "stpu_lb_resume_gap_seconds",
    "Client-visible stream stall during a mid-stream resume: upstream "
    "death to first spliced continuation byte (re-pick + re-prefill "
    "of the emitted prefix on the peer).",
    buckets=metrics.LATENCY_BUCKETS)
_BREAKER_STATE = metrics.gauge(
    "stpu_lb_breaker_state",
    "Per-replica circuit-breaker state: 0=closed 1=open 2=half-open.",
    ("replica",))
_BREAKER_EJECTIONS = metrics.counter(
    "stpu_lb_breaker_ejections_total",
    "Replica ejections by the circuit breaker (closed -> open "
    "transitions).", ("replica",))

# Bounded retry for PRE-first-byte upstream failures (after the first
# byte the status line already went out, so a full retry would corrupt
# the stream — that is what the resume journal below is for). Default 2
# extra attempts, each on a different replica.
DEFAULT_MAX_RETRIES = int(os.environ.get("STPU_LB_RETRIES", "2"))
# Reject request bodies above this before buffering them (413): the LB
# reads the whole body for content-aware routing, so a hostile/buggy
# client must not be able to OOM the proxy.
DEFAULT_MAX_BODY_BYTES = int(os.environ.get(
    "STPU_LB_MAX_BODY_BYTES", str(10 * 1024 * 1024)))
# Mid-stream resume budget: when a REPLICA dies mid-SSE (not the
# client), the LB re-submits prompt + emitted-so-far to a peer with the
# `resume` contract and splices the continuation into the same client
# stream — at most this many times per request. The engine's
# fold_in(seed, absolute_position) sampling keys make the continuation
# bit-identical to the uninterrupted run. 0 disables journaling +
# resume entirely (streams degrade to the pre-resume clean abort).
DEFAULT_STREAM_RESUMES = int(os.environ.get(
    "STPU_LB_STREAM_RESUMES", "1"))
# Global cap (MiB) on resume-journal memory across ALL in-flight
# streams. A stream whose journal cannot charge the budget is EVICTED:
# it keeps streaming but an upstream death degrades to the plain
# abort (outcome="evicted" on stpu_lb_stream_resumes_total).
DEFAULT_RESUME_JOURNAL_MB = float(os.environ.get(
    "STPU_LB_RESUME_JOURNAL_MB", "8"))


class CircuitBreaker:
    """Per-replica connect-failure ejection, ahead of the controller.

    The controller's probe/sync cycle eventually removes a dead replica
    from the ready set, but that takes a probe-failure streak plus a
    sync interval — seconds during which every Nth request eats a
    connect timeout. The breaker reacts at REQUEST granularity:
    ``threshold`` consecutive connect-level failures open the circuit
    (the replica is excluded from selection immediately); after a
    backoff the circuit turns half-open, letting live traffic probe it
    — one success closes it, one failure re-opens it with the backoff
    doubled (capped, jittered so a fleet of LBs doesn't re-probe in
    lockstep). If EVERY candidate is open, selection fails open and
    routes anyway: a likely-dead replica beats a guaranteed 502.

    State transitions mirror onto the ``stpu_lb_breaker_state`` gauge
    (0=closed 1=open 2=half-open) and closed->open edges count into
    ``stpu_lb_breaker_ejections_total``.
    """

    def __init__(self, threshold: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 backoff_cap: Optional[float] = None,
                 jitter: float = 0.25,
                 seed: Optional[int] = None):
        self.threshold = threshold if threshold is not None else int(
            os.environ.get("STPU_LB_BREAKER_THRESHOLD", "3"))
        self.backoff_base = backoff_base if backoff_base is not None \
            else float(os.environ.get("STPU_LB_BREAKER_BACKOFF", "2"))
        self.backoff_cap = backoff_cap if backoff_cap is not None \
            else float(os.environ.get("STPU_LB_BREAKER_BACKOFF_CAP",
                                      "60"))
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # url -> [state, consecutive_failures, open_until, backoff]
        self._replicas: Dict[str, list] = {}

    _CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"
    _STATE_VALUE = {_CLOSED: 0, _OPEN: 1, _HALF_OPEN: 2}

    def _set_state(self, url: str, entry: list, state: str) -> None:
        entry[0] = state
        _BREAKER_STATE.labels(replica=url).set(self._STATE_VALUE[state])

    def blocked(self, urls: List[str]) -> Set[str]:
        """The subset of ``urls`` currently ejected. An open circuit
        whose backoff has expired flips to half-open here (and is NOT
        blocked): the next request through it is the probe."""
        now = time.monotonic()
        out: Set[str] = set()
        with self._lock:
            for url in urls:
                entry = self._replicas.get(url)
                if entry is None or entry[0] == self._CLOSED:
                    continue
                if entry[0] == self._OPEN:
                    if now < entry[2]:
                        out.add(url)
                    else:
                        self._set_state(url, entry, self._HALF_OPEN)
        return out

    def record_failure(self, url: str) -> None:
        """A connect-level failure against ``url``."""
        with self._lock:
            entry = self._replicas.setdefault(
                url, [self._CLOSED, 0, 0.0, self.backoff_base])
            if entry[0] == self._HALF_OPEN:
                # Failed probe: re-open with the backoff doubled.
                entry[3] = min(entry[3] * 2, self.backoff_cap)
                self._open(url, entry)
                return
            entry[1] += 1
            if entry[0] == self._CLOSED and entry[1] >= self.threshold:
                _BREAKER_EJECTIONS.labels(replica=url).inc()
                self._open(url, entry)

    def _open(self, url: str, entry: list) -> None:
        delay = entry[3] * (1.0 + self.jitter * self._rng.random())
        entry[2] = time.monotonic() + delay
        self._set_state(url, entry, self._OPEN)

    def record_success(self, url: str) -> None:
        """``url`` answered (any HTTP status): close its circuit."""
        with self._lock:
            entry = self._replicas.get(url)
            if entry is None:
                return
            entry[1] = 0
            entry[3] = self.backoff_base
            if entry[0] != self._CLOSED:
                self._set_state(url, entry, self._CLOSED)

    def state(self, url: str) -> str:
        with self._lock:
            entry = self._replicas.get(url)
            return entry[0] if entry is not None else self._CLOSED

    def prune(self, urls: List[str]) -> None:
        """Forget replicas no longer in the ready set (their gauge
        series reads closed so a torn-down replica doesn't linger as
        'open' on dashboards forever)."""
        keep = set(urls)
        with self._lock:
            for url in list(self._replicas):
                if url not in keep:
                    del self._replicas[url]
                    _BREAKER_STATE.labels(replica=url).set(0)


def write_chunk(wfile, data: bytes) -> None:
    """One HTTP/1.1 chunked-transfer frame, flushed immediately (shared
    by the LB proxy and the serve_llm SSE endpoint)."""
    wfile.write(f"{len(data):x}\r\n".encode())
    wfile.write(data)
    wfile.write(b"\r\n")
    wfile.flush()


def end_chunks(wfile) -> None:
    """Chunked-transfer terminator."""
    wfile.write(b"0\r\n\r\n")
    wfile.flush()


def _is_timeout(exc: BaseException) -> bool:
    """True if ``exc`` is a timeout, however urllib wrapped it (the
    exception itself, its URLError .reason, or its __cause__ chain).
    Shared by every breaker-charging branch so mid-stream and
    pre-first-byte failures can never diverge on what 'slow' means."""
    seen = 0
    while exc is not None and seen < 4:
        if isinstance(exc, TimeoutError):
            return True
        exc = getattr(exc, "reason", None) or exc.__cause__
        seen += 1
    return False


class _UpstreamAborted(Exception):
    """Mid-stream failure attributable to the REPLICA (the upstream
    read died), as opposed to the client hanging up (a write-side
    error). The distinction matters twice over: the circuit breaker
    charges a replica that accepts connections and dies mid-generation
    (never a client closing its SSE tab), and the resume journal only
    splices a continuation for upstream deaths — a gone client has
    nothing left to resume for."""


def _sse_token(event: bytes) -> Optional[int]:
    """The token id carried by one complete SSE event (``data:
    {"token": N}\\n\\n``), or None for [DONE] / non-token events."""
    if not event.startswith(b"data: "):
        return None
    payload = event[6:].strip()
    if payload == b"[DONE]":
        return None
    try:
        return int(json.loads(payload)["token"])
    except (ValueError, KeyError, TypeError):
        return None


class JournalAccount:
    """Global byte budget shared by every live stream journal — the
    resume feature's memory footprint is bounded regardless of how
    many long streams are in flight at once."""

    def __init__(self, cap_bytes: Optional[int] = None):
        self.cap = cap_bytes if cap_bytes is not None else int(
            DEFAULT_RESUME_JOURNAL_MB * 1024 * 1024)
        self._lock = threading.Lock()
        self._bytes = 0

    def charge(self, n: int) -> bool:
        with self._lock:
            if self._bytes + n > self.cap:
                return False
            self._bytes += n
            return True

    def release(self, n: int) -> None:
        with self._lock:
            self._bytes = max(0, self._bytes - n)

    def used(self) -> int:
        with self._lock:
            return self._bytes


class StreamJournal:
    """Per-request resume state while the LB proxies an SSE stream.

    Holds everything needed to re-submit the generation to a peer if
    the upstream dies mid-stream: the original request document
    (prompt, seed, temperature, max_tokens) plus every token event
    already forwarded to the client. ``resume_body()`` re-materializes
    the request with the `resume: {emitted, pos}` extension; the
    engine re-prefills the emitted tokens and continues emitting at
    the same absolute positions with the original seed, so the splice
    is bit-identical to the uninterrupted run.

    Memory is charged against the shared :class:`JournalAccount`; a
    charge failure EVICTS the journal (the stream keeps proxying but
    can no longer resume — bounded memory beats unbounded promises).
    """

    TOKEN_BYTES = 8  # conservative per-token journal cost estimate

    def __init__(self, request: dict, doc: dict, budget: int,
                 account: JournalAccount):
        self.request = request  # routing dict {path, body}
        self.doc = doc  # parsed original /generate body
        self.budget = budget  # resume attempts remaining
        self.account = account
        self.tried: Set[str] = set()
        self.emitted: List[int] = []
        self.evicted = False
        self._charged = 0
        if not self._charge(len(request.get("body") or b"") + 64):
            self.evict()

    def _charge(self, n: int) -> bool:
        if not self.account.charge(n):
            return False
        self._charged += n
        return True

    def append(self, tok: int) -> None:
        if self.evicted:
            return
        if not self._charge(self.TOKEN_BYTES):
            self.evict()
            return
        self.emitted.append(tok)

    def evict(self) -> None:
        if not self.evicted:
            self.evicted = True
            _RESUMES.labels(outcome="evicted").inc()
            self.release()

    def release(self) -> None:
        if self._charged:
            self.account.release(self._charged)
            self._charged = 0

    def can_resume(self) -> bool:
        return not self.evicted and self.budget > 0

    def resume_body(self) -> bytes:
        """The re-submission payload: the original request before any
        token went out (plain re-submit — nothing to dedupe), the
        `resume` extension after."""
        if not self.emitted:
            return self.request["body"]
        doc = dict(self.doc)
        doc["resume"] = {"emitted": list(self.emitted),
                         "pos": len(self.emitted)}
        return json.dumps(doc).encode()


# Journal budget for bare handler subclasses that don't provision
# their own (run_load_balancer / run_lb_process install a fresh one
# per server so tests and multi-LB processes stay isolated).
_GLOBAL_JOURNAL_ACCOUNT = JournalAccount()


class RequestRecorder:
    """Thread-safe sink of request timestamps, drained by the autoscaler
    each controller tick (reference: LB reports qps to controller)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._timestamps: List[float] = []

    def record(self) -> None:
        with self._lock:
            self._timestamps.append(time.time())

    def record_many(self, timestamps: List[float]) -> None:
        """Adopt timestamps drained by a remote LB process (sync RPC) —
        preserved, not re-stamped, so QPS windows stay accurate."""
        with self._lock:
            self._timestamps.extend(float(t) for t in timestamps)

    def drain(self) -> List[float]:
        with self._lock:
            out, self._timestamps = self._timestamps, []
            return out


class _ProxyHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    policy: LoadBalancingPolicy = None  # set by make_handler
    recorder: RequestRecorder = None
    # Per-replica circuit breaker (None disables: a bare handler
    # subclass behaves as before). Shared at class level — one breaker
    # per LB server, like the policy.
    breaker: Optional[CircuitBreaker] = None
    max_retries: int = DEFAULT_MAX_RETRIES
    max_body_bytes: int = DEFAULT_MAX_BODY_BYTES
    # Mid-stream resume: attempts per request (0 disables journaling)
    # and the shared journal byte budget (None = module-global).
    max_stream_resumes: int = DEFAULT_STREAM_RESUMES
    journal_account: Optional[JournalAccount] = None
    # Per-service upstream (replica) timeout; the sync loop overwrites
    # this from the controller's spec (service_spec.py
    # upstream_timeout_seconds) so slow-first-byte services (cold model
    # compile, long prompts) aren't 502'd at an arbitrary 120s.
    upstream_timeout: float = 120.0
    # Latest Prometheus snapshot of the CONTROLLER process's registry
    # (autoscaler decisions, replica-state gauges) — rides the /sync
    # reply in LB-as-a-process mode and is merged into /metrics.
    controller_metrics_text: str = ""
    # Controller sync-server URL (LB-as-a-process mode): GET /fleet on
    # the service endpoint is forwarded there, where the fleet
    # telemetry store lives. Empty = no controller (bare in-process
    # LB) → /fleet answers 503.
    controller_url: str = ""

    def log_message(self, fmt, *args):  # quiet
        del fmt, args

    def _serve_metrics(self) -> None:
        """GET /metrics: this process's registry merged with the
        controller's latest snapshot AND each ready replica's own
        /metrics (decode-engine slot/queue/token families), so one
        scrape of the service endpoint covers the whole serving stack.
        merge_text drops duplicate families (the controller imports
        this module, so zero-valued stpu_lb_* copies exist over there;
        with >1 replica the first replica's engine families win — a
        per-replica label would need a rewriting merge). Scrapes are
        not counted as proxied requests."""
        text = metrics.merge_text(metrics.render(),
                                  self.controller_metrics_text)
        for doc in self._scrape_replicas():
            text = metrics.merge_text(text, doc)
        body = text.encode()
        self.send_response(200)
        self.send_header("Content-Type", metrics.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _replica_urls(self) -> List[str]:
        try:
            return self.policy.ready_replicas()
        except NotImplementedError:
            return []

    def _fetch_replicas(self, path: str, timeout: float = 2.0,
                        urls: Optional[List[str]] = None,
                        errors: Optional[Dict[str, str]] = None
                        ) -> Dict[str, str]:
        """Fetch ``path`` from each ready replica CONCURRENTLY, so
        fetch latency is bounded by one timeout, not timeout x
        replicas (a wave of mid-restart replicas must not stall the
        caller). Unreachable replicas / missing endpoints are skipped.
        Returns url -> response text. ``urls`` lets the caller pin one
        snapshot of the ready set (it can change under a concurrent
        controller sync). A caller-provided ``errors`` dict collects
        url -> failure string for the skipped replicas (the degraded
        /perf merge reports them instead of silently dropping them);
        a thread still running at join-timeout is recorded there too."""
        if urls is None:
            urls = self._replica_urls()
        if not urls:
            return {}
        docs: Dict[str, str] = {}

        def fetch(url: str) -> None:
            try:
                with urllib.request.urlopen(
                        url.rstrip("/") + path,
                        timeout=timeout) as resp:
                    docs[url] = resp.read().decode("utf-8", "replace")
            except Exception as e:  # noqa: stpu-except — best-effort scrape; an unreachable replica just contributes no doc
                if errors is not None:
                    errors[url] = f"{type(e).__name__}: {e}"

        threads = [threading.Thread(target=fetch, args=(u,),
                                    daemon=True) for u in urls]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout + 0.5)
        if errors is not None:
            for url in urls:
                if url not in docs and url not in errors:
                    errors[url] = "timeout: no response within scrape "
                    errors[url] += "window"
        return docs

    def _scrape_replicas(self, timeout: float = 2.0) -> List[str]:
        """Each ready replica's /metrics exposition, replica order.
        The url list is snapshotted ONCE — re-reading it for ordering
        would drop a fetched doc whose replica a concurrent controller
        sync just rotated out."""
        urls = self._replica_urls()
        docs = self._fetch_replicas("/metrics", timeout=timeout,
                                    urls=urls)
        return [docs[u] for u in urls if u in docs]

    def _serve_perf(self) -> None:
        """GET /perf: every ready replica's step-telemetry snapshot
        (observability/stepstats.py — phase breakdown, occupancy,
        sampled dispatch/device split) merged into ONE JSON document
        keyed by replica URL, plus a cross-replica aggregate — the
        /metrics merge pattern applied to the perf view, so one fetch
        of the service endpoint covers the whole serving stack."""
        import json as json_lib
        replicas: Dict[str, dict] = {}
        healthy: Dict[str, dict] = {}
        errors: Dict[str, str] = {}
        for url, text in self._fetch_replicas(
                "/perf", errors=errors).items():
            try:
                doc = json_lib.loads(text)
            except ValueError:
                errors[url] = "invalid JSON from /perf"
                continue
            if isinstance(doc, dict):
                healthy[url] = replicas[url] = doc
            else:
                errors[url] = "non-object /perf document"
        # A replica that timed out mid-scrape (or answered garbage) is
        # REPORTED, not silently dropped: it appears under `replicas`
        # with an error marker and is excluded from the aggregate so
        # the healthy fleet's numbers aren't diluted by zeros.
        for url, err in errors.items():
            replicas[url] = {"error": err}
        agg: Dict[str, object] = {"replicas": len(healthy)}
        if errors:
            agg["errors"] = len(errors)
        phases: Dict[str, Dict[str, float]] = {}
        tok = {"prefill": 0.0, "decode": 0.0}
        busy = []
        for doc in healthy.values():
            for p, d in (doc.get("phases") or {}).items():
                slot = phases.setdefault(p, {"steps": 0,
                                             "seconds": 0.0})
                slot["steps"] += int(d.get("steps", 0))
                slot["seconds"] += float(d.get("seconds", 0.0))
            for p in tok:
                tok[p] += float(
                    (doc.get("tokens_per_sec") or {}).get(p, 0.0))
            if doc.get("steps"):
                busy.append(float(doc.get("busy_fraction", 0.0)))
        agg["phases"] = phases
        agg["tokens_per_sec"] = {p: round(v, 1)
                                 for p, v in tok.items()}
        if busy:
            agg["busy_fraction_mean"] = round(sum(busy) / len(busy), 4)
        body = json_lib.dumps({"replicas": replicas,
                               "aggregate": agg}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _proxy(self, method: str) -> None:
        self.recorder.record()
        t0 = time.perf_counter()
        stats = {"code": 0, "bytes": 0, "t0": t0}
        # Root span of the request's trace (tracing.ENABLED guard =
        # zero tracing cost unarmed). A client that is itself traced
        # (e.g. a traced launch curling the endpoint) parents us via
        # the X-STPU-Trace header; otherwise the LB is the root.
        span = None
        if tracing.ENABLED:
            span = tracing.start_span(
                "lb.request", kind="lb",
                parent=tracing.extract(self.headers),
                attrs={"method": method, "path": self.path})
        if reqlog.ENABLED:
            # LB half of the wide-event request record
            # (observability/reqlog.py). The request id IS the trace
            # id when one exists (the span's, or an inbound header
            # from an upper tier); otherwise reqlog mints one and
            # _proxy_to rides it on X-STPU-Trace (sampled flag 00) so
            # the engine half joins by the same key.
            sctx = span.context() if span is not None else None
            if sctx is None:
                sctx = tracing.extract(self.headers)
            stats["reqlog"] = {
                "request_id": (sctx.trace_id if sctx is not None
                               else reqlog.mint_id()),
                "ts": time.time(),
                "method": method,
                "path": self.path.split("?", 1)[0],
                "trace_sampled": bool(sctx is not None
                                      and sctx.sampled),
            }
        try:
            self._proxy_inner(method, stats, span)
        finally:
            # A stream dying after the upstream's 2xx status line went
            # out must not read as a clean 200 — and WHO died matters:
            # "upstream_aborted" (replica death the resume ladder could
            # not heal) is an error the SLO burn charges us for;
            # "client_closed" (the client hung up) is not our failure.
            aborted = (stats.get("upstream_aborted")
                       or stats.get("client_closed"))
            code = ("upstream_aborted" if stats.get("upstream_aborted")
                    else "client_closed" if stats.get("client_closed")
                    else str(stats["code"] or 0))
            _REQUESTS.labels(method=method, code=code).inc()
            _LATENCY.labels(code=code).observe(
                time.perf_counter() - t0)
            _STREAMED.observe(stats["bytes"])
            if reqlog.ENABLED and stats.get("reqlog") is not None:
                rlog = stats["reqlog"]
                rlog["status"] = code
                rlog["e2e_s"] = round(time.perf_counter() - t0, 6)
                rlog["bytes_streamed"] = stats["bytes"]
                rlog["retries"] = max(rlog.get("attempts", 1) - 1, 0)
                rlog.setdefault("resumed", False)
                reqlog.write_record(rlog)
            if span is not None:
                span.end(status=("error" if aborted else "ok"),
                         code=code, bytes=stats["bytes"])

    def _send_plain(self, code: int, payload: bytes,
                    stats: Dict[str, int]) -> None:
        self.send_response(code)
        stats["code"] = code
        if self.close_connection:
            # Tell the client too (413 leaves the body unread, so the
            # connection cannot be reused) — not just the server loop.
            self.send_header("Connection", "close")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)
        stats["bytes"] += len(payload)

    def _pick_replica(self, request: dict, tried: Set[str],
                      span=None) -> Optional[str]:
        """Policy selection with breaker-ejected replicas excluded.
        Fails OPEN when every untried replica is ejected: routing to a
        likely-dead replica beats a guaranteed 502."""
        if self.breaker is None:
            return self.policy.select_replica(request, exclude=tried)
        blocked = self.breaker.blocked(self._replica_urls())
        if span is not None and blocked:
            span.event("breaker_ejected", replicas=sorted(blocked))
        target = self.policy.select_replica(request,
                                            exclude=tried | blocked)
        if target is None and blocked - tried:
            if span is not None:
                span.event("breaker_fail_open")
            target = self.policy.select_replica(request, exclude=tried)
        return target

    def _proxy_inner(self, method: str, stats: Dict[str, int],
                     span=None) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        if length > self.max_body_bytes:
            # Refuse BEFORE buffering: the content-aware-routing body
            # read below would otherwise hold the whole payload in LB
            # memory per in-flight request. The unread body makes the
            # connection unusable for keep-alive — drop it.
            self.close_connection = True
            self._send_plain(413, b"Request body too large.\n", stats)
            return
        # Body read BEFORE replica selection: content-aware policies
        # (prefix affinity) route on the request payload.
        body = self.rfile.read(length) if length else None
        request = {"path": self.path, "body": body}
        rlog = stats.get("reqlog")
        if rlog is not None and body \
                and self.path.split("?", 1)[0] == "/generate":
            # Workload-shape fields for loadgen.derive_spec. The record
            # carries a hash of the LEADING prompt chunk (the shared-
            # prefix granularity), never prompt text/tokens — enough to
            # recover prefix-reuse structure, nothing to leak.
            try:
                doc = json.loads(body)
                prompt = [int(t) for t in doc.get("prompt") or []]
                rlog["prompt_tokens"] = len(prompt)
                rlog["max_tokens"] = int(doc.get("max_tokens", 16))
                rlog["temperature"] = float(doc.get("temperature", 0.0))
                rlog["stream"] = bool(doc.get("stream"))
                rlog["prefix_hash"] = hashlib.sha256(
                    json.dumps(prompt[:_PREFIX_HASH_TOKENS],
                               separators=(",", ":")).encode()
                ).hexdigest()[:16]
            except (ValueError, TypeError, KeyError):
                pass
        journal = self._maybe_journal(method, body, request)
        tried: Set[str] = set()
        attempts = 1 + max(self.max_retries, 0)
        try:
            for attempt in range(attempts):
                target = self._pick_replica(request, tried, span)
                if target is None:
                    break
                if attempt:
                    _RETRIES.inc()
                    if span is not None:
                        span.event("retry", attempt=attempt,
                                   target=target)
                if span is not None:
                    # The policy decision, annotated on every attempt:
                    # who was picked, by which policy, excluding whom.
                    span.event("select", target=target,
                               attempt=attempt,
                               policy=type(self.policy).__name__)
                if rlog is not None:
                    rlog["replica"] = target
                    rlog["policy"] = type(self.policy).__name__
                    rlog["attempts"] = attempt + 1
                tried.add(target)
                if journal is not None:
                    # The resume re-pick must exclude every replica
                    # this request already burned, pre-first-byte
                    # retries included.
                    journal.tried.add(target)
                # A retry only helps if another replica is left to try.
                can_retry = (attempt < attempts - 1 and
                             any(u not in tried
                                 for u in self._replica_urls()))
                try:
                    retry = self._proxy_to(target, method, body, stats,
                                           can_retry, span, journal)
                finally:
                    # Return the in-flight slot on every exit path
                    # (clean, HTTP error, aborted stream) —
                    # least-loaded accounting must not leak slots or a
                    # replica reads as busy forever.
                    self.policy.report_done(target)
                if not retry:
                    return
            if tried:
                self._send_plain(502, b"Replica unreachable.\n", stats)
            else:
                self._send_plain(503, b"No ready replicas.\n", stats)
        finally:
            if journal is not None:
                journal.release()

    def _maybe_journal(self, method: str, body: Optional[bytes],
                       request: dict) -> Optional[StreamJournal]:
        """A StreamJournal for requests the LB knows how to resume:
        streaming POST /generate with a parseable JSON body that is
        not ITSELF a resume re-submission (a resuming upstream LB tier
        owns that journal). Anything else proxies exactly as before."""
        if (self.max_stream_resumes <= 0 or method != "POST"
                or self.path.split("?", 1)[0] != "/generate"
                or not body):
            return None
        try:
            doc = json.loads(body)
        except ValueError:
            return None
        if (not isinstance(doc, dict) or not doc.get("stream")
                or doc.get("resume") is not None):
            return None
        return StreamJournal(
            request, doc, self.max_stream_resumes,
            self.journal_account or _GLOBAL_JOURNAL_ACCOUNT)

    def _proxy_to(self, target: str, method: str,
                  body: Optional[bytes], stats: Dict[str, int],
                  can_retry: bool = False, span=None,
                  journal: Optional[StreamJournal] = None) -> bool:
        """One upstream attempt. Returns True iff the attempt failed
        BEFORE the first response byte reached the client and the
        caller should retry on another replica; in every other case the
        response (success or error) has been sent — possibly completed
        by the mid-stream resume ladder when ``journal`` is armed."""
        url = target.rstrip("/") + self.path
        headers = {k: v for k, v in self.headers.items()
                   if k.lower() not in _HOP_HEADERS}
        if span is not None:
            # Context propagation to the replica: the replica's
            # generate/engine spans attach under this request's trace.
            ctx = tracing.format_ctx(span.context())
            if ctx:
                headers[tracing.HEADER] = ctx
        elif reqlog.ENABLED and stats.get("reqlog") is not None \
                and tracing.extract(self.headers) is None:
            # Tracing disarmed: the reqlog-minted request id still
            # rides X-STPU-Trace (sampled flag 00 — pure string work,
            # every replica tracing guard stays short-circuited) so
            # the engine assembles its record half under the same key.
            # An inbound header from an upper tier passes through
            # untouched above instead.
            headers[tracing.HEADER] = tracing.format_ctx(
                tracing.SpanContext(stats["reqlog"]["request_id"],
                                    reqlog.mint_id()[:16], False))
        req = urllib.request.Request(url, data=body, headers=headers,
                                     method=method)
        started: List[bool] = []
        try:
            if fault_injection.ENABLED:
                fault_injection.fire("lb.upstream", url=url)
            with urllib.request.urlopen(
                    req, timeout=self.upstream_timeout) as resp:
                stats["code"] = resp.status
                self._stream_response(resp, started, stats, journal)
            # Success recorded only after the WHOLE stream proxied:
            # recording at first byte would reset the consecutive count
            # right before a mid-stream failure increments it, so an
            # accept-then-die replica could never trip the breaker.
            if self.breaker is not None:
                self.breaker.record_success(target)
            return False
        except urllib.error.HTTPError as e:
            payload = e.read()
            # The replica ANSWERED — connect-wise it is healthy.
            if self.breaker is not None:
                self.breaker.record_success(target)
            if e.code == 503 and can_retry:
                # 503 is the one status that means "this replica can't
                # take the request right now" (draining engine, warming
                # model) while a peer can — and nothing was processed,
                # so re-routing is safe. Other statuses pass through.
                if span is not None:
                    span.event("reroute_503", target=target)
                return True
            self.send_response(e.code)
            stats["code"] = e.code
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            stats["bytes"] += len(payload)
            return False
        except _UpstreamAborted as e:
            # The REPLICA died mid-stream (upstream read failed —
            # http.client.IncompleteRead on a truncated body, reset,
            # etc). Charge its breaker (unless it was a read timeout:
            # slow ≠ dead, see below), then try the resume ladder: the
            # journal re-submits prompt + emitted-so-far to a peer and
            # splices the continuation into THIS client stream. Only
            # when that is off/evicted/exhausted does the request
            # degrade to the honest truncated-stream abort — a second
            # response would corrupt the bytes, so drop the connection.
            if self.breaker is not None and not _is_timeout(e):
                self.breaker.record_failure(target)
            if journal is not None and journal.can_resume():
                if self._resume_stream(journal, stats, span):
                    return False
            stats["upstream_aborted"] = True
            self.close_connection = True
            return False
        except (urllib.error.URLError, ConnectionError, OSError,
                TimeoutError, http.client.HTTPException) as e:
            if started:
                # Upstream reads are wrapped in _UpstreamAborted, so a
                # raw failure after `started` is the CLIENT side dying
                # (BrokenPipe on our wfile). Abort the proxying but do
                # NOT charge the replica — a closed SSE tab is not a
                # replica failure — and never resume: the journal only
                # heals upstream deaths; there is no client left to
                # splice for.
                stats["client_closed"] = True
                self.close_connection = True
                return False
            # Pre-first-byte failure. Timeouts feed the RETRY but not
            # the BREAKER: a replica whose first byte is slow under
            # load is very likely alive (cold compile, long prompt) —
            # three-striking it would eject healthy-slow replicas and
            # concentrate load on the rest, the breaker-cascade
            # failure mode. Dead replicas still eject via connect
            # refused/reset, and truly wedged ones fall to the
            # controller's probe path.
            if self.breaker is not None and not _is_timeout(e):
                self.breaker.record_failure(target)
            if span is not None:
                span.event("upstream_failed", target=target,
                           error=type(e).__name__)
            if can_retry:
                return True
            self._send_plain(502, b"Replica unreachable.\n", stats)
            return False

    def _read1(self, resp, stats: Optional[Dict[str, int]] = None
               ) -> bytes:
        """Upstream read, with failures re-raised as _UpstreamAborted
        so the caller can tell a dying REPLICA (this) from a dying
        CLIENT (raw write-side errors). Fault point ``lb.stream``
        fires per read (ctx carries the proxied byte count) — the
        game-day lever that kills a proxied stream after K reads."""
        try:
            if fault_injection.ENABLED:
                fault_injection.fire(
                    "lb.stream",
                    bytes=(stats or {}).get("bytes", 0))
            return resp.read1(65536)
        except (urllib.error.URLError, ConnectionError, OSError,
                TimeoutError, http.client.HTTPException) as e:
            raise _UpstreamAborted() from e

    def _stream_response(self, resp, started: List[bool],
                         stats: Dict[str, int],
                         journal: Optional[StreamJournal] = None
                         ) -> None:
        """Forward the replica's response as chunks ARRIVE (read1 =
        whatever bytes are available), never whole-response buffered.
        Appends to ``started`` before the first write so the caller can
        tell a clean failure from a mid-stream one. With a ``journal``
        armed the chunked (SSE) path forwards on EVENT boundaries
        instead of raw reads — the client's received bytes then always
        end at a whole event, the precondition for splicing a resumed
        continuation without corrupting the stream."""
        started.append(True)
        if "t0" in stats:
            _TTFB.observe(time.perf_counter() - stats["t0"])
            if stats.get("reqlog") is not None:
                # Client-visible TTFT for the request record (first
                # upstream byte = first token for a streaming client);
                # a retried request overwrites with the attempt that
                # actually delivered.
                stats["reqlog"]["ttft_s"] = round(
                    time.perf_counter() - stats["t0"], 6)
        self.send_response(resp.status)
        clen = resp.getheader("Content-Length")
        for k, v in resp.getheaders():
            if k.lower() not in _HOP_HEADERS:
                self.send_header(k, v)
        if clen is not None:
            self.send_header("Content-Length", clen)
            self.end_headers()
            while True:
                chunk = self._read1(resp, stats)
                if not chunk:
                    break
                self.wfile.write(chunk)
                self.wfile.flush()
                stats["bytes"] += len(chunk)
        else:
            # Chunked upstream (SSE/token streams): re-chunk, flushing
            # per chunk so the client sees tokens as they are produced.
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            if journal is not None:
                self._pump_sse(resp, journal, stats)
                end_chunks(self.wfile)
                return
            if reqlog.ENABLED and stats.get("reqlog") is not None \
                    and (resp.getheader("Content-Type") or ""
                         ).startswith("text/event-stream"):
                # Journal-less SSE with reqlog armed: the replica's
                # trailing stats frame must not leak to the client, so
                # forward on event boundaries (strip + fold) instead
                # of raw reads. Disarmed keeps the raw zero-parse path.
                self._pump_events(resp, stats)
                end_chunks(self.wfile)
                return
            while True:
                chunk = self._read1(resp, stats)
                if not chunk:
                    break
                write_chunk(self.wfile, chunk)
                stats["bytes"] += len(chunk)
            end_chunks(self.wfile)

    # --------------------------------------------- request-record folding
    def _fold_stats_frame(self, event: bytes,
                          stats: Dict[str, int]) -> None:
        """Fold a replica's trailing ``event: stats`` SSE frame (the
        engine half of the request record, emitted by serve_llm before
        [DONE]) into this request's LB half. A malformed frame is
        dropped — the record degrades to LB-only, same as a legacy
        replica that never emits one."""
        rlog = stats.get("reqlog")
        if rlog is None:
            return
        for line in event.split(b"\n"):
            if line.startswith(b"data: "):
                try:
                    half = json.loads(line[6:])
                except ValueError:
                    return
                if isinstance(half, dict):
                    rlog["engine"] = half
                return

    def _pump_events(self, resp, stats: Dict[str, int]) -> None:
        """Event-boundary forwarding for journal-less SSE while reqlog
        is armed: everything passes through verbatim except ``event:
        stats`` frames, which are folded into the request record. EOF
        flushes any residual partial event — unlike _pump_sse this
        path has no resume journal, so termination semantics stay
        those of the raw chunk loop (upstream EOF ends the stream;
        read failures raise _UpstreamAborted from _read1)."""
        buf = b""
        while True:
            chunk = self._read1(resp, stats)
            if not chunk:
                break
            buf += chunk
            while True:
                cut = buf.find(b"\n\n")
                if cut < 0:
                    break
                event, buf = buf[:cut + 2], buf[cut + 2:]
                if event.startswith(b"event: stats"):
                    self._fold_stats_frame(event, stats)
                    continue
                write_chunk(self.wfile, event)
                stats["bytes"] += len(event)
        if buf:
            write_chunk(self.wfile, buf)
            stats["bytes"] += len(buf)

    # ------------------------------------------------- mid-stream resume
    def _pump_sse(self, resp, journal: StreamJournal,
                  stats: Dict[str, int], skip: int = 0,
                  gap_t0: Optional[float] = None) -> None:
        """Forward an SSE upstream event-by-event (buffered to
        ``\\n\\n`` boundaries), recording every token event into the
        journal. Returns once the upstream's ``[DONE]`` event has been
        forwarded; an upstream EOF before [DONE] is a mid-stream death
        and raises _UpstreamAborted (the replica's own SSE endpoint
        only terminates cleanly after [DONE]). ``skip`` drops the
        first N token events — a continuation replica that replayed
        the overlap instead of honoring `resume` — verifying each
        against the journal: a mismatched overlap means the peer is
        NOT reproducing the original stream, and splicing it would
        corrupt the client bytes."""
        buf = b""
        skipped = 0
        while True:
            chunk = self._read1(resp, stats)
            if not chunk:
                raise _UpstreamAborted()
            buf += chunk
            while True:
                cut = buf.find(b"\n\n")
                if cut < 0:
                    break
                event, buf = buf[:cut + 2], buf[cut + 2:]
                if event.startswith(b"event: stats"):
                    # The replica's trailing request-record frame is
                    # LB-internal: fold it into the record half and
                    # never forward it (a resumed continuation's frame
                    # supersedes the dead upstream's — the half that
                    # actually finished the stream wins). Stripped
                    # even with reqlog disarmed here: this path is
                    # already event-parsing, and a frame the armed
                    # replica emitted is not part of the client
                    # contract.
                    self._fold_stats_frame(event, stats)
                    continue
                tok = _sse_token(event)
                if tok is not None and skipped < skip:
                    if (skipped >= len(journal.emitted)
                            or journal.emitted[skipped] != tok):
                        raise _UpstreamAborted()
                    skipped += 1
                    continue
                if tok is not None:
                    journal.append(tok)
                if gap_t0 is not None:
                    _RESUME_GAP.observe(
                        time.perf_counter() - gap_t0)
                    gap_t0 = None
                write_chunk(self.wfile, event)
                stats["bytes"] += len(event)
                if event.strip() == b"data: [DONE]":
                    return

    def _resume_stream(self, journal: StreamJournal,
                       stats: Dict[str, int], span=None) -> bool:
        """The resume ladder: splice continuation(s) from peers into
        the already-started client stream. Returns True iff the
        stream's fate was decided here (carried to [DONE], or the
        CLIENT died mid-splice); False degrades to the plain upstream
        abort in the caller."""
        rlog = stats.get("reqlog")
        if rlog is not None:
            # A resumed stream is always kept by the request log (the
            # tail-bias contract); the outcome fields update as the
            # ladder runs.
            rlog["resumed"] = True
        while journal.budget > 0:
            journal.budget -= 1
            gap_t0 = time.perf_counter()
            rspan = None
            if tracing.ENABLED and span is not None:
                rspan = tracing.start_span(
                    "lb.resume", kind="lb", parent=span.context(),
                    attrs={"pos": len(journal.emitted)})
            target = self._pick_replica(journal.request, journal.tried,
                                        rspan or span)
            if target is None:
                _RESUMES.labels(outcome="no_replica").inc()
                if rlog is not None:
                    rlog["resume_outcome"] = "no_replica"
                if rspan is not None:
                    rspan.end(status="error", outcome="no_replica")
                return False
            journal.tried.add(target)
            ok = False
            outcome = "failed"
            try:
                ok = self._splice_from(target, journal, stats, gap_t0)
                outcome = "ok" if ok else "failed"
            except _UpstreamAborted as e:
                # The continuation died mid-splice too: charge it and,
                # budget permitting, go around again — the client's
                # bytes still end at an event boundary.
                if self.breaker is not None and not _is_timeout(e):
                    self.breaker.record_failure(target)
            except (ConnectionError, OSError, TimeoutError):
                # Raw write-side failure = the CLIENT died mid-splice.
                # Nothing left to resume for.
                stats["client_closed"] = True
                self.close_connection = True
                _RESUMES.labels(outcome="client_closed").inc()
                if rlog is not None:
                    rlog["resume_outcome"] = "client_closed"
                if rspan is not None:
                    rspan.end(status="error", outcome="client_closed",
                              target=target)
                return True
            finally:
                # The resume attempt consumed a policy slot like any
                # admission.
                self.policy.report_done(target)
            _RESUMES.labels(outcome=outcome).inc()
            if rlog is not None:
                rlog["resume_outcome"] = outcome
            if rspan is not None:
                rspan.end(status="ok" if ok else "error",
                          outcome=outcome, target=target)
            if ok:
                return True
        _RESUMES.labels(outcome="exhausted").inc()
        if rlog is not None:
            rlog["resume_outcome"] = "exhausted"
        return False

    def _splice_from(self, target: str, journal: StreamJournal,
                     stats: Dict[str, int], gap_t0: float) -> bool:
        """One resume attempt against ``target``: re-submit the
        journaled request with the `resume` extension and pump the
        continuation into the client stream. Returns True iff the
        continuation reached [DONE] (client terminator sent); False
        for a clean upstream refusal (connect failure / non-200).
        Raises _UpstreamAborted if the continuation itself died
        mid-splice; raw OSErrors are client-side write failures and
        propagate to the caller."""
        url = target.rstrip("/") + self.path
        headers = {k: v for k, v in self.headers.items()
                   if k.lower() not in _HOP_HEADERS}
        headers["Content-Type"] = "application/json"
        req = urllib.request.Request(url, data=journal.resume_body(),
                                     headers=headers, method="POST")
        try:
            resp_ctx = urllib.request.urlopen(
                req, timeout=self.upstream_timeout)
        except urllib.error.HTTPError as e:
            e.read()
            # The peer ANSWERED (connect-wise healthy) — it just
            # refused the resume (e.g. draining). Not a breaker charge.
            return False
        except (urllib.error.URLError, ConnectionError, OSError,
                TimeoutError, http.client.HTTPException) as e:
            if self.breaker is not None and not _is_timeout(e):
                self.breaker.record_failure(target)
            return False
        with resp_ctx as resp:
            if resp.status != 200:
                return False
            # X-STPU-Resume acknowledges the resume admission: the
            # first event is already the continuation. A peer that
            # restarted from position 0 instead replays the overlap —
            # _pump_sse drops (and verifies) those events.
            honored = resp.getheader("X-STPU-Resume")
            skip = 0 if honored else len(journal.emitted)
            self._pump_sse(resp, journal, stats, skip=skip,
                           gap_t0=gap_t0)
            end_chunks(self.wfile)
            return True

    def _serve_fleet(self) -> None:
        """GET /fleet: forwarded to the controller's sync server (the
        fleet telemetry store is controller-resident; the LB just makes
        it reachable on the service endpoint). Not a proxied request —
        like /metrics and /perf, observability never counts as
        traffic."""
        if not self.controller_url:
            body = (b'{"error": "no controller attached; /fleet needs '
                    b'the LB-as-a-process mode"}')
            code = 503
        else:
            try:
                with urllib.request.urlopen(
                        self.controller_url.rstrip("/") + self.path,
                        timeout=5.0) as resp:
                    body = resp.read()
                    code = resp.status
            except urllib.error.HTTPError as e:
                body = e.read()
                code = e.code
            except Exception as e:  # noqa: stpu-except — a dead controller yields a clean 502 document, not a hung scrape
                body = json.dumps(
                    {"error": f"controller unreachable: "
                              f"{type(e).__name__}"}).encode()
                code = 502
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _serve_requests(self) -> None:
        """GET /requests[?limit=N]: the newest wide-event request
        records (observability/reqlog.py) from this LB's local
        requests.jsonl, newest last — lets `stpu requests SERVICE`
        read analytics without shell access to the LB host. Like
        /metrics and /perf, observability never counts as traffic.
        Serves whatever is on disk even when reqlog is currently
        disarmed (the file is the artifact, the flag gates writes)."""
        limit = 200
        if "?" in self.path:
            q = urllib.parse.parse_qs(self.path.split("?", 1)[1])
            try:
                limit = max(int(q.get("limit", ["200"])[0]), 1)
            except ValueError:
                pass
        records = reqlog.read()[-limit:]
        body = json.dumps(records, default=str).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/metrics":
            self._serve_metrics()
            return
        if self.path == "/perf":
            self._serve_perf()
            return
        if self.path.split("?", 1)[0] == "/requests":
            self._serve_requests()
            return
        if self.path.split("?", 1)[0] == "/fleet":
            self._serve_fleet()
            return
        self._proxy("GET")

    def do_POST(self):
        self._proxy("POST")

    def do_PUT(self):
        self._proxy("PUT")

    def do_DELETE(self):
        self._proxy("DELETE")


class _ThreadingHTTPServer(socketserver.ThreadingMixIn,
                           http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True


def run_load_balancer(port: int, policy: LoadBalancingPolicy,
                      recorder: RequestRecorder,
                      ready_event: Optional[threading.Event] = None
                      ) -> _ThreadingHTTPServer:
    """Start the LB server on a daemon thread; returns the server (call
    .shutdown() to stop)."""
    handler = type("Handler", (_ProxyHandler,),
                   {"policy": policy, "recorder": recorder,
                    "breaker": CircuitBreaker(),
                    "journal_account": JournalAccount()})
    server = _ThreadingHTTPServer(("0.0.0.0", port), handler)
    server.breaker = handler.breaker  # visible for tests/introspection
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    if ready_event is not None:
        ready_event.set()
    return server


# ---------------------------------------------------------- LB as a process
def run_lb_process(port: int, controller_url: str,
                   sync_interval: float,
                   policy_name: Optional[str] = None,
                   stop: Optional[threading.Event] = None) -> None:
    """Standalone LB process (reference: run_load_balancer,
    sky/serve/load_balancer.py:226 — a separate process from the
    controller, syncing over HTTP).

    Every ``sync_interval`` it POSTs drained request timestamps to the
    controller's /sync endpoint and adopts the returned ready-replica
    set. A dead/unreachable controller is NOT fatal: the LB keeps
    serving its last-known ready set — the data plane survives a
    control-plane crash (the blast-radius isolation the single-process
    design lacked).

    ``policy_name`` selects the routing policy
    (load_balancing_policies.POLICIES; service.py passes the service
    YAML's ``load_balancing_policy``); default env STPU_LB_POLICY or
    round_robin.

    ``stop`` (default: never) ends the loop once set: the server is shut
    down and closed before the call returns.
    """
    from skypilot_tpu_torch.serve.load_balancing_policies import make_policy
    policy = make_policy(policy_name
                         or os.environ.get("STPU_LB_POLICY"))
    recorder = RequestRecorder()
    breaker = CircuitBreaker()
    handler_cls = type("Handler", (_ProxyHandler,),
                       {"policy": policy, "recorder": recorder,
                        "breaker": breaker,
                        "journal_account": JournalAccount(),
                        # /fleet forwards to the controller, where the
                        # fleet telemetry store lives.
                        "controller_url": controller_url})
    server = _ThreadingHTTPServer(("0.0.0.0", port), handler_cls)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    stop = stop or threading.Event()
    try:
        while not stop.is_set():
            # Sync FIRST: the ready set should arrive as soon as the
            # controller has one, not one interval late.
            drained = recorder.drain()
            try:
                if fault_injection.ENABLED:
                    fault_injection.fire("controller.sync",
                                         controller=controller_url)
                req = urllib.request.Request(
                    controller_url.rstrip("/") + "/sync",
                    data=json.dumps(
                        {"request_timestamps": drained}).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=5) as resp:
                    payload = json.loads(resp.read())
                ready_urls = payload.get("ready_urls", [])
                policy.set_ready_replicas(ready_urls)
                # A replica the controller removed must not linger in the
                # breaker as a stuck-open series.
                breaker.prune(ready_urls)
                handler_cls.upstream_timeout = float(
                    payload.get("upstream_timeout", 120.0))
                # Controller-process metrics snapshot (autoscaler decisions,
                # replica-state gauges) for this LB's /metrics.
                handler_cls.controller_metrics_text = str(
                    payload.get("metrics_text", ""))
            except Exception:  # noqa: BLE001 — keep serving last-known set
                # Re-queue the drained timestamps: a transiently unreachable
                # controller must not erase QPS signal (the autoscaler would
                # scale below real demand).
                recorder.record_many(drained)
            stop.wait(sync_interval)
    finally:
        server.shutdown()
        server.server_close()


def main() -> None:
    import argparse
    parser = argparse.ArgumentParser()
    from skypilot_tpu_torch.serve import load_balancing_policies
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--controller-url", required=True)
    parser.add_argument("--sync-interval", type=float, default=2.0)
    parser.add_argument(
        "--lb-policy",
        choices=sorted(load_balancing_policies.POLICIES), default=None,
        help="replica routing policy (default env STPU_LB_POLICY or "
             "round_robin; prefix_affinity pins shared-prefix traffic "
             "to the replica whose KV prefix cache is warm)")
    args = parser.parse_args()
    run_lb_process(args.port, args.controller_url, args.sync_interval,
                   policy_name=args.lb_policy)


if __name__ == "__main__":
    main()
