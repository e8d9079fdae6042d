"""The port's load generator: the JAX package's ``benchmark/loadgen.py``
(standard library only) on the port's promtext, event log and fault
points; it imports nothing of that package. Schedules, their digests
and ``schedule.json`` files are byte for byte JAX's for the same spec
and seed (either package's ``load_schedule`` reads the other's file),
and the report's keys are JAX's. Runs land under the port's
``utils/paths.home()``, as JAX's under its own. There is no CLI here:
``decode_bench --mode loadgen`` and ``--mode chaos`` drive it, and the
JAX package's ``stpu loadgen`` drives any endpoint.

Open-loop, trace-driven load generator with SLO reports.

Reference analogs: the LoadGen harness of MLPerf Inference (open-loop
Poisson "server" scenario — the arrival process never waits for the
system under test, so a slow stack accumulates queue instead of
silently throttling the offered load) and vLLM's benchmark_serving.py
(client-side TTFT/TPOT from the streamed tokens). bench.py measures
engines in ISOLATION and the chaos tests inject single faults; this is
the missing piece that drives the full LB -> replica -> engine stack
the way a million users would, and turns the histograms the stack
already exports into SLO VERDICTS.

Three layers, each usable alone:

* **Schedule** — ``build_schedule(spec)`` expands a ``LoadSpec`` into a
  concrete trace: per-request arrival offset, prompt token ids, token
  budget, sampling seed. Everything is derived from ONE seeded RNG, so
  the same spec + seed replays bit-identically (``schedule_digest``
  pins it) — a latency regression seen in production traffic shapes
  can be handed to a teammate as ``--mix chat --qps 50 --seed 7``.
  Mixes: ``chat`` (a few shared system prompts + unique tails — the
  prefix-cache/affinity shape), ``long_context`` (long prompts, short
  outputs — prefill-dominated), ``bursty`` (chat content under a
  diurnal rate wave). Arrivals: ``poisson`` (memoryless, the
  open-loop default), ``ramp`` (rate climbs linearly across the run —
  finds the knee), ``uniform`` (fixed spacing — isolates queueing from
  arrival variance).

* **Driver** — ``run(target, spec)`` fires the schedule at a live
  stack over HTTP (POST /generate, SSE streaming), OPEN LOOP: requests
  launch at their scheduled instant no matter how many are still in
  flight. Client-observed TTFT / TPOT / end-to-end latency per request;
  meanwhile a run-scoped scraper thread snapshots the target's
  ``/metrics`` every ``scrape_interval`` seconds into a JSONL time
  series (``metrics.jsonl`` in the run dir, same append path as the
  events/traces sinks) parsed via ``observability/promtext.py``.
  ``faults=...`` arms the deterministic chaos seams
  (utils/fault_injection.py) ``faults_at`` seconds INTO the run — an
  in-process stack (tests, serve_llm --lb-port, the bench leg)
  degrades mid-run and the report shows it; remote stacks arm via
  STPU_FAULTS in their own environment instead.

* **Report** — client percentiles + achieved-vs-offered QPS +
  goodput-under-SLO (the fraction of ALL scheduled requests that
  completed AND met ``--slo-ttft``/``--slo-tpot``; errors and drops
  count against it), cross-checked with SERVER-side percentiles
  interpolated from the first/last Prometheus histogram snapshots
  (engine TTFT, LB latency) and LB retry/breaker/status counters over
  the run window. Written as ``report.json`` for machines
  (bench_compare gates ``{family}_slo_goodput`` / ``{family}_p99_ttft_s``
  on it) and rendered by ``stpu loadgen report`` for humans. With
  tracing armed (STPU_TRACE=1) every request the LB handles carries a
  span tree, so a slow p99 in the report links to concrete
  ``stpu trace show`` timelines from the same window.

Stdlib-only; no jax import — the generator must run from a laptop
against a remote endpoint.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import threading
import time
import urllib.error
import urllib.request
from random import Random
from typing import Any, Dict, List, Optional, Tuple

from skypilot_tpu_torch.observability import events
from skypilot_tpu_torch.observability import jsonl_log
from skypilot_tpu_torch.observability import promtext
from skypilot_tpu_torch.utils import fault_injection

MIXES = ("chat", "long_context", "bursty")
ARRIVALS = ("poisson", "ramp", "uniform")

# Rotation cap for the per-run metrics time series (jsonl_log): a
# pathological day-long scrape must not fill the disk.
_SERIES_MAX_BYTES = 64 * 1024 * 1024

# Server-side histogram families the report interpolates percentiles
# from (engine TTFT rides the LB /metrics via the replica scrape).
_TTFT_FAMILY = "stpu_engine_ttft_seconds"
_LB_LATENCY_FAMILY = "stpu_lb_request_duration_seconds"


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """A replayable workload: (spec, seed) fully determines the trace."""
    mix: str = "chat"
    arrival: str = "poisson"
    qps: float = 8.0                 # base offered arrival rate
    duration_s: float = 10.0
    seed: int = 0
    # chat / bursty mixes: shared system prompts.
    shared_prefix: int = 64          # tokens per shared prefix (one
    #                                  engine prefill chunk = cacheable)
    n_prefixes: int = 4              # distinct system prompts in play
    prompt_tokens: int = 96          # mean TOTAL chat prompt length
    # long_context mix: prefill-heavy prompts.
    long_prompt_tokens: int = 640    # mean long-context prompt length
    max_prompt_tokens: int = 960     # hard cap (serve_llm caps at 1024)
    max_tokens: int = 32             # per-request decode budget cap
    temperature: float = 0.0
    vocab: int = 32000
    # bursty mix: diurnal wave on top of the arrival process.
    burst_factor: float = 4.0        # peak rate = burst_factor x qps
    burst_period_s: float = 4.0      # one trough->peak->trough cycle

    def validate(self) -> "LoadSpec":
        if self.mix not in MIXES:
            raise ValueError(f"unknown mix {self.mix!r}; one of {MIXES}")
        if self.arrival not in ARRIVALS:
            raise ValueError(
                f"unknown arrival {self.arrival!r}; one of {ARRIVALS}")
        if self.qps <= 0 or self.duration_s <= 0:
            raise ValueError("qps and duration_s must be positive")
        return self


@dataclasses.dataclass(frozen=True)
class ScheduledRequest:
    index: int
    at: float                        # seconds after run start
    prompt: Tuple[int, ...]
    max_tokens: int
    temperature: float
    seed: int                        # per-request sampling seed


def _rate_at(spec: LoadSpec, t: float) -> float:
    """Instantaneous arrival rate. The bursty mix modulates the base
    rate with a raised-cosine diurnal wave (troughs at cycle edges,
    ``burst_factor`` x qps at the crest); ramp climbs linearly from
    25% to 175% of qps across the run so one trace sweeps the knee."""
    rate = spec.qps
    if spec.arrival == "ramp":
        rate = spec.qps * (0.25 + 1.5 * min(t / spec.duration_s, 1.0))
    if spec.mix == "bursty":
        phase = 0.5 * (1.0 - math.cos(
            2.0 * math.pi * t / max(spec.burst_period_s, 1e-6)))
        rate *= 1.0 + (spec.burst_factor - 1.0) * phase
    return max(rate, 1e-6)


def _prefixes(spec: LoadSpec) -> List[List[int]]:
    """The mix's shared system prompts — derived from the seed alone
    (NOT the arrival RNG), so two specs differing only in qps/duration
    still share prompt identity and a replica cache warmed by one trace
    is warm for the other."""
    out = []
    for i in range(max(spec.n_prefixes, 1)):
        rng = Random(f"{spec.seed}/prefix/{i}")
        out.append([rng.randrange(1, spec.vocab)
                    for _ in range(spec.shared_prefix)])
    return out


def build_schedule(spec: LoadSpec) -> List[ScheduledRequest]:
    """Expand the spec into a concrete, replayable trace. One RNG,
    seeded by ``spec.seed``, drives arrivals AND content in a fixed
    draw order — the bit-identical-replay contract the smoke test
    pins."""
    spec.validate()
    rng = Random(f"{spec.seed}/schedule")
    prefixes = _prefixes(spec)
    out: List[ScheduledRequest] = []
    t = 0.0
    index = 0
    while True:
        rate = _rate_at(spec, t)
        if spec.arrival == "uniform":
            gap = 1.0 / rate
        else:
            gap = rng.expovariate(rate)
        t += gap
        if t >= spec.duration_s:
            break
        if spec.mix == "long_context":
            lo = max(spec.long_prompt_tokens // 2, 16)
            hi = min(spec.long_prompt_tokens * 3 // 2,
                     spec.max_prompt_tokens)
            prompt = [rng.randrange(1, spec.vocab)
                      for _ in range(rng.randint(lo, max(hi, lo)))]
            max_tokens = rng.randint(1, max(spec.max_tokens // 4, 1))
        else:
            prefix = prefixes[rng.randrange(len(prefixes))]
            tail_budget = max(spec.prompt_tokens - len(prefix), 8)
            tail = [rng.randrange(1, spec.vocab)
                    for _ in range(rng.randint(4, tail_budget))]
            prompt = (prefix + tail)[:spec.max_prompt_tokens]
            max_tokens = rng.randint(max(spec.max_tokens // 4, 1),
                                     max(spec.max_tokens, 1))
        out.append(ScheduledRequest(
            index=index, at=t, prompt=tuple(prompt),
            max_tokens=max_tokens, temperature=spec.temperature,
            seed=rng.getrandbits(32)))
        index += 1
    return out


def schedule_digest(schedule: List[ScheduledRequest]) -> str:
    """sha256 over the full schedule content (arrival offsets at full
    float precision, prompts, budgets, seeds) — equal digests mean
    bit-identical traces."""
    doc = [[r.index, repr(r.at), list(r.prompt), r.max_tokens,
            repr(r.temperature), r.seed] for r in schedule]
    return hashlib.sha256(
        json.dumps(doc, separators=(",", ":")).encode()).hexdigest()


def save_schedule(path: str, spec: LoadSpec,
                  schedule: List[ScheduledRequest]) -> str:
    """Write a schedule.json (the spec that produced the trace, the
    pinned digest, and every concrete request) — the interchange
    format ``run()`` emits per run dir, ``--schedule`` reads back, and
    ``stpu loadgen capture`` synthesizes from captured records.
    Returns the digest."""
    digest = schedule_digest(schedule)
    with open(path, "w") as f:
        json.dump({
            "spec": dataclasses.asdict(spec),
            "digest": digest,
            "requests": [
                {"index": r.index, "at": r.at,
                 "prompt": list(r.prompt), "max_tokens": r.max_tokens,
                 "temperature": r.temperature, "seed": r.seed}
                for r in schedule],
        }, f)
    return digest


def load_schedule(path: str
                  ) -> Tuple[LoadSpec, List[ScheduledRequest], str]:
    """Read a saved schedule.json back into a runnable trace. The
    pinned digest is VERIFIED against the loaded content (float
    offsets survive the JSON round-trip exactly), so a hand-edited or
    truncated file fails loudly instead of silently benchmarking a
    different workload."""
    with open(path, "r") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "requests" not in doc:
        raise ValueError(f"{path}: not a schedule.json")
    known = {f.name for f in dataclasses.fields(LoadSpec)}
    spec = LoadSpec(**{k: v for k, v in (doc.get("spec") or {}).items()
                       if k in known})
    schedule = [ScheduledRequest(
        index=int(r["index"]), at=float(r["at"]),
        prompt=tuple(int(t) for t in r["prompt"]),
        max_tokens=int(r["max_tokens"]),
        temperature=float(r.get("temperature", 0.0)),
        seed=int(r["seed"]))
        for r in doc["requests"]]
    digest = schedule_digest(schedule)
    pinned = doc.get("digest")
    if pinned and pinned != digest:
        raise ValueError(
            f"{path}: content does not match its pinned digest "
            f"(expected {str(pinned)[:12]}…, recomputed "
            f"{digest[:12]}…) — the file was edited or truncated")
    return spec, schedule, digest


# ------------------------------------------------------ capture bridge
def derive_spec(records: List[Dict[str, Any]]) -> LoadSpec:
    """Fit a LoadSpec to captured request records (observability/
    reqlog.py) — the capture→replay bridge: arrival rate and
    burstiness from the record timestamps, prompt-length and
    max-tokens mix from the workload-shape fields, and prefix-reuse
    structure from the leading-chunk hashes (the records never carry
    prompt text, so replay prompts are SYNTHESIZED with the same
    sharing structure, not replayed verbatim). Deterministic: the
    same records — in any order — derive the identical spec, and
    therefore (via build_schedule) a bit-identical schedule digest."""
    reqs = sorted(
        (r for r in records
         if r.get("path") == "/generate"
         and isinstance(r.get("prompt_tokens"), int)),
        key=lambda r: (float(r.get("ts", 0.0)),
                       str(r.get("request_id", ""))))
    if not reqs:
        raise ValueError(
            "no /generate records with workload-shape fields — was "
            "the capture run made with STPU_REQLOG=1 at the LB?")
    ts = [float(r.get("ts", 0.0)) for r in reqs]
    span = max(ts) - min(ts)
    duration = max(round(span, 3), 1.0)
    qps = round(len(reqs) / duration, 3)
    # Burstiness: coefficient of variation of the inter-arrival gaps.
    # Poisson arrivals sit near 1; a diurnal/bursty capture runs well
    # above it.
    gaps = [b - a for a, b in zip(ts, ts[1:]) if b >= a]
    cov = 0.0
    if len(gaps) >= 2:
        mean = sum(gaps) / len(gaps)
        if mean > 1e-9:
            var = sum((g - mean) ** 2 for g in gaps) / len(gaps)
            cov = math.sqrt(var) / mean
    plens = [int(r["prompt_tokens"]) for r in reqs]
    mean_plen = sum(plens) / len(plens)
    hashes = {r.get("prefix_hash") for r in reqs
              if r.get("prefix_hash")}
    max_tokens = max((int(r["max_tokens"]) for r in reqs
                      if isinstance(r.get("max_tokens"), int)),
                     default=32)
    temps = [float(r["temperature"]) for r in reqs
             if isinstance(r.get("temperature"), (int, float))]
    if mean_plen > 320:
        mix = "long_context"
    elif cov >= 2.0:
        mix = "bursty"
    else:
        mix = "chat"
    # The replay seed is a pure function of the capture content, so two
    # derivations from the same records pin the same schedule digest.
    seed = int(hashlib.sha256(json.dumps(
        [len(reqs), sorted(str(h) for h in hashes), plens],
        separators=(",", ":")).encode()).hexdigest()[:8], 16)
    return LoadSpec(
        mix=mix,
        arrival="poisson",
        qps=max(qps, 0.1),
        duration_s=duration,
        seed=seed,
        n_prefixes=max(len(hashes), 1),
        # Moment-match the synthesizer: the chat mix draws total
        # length ~ Uniform(shared_prefix + 4, prompt_tokens), so the
        # cap that reproduces the OBSERVED mean is
        # 2*mean - shared_prefix - 4 (shared_prefix stays the default
        # 64 — the records carry prefix identity, not prefix length).
        prompt_tokens=(96 if mix == "long_context"
                       else min(max(2 * int(round(mean_plen)) - 68,
                                    72), 960)),
        long_prompt_tokens=(max(int(round(mean_plen)), 16)
                            if mix == "long_context" else 640),
        max_tokens=max(max_tokens, 1),
        temperature=round(temps[0], 1) if temps else 0.0,
    ).validate()


# ------------------------------------------------------------- scraper
class MetricsScraper:
    """Run-scoped /metrics snapshotter: every ``interval`` seconds the
    target's exposition is fetched, parsed (promtext), and appended as
    one JSONL record to ``series_path`` — a metric time series scoped
    to THIS run, beside the events/traces sinks. The first and last
    successful snapshots are kept in memory for the report's
    histogram-delta percentiles."""

    def __init__(self, target: str, interval: float, series_path):
        import pathlib
        self._url = target.rstrip("/") + "/metrics"
        self.interval = float(interval)
        self.series_path = pathlib.Path(series_path)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0
        self.first: Optional[Dict[str, promtext.Family]] = None
        self.last: Optional[Dict[str, promtext.Family]] = None
        # Monotonic stamps of the first/last SUCCESSFUL snapshots: the
        # report's scrape window. Wall ``ts`` is kept per record for
        # cross-host alignment, but window arithmetic must ride the
        # monotonic clock — an NTP step mid-run would otherwise
        # stretch/shrink the window the server-side percentiles and
        # rates are computed over (the stpu-wallclock rationale).
        self.first_mono: Optional[float] = None
        self.last_mono: Optional[float] = None
        self.snapshots = 0
        self.failures = 0

    def scrape_once(self) -> Optional[Dict[str, promtext.Family]]:
        now = time.time()
        mono = time.perf_counter()
        offset = round(mono - self._t0, 3) if self._t0 else 0.0
        try:
            with urllib.request.urlopen(self._url, timeout=5) as resp:
                text = resp.read().decode("utf-8", "replace")
            families = promtext.parse(text)
        except Exception as e:  # noqa: BLE001 — a scrape failure is a
            # data point (the stack was unreachable), never a crash.
            self.failures += 1
            record = {"ts": now, "mono": mono, "offset": offset,
                      "error": f"{type(e).__name__}: {e}"}
            jsonl_log.append_line(self.series_path, json.dumps(record),
                                  _SERIES_MAX_BYTES, self._lock)
            return None
        if self.first is None:
            self.first = families
            self.first_mono = mono
        self.last = families
        self.last_mono = mono
        self.snapshots += 1
        record = {
            "ts": now, "mono": mono, "offset": offset,
            "families": {
                name: {"kind": fam.kind,
                       "samples": [[s.name, dict(s.labels), s.value]
                                   for s in fam.samples]}
                for name, fam in families.items()},
        }
        jsonl_log.append_line(self.series_path, json.dumps(record),
                              _SERIES_MAX_BYTES, self._lock)
        return families

    def window_seconds(self) -> float:
        """Monotonic span first→last successful snapshot — the window
        the report's server-side deltas cover; immune to wall-clock
        steps mid-run."""
        if self.first_mono is None or self.last_mono is None:
            return 0.0
        return max(self.last_mono - self.first_mono, 0.0)

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self.scrape_once()               # baseline snapshot at t=0
        self._thread = threading.Thread(target=self._loop,
                                        name="loadgen-scraper",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.scrape_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 5)
        self.scrape_once()               # closing snapshot

    # ----------------------------------------------------- report side
    def histogram_delta(self, name: str
                        ) -> Optional[promtext.HistogramSnapshot]:
        if self.first is None or self.last is None:
            return None
        end = promtext.histogram(self.last, name)
        if end is None:
            return None
        begin = promtext.histogram(self.first, name)
        if begin is None:
            return end
        try:
            return end.delta(begin)
        except ValueError:
            return end                   # process restarted mid-run

    def counter_delta(self, name: str, **labels) -> float:
        if self.last is None:
            return 0.0
        end = promtext.counter_total(self.last, name, **labels)
        begin = promtext.counter_total(self.first or {}, name, **labels)
        return max(end - begin, 0.0)

    def counter_by_label(self, name: str, key: str) -> Dict[str, float]:
        """Per-label-value counter deltas, e.g. LB requests by code."""
        if self.last is None:
            return {}
        out: Dict[str, float] = {}
        fam = self.last.get(name)
        if fam is None:
            return {}
        for s in fam.samples:
            val = s.label(key)
            if not val:
                continue
            out[val] = out.get(val, 0.0) + s.value
        if self.first is not None:
            prev = self.first.get(name)
            if prev is not None:
                for s in prev.samples:
                    val = s.label(key)
                    if val in out:
                        out[val] -= s.value
        return {k: v for k, v in out.items() if v > 0}

    def label_sets(self, name: str) -> List[Dict[str, str]]:
        """Distinct label sets of an info-style family in the LAST
        snapshot (e.g. stpu_replica_topology_info: one entry per
        replica topology serving behind the target)."""
        if self.last is None:
            return []
        fam = self.last.get(name)
        if fam is None:
            return []
        seen, out = set(), []
        for s in fam.samples:
            key = tuple(s.labels)
            if key in seen:
                continue
            seen.add(key)
            out.append(dict(s.labels))
        return out


# -------------------------------------------------------------- driver
def _percentile(values: List[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile of raw client samples."""
    if not values:
        return None
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    pos = q * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def _pctiles(values: List[float]) -> Optional[Dict[str, float]]:
    if not values:
        return None
    return {f"p{int(q * 100)}": round(_percentile(values, q), 6)
            for q in (0.5, 0.9, 0.95, 0.99)}


class _RequestWorker(threading.Thread):
    """One scheduled request: POST /generate with stream=true, stamp
    the first/last token arrival off the SSE events."""

    def __init__(self, target: str, req: ScheduledRequest, t0: float,
                 timeout: float, sink: List[dict], lock):
        super().__init__(daemon=True, name=f"loadgen-{req.index}")
        self._target = target
        self._req = req
        self._t0 = t0
        self._timeout = timeout
        self._sink = sink
        self._lock = lock

    def run(self) -> None:
        req = self._req
        record: Dict[str, Any] = {
            "index": req.index,
            "scheduled_at": round(req.at, 6),
            "prompt_tokens": len(req.prompt),
            "max_tokens": req.max_tokens,
            "ok": False, "code": 0, "tokens": 0,
            "ttft_s": None, "tpot_s": None, "e2e_s": None,
            "error": None,
        }
        body = json.dumps({
            "prompt": list(req.prompt), "max_tokens": req.max_tokens,
            "temperature": req.temperature, "seed": req.seed,
            "stream": True,
        }).encode()
        http_req = urllib.request.Request(
            self._target.rstrip("/") + "/generate", data=body,
            headers={"Content-Type": "application/json"},
            method="POST")
        sent = time.perf_counter()
        record["sent_offset"] = round(sent - self._t0, 6)
        record["dispatch_lag_s"] = round(sent - self._t0 - req.at, 6)
        first_at = last_at = None
        tokens = 0
        done = False
        try:
            with urllib.request.urlopen(
                    http_req, timeout=self._timeout) as resp:
                record["code"] = resp.status
                buf = b""
                while True:
                    chunk = resp.read1(65536)
                    now = time.perf_counter()
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n\n" in buf:
                        event, buf = buf.split(b"\n\n", 1)
                        for line in event.splitlines():
                            if not line.startswith(b"data: "):
                                continue
                            payload = line[len(b"data: "):]
                            if payload.strip() == b"[DONE]":
                                done = True
                                continue
                            try:
                                doc = json.loads(payload)
                            except ValueError:
                                continue
                            if not (isinstance(doc, dict)
                                    and "token" in doc):
                                # Non-token SSE payload (e.g. a stats
                                # frame from a reqlog-armed replica
                                # behind a disarmed LB) — not a token.
                                continue
                            tokens += 1
                            last_at = now
                            if first_at is None:
                                first_at = now
        except urllib.error.HTTPError as e:
            record["code"] = e.code
            record["error"] = f"http_{e.code}"
            try:
                e.read()
            except OSError:
                pass
        except Exception as e:  # noqa: BLE001 — connect refused, reset,
            # timeout, truncated stream: all are load-test outcomes.
            record["error"] = type(e).__name__
        finish = time.perf_counter()
        record["tokens"] = tokens
        if first_at is not None:
            record["ttft_s"] = round(first_at - sent, 6)
            if tokens > 1:
                record["tpot_s"] = round(
                    (last_at - first_at) / (tokens - 1), 6)
        record["e2e_s"] = round(finish - sent, 6)
        # ok = the stream COMPLETED ([DONE] seen): a truncated stream
        # or transport error is not a served request, whatever the
        # status line said.
        record["ok"] = bool(done) and record["error"] is None \
            and record["code"] == 200
        if record["error"] is None and not done:
            record["error"] = "truncated_stream"
        with self._lock:
            self._sink.append(record)


def run(target: str, spec: Optional[LoadSpec] = None, *,
        slo_ttft_s: Optional[float] = None,
        slo_tpot_s: Optional[float] = None,
        scrape_interval: float = 1.0,
        out_dir: Optional[str] = None,
        faults: Optional[str] = None,
        faults_at: float = 0.0,
        request_timeout: float = 120.0,
        schedule_file: Optional[str] = None) -> Dict[str, Any]:
    """Fire ``spec``'s schedule at ``target`` (the LB endpoint) and
    return the SLO report (also persisted to ``<out_dir>/report.json``
    next to ``schedule.json`` and the scraped ``metrics.jsonl``).
    With ``schedule_file`` the saved/derived trace is replayed VERBATIM
    instead of built from ``spec`` (which may be None); the report's
    ``source`` field records the provenance either way, and
    ``schedule_sha256`` pins the digest that actually ran."""
    if schedule_file:
        spec, schedule, digest = load_schedule(schedule_file)
        source = "schedule"
    elif spec is not None:
        spec.validate()
        schedule = build_schedule(spec)
        digest = schedule_digest(schedule)
        source = "spec"
    else:
        raise ValueError("run() needs a spec or a schedule_file")
    if faults:
        # Fail fast on a malformed spec — not mid-run with the scraper
        # already started and partial artifacts on disk.
        fault_injection.parse_spec(faults)
    run_dir = _resolve_out_dir(out_dir, spec)
    os.makedirs(run_dir, exist_ok=True)
    save_schedule(os.path.join(run_dir, "schedule.json"), spec,
                  schedule)

    scraper = MetricsScraper(target, scrape_interval,
                             os.path.join(run_dir, "metrics.jsonl"))
    events.emit("loadgen", os.path.basename(run_dir), "run_start",
                target=target, mix=spec.mix, arrival=spec.arrival,
                qps=spec.qps, duration_s=spec.duration_s,
                seed=spec.seed, requests=len(schedule), digest=digest)

    results: List[dict] = []
    results_lock = threading.Lock()
    workers: List[_RequestWorker] = []
    fault_timer: Optional[threading.Timer] = None
    armed_faults = False
    if faults:
        def _arm():
            fault_injection.configure(faults)
        fault_timer = threading.Timer(max(faults_at, 0.0), _arm)
        fault_timer.daemon = True
        armed_faults = True

    scraper.start()
    t0 = time.perf_counter()
    if fault_timer is not None:
        if faults_at <= 0:
            fault_injection.configure(faults)
            fault_timer = None
        else:
            fault_timer.start()
    try:
        # Open-loop dispatch: each request fires at its scheduled
        # instant, never gated on completions — a saturated stack sees
        # the queue it would see in production, not a self-throttling
        # closed loop.
        for req in schedule:
            delay = t0 + req.at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            worker = _RequestWorker(target, req, t0, request_timeout,
                                    results, results_lock)
            worker.start()
            workers.append(worker)
        dispatch_window = time.perf_counter() - t0
        deadline = time.perf_counter() + request_timeout + 5.0
        for worker in workers:
            worker.join(timeout=max(deadline - time.perf_counter(),
                                    0.1))
    finally:
        if fault_timer is not None:
            fault_timer.cancel()
        wall = time.perf_counter() - t0
        scraper.stop()
        if armed_faults:
            # The run armed this process's seams; a later run (or the
            # host process) must not inherit them.
            fault_injection.clear()

    with results_lock:
        # Snapshot: a straggler worker past its join deadline may still
        # append while the report is being assembled.
        results_snapshot = list(results)
    report = _build_report(spec, schedule, digest, results_snapshot,
                           wall, scraper, target,
                           dispatch_window=dispatch_window,
                           slo_ttft_s=slo_ttft_s,
                           slo_tpot_s=slo_tpot_s,
                           faults=faults, faults_at=faults_at,
                           source=source,
                           scrape_interval=scrape_interval)
    report["out_dir"] = run_dir
    with open(os.path.join(run_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    events.emit("loadgen", os.path.basename(run_dir), "run_complete",
                goodput=report["goodput"]["fraction"],
                achieved_qps=report["qps"]["achieved"],
                errors=report["requests"]["error"])
    return report


def _resolve_out_dir(out_dir: Optional[str], spec: LoadSpec) -> str:
    if out_dir:
        return str(out_dir)
    from skypilot_tpu_torch.utils import paths
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return str(paths.logs_dir() / "loadgen"
               / f"{stamp}-{spec.mix}-seed{spec.seed}")


def runs_root() -> str:
    from skypilot_tpu_torch.utils import paths
    return str(paths.logs_dir() / "loadgen")


def latest_run_dir() -> Optional[str]:
    """Newest run dir holding a report.json (for `stpu loadgen
    report` with no argument)."""
    root = runs_root()
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return None
    for name in reversed(names):
        candidate = os.path.join(root, name)
        if os.path.exists(os.path.join(candidate, "report.json")):
            return candidate
    return None


def _build_report(spec, schedule, digest, results, wall, scraper,
                  target, *, dispatch_window, slo_ttft_s, slo_tpot_s,
                  faults, faults_at, source="spec",
                  scrape_interval=1.0) -> Dict[str, Any]:
    results = sorted(results, key=lambda r: r["index"])
    ok = [r for r in results if r["ok"]]
    ttfts = [r["ttft_s"] for r in ok if r["ttft_s"] is not None]
    tpots = [r["tpot_s"] for r in ok if r["tpot_s"] is not None]
    e2es = [r["e2e_s"] for r in ok if r["e2e_s"] is not None]
    total_tokens = sum(r["tokens"] for r in results)
    # Throughput window: run start -> last SERVED completion. The raw
    # wall is join-bounded, so one wedged stream waiting out its socket
    # timeout would deflate achieved QPS / tok_s by an order of
    # magnitude (and trip bench_compare) even with goodput untouched.
    done_at = [r["sent_offset"] + r["e2e_s"]
               for r in (ok or results) if r.get("e2e_s") is not None]
    window = max(done_at) if done_at else wall

    def meets_slo(r) -> bool:
        if not r["ok"]:
            return False
        if slo_ttft_s is not None and (r["ttft_s"] is None
                                       or r["ttft_s"] > slo_ttft_s):
            return False
        if slo_tpot_s is not None and r["tpot_s"] is not None \
                and r["tpot_s"] > slo_tpot_s:
            return False
        return True

    # Goodput over SCHEDULED requests: a request that never completed
    # (still hung at join deadline) counts against goodput exactly like
    # an error — the user it represents was not served.
    good = sum(1 for r in results if meets_slo(r))
    n_sched = len(schedule)
    error_count = sum(1 for r in results if not r["ok"])
    errors_by_kind: Dict[str, int] = {}
    for r in results:
        if r["ok"]:
            continue
        kind = r["error"] or f"http_{r['code']}"
        errors_by_kind[kind] = errors_by_kind.get(kind, 0) + 1

    server: Dict[str, Any] = {"scrapes": scraper.snapshots,
                              "scrape_failures": scraper.failures,
                              # Monotonic first→last-scrape span: the
                              # window every server-side delta below
                              # covers (wall-clock-step immune).
                              "scrape_window_seconds": round(
                                  scraper.window_seconds(), 3)}
    ttft_hist = scraper.histogram_delta(_TTFT_FAMILY)
    if ttft_hist is not None and ttft_hist.count > 0:
        server["engine_ttft"] = {
            "count": ttft_hist.count,
            "p50": round(ttft_hist.quantile(0.50), 6),
            "p90": round(ttft_hist.quantile(0.90), 6),
            "p99": round(ttft_hist.quantile(0.99), 6),
        }
    lb_hist = scraper.histogram_delta(_LB_LATENCY_FAMILY)
    if lb_hist is not None and lb_hist.count > 0:
        server["lb_latency"] = {
            "count": lb_hist.count,
            "p50": round(lb_hist.quantile(0.50), 6),
            "p99": round(lb_hist.quantile(0.99), 6),
        }
    # Replica topology tags (hosts x tp, from each replica's
    # stpu_replica_topology_info riding the LB's merged /metrics): an
    # SLO regression between two runs that ALSO differ here is
    # attributable to the replica_topology change, not the engine.
    topo = scraper.label_sets("stpu_replica_topology_info")
    if topo:
        server["replica_topology"] = [
            {"hosts": t.get("hosts", "1"), "tp": t.get("tp", "1"),
             "label": f"{t.get('hosts', '1')}x{t.get('tp', '1')}"}
            for t in topo]
    server["lb_retries"] = scraper.counter_delta(
        "stpu_lb_upstream_retries_total")
    server["lb_breaker_ejections"] = scraper.counter_delta(
        "stpu_lb_breaker_ejections_total")
    by_code = scraper.counter_by_label("stpu_lb_requests_total", "code")
    if by_code:
        server["lb_requests_by_code"] = by_code
    # Durable-stream accounting: how many mid-stream upstream deaths
    # the LB healed by resuming on a peer (outcome="ok"), plus the
    # client-observed stall each splice cost (death -> first resumed
    # byte). A chaos leg asserts on these; a kill-free run reports 0.
    resumes = scraper.counter_by_label(
        "stpu_lb_stream_resumes_total", "outcome")
    server["resumed_streams"] = resumes.get("ok", 0.0)
    if resumes:
        server["lb_stream_resumes"] = resumes
    gap_hist = scraper.histogram_delta("stpu_lb_resume_gap_seconds")
    if gap_hist is not None and gap_hist.count > 0:
        server["resume_gap"] = {
            "count": gap_hist.count,
            "p50": round(gap_hist.quantile(0.50), 6),
            "p90": round(gap_hist.quantile(0.90), 6),
            "p99": round(gap_hist.quantile(0.99), 6),
        }

    # Open-loop integrity: how late each dispatch actually fired
    # relative to its scheduled instant. A single-process driver that
    # saturates under-drives SILENTLY — achieved < offered then blames
    # the server for queueing that never happened. Surfacing the lag
    # (and warning once it exceeds a scrape interval, the report's own
    # resolution) makes the shortfall attributable.
    lags = [r["dispatch_lag_s"] for r in results
            if r.get("dispatch_lag_s") is not None]
    driver: Dict[str, Any] = {"lag_s": _pctiles(lags),
                              "warning": None}
    lag_p99 = _percentile(lags, 0.99) if lags else None
    driver["lag_p99_s"] = round(lag_p99, 6) if lag_p99 is not None \
        else None
    if lag_p99 is not None and lag_p99 > scrape_interval:
        driver["warning"] = (
            f"driver saturated: dispatch lag p99 {lag_p99:.3f}s "
            f"exceeds the {scrape_interval:g}s scrape interval — "
            "'achieved < offered' is (at least partly) the DRIVER "
            "under-driving, not the server queueing")

    offered = n_sched / spec.duration_s
    return {
        "version": 1,
        "target": target,
        "source": source,
        "spec": dataclasses.asdict(spec),
        "schedule_sha256": digest,
        "driver": driver,
        "wall_seconds": round(wall, 3),
        "serving_window_seconds": round(window, 3),
        "faults": faults, "faults_at_s": faults_at if faults else None,
        "qps": {
            "offered": round(offered, 3),
            # Every scheduled request IS dispatched (open loop); the
            # sent rate differs from offered only by dispatch lag —
            # dividing by completion wall time would silently turn
            # 'sent' into a completion rate under saturation.
            "sent": round(n_sched / max(dispatch_window, 1e-9), 3),
            "achieved": round(len(ok) / max(window, 1e-9), 3),
        },
        "requests": {
            "scheduled": n_sched,
            "completed": len(results),
            "ok": len(ok),
            "error": error_count,
            "unfinished": n_sched - len(results),
            "errors_by_kind": errors_by_kind,
        },
        "latency_s": {
            "ttft": _pctiles(ttfts),
            "tpot": _pctiles(tpots),
            "e2e": _pctiles(e2es),
        },
        "goodput": {
            "slo_ttft_s": slo_ttft_s,
            "slo_tpot_s": slo_tpot_s,
            "good": good,
            "fraction": round(good / max(n_sched, 1), 4),
        },
        "tokens": {
            "generated": total_tokens,
            "tok_s": round(total_tokens / max(window, 1e-9), 1),
        },
        "server": server,
        "per_request": results,
    }


# ------------------------------------------------------------ renderer
def format_report(report: Dict[str, Any]) -> str:
    """Human rendering of a report dict (`stpu loadgen` / `stpu
    loadgen report`)."""
    spec = report.get("spec", {})
    qps = report.get("qps", {})
    reqs = report.get("requests", {})
    good = report.get("goodput", {})
    lat = report.get("latency_s", {})
    server = report.get("server", {})
    lines = [
        f"run        {report.get('out_dir', '-')}",
        f"target     {report.get('target', '-')}",
        f"workload   mix={spec.get('mix')} arrival={spec.get('arrival')}"
        f" qps={spec.get('qps')} duration={spec.get('duration_s')}s"
        f" seed={spec.get('seed')}",
        f"schedule   {reqs.get('scheduled')} requests"
        f" sha256={str(report.get('schedule_sha256', ''))[:12]}…"
        f" source={report.get('source', 'spec')}",
        f"qps        offered {qps.get('offered')}  sent {qps.get('sent')}"
        f"  achieved {qps.get('achieved')}",
        f"requests   ok {reqs.get('ok')}  error {reqs.get('error')}"
        f"  unfinished {reqs.get('unfinished')}"
        + (f"  ({', '.join(f'{k}={v}' for k, v in sorted(reqs.get('errors_by_kind', {}).items()))})"
           if reqs.get("errors_by_kind") else ""),
        f"tokens     {report.get('tokens', {}).get('generated')} generated"
        f" ({report.get('tokens', {}).get('tok_s')} tok/s)",
    ]
    if report.get("faults"):
        lines.append(f"faults     {report['faults']} "
                     f"(armed at t+{report.get('faults_at_s')}s)")
    driver = report.get("driver") or {}
    if driver.get("lag_p99_s") is not None:
        lines.append(
            f"driver     dispatch lag p99 "
            f"{driver['lag_p99_s'] * 1000:.1f}ms")
    if driver.get("warning"):
        lines.append(f"WARNING    {driver['warning']}")

    def fmt_p(name: str, p: Optional[Dict[str, float]]) -> str:
        if not p:
            return f"{name:<10} (no samples)"
        body = "  ".join(f"{k} {v * 1000:.1f}ms"
                         for k, v in sorted(p.items(),
                                            key=lambda kv: int(kv[0][1:])))
        return f"{name:<10} {body}"

    lines.append("client-side latency:")
    for key in ("ttft", "tpot", "e2e"):
        lines.append("  " + fmt_p(key, lat.get(key)))
    if server.get("engine_ttft"):
        s = server["engine_ttft"]
        lines.append(
            f"server ttft (engine histogram, n={s['count']:g}): "
            f"p50 {s['p50'] * 1000:.1f}ms  p90 {s['p90'] * 1000:.1f}ms"
            f"  p99 {s['p99'] * 1000:.1f}ms")
    if server.get("lb_latency"):
        s = server["lb_latency"]
        lines.append(
            f"server e2e (LB histogram, n={s['count']:g}): "
            f"p50 {s['p50'] * 1000:.1f}ms  p99 {s['p99'] * 1000:.1f}ms")
    lines.append(
        f"lb         retries {server.get('lb_retries', 0):g}  breaker "
        f"ejections {server.get('lb_breaker_ejections', 0):g}  scrapes "
        f"{server.get('scrapes', 0)}")
    if server.get("lb_stream_resumes"):
        outcomes = ", ".join(
            f"{k}={v:g}" for k, v in
            sorted(server["lb_stream_resumes"].items()))
        line = (f"resumes    {server.get('resumed_streams', 0):g} "
                f"streams resumed mid-flight ({outcomes})")
        if server.get("resume_gap"):
            g = server["resume_gap"]
            line += (f"  gap p50 {g['p50'] * 1000:.1f}ms"
                     f"  p99 {g['p99'] * 1000:.1f}ms")
        lines.append(line)
    if server.get("replica_topology"):
        labels = ", ".join(t["label"]
                           for t in server["replica_topology"])
        lines.append(f"topology   replicas (hosts x tp): {labels}")
    slo_bits = []
    if good.get("slo_ttft_s") is not None:
        slo_bits.append(f"ttft<={good['slo_ttft_s']}s")
    if good.get("slo_tpot_s") is not None:
        slo_bits.append(f"tpot<={good['slo_tpot_s']}s")
    slo = " and ".join(slo_bits) if slo_bits else "completion only"
    lines.append(
        f"goodput    {good.get('good')}/{reqs.get('scheduled')} = "
        f"{good.get('fraction', 0) * 100:.1f}% under SLO ({slo})")
    return "\n".join(lines)
