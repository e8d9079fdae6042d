"""LLM inference replica: the port's counterpart of the JAX package's
``recipes/serve_llm.py``, with the same HTTP surface byte for byte, so
the JAX package's load balancer and controller front it unchanged:

    GET  /health    -> 200 once the engine has served its warmup request
    GET  /metrics   -> Prometheus exposition (the same metric names)
    GET  /drain, POST /drain, GET /perf, POST /profile?seconds=N
    POST /generate  {"prompt": [ids...], "max_tokens": N,
                     "temperature": 0.7, "seed": 1, "stream": true,
                     "resume": {"emitted": [...], "pos": K}}
                    -> {"tokens": [...]} or SSE ``data: {"token": N}``
                       frames, a trailing ``event: stats`` frame while
                       the request log is armed, then ``data: [DONE]``

Requests are served by the port's continuous-batching DecodeEngine
under an EngineSupervisor (paged KV and the prefix cache by default,
int8 weights and KV, speculative decoding and the host spill tier on
request); ``engine_slots=0`` keeps the legacy locked path. Seeded
sampling uses threefry keys equal to ``jax.random``'s, so a stream
resumes on either package's replica.

    python -m skypilot_tpu_torch.recipes.serve_llm --model llama3-8b \
        --port 8080        # or --model gemma-2b

Runs on the card unless given ``--device cpu``. Not ported yet, and
refused with a ValueError: gang and tensor-parallel replicas
(``--replica-hosts`` > 1, ``--tp`` > 1, ``SKYPILOT_NUM_NODES`` > 1 or a
``SKYPILOT_NODE_RANK`` > 0), the co-located load balancer
(``--lb-port``: run the JAX package's load balancer process in front
instead), and the mixtral family.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device, to_device
from skypilot_tpu_torch.models import gemma, llama, mixtral, model_api
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import reqlog
from skypilot_tpu_torch.observability import stepstats
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.serve import decode_engine
from skypilot_tpu_torch.serve import prng
from skypilot_tpu_torch.utils import fault_injection

# The gang env contract (the JAX package's ``agent/constants.py``).
NODE_RANK = "SKYPILOT_NODE_RANK"
NUM_NODES = "SKYPILOT_NUM_NODES"


def write_chunk(wfile, data: bytes) -> None:
    """One HTTP/1.1 chunked-transfer frame, flushed immediately (the JAX
    package's ``serve/load_balancer.write_chunk``)."""
    wfile.write(f"{len(data):x}\r\n".encode())
    wfile.write(data)
    wfile.write(b"\r\n")
    wfile.flush()


def end_chunks(wfile) -> None:
    """Chunked-transfer terminator."""
    wfile.write(b"0\r\n\r\n")
    wfile.flush()



# Request limits: prompt/decode lengths are padded to buckets (the
# legacy path's shapes) and a hostile request cannot trigger unbounded
# allocation or a giant loop.
PROMPT_BUCKET = 64
MAX_PROMPT_TOKENS = 1024
MAX_GEN_TOKENS = 256
GEN_BUCKET = 16

# Engine defaults (overridable per serve() call / env). The prefill
# chunk has no constant here: the recipe leaves it at
# resolve_kv_geometry's 0 sentinel so its one derivation
# (DEFAULT_PREFILL_CHUNK) lives in decode_engine.
ENGINE_SLOTS = int(os.environ.get("STPU_ENGINE_SLOTS", "4"))
# Host-RAM KV spill tier budget (MiB) under the paged pool's trie:
# LRU-evicted prefix blocks spill D2H into a bounded host pool and
# re-admit H2D on a warm match, so the effective prefix cache grows
# from the HBM pool to host RAM at the cost of one block transfer per
# re-hit. 0 turns the tier off (evictions drop the leaf); default on
# at 64 MiB. Ignored by the dense engine (no trie, no tier).
ENGINE_PREFIX_CACHE_MB = float(
    os.environ.get("STPU_PREFIX_CACHE_MB", "64"))
# Paged KV block pool (decode_engine paged mode): one device-resident
# pool + per-slot block tables instead of dense per-slot cache rows —
# admission is free-block based and prefix hits alias blocks
# zero-copy. ON by default (bit-identical to dense, pinned by
# tests/test_paged_kv.py); STPU_KV_PAGED=0 keeps the dense path
# selectable for parity debugging (no prefix cache there).
ENGINE_KV_PAGED = os.environ.get("STPU_KV_PAGED", "1") == "1"
# 0 = auto-size the pool to the dense HBM budget
# (slots * max_seq / block + 1 scratch; doubled under KV_QUANT —
# int8 blocks are ~half the bytes).
ENGINE_KV_POOL_BLOCKS = int(os.environ.get("STPU_KV_POOL_BLOCKS", "0"))
# 0 = block size follows the prefill chunk (64).
ENGINE_KV_BLOCK_TOKENS = int(
    os.environ.get("STPU_KV_BLOCK_TOKENS", "0"))
# Quantized serving (decode_engine quant mode): KV_QUANT stores int8
# KV blocks + per-(layer, block, head) f32 scales in the paged pool
# (~2x block capacity at the same HBM budget; requires KV_PAGED);
# WEIGHT_QUANT serves int8 per-channel-scaled params. NOT
# bit-identical to bf16 — gated by the tests/test_quant.py parity
# suite (top-1 agreement + perplexity bound per family).
ENGINE_KV_QUANT = os.environ.get("STPU_KV_QUANT", "0") == "1"
ENGINE_WEIGHT_QUANT = os.environ.get("STPU_WEIGHT_QUANT", "0") == "1"
# Self-speculative decoding (decode_engine spec mode): up to K n-gram
# drafted tokens per slot per step, verified in one batched forward —
# bit-identical output, fewer memory-bound passes per token on
# repetitive/templated traffic. 0 disables (this release's default;
# the bench legs and chat-heavy deployments turn it on).
ENGINE_SPEC_K = int(os.environ.get("STPU_SPEC_K", "0"))
ENGINE_SPEC_NGRAM = int(os.environ.get("STPU_SPEC_NGRAM", "3"))
ENGINE_SPEC_MIN_ACCEPT = float(
    os.environ.get("STPU_SPEC_MIN_ACCEPT", "0.2"))
# Per-token stream timeout: how long a client handler waits for the
# NEXT token before declaring the engine wedged (surfaced as a clean
# EngineError, not a hang). Operator-tunable — the right bound is how
# fast wedged-device detection should be vs. the slowest honest step.
STREAM_TIMEOUT_SECONDS = float(
    os.environ.get("STPU_STREAM_TIMEOUT", "600"))
# Preemption-notice watcher poll interval (seconds): how often the
# replica checks the provider's metadata preemption signal (the fault
# point ``replica.preempt_notice`` stands in for the metadata server in
# tests and game-days). On a notice the replica KEEPS serving — it only
# advertises the notice via /health so the controller can flip it
# DRAINING and launch the replacement BEFORE the kill lands
# (replace-ahead); in-flight streams resume on peers through the LB
# journal when the kill arrives. 0 disables the watcher.
PREEMPT_NOTICE_POLL = float(
    os.environ.get("STPU_PREEMPT_NOTICE_POLL", "1.0"))
# Engine supervision (decode_engine.EngineSupervisor): restart a
# crashed engine loop this many times (capped exponential backoff
# starting at BACKOFF seconds) before declaring the replica dead.
ENGINE_MAX_RESTARTS = int(os.environ.get("STPU_ENGINE_MAX_RESTARTS",
                                         "3"))
ENGINE_RESTART_BACKOFF = float(
    os.environ.get("STPU_ENGINE_RESTART_BACKOFF", "1.0"))

# Topology tag for this replica (hosts x tp), exported so the LB's
# merged /metrics and loadgen reports can attribute SLO shifts to a
# replica_topology change. Info-style gauge: value is always 1, the
# labels carry the fact.
_TOPOLOGY_INFO = metrics.gauge(
    "stpu_replica_topology_info",
    "Replica serving topology (hosts x tensor-parallel degree); "
    "value is constant 1.", ("hosts", "tp"))
_PREEMPT_NOTICES = metrics.counter(
    "stpu_serve_preempt_notices_total",
    "Provider preemption notices observed by the replica's metadata "
    "watcher (fault point replica.preempt_notice); each one is a "
    "replace-ahead trigger for the controller.")


def _ceil_to(n: int, b: int) -> int:
    return ((n + b - 1) // b) * b


def _pick(logits_row: torch.Tensor, temperature: float,
          key: torch.Tensor) -> torch.Tensor:
    if temperature > 0.0:
        t = torch.full((), temperature, dtype=torch.float32,
                       device=logits_row.device)
        return prng.categorical(key, logits_row / t)
    return torch.argmax(logits_row, dim=-1)


@torch.inference_mode()
def _prefill(cfg: llama.LlamaConfig, params, buf: torch.Tensor,
             max_seq: int, start: int, temperature: float,
             key: torch.Tensor):
    """Legacy streaming path, step 1: one O(S) prefill over the padded
    prompt into a fresh cache; returns (first token (1,), KV cache)."""
    api = model_api(cfg)
    cache = api.init_cache(cfg, 1, max_seq, buf.device)
    logits, cache = api.forward_with_cache(
        cfg, params, buf[None, :], cache, 0, valid_len=start,
        logits_at=start - 1)
    return _pick(logits[:, 0], temperature, key), cache


@torch.inference_mode()
def _gen_step(cfg: llama.LlamaConfig, params, tok: torch.Tensor, cache,
              pos: int, temperature: float, key: torch.Tensor):
    """Legacy streaming path, step 2..N: one cached decode step (the
    cache updates in place) — called per token so the handler can flush
    each token to the client as it exists (SSE)."""
    logits, cache = model_api(cfg).forward_with_cache(
        cfg, params, tok[:, None], cache, pos)
    return _pick(logits[:, -1], temperature, key), cache


@torch.inference_mode()
def _decode(cfg: llama.LlamaConfig, params, buf: torch.Tensor, start: int,
            mt_pad: int, temperature: float, cache,
            seed: int) -> torch.Tensor:
    """Legacy fixed-batch continuation over a padded prompt buffer.

    buf: (s_pad,) with the prompt in [0, start). ``cache`` is allocated
    by the caller and filled in place. Returns tokens (mt_pad,)."""
    max_seq = buf.shape[0] + mt_pad
    toks = model_api(cfg).decode(
        cfg, params, buf[None, :], start, mt_pad, max_seq,
        temperature=temperature, key=prng.key(seed, buf.device),
        cache=cache)
    return toks[0]


def _decode_locked(ctx, buf, s, mt_pad, temperature, seed):
    """Legacy path: allocate a fresh cache and decode under the model
    lock."""
    cfg = ctx["cfg"]
    cache = model_api(cfg).init_cache(cfg, 1, buf.shape[0] + mt_pad,
                                      buf.device)
    with ctx["lock"]:
        return _decode(cfg, ctx["params"], buf, s, mt_pad, temperature,
                       cache, seed)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # chunked responses need 1.1
    server_ctx = None  # set by serve()

    def log_message(self, *args):
        pass

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/health"):
            ctx = self.server_ctx
            ready = ctx["ready"].is_set()
            engine = ctx.get("engine")
            if not ready:
                self._json(503, {"status": "warming"})
            elif engine is not None and not engine.healthy():
                # The readiness probe must tell the truth about the
                # ENGINE, not just the HTTP process: a dead/restarting
                # engine behind a 200 probe is a zombie replica that
                # blackholes its share of traffic.
                self._json(503, {"status": "engine_down"})
            else:
                payload = {"status": "ok"}
                notice = ctx.get("preempt_notice")
                if notice is not None and notice.is_set():
                    # Preemption notice observed: the replica is still
                    # fully serving (200), but the controller's probe
                    # reads this flag and flips the replica DRAINING —
                    # replace-ahead, before the kill ever lands.
                    payload["preempt_notice"] = True
                self._json(200, payload)
        elif self.path == "/drain":
            self._json(200, self._drain_payload())
        elif self.path == "/perf":
            # Step-telemetry snapshot (observability/stepstats.py):
            # phase breakdown, occupancy, sampled dispatch/device
            # split over the step ring. Meaningful content needs
            # STPU_STEPSTATS=1 on the replica; disarmed it reports
            # armed=false with an empty ring. The LB merges every
            # ready replica's /perf like it merges /metrics.
            self._json(200, self._perf_payload())
        elif self.path == "/gang":
            self._json(404, {"error": "not a gang replica"})
        elif self.path == "/metrics":
            # Replica-local registry (engine slot/queue/token families);
            # the LB pulls this into its merged /metrics snapshot.
            body = metrics.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", metrics.CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._json(404, {"error": "not found"})

    # ------------------------------------------------------------ perf
    def _perf_payload(self) -> dict:
        ctx = self.server_ctx
        doc = stepstats.snapshot()
        engine = ctx.get("engine")
        if engine is not None:
            doc["engine"] = {
                "healthy": engine.healthy(),
                "in_flight": engine.in_flight(),
                "draining": engine.draining(),
                "restarts": getattr(engine, "restarts", 0),
            }
            kv = engine.kv_config()
            if kv:
                # Quant mode line for `stpu perf`: which int8 paths
                # this replica serves with (resolve_kv_geometry output).
                doc["quant"] = {
                    "kv_quant": int(kv.get("kv_quant", 0)),
                    "weight_quant": int(kv.get("weight_quant", 0)),
                    "pool_blocks": int(kv.get("pool_blocks", 0)),
                }
                # Tuning line for `stpu perf`: the constants this
                # replica decodes with; the port has no tuning manifest,
                # so "manifest" is always "default".
                doc["tuning"] = {
                    "block": int(kv.get("block", 0)),
                    "chunk": int(kv.get("chunk", 0)),
                    "window": int(kv.get("window", 0)),
                    "spec_k": int(kv.get("spec_k", 0)),
                    "manifest": kv.get("manifest", "default"),
                }
            # Host KV tier line for `stpu perf`: spill/re-admit and
            # residency counters from the engine's HostBlockPool
            # (absent while the tier is off).
            tier = {}
            get_tier = getattr(engine, "host_tier_stats", None)
            if callable(get_tier):
                tier = get_tier() or {}
            if tier:
                doc["tier"] = {
                    "budget_mb": float(tier.get("budget_mb", 0.0)),
                    "bytes": int(tier.get("bytes", 0)),
                    "blocks": int(tier.get("blocks", 0)),
                    "spilled": int(tier.get("spilled", 0)),
                    "dropped": int(tier.get("evict_drops", 0)),
                    "lru_dropped": int(tier.get("lru_dropped", 0)),
                    "readmitted": int(tier.get("readmitted_blocks",
                                               0)),
                    "rehits": int(tier.get("rehits", 0)),
                }
        return doc

    def _start_profile(self) -> None:
        """POST /profile?seconds=N: capture a ``torch.profiler`` trace
        (CPU and CUDA activity) to ``~/.stpu/logs/profiles/<stamp>/``.
        The capture runs on its own thread (the handler answers 202
        immediately with the target directory); one capture at a time
        per process."""
        import urllib.parse
        query = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query)
        try:
            seconds = float(query.get("seconds", ["5"])[0])
        except ValueError:
            self._json(400, {"error": "seconds must be numeric"})
            return
        # Atomic claim BEFORE the 202: a racing second request must be
        # told 409, not promised a directory that never appears.
        if not stepstats.begin_profile():
            self._json(409, {"error": "a profile capture is already "
                                      "running"})
            return
        out_dir = os.path.join(
            str(stepstats.profiles_dir()),
            time.strftime("%Y%m%d-%H%M%S"))

        def capture():
            try:
                stepstats.capture_profile(seconds, out_dir=out_dir,
                                          claimed=True)
            except Exception:  # noqa: stpu-except — best-effort capture; the 202 already told the client where to look
                pass

        threading.Thread(target=capture, daemon=True,
                         name="profile-capture").start()
        self._json(202, {"profile_dir": out_dir,
                         "seconds": min(max(seconds, 0.05), 120.0)})

    # ----------------------------------------------------------- drain
    def _drain_payload(self) -> dict:
        ctx = self.server_ctx
        with ctx["inflight_lock"]:
            handler_inflight = ctx["inflight"][0]
        engine = ctx.get("engine")
        if engine is not None:
            # The engine's slot count hits zero while a handler thread
            # may still be FLUSHING queued tokens to a slow client —
            # the handler count covers that tail, so report the max of
            # the two views or a drain could truncate a live stream.
            return {"draining": engine.draining(),
                    "in_flight": max(engine.in_flight(),
                                     handler_inflight)}
        return {"draining": ctx["draining"].is_set(),
                "in_flight": handler_inflight}

    def _start_drain(self) -> None:
        """POST /drain: stop admitting new generations, report what is
        still in flight. The replica manager polls GET /drain until
        in_flight hits 0 (or its deadline) before terminating, so live
        token streams finish instead of truncating mid-rollout."""
        ctx = self.server_ctx
        ctx["draining"].set()
        engine = ctx.get("engine")
        if engine is not None:
            engine.drain()
        self._json(200, self._drain_payload())

    def do_POST(self):
        # Body consumed up front on EVERY path: an early error response
        # that leaves unread body bytes on an HTTP/1.1 keep-alive
        # connection corrupts the next request parsed off it.
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length) if length else b""
        if self.path == "/drain":
            self._start_drain()
            return
        if self.path == "/profile" or self.path.startswith("/profile?"):
            self._start_profile()
            return
        if self.path != "/generate":
            self._json(404, {"error": "not found"})
            return
        if self.server_ctx["draining"].is_set():
            # Engine-path submits would raise EngineError anyway; this
            # also covers the legacy path and keeps the refusal shape
            # uniform (503 → the LB retries on a non-draining peer).
            self._json(503, {"error": "replica draining"})
            return
        try:
            req = json.loads(raw or b"{}")
            prompt = [int(t) for t in req["prompt"]]
            if not 1 <= len(prompt) <= MAX_PROMPT_TOKENS:
                raise ValueError(
                    f"prompt length must be in [1, {MAX_PROMPT_TOKENS}]")
            mt = min(max(int(req.get("max_tokens", 16)), 1),
                     MAX_GEN_TOKENS)
            # Quantized so the jit cache stays bounded; 0.0 = greedy.
            temperature = round(
                max(0.0, min(float(req.get("temperature", 0.0)), 2.0)),
                1)
            # Mask to uint32 range: any int is a valid seed, and an
            # out-of-range value must not escape the 400 contract.
            seed = int(req.get("seed", 0)) & 0xFFFFFFFF
            ctx = self.server_ctx
            stream = bool(req.get("stream"))
            # LB mid-stream resume contract: ``resume.emitted`` are the
            # tokens the client already received (they become a prompt
            # extension in the engine), ``resume.pos`` the absolute
            # emission position to continue from. The engine's
            # fold_in(seed, position) sampling keys make the
            # continuation bit-identical to the uninterrupted run.
            resume = None
            rd = req.get("resume")
            if rd is not None:
                if not isinstance(rd, dict):
                    raise ValueError("resume must be an object")
                resume = [int(t) for t in rd.get("emitted") or []]
                if not resume:
                    raise ValueError("resume.emitted must be non-empty")
                if int(rd.get("pos", -1)) != len(resume):
                    raise ValueError(
                        "resume.pos must equal len(resume.emitted)")
                if len(resume) >= mt:
                    raise ValueError(
                        "resume.emitted already covers max_tokens")
        except (KeyError, ValueError, TypeError) as e:
            self._json(400, {"error": str(e)})
            return
        engine = ctx.get("engine")
        if resume is not None and engine is None:
            # The legacy locked path has no absolute-position sampling
            # contract to resume into; only engine replicas honor it.
            self._json(400, {"error": "resume requires the decode "
                                      "engine (engine_slots > 0)"})
            return
        # Replica hop of the request's trace, continued from the LB's
        # X-STPU-Trace header (tracing.ENABLED guard = zero tracing
        # cost unarmed); the engine parents its queue/prefill/decode
        # spans under this one via the submit trace context.
        span = None
        if tracing.ENABLED:
            span = tracing.start_span(
                "replica.generate", kind="replica",
                parent=tracing.extract(self.headers),
                attrs={"prompt_tokens": len(prompt), "max_tokens": mt,
                       "stream": stream,
                       "resume": len(resume) if resume else 0,
                       "engine": engine is not None})
        # Legacy-path in-flight accounting (the engine tracks its own):
        # GET /drain must see requests this handler is still streaming.
        with ctx["inflight_lock"]:
            ctx["inflight"][0] += 1
        status = "error"
        try:
            if engine is not None:
                self._engine_generate(engine, prompt, mt, temperature,
                                      seed, stream, span, resume)
            else:
                self._legacy_generate(ctx, prompt, mt, temperature,
                                      seed, stream, span)
            status = "ok"
        except decode_engine.EngineError as e:
            if span is not None:
                span.event("engine_error", error=str(e))
            self._json(503, {"error": str(e)})
        except (KeyError, ValueError, TypeError) as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — pre-header failures
            # (runtime errors before the first token) must still
            # produce a clean JSON error; once headers are out, _sse
            # has already swallowed the exception and dropped the
            # connection, so this catch never corrupts a stream.
            self._json(500, {"error": f"{type(e).__name__}: {e}"})
        finally:
            with ctx["inflight_lock"]:
                ctx["inflight"][0] -= 1
            if span is not None:
                span.end(status=status)

    # ----------------------------------------------------- engine path
    def _engine_generate(self, engine, prompt, mt, temperature, seed,
                         stream, span=None, resume=None) -> None:
        trace = span.context() if span is not None else None
        if trace is None and reqlog.ENABLED:
            # Request-analytics join key: with tracing disarmed the LB
            # still stamps X-STPU-Trace (a reqlog-minted id, sampled
            # flag 00), and carrying it into the engine keys the
            # engine half of the request record. extract/parse are
            # pure string work — no tracing I/O, and the 00 flag keeps
            # every engine tracing guard short-circuited.
            trace = tracing.extract(self.headers)
        # Resume admission: ``mt`` is the ORIGINAL request budget — the
        # engine re-prefills the emitted tokens as a prompt extension
        # and regenerates only the remainder, emitting from the same
        # absolute positions (same seed) the dead upstream would have.
        remaining = mt - (len(resume) if resume else 0)
        req = engine.submit(prompt, max_tokens=remaining,
                            temperature=temperature, seed=seed,
                            trace=trace, resume=resume)
        timeout = self.server_ctx["stream_timeout"]
        if not stream:
            self._json(200, {"tokens": req.result(timeout=timeout)})
            return
        it = req.stream(timeout=timeout)
        try:
            # First token BEFORE the headers go out: a prefill
            # error must still be reportable as a clean JSON error, not
            # a corrupted half-stream.
            first = next(it)
        except decode_engine.EngineError as e:
            if span is not None:
                # end() here (idempotent — do_POST's finally no-ops)
                # so a 503'd stream records error like the non-stream
                # path, not a healthy-looking hop.
                span.event("engine_error", error=str(e))
                span.end(status="error")
            self._json(503, {"error": str(e)})
            return
        except StopIteration:
            self._json(200, {"tokens": []})
            return
        self._sse(req, [first], it, span,
                  resume_len=len(resume) if resume else 0)

    # ----------------------------------------------------- legacy path
    def _legacy_generate(self, ctx, prompt, mt, temperature, seed,
                         stream, span=None) -> None:
        s = len(prompt)
        s_pad = _ceil_to(s, PROMPT_BUCKET)
        mt_pad = _ceil_to(mt, GEN_BUCKET)
        buf_np = np.zeros((s_pad,), np.int64)
        buf_np[:s] = prompt
        buf = to_device(buf_np, ctx["device"])
        if not stream:
            toks = _decode_locked(ctx, buf, s, mt_pad, temperature,
                                  seed)
            self._json(200, {"tokens": toks[:mt].tolist()})
            return
        cfg, params = ctx["cfg"], ctx["params"]
        key = prng.key(seed, buf.device)
        # Prefill BEFORE the headers go out (clean-error contract, as
        # above). The model lock is held ONLY around compute, never
        # across socket writes — a stalled client (TCP backpressure on
        # emit) must not block other requests.
        key, k = prng.split(key)
        with ctx["lock"]:
            tok, cache = _prefill(cfg, params, buf, s_pad + mt_pad, s,
                                  temperature, k)
            first = int(tok[0])

        def tokens():
            nonlocal tok, cache, key
            for i in range(mt - 1):
                key, k2 = prng.split(key)
                with ctx["lock"]:
                    tok, cache = _gen_step(cfg, params, tok, cache, s + i,
                                           temperature, k2)
                    nxt = int(tok[0])
                yield nxt

        self._sse(None, [first], tokens(), span)

    # ------------------------------------------------------------- SSE
    def _sse(self, req, first_tokens, rest_iter, span=None,
             resume_len: int = 0) -> None:
        """SSE token stream: one `data: {"token": N}` event per decoded
        token, flushed as produced (chunked transfer), then
        `data: [DONE]` — the OpenAI-style contract LLM clients expect.
        A mid-stream failure drops the connection (a JSON error would
        corrupt the stream; the truncated stream is the signal)."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        if resume_len:
            # Acknowledges the resume admission to the splicing LB:
            # this stream's first event is the token at absolute
            # position ``resume_len``, not position 0.
            self.send_header("X-STPU-Resume", str(resume_len))
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def emit(payload: str) -> None:
            write_chunk(self.wfile, f"data: {payload}\n\n".encode())

        t0 = time.perf_counter() if span is not None else 0.0
        sent = 0
        try:
            for tok in first_tokens:
                emit(json.dumps({"token": int(tok)}))
                sent += 1
            for tok in rest_iter:
                emit(json.dumps({"token": int(tok)}))
                sent += 1
            if reqlog.ENABLED and req is not None:
                self._emit_stats_frame(req)
            emit("[DONE]")
            end_chunks(self.wfile)
            if span is not None:
                # Stream-delivery child span: first flush → [DONE].
                tracing.record_span("replica.stream", "replica",
                                    span.context(), start_mono=t0,
                                    attrs={"tokens": sent})
        except Exception:  # noqa: BLE001 — client gone / engine died
            if req is not None:
                req.cancel()  # free the slot; don't decode into a void
            self.close_connection = True
            if span is not None:
                tracing.record_span("replica.stream", "replica",
                                    span.context(), start_mono=t0,
                                    status="error",
                                    attrs={"tokens": sent,
                                           "aborted": True})

    def _emit_stats_frame(self, req) -> None:
        """Trailing ``event: stats`` SSE frame (reqlog armed only): the
        engine half of the wide-event request record, assembled by
        _free_slot and readable once the token iterator exhausts
        (_DONE is queued after the record is attached), enriched with
        the engine-level fields the slot cannot see (quant modes,
        restarts survived). The LB strips this frame from the client
        stream and folds it into its half; a legacy LB/custom client
        that does not strip must ignore non-``data:``-only SSE events
        per the SSE spec. Emission failures fall through to _sse's
        abort path like any other mid-stream write error."""
        half = getattr(req, "reqlog_record", None)
        if half is None:
            return
        engine = self.server_ctx.get("engine")
        if engine is not None:
            kv = engine.kv_config()
            half["kv_quant"] = bool(kv.get("kv_quant"))
            half["weight_quant"] = bool(kv.get("weight_quant"))
            half["kv_paged"] = bool(kv.get("paged"))
            half["restarts"] = int(getattr(engine, "restarts", 0))
        write_chunk(self.wfile,
                    b"event: stats\ndata: "
                    + json.dumps(half, default=str).encode()
                    + b"\n\n")


def preempt_notice_watch(notice: threading.Event,
                         poll: float = None) -> None:
    """Watch the provider's preemption metadata signal.

    Real deployments poll the cloud metadata endpoint (e.g. the GCE
    ``instance/preempted`` key); this repro's signal source is the
    fault point ``replica.preempt_notice`` — an injected fault IS the
    notice, which makes the whole replace-ahead path game-day drivable.
    On a notice: set the shared event (surfaced via /health as
    ``preempt_notice: true``) and stop — the notice is terminal for
    this replica's lifetime; the controller takes it from there.
    """
    if poll is None:
        poll = PREEMPT_NOTICE_POLL
    while not notice.is_set():
        try:
            if fault_injection.ENABLED:
                fault_injection.fire("replica.preempt_notice")
        except fault_injection.InjectedFault:
            notice.set()
            _PREEMPT_NOTICES.inc()
            return
        time.sleep(poll)


def serve(cfg: llama.LlamaConfig, params, port: int,
          ready_event: threading.Event = None,
          engine_slots: int = None,
          prefix_cache_mb: float = None,
          stream_timeout: float = None,
          engine_max_restarts: int = None,
          engine_restart_backoff: float = None,
          kv_paged: bool = None,
          kv_pool_blocks: int = None,
          kv_block_tokens: int = None,
          kv_quant: bool = None,
          weight_quant: bool = None,
          spec_k: int = None,
          spec_ngram: int = None,
          spec_min_accept: float = None,
          device: DeviceLike = None
          ) -> ThreadingHTTPServer:
    """Start the replica server. ``engine_slots`` > 0 (default: env
    STPU_ENGINE_SLOTS or 4) serves through the continuous-batching
    decode engine; 0 keeps the legacy locked fixed-batch path.
    ``prefix_cache_mb`` (default: env STPU_PREFIX_CACHE_MB or 64) is
    the host-RAM KV spill tier budget in MiB under the paged pool's
    trie — evicted prefix blocks spill D2H and re-admit H2D on a warm
    match; 0 turns the tier off (dense mode has no trie and ignores
    it).
    ``stream_timeout`` (default: env STPU_STREAM_TIMEOUT or 600) is the
    per-token wait before a wedged engine surfaces as a clean error.
    ``kv_quant``/``weight_quant`` (default: env STPU_KV_QUANT /
    STPU_WEIGHT_QUANT or 0) serve int8 KV blocks / int8 params —
    ~2x KV capacity per device byte, not bit-identical to bf16.
    ``spec_k`` (default: env STPU_SPEC_K or 0) arms self-speculative
    decoding — k n-gram-drafted tokens per slot verified in one
    batched forward, bit-identical output.
    The engine runs under an EngineSupervisor: a crashed compute loop
    flips /health to 503 and is restarted with fresh state (capped
    backoff, ``engine_max_restarts`` consecutive fast failures →
    permanently down so the replica manager replaces the replica).
    ``device`` (default: the card) must hold ``params``; the CPU runs
    only on ``device="cpu"``. Mixtral configs raise a ValueError (its
    serving half is not ported)."""
    model_api(cfg)
    device = resolve_device(device)
    if engine_slots is None:
        engine_slots = ENGINE_SLOTS
    if prefix_cache_mb is None:
        prefix_cache_mb = ENGINE_PREFIX_CACHE_MB
    if stream_timeout is None:
        stream_timeout = STREAM_TIMEOUT_SECONDS
    if engine_max_restarts is None:
        engine_max_restarts = ENGINE_MAX_RESTARTS
    if engine_restart_backoff is None:
        engine_restart_backoff = ENGINE_RESTART_BACKOFF
    if kv_paged is None:
        kv_paged = ENGINE_KV_PAGED
    if kv_pool_blocks is None:
        kv_pool_blocks = ENGINE_KV_POOL_BLOCKS
    if kv_block_tokens is None:
        kv_block_tokens = ENGINE_KV_BLOCK_TOKENS
    if kv_quant is None:
        kv_quant = ENGINE_KV_QUANT
    if weight_quant is None:
        weight_quant = ENGINE_WEIGHT_QUANT
    if spec_k is None:
        spec_k = ENGINE_SPEC_K
    if spec_ngram is None:
        spec_ngram = ENGINE_SPEC_NGRAM
    if spec_min_accept is None:
        spec_min_accept = ENGINE_SPEC_MIN_ACCEPT
    ctx = {"cfg": cfg, "params": params, "lock": threading.Lock(),
           "device": device,
           "ready": ready_event or threading.Event(), "engine": None,
           "stream_timeout": float(stream_timeout),
           "draining": threading.Event(),
           "preempt_notice": threading.Event(),
           "inflight": [0], "inflight_lock": threading.Lock()}
    _TOPOLOGY_INFO.labels(hosts="1", tp="1").set(1)
    if engine_slots > 0:
        def _engine_factory():
            return decode_engine.DecodeEngine(
                cfg, params, slots=engine_slots,
                max_seq=MAX_PROMPT_TOKENS + MAX_GEN_TOKENS,
                prefix_cache_mb=prefix_cache_mb,
                paged=bool(kv_paged),
                kv_pool_blocks=int(kv_pool_blocks),
                kv_block_tokens=int(kv_block_tokens),
                kv_quant=bool(kv_quant),
                weight_quant=bool(weight_quant),
                spec_k=int(spec_k),
                spec_ngram=int(spec_ngram),
                spec_min_accept=float(spec_min_accept),
                device=device)

        ctx["engine"] = decode_engine.EngineSupervisor(
            _engine_factory, max_restarts=engine_max_restarts,
            backoff_base=engine_restart_backoff).start()

    handler = type("Handler", (_Handler,), {"server_ctx": ctx})
    httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
    httpd.engine = ctx["engine"]  # visible for shutdown/tests

    def warmup():
        if ctx["engine"] is not None:
            ctx["engine"].warmup()
        else:
            buf = torch.zeros((PROMPT_BUCKET,), dtype=torch.int64,
                              device=device)
            _decode_locked(ctx, buf, 8, GEN_BUCKET, 0.0, 0)
        ctx["ready"].set()

    threading.Thread(target=warmup, daemon=True).start()
    if PREEMPT_NOTICE_POLL > 0:
        threading.Thread(target=preempt_notice_watch,
                         args=(ctx["preempt_notice"],),
                         daemon=True, name="preempt-watch").start()
    return httpd


# --model choice -> the port's config.
MODELS = {
    "llama-tiny": llama.LlamaConfig.tiny,
    "llama3-8b": llama.LlamaConfig.llama3_8b,
    "mixtral-tiny": mixtral.MixtralConfig.tiny,
    "mixtral-8x7b": mixtral.MixtralConfig.mixtral_8x7b,
    "gemma-tiny": gemma.GemmaConfig.tiny,
    "gemma-2b": gemma.GemmaConfig.gemma_2b,
    "gemma-7b": gemma.GemmaConfig.gemma_7b,
}


def _build_model(args, device: torch.device):
    """The --model config (--dtype applied) and its random weights from
    --seed, through the family's own init (gemma's norms start at zero).
    A family whose serving is not ported raises before any init."""
    cfg = MODELS[args.model]()
    api = model_api(cfg)
    if args.dtype:
        cfg = dataclasses.replace(
            cfg, dtype={"bfloat16": torch.bfloat16,
                        "float32": torch.float32}[args.dtype])
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return cfg, api.init(cfg, gen, device)


def _refuse_not_ported(args) -> None:
    """The replica kinds the port does not serve yet raise a ValueError
    before anything is allocated."""
    if (args.replica_hosts or 1) > 1 or (args.tp or 1) > 1 or \
            int(os.environ.get(NUM_NODES, "1")) > 1 or \
            int(os.environ.get(NODE_RANK, "0")) > 0:
        raise ValueError(
            "gang and tensor-parallel serving (--replica-hosts > 1, --tp "
            f"> 1, {NUM_NODES} > 1, {NODE_RANK} > 0) are not ported yet: "
            "the port's replica serves on one card")
    if args.lb_port:
        raise ValueError(
            "the co-located load balancer (--lb-port) is not ported: run "
            "the JAX package's load balancer in front of this replica")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=sorted(MODELS), default="llama-tiny")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:0), which "
                        "raises when there is none. 'cpu' only on "
                        "request")
    p.add_argument("--replica-hosts", type=int, default=None,
                   help="hosts in the replica's serving gang; > 1 is not "
                        "ported and raises")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel degree; > 1 is not ported and "
                        "raises")
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default=None,
                   help="override the model compute dtype")
    p.add_argument("--engine-slots", type=int, default=None,
                   help="decode-engine slots (0 = legacy locked path; "
                        "default env STPU_ENGINE_SLOTS or 4)")
    p.add_argument("--prefix-cache-mb", type=float, default=None,
                   help="host-RAM KV spill tier budget in MiB under "
                        "the paged trie: LRU-evicted prefix blocks "
                        "spill D2H and re-admit H2D on a warm match. "
                        "0 = tier off (evictions drop). Default env "
                        "STPU_PREFIX_CACHE_MB or 64")
    p.add_argument("--kv-paged", type=int, choices=(0, 1),
                   default=None,
                   help="1 serves from the paged KV block pool (one "
                        "device pool + per-slot block tables; prefix "
                        "hits alias blocks zero-copy; admission is "
                        "free-block based). Default env STPU_KV_PAGED "
                        "or 1. Bit-identical to the dense path")
    p.add_argument("--kv-pool-blocks", type=int, default=None,
                   help="paged-KV pool size in blocks incl. scratch "
                        "(0 = auto: slots * max_seq / block + 1, the "
                        "dense budget; default env STPU_KV_POOL_BLOCKS)")
    p.add_argument("--kv-block-tokens", type=int, default=None,
                   help="paged-KV block size in tokens (also the "
                        "prefill chunk; 0 = the default 64-token "
                        "chunk; default env STPU_KV_BLOCK_TOKENS)")
    p.add_argument("--kv-quant", type=int, choices=(0, 1),
                   default=None,
                   help="1 stores int8 KV blocks (+ per-block/head "
                        "scales) in the paged pool — ~2x blocks at "
                        "the same budget; requires --kv-paged. Not "
                        "bit-identical to bf16. Default env "
                        "STPU_KV_QUANT or 0")
    p.add_argument("--weight-quant", type=int, choices=(0, 1),
                   default=None,
                   help="1 serves int8 per-channel-quantized params "
                        "(matmul weights + embed/lm_head; norms stay "
                        "full precision). Default env STPU_WEIGHT_QUANT "
                        "or 0")
    p.add_argument("--spec-k", type=int, default=None,
                   help="speculative decoding: tokens drafted per "
                        "slot per step from the slot's own n-gram "
                        "history, verified in one batched forward (0 "
                        "disables; default env STPU_SPEC_K or 0). "
                        "Output is bit-identical either way — greedy "
                        "AND seeded sampling")
    p.add_argument("--spec-ngram", type=int, default=None,
                   help="draft matcher n-gram length (default env "
                        "STPU_SPEC_NGRAM or 3)")
    p.add_argument("--spec-min-accept", type=float, default=None,
                   help="per-slot acceptance-rate floor below which a "
                        "slot stops drafting (default env "
                        "STPU_SPEC_MIN_ACCEPT or 0.2)")
    p.add_argument("--stream-timeout", type=float, default=None,
                   help="seconds to wait for the NEXT token before "
                        "failing the request as engine-stalled "
                        "(default env STPU_STREAM_TIMEOUT or 600)")
    p.add_argument("--engine-max-restarts", type=int, default=None,
                   help="consecutive fast engine-crash restarts before "
                        "the replica reports permanently unhealthy "
                        "(default env STPU_ENGINE_MAX_RESTARTS or 3)")
    p.add_argument("--lb-port", type=int, default=0,
                   help="the co-located load balancer: not ported, "
                        "raises")
    args = p.parse_args(argv)
    _refuse_not_ported(args)
    device = resolve_device(args.device)
    cfg, params = _build_model(args, device)

    httpd = serve(cfg, params, args.port,
                  engine_slots=args.engine_slots,
                  prefix_cache_mb=args.prefix_cache_mb,
                  stream_timeout=args.stream_timeout,
                  engine_max_restarts=args.engine_max_restarts,
                  kv_paged=args.kv_paged,
                  kv_pool_blocks=args.kv_pool_blocks,
                  kv_block_tokens=args.kv_block_tokens,
                  kv_quant=args.kv_quant, weight_quant=args.weight_quant,
                  spec_k=args.spec_k, spec_ngram=args.spec_ngram,
                  spec_min_accept=args.spec_min_accept, device=device)

    def _term(signum, frame):
        del signum, frame
        # Flight recorder first: a SIGTERM'd replica's last step ring
        # is the only record of what it was doing when the teardown /
        # scale-down landed (armed replicas only).
        if stepstats.ENABLED:
            stepstats.dump_flight("sigterm")
        os._exit(143)
    signal.signal(signal.SIGTERM, _term)
    print(f"serve_llm: listening on :{args.port}", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
