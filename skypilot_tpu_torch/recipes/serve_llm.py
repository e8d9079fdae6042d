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

Mixtral serves through its dense-routed MoE cache path. Its 8x7B is 93.4
GB in bf16, more than one 80 GB card holds: ``--model mixtral-8x7b
--weight-quant 1`` draws its int8 tree a layer at a time (46.7 GB), and
a tree that does not fit the card's free memory is refused before it is
drawn.
Runs on the card unless given ``--device cpu``. ``--lb-port N`` also
starts the port's load balancer (``serve/load_balancer.py``) in the same
process on port N, fronting this replica (``--lb-policy round_robin`` or
``prefix_affinity``).

Gang and tensor-parallel replicas (``serve/gang_replica.py``):
``--replica-hosts N --tp K`` (or ``STPU_REPLICA_TOPOLOGY``) serves one
replica from N x K processes, one per card. Outside a gang launch the
process started by hand is host 0's tp rank 0: it spawns the others on
this machine (tp rank r on ``cuda:r``; ``--device`` given carries to every
rank, ``--device cpu`` too), fronts HTTP as the ``GangLeader`` and
broadcasts each admission to the other hosts' rank 0 (under
``gang_admit_lock``, with its own submit). Each host's tp ranks form a
process group (``--tp-backend``: NCCL on the card by default, gloo on the
CPU; gloo also for two ranks sharing one card). /health covers every
rank; a dead one restarts the whole gang; drain and SIGTERM reach every
rank.

    python -m skypilot_tpu_torch.recipes.serve_llm --model llama3-8b \
        --tp 2 --port 8080      # two cards; --replica-hosts 2: four
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device, to_device
from skypilot_tpu_torch.models import (family_name, gemma, llama, mixtral,
                                       model_api)
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import reqlog
from skypilot_tpu_torch.observability import stepstats
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.serve import decode_engine
from skypilot_tpu_torch.serve import gang_replica
from skypilot_tpu_torch.serve import load_balancer as lb_lib
from skypilot_tpu_torch.serve import load_balancing_policies
from skypilot_tpu_torch.serve import prng
from skypilot_tpu_torch.train import distributed
from skypilot_tpu_torch.utils import fault_injection

# The gang env contract (the JAX package's ``agent/constants.py``).
NODE_RANK = distributed.NODE_RANK
NUM_NODES = distributed.NUM_NODES


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
            gang = ctx.get("gang")
            if not ready:
                self._json(503, {"status": "warming"})
            elif gang is not None and not gang.healthy():
                # Gang replicas probe as ONE unit: host 0's /health
                # speaks for every rank (the leader's membership
                # monitor), so a dead rank never hides behind a READY
                # replica.
                self._json(503, {"status": "gang_degraded"})
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
            gang = self.server_ctx.get("gang")
            if gang is None:
                self._json(404, {"error": "not a gang replica"})
            else:
                self._json(200, {
                    "topology": gang.topology.to_config(),
                    "label": gang.topology.label(),
                    "healthy": gang.healthy(),
                    "restarts": gang.restarts,
                    "members": gang.members_info()})
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
                # replica decodes with and which manifest supplied them
                # (its sha tag, or "default").
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
        gang = ctx.get("gang")
        if gang is not None:
            # Drain is gang-wide: the other hosts' engines stop
            # admitting too.
            gang.drain()
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
        gang = self.server_ctx.get("gang")
        if gang is not None:
            # Mirror the admission (prompt + sampling seed) to every
            # other host BEFORE the local submit, so every host sees the
            # same request order. Broadcast + local submit are ONE
            # critical section: concurrent handlers interleaving them
            # would admit (A, B) on a follower but (B, A) here.
            with self.server_ctx["gang_admit_lock"]:
                gang.broadcast_generate(prompt, remaining, temperature,
                                        seed, trace=trace, resume=resume)
                req = engine.submit(prompt, max_tokens=remaining,
                                    temperature=temperature, seed=seed,
                                    trace=trace, resume=resume)
        else:
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
            lb_lib.write_chunk(self.wfile, f"data: {payload}\n\n".encode())

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
            lb_lib.end_chunks(self.wfile)
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
        lb_lib.write_chunk(self.wfile,
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
          device: DeviceLike = None,
          topology: "gang_replica.ReplicaTopology" = None,
          mesh=None, rules=None,
          gang: "gang_replica.GangLeader" = None,
          tp_group: "gang_replica.TpGroup" = None
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
    only on ``device="cpu"``.

    Sharded replicas (``serve/gang_replica.py``): ``mesh``/``rules`` make
    the engine tensor-parallel (``params`` the rank's
    ``gang_replica.shard_params`` tree; ``tp_group``, when given, is
    rejoined by each engine build after a gang restart tore it down), and
    ``gang`` is host 0's GangLeader: admissions broadcast to the other
    hosts, /health covers every rank, drain propagates, and an engine
    crash-restart restarts every host's engine, while a dead rank leaves
    the engine to the gang's restart."""
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
           "draining": threading.Event(), "gang": gang,
           "gang_admit_lock": threading.Lock(),
           "preempt_notice": threading.Event(),
           "inflight": [0], "inflight_lock": threading.Lock()}
    _TOPOLOGY_INFO.labels(
        hosts=str(topology.hosts if topology else 1),
        tp=str(topology.tp if topology else 1)).set(1)
    if mesh is not None and engine_slots <= 0:
        raise ValueError("a tensor-parallel replica serves through the "
                         "decode engine (engine_slots > 0)")
    if engine_slots > 0:
        first_build = [True]

        def _engine_factory():
            if gang is not None and not first_build[0]:
                # Supervisor crash-restart: the other hosts rebuild in
                # lockstep, or the gang serves from desynced caches.
                gang.broadcast_restart()
            first_build[0] = False
            return decode_engine.DecodeEngine(
                cfg, params, slots=engine_slots,
                max_seq=MAX_PROMPT_TOKENS + MAX_GEN_TOKENS,
                prefix_cache_mb=prefix_cache_mb,
                mesh=(tp_group.connect() if tp_group is not None
                      else mesh), rules=rules,
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
            backoff_base=engine_restart_backoff,
            defer=((lambda: not gang.healthy()) if gang is not None
                   else None)).start()

    handler = type("Handler", (_Handler,), {"server_ctx": ctx})
    httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
    httpd.engine = ctx["engine"]  # visible for shutdown/tests
    httpd.gang = gang

    def warmup():
        if gang is not None and not gang.wait_ready():
            # Probes keep seeing "warming": the replica manager's
            # initial-delay deadline replaces the half-formed gang.
            return
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


def _build_model(args, device: torch.device, mesh=None, rules=None):
    """The --model config (--dtype applied) and its random weights from
    --seed, through the family's own init (gemma's norms start at zero,
    mixtral's router is f32). Under --weight-quant 1 (or env
    STPU_WEIGHT_QUANT) mixtral's tree is drawn int8 a layer at a time
    (the engine then serves it as it is; other families are quantized by
    the engine). On a tp mesh the rank's serving tree of that same tree
    (``gang_replica.shard_init``: int8 under --weight-quant 1 for every
    family, quantized whole before it is split; Mixtral a layer at a
    time). A tree (a rank's share of it under tp) larger than the card's
    free memory raises a ValueError before anything is drawn."""
    cfg = MODELS[args.model]()
    api = model_api(cfg)
    if args.dtype:
        cfg = dataclasses.replace(
            cfg, dtype={"bfloat16": torch.bfloat16,
                        "float32": torch.float32}[args.dtype])
    weight_quant = ENGINE_WEIGHT_QUANT if args.weight_quant is None \
        else bool(args.weight_quant)
    int8 = weight_quant and api is mixtral
    tp = 1
    if mesh is not None:
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        tp = mesh_lib.axis_size(mesh, mesh_lib.TP)
    if device.type == "cuda":
        need = cfg.num_params() * (1 if int8 else cfg.dtype.itemsize) / tp
        free = torch.cuda.mem_get_info(device)[0]
        if need > free:
            raise ValueError(
                f"--model {args.model} is {need / 1e9:.1f} GB in "
                f"{'int8' if int8 else cfg.dtype}"
                f"{f' a rank at tp {tp}' if tp > 1 else ''}, more than the "
                f"{free / 1e9:.1f} GB free on {device}" +
                (": serve it with --weight-quant 1" if api is mixtral
                 and not int8 else ""))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if mesh is not None:
        return cfg, gang_replica.shard_init(cfg, gen, device, mesh, rules,
                                            quantize=weight_quant)
    if int8:
        return cfg, api.init(cfg, gen, device, quantize=True)
    return cfg, api.init(cfg, gen, device)


def _resolve_kv(args) -> dict:
    """CLI flags > STPU_KV_* env > defaults, resolved ONCE and used for
    the local engine, every other rank's engine and the gang welcome's
    geometry check."""
    def pick(value, default, cast):
        return cast(value) if value is not None else default
    return {
        "paged": pick(args.kv_paged, ENGINE_KV_PAGED, bool),
        "pool_blocks": pick(args.kv_pool_blocks, ENGINE_KV_POOL_BLOCKS,
                            int),
        "block_tokens": pick(args.kv_block_tokens, ENGINE_KV_BLOCK_TOKENS,
                             int),
        "kv_quant": pick(args.kv_quant, ENGINE_KV_QUANT, bool),
        "weight_quant": pick(args.weight_quant, ENGINE_WEIGHT_QUANT, bool),
        "spec_k": pick(args.spec_k, ENGINE_SPEC_K, int),
        "spec_ngram": pick(args.spec_ngram, ENGINE_SPEC_NGRAM, int),
        "spec_min_accept": pick(args.spec_min_accept,
                                ENGINE_SPEC_MIN_ACCEPT, float),
        "prefix_cache_mb": pick(args.prefix_cache_mb,
                                ENGINE_PREFIX_CACHE_MB, float),
    }


def _check_topology(args, topology, cfg, device: torch.device) -> None:
    """What a sharded replica cannot serve raises before any rank is
    spawned: tp over the legacy locked path, NCCL on the CPU, a model
    whose heads, MLP or vocab tp does not divide, and a tp group larger
    than this host's cards (a group across nodes is not served)."""
    tp = topology.tp
    if tp <= 1:
        return
    if args.engine_slots == 0:
        raise ValueError("a tensor-parallel replica serves through the "
                         "decode engine: --engine-slots 0 (the legacy "
                         "locked path) has no tp")
    if args.tp_backend == "nccl" and device.type != "cuda":
        raise ValueError("--tp-backend nccl needs the card (NCCL); the "
                         "CPU runs gloo")
    for name in ("n_heads", "mlp_dim", "vocab_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"--model {args.model}: {name}="
                             f"{getattr(cfg, name)} not divisible by "
                             f"--tp {tp}")
    gang_replica.local_kv_heads(cfg, tp)
    if args.device is None and device.type == "cuda" and \
            torch.cuda.device_count() < tp:
        raise gang_replica.GangError(
            f"--tp {tp} needs {tp} cards on this host, it has "
            f"{torch.cuda.device_count()}: a tp group spans one host's "
            "cards (a group across nodes is not served), or pass --device "
            "and --tp-backend gloo to share one card")


def _resolve_topology(args) -> gang_replica.ReplicaTopology:
    """CLI flags > STPU_REPLICA_TOPOLOGY env (stamped by the replica
    manager) > unsharded default."""
    if args.replica_hosts or args.tp:
        hosts = int(args.replica_hosts or 1)
        tp = int(args.tp or 1)
        return gang_replica.ReplicaTopology(
            hosts=hosts, ici_axes={"tp": tp} if tp > 1 else {})
    return (gang_replica.ReplicaTopology.from_env()
            or gang_replica.ReplicaTopology())


# Flags a self-spawned rank inherits from host 0's command line.
_MEMBER_FLAGS = ("dtype", "device", "tp_backend", "engine_slots",
                 "prefix_cache_mb", "kv_paged", "kv_pool_blocks",
                 "kv_block_tokens", "kv_quant", "weight_quant", "spec_k",
                 "spec_ngram", "spec_min_accept", "stream_timeout")


def _spawn_follower_cmd(args, rank: int, topology, leader_port: int,
                        tp_addrs: dict):
    """Self-spawn dev gang (``--replica-hosts N --tp K`` outside a gang
    launch): gang rank ``rank`` (host ``rank // K``, tp rank ``rank %
    K``) as a process on THIS machine, with the rank/env contract a
    gang-launched host would see (SKYPILOT_NODE_RANK, the leader's gang
    channel, its host's tp rendezvous, STPU_TRACE_CTX propagation)."""
    host, tp_rank = divmod(rank, topology.tp)
    env = dict(os.environ)
    env[NODE_RANK] = str(host)
    env[NUM_NODES] = str(topology.hosts)
    env[gang_replica.GANG_ADDR_ENV] = f"127.0.0.1:{leader_port}"
    env[gang_replica.TP_ADDR_ENV] = tp_addrs[host]
    env[gang_replica.TP_RANK_ENV] = str(tp_rank)
    env.update(tracing.child_env())
    argv = [sys.executable, "-m", "skypilot_tpu_torch.recipes.serve_llm",
            "--model", args.model, "--seed", str(args.seed),
            "--port", str(args.port),
            "--replica-hosts", str(topology.hosts),
            "--tp", str(topology.tp)]
    for name in _MEMBER_FLAGS:
        value = getattr(args, name)
        if value is not None:
            argv += ["--" + name.replace("_", "-"),
                     str(int(value) if isinstance(value, bool) else value)]
    return subprocess.Popen(argv, env=env, start_new_session=True)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=sorted(MODELS), default="llama-tiny")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:0), which "
                        "raises when there is none. 'cpu' only on "
                        "request")
    p.add_argument("--replica-hosts", type=int, default=None,
                   help="hosts in this replica's serving gang (default "
                        "env STPU_REPLICA_TOPOLOGY or 1). Outside a "
                        "gang launch, host 0 self-spawns the other "
                        "processes: the single-machine dev analog of a "
                        "gang-scheduled slice")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel degree: each host's ranks (one "
                        "per card, rank r on cuda:r) split params and KV "
                        "cache by parallel/mesh.py's rules")
    p.add_argument("--tp-backend", choices=("nccl", "gloo"), default=None,
                   help="the tp group's backend (default NCCL on the "
                        "card, gloo on the CPU; gloo when ranks share a "
                        "card, which NCCL refuses)")
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
                   help="also start an in-process load balancer on "
                        "this port fronting the replica — the "
                        "single-host dev analog of the `stpu serve` "
                        "data plane")
    p.add_argument("--lb-policy",
                   choices=sorted(
                       load_balancing_policies.POLICIES),
                   default=None,
                   help="routing policy for the --lb-port balancer; "
                        "prefix_affinity keeps shared-prefix traffic "
                        "on the replica whose prefix cache is warm. "
                        "Deployed services set "
                        "service.load_balancing_policy in the YAML "
                        "instead.")
    return p


def main(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    if args.lb_policy and not args.lb_port:
        p.error("--lb-policy only configures the --lb-port balancer; "
                "deployed services set service.load_balancing_policy "
                "in the YAML")
    topology = _resolve_topology(args)
    host = int(os.environ.get(NODE_RANK, "0"))
    tp_rank = int(os.environ.get(gang_replica.TP_RANK_ENV, "0"))
    rank = host * topology.tp + tp_rank
    # Every rank on the device given, or rank r on card r.
    device = resolve_device(args.device if args.device is not None or
                            not tp_rank else f"cuda:{tp_rank}")
    _check_topology(args, topology, MODELS[args.model](), device)
    kv = _resolve_kv(args)
    engine_slots = args.engine_slots if args.engine_slots else ENGINE_SLOTS
    # The welcome compares EFFECTIVE geometry (auto-sized pool included),
    # not raw knobs.
    kv_geo = decode_engine.resolve_kv_geometry(
        slots=engine_slots, max_seq=MAX_PROMPT_TOKENS + MAX_GEN_TOKENS,
        paged=kv["paged"], kv_pool_blocks=kv["pool_blocks"],
        kv_block_tokens=kv["block_tokens"], kv_quant=kv["kv_quant"],
        weight_quant=kv["weight_quant"], spec_k=kv["spec_k"],
        spec_ngram=kv["spec_ngram"], spec_min_accept=kv["spec_min_accept"],
        host_cache_mb=kv["prefix_cache_mb"] if kv["paged"] else 0.0,
        family=family_name(MODELS[args.model]()), tp=topology.tp)
    gang_launched = (int(os.environ.get(NUM_NODES, "1")) > 1 and
                     not os.environ.get(gang_replica.GANG_ADDR_ENV))
    gang = group = None
    tp_addrs = {h: gang_replica.free_addr() for h in range(topology.hosts)}
    if topology.is_sharded and rank == 0:
        if gang_launched:
            # Members derive the channel address from the env contract
            # (head ip + serving port + offset), so the port is fixed.
            gang = gang_replica.GangLeader(
                topology, port=args.port + gang_replica.GANG_PORT_OFFSET,
                kv_config=kv_geo)
        else:
            # Self-spawn dev gang: OS-assigned channel port, members on
            # this machine with the addresses stamped explicitly (the
            # lambda reads gang.port after construction binds it).
            gang = gang_replica.GangLeader(
                topology, spawn=lambda r: _spawn_follower_cmd(
                    args, r, topology, gang.port, tp_addrs),
                kv_config=kv_geo)
            gang.start_followers()
    mesh = rules = None
    if topology.tp > 1:
        # This host's tp group (its rendezvous waits for every rank).
        group = (gang_replica.TpGroup(tp=topology.tp, rank=0,
                                      addr=tp_addrs[0], device=device,
                                      backend=args.tp_backend)
                 if rank == 0 and not gang_launched else
                 gang_replica.TpGroup.from_env(
                     topology, host=host, serving_port=args.port,
                     device=device, backend=args.tp_backend))
        mesh, rules = gang_replica.build_mesh(topology, group)
    cfg, params = _build_model(args, device, mesh, rules)
    engine_kw = dict(
        slots=engine_slots, max_seq=MAX_PROMPT_TOKENS + MAX_GEN_TOKENS,
        prefix_cache_mb=kv["prefix_cache_mb"], paged=kv["paged"],
        kv_pool_blocks=kv["pool_blocks"],
        kv_block_tokens=kv["block_tokens"], kv_quant=kv["kv_quant"],
        weight_quant=kv["weight_quant"], spec_k=kv["spec_k"],
        spec_ngram=kv["spec_ngram"], spec_min_accept=kv["spec_min_accept"],
        device=device)
    if rank > 0:
        # Every other rank: no HTTP. A host's tp rank 0 mirrors the
        # leader's admissions into its engine; every other tp rank serves
        # its rank 0's plans.
        def _member_engine():
            return decode_engine.DecodeEngine(
                cfg, params, mesh=group.connect() if group else None,
                rules=rules, **engine_kw)
        serve_fn = (gang_replica.tp_worker_serve if tp_rank
                    else gang_replica.follower_serve)
        sys.exit(serve_fn(_member_engine, topology,
                          gang_replica.follower_addr(args.port), rank,
                          kv_config=kv_geo))

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
                  spec_min_accept=args.spec_min_accept, device=device,
                  topology=topology, mesh=mesh, rules=rules, gang=gang,
                  tp_group=group)
    if gang is not None and httpd.engine is not None:
        # Whole-gang restart rebuilds host 0's engine too, after its tp
        # group (if any) was torn down and the members respawned.
        gang.set_engine_reset(httpd.engine.restart_now)
        if group is not None and not gang_launched:
            gang.set_teardown(lambda: _tp_teardown(httpd.engine, group,
                                                   tp_addrs))

    def _term(signum, frame):
        del signum, frame
        # Flight recorder first: a SIGTERM'd replica's last step ring
        # is the only record of what it was doing when the teardown /
        # scale-down landed (armed replicas only).
        if stepstats.ENABLED:
            stepstats.dump_flight("sigterm")
        if gang is not None:
            # SIGTERM reaches every rank: members get an explicit
            # shutdown, self-spawned ones are reaped.
            gang.shutdown()
        os._exit(143)
    signal.signal(signal.SIGTERM, _term)
    if args.lb_port:
        policy = load_balancing_policies.make_policy(args.lb_policy)
        policy.set_ready_replicas([f"http://127.0.0.1:{args.port}"])
        lb_lib.run_load_balancer(args.lb_port, policy,
                                 lb_lib.RequestRecorder())
        print(f"serve_llm: LB ({args.lb_policy or 'round_robin'}) "
              f"on :{args.lb_port}", flush=True)
    print(f"serve_llm: listening on :{args.port}", flush=True)
    httpd.serve_forever()


def _tp_teardown(supervisor, group, tp_addrs: dict) -> None:
    """A whole-gang restart's host-0 half, after the members were killed:
    stop the engine and tear its tp group down (gloo first stops the
    engine, whose collective fails on the dead peers; an NCCL group is
    aborted first, so a collective waiting on them returns), then point
    every host at a fresh rendezvous for the respawned ranks."""
    engine = supervisor.engine
    nccl = group.connected and torch.distributed.get_backend() == "nccl"
    if nccl:
        group.close()
    if engine is not None:
        engine.shutdown()
    if group.connected:
        group.close()
    tp_addrs.update({h: gang_replica.free_addr() for h in tp_addrs})
    group.addr = tp_addrs[0]


if __name__ == "__main__":
    main()
