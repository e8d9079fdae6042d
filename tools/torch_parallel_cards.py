#!/usr/bin/env python3
"""Training and serving across ranks on every card of one machine: the
port's sharded step, ring attention and pipeline over NCCL, and its
tensor-parallel replica, each held to the same work on one card.

    python3 tools/torch_parallel_cards.py [world1] [step] [ring] [tp_serve] [ep] [pipe]

[world1] runs on one card; [step], [ring], [tp_serve], [ep] and [pipe]
need an even count of 2+. With no phase named, the first three run
([step] includes [pipeline]); [tp_serve], [ep] and [pipe] run when
named.

The script launches one process per card itself, as a gang host's
torchrun would: LOCAL_RANK / LOCAL_WORLD_SIZE and the SKYPILOT_* env
(one node, the coordinator on 127.0.0.1 and a free port), so each
process brings its NCCL group up through
``distributed.initialize_from_env()`` on ``cuda:<LOCAL_RANK>``. Phases
(rank 0 prints; every number is this run's):

- [world1] chip_smoke.py's [parallel] phase on card 0, in this process,
  before the others start (a world-1 NCCL group it destroys at its end).
- [step] Llama-3-8B widths, N_LAYERS layers, the global batch
  BATCH x SEQ, bf16, adamw, full remat, on {"fsdp": n/2, "tp": 2}: the
  sharded step's losses against the one-card step's on the same batch
  (rank 0 runs it first), per-rank flash launches (2L/L/L a step) and
  both median step times.
- [pipeline] the same model on {"pp": 2, "tp": n/2}: forward_pipelined
  at 2 microbatches against forward (norm-relative), then STEPS steps
  through it against the one-card losses.
- [ring] attention at Llama-3-8B's shape (1, 8192, 32, 8, 128) on
  {"sp": n}, causal and not: each card holds one chunk; the output and
  the gradients of sum(out * dO), gathered, against the flash op on the
  whole sequence (one card), norm-relative; both timed.

- [ep] Mixtral-8x7B widths, bf16, full remat, the global batch
  BATCH x SEQ, through recipes/mixtral_ep.build (the recipe's weights
  from its seed, its adamw) on
  {"ep": n} (8 / n experts a card, the batch on every card): first at
  EP_CMP_LAYERS layers, its losses, aux losses and final parameters
  against the one-card step from the same weights (rank 0 runs it
  first) within LOSS_TOL, launches 2L/L/L a step on every rank; then at
  EP_BIG_LAYERS layers, a depth one card cannot hold under adamw, timed
  (median step, tokens/s, peak memory a card).

- [pipe] the [step] model on a mesh of {"pp": n} alone (a stage is one
  card, N_LAYERS / n layers; PIPELINE_RULES, 2 microbatches, full
  remat) with adafactor: STEPS steps from the one-card weights, and a
  state placed onto the mesh after one one-card step (place_state of an
  adafactor state) then STEPS - 1 steps, both against the one-card
  adafactor steps (rank 0 runs them first) within LOSS_TOL; rank 0's
  launches 2 x 2 x N_LAYERS / n forwards and half as many dq and dk/dv
  a step; both median step times. It runs here, not on chip_smoke.py's
  one card: gloo's send/recv of CUDA tensors, which the pipeline's
  stage boundaries use, kills the process (torch 2.11).

- [tp_serve] serve_llm replicas, each from this process: Llama-3-8B at
  full depth, bf16, on one card, at tp 2 and at tp n (NCCL, rank r on
  cuda:r), TP_SLOTS greedy requests of TP_CONTEXT prompt tokens and
  TP_TOKENS new ones at once; each replica's decode-step ms (its
  /perf, STPU_STEPSTATS) and tokens/s, and its streams against one
  card's (printed: bf16 near-ties); then Mixtral-8x7B in bf16 at full
  depth on tp n (a rank draws and keeps a layer's shard at a time:
  23.4 GB a card at tp 4), its streams against the int8 tree's on one
  card (printed, not gated); then tp 2's rank 1 SIGKILLed mid-stream
  under NCCL: the seconds to 503 and back to 200 (the whole-gang
  restart aborts the group), or that it never came back within
  TP_RECOVER_S.

Exit 0 only when every gate holds; the last line is a JSON summary.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
N_LAYERS = 4
BATCH, SEQ = 4, 2048
STEPS = 6
LOSS_TOL = 2e-2
PIPE_REL_TOL = 2e-2
RING_SHAPE = (1, 8192, 32, 8, 128)
OUT_REL_TOL, GRAD_REL_TOL = 1e-2, 2e-2
TP_SLOTS, TP_CONTEXT, TP_TOKENS = 8, 1024, 64
EP_CMP_LAYERS, EP_BIG_LAYERS, EP_SEED = 2, 8, 4
TP_VOCAB = 32000        # prompt token ids: Mixtral's vocab, inside Llama-3's
TP_RECOVER_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url, body=None, timeout=600):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except OSError:
        return None, b""


class _Replica:
    """One serve_llm replica (and the gang it spawns) on this machine."""

    def __init__(self, *argv):
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "skypilot_tpu_torch.recipes.serve_llm",
             "--seed", "5", "--port", str(self.port), "--engine-slots",
             str(TP_SLOTS), "--kv-block-tokens", "64", *argv], cwd=REPO,
            env=dict(os.environ, STPU_STEPSTATS="1",
                     STPU_TUNE_MANIFEST="0"),
            stdout=subprocess.DEVNULL, start_new_session=True)

    def wait(self, code, seconds):
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            if _http(self.base + "/health", timeout=5)[0] == code:
                return True
            if self.proc.poll() is not None:
                return False
            time.sleep(0.1)
        return False

    def run(self, prompts):
        """The prompts at once, greedy: (streams, wall s, decode ms)."""
        import threading
        out = [None] * len(prompts)

        def one(i):
            # A request a rank's death cut answers 503 with an error.
            out[i] = json.loads(_http(self.base + "/generate", {
                "prompt": prompts[i], "max_tokens": TP_TOKENS})[1] or
                b"{}").get("tokens")
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        perf = json.loads(_http(self.base + "/perf")[1])
        dec = perf["phases"].get("decode", {})
        return out, wall, dec.get("seconds", 0) / max(dec.get("steps", 1),
                                                       1) * 1e3

    def stop(self):
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.wait()


def _serve(label, argv, prompts, out, card):
    rep = _Replica(*argv)
    try:
        _check(rep.wait(200, 900), f"[tp_serve] {label} never ready")
        up = time.perf_counter() - rep.t0
        streams, wall, step = rep.run(prompts)
    finally:
        rep.stop()
    tok_s = len(prompts) * TP_TOKENS / wall
    out[label] = {"up_s": up, "wall_s": wall, "tokens_per_s": tok_s,
                  "decode_step_ms": step, "streams": streams}
    print(f"[tp_serve] {label}: up in {up:.1f} s; {len(prompts)} x "
          f"{TP_CONTEXT}+{TP_TOKENS} tokens in {wall:.2f} s, {tok_s:.1f} "
          f"tokens/s; decode step {step:.1f} ms mean ({card})", flush=True)
    return streams


def _agree(a, b):
    first = [next((i for i, (x, y) in enumerate(zip(s, t)) if x != y),
                  None) for s, t in zip(a, b)]
    same = sum(x == y for s, t in zip(a, b) for x, y in zip(s, t))
    return f"{same} of {sum(map(len, a))} tokens equal, first divergences " \
        f"{first}"


def phase_tp_serve(n):
    """[tp_serve] (module docstring), from the launching process."""
    import threading
    from skypilot_tpu_torch.serve import gang_replica
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = "; ".join(sorted(set(cards.strip().splitlines())))
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(1, TP_VOCAB, (TP_CONTEXT,),
                             generator=gen).tolist()
               for _ in range(TP_SLOTS)]
    out = {"card": card}
    one = _serve("llama3-8b one card", ["--model", "llama3-8b"], prompts,
                 out, card)
    for tp in sorted({2, n}):
        got = _serve(f"llama3-8b tp {tp}", ["--model", "llama3-8b", "--tp",
                                            str(tp)], prompts, out, card)
        print(f"[tp_serve] llama3-8b tp {tp} vs one card: "
              f"{_agree(got, one)}", flush=True)
    q = _serve("mixtral-8x7b int8 one card",
               ["--model", "mixtral-8x7b", "--weight-quant", "1"], prompts,
               out, card)
    mx = _serve(f"mixtral-8x7b bf16 tp {n}",
                ["--model", "mixtral-8x7b", "--tp", str(n)], prompts, out,
                card)
    print(f"[tp_serve] mixtral-8x7b bf16 tp {n} vs int8 one card (not "
          f"gated): {_agree(mx, q)}", flush=True)
    # A rank killed under NCCL.
    rep = _Replica("--model", "llama3-8b", "--tp", "2")
    try:
        _check(rep.wait(200, 900), "[tp_serve] failover replica never ready")
        members = json.loads(_http(rep.base + "/gang")[1])["members"]
        victim = [m["pid"] for m in members if m["role"] == "tp"][0]
        threading.Thread(target=rep.run, args=(prompts,),
                         daemon=True).start()
        time.sleep(10)
        t0 = time.perf_counter()
        os.kill(victim, 9)
        down = rep.wait(503, 120)
        t503 = time.perf_counter() - t0
        back = rep.wait(200, TP_RECOVER_S)
        t200 = time.perf_counter() - t0
        status, body = _http(rep.base + "/generate", {
            "prompt": prompts[0], "max_tokens": 8}, timeout=300)
        out["failover"] = {"503": down, "503_s": t503, "recovered": back,
                           "200_s": t200, "after": status,
                           "leader_alive": rep.proc.poll() is None}
        print(f"[tp_serve] tp 2, rank 1 SIGKILLed under NCCL mid-stream: "
              f"503 {down} after {t503:.2f} s; 200 {back} after "
              f"{t200:.1f} s (limit {TP_RECOVER_S} s; group timeout "
              f"{gang_replica.TP_TIMEOUT_SECONDS:g} s); next request "
              f"HTTP {status}; leader alive {rep.proc.poll() is None} "
              f"({card})", flush=True)
    finally:
        rep.stop()
    return {k: {kk: vv for kk, vv in v.items() if kk != "streams"}
            if isinstance(v, dict) else v for k, v in out.items()}


def _launch(phases) -> int:
    n = torch.cuda.device_count()
    if set(phases) - {"world1"} and (n < 2 or n % 2):
        print(f"FAIL: {n} cards; [step], [ring] and [tp_serve] need an "
              "even count of at least 2", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from skypilot_tpu_torch.ops import _build
    _build.build_all()  # once, before the processes that load it
    if "world1" in phases:
        import chip_smoke
        from skypilot_tpu_torch.models import llama
        from skypilot_tpu_torch.ops import attention as attention_ops
        from skypilot_tpu_torch.ops import flash_attention as fa
        from skypilot_tpu_torch.train import trainer
        print(chip_smoke.phase_device(), flush=True)
        chip_smoke.phase_parallel(fa, llama, trainer, attention_ops)
        torch.cuda.empty_cache()
        phases = [p for p in phases if p != "world1"]
        if not phases:
            return 0
    if "tp_serve" in phases:
        try:
            summary = phase_tp_serve(n)
        except RuntimeError as e:
            print(f"FAIL: {e}", file=sys.stderr, flush=True)
            return 1
        phases = [p for p in phases if p != "tp_serve"]
        if not phases:
            print(json.dumps({"ok": True, "cards": n, "tp_serve": summary}))
            return 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   SKYPILOT_NODE_RANK="0", SKYPILOT_NUM_NODES="1",
                   SKYPILOT_COORDINATOR_ADDR=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank", *phases], env=env))
    # A process that fails leaves its peers waiting in a collective:
    # stop them all at the first failure.
    deadline = time.monotonic() + 1500
    try:
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs) or None not in rcs:
                break
            time.sleep(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return max(p.returncode for p in procs)


def _say(*args):
    if torch.distributed.get_rank() == 0:
        print(*args, flush=True)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _setup(llama):
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=N_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device="cuda",
                           generator=gen)
    return cfg, params, tokens


def _steps(step, state, batch, fa):
    fa.reset_launches()
    losses, times = [], []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rest = sorted(times[1:])
    return losses, rest[len(rest) // 2] * 1e3, dict(fa.LAUNCHES)


def _rows(mesh, mesh_lib, n_rows):
    dp = mesh_lib.axis_size(mesh, mesh_lib.DP)
    fsdp = mesh_lib.axis_size(mesh, mesh_lib.FSDP)
    i = (mesh_lib.axis_index(mesh, mesh_lib.DP) * fsdp +
         mesh_lib.axis_index(mesh, mesh_lib.FSDP))
    per = n_rows // (dp * fsdp)
    return slice(i * per, (i + 1) * per)


def phase_step(n, out, llama, trainer, mesh_lib, fa):
    tcfg = trainer.TrainConfig(warmup_steps=1, total_steps=100)
    if torch.distributed.get_rank() == 0:
        cfg, params, tokens = _setup(llama)
        tx = trainer.make_optimizer(tcfg)
        step = trainer.make_train_step(
            lambda p, t: llama.forward(cfg, p, t), tx, with_grad_norm=False)
        out["one_card"] = _steps(step, trainer.init_train_state(params, tx),
                                 {"tokens": tokens}, fa)[:2]
        del params, step, tx
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    obj = [out.get("one_card")]
    torch.distributed.broadcast_object_list(obj, src=0)
    one_losses, one_ms = obj[0]
    for name, axes, rules, pipelined in (
            ("step", {"fsdp": n // 2, "tp": 2}, mesh_lib.DEFAULT_RULES,
             False),
            ("pipeline", {"pp": 2, "tp": n // 2}, mesh_lib.PIPELINE_RULES,
             True)):
        mesh = mesh_lib.make_mesh(axes)
        cfg, params, tokens = _setup(llama)
        if pipelined:
            with torch.no_grad():
                plain = llama.forward(cfg, params, tokens)
        tx = trainer.make_optimizer(tcfg)
        state = trainer.init_train_state(params, tx)
        state = trainer.place_state(state, trainer.state_shardings(
            mesh, rules, llama.param_specs(cfg), state), tx)
        if pipelined:
            with torch.no_grad():
                piped = llama.forward_pipelined(cfg, state.params, tokens,
                                                mesh=mesh, rules=rules,
                                                num_microbatches=2)
            rel = float((piped - plain).norm() / plain.norm())
            del piped, plain
            _say(f"[{name}] forward_pipelined vs forward: logits rel "
                 f"{rel:.3e} (tol {PIPE_REL_TOL})")
            _check(rel <= PIPE_REL_TOL, "forward_pipelined disagrees")
            out["pipeline_rel"] = rel

            def fwd(p, t, cfg=cfg, mesh=mesh, rules=rules):
                return llama.forward_pipelined(cfg, p, t, mesh=mesh,
                                               rules=rules,
                                               num_microbatches=2)
        else:
            def fwd(p, t, cfg=cfg):
                return llama.forward(cfg, p, t)
        step = trainer.make_train_step(fwd, tx, with_grad_norm=False,
                                       mesh=mesh, rules=rules)
        batch = {"tokens": tokens[_rows(mesh, mesh_lib, BATCH)]}
        losses, ms, launches = _steps(step, state, batch, fa)
        worst = max(abs(a - b) for a, b in zip(losses, one_losses))
        _say(f"[{name}] mesh {axes}: losses {[round(x, 4) for x in losses]}"
             f"; one card {[round(x, 4) for x in one_losses]}; largest "
             f"|diff| {worst:.3e} (tol {LOSS_TOL}); step {ms:.1f} ms on "
             f"{n} cards vs {one_ms:.1f} ms on one (median of steps 2-"
             f"{STEPS}); rank 0 launches {launches}")
        _check(worst <= LOSS_TOL, f"[{name}] loss off the one-card step's")
        _check(losses[-1] < losses[0], f"[{name}] loss did not fall")
        layers = N_LAYERS // (2 if pipelined else 1)
        micro = 2 if pipelined else 1
        want = {"flash_fwd": 2 * layers * micro * STEPS,
                "flash_dq": layers * micro * STEPS,
                "flash_dkv": layers * micro * STEPS}
        got = {k: v for k, v in launches.items() if v}
        _check(got == want, f"[{name}] launches {got} != {want}")
        out[name] = {"losses": losses, "one_card_losses": one_losses,
                     "max_loss_diff": worst, "step_ms": ms,
                     "one_card_step_ms": one_ms, "mesh": axes}
        del state, step, tx, params
        torch.cuda.empty_cache()


def phase_pipe(n, out, llama, trainer, mesh_lib, fa):
    """[pipe] (module docstring): {pp: n} alone under PIPELINE_RULES with
    adafactor, from step 0 and from a state placed after one one-card
    step, against the one-card adafactor steps."""
    tcfg = trainer.TrainConfig(warmup_steps=1, total_steps=100,
                               optimizer="adafactor")
    rules = mesh_lib.PIPELINE_RULES

    def one_card(params):
        tx = trainer.make_optimizer(tcfg)
        return tx, trainer.init_train_state(params, tx), \
            trainer.make_train_step(lambda p, t: llama.forward(cfg, p, t),
                                    tx, with_grad_norm=False)
    if torch.distributed.get_rank() == 0:
        cfg, params, tokens = _setup(llama)
        _, state, step = one_card(params)
        out["pipe_one_card"] = _steps(step, state, {"tokens": tokens},
                                      fa)[:2]
        del params, state, step
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    obj = [out.get("pipe_one_card")]
    torch.distributed.broadcast_object_list(obj, src=0)
    one_losses, one_ms = obj[0]
    mesh = mesh_lib.make_mesh({"pp": n})

    def fwd(p, t):
        return llama.forward_pipelined(cfg, p, t, mesh=mesh, rules=rules,
                                       num_microbatches=2)
    cfg, params, tokens = _setup(llama)
    tx = trainer.make_optimizer(tcfg)
    state = trainer.init_train_state(params, tx)
    state = trainer.place_state(state, trainer.state_shardings(
        mesh, rules, llama.param_specs(cfg), state), tx)
    step = trainer.make_train_step(fwd, tx, with_grad_norm=False, mesh=mesh,
                                   rules=rules)
    losses, ms, launches = _steps(step, state, {"tokens": tokens}, fa)
    del state, step, params
    torch.cuda.empty_cache()
    # The state placed after one one-card step (every process takes it on
    # its own card), then the rest of the steps through the pipeline.
    cfg, params, tokens = _setup(llama)
    tx, state, step = one_card(params)
    state, m = step(state, {"tokens": tokens})
    placed = [float(m["loss"])]
    state = trainer.place_state(state, trainer.state_shardings(
        mesh, rules, llama.param_specs(cfg), state), tx)
    step = trainer.make_train_step(fwd, tx, with_grad_norm=False, mesh=mesh,
                                   rules=rules)
    for _ in range(STEPS - 1):
        state, m = step(state, {"tokens": tokens})
        placed.append(float(m["loss"]))
    del state, step, params
    torch.cuda.empty_cache()
    worst = max(abs(a - b) for a, b in zip(losses, one_losses))
    worst_placed = max(abs(a - b) for a, b in zip(placed, one_losses))
    layers = N_LAYERS // n
    want = {"flash_fwd": 2 * layers * 2 * STEPS,
            "flash_dq": layers * 2 * STEPS, "flash_dkv": layers * 2 * STEPS}
    got = {k: v for k, v in launches.items() if v}
    _say(f"[pipe] mesh {{pp: {n}}} alone, adafactor: losses "
         f"{[round(x, 4) for x in losses]}; placed after one one-card step "
         f"{[round(x, 4) for x in placed]}; one card "
         f"{[round(x, 4) for x in one_losses]}; largest |diff| {worst:.3e}, "
         f"placed {worst_placed:.3e} (tol {LOSS_TOL}); step {ms:.1f} ms on "
         f"{n} cards vs {one_ms:.1f} ms on one (median of steps 2-{STEPS}); "
         f"rank 0 launches {got}")
    _check(worst <= LOSS_TOL and worst_placed <= LOSS_TOL,
           "[pipe] loss off the one-card step's")
    _check(losses[-1] < losses[0], "[pipe] loss did not fall")
    _check(got == want, f"[pipe] rank 0 launches {got} != {want}")
    out["pipe"] = {"losses": losses, "placed_losses": placed,
                   "one_card_losses": one_losses, "max_loss_diff": worst,
                   "max_placed_diff": worst_placed, "step_ms": ms,
                   "one_card_step_ms": one_ms, "mesh": {"pp": n}}


def _ep_build(n_layers, trainer, mesh_lib, mesh=None):
    """Mixtral-8x7B widths at ``n_layers``, bf16: (cfg, the recipe's args,
    a batch) and, on a mesh, the recipe's placed state and step; else
    the one-card state and step from the same weights."""
    from skypilot_tpu_torch.models import mixtral
    from skypilot_tpu_torch.recipes import mixtral_ep
    cfg = dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                              n_layers=n_layers)
    args = mixtral_ep.build_arg_parser().parse_args([
        "--model", "8x7b", "--steps", "100", "--seed", str(EP_SEED)])
    gen = torch.Generator(device="cuda").manual_seed(EP_SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device="cuda",
                           generator=gen)
    device = torch.device("cuda", torch.cuda.current_device())
    if mesh is not None:
        return cfg, mixtral_ep.build(cfg, args, device, mesh), tokens
    params = mixtral.init(cfg, torch.Generator("cuda").manual_seed(
        args.seed), device)
    tx = trainer.make_optimizer(trainer.TrainConfig(total_steps=100))
    step = trainer.make_train_step(lambda p, t: mixtral.forward(cfg, p, t),
                                   tx, with_grad_norm=False)
    return cfg, (trainer.init_train_state(params, tx), step), tokens


def _ep_steps(step, state, tokens, fa):
    fa.reset_launches()
    losses, aux, times = [], [], []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
        aux.append(float(m["aux_loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rest = sorted(times[1:])
    return losses, aux, rest[len(rest) // 2] * 1e3, dict(fa.LAUNCHES)


def phase_ep(n, out, trainer, mesh_lib, fa):
    rank = torch.distributed.get_rank()
    ref = None
    if rank == 0:
        _, (state, step), tokens = _ep_build(EP_CMP_LAYERS, trainer,
                                             mesh_lib)
        losses, aux, ms, _ = _ep_steps(step, state, tokens, fa)
        out["ep_one_card"] = (losses, aux, ms)
        ref = [p.detach() for p in state.params.parameters()]
        del state, step
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    obj = [out.get("ep_one_card")]
    torch.distributed.broadcast_object_list(obj, src=0)
    one_losses, one_aux, one_ms = obj[0]
    mesh = mesh_lib.make_mesh({"ep": n})
    for n_layers in (EP_CMP_LAYERS, EP_BIG_LAYERS):
        torch.cuda.reset_peak_memory_stats()
        cfg, (state, step), tokens = _ep_build(n_layers, trainer, mesh_lib,
                                               mesh)
        losses, aux, ms, launches = _ep_steps(step, state, tokens, fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        local = sum(p.to_local().numel() for p in state.params.parameters())
        want = {"flash_fwd": 2 * n_layers * STEPS,
                "flash_dq": n_layers * STEPS, "flash_dkv": n_layers * STEPS}
        got = {k: v for k, v in launches.items() if v}
        _check(got == want, f"[ep] rank {rank} launches {got} != {want}")
        _check(all(x == x for x in losses + aux), "[ep] non-finite loss")
        res = {"mesh": {"ep": n}, "layers": n_layers, "losses": losses,
               "aux": aux, "step_ms": ms,
               "tokens_per_s": BATCH * SEQ / ms * 1e3,
               "peak_gb_rank0": peak_gb, "params_a_card_b": local / 1e9}
        if n_layers == EP_CMP_LAYERS:
            diff = 0.0
            with torch.no_grad():
                for i, p in enumerate(state.params.parameters()):
                    whole = p.full_tensor()
                    if rank == 0:
                        diff = max(diff, (whole.float() - ref[i].float()
                                          ).abs().max().item())
                    del whole
            worst = max(abs(a - b) for a, b in zip(losses, one_losses))
            aux_diff = max(abs(a - b) for a, b in zip(aux, one_aux))
            obj = [diff]
            torch.distributed.broadcast_object_list(obj, src=0)
            diff = obj[0]
            res.update(one_card_losses=one_losses, one_card_aux=one_aux,
                       one_card_step_ms=one_ms, max_loss_diff=worst,
                       max_aux_diff=aux_diff, max_param_diff=diff)
            _say(f"[ep] {EP_CMP_LAYERS} layers on {{ep {n}}}: losses "
                 f"{[round(x, 4) for x in losses]}, aux "
                 f"{[round(x, 5) for x in aux]}; one card "
                 f"{[round(x, 4) for x in one_losses]}, aux "
                 f"{[round(x, 5) for x in one_aux]}; largest |diff| loss "
                 f"{worst:.3e}, aux {aux_diff:.3e}, parameter {diff:.3e} "
                 f"(tol {LOSS_TOL}); step {ms:.1f} ms on {n} cards vs "
                 f"{one_ms:.1f} ms on one (median of steps 2-{STEPS}); "
                 f"{local / 1e9:.3f} B parameters a card; peak "
                 f"{peak_gb:.2f} GB on rank 0; launches {got}")
            _check(worst <= LOSS_TOL and aux_diff <= LOSS_TOL
                   and diff <= LOSS_TOL, "[ep] off the one-card step")
            del ref
        else:
            _say(f"[ep] {n_layers} layers on {{ep {n}}}: "
                 f"{cfg.num_params() / 1e9:.3f} B parameters, "
                 f"{local / 1e9:.3f} B a card; losses "
                 f"{[round(x, 4) for x in losses]}; step {ms:.1f} ms "
                 f"(median of steps 2-{STEPS}), "
                 f"{res['tokens_per_s']:.0f} tokens/s; peak {peak_gb:.2f} "
                 f"GB on rank 0; launches {got}")
        out[f"ep_{n_layers}_layers"] = res
        del state, step
        torch.cuda.empty_cache()


def _rel_global(a, b):
    num = torch.tensor([(a.float() - b.float()).square().sum(),
                        b.float().square().sum()], device="cuda")
    torch.distributed.all_reduce(num)
    return float((num[0] / num[1]).sqrt())


def _time(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_ring(n, out, mesh_lib, ring_attention, attention_ops):
    mesh = mesh_lib.make_mesh({"sp": n})
    b, s, h, kvh, d = RING_SHAPE
    sl = s // n
    rank = mesh_lib.axis_index(mesh, mesh_lib.SP)
    chunk = slice(rank * sl, (rank + 1) * sl)
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn(*shape, device="cuda", generator=g).to(
        torch.bfloat16) for shape in ((b, s, h, d), (b, s, kvh, d),
                                      (b, s, kvh, d), (b, s, h, d)))
    for causal in (True, False):
        def ring():
            leaves = [x[:, chunk].clone().requires_grad_()
                      for x in (q, k, v)]
            o = ring_attention.ring_attention(*leaves, mesh=mesh,
                                              causal=causal)
            grads = torch.autograd.grad((o * do[:, chunk]).sum(), leaves)
            return o.detach(), grads

        def flash():
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            o = attention_ops.attention(*leaves, causal=causal)
            grads = torch.autograd.grad((o * do).sum(), leaves)
            return o.detach(), grads

        o, grads = ring()
        ref, ref_grads = flash()
        errs = {"o": _rel_global(o, ref[:, chunk])}
        for name, gr, rg in zip(("dq", "dk", "dv"), grads, ref_grads):
            errs[name] = _rel_global(gr, rg[:, chunk])
        ring_ms = _time(ring)
        flash_ms = _time(flash)
        with torch.no_grad():
            ring_fwd = _time(lambda: ring_attention.ring_attention(
                q[:, chunk], k[:, chunk], v[:, chunk], mesh=mesh,
                causal=causal))
            flash_fwd = _time(lambda: attention_ops.attention(
                q, k, v, causal=causal))
        _say(f"[ring] sp={n} {RING_SHAPE} causal={causal}: rel o "
             f"{errs['o']:.3e} (tol {OUT_REL_TOL}), dq {errs['dq']:.3e}, dk "
             f"{errs['dk']:.3e}, dv {errs['dv']:.3e} (tol {GRAD_REL_TOL}); "
             f"forward {ring_fwd:.2f} ms vs the flash op on one card "
             f"{flash_fwd:.2f} ms; forward + backward {ring_ms:.2f} ms vs "
             f"{flash_ms:.2f} ms")
        _check(errs["o"] <= OUT_REL_TOL and all(
            errs[x] <= GRAD_REL_TOL for x in ("dq", "dk", "dv")),
            f"ring causal={causal} disagrees with the flash op")
        out[f"ring_causal_{causal}"] = dict(errs, ring_fwd_ms=ring_fwd,
                                            flash_fwd_ms=flash_fwd,
                                            ring_ms=ring_ms,
                                            flash_ms=flash_ms)


def _run_rank(phases) -> int:
    sys.path.insert(0, str(REPO))
    os.environ["STPU_TUNE_MANIFEST"] = "0"
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import attention as attention_ops
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import ring_attention
    from skypilot_tpu_torch.train import distributed, trainer

    ctx = distributed.initialize_from_env(timeout_ms=120_000)
    n = ctx.world_size
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    _say(f"[group] {ctx}; backend {torch.distributed.get_backend()}; "
         f"cards {cards.strip().splitlines()}")
    out = {"cards": n}
    try:
        t0 = time.perf_counter()
        if "step" in phases:
            phase_step(n, out, llama, trainer, mesh_lib, fa)
        if "ring" in phases:
            phase_ring(n, out, mesh_lib, ring_attention, attention_ops)
        if "ep" in phases:
            phase_ep(n, out, trainer, mesh_lib, fa)
        if "pipe" in phases:
            phase_pipe(n, out, llama, trainer, mesh_lib, fa)
        out["seconds"] = time.perf_counter() - t0
        for key in ("one_card", "ep_one_card", "pipe_one_card"):
            out.pop(key, None)
        _say(json.dumps({"ok": True, **out}))
        return 0
    except RuntimeError as e:
        print(f"FAIL rank {ctx.rank}: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        sys.exit(1)
    phases = ([a for a in sys.argv[1:] if a != "--rank"] or
              ["world1", "step", "ring"])
    sys.exit(_run_rank(phases) if "--rank" in sys.argv else
             _launch(phases))
