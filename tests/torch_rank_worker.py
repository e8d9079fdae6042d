"""One process of a multi-process CPU (gloo) run of the port, for the
tests that hold its mesh, sharded step, ring attention and pipeline to
the JAX package. Imports torch and skypilot_tpu_torch only: the tests
compute the JAX side in their own process and hand the inputs over in a
pickle.

    python tests/torch_rank_worker.py cases <dir> <rank> <world>
        rendezvous through file://<dir>/rendezvous; runs every case of
        <dir>/cases.pkl in order; rank 0 writes <dir>/results.pkl
    python tests/torch_rank_worker.py env <dir>
        brings the group up from the SKYPILOT_* env
        (distributed.initialize_from_env, gloo) and writes
        <dir>/env_<rank>.pkl
    python tests/torch_rank_worker.py lora <dir> <recipe arguments>
        the LoRA recipe's main() under the SKYPILOT_* env, with the tiny
        Llama config in f32
    python tests/torch_rank_worker.py resnet <dir> <recipe arguments>
        resnet_ddp's run() under the SKYPILOT_* env (DDP over gloo);
        writes <dir>/params_<rank>.pkl, the trained parameters by name
    python tests/torch_rank_worker.py tp <dir> <rank> <tp> <addr>
        one rank of a tensor-parallel serving group (gang_replica.TpGroup
        at <addr>): every case of <dir>/cases.pkl through a tp engine, rank
        0 scheduling, the others serving its plans; rank 0 writes
        <dir>/results.pkl
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from skypilot_tpu_torch import convert  # noqa: E402
from skypilot_tpu_torch.models import gemma, llama, mixtral  # noqa: E402
from skypilot_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from skypilot_tpu_torch.parallel import pipeline  # noqa: E402
from skypilot_tpu_torch.parallel import placement  # noqa: E402
from skypilot_tpu_torch.parallel import ring_attention  # noqa: E402
from skypilot_tpu_torch.parallel import seq_gather  # noqa: E402
from skypilot_tpu_torch.train import distributed  # noqa: E402
from skypilot_tpu_torch.train import trainer  # noqa: E402

TIMEOUT = timedelta(seconds=60)
WAIT_S = 180
MODELS = {"llama": (llama, llama.LlamaConfig, convert.llama_params_from_jax),
          "gemma": (gemma, gemma.GemmaConfig, convert.gemma_params_from_jax),
          "mixtral": (mixtral, mixtral.MixtralConfig,
                      convert.mixtral_params_from_jax)}


def _mesh(c):
    if c.get("slices"):
        return mesh_lib.make_multislice_mesh(c["axes"], c["slices"],
                                             device="cpu")
    return mesh_lib.make_mesh(c["axes"], device="cpu")


def _batch_rows(mesh, n_rows):
    """This process's rows of the global batch: its (dp, fsdp)
    coordinate's block, row-major."""
    dp = mesh_lib.axis_size(mesh, mesh_lib.DP)
    fsdp = mesh_lib.axis_size(mesh, mesh_lib.FSDP)
    i = (mesh_lib.axis_index(mesh, mesh_lib.DP) * fsdp +
         mesh_lib.axis_index(mesh, mesh_lib.FSDP))
    per = n_rows // (dp * fsdp)
    return slice(i * per, (i + 1) * per)


def _config(c):
    model, cls, from_jax = MODELS[c["family"]]
    cfg = dataclasses.replace(cls.tiny(vocab_size=c["vocab"]),
                              dtype=torch.float32, **c.get("cfg", {}))
    return model, cfg, from_jax


def _merge_lora(params, lora):
    """The case's adapters (the JAX tree's stacked layout) registered on
    the layers beside their frozen weights: only the adapters train."""
    params.requires_grad_(False)
    for name, stacked in lora["layers"].items():
        for lp, a in zip(params.layers, stacked):
            setattr(lp, name, torch.nn.Parameter(torch.from_numpy(
                a.copy())))


def case_train(c):
    model, cfg, from_jax = _config(c)
    mesh = _mesh(c)
    rules = (mesh_lib.PIPELINE_RULES if c.get("pipelined")
             else mesh_lib.DEFAULT_RULES)
    params = from_jax(cfg, c["init"], "cpu")
    if c.get("lora"):
        _merge_lora(params, c["lora"])
    tx = trainer.make_optimizer(trainer.TrainConfig(**c["tcfg"]))
    tokens = torch.from_numpy(c["tokens"]).long()
    losses, norms, aux = [], [], []
    if c.get("replace"):
        # One step on one device (the whole batch), then the state placed
        # onto the mesh: jax.device_put of a state after its first step.
        state = trainer.init_train_state(params, tx)
        state, m = trainer.make_train_step(
            lambda p, t: model.forward(cfg, p, t), tx)(state,
                                                       {"tokens": tokens})
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        aux.append(m["aux_loss"].item())
        state = trainer.place_state(state, trainer.state_shardings(
            mesh, rules, model.param_specs(cfg), state), tx)
    else:
        want = trainer.state_shardings(mesh, rules, model.param_specs(cfg),
                                       trainer.init_train_state(params, tx))
        # The weights go in through convert.shard_params (and come out
        # through convert.gather_params), placed as state_shardings says.
        convert.shard_params(params, mesh, rules, model.param_specs(cfg))
        for name, p in params.named_parameters():
            sh = want.params[name]
            assert p.is_meta or (p.device_mesh == sh.mesh and
                                 tuple(p.placements) == sh.placements), name
        state = trainer.init_train_state(params, tx)
    if c.get("pipelined"):
        def fwd(p, t):
            return llama.forward_pipelined(cfg, p, t, mesh=mesh, rules=rules,
                                           num_microbatches=2)
    else:
        def fwd(p, t):
            return model.forward(cfg, p, t)
    if c.get("chunked"):
        step = trainer.make_train_step(
            None, tx, trunk_fn=lambda p, t: model.forward_trunk(cfg, p, t),
            head_fn=model.head_weights, mesh=mesh, rules=rules)
    else:
        step = trainer.make_train_step(fwd, tx, mesh=mesh, rules=rules)
    batch = {"tokens": tokens[_batch_rows(mesh, tokens.shape[0])]}
    calls = []
    apply = llama._FlashRematLayer.apply
    llama._FlashRematLayer.apply = lambda *a: calls.append(1) or apply(*a)
    spy = _EpSpy(mesh)
    try:
        with spy, _SeqSpy() as seq:
            for _ in range(c["steps"] - len(losses)):
                state, m = step(state, batch)
                losses.append(m["loss"].item())
                norms.append(m["grad_norm"].item())
                aux.append(m["aux_loss"].item())
                assert abs(m["total_loss"].item() - losses[-1] -
                           aux[-1]) <= 1e-6 * abs(losses[-1])
    finally:
        llama._FlashRematLayer.apply = apply
    return {"loss": losses, "grad_norm": norms, "aux_loss": aux,
            "final": convert.gather_params(state.params, mesh),
            "flash_remat_layers": len(calls), "ep_views": spy.views,
            "ep_gathers": _gather(spy.gathers, dist.get_world_size()),
            "seq": seq.seen}


class _SeqSpy:
    """Records, while a step runs, the ring's calls and the sequence
    lengths that meet attention's gather (``seq_gather.gather_seq`` along
    the sequence: its input, the chunk) and the MLP (``llama.mlp_block``'s
    input)."""

    def __enter__(self):
        self.saved = (ring_attention.ring_attention, seq_gather.gather_seq,
                      llama.mlp_block)
        ring, gather, mlp = self.saved
        self.seen = {"ring": 0, "gathered": set(), "mlp": set()}
        seen = self.seen

        def ring_(*a, **k):
            seen["ring"] += 1
            return ring(*a, **k)

        def gather_(t, group, dim=1):
            if dim == 1:
                seen["gathered"].add(t.shape[1])
            return gather(t, group, dim)

        def mlp_(cfg, x, lp):
            seen["mlp"].add(x.shape[1])
            return mlp(cfg, x, lp)
        ring_attention.ring_attention = ring_
        seq_gather.gather_seq = gather_
        llama.mlp_block = mlp_
        return self

    def __exit__(self, *exc):
        (ring_attention.ring_attention, seq_gather.gather_seq,
         llama.mlp_block) = self.saved
        return False


class _EpSpy:
    """Records, while a step runs, the local shape of every expert
    tensor's compute view and every redistribution or whole gather of a
    tensor split over ``ep`` that leaves the ``ep`` axis unsplit."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.views, self.gathers = [], []

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        self.saved = (placement.compute_view, DTensor.redistribute,
                      DTensor.full_tensor)
        view, redistribute, full = self.saved
        spy = self

        def ep_split(t):
            names = t.device_mesh.mesh_dim_names
            return (mesh_lib.EP in names and
                    t.placements[names.index(mesh_lib.EP)].is_shard())

        def compute_view(p, *a, **k):
            out = view(p, *a, **k)
            if p.dim() == 3:
                spy.views.append((tuple(p.shape), tuple(out.shape)))
            return out

        def redistribute_(t, device_mesh=None, placements=None, **k):
            if ep_split(t) and placements is not None:
                names = t.device_mesh.mesh_dim_names
                if not placements[names.index(mesh_lib.EP)].is_shard():
                    spy.gathers.append(("redistribute", tuple(t.shape)))
            return redistribute(t, device_mesh, placements, **k)

        def full_tensor(t, *a, **k):
            if ep_split(t):
                spy.gathers.append(("full_tensor", tuple(t.shape)))
            return full(t, *a, **k)
        placement.compute_view = compute_view
        DTensor.redistribute = redistribute_
        DTensor.full_tensor = full_tensor
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor import DTensor
        (placement.compute_view, DTensor.redistribute,
         DTensor.full_tensor) = self.saved
        return False


def _gather(obj, world):
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def case_ring(c):
    mesh = _mesh(c)
    for name, value in c.get("patch", {}).items():
        setattr(ring_attention, name, value)
    q, k, v = (torch.from_numpy(c[n]) for n in "qkv")
    rows = _batch_rows(mesh, q.shape[0])
    sp, tp = (mesh_lib.axis_size(mesh, a) for a in (mesh_lib.SP, mesh_lib.TP))
    si, ti = (mesh_lib.axis_index(mesh, a) for a in (mesh_lib.SP, mesh_lib.TP))
    sl = q.shape[1] // sp
    seq = slice(si * sl, (si + 1) * sl)

    def heads(t):
        n = t.shape[2] // tp
        return t[rows, seq, ti * n:(ti + 1) * n].clone().requires_grad_()
    ql, kl, vl = heads(q), heads(k), heads(v)
    out = ring_attention.ring_attention(ql, kl, vl, mesh=mesh,
                                        causal=c["causal"])
    (out.square().sum()).backward()
    parts = _gather((rows.start, seq.start, ti, out.detach().numpy(),
                     ql.grad.numpy(), kl.grad.numpy(), vl.grad.numpy()),
                    dist.get_world_size())
    full = {n: np.zeros(t.shape, np.float32)
            for n, t in (("out", q), ("dq", q), ("dk", k), ("dv", v))}
    for r0, s0, t_i, *arrs in parts:
        for n, a in zip(("out", "dq", "dk", "dv"), arrs):
            b, s, h = a.shape[:3]
            full[n][r0:r0 + b, s0:s0 + s, t_i * h:(t_i + 1) * h] = a
    # The sequence is split and the keys/values of each chunk are seen by
    # every query chunk: a K/V gradient is complete once summed over the
    # processes that share its heads and rows, which the ring does.
    for name, value in c.get("restore", {}).items():
        setattr(ring_attention, name, value)
    return full


def case_pipeline_forward(c):
    _, cfg, from_jax = _config(c)
    mesh = _mesh(c)
    rules = mesh_lib.PIPELINE_RULES
    params = from_jax(cfg, c["init"], "cpu")
    tokens = torch.from_numpy(c["tokens"]).long()
    with torch.no_grad():
        plain = llama.forward(cfg, params, tokens)
        convert.shard_params(params, mesh, rules, llama.param_specs(cfg))
        piped = llama.forward_pipelined(cfg, params, tokens, mesh=mesh,
                                        rules=rules, num_microbatches=2)
    return {"piped": piped.detach().numpy(), "plain": plain.numpy()}


def case_gpipe(c):
    mesh = _mesh(c)
    w = torch.from_numpy(c["w"])
    x = torch.from_numpy(c["x"])
    out = pipeline.gpipe(lambda lw, xm, _ex: torch.tanh(xm @ lw), list(w), x,
                         mesh=mesh, num_microbatches=x.shape[0])
    return {"out": out.detach().numpy()}


def _tp_model(c, mesh, rules):
    """The case's tiny f32 model from its JAX tree, (int8 when asked)
    sharded onto the tp mesh: (model module, cfg, serving tree)."""
    from skypilot_tpu_torch.models import mixtral
    from skypilot_tpu_torch.serve import gang_replica
    if c["family"] == "mixtral":
        cfg = dataclasses.replace(mixtral.MixtralConfig.tiny(c["vocab"]),
                                  dtype=torch.float32, **c.get("cfg", {}))
        model, params = mixtral, convert.mixtral_params_from_jax(
            cfg, c["init"], "cpu")
    else:
        model, cfg, from_jax = _config(c)
        params = from_jax(cfg, c["init"], "cpu")
    if c.get("quantize"):
        params = model.quantize_params(cfg, params)
    return model, cfg, gang_replica.shard_params(cfg, params, mesh, rules)


def case_tp_engine(c, group, mesh, rules):
    """The case's requests through a tp engine: rank 0's streams (and,
    with ``evict``, a second pass after every prefix block went to the
    host tier); every other rank serves the plans."""
    from skypilot_tpu_torch.serve import decode_engine
    _, cfg, params = _tp_model(c, mesh, rules)
    engine = decode_engine.DecodeEngine(cfg, params, mesh=mesh, rules=rules,
                                        device="cpu", use_manifest=False,
                                        **c["engine"])
    if group.rank:
        engine.work()
        # The spilled shards this rank still keeps, once rank 0's close
        # forwarded every drop.
        return {"tp_host": len(engine._tp_host)}
    engine.start()
    out = {"kv": engine.kv_config()}
    try:
        passes = 2 if c.get("evict") else 1
        out["streams"] = []
        for i in range(passes):
            handles = [engine.submit(p, max_tokens=m, temperature=t, seed=s)
                       for p, m, t, s in c["requests"]]
            out["streams"].append([h.result(timeout=120.0)
                                   for h in handles])
            out.setdefault("chunks", []).append(
                [h.prefill_chunks for h in handles])
            if i + 1 < passes:
                while engine.prefix_cache.evict_one() == "spilled":
                    pass
                while engine.spill_in_flight():
                    time.sleep(0.001)
        out["tier"] = engine.host_tier_stats()
    finally:
        engine.shutdown()
    return out


def case_tp_logits(c, group, mesh, rules):
    """Teacher-forced logits of the case's tokens through the tp tree's
    dense and paged cache paths (every rank calls them; rank 0's
    returned)."""
    model, cfg, params = _tp_model(c, mesh, rules)
    tokens = torch.from_numpy(c["tokens"]).long()
    b, s = tokens.shape
    from skypilot_tpu_torch.serve import gang_replica
    kvh = gang_replica.local_kv_heads(cfg, group.tp)
    with torch.inference_mode():
        cache = model.init_cache(cfg, b, s, "cpu", kv_heads=kvh)
        dense, _ = model.forward_with_cache(cfg, params, tokens, cache, 0)
        bt = c["block_tokens"]
        nb = b * s // bt
        pool = model.init_paged_cache(cfg, nb + 1, bt, device="cpu",
                                      kv_heads=kvh)
        table = np.arange(1, nb + 1).reshape(b, s // bt)
        logits = []
        for j in range(s // bt):
            for row in range(b):
                z, _ = model.forward_with_paged_cache(
                    cfg, params, tokens[row:row + 1, j * bt:(j + 1) * bt],
                    pool, table[row:row + 1], j * bt, window=s,
                    write_block=int(table[row, j]))
                logits.append(z)
        paged = torch.stack(logits).reshape(s // bt, b, bt, -1)
    return {"dense": dense.numpy(),
            "paged": paged.permute(1, 0, 2, 3).reshape(b, s, -1).numpy()}


TP_CASES = {"tp_engine": case_tp_engine, "tp_logits": case_tp_logits}


def run_tp(root: pathlib.Path, rank: int, tp: int, addr: str) -> int:
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.serve import gang_replica
    group = gang_replica.TpGroup(tp=tp, rank=rank, addr=addr, device="cpu",
                                 timeout_s=TIMEOUT.total_seconds())
    topology = gang_replica.ReplicaTopology(ici_axes={"tp": tp})
    mesh, rules = gang_replica.build_mesh(topology, group)
    assert rules is mesh_lib.DEFAULT_RULES
    cases = pickle.loads((root / "cases.pkl").read_bytes())
    results = {}
    for name, c in cases.items():
        try:
            results[name] = TP_CASES[c["kind"]](c, group, mesh, rules)
        except Exception:  # noqa: BLE001 - reported to the test
            results[name] = {"error": traceback.format_exc()}
            (root / f"error_{rank}.txt").write_text(results[name]["error"])
            if rank == 0:
                (root / "results.pkl").write_bytes(pickle.dumps(results))
            return 1
    (root / ("results.pkl" if rank == 0 else f"results_{rank}.pkl")
     ).write_bytes(pickle.dumps(results))
    group.close()
    return 0


def stage_tree_arrays(c):
    """The adafactor-over-stages case's parameters and per-step
    gradients, drawn from its seed (the test draws the same): a JAX-layout
    tree {name: array, "layers": {name: (L, ...) array}}."""
    rng = np.random.default_rng(c["seed"])

    def draw():
        tree = {n: rng.standard_normal(sh).astype(np.float32)
                for n, sh in c["top"].items()}
        tree["layers"] = {
            n: rng.standard_normal((c["n_layers"],) + sh).astype(np.float32)
            for n, sh in c["layer"].items()}
        return tree
    return draw(), [draw() for _ in range(c["steps"])]


def case_adafactor_stages(c):
    """Adafactor alone on a tree placed under pipeline stages: the layer
    axis split over pp, a per-layer dim over tp; each step's gradients are
    the drawn whole ones, placed as their parameters."""
    from torch.distributed.tensor import distribute_tensor
    init, grads = stage_tree_arrays(c)
    module = torch.nn.Module()
    for n, a in init.items():
        if n != "layers":
            setattr(module, n, torch.nn.Parameter(torch.from_numpy(a)))
    module.layers = torch.nn.ModuleList(torch.nn.Module()
                                        for _ in range(c["n_layers"]))
    for n, a in init["layers"].items():
        for lp, row in zip(module.layers, a):
            setattr(lp, n, torch.nn.Parameter(torch.from_numpy(row.copy())))
    mesh = _mesh(c)
    placement.place_module(module, placement.param_shardings(
        module, mesh, mesh_lib.PIPELINE_RULES, c["specs"]), mesh)
    tx = trainer.make_optimizer(trainer.TrainConfig(**c["tcfg"]))
    state = tx.init(module)
    for tree in grads:
        held, gs = [], []
        for name, p in module.named_parameters():
            if p.is_meta:
                continue
            parts = name.split(".")
            g = (tree["layers"][parts[2]][int(parts[1])]
                 if parts[0] == "layers" else tree[name])
            held.append(p)
            gs.append(distribute_tensor(torch.from_numpy(g.copy()),
                                        p.device_mesh, p.placements,
                                        src_data_rank=None))
        tx.update_(held, gs, state, placement.global_norm(gs, mesh))
    return convert.gather_params(module, mesh)


def _raised(fn):
    """(exception type name, message) of what ``fn()`` raises, or None."""
    try:
        fn()
    except (ValueError, NotImplementedError) as exc:
        return type(exc).__name__, str(exc)
    return None


def case_refusals(c):
    """The sharded step's refusals that the JAX package shares, each on
    a mesh of all four ranks, raised by every rank at the same point:
    an mlp_dim that tp does not divide, n_experts that ep does not
    divide, and Mixtral on a pipeline."""
    tokens = torch.from_numpy(c["tokens"]).long()
    out = {}
    for name, family, axes, fields in c["meshes"]:
        model, cls, _ = MODELS[family]
        cfg = dataclasses.replace(cls.tiny(vocab_size=c["vocab"]),
                                  dtype=torch.float32, **fields)
        params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
        mesh = mesh_lib.make_mesh(axes, device="cpu")
        rules = mesh_lib.DEFAULT_RULES
        convert.shard_params(params, mesh, rules, model.param_specs(cfg))

        def forward():
            with mesh_lib.use_mesh(mesh, rules):
                model.forward(cfg, params, tokens[_batch_rows(
                    mesh, tokens.shape[0])])
        out[name] = _raised(forward)
    return out


CASES = {"train": case_train, "ring": case_ring,
         "pipeline_forward": case_pipeline_forward, "gpipe": case_gpipe,
         "refusals": case_refusals,
         "adafactor_stages": case_adafactor_stages}


def run_cases(root: pathlib.Path, rank: int, world: int) -> int:
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    cases = pickle.loads((root / "cases.pkl").read_bytes())
    results = {}
    for name, c in cases.items():
        try:
            results[name] = CASES[c["kind"]](c)
        except Exception:  # noqa: BLE001 - reported to the test
            results[name] = {"error": traceback.format_exc()}
            (root / f"error_{rank}.txt").write_text(results[name]["error"])
            if rank == 0:
                (root / "results.pkl").write_bytes(pickle.dumps(results))
            return 1
    if rank == 0:
        (root / "results.pkl").write_bytes(pickle.dumps(results))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_env(root: pathlib.Path) -> int:
    ctx = distributed.initialize_from_env(timeout_ms=60_000, device="cpu")
    out = {"ctx": dataclasses.asdict(ctx)}
    distributed.kv_put(f"hello/{ctx.rank}", f"from {ctx.rank}")
    distributed.barrier("after_put", timeout_ms=60_000)
    out["kv"] = [distributed.kv_get(f"hello/{r}", timeout_ms=60_000)
                 for r in range(ctx.world_size)]
    rng = np.random.default_rng(ctx.rank)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.integers(0, 100, (5,)).astype(np.int32),
                  torch.from_numpy(rng.standard_normal(2)).to(
                      torch.float64)]}
    out["tree"] = {"a": tree["a"], "b": [tree["b"][0],
                                         tree["b"][1].numpy()]}
    mean = distributed.kv_allreduce_mean(tree, ctx, "t")
    out["mean"] = {"a": mean["a"], "b": [mean["b"][0], mean["b"][1].numpy()],
                   "types": [type(mean["a"]).__name__,
                             type(mean["b"][1]).__name__,
                             str(mean["b"][1].dtype)]}
    os.environ[distributed.NUM_SLICES] = str(ctx.world_size)
    mesh = distributed.make_mesh_from_env({"fsdp": -1}, device="cpu")
    out["slices_mesh"] = (mesh.mesh_dim_names, tuple(mesh.shape))
    os.environ[distributed.NUM_SLICES] = "1"
    mesh = distributed.make_mesh_from_env({"fsdp": -1}, device="cpu")
    out["flat_mesh"] = (mesh.mesh_dim_names, tuple(mesh.shape))
    distributed.barrier("done", timeout_ms=60_000)
    (root / f"env_{ctx.rank}.pkl").write_bytes(pickle.dumps(out))
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, world):
    """``world`` worker processes with the SKYPILOT_* env of a
    ``world``-node gang on a free port; returns their outputs, killing
    every one on a failure or a timeout."""
    port = free_port()
    procs = []
    try:
        for r in range(world):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("JAX", "XLA", "LOCAL_"))}
            env.update({distributed.NODE_RANK: str(r),
                        distributed.NUM_NODES: str(world),
                        distributed.COORDINATOR_ADDR:
                            f"127.0.0.1:{port}",
                        "OMP_NUM_THREADS": "1"})
            procs.append(subprocess.Popen(
                [sys.executable, __file__, *args(r)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        outs = [p.communicate(timeout=WAIT_S)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def tiny_f32(vocab_size: int = 512) -> llama.LlamaConfig:
    return dataclasses.replace(TINY(vocab_size), dtype=torch.float32)


TINY = llama.LlamaConfig.tiny


def run_resnet(root: pathlib.Path, argv) -> int:
    from skypilot_tpu_torch.recipes import resnet_ddp
    args = resnet_ddp.build_arg_parser().parse_args(argv)
    metrics, model = resnet_ddp.run(args)
    params = {n: p.detach().numpy() for n, p in model.named_parameters()}
    (root / f"params_{metrics['rank']}.pkl").write_bytes(pickle.dumps(params))
    dist.destroy_process_group()
    return 0


def run_lora(argv) -> int:
    from skypilot_tpu_torch.recipes import llama_lora
    llama.LlamaConfig.tiny = staticmethod(tiny_f32)
    llama_lora.main(argv)
    return 0


if __name__ == "__main__":
    mode, root = sys.argv[1], pathlib.Path(sys.argv[2])
    if mode == "cases":
        sys.exit(run_cases(root, int(sys.argv[3]), int(sys.argv[4])))
    if mode == "lora":
        sys.exit(run_lora(sys.argv[3:]))
    if mode == "resnet":
        sys.exit(run_resnet(root, sys.argv[3:]))
    if mode == "tp":
        sys.exit(run_tp(root, int(sys.argv[3]), int(sys.argv[4]),
                        sys.argv[5]))
    sys.exit(run_env(root))
