"""The port's training across ranks against the JAX package, on the CPU:
four gloo processes (``tests/torch_rank_worker.py``, spawned once for the
whole file; each case reads its results) against the JAX functions on
the same mesh shape over 4 of the 8 virtual CPU devices.

(a)-(c) ``make_train_step(..., mesh=, rules=)``: Llama tiny on
{fsdp: 2, tp: 2}, Gemma tiny (MQA: one KV head for two tp ranks) on
{dp: 2, tp: 2}, and the multislice {fsdp: 2} x 2 slices; three adamw
steps in f32, loss and grad norm per step within LOSS_TOL, final
parameters within MOVE_TOL of the distance moved, the tolerances of
``tests/test_torch_trainer.py``. (d) ring attention on {sp: 4} and
{sp: 2, tp: 2}, causal and not, and a prime chunk length through the
pad path, against JAX's ring and the reference: outputs 2e-4, gradients
1e-3 (``tests/test_ring_attention.py``). (e) ``forward_pipelined`` on
{pp: 2, tp: 2} against JAX's and against ``forward`` (1e-4,
``tests/test_pipeline.py``), the GPipe schedule on affine stages, and
three steps through the pipeline. (f) Llama with ring attention on
{sp: 2, tp: 2}, one step.

The sharded step without its former refusals, each against JAX's step
on the same mesh: the save_flash* policies on tp-split layers (Llama,
and Gemma's one KV head through ``kv_select``); LoRA adapters on all
seven projections of tp-split layers, only the adapters trained; sp
without the ring (the sequence gathered for attention only, a spy
showing that no ring ran and that the MLP saw the chunk), reference and
kernel impls, and save_flash under sp and tp; a pipeline on {pp: 4}
alone and on {pp: 2, sp: 2}; adafactor under pipeline stages; and an
adafactor state placed
onto the mesh after a step on one device. The refusals the JAX package
shares stay (``test_shared_refusals_still_raised``).
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from skypilot_tpu.models import gemma as gemma_jax
from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu.models import mixtral as mixtral_jax
from skypilot_tpu.ops import attention as attention_jax
from skypilot_tpu.parallel import mesh as mesh_jax
from skypilot_tpu.parallel import pipeline as pipeline_jax
from skypilot_tpu.parallel import ring_attention as ring_jax
from skypilot_tpu.train import trainer as trainer_jax

LOSS_TOL = 2e-3
MOVE_TOL = 2e-3
LR = 1e-2
TCFG = dict(warmup_steps=2, total_steps=10, learning_rate=LR)
WORLD = 4
WORKER = pathlib.Path(__file__).with_name("torch_rank_worker.py")
WAIT_S = 300
MODELS = {"llama": llama_jax, "gemma": gemma_jax}
CONFIGS = {"llama": llama_jax.LlamaConfig, "gemma": gemma_jax.GemmaConfig}
TRAIN = {
    "llama_fsdp_tp": dict(family="llama", axes={"fsdp": 2, "tp": 2}),
    "gemma_dp_tp": dict(family="gemma", axes={"dp": 2, "tp": 2}),
    "llama_multislice": dict(family="llama", axes={"fsdp": 2}, slices=2),
    "llama_pipelined": dict(family="llama", axes={"pp": 2, "tp": 2},
                            pipelined=True),
    "llama_ring": dict(family="llama", axes={"sp": 2, "tp": 2},
                       impl="ring", steps=1),
    # Adafactor's factored statistics over a table split on both dims
    # (vocab over tp, embed over fsdp), and the chunked loss through
    # trunk_fn + head_fn.
    "llama_adafactor": dict(family="llama", axes={"fsdp": 2, "tp": 2},
                            optimizer="adafactor"),
    "llama_chunked_ce": dict(family="llama", axes={"fsdp": 2, "tp": 2},
                             chunked=True),
    # The save_flash* backward on gathered layer views (no tp split),
    # through the kernel path's plain versions on the CPU.
    "llama_save_flash_qkv": dict(family="llama", axes={"dp": 2, "fsdp": 2},
                                 port_cfg={"attention_impl": "kernel",
                                           "remat_policy": "save_flash_qkv"}),
    # The save_flash* backward on tp-split layers: the rank's heads, the
    # x cotangent summed over tp once; Gemma's one KV head gathered whole
    # (kv_select).
    "llama_save_flash_offload_tp": dict(
        family="llama", axes={"fsdp": 2, "tp": 2},
        port_cfg={"attention_impl": "kernel",
                  "remat_policy": "save_flash_offload_qkv"}),
    "gemma_save_flash_qkv_tp": dict(
        family="gemma", axes={"dp": 2, "tp": 2},
        port_cfg={"attention_impl": "kernel",
                  "remat_policy": "save_flash_qkv"}),
    # Adapters on all seven projections of tp-split layers, only the
    # adapters trained: through save_flash_qkv's hand-written transposes
    # and through autograd under full remat.
    "llama_lora_tp": dict(family="llama", axes={"fsdp": 2, "tp": 2},
                          lora=True,
                          port_cfg={"attention_impl": "kernel",
                                    "remat_policy": "save_flash_qkv"}),
    "llama_lora_tp_full": dict(family="llama", axes={"fsdp": 2, "tp": 2},
                               lora=True),
    # sp without the ring: every part of a layer on the sequence chunk but
    # attention, which gathers it (parallel/seq_gather.py).
    "llama_sp_gather_sp2_tp2_reference": dict(
        family="llama", axes={"sp": 2, "tp": 2}, seq_split=2),
    "llama_sp_gather_sp2_tp2_kernel": dict(
        family="llama", axes={"sp": 2, "tp": 2}, seq_split=2,
        port_cfg={"attention_impl": "kernel"}),
    "llama_sp_gather_dp2_sp2_reference": dict(
        family="llama", axes={"dp": 2, "sp": 2}, seq_split=2),
    "llama_sp_gather_dp2_sp2_kernel": dict(
        family="llama", axes={"dp": 2, "sp": 2}, seq_split=2,
        port_cfg={"attention_impl": "kernel"}),
    "llama_sp_save_flash_tp": dict(
        family="llama", axes={"sp": 2, "tp": 2}, seq_split=2,
        port_cfg={"attention_impl": "kernel", "remat_policy": "save_flash"}),
    # A pipeline on a mesh of pp alone (a stage is one process), and
    # adafactor under pipeline stages.
    "llama_pp_only": dict(family="llama", axes={"pp": 4}, pipelined=True),
    "llama_pipelined_sp": dict(family="llama", axes={"pp": 2, "sp": 2},
                               pipelined=True, seq_split=2),
    "llama_adafactor_pipelined": dict(family="llama", axes={"pp": 2, "tp": 2},
                                      pipelined=True,
                                      optimizer="adafactor"),
    # An adafactor state placed after its first step (one device), then
    # two steps on the mesh.
    "llama_adafactor_replace": dict(family="llama", axes={"fsdp": 2, "tp": 2},
                                    optimizer="adafactor", replace=True),
}
# Adapters on the LoRA recipe's four targets and the MLP's three
# (skypilot_tpu/recipes/llama_lora.py), rank 4; B drawn nonzero so the
# first step moves A too.
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
LORA_RANK = 4
# Adafactor alone under pipeline stages ({pp 2, tp 2}): 130 layers, so
# a stacked leaf whose layer axis is one of its two largest ("tall",
# (130, 4, 150)) is factored across the stages; "w" factors per layer,
# "b" not at all; the embedding factors, split on its rows over tp.
ADAFACTOR_STAGES = dict(
    axes={"pp": 2, "tp": 2}, n_layers=130, seed=9, steps=3,
    layer={"tall": (4, 150), "w": (136, 144), "b": (8,)},
    top={"embed": (256, 128)},
    specs={"embed": ("vocab", "embed"),
           "layers": {"tall": (None, "mlp"), "w": ("embed", "mlp"),
                      "b": (None,)}},
    tcfg=dict(TCFG, optimizer="adafactor", max_grad_norm=50.0))
# The refusals the JAX package shares (test_shared_refusals_still_raised):
# (name, family, mesh, config fields).
REFUSALS = (
    ("mlp_dim_tp", "llama", {"tp": 4}, {"mlp_dim": 250}),
    ("experts_ep", "mixtral", {"ep": 4}, {"n_experts": 6}),
    ("mixtral_pp", "mixtral", {"pp": 4}, {}),
)
RING = {
    "sp4_causal": dict(axes={"sp": 4}, causal=True),
    "sp4_full": dict(axes={"sp": 4}, causal=False),
    "sp2_tp2_causal": dict(axes={"sp": 2, "tp": 2}, causal=True),
    "sp2_tp2_full": dict(axes={"sp": 2, "tp": 2}, causal=False),
    # Chunk length 61, prime: with blocks of 16 and a floor of 8 the
    # chunk is padded to 64 and the tail masked (JAX's
    # test_ring_prime_chunk_length_pads).
    "prime_causal": dict(axes={"dp": 2, "sp": 2}, causal=True,
                         shape=(4, 122, 2, 1, 16),
                         patch={"_KV_BLOCK": 16, "_KV_BLOCK_FLOOR": 8}),
    "prime_full": dict(axes={"dp": 2, "sp": 2}, causal=False,
                       shape=(4, 122, 2, 1, 16),
                       patch={"_KV_BLOCK": 16, "_KV_BLOCK_FLOOR": 8}),
}
RING_SHAPE = (2, 128, 4, 2, 32)


def _tcfg(spec):
    return dict(TCFG, optimizer=spec.get("optimizer", "adamw"))


def _jax_cfg(family, impl="reference"):
    cfg = CONFIGS[family].tiny(vocab_size=256)
    return dataclasses.replace(cfg, dtype=jnp.float32,
                               attention_impl=impl)


def _init(family):
    cfg = _jax_cfg(family)
    return jax.tree.map(np.asarray, MODELS[family].init(cfg,
                                                        jax.random.key(0)))


def _tokens(seed=7, shape=(4, 64)):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.int32)


def _qkv(shape, seed):
    b, s, h, kvh, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]


def _lora(family):
    """Adapters in the JAX tree's stacked layout: A ~ N(0, 1/in), B ~
    N(0, 0.02^2)."""
    shapes = _init(family)["layers"]
    rng = np.random.default_rng(5)
    out = {}
    for name in LORA_TARGETS:
        n_layers, fan_in, fan_out = shapes[name].shape
        out[name + "_lora_a"] = (rng.standard_normal(
            (n_layers, fan_in, LORA_RANK)) * fan_in ** -0.5).astype(
                np.float32)
        out[name + "_lora_b"] = (rng.standard_normal(
            (n_layers, LORA_RANK, fan_out)) * 0.02).astype(np.float32)
    return {"layers": out}


def _cases():
    cases = {}
    for name, spec in TRAIN.items():
        port_impl = "ring" if spec.get("impl") == "ring" else "reference"
        port_cfg = spec.get("port_cfg", {"attention_impl": port_impl})
        cases[name] = dict(kind="train", family=spec["family"],
                           axes=spec["axes"], slices=spec.get("slices"),
                           pipelined=spec.get("pipelined", False),
                           vocab=256, cfg=port_cfg,
                           init=_init(spec["family"]), tokens=_tokens(),
                           tcfg=_tcfg(spec), steps=spec.get("steps", 3),
                           chunked=spec.get("chunked", False),
                           lora=_lora(spec["family"]) if spec.get("lora")
                           else None,
                           replace=spec.get("replace", False))
    cases["refusals"] = dict(kind="refusals", meshes=REFUSALS, vocab=256,
                             tokens=_tokens())
    cases["adafactor_stages"] = dict(kind="adafactor_stages",
                                     **ADAFACTOR_STAGES)
    for i, (name, spec) in enumerate(RING.items()):
        q, k, v = _qkv(spec.get("shape", RING_SHAPE), i)
        patch = spec.get("patch", {})
        cases["ring_" + name] = dict(
            kind="ring", axes=spec["axes"], causal=spec["causal"], q=q, k=k,
            v=v, patch=patch,
            restore={n: 512 if n == "_KV_BLOCK" else 128 for n in patch})
    cases["pipeline_forward"] = dict(kind="pipeline_forward",
                                     family="llama", axes={"pp": 2, "tp": 2},
                                     vocab=64, init=_init_small(),
                                     tokens=_tokens(1, (4, 32)) % 64)
    rng = np.random.default_rng(3)
    cases["gpipe"] = dict(kind="gpipe", axes={"pp": 2, "tp": 2},
                          w=(rng.standard_normal((2, 16, 16)) * 0.3).astype(
                              np.float32),
                          x=rng.standard_normal((4, 2, 16)).astype(
                              np.float32))
    return cases


def _init_small():
    cfg = dataclasses.replace(llama_jax.LlamaConfig.tiny(vocab_size=64),
                              dtype=jnp.float32)
    return jax.tree.map(np.asarray, llama_jax.init(cfg, jax.random.key(0)))


class _Run:
    """The four worker processes; ``results()`` waits for them once."""

    def __init__(self, root: pathlib.Path, cases: dict):
        self.root, self.cases = root, cases
        (root / "cases.pkl").write_bytes(pickle.dumps(cases))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX", "XLA"))}
        env["OMP_NUM_THREADS"] = "1"
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), "cases", str(root), str(r),
             str(WORLD)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(WORLD)]
        self._results = None

    def results(self) -> dict:
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    out, _ = p.communicate(timeout=WAIT_S)
                    logs.append(out.decode(errors="replace")[-3000:])
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            path = self.root / "results.pkl"
            assert path.exists(), "\n".join(logs)
            self._results = pickle.loads(path.read_bytes())
            self._logs = logs
        return self._results

    def get(self, name: str) -> dict:
        res = self.results().get(name)
        errors = "\n".join(f.read_text()[-3000:] for f in sorted(
            self.root.glob("error_*.txt")))
        assert res is not None, f"{name}: not run\n{errors}"
        assert "error" not in res, errors
        return res


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    r = _Run(tmp_path_factory.mktemp("ranks"), _cases())
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _jax_mesh(axes, slices=None):
    devices = jax.devices()[:WORLD]
    if slices:
        return mesh_jax.make_multislice_mesh(axes, slices, devices=devices)
    return mesh_jax.make_mesh(axes, devices=devices)


def _jax_lora_train(spec, cfg, mesh, rules, model):
    """JAX's step on the mesh with only the adapters trained (the LoRA
    recipe's step_fn, the trainer's optimizer and loss): losses, grad
    norms and the final tree, the adapters merged."""
    base = jax.device_put(model.init(cfg, jax.random.key(0)),
                          mesh_jax.tree_shardings(mesh, rules,
                                                  model.param_specs(cfg)))
    lora = jax.tree.map(jnp.asarray, _lora(spec["family"]))
    tx = trainer_jax.make_optimizer(trainer_jax.TrainConfig(**_tcfg(spec)))
    opt = tx.init(lora)

    def merged(lora):
        return {**base, "layers": {**base["layers"], **lora["layers"]}}

    def loss_fn(lora, tokens):
        with mesh_jax.use_mesh(mesh, rules):
            logits = model.forward(
                cfg, merged(lora), tokens,
                constrain=lambda x, a: mesh_jax.constrain(x, mesh, rules, a))
        return trainer_jax.cross_entropy_loss(logits[:, :-1], tokens[:, 1:])

    @jax.jit
    def step(lora, opt, tokens):
        loss, grads = jax.value_and_grad(loss_fn)(lora, tokens)
        updates, opt = tx.update(grads, opt, lora)
        return (optax.apply_updates(lora, updates), opt, loss,
                optax.global_norm(grads))
    tokens = jnp.asarray(_tokens())
    losses, norms = [], []
    for _ in range(spec.get("steps", 3)):
        lora, opt, loss, norm = step(lora, opt, tokens)
        losses.append(float(loss))
        norms.append(float(norm))
    return losses, norms, jax.tree.map(np.asarray, merged(lora))


def _jax_train(spec):
    family = spec["family"]
    cfg = _jax_cfg(family, spec.get("impl", "reference"))
    mesh = _jax_mesh(spec["axes"], spec.get("slices"))
    rules = (mesh_jax.PIPELINE_RULES if spec.get("pipelined")
             else mesh_jax.DEFAULT_RULES)
    model = MODELS[family]
    if spec.get("lora"):
        return _jax_lora_train(spec, cfg, mesh, rules, model)
    params = model.init(cfg, jax.random.key(0))
    tx = trainer_jax.make_optimizer(trainer_jax.TrainConfig(**_tcfg(spec)))
    state = trainer_jax.init_train_state(params, tx)
    first = None
    if spec.get("replace"):
        # One step on one device, then the state device_put onto the mesh.
        one = mesh_jax.make_mesh({"dp": 1}, devices=jax.devices()[:1])
        state, first = trainer_jax.make_train_step(
            lambda p, t, constrain: model.forward(cfg, p, t,
                                                  constrain=constrain),
            tx, one, rules)(state, {"tokens": jnp.asarray(_tokens())})
        state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
    if spec.get("optimizer") == "adafactor":
        # JAX's state_shardings would give the factored statistics their
        # parameter's (higher-rank) sharding: place the parameters only.
        state.params = jax.device_put(state.params, mesh_jax.tree_shardings(
            mesh, rules, model.param_specs(cfg)))
    else:
        state = jax.device_put(state, trainer_jax.state_shardings(
            mesh, rules, model.param_specs(cfg), state))
    if spec.get("pipelined"):
        def fwd(p, t, constrain):
            return llama_jax.forward_pipelined(cfg, p, t, mesh=mesh,
                                               rules=rules,
                                               num_microbatches=2)
    else:
        def fwd(p, t, constrain):
            return model.forward(cfg, p, t, constrain=constrain)
    if spec.get("chunked"):
        step = trainer_jax.make_train_step(
            None, tx, mesh, rules,
            trunk_fn=lambda p, t, constrain: model.forward_trunk(
                cfg, p, t, constrain=constrain),
            head_fn=model.head_weights)
    else:
        step = trainer_jax.make_train_step(fwd, tx, mesh, rules)
    batch = {"tokens": jnp.asarray(_tokens())}
    losses, norms = [], []
    if first is not None:
        losses.append(float(first["loss"]))
        norms.append(float(first["grad_norm"]))
    for _ in range(spec.get("steps", 3) - len(losses)):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_steps_match_jax(run, name):
    spec = TRAIN[name]
    losses, norms, final_j = _jax_train(spec)
    got = run.get(name)
    if "remat_policy" in spec.get("port_cfg", {}):
        assert got["flash_remat_layers"] > 0
    seq = got["seq"]
    if spec.get("seq_split"):
        # No ring ran, and only attention saw the whole sequence.
        chunk = _tokens().shape[1] // spec["seq_split"]
        assert seq == {"ring": 0, "gathered": {chunk}, "mlp": {chunk}}, seq
    elif spec.get("impl") != "ring":
        assert seq["ring"] == 0 and not seq["gathered"], seq
    np.testing.assert_allclose(got["loss"], losses, rtol=LOSS_TOL)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=LOSS_TOL)
    init = _init(spec["family"])
    if spec.get("lora"):
        init["layers"].update(_lora(spec["family"])["layers"])
    for path, want in jax.tree_util.tree_leaves_with_path(final_j):
        a, i0 = got["final"], init
        for key in path:
            a, i0 = a[key.key], i0[key.key]
        moved = np.linalg.norm(want - i0)
        assert np.linalg.norm(a - want) <= MOVE_TOL * moved, path
        np.testing.assert_allclose(a, want, rtol=0, atol=LR / 2,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_matches_jax(run, name, monkeypatch):
    spec = RING[name]
    for attr, value in spec.get("patch", {}).items():
        monkeypatch.setattr(ring_jax, attr, value)
    c = run.cases["ring_" + name]
    q, k, v = (jnp.asarray(c[n]) for n in "qkv")
    mesh = _jax_mesh(spec["axes"])
    causal = spec["causal"]

    def loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v) ** 2)

    def ring(q, k, v):
        return ring_jax.ring_attention(q, k, v, mesh=mesh, causal=causal)

    def ref(q, k, v):
        return attention_jax._reference_attention(q, k, v, causal=causal,
                                                  scale=None)
    out_j = jax.jit(ring)(q, k, v)
    out_ref = ref(q, k, v)
    got = run.get("ring_" + name)
    for want in (out_j, out_ref):
        np.testing.assert_allclose(got["out"], np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
    grads_j = jax.jit(jax.grad(loss(ring), argnums=(0, 1, 2)))(q, k, v)
    grads_ref = jax.grad(loss(ref), argnums=(0, 1, 2))(q, k, v)
    for n, gj, gr in zip(("dq", "dk", "dv"), grads_j, grads_ref):
        for want in (gj, gr):
            np.testing.assert_allclose(got[n], np.asarray(want), rtol=1e-3,
                                       atol=1e-3, err_msg=n)


def test_pipelined_forward_matches_jax_and_forward(run):
    c = run.cases["pipeline_forward"]
    cfg = dataclasses.replace(llama_jax.LlamaConfig.tiny(vocab_size=64),
                              dtype=jnp.float32)
    params = llama_jax.init(cfg, jax.random.key(0))
    mesh = _jax_mesh({"pp": 2, "tp": 2})
    piped_j = jax.jit(lambda p, t: llama_jax.forward_pipelined(
        cfg, p, t, mesh=mesh, rules=mesh_jax.PIPELINE_RULES,
        num_microbatches=2))(params, jnp.asarray(c["tokens"]))
    got = run.get("pipeline_forward")
    np.testing.assert_allclose(got["piped"], np.asarray(piped_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["piped"], got["plain"], rtol=1e-4,
                               atol=1e-4)


def test_gpipe_matches_jax(run):
    c = run.cases["gpipe"]
    mesh = _jax_mesh({"pp": 2, "tp": 2})
    out_j = jax.jit(lambda w, x: pipeline_jax.gpipe(
        lambda lp, xm, _e: jnp.tanh(xm @ lp["w"]), {"w": w}, x, mesh=mesh,
        num_microbatches=x.shape[0]))(jnp.asarray(c["w"]),
                                      jnp.asarray(c["x"]))
    ref = c["x"]
    for w in c["w"]:
        ref = np.tanh(ref @ w)
    got = run.get("gpipe")["out"]
    np.testing.assert_allclose(got, np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_shared_refusals_still_raised(run):
    """Each refusal of the sharded step that the JAX package shares is
    raised, by name, on every rank: an mlp_dim that tp does not divide
    and n_experts that ep does not divide (JAX's device_put refuses both
    shardings), and Mixtral on a pipeline (JAX has no pipelined Mixtral
    forward)."""
    got = run.get("refusals")
    assert got["mlp_dim_tp"][0] == "ValueError"
    assert "mlp_dim=250 not divisible by tp=4" in got["mlp_dim_tp"][1]
    assert got["experts_ep"] == ("ValueError",
                                 "n_experts=6 not divisible by ep=4")
    assert got["mixtral_pp"][0] == "NotImplementedError"
    assert "pp > 1" in got["mixtral_pp"][1]
    assert not hasattr(mixtral_jax, "forward_pipelined")
    for axes, shape, spec in (({"tp": 4}, (128, 250), (None, "tp")),
                              ({"ep": 4}, (6, 64, 128), ("ep",))):
        with pytest.raises(ValueError, match="divisible"):
            jax.device_put(np.zeros(shape, np.float32), NamedSharding(
                _jax_mesh(axes), PartitionSpec(*spec)))


def test_adafactor_over_pipeline_stages_matches_optax(run):
    """The port's adafactor on a tree whose layers are split over pipeline
    stages (and a dim over tp) against optax's chain on the same tree on
    one device: each leaf within 1e-5 of how far it moved after three
    steps (``tests/test_torch_adafactor.py``'s bound). The layer-axis
    leaf's row statistic and every block rms are summed over pp."""
    from torch_rank_worker import stage_tree_arrays
    c = ADAFACTOR_STAGES
    params, grads = stage_tree_arrays(c)
    tx = trainer_jax.make_optimizer(trainer_jax.TrainConfig(**c["tcfg"]))
    p_j = jax.tree.map(jnp.asarray, params)
    opt = tx.init(p_j)
    for g in grads:
        upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, p_j)
        p_j = optax.apply_updates(p_j, upd)
    got = run.get("adafactor_stages")
    for path, want in jax.tree_util.tree_leaves_with_path(p_j):
        a, i0 = got, params
        for key in path:
            a, i0 = a[key.key], i0[key.key]
        moved = np.linalg.norm(np.asarray(want) - i0)
        assert moved > 0, path
        assert np.linalg.norm(a - np.asarray(want)) <= 1e-5 * moved, path
