"""The port's Mixtral serving half (skypilot_tpu_torch.models.mixtral:
quantize_params, the dense-routed MoE block and the KV-cache paths) against
the JAX package's, on the CPU from the same converted weights, tokens and
caches; then the port's DecodeEngine and serve_llm replica on
``mixtral-tiny`` against JAX's engine and replica.

``_moe_mlp_dense`` is held in f32 (2e-5 norm-relative: summation order
only), in bf16 and on the int8 tree (1e-2: one bf16 rounding is 2^-8 =
3.9e-3 relative, and XLA rounds silu's sigmoid and product apart where
torch rounds once; the readings are 4.6e-3 and 5.3e-3), and with exactly
tied gates, where both packages must take the same two experts (the lower
index first). The cache paths are
held as llama's are in ``test_torch_serve_models.py``: logits and float
caches within 2e-3 in f32, int8 codes equal but for a counted few one step
apart, paged equal to dense bit for bit within the port. Greedy decode is
held token for token; seeded decode too, except at a near-tie of JAX's two
best perturbed logits (the gumbel ``log`` may round an ulp apart), which
is counted. The engine's streams (dense, paged, speculative, prefix hit,
host tier, int8 weights and KV) equal the JAX engine's, and the replica's
HTTP bodies equal the JAX replica's byte for byte.
"""
import dataclasses
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import mixtral as mixtral_jax
from skypilot_tpu.recipes import serve_llm as serve_jax
from skypilot_tpu.serve import decode_engine as engine_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import mixtral as mixtral_torch
from skypilot_tpu_torch.models import model_api
from skypilot_tpu_torch.observability import metrics as metrics_torch
from skypilot_tpu_torch.recipes import serve_llm as serve_torch
from skypilot_tpu_torch.serve import decode_engine as engine_torch
from skypilot_tpu_torch.serve import prng


@pytest.fixture(scope="module", autouse=True)
def no_tuning_manifest():
    """Every engine here runs the default constants: no ambient tuning
    manifest (STPU_TUNE_MANIFEST=0), set before the module's engines."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STPU_TUNE_MANIFEST", "0")
        yield


TOL = 2e-3
F32_MLP_TOL = 2e-5
BF16_MLP_TOL = 1e-2
SCALE_TOL = 1e-7
CODE_SLACK = 1e-3
NEAR_TIE = 1e-5
VOCAB = 128


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(1, VOCAB, shape,
                                                dtype=np.int32)


def _long(a):
    return torch.from_numpy(np.asarray(a)).long()


def _pair(dtype_j=jnp.float32, dtype_t=torch.float32, **fields):
    cfg_j = dataclasses.replace(mixtral_jax.MixtralConfig.tiny(VOCAB),
                                dtype=dtype_j, **fields)
    cfg_t = dataclasses.replace(mixtral_torch.MixtralConfig.tiny(VOCAB),
                                dtype=dtype_t, **fields)
    params_j = mixtral_jax.init(cfg_j, jax.random.key(0))
    params_t = convert.mixtral_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


@pytest.fixture(scope="module")
def model():
    return _pair()


def _assert_codes_close(codes_j, codes_t, label):
    """int8 codes equal but for a counted few one step apart."""
    diff = np.abs(np.asarray(codes_j, np.int32) - np.asarray(codes_t,
                                                             np.int32))
    assert diff.max() <= 1, label
    assert (diff > 0).mean() <= CODE_SLACK, (label, (diff > 0).sum())


# --------------------------------------------------------- the MoE block

def _layer0(params_j, params_t):
    return (jax.tree.map(lambda a: a[0], params_j["layers"]),
            params_t.layers[0])


def _moe_inputs(cfg, dtype_j, dtype_t, seed=1):
    y = np.random.default_rng(seed).standard_normal(
        (2, 7, cfg.dim)).astype(np.float32)
    y_j = jnp.asarray(y).astype(dtype_j)
    y_t = torch.from_numpy(np.array(y_j.astype(jnp.float32))).to(dtype_t)
    return y_j, y_t


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_moe_mlp_dense_matches_jax(mode):
    """Every expert on every token, the top-2 combined: the port's block
    against JAX's, in f32, in bf16, and on the int8 tree (codes cast to
    bf16, the (E, out) scales applied in fp32)."""
    f32 = mode == "f32"
    dt_j, dt_t = ((jnp.float32, torch.float32) if f32
                  else (jnp.bfloat16, torch.bfloat16))
    cfg_j, cfg_t, params_j, params_t = _pair(dt_j, dt_t)
    if mode == "int8":
        params_j = mixtral_jax.quantize_params(cfg_j, params_j)
        params_t = convert.mixtral_params_from_jax(
            cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
        assert params_t.layers[0].w_gate.dtype == torch.int8
    lp_j, lp_t = _layer0(params_j, params_t)
    y_j, y_t = _moe_inputs(cfg_t, dt_j, dt_t)
    want = mixtral_jax._moe_mlp_dense(cfg_j, y_j, lp_j)
    with torch.no_grad():
        got = mixtral_torch._moe_mlp_dense(cfg_t, y_t, lp_t)
    assert got.dtype == dt_t and got.shape == want.shape
    assert _rel(np.asarray(want.astype(jnp.float32)),
                got.float().numpy()) < (F32_MLP_TOL if f32
                                        else BF16_MLP_TOL)


def test_moe_mlp_dense_tied_gates_take_lax_top_k_experts():
    """Router columns made equal so gates tie exactly: tokens with
    y . r > 0 tie experts 0, 1 and 2 (lax.top_k takes 0 and 1), the
    others have expert 3 first and then a three-way tie (3 and 0). Both
    packages take exactly those two experts, at the same weights."""
    cfg_j, cfg_t, params_j, params_t = _pair()
    lp_j, lp_t = _layer0(params_j, params_t)
    r = np.random.default_rng(2).standard_normal(cfg_t.dim).astype(
        np.float32) * 0.3
    router = np.stack([r, r, r, -r], axis=1)
    lp_j = dict(lp_j, router=jnp.asarray(router))
    with torch.no_grad():
        lp_t.router.copy_(torch.from_numpy(router))
    y_j, y_t = _moe_inputs(cfg_t, jnp.float32, torch.float32, seed=3)
    with torch.no_grad():
        gates = torch.softmax(y_t.reshape(-1, cfg_t.dim) @ lp_t.router,
                              dim=-1)
        w = mixtral_torch._top2_weights(gates).numpy()
    pos = (y_t.reshape(-1, cfg_t.dim).numpy() @ r) > 0
    assert pos.any() and (~pos).any()
    np.testing.assert_array_equal(w[pos][:, 2:], 0.0)
    assert (w[pos][:, :2] > 0).all()
    np.testing.assert_array_equal(w[~pos][:, 1:3], 0.0)
    assert (w[~pos][:, [0, 3]] > 0).all()
    np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-6)
    want = mixtral_jax._moe_mlp_dense(cfg_j, y_j, lp_j)
    with torch.no_grad():
        got = mixtral_torch._moe_mlp_dense(cfg_t, y_t, lp_t)
    assert _rel(want, got.numpy()) < F32_MLP_TOL


def test_dense_routing_equals_capacity_path_without_drops(model):
    """The port's inference block equals its training block's capacity
    routing when capacity never binds (capacity_factor E / top_k makes
    C = T), as JAX's test_dense_routing_matches_capacity_path holds."""
    _, cfg_t, _, params_t = model
    roomy = dataclasses.replace(cfg_t, capacity_factor=cfg_t.n_experts /
                                cfg_t.top_k)
    lp = params_t.layers[0]
    y = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, cfg_t.dim)).astype(np.float32))
    assert mixtral_torch.capacity(roomy, 32) == 32
    with torch.no_grad():
        cap, _ = mixtral_torch._moe_mlp(roomy, y, lp)
        dense = mixtral_torch._moe_mlp_dense(cfg_t, y, lp)
    assert _rel(cap.numpy(), dense.numpy()) < F32_MLP_TOL


# ------------------------------------------------------- the int8 tree

def test_quantize_params_matches_jax(model):
    """Codes equal, scales within 1e-7 (the expert scales keep their
    expert axis), the router f32 and unchanged, norms shared; the port's
    tree round-trips through convert both ways."""
    cfg_j, cfg_t, params_j, params_t = model
    q_j = jax.tree.map(np.asarray,
                       mixtral_jax.quantize_params(cfg_j, params_j))
    q_port = mixtral_torch.quantize_params(cfg_t, params_t)
    assert mixtral_torch.params_quantized(q_port)
    assert not mixtral_torch.params_quantized(params_t)
    assert q_port.layers[0].router is params_t.layers[0].router
    q_t = convert.mixtral_params_to_numpy(q_port)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(q_j))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(q_t))
    assert set(flat_j) == set(flat_t)
    for path, leaf in flat_j.items():
        got = flat_t[path]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        if leaf.dtype == np.int8:
            np.testing.assert_array_equal(got, leaf, err_msg=str(path))
        else:
            np.testing.assert_allclose(got, leaf, rtol=0, atol=SCALE_TOL,
                                       err_msg=str(path))
    assert q_t["layers"]["w_gate_scale"].shape == (
        cfg_t.n_layers, cfg_t.n_experts, cfg_t.mlp_dim)
    assert q_t["layers"]["router"].dtype == np.float32
    np.testing.assert_array_equal(q_t["layers"]["router"],
                                  q_j["layers"]["router"])
    # JAX's int8 tree into the port and back: leaf for leaf.
    back = convert.mixtral_params_to_numpy(
        convert.mixtral_params_from_jax(cfg_t, q_j, "cpu"))
    for path, leaf in dict(jax.tree_util.tree_leaves_with_path(
            back)).items():
        np.testing.assert_array_equal(leaf, flat_j[path], err_msg=str(path))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_init_quantize_equals_quantize_params_of_init(dtype):
    """``init(..., quantize=True)``, drawn and quantized a layer at a
    time (and each expert tensor one expert at a time), is
    ``quantize_params(init(...))`` from the same seed, leaf for leaf."""
    cfg = dataclasses.replace(mixtral_torch.MixtralConfig.tiny(VOCAB),
                              dtype=dtype)
    whole = mixtral_torch.quantize_params(cfg, mixtral_torch.init(
        cfg, torch.Generator().manual_seed(5), "cpu"))
    layered = mixtral_torch.init(cfg, torch.Generator().manual_seed(5),
                                 "cpu", quantize=True)
    assert mixtral_torch.params_quantized(layered)
    want = dict(whole.named_parameters())
    got = dict(layered.named_parameters())
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert got[name].dtype == leaf.dtype, name
        assert got[name].device.type == "cpu", name
        assert torch.equal(got[name], leaf), name
    assert got["layers.0.router"].dtype == torch.float32


def test_convert_checks_the_int8_tree(model):
    cfg_j, cfg_t, params_j, _ = model
    q_j = jax.tree.map(np.asarray,
                       mixtral_jax.quantize_params(cfg_j, params_j))
    bad = dict(q_j, layers=dict(q_j["layers"]))
    bad["layers"]["router"] = bad["layers"]["router"].astype(np.float16)
    with pytest.raises(ValueError, match="router: dtype"):
        convert.mixtral_params_from_jax(cfg_t, bad, "cpu")
    bad["layers"] = dict(q_j["layers"])
    bad["layers"]["w_up_scale"] = bad["layers"]["w_up_scale"][:, 0]
    with pytest.raises(ValueError, match="w_up_scale: shape"):
        convert.mixtral_params_from_jax(cfg_t, bad, "cpu")


# ------------------------------------------------------ the cache paths

def _assert_cache_close(cache_j, cache_t):
    got = convert.cache_to_numpy(cache_t)
    for name, leaf in cache_j.items():
        assert got[name].shape == leaf.shape, name
        assert _rel(leaf, got[name]) < TOL, name


def test_forward_with_cache_matches_jax(model):
    """A ragged prefill (per-slot start and valid_len, split-KV tiles of
    16) then one decode step: logits and cache within 2e-3."""
    cfg_j, cfg_t, params_j, params_t = model
    b, t, max_seq = 3, 12, 48
    start = np.array([0, 9, 30], np.int32)
    valid = np.array([7, 21, 42], np.int32)
    cache_j = mixtral_jax.init_cache(cfg_j, b, max_seq)
    cache_t = mixtral_torch.init_cache(cfg_t, b, max_seq, "cpu")
    with torch.no_grad():
        for tk, st, vl in ((_tokens(1, (b, t)), start, valid),
                           (_tokens(2, (b, 1)), valid, None)):
            lj, cache_j = mixtral_jax.forward_with_cache(
                cfg_j, params_j, jnp.asarray(tk), cache_j, jnp.asarray(st),
                None if vl is None else jnp.asarray(vl), block=16)
            lt, cache_t = mixtral_torch.forward_with_cache(
                cfg_t, params_t, _long(tk), cache_t, st, vl, block=16)
            assert lt.shape == lj.shape
            assert _rel(lj, lt.numpy()) < TOL
    _assert_cache_close(cache_j, cache_t)


def test_verify_step_matches_jax(model):
    """A (B, 5) verify window over a prefilled cache, slots carrying 0, 2
    and 4 drafts: logits and cache within 2e-3."""
    cfg_j, cfg_t, params_j, params_t = model
    prompt = _tokens(3, (3, 16))
    cache_j = mixtral_jax.init_cache(cfg_j, 3, 40)
    _, cache_j = mixtral_jax.forward_with_cache(
        cfg_j, params_j, jnp.asarray(prompt), cache_j, 0)
    cache_t = convert.cache_from_jax(jax.tree.map(np.asarray, cache_j),
                                     "cpu")
    window = _tokens(4, (3, 5))
    start = np.array([16, 16, 16], np.int32)
    spec = np.array([0, 2, 4], np.int32)
    lj, cache_j = mixtral_jax.verify_step(
        cfg_j, params_j, jnp.asarray(window), cache_j, jnp.asarray(start),
        jnp.asarray(spec))
    with torch.no_grad():
        lt, cache_t = mixtral_torch.verify_step(
            cfg_t, params_t, _long(window), cache_t, start, spec)
    assert _rel(lj, lt.numpy()) < TOL
    _assert_cache_close(cache_j, cache_t)


def _paged_drive(api, cfg, params, cache, table, prompts, window, chunk,
                 tensor):
    """Chunk-prefill each prompt into its own table row, then one batched
    T == 1 step and one verify window; returns the logits."""
    out = []
    for b, prompt in enumerate(prompts):
        for start in range(0, len(prompt), chunk):
            piece = np.zeros((1, chunk), np.int32)
            part = prompt[start:start + chunk]
            piece[0, :len(part)] = part
            valid = start + len(part)
            logits, cache = api.forward_with_paged_cache(
                cfg, params, tensor(piece), cache, tensor(table[b:b + 1]),
                start, valid_len=valid, logits_at=valid - start - 1,
                window=window, write_block=int(table[b, start // chunk]))
            out.append(np.asarray(logits))
    pos = np.array([len(p) for p in prompts], np.int32)
    logits, cache = api.forward_with_paged_cache(
        cfg, params, tensor(_tokens(6, (len(prompts), 1))), cache,
        tensor(table), tensor(pos), window=window)
    out.append(np.asarray(logits))
    logits, cache = api.verify_step_paged(
        cfg, params, tensor(_tokens(7, (len(prompts), 3))), cache,
        tensor(table), tensor(pos + 1), tensor(np.array([2, 1], np.int32)),
        window=window)
    out.append(np.asarray(logits))
    return out, cache


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_paged_forward_and_verify_match_jax(model, quantized):
    """Chunked prefill (a right-padded final chunk), a T == 1 scatter into
    a fresh block, a verify window through the table: logits within 2e-3
    of JAX's; the float pool within 2e-3, the int8 codes and scales equal
    but for the counted slack."""
    cfg_j, cfg_t, params_j, params_t = model
    chunk, nb = 8, 12
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    prompts = [list(_tokens(8, 16)), list(_tokens(9, 13))]
    pool_j = mixtral_jax.init_paged_cache(cfg_j, nb, chunk,
                                          quantized=quantized)
    pool_t = mixtral_torch.init_paged_cache(cfg_t, nb, chunk,
                                            quantized=quantized,
                                            device="cpu")
    out_j, pool_j = _paged_drive(mixtral_jax, cfg_j, params_j, pool_j,
                                 table, prompts, 16, chunk, jnp.asarray)
    with torch.no_grad():
        out_t, pool_t = _paged_drive(mixtral_torch, cfg_t, params_t, pool_t,
                                     table, prompts, 16, chunk, _long)
    for lj, lt in zip(out_j, out_t):
        assert _rel(lj, lt) < TOL
    got = convert.cache_to_numpy(pool_t)
    live = slice(1, None)   # block 0 is the scratch block
    for name in ("k", "v"):
        want = np.asarray(pool_j[name])[:, live]
        if quantized:
            _assert_codes_close(want, got[name][:, live], name)
            assert _rel(np.asarray(pool_j[name + "_scale"])[:, live],
                        got[name + "_scale"][:, live]) < 1e-6
        else:
            assert _rel(want, got[name][:, live]) < TOL


def test_paged_equals_dense_bitwise(model):
    """Within the port: the paged pool gives the dense cache's logits bit
    for bit when the window equals the dense tile."""
    _, cfg_t, _, params_t = model
    chunk, tile = 8, 16
    prompts = [list(_tokens(10, 14)), list(_tokens(11, 21))]
    table = np.array([[3, 1, 5, 7, 0, 0], [2, 6, 4, 8, 9, 10]], np.int64)
    dense = mixtral_torch.init_cache(cfg_t, 2, 48, "cpu")
    pool = mixtral_torch.init_paged_cache(cfg_t, 11, chunk, device="cpu")
    with torch.no_grad():
        for b, prompt in enumerate(prompts):
            for start in range(0, len(prompt), chunk):
                piece = torch.zeros((1, chunk), dtype=torch.long)
                part = prompt[start:start + chunk]
                piece[0, :len(part)] = torch.tensor(part)
                valid = start + len(part)
                row = {k: v[:, b:b + 1] for k, v in dense.items()}
                ld, _ = mixtral_torch.forward_with_cache(
                    cfg_t, params_t, piece, row, start, valid_len=valid,
                    logits_at=valid - start - 1, block=tile)
                lp, _ = mixtral_torch.forward_with_paged_cache(
                    cfg_t, params_t, piece, pool, table[b:b + 1], start,
                    valid_len=valid, logits_at=valid - start - 1,
                    window=tile, write_block=int(table[b, start // chunk]))
                assert torch.equal(ld, lp)
        pos = np.array([len(p) for p in prompts])
        toks = _long(_tokens(12, (2, 1)))
        for _ in range(6):
            ld, _ = mixtral_torch.forward_with_cache(cfg_t, params_t, toks,
                                                     dense, pos, block=tile)
            lp, _ = mixtral_torch.forward_with_paged_cache(
                cfg_t, params_t, toks, pool, table, pos, window=tile)
            assert torch.equal(ld, lp)
            toks = ld[:, -1].argmax(-1, keepdim=True)
            pos = pos + 1


def test_int8_forward_matches_jax(model):
    """JAX's int8 tree through both cache paths: the quantized embed
    gather, int8 attention and expert weights, the head's scale."""
    cfg_j, cfg_t, params_j, _ = model
    q_j = mixtral_jax.quantize_params(cfg_j, params_j)
    q_t = convert.mixtral_params_from_jax(cfg_t,
                                          jax.tree.map(np.asarray, q_j),
                                          "cpu")
    toks = _tokens(13, (2, 10))
    lj, _ = mixtral_jax.forward_with_cache(
        cfg_j, q_j, jnp.asarray(toks), mixtral_jax.init_cache(cfg_j, 2, 16),
        0)
    with torch.no_grad():
        lt, _ = mixtral_torch.forward_with_cache(
            cfg_t, q_t, _long(toks),
            mixtral_torch.init_cache(cfg_t, 2, 16, "cpu"), 0)
    assert _rel(lj, lt.numpy()) < TOL


def _decode_near_ties(cfg_j, params_j, prompt, true_len, got, want, temp,
                      key):
    """Rows where the port's sampled tokens part from JAX's: each must
    part first at a near-tie of JAX's two best perturbed logits (its own
    key chain: one split per token, as llama.decode draws). Returns how
    many rows parted."""
    parted = 0
    keys = []
    k = key
    for _ in range(got.shape[1]):
        k, sub = jax.random.split(k)
        keys.append(sub)
    for b in range(got.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if not len(diff):
            continue
        parted += 1
        i = int(diff[0])
        n = int(true_len[b])
        seq = np.concatenate([prompt[b, :n], want[b, :i]])[None]
        logits, _ = mixtral_jax.forward_with_cache(
            cfg_j, params_j, jnp.asarray(seq),
            mixtral_jax.init_cache(cfg_j, 1, seq.shape[1]), 0)
        z = (np.asarray(jax.random.gumbel(keys[i], (VOCAB,))) +
             np.asarray(logits[0, -1]) / temp)
        top2 = np.sort(z)[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (b, i, top2)
    return parted


def test_decode_greedy_and_seeded_match_jax(model):
    """Ragged prompts right-padded to one bucket: greedy tokens equal to
    JAX's; sampled ones from the same key equal but at counted
    near-ties; the cache passed in is filled in place."""
    cfg_j, cfg_t, params_j, params_t = model
    prompt = _tokens(15, (3, 16))
    true_len = np.array([5, 16, 9], np.int32)
    ref = np.asarray(mixtral_jax.decode(cfg_j, params_j, jnp.asarray(prompt),
                                        jnp.asarray(true_len), 8, 32))
    cache = mixtral_torch.init_cache(cfg_t, 3, 32, "cpu")
    with torch.no_grad():
        got = mixtral_torch.decode(cfg_t, params_t, _long(prompt), true_len,
                                   8, 32, cache=cache)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert cache["k"].shape == (cfg_t.n_layers, 3, 32, cfg_t.n_kv_heads,
                                cfg_t.head_dim) and cache["k"].any()
    ref = np.asarray(mixtral_jax.decode(
        cfg_j, params_j, jnp.asarray(prompt), jnp.asarray(true_len), 8, 32,
        temperature=0.9, key=jax.random.key(3)))
    with torch.no_grad():
        got = mixtral_torch.decode(cfg_t, params_t, _long(prompt), true_len,
                                   8, 32, temperature=0.9,
                                   key=prng.key(3)).numpy()
    parted = _decode_near_ties(cfg_j, params_j, prompt, true_len, got, ref,
                               0.9, jax.random.key(3))
    assert parted <= 1, parted


def test_incremental_equals_whole(model):
    """tests/test_mixtral.py's serving contract on the port: the greedy
    tokens of prefill + cached T = 1 steps equal, step by step, a fresh
    cache's prefill over each whole prefix."""
    _, cfg_t, _, params_t = model
    prompt = _long(_tokens(16, (2, 8)))
    with torch.no_grad():
        toks = mixtral_torch.decode(cfg_t, params_t, prompt, 8, 4, 16)
        seq, expected = prompt, []
        for _ in range(4):
            padded = torch.nn.functional.pad(seq, (0, 16 - seq.shape[1]))
            logits, _ = mixtral_torch.forward_with_cache(
                cfg_t, params_t, padded,
                mixtral_torch.init_cache(cfg_t, 2, 16, "cpu"), 0,
                valid_len=seq.shape[1], logits_at=seq.shape[1] - 1)
            nxt = logits[:, 0].argmax(-1)
            expected.append(nxt)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert toks.shape == (2, 4)
    assert torch.equal(toks, torch.stack(expected, dim=1))


def test_model_api_serves_mixtral():
    assert model_api(mixtral_torch.MixtralConfig.tiny()) is mixtral_torch


# ------------------------------------------------- engine and replica

GEOMETRY = dict(slots=2, max_seq=64, prefill_chunk=8)


def _requests():
    """(prompt, max_tokens, temperature, seed): greedy and seeded, the
    repetitive ones settling into cycles the n-gram drafter proposes."""
    rng = np.random.default_rng(17)
    rand = rng.integers(1, VOCAB, 17).tolist()
    loop = [5, 6, 7] * 6
    return [(rand, 6, 0.0, 0), (loop, 10, 0.2, 17), (loop, 10, 0.0, 0),
            (rand[:9], 6, 0.7, 5)]


# Shares the first two 8-token blocks of request 0's prompt.
PREFIXED = (_requests()[0][0] + [3, 1, 4, 1, 5], 6, 0.0, 0)


def _run(engine, reqs):
    try:
        handles = [engine.submit(p, max_tokens=m, temperature=t, seed=s)
                   for p, m, t, s in reqs]
        return [h.result(timeout=300.0) for h in handles]
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def jax_streams(model):
    """The JAX engine's streams, f32 and int8 (weights and KV): the
    requests' streams followed by PREFIXED's."""
    cfg_j, _, params_j, _ = model
    out = {}
    for mode, quant in (("f32", False), ("int8", True)):
        eng = engine_jax.DecodeEngine(
            cfg_j, params_j, paged=True, kv_quant=quant, weight_quant=quant,
            use_manifest=False, **GEOMETRY).start()
        out[mode] = _run(eng, _requests() + [PREFIXED])
    return out


def _port_engine(model, params=None, **kw):
    _, cfg_t, _, params_t = model
    return engine_torch.DecodeEngine(cfg_t, params or params_t,
                                     device="cpu", **GEOMETRY, **kw).start()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("spec_k", [0, 4], ids=["spec0", "spec4"])
def test_engine_matches_jax(model, jax_streams, paged, spec_k):
    eng = _port_engine(model, paged=paged, spec_k=spec_k, spec_ngram=2)
    drafted = metrics_torch.REGISTRY.counter(
        "stpu_engine_spec_drafted_tokens_total")
    before = drafted.get()
    assert _run(eng, _requests()) == jax_streams["f32"][:4]
    if spec_k:
        assert drafted.get() > before


@pytest.mark.parametrize("prequantized", [False, True],
                         ids=["quantized-here", "prequantized"])
def test_engine_int8_weights_and_kv_match_jax(model, jax_streams,
                                              prequantized):
    """int8 weights and KV: the engine quantizes the tree, or takes an
    already-quantized one as it is (no second quantization)."""
    _, cfg_t, _, params_t = model
    params = (mixtral_torch.quantize_params(cfg_t, params_t) if prequantized
              else None)
    eng = _port_engine(model, params, paged=True, kv_quant=True,
                       weight_quant=True, spec_k=4, spec_ngram=2)
    if prequantized:
        assert eng._params is params
    assert eng.kv_config()["kv_quant"] == eng.kv_config()["weight_quant"] \
        == 1
    assert _run(eng, _requests()) == jax_streams["int8"][:4]


def test_engine_prefix_hit_matches_jax(model, jax_streams):
    hits = metrics_torch.REGISTRY.counter(
        "stpu_engine_prefix_cache_hits_total")
    before = hits.get()
    eng = _port_engine(model, paged=True)
    try:
        first = eng.submit(_requests()[0][0], max_tokens=6)
        assert first.result(timeout=300.0) == jax_streams["f32"][0]
        warm = eng.submit(PREFIXED[0], max_tokens=6)
        assert warm.result(timeout=300.0) == jax_streams["f32"][4]
        assert warm.cached_prompt_tokens == 16
    finally:
        eng.shutdown()
    assert hits.get() == before + 1


def test_engine_host_tier_readmit_matches_jax(model, jax_streams):
    """Cold streams, every prefix block spilled to the host tier, then
    the same requests: re-admitted blocks give JAX's streams."""
    reqs = _requests()[:2]
    eng = _port_engine(model, paged=True, prefix_cache_mb=8)
    try:
        cold = [eng.submit(p, max_tokens=m, temperature=t, seed=s)
                for p, m, t, s in reqs]
        assert [h.result(timeout=300.0) for h in cold] == \
            jax_streams["f32"][:2]
        while eng.prefix_cache.evict_one():
            pass
        deadline = time.monotonic() + 30.0
        while eng.spill_in_flight() > 0:
            assert time.monotonic() < deadline, "spill drain never landed"
            time.sleep(0.005)
        warm = [eng.submit(p, max_tokens=m, temperature=t, seed=s)
                for p, m, t, s in reqs]
        assert [h.result(timeout=300.0) for h in warm] == \
            jax_streams["f32"][:2]
        assert eng.host_tier_stats()["readmitted_blocks"] >= 4
    finally:
        eng.shutdown()


def _call(httpd, body):
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                      timeout=120)
    conn.request("POST", "/generate", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


GREEDY = {"prompt": [1, 2, 3, 4, 5], "max_tokens": 8, "stream": True}
SEEDED = {"prompt": [7, 8, 9], "max_tokens": 8, "temperature": 0.8,
          "seed": 5, "stream": True}


@pytest.mark.parametrize("engine_slots", [2, 0], ids=["engine", "locked"])
def test_replica_bytes_equal_jax(model, engine_slots):
    """--model mixtral-tiny's replica on converted weights: the SSE and
    JSON bodies byte-equal to JAX's, through the engine and through the
    legacy locked path (--engine-slots 0)."""
    cfg_j, cfg_t, params_j, params_t = model
    pair = []
    try:
        for module, cfg, params, kw in (
                (serve_jax, cfg_j, params_j, {}),
                (serve_torch, cfg_t, params_t, {"device": "cpu"})):
            ready = threading.Event()
            httpd = module.serve(cfg, params, 0, ready_event=ready,
                                 engine_slots=engine_slots, **kw)
            pair.append(httpd)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            assert ready.wait(timeout=120)
        for body in (GREEDY, SEEDED, dict(SEEDED, stream=False)):
            want = _call(pair[0], body)
            assert want[0] == 200
            assert _call(pair[1], body) == want
    finally:
        for httpd in pair:
            httpd.shutdown()
            httpd.server_close()
            if httpd.engine is not None:
                httpd.engine.shutdown()
