"""The port's KV-cache serving half of Llama (skypilot_tpu_torch.models.llama)
against the JAX package's, on the CPU in f32, from the same converted
weights, tokens and caches: forward_with_cache, forward_with_paged_cache,
verify_step(_paged), decode, quantize_params and the int8 pool writes.
Gemma's serving is those functions driven by its config's knobs (the
(1 + w) norms, GeGLU, the sqrt(dim) embed multiplier, MQA at head_dim
256): every check that takes a model runs again on two Gemma configs
(``test_gemma_serving_matches_jax``).

Logits and float caches are held to 2e-3 norm-relative (the JAX flash
tests' tolerance: f32, summation order only). int8 codes and scales are
held equal, except that a code may sit one step apart where f32 rounding
puts an entry on a .5 boundary differently: at most 0.1% of the codes,
counted. Within the port, paged output equals dense bit for bit when the
tiles align.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import gemma as gemma_jax
from skypilot_tpu.models import llama as llama_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import gemma as gemma_torch
from skypilot_tpu_torch.models import llama as llama_torch

TOL = 2e-3
VOCAB = 256
# int8 parity: share of codes allowed one step apart, none further.
CODE_SLACK = 1e-3


def _configs():
    cfg_j = dataclasses.replace(llama_jax.LlamaConfig.tiny(VOCAB),
                                n_layers=2, dtype=jnp.float32)
    cfg_t = dataclasses.replace(llama_torch.LlamaConfig.tiny(VOCAB),
                                n_layers=2, dtype=torch.float32)
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = _configs()
    params_j = llama_jax.init(cfg_j, jax.random.key(0))
    params_t = convert.llama_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(1, VOCAB, shape,
                                                dtype=np.int32)


def _assert_cache_close(cache_j, cache_t):
    for name, leaf in cache_j.items():
        got = convert.cache_to_numpy(cache_t)[name]
        assert got.shape == leaf.shape, name
        assert _rel(leaf, got) < TOL, name


def _assert_codes_close(codes_j, codes_t, label):
    """int8 codes equal but for a counted few one step apart."""
    diff = np.abs(np.asarray(codes_j, np.int32) - np.asarray(codes_t,
                                                             np.int32))
    assert diff.max() <= 1, label
    assert (diff > 0).mean() <= CODE_SLACK, (label, (diff > 0).sum())


@pytest.mark.parametrize("max_seq,block", [(48, 16), (48, 20), (48, None)],
                         ids=["block-divides", "block-clamped",
                              "default-block"])
def test_forward_with_cache_matches_jax(model, max_seq, block):
    """A ragged prefill (per-slot start and valid_len) then one decode
    step, both reading and writing the cache: logits and cache within
    2e-3. A block that does not divide max_seq takes the clamped final
    window."""
    cfg_j, cfg_t, params_j, params_t = model
    b, t = 3, 12
    start = np.array([0, 9, 30], np.int32)
    valid = np.array([7, 21, 42], np.int32)
    toks = _tokens(1, (b, t))
    cache_j = llama_jax.init_cache(cfg_j, b, max_seq)
    cache_t = llama_torch.init_cache(cfg_t, b, max_seq, "cpu")
    step = _tokens(2, (b, 1))
    with torch.no_grad():
        for tk, st, vl in ((toks, start, valid), (step, valid, None)):
            lj, cache_j = llama_jax.forward_with_cache(
                cfg_j, params_j, jnp.asarray(tk), cache_j,
                jnp.asarray(st), None if vl is None else jnp.asarray(vl),
                block=block)
            lt, cache_t = llama_torch.forward_with_cache(
                cfg_t, params_t, torch.from_numpy(tk).long(), cache_t, st,
                vl, block=block)
            assert lt.shape == lj.shape
            assert _rel(lj, lt.numpy()) < TOL
    _assert_cache_close(cache_j, cache_t)


def test_forward_with_cache_logits_at_matches_jax(model):
    cfg_j, cfg_t, params_j, params_t = model
    toks = _tokens(3, (2, 16))
    true_len = np.array([5, 16], np.int32)
    cache_j = llama_jax.init_cache(cfg_j, 2, 32)
    cache_t = llama_torch.init_cache(cfg_t, 2, 32, "cpu")
    lj, _ = llama_jax.forward_with_cache(
        cfg_j, params_j, jnp.asarray(toks), cache_j, 0,
        valid_len=jnp.asarray(true_len), logits_at=jnp.asarray(true_len - 1))
    with torch.no_grad():
        lt, _ = llama_torch.forward_with_cache(
            cfg_t, params_t, torch.from_numpy(toks).long(), cache_t, 0,
            valid_len=true_len, logits_at=true_len - 1)
    assert lt.shape == (2, 1, VOCAB)
    assert _rel(lj, lt.numpy()) < TOL


def test_verify_step_junk_columns_match_jax(model):
    """A (B, 5) verify window whose slots carry 0, 2 and 4 drafts: the
    junk columns past each slot's drafts write nothing (dense rows >=
    max_seq are dropped) and are masked from every other query."""
    cfg_j, cfg_t, params_j, params_t = model
    max_seq = 40
    prompt = _tokens(4, (3, 16))
    cache_j = llama_jax.init_cache(cfg_j, 3, max_seq)
    cache_np = convert.cache_to_numpy(
        llama_torch.init_cache(cfg_t, 3, max_seq, "cpu"))
    _, cache_j = llama_jax.forward_with_cache(
        cfg_j, params_j, jnp.asarray(prompt), cache_j, 0)
    cache_t = convert.cache_from_jax(jax.tree.map(np.asarray, cache_j),
                                     "cpu")
    assert set(cache_np) == set(cache_t)
    window = _tokens(5, (3, 5))
    start = np.array([16, 16, 16], np.int32)
    spec = np.array([0, 2, 4], np.int32)
    lj, cache_j = llama_jax.verify_step(cfg_j, params_j,
                                        jnp.asarray(window), cache_j,
                                        jnp.asarray(start),
                                        jnp.asarray(spec))
    with torch.no_grad():
        lt, cache_t = llama_torch.verify_step(
            cfg_t, params_t, torch.from_numpy(window).long(), cache_t,
            start, spec)
    assert _rel(lj, lt.numpy()) < TOL
    _assert_cache_close(cache_j, cache_t)
    # Slot 0's junk columns wrote nothing past its own row 16.
    assert not cache_t["k"][:, 0, 17:].any()


def _paged_drive(api, cfg, params, cache, table, prompts, window,
                 chunk, tensor):
    """Chunk-prefill each prompt into its own table row, then one
    batched T == 1 step and one verify window; returns the logits."""
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
    toks = _tokens(6, (len(prompts), 1))
    logits, cache = api.forward_with_paged_cache(
        cfg, params, tensor(toks), cache, tensor(table), tensor(pos),
        window=window)
    out.append(np.asarray(logits))
    window_toks = _tokens(7, (len(prompts), 3))
    logits, cache = api.verify_step_paged(
        cfg, params, tensor(window_toks), cache, tensor(table),
        tensor(pos + 1), tensor(np.array([2, 1], np.int32)), window=window)
    out.append(np.asarray(logits))
    return out, cache


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_paged_forward_and_verify_match_jax(model, quantized):
    """Chunked prefill (whole-block writes, a right-padded final chunk),
    a T == 1 row scatter crossing into a fresh block, and a verify
    window through the table: logits within 2e-3 of JAX; the float pool
    within 2e-3, the int8 codes and scales equal but for the counted
    slack."""
    cfg_j, cfg_t, params_j, params_t = model
    chunk, nb = 8, 12
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    prompts = [list(_tokens(8, 16)), list(_tokens(9, 13))]
    pool_j = llama_jax.init_paged_cache(cfg_j, nb, chunk,
                                        quantized=quantized)
    pool_t = llama_torch.init_paged_cache(cfg_t, nb, chunk,
                                          quantized=quantized, device="cpu")
    out_j, pool_j = _paged_drive(llama_jax, cfg_j, params_j, pool_j, table,
                                 prompts, 16, chunk, jnp.asarray)
    with torch.no_grad():
        out_t, pool_t = _paged_drive(
            llama_torch, cfg_t, params_t, pool_t, table, prompts, 16,
            chunk, lambda a: torch.from_numpy(np.asarray(a)).long())
    for lj, lt in zip(out_j, out_t):
        assert _rel(lj, lt) < TOL
    got = convert.cache_to_numpy(pool_t)
    live = slice(1, None)   # block 0 is the scratch block
    if not quantized:
        for name in ("k", "v"):
            assert _rel(np.asarray(pool_j[name])[:, live],
                        got[name][:, live]) < TOL
    else:
        for name in ("k", "v"):
            _assert_codes_close(np.asarray(pool_j[name])[:, live],
                                got[name][:, live], name)
            assert _rel(np.asarray(pool_j[name + "_scale"])[:, live],
                        got[name + "_scale"][:, live]) < 1e-6


def test_paged_equals_dense_bitwise(model):
    """Within the port: the paged pool through block tables gives the
    dense cache's logits bit for bit when the window equals the dense
    tile (prefill chunks, then decode steps past a tile boundary)."""
    _, cfg_t, _, params_t = model
    chunk, tile, max_seq = 8, 16, 48
    prompts = [list(_tokens(10, 14)), list(_tokens(11, 21))]
    table = np.array([[3, 1, 5, 7, 0, 0], [2, 6, 4, 8, 9, 10]], np.int64)
    dense = llama_torch.init_cache(cfg_t, 2, max_seq, "cpu")
    pool = llama_torch.init_paged_cache(cfg_t, 11, chunk, device="cpu")
    with torch.no_grad():
        for b, prompt in enumerate(prompts):
            for start in range(0, len(prompt), chunk):
                piece = torch.zeros((1, chunk), dtype=torch.long)
                part = prompt[start:start + chunk]
                piece[0, :len(part)] = torch.tensor(part)
                valid = start + len(part)
                row = {k: v[:, b:b + 1] for k, v in dense.items()}
                ld, _ = llama_torch.forward_with_cache(
                    cfg_t, params_t, piece, row, start, valid_len=valid,
                    logits_at=valid - start - 1, block=tile)
                lp, _ = llama_torch.forward_with_paged_cache(
                    cfg_t, params_t, piece, pool, table[b:b + 1], start,
                    valid_len=valid, logits_at=valid - start - 1,
                    window=tile, write_block=int(table[b, start // chunk]))
                assert torch.equal(ld, lp)
        pos = np.array([len(p) for p in prompts])
        toks = torch.from_numpy(_tokens(12, (2, 1))).long()
        for _ in range(6):
            ld, _ = llama_torch.forward_with_cache(cfg_t, params_t, toks,
                                                   dense, pos, block=tile)
            lp, _ = llama_torch.forward_with_paged_cache(
                cfg_t, params_t, toks, pool, table, pos, window=tile)
            assert torch.equal(ld, lp)
            toks = ld[:, -1].argmax(-1, keepdim=True)
            pos = pos + 1


def test_quantize_params_codes_equal_jax(model):
    cfg_j, cfg_t, params_j, params_t = model
    q_j = jax.tree.map(np.asarray, llama_jax.quantize_params(cfg_j,
                                                             params_j))
    q_t = convert.llama_params_to_numpy(
        llama_torch.quantize_params(cfg_t, params_t))
    assert llama_torch.params_quantized(
        llama_torch.quantize_params(cfg_t, params_t))
    flat_j = jax.tree_util.tree_leaves_with_path(q_j)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(q_t))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        assert flat_t[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(flat_t[path], leaf, err_msg=str(path))


def test_int8_forward_matches_jax(model):
    """The int8 tree through the cache path: quantized embed gather,
    int8 lora_dense, and the head's scale folded into the logits."""
    cfg_j, cfg_t, params_j, params_t = model
    q_j = llama_jax.quantize_params(cfg_j, params_j)
    q_t = convert.llama_params_from_jax(cfg_t, jax.tree.map(np.asarray, q_j),
                                        "cpu")
    toks = _tokens(13, (2, 10))
    lj, _ = llama_jax.forward_with_cache(
        cfg_j, q_j, jnp.asarray(toks), llama_jax.init_cache(cfg_j, 2, 16), 0)
    with torch.no_grad():
        lt, _ = llama_torch.forward_with_cache(
            cfg_t, q_t, torch.from_numpy(toks).long(),
            llama_torch.init_cache(cfg_t, 2, 16, "cpu"), 0)
    assert _rel(lj, lt.numpy()) < TOL


def test_quant_writes_match_jax():
    """_quant_block_write then _quant_scatter_row over a sequence that
    fills a block past its boundary, grows a scale (a row of larger
    absmax) and reuses a block (offset 0 resets its inherited scale):
    codes and scales equal to JAX's after every write."""
    rng = np.random.default_rng(14)
    nb, bt, kvh, d = 5, 4, 2, 16
    pk_j = jnp.zeros((nb, bt, kvh, d), jnp.int8)
    ks_j = jnp.zeros((nb, kvh), jnp.float32)
    pk_t = torch.zeros((nb, bt, kvh, d), dtype=torch.int8)
    ks_t = torch.zeros((nb, kvh), dtype=torch.float32)

    def check(label):
        _assert_codes_close(np.asarray(pk_j), pk_t.numpy(), label)
        np.testing.assert_array_equal(np.asarray(ks_j), ks_t.numpy(),
                                      err_msg=label)

    rows = rng.standard_normal((bt, kvh, d)).astype(np.float32)
    valid = np.array([True, True, True, False])
    rows[3] *= 50.0                      # junk row: must not set the scale
    pk_j, ks_j = llama_jax._quant_block_write(
        pk_j, ks_j, 1, jnp.asarray(rows), jnp.asarray(valid))
    llama_torch._quant_block_write(pk_t, ks_t, 1, torch.from_numpy(rows),
                                   torch.from_numpy(valid))
    check("block write")
    # (block, offset) per slot for each step; slot 2 is a free slot on
    # the scratch block. Offsets 3 then 0 of block 2 cross the boundary;
    # step 2 grows block 2's scale; step 4 reuses block 1 at offset 0.
    steps = [((1, 3), (2, 0), (0, 0)), ((2, 1), (3, 0), (0, 0)),
             ((2, 2), (3, 1), (0, 0)), ((1, 0), (3, 2), (0, 0))]
    for n, targets in enumerate(steps):
        row = rng.standard_normal((3, kvh, d)).astype(np.float32)
        if n == 2:
            row[0] *= 8.0
        blk = np.array([b for b, _ in targets], np.int32)
        off = np.array([o for _, o in targets], np.int32)
        pk_j, ks_j = llama_jax._quant_scatter_row(
            pk_j, ks_j, jnp.asarray(blk), jnp.asarray(off), jnp.asarray(row))
        llama_torch._quant_scatter_row(
            pk_t, ks_t, torch.from_numpy(blk).long(),
            torch.from_numpy(off).long(), torch.from_numpy(row))
        # The scratch block is never attended: compare the live ones.
        pk_j, ks_j = pk_j.at[0].set(0), ks_j.at[0].set(0.0)
        pk_t[0], ks_t[0] = 0, 0.0
        check(f"scatter step {n}")


def test_decode_greedy_and_seeded_match_jax(model):
    """Ragged prompts right-padded to one bucket: greedy tokens equal to
    JAX's, and sampled ones from the same key (prng's threefry) too."""
    cfg_j, cfg_t, params_j, params_t = model
    from skypilot_tpu_torch.serve import prng
    prompt = _tokens(15, (3, 16))
    true_len = np.array([5, 16, 9], np.int32)
    ref = np.asarray(llama_jax.decode(cfg_j, params_j, jnp.asarray(prompt),
                                      jnp.asarray(true_len), 8, 32))
    with torch.no_grad():
        got = llama_torch.decode(cfg_t, params_t,
                                 torch.from_numpy(prompt).long(), true_len,
                                 8, 32)
        assert torch.equal(got, llama_torch.greedy_decode(
            cfg_t, params_t, torch.from_numpy(prompt).long(), true_len, 8,
            32))
    np.testing.assert_array_equal(got.numpy(), ref)
    ref = np.asarray(llama_jax.decode(
        cfg_j, params_j, jnp.asarray(prompt), jnp.asarray(true_len), 8, 32,
        temperature=0.9, key=jax.random.key(3)))
    with torch.no_grad():
        got = llama_torch.decode(cfg_t, params_t,
                                 torch.from_numpy(prompt).long(), true_len,
                                 8, 32, temperature=0.9, key=prng.key(3))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_decode_rejects_bad_arguments(model):
    _, cfg_t, _, params_t = model
    prompt = torch.ones((2, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="true_len"):
        llama_torch.decode(cfg_t, params_t, prompt, [3, 4, 5], 4, 16)
    with pytest.raises(ValueError, match="exceeds the cache"):
        llama_torch.decode(cfg_t, params_t, prompt, 8, 12, 16)
    with pytest.raises(ValueError, match="PRNG key"):
        llama_torch.decode(cfg_t, params_t, prompt, 8, 4, 16,
                           temperature=0.5)


# Gemma's tiny config, and Gemma-2B's attention (MQA, head_dim 256) at a
# small width; 2 layers, f32.
GEMMA_FIELDS = {"tiny": dict(n_layers=2),
                "d256": dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=1,
                             head_dim_=256, mlp_dim=512)}


@pytest.fixture(scope="module", params=list(GEMMA_FIELDS))
def gemma_model(request):
    fields = GEMMA_FIELDS[request.param]
    cfg_j = dataclasses.replace(gemma_jax.GemmaConfig.tiny(VOCAB),
                                dtype=jnp.float32, **fields)
    cfg_t = dataclasses.replace(gemma_torch.GemmaConfig.tiny(VOCAB),
                                dtype=torch.float32, **fields)
    params_j = gemma_jax.init(cfg_j, jax.random.key(0))
    params_t = convert.gemma_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


GEMMA_CHECKS = {
    "cache": lambda m: test_forward_with_cache_matches_jax(m, 48, 16),
    "cache-clamped": lambda m: test_forward_with_cache_matches_jax(m, 48,
                                                                   20),
    "logits-at": test_forward_with_cache_logits_at_matches_jax,
    "verify-junk": test_verify_step_junk_columns_match_jax,
    "paged-float": lambda m: test_paged_forward_and_verify_match_jax(m,
                                                                     False),
    "paged-int8": lambda m: test_paged_forward_and_verify_match_jax(m,
                                                                    True),
    "paged-equals-dense": test_paged_equals_dense_bitwise,
    "quantize-codes": test_quantize_params_codes_equal_jax,
    "int8-forward": test_int8_forward_matches_jax,
    "decode": test_decode_greedy_and_seeded_match_jax,
}


@pytest.mark.parametrize("check", list(GEMMA_CHECKS))
def test_gemma_serving_matches_jax(gemma_model, check):
    GEMMA_CHECKS[check](gemma_model)
