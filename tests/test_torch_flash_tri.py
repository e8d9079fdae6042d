"""The port's triangular flash family (skypilot_tpu_torch.ops.flash_attention:
flash_fwd_tri_plain, flash_bwd_tri_plain, the family dispatch and the
tile schedule) against the JAX package's triangular kernels, on the CPU.

Inputs come from numpy with a seed and go to both sides. The JAX side runs
``_flash_fwd_tri`` / ``_flash_bwd_tri`` in interpret mode, as
tests/test_flash_attention.py does, at two unequal block shapes, to show
the function does not depend on the TPU's blocks; the port side runs the
plain versions a CPU tensor gets. The base-2 lse is compared as it is, with
no conversion. Tolerances are the JAX tests' own: 2e-3 for outputs and
lse, 5e-3 for gradients (f32 on both sides; the gap is summation order and
the JAX side's pre-scaled q).
"""
import collections
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.pallas import flash_attention as fa_jax
from skypilot_tpu_torch.ops import flash_attention as fa_torch

OUT_TOL = 2e-3
GRAD_TOL = 5e-3
BLOCKS = [(128, 64), (64, 128)]


@pytest.fixture
def past_budget(monkeypatch):
    """Both packages past the resident budget. JAX keeps traces of its
    flash op keyed on the function, not on the patched budget, so its
    caches are cleared on entry and on exit: no trace of one family meets
    the other's backward, here or in a later test."""
    jax.clear_caches()
    monkeypatch.setattr(fa_jax, "_use_resident", lambda s, d: False)
    monkeypatch.setattr(fa_torch, "_use_resident", lambda s, d: False)
    yield
    jax.clear_caches()


def _arrays(seed, b=1, s=256, h=4, kvh=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                          (b, s, h, d))]


def _check_forward(q, k, v, block_q, block_k):
    scale = q.shape[-1] ** -0.5
    o_j, lse_j = fa_jax._flash_fwd_tri(*map(jnp.asarray, (q, k, v)),
                                       scale=scale, block_q=block_q,
                                       block_k=block_k)
    o_t, lse_t = fa_torch.flash_fwd_tri_plain(
        *map(torch.from_numpy, (q, k, v)), scale)
    assert lse_t.shape == lse_j.shape == (q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=OUT_TOL,
                               atol=OUT_TOL)


@pytest.mark.parametrize("block_q,block_k", BLOCKS)
def test_tri_forward_matches_jax(block_q, block_k):
    _check_forward(*_arrays(0)[:3], block_q, block_k)


@pytest.mark.parametrize("block_q,block_k", BLOCKS)
def test_tri_forward_matches_jax_at_head_dim_256(block_q, block_k):
    # Gemma's head (one KV head of 256 for four query heads), the width
    # the kernels take past the budget at S > 2048.
    _check_forward(*_arrays(5, h=4, kvh=1, d=256)[:3], block_q, block_k)


def _check_backward(q, k, v, do, block_q, block_k):
    scale = q.shape[-1] ** -0.5
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    o_j, lse_pad = fa_jax._flash_fwd_tri(qj, kj, vj, scale=scale,
                                         block_q=block_q, block_k=block_k,
                                         keep_lse_pad=True)
    ref = fa_jax._flash_bwd_tri((qj, kj, vj, o_j, lse_pad), doj,
                                scale=scale, block_q=block_q,
                                block_k=block_k)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o_t, lse_t = fa_torch.flash_fwd_tri_plain(qt, kt, vt, scale)
    got = fa_torch.flash_bwd_tri_plain(qt, kt, vt, o_t, lse_t, dot, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("block_q,block_k", BLOCKS)
def test_tri_backward_matches_jax(block_q, block_k):
    _check_backward(*_arrays(1, b=2, h=6), block_q, block_k)


@pytest.mark.parametrize("block_q,block_k", BLOCKS)
def test_tri_backward_matches_jax_at_head_dim_256(block_q, block_k):
    _check_backward(*_arrays(6, h=4, kvh=1, d=256), block_q, block_k)


def test_dispatch_past_budget_takes_triangular_family(monkeypatch,
                                                      past_budget):
    # Past the budget on both sides: JAX's flash_attention takes its
    # triangular kernels; the port's takes the triangular plain versions,
    # never the resident ones, and matches output and gradients.
    q, k, v, _ = _arrays(2, b=2, s=128)
    calls = collections.Counter()

    def spy(name):
        fn = getattr(fa_torch, name)

        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        monkeypatch.setattr(fa_torch, name, wrapped)

    for name in ("flash_fwd_plain", "flash_bwd_plain", "flash_fwd_tri_plain",
                 "flash_bwd_tri_plain"):
        spy(name)

    def loss_jax(q, k, v):
        out = fa_jax.flash_attention(q, k, v, causal=True, block_q=64,
                                     block_k=64)
        return jnp.sum(out ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss_jax, argnums=(0, 1, 2),
                                         has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out_t = fa_torch.flash_attention(qt, kt, vt, causal=True)
    g_t = torch.autograd.grad((out_t ** 2).sum(), (qt, kt, vt))
    assert calls == {"flash_fwd_tri_plain": 1, "flash_bwd_tri_plain": 1}
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("s,d,causal", [
    (2048, 128, True), (4096, 128, True), (4160, 128, True),
    (8192, 128, True), (8192, 64, True), (16384, 64, True),
    (8192, 128, False), (32768, 128, False), (4160, 128, False)])
def test_family_follows_jax_budget(s, d, causal):
    # JAX: resident within the budget, triangular for causal past it,
    # streamed for non-causal past it; the port makes the same choice.
    if fa_jax._use_resident(s, d):
        want = fa_torch.RESIDENT
    elif causal:
        want = fa_torch.TRIANGULAR
    else:
        want = fa_torch.STREAMED
    assert fa_torch._use_resident(s, d) == fa_jax._use_resident(s, d)
    assert fa_torch.family(s, d, causal) == want


# The long-context lengths the Hopper backward's lists must cover: ragged
# (200, 4136), a multiple of 64 but not of 128 (4160), and whole.
BWD_S = (200, 4096, 4136, 4160, 8192)
# _T: a small square tile (64 rows), the lists' arithmetic at tiles
# other than the kernels'.
_T, _BT, _BI = 64, fa_torch.BWD_TILE, fa_torch.BWD_INNER


def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize("n_rows,s,tile,inner", [
    pytest.param(1, 64, _T, _T, id="1-64"),
    pytest.param(3, 512, _T, _T, id="3-512"),
    pytest.param(8, 1024, _T, _T, id="8-1024"),
] + [pytest.param(2, s, _BT, _BI, id=f"bwd-2-{s}") for s in BWD_S] + [
    # Gemma-2B's 8 heads at a ragged length, not a multiple of 64.
    pytest.param(8, 1000, _BT, _BI, id="bwd-8-1000"),
])
def test_row_schedule_covers_the_triangle(n_rows, s, tile, inner):
    # Forward / dq: every (row, q tile) once, longest first; the pair count
    # is the JAX enumeration's at the list's tiles: 64-row q and kv
    # tiles, or the Hopper dq's 128-row q tiles against 64-row kv tiles.
    work = fa_torch.tri_schedule("rows", n_rows, s, tile=tile,
                                 inner=inner).tolist()
    nt = _ceil(s, tile)
    assert sorted(map(tuple, work)) == [(r, t) for r in range(n_rows)
                                        for t in range(nt)]
    qs, _ = fa_jax._tri_maps_row(nt, _ceil(s, inner), tile, inner)
    pairs = collections.Counter(qs.tolist())
    cost = [pairs[t] for _, t in work]
    assert cost == sorted(cost, reverse=True)
    assert sum(cost) == n_rows * len(qs)


class _OnCard(torch.Tensor):
    is_cuda = True


@pytest.mark.parametrize("s", [8192, 4136, 4160, 200, 1000])
def test_tri_dq_launch_carries_the_row_schedule(s, monkeypatch):
    # The triangular dq at head_dim 256 (Gemma-2B's 8 heads over 1)
    # launches with the row list at 128-row q tiles against the 64-row
    # K/V tiles its CTA walks (DqSplitKV), as built above and checked
    # longest first by test_row_schedule_covers_the_triangle. Spied on
    # bf16 CPU tensors that claim to be on the card, every input check
    # kept.
    b, h, kvh, d = 1, 8, 1, 256
    launches = []
    check = fa_torch._check_inputs
    monkeypatch.setattr(fa_torch, "_check_inputs", lambda *ts, **kw: check(
        *(x.as_subclass(_OnCard) for x in ts), **kw))
    monkeypatch.setattr(fa_torch, "_launch", lambda name, source, ptrs,
                        *rest: launches.append((name, source, list(ptrs))))
    q = torch.zeros(b, s, h, d, dtype=torch.bfloat16)
    k = torch.zeros(b, s, kvh, d, dtype=torch.bfloat16)
    lse = torch.zeros(b, h, s)
    fa_torch.flash_dq_tri(q, k, k, q, lse, q, 0.0625)
    ((name, source, ptrs),) = launches
    assert (name, source) == ("flash_dq_tri", "flash_tri")
    want = fa_torch.tri_schedule("rows", b * h, s, tile=_BT, inner=_BI)
    assert torch.equal(ptrs[-1], want)


# q tiles half the kv tiles: the column list at unequal small tiles.
_HALF_T = _T // 2


@pytest.mark.parametrize("n_rows,s,tile,inner", [
    pytest.param(1, 64, _T, _HALF_T, id="1-64"),
    pytest.param(2, 512, _T, _HALF_T, id="2-512"),
    pytest.param(8, 1024, _T, _HALF_T, id="8-1024"),
] + [pytest.param(2, s, _BT, _BI, id=f"bwd-2-{s}") for s in BWD_S])
def test_col_schedule_covers_the_triangle(n_rows, s, tile, inner):
    # dk/dv: every (row, kv tile) once, heaviest (first) kv tiles first,
    # counted in q tiles: 64-row kv tiles against 32-row q tiles, or the
    # Hopper dk/dv's (resident, triangular and streamed) 128-row kv tiles
    # against 64-row q tiles.
    work = fa_torch.tri_schedule("cols", n_rows, s, tile=tile,
                                 inner=inner).tolist()
    nt = _ceil(s, tile)
    assert sorted(map(tuple, work)) == [(r, t) for r in range(n_rows)
                                        for t in range(nt)]
    ks, _, _ = fa_jax._tri_maps_col(_ceil(s, inner), nt, inner, tile, 1)
    pairs = collections.Counter(ks.tolist())
    cost = [pairs[t] for _, t in work]
    assert cost == sorted(cost, reverse=True)
    assert sum(cost) == n_rows * len(ks)


# The width-256 triangular and streamed dk/dv (dkv_cta_wide): 64-row kv
# tiles against 64-row q tiles, each (row, kv tile) in P parts of the GQA
# group.
_WT = fa_torch.WIDE_KV_TILE


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("s", [200, 4136, 4160, 8192])
def test_wide_dkv_schedule_covers_every_part(s, parts, causal):
    # Every (row, kv tile, part) once, the longest items first, costed in
    # q tiles per head from the kernel's loop bounds (causal: from the
    # diagonal tile kt): causal, they sum to n_rows x P x the JAX
    # enumeration's pairs at 64 x 64 tiles; not causal, every item walks
    # every q tile.
    n_rows = 3
    work = fa_torch.dkv_wide_schedule(n_rows, s, parts).tolist()
    nt, ni = _ceil(s, _WT), _ceil(s, fa_torch.BWD_INNER)
    assert sorted(map(tuple, work)) == [(r, t, p) for r in range(n_rows)
                                        for t in range(nt)
                                        for p in range(parts)]
    cost = [ni - (t if causal else 0) for _, t, _ in work]
    assert cost == sorted(cost, reverse=True)
    ks, _, _ = fa_jax._tri_maps_col(ni, nt, fa_torch.BWD_INNER, _WT, 1)
    assert sum(cost) == n_rows * parts * (len(ks) if causal else nt * ni)


@pytest.mark.parametrize("b,s,h,kvh,causal,want", [
    # Gemma-2B at its context ([gemma_long], triangular): 256 items.
    (1, 8192, 8, 1, True, 2),
    # The streamed width-256 main shape, non-causal: 128 items.
    (1, 4096, 8, 1, False, 2),
    # Causal at 4096 (the op's [wide op] shape): the shorter triangle
    # needs smaller items.
    (1, 4096, 8, 1, True, 4),
    # Shapes that fill the card alone: Gemma-7B's MHA, a batch of 8.
    (1, 4096, 16, 16, True, 1),
    (8, 2048, 8, 1, True, 1),
])
def test_dkv_parts_at_the_main_shapes(b, s, h, kvh, causal, want):
    assert fa_torch.dkv_parts(b, s, kvh, h // kvh, causal, 132) == want


@pytest.mark.parametrize("groups", [1, 2, 3, 4, 6, 8, 12, 16])
@pytest.mark.parametrize("s,causal", [(200, True), (4160, True),
                                      (8192, True), (4136, False),
                                      (16384, False)])
def test_dkv_parts_is_the_least_cost_divisor(groups, s, causal):
    # P divides G, is at most MAX_PARTS, and has the least modelled cost
    # of all such divisors; each divisor's makespan lies within list
    # scheduling's bounds (at least the longest item and an SM's mean
    # share, at most their sum), and only a split pays for partials.
    sms = 132
    parts = fa_torch.dkv_parts(1, s, 1, groups, causal, sms)
    assert groups % parts == 0 and parts <= fa_torch.MAX_PARTS
    n = _ceil(s, _WT)
    costs = {}
    for p in range(1, min(groups, fa_torch.MAX_PARTS) + 1):
        if groups % p:
            continue
        makespan, traffic = fa_torch.dkv_parts_cost(1, s, 1, groups, causal,
                                                    sms, p)
        items = [groups // p * (n - (t if causal else 0)) + 1
                 for t in range(n) for _ in range(p)]
        mean = sum(items) / sms
        assert max(max(items), mean) <= makespan <= max(items) + mean
        assert (traffic == 0) == (p == 1)
        costs[p] = makespan + traffic
    assert costs[parts] == min(costs.values())


def _split_sum_plain(q, k, v, o, lse, do, causal, scale, base, parts):
    """What the width-256 dk/dv's split computes, plainly: the (2, P, B,
    S, KVH, D) fp32 partials its items hold (dv's, then dk's unscaled),
    part p over the p-th of P equal slices of each KV head's query group,
    from the family's lse (``base`` "2" or "e"); then (dk, dv) as the last
    item of a kv tile sums them, part 0 + part 1 + ... in fp32, dk times
    ``scale``."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    per = g // parts
    exp, _, mul = fa_torch._BASES[base]
    ws = torch.empty((2, parts, b, s, kvh, d), dtype=torch.float32)
    for j in range(kvh):
        sc = fa_torch._group_scores(q, k, j, causal, scale * mul)
        for part in range(parts):
            hs = slice(j * g + part * per, j * g + (part + 1) * per)
            p = exp(sc[:, part * per:(part + 1) * per]
                    - lse[:, hs, :, None])
            dp = torch.einsum("bqgd,bkd->bgqk", do[:, :, hs], v[:, :, j])
            delta = (do[:, :, hs] * o[:, :, hs]).sum(-1)
            ds = p * (dp - delta.permute(0, 2, 1)[..., None])
            ws[0, part, :, :, j] = torch.einsum("bgqk,bqgd->bkd", p,
                                                do[:, :, hs])
            ws[1, part, :, :, j] = torch.einsum("bgqk,bqgd->bkd", ds,
                                                q[:, :, hs])
    dv, dk = ws[0, 0].clone(), ws[1, 0].clone()
    for part in range(1, parts):
        dv += ws[0, part]
        dk += ws[1, part]
    return dk * scale, dv


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("fam,causal", [("tri", True), ("streamed", False),
                                        ("streamed", True)])
def test_split_sum_matches_jax_at_head_dim_256(fam, causal, parts):
    # The plain counterpart of the width-256 dk/dv's split (each part's
    # fp32 partials summed in part order) from the family's own lse
    # (triangular base 2, streamed natural) against JAX's triangular or
    # streamed backward, G = 4 over two KV heads.
    q, k, v, do = _arrays(7 if fam == "tri" else 8, h=8, kvh=2, d=256)
    scale = q.shape[-1] ** -0.5
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    blocks = dict(scale=scale, block_q=128, block_k=64)
    if fam == "tri":
        o_j, lse_pad = fa_jax._flash_fwd_tri(qj, kj, vj, keep_lse_pad=True,
                                             **blocks)
        _, dk_j, dv_j = fa_jax._flash_bwd_tri((qj, kj, vj, o_j, lse_pad),
                                              doj, **blocks)
    else:
        o_j, lse_pad = fa_jax._flash_fwd_streamed(
            qj, kj, vj, causal=causal, keep_lse_pad=True, **blocks)
        _, dk_j, dv_j = fa_jax._flash_bwd_streamed(
            (qj, kj, vj, o_j, lse_pad), doj, causal=causal, **blocks)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    if fam == "tri":
        o_t, lse_t = fa_torch.flash_fwd_tri_plain(qt, kt, vt, scale)
    else:
        o_t, lse_t = fa_torch.flash_fwd_streamed_plain(qt, kt, vt, causal,
                                                       scale)
    dk, dv = _split_sum_plain(qt, kt, vt, o_t, lse_t, dot, causal, scale,
                              "2" if fam == "tri" else "e", parts)
    for name, a, b in (("dk", dk, dk_j), ("dv", dv, dv_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


_CSRC = pathlib.Path(fa_torch.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("header,name,value", [
    ("flash_fwd_sm90.cuh", "kBM", fa_torch.FWD_TILE),
    ("flash_bwd_sm90.cuh", "kBwdRows", fa_torch.BWD_TILE),
    ("flash_bwd_sm90.cuh", "kBwdTile", fa_torch.BWD_INNER),
    ("flash_bwd_sm90.cuh", "kWideRows", fa_torch.WIDE_KV_TILE),
    ("flash_bwd_sm90.cuh", "kMaxParts", fa_torch.MAX_PARTS),
])
def test_work_list_tiles_match_the_kernels(header, name, value):
    # The wrappers build each Hopper kernel's work list at its tiles: one
    # item per CTA, each CTA's loop bound from the same tiles. A constant
    # changed on one side only would leave tiles unwalked.
    text = (_CSRC / header).read_text()
    got = re.search(rf"constexpr int {name} = (\d+);", text)
    assert got is not None and int(got.group(1)) == value
