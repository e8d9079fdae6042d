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


@pytest.mark.parametrize("block_q,block_k", BLOCKS)
def test_tri_forward_matches_jax(block_q, block_k):
    q, k, v, _ = _arrays(0)
    scale = q.shape[-1] ** -0.5
    o_j, lse_j = fa_jax._flash_fwd_tri(*map(jnp.asarray, (q, k, v)),
                                       scale=scale, block_q=block_q,
                                       block_k=block_k)
    o_t, lse_t = fa_torch.flash_fwd_tri_plain(
        *map(torch.from_numpy, (q, k, v)), scale)
    assert lse_t.shape == lse_j.shape == (1, 4, 256)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=OUT_TOL,
                               atol=OUT_TOL)


@pytest.mark.parametrize("block_q,block_k", BLOCKS)
def test_tri_backward_matches_jax(block_q, block_k):
    q, k, v, do = _arrays(1, b=2, h=6)
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
] + [pytest.param(2, s, _BT, _BI, id=f"bwd-2-{s}") for s in BWD_S])
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


_CSRC = pathlib.Path(fa_torch.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("header,name,value", [
    ("flash_fwd_sm90.cuh", "kBM", fa_torch.FWD_TILE),
    ("flash_bwd_sm90.cuh", "kBwdRows", fa_torch.BWD_TILE),
    ("flash_bwd_sm90.cuh", "kBwdTile", fa_torch.BWD_INNER),
])
def test_work_list_tiles_match_the_kernels(header, name, value):
    # The wrappers build each Hopper kernel's work list at its tiles: one
    # item per CTA, each CTA's loop bound from the same tiles. A constant
    # changed on one side only would leave tiles unwalked.
    text = (_CSRC / header).read_text()
    got = re.search(rf"constexpr int {name} = (\d+);", text)
    assert got is not None and int(got.group(1)) == value
