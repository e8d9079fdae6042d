"""Ragged sequence tails and the Hopper forward's work list in the port's
flash attention (skypilot_tpu_torch.ops.flash_attention), against the
JAX package on the CPU.

The kernels take any S that is a multiple of 8: a sequence has
ceil(S / tile) tiles and the last one may be partial. What a CPU run can
hold of that: the shape rules (``kernel_shape_error``), the causal work
lists at ragged S and at the Hopper forward's 128-row q tile (their pair
counts from the JAX package's own enumerations), and the public op at
S = 200, where JAX runs its kernels with a block of 200 rows (in interpret
mode here) and the port runs each family's plain versions. Inputs come
from numpy with a seed. Tolerances are the JAX tests' own: 2e-3 for
outputs, 5e-3 for gradients (f32 on both sides; the gap is summation
order).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.pallas import flash_attention as fa_jax
from skypilot_tpu_torch.ops import flash_attention as fa_torch

OUT_TOL = 2e-3
GRAD_TOL = 5e-3
RAGGED_S = 200


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


def _arrays(seed, b=2, s=RAGGED_S, h=4, kvh=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]


def _ceil(a, b):
    return -(-a // b)


def _check_schedule(work, n_rows, nt, tiles):
    # Every (row, tile) once; costs longest first, summing to the
    # enumeration's pairs over all rows.
    assert sorted(map(tuple, work)) == [(r, t) for r in range(n_rows)
                                        for t in range(nt)]
    pairs = collections.Counter(tiles)
    cost = [pairs[t] for _, t in work]
    assert cost == sorted(cost, reverse=True)
    assert sum(cost) == n_rows * len(tiles)


@pytest.mark.parametrize("n_rows,s", [(1, 128), (3, 1024), (4, 2048),
                                      (2, 1000), (2, RAGGED_S)])
def test_forward_schedule_covers_128_row_tiles(n_rows, s):
    # The Hopper forwards' list: one item per (row, 128-row q tile), pair
    # counts from the JAX enumeration at that tile.
    tile = fa_torch.FWD_TILE
    work = fa_torch.tri_schedule("rows", n_rows, s, tile=tile,
                                 inner=tile).tolist()
    nt = _ceil(s, tile)
    qs, _ = fa_jax._tri_maps_row(nt, nt, tile, tile)
    _check_schedule(work, n_rows, nt, qs.tolist())


# _T: a small tile (64 rows), the lists' arithmetic at tiles other than
# the kernels'.
_T, _BT, _BI = 64, fa_torch.BWD_TILE, fa_torch.BWD_INNER


@pytest.mark.parametrize("s,kind,tile,inner", [
    pytest.param(s, kind, _T, _T if kind == "rows" else _T // 2,
                 id=f"{s}-{kind}")
    for s in (RAGGED_S, 1000) for kind in ("rows", "cols")
] + [pytest.param(s, kind, _BT, _BI, id=f"bwd-{s}-{kind}")
     for s in (RAGGED_S, 1000, 4136, 4160) for kind in ("rows", "cols")])
def test_ragged_schedules_count_partial_tiles(s, kind, tile, inner):
    # At S not a multiple of the tile the dq and dk/dv lists count the
    # partial last tile: ceil(S / tile) tiles, costs from the JAX
    # enumerations at those counts; 64-row tiles (against 32-row q tiles
    # for the columns), and the Hopper backward's 128-row tiles against
    # 64-row ones.
    n_rows = 3
    work = fa_torch.tri_schedule(kind, n_rows, s, tile=tile,
                                 inner=inner).tolist()
    nt = _ceil(s, tile)
    assert nt == s // tile + 1
    if kind == "rows":
        tiles, _ = fa_jax._tri_maps_row(nt, _ceil(s, inner), tile, inner)
    else:
        tiles, _, _ = fa_jax._tri_maps_col(_ceil(s, inner), nt, inner, tile,
                                           1)
    _check_schedule(work, n_rows, nt, tiles.tolist())


@pytest.mark.parametrize("s", [RAGGED_S, 4136, 8, 2048])
def test_kernel_shape_error_takes_ragged_s(s):
    assert fa_torch.kernel_shape_error((1, s, 12, 128), (1, s, 2, 128)) is None
    assert fa_torch.kernel_shape_error((2, s, 8, 64), (2, s, 8, 64)) is None


@pytest.mark.parametrize("d", [256, 96])
def test_kernel_shape_error_names_missing_head_dim(d):
    err = fa_torch.kernel_shape_error((1, 512, 8, d), (1, 512, 1, d))
    assert err is not None and f"head_dim {d}" in err


@pytest.mark.parametrize("q_shape,k_shape,words", [
    ((1, 100, 8, 128), (1, 100, 2, 128), "multiple of 8"),
    ((1, 200, 6, 128), (1, 200, 4, 128), "H % KVH"),
    ((1, 200, 8, 128), (1, 208, 2, 128), "do not match"),
])
def test_kernel_shape_error_refuses(q_shape, k_shape, words):
    err = fa_torch.kernel_shape_error(q_shape, k_shape)
    assert err is not None and words in err


def _spy_plain(monkeypatch):
    calls = collections.Counter()
    for name in ("flash_fwd_plain", "flash_bwd_plain", "flash_fwd_tri_plain",
                 "flash_bwd_tri_plain", "flash_fwd_streamed_plain",
                 "flash_bwd_streamed_plain"):
        fn = getattr(fa_torch, name)

        def wrapped(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(fa_torch, name, wrapped)
    return calls


def _op_matches_jax(q, k, v, causal):
    assert fa_torch.takes_kernel_path(q.shape, k.shape)

    def loss_jax(q, k, v):
        out = fa_jax.flash_attention(q, k, v, causal=causal)
        return jnp.sum(out ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss_jax, argnums=(0, 1, 2),
                                         has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out_t = fa_torch.flash_attention(qt, kt, vt, causal=causal)
    g_t = torch.autograd.grad((out_t ** 2).sum(), (qt, kt, vt))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_op_matches_jax_resident(monkeypatch, causal):
    # S = 200 within the budget: the resident family on both sides.
    q, k, v = _arrays(1 if causal else 2)
    assert fa_torch.family(RAGGED_S, 64, causal) == fa_torch.RESIDENT
    calls = _spy_plain(monkeypatch)
    _op_matches_jax(q, k, v, causal)
    assert calls == {"flash_fwd_plain": 1, "flash_bwd_plain": 1}


@pytest.mark.parametrize("causal,fam", [(True, "tri"), (False, "streamed")])
def test_ragged_op_matches_jax_past_budget(monkeypatch, past_budget, causal,
                                           fam):
    # S = 200 past the (patched) budget: JAX's triangular or streamed
    # kernels at block 200; the port's plain versions of the same family.
    q, k, v = _arrays(3 if causal else 4, h=6)
    calls = _spy_plain(monkeypatch)
    _op_matches_jax(q, k, v, causal)
    assert calls == {f"flash_fwd_{fam}_plain": 1, f"flash_bwd_{fam}_plain": 1}
