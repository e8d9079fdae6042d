"""The port's flash attention past head_dim 256 (skypilot_tpu_torch.ops.
flash_attention at kernel width 512) against the JAX package, on the CPU.

JAX's kernels take any head_dim that is a multiple of 8; the port's take
64, 128, 256 and 512, and the op zero-pads the caller's head_dim to the
next (264-512 to 512). Here:

* JAX's three families' forwards and backwards, called directly in
  interpret mode with 64-row blocks at head_dim 512, 320 and 264, against
  the port's plain versions (what a CPU tensor gets; on the card the
  width-512 kernels hold to them in chip_smoke.py's [kernels d512]);
* the op through autograd against JAX's flash_attention at head_dim 512,
  in every family (the triangular and streamed past the budget, patched
  on both sides), and at 320 through the op's own pad and slice;
* the width rule, and the width-512 work lists (dq_schedule's 64-row q
  tiles, dkv_wide_schedule's items in dkv_parts' parts at width 512)
  walked with the kernels' loop bounds against JAX's enumeration;
* the width-512 dk/dv's cluster walk (each chunk's partials of S^T and
  dP^T summed chunk 0 + chunk 1, P^T and dS^T rounded to bf16, each
  chunk's dk and dv, the GQA parts summed in order) against JAX's
  backward kernels; the forward's and dq's cluster walks likewise (the
  chunks' partials of S, and of dP and delta, as each rank sums them, P
  and dS rounded, each chunk's o or each half-chunk's dq) against JAX's
  forward and backward kernels, with the ranks' S, dP and delta
  bit-equal; the forward's and dq's cluster walks likewise (the
  chunks' partials of S, and of dP and delta, summed in rank order, P
  and dS rounded, each chunk's o or each half-chunk's dq) against JAX's
  forward and backward kernels, with the ranks' S, dP and delta
  bit-equal;
* each wrapper, on bf16 or f16 CPU tensors that claim to be on the card,
  launching its width-512 instance on padded tensors with the list,
  workspace and tickets of that width;
* a tiny Gemma at head_dim 512 through make_train_step, two steps, port
  against JAX.

Inputs come from numpy with a seed. Tolerances are the JAX flash tests'
own: 2e-3 for outputs and lse, 5e-3 for gradients (f32 on both sides; the
gap is summation order).
"""
import collections
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import gemma as gemma_jax
from skypilot_tpu.ops.pallas import flash_attention as fa_jax
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import trainer as trainer_jax
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import gemma as gemma_torch
from skypilot_tpu_torch.ops import flash_attention as fa_torch
from skypilot_tpu_torch.train import trainer as trainer_torch

OUT_TOL = 2e-3
GRAD_TOL = 5e-3
# Gradients from P and dS rounded to bf16 (2^-9 relative) before their
# products, as the bf16 kernels round them, against JAX's fp32 ones: the
# bf16 kernels' bound against their plain versions (chip_smoke.py
# GRAD_REL_TOL).
BF16_GRAD_TOL = 2e-2
# The forward's o with P rounded to bf16 before P V, as the bf16 kernels
# round it: their bound against the plain forward (chip_smoke.py
# OUT_REL_TOL).
BF16_OUT_TOL = 1e-2
BLOCK = 64


@pytest.fixture
def past_budget(monkeypatch):
    """Both packages past the resident budget; JAX's traces of its flash
    op are cleared on entry and exit (they are keyed on the function, not
    on the patched budget)."""
    jax.clear_caches()
    monkeypatch.setattr(fa_jax, "_use_resident", lambda s, d: False)
    monkeypatch.setattr(fa_torch, "_use_resident", lambda s, d: False)
    yield
    jax.clear_caches()


def _arrays(seed, b=1, s=128, h=4, kvh=1, d=512):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                          (b, s, h, d))]


# (family, causal, S, H, KVH): each family in its own mode, at S 128-256
# (64-row blocks), MQA and GQA.
FAMILIES = {
    "resident": (True, 128, 4, 1),
    "triangular": (True, 256, 4, 2),
    "streamed": (False, 192, 4, 1),
}


def _jax_family(fam, causal, scale, block=BLOCK):
    """(forward, backward) of JAX family `fam`, called directly with
    `block`-row blocks."""
    kw = dict(scale=scale, block_q=block, block_k=block)
    if fam == "triangular":
        return (lambda q, k, v, **x: fa_jax._flash_fwd_tri(q, k, v, **kw, **x),
                lambda res, do: fa_jax._flash_bwd_tri(res, do, **kw))
    fwd, bwd = {"resident": (fa_jax._flash_fwd_resident,
                             fa_jax._flash_bwd_resident),
                "streamed": (fa_jax._flash_fwd_streamed,
                             fa_jax._flash_bwd_streamed)}[fam]
    return (lambda q, k, v, **x: fwd(q, k, v, causal=causal, **kw, **x),
            lambda res, do: bwd(res, do, causal=causal, **kw))


def _torch_family(fam, causal, scale):
    """(forward, backward) plain versions of the port's family `fam`."""
    if fam == "triangular":
        return (lambda q, k, v: fa_torch.flash_fwd_tri_plain(q, k, v, scale),
                lambda q, k, v, o, lse, do: fa_torch.flash_bwd_tri_plain(
                    q, k, v, o, lse, do, scale))
    fwd, bwd = {"resident": (fa_torch.flash_fwd_plain,
                             fa_torch.flash_bwd_plain),
                "streamed": (fa_torch.flash_fwd_streamed_plain,
                             fa_torch.flash_bwd_streamed_plain)}[fam]
    return (lambda q, k, v: fwd(q, k, v, causal, scale),
            lambda q, k, v, o, lse, do: bwd(q, k, v, o, lse, do, causal,
                                            scale))


@pytest.mark.parametrize("d", [512, 320, 264])
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_forward_matches_jax_past_256(fam, d):
    causal, s, h, kvh = FAMILIES[fam]
    q, k, v, _ = _arrays(d + s, s=s, h=h, kvh=kvh, d=d)
    scale = d ** -0.5
    fwd_j, _ = _jax_family(fam, causal, scale)
    fwd_t, _ = _torch_family(fam, causal, scale)
    o_j, lse_j = fwd_j(*map(jnp.asarray, (q, k, v)))
    o_t, lse_t = fwd_t(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=OUT_TOL,
                               atol=OUT_TOL)
    assert lse_t.shape == lse_j.shape == (1, h, s)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("d", [512, 320, 264])
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_backward_matches_jax_past_256(fam, d):
    causal, s, h, kvh = FAMILIES[fam]
    q, k, v, do = _arrays(2 * d + s, s=s, h=h, kvh=kvh, d=d)
    scale = d ** -0.5
    fwd_j, bwd_j = _jax_family(fam, causal, scale)
    _, bwd_t = _torch_family(fam, causal, scale)
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    o_j, lse_pad = fwd_j(qj, kj, vj, keep_lse_pad=True)
    ref = bwd_j((qj, kj, vj, o_j, lse_pad), doj)
    _, lse_j = fwd_j(qj, kj, vj)
    # The port's backward from JAX's own saved forward (o, lse).
    got = bwd_t(*map(torch.from_numpy, (q, k, v, np.array(o_j),
                                        np.array(lse_j), do)))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def _op_against_jax(q, k, v, causal):
    def loss(q, k, v):
        out = fa_jax.flash_attention(q, k, v, causal=causal, block_q=BLOCK,
                                     block_k=BLOCK)
        return jnp.sum(out ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out_t = fa_torch.flash_attention(*leaves, causal=causal)
    g_t = torch.autograd.grad((out_t ** 2).sum(), leaves)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_op_matches_jax_at_512_resident(causal):
    # S 128 at 512: 3 * 128 * 512 * 4 bytes is within the budget on both
    # sides, the resident family.
    q, k, v, _ = _arrays(11 + causal, s=128, h=4, kvh=2)
    assert fa_torch.family(128, 512, causal) == fa_torch.RESIDENT
    _op_against_jax(q, k, v, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_op_matches_jax_at_512_past_budget(past_budget, causal):
    # Past the budget: the triangular family causal, the streamed one not.
    q, k, v, _ = _arrays(13 + causal, s=128, h=4, kvh=1)
    assert fa_torch.family(128, 512, causal) == (
        fa_torch.TRIANGULAR if causal else fa_torch.STREAMED)
    _op_against_jax(q, k, v, causal)


def test_op_pad_rule_matches_jax_at_320():
    # On the card the op zero-pads 320 to 512 and slices back; the same
    # arithmetic on the CPU (the plain versions at width 512 with the
    # caller's scale) against JAX's flash_attention at 320, the padded
    # columns exactly 0.
    q, k, v, _ = _arrays(15, s=128, h=4, kvh=2, d=320)
    width, scale = fa_torch.kernel_head_dim(320), 320 ** -0.5
    assert width == 512
    qp, kp, vp = (fa_torch.pad_head_dim(torch.from_numpy(t), width)
                  for t in (q, k, v))
    o_pad, lse = fa_torch.flash_fwd_plain(qp, kp, vp, True, scale)
    grads_pad = fa_torch.flash_bwd_plain(qp, kp, vp, o_pad, lse, 2 * o_pad,
                                         True, scale)
    out_j = fa_jax.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                   block_q=BLOCK, block_k=BLOCK)
    g_j = jax.grad(lambda *a: jnp.sum(fa_jax.flash_attention(
        *a, causal=True, block_q=BLOCK, block_k=BLOCK) ** 2),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(fa_torch.unpad_head_dim(o_pad, 320).numpy(),
                               np.asarray(out_j), rtol=OUT_TOL, atol=OUT_TOL)
    for a, b in zip(grads_pad, g_j):
        np.testing.assert_allclose(fa_torch.unpad_head_dim(a, 320).numpy(),
                                   np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    for t in (o_pad, *grads_pad):
        assert torch.count_nonzero(t[..., 320:]) == 0


# --------------------------------------------------------- the width rule

def test_every_multiple_of_8_up_to_512_reaches_a_kernel_width():
    # JAX's kernels take every d % 8 == 0; the port pads each to the least
    # kernel width at or above it (up to 512 an instance of its own, past
    # it the cluster widths, every multiple of 256 up to 2048), and only
    # past 2048 refuses.
    for d in range(8, 2049, 8):
        width = fa_torch.kernel_head_dim(d)
        # The least width that holds d: the next narrower one does not.
        assert width in fa_torch.KERNEL_WIDTHS and d <= width
        narrower = [w for w in fa_torch.KERNEL_WIDTHS if w < width]
        assert not narrower or narrower[-1] < d
        assert fa_torch.kernel_shape_error((1, 64, 4, width),
                                           (1, 64, 2, width)) is None
    assert fa_torch.HEAD_DIMS[-1] == 512
    assert fa_torch.KERNEL_WIDTHS[-1] == 2048
    for d in (2056, 2304, 4096):
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            fa_torch.kernel_head_dim(d)
        assert fa_torch.kernel_shape_error((1, 64, 4, d),
                                           (1, 64, 2, d)) is not None


# --------------------------------------------------- width-512 work lists

def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [8192, 4136, 1024, 200, 136])
def test_fwd_list_at_512_covers_every_pair_once(s, causal):
    # fwd_cta_512 walks the forward's (row, 128-row q tile) items, two
    # CTAs each, against CHUNKED_INNER (64)-row K/V tiles to n_kt = min(n_all,
    # 2 (qt + 1)); consumer cw's 64 rows stop at tile 2 qt + cw when
    # causal. Every 64 x 64 tile pair that JAX's enumeration needs for
    # rows before S, exactly once (a consumer whose rows all lie past S
    # computes and stores nothing that counts); the CTAs' loops longest
    # first.
    n_rows, tile, kv = 3, fa_torch.FWD_TILE, fa_torch.CHUNKED_INNER
    work = fa_torch.tri_schedule("rows", n_rows, s, tile=tile,
                                 inner=tile).tolist()
    nt, nk, nq = _ceil(s, tile), _ceil(s, kv), _ceil(s, kv)
    assert sorted(map(tuple, work)) == [(r, t) for r in range(n_rows)
                                        for t in range(nt)]
    got, steps = [], []
    for row, qt in work:
        n_kt = min(nk, (qt + 1) * (tile // kv)) if causal else nk
        steps.append(n_kt)
        for cw in range(tile // kv):
            qb = qt * (tile // kv) + cw
            j_last = min(qb, n_kt - 1) if causal else n_kt - 1
            if qb < nq:
                got += [(row, qb, j) for j in range(j_last + 1)]
    if causal:
        qs, ks = fa_jax._tri_maps_row(nq, nk, kv, kv)
        want = [(r, qi, ki) for r in range(n_rows)
                for qi, ki in zip(qs.tolist(), ks.tolist())]
    else:
        want = [(r, qi, ki) for r in range(n_rows) for qi in range(nq)
                for ki in range(nk)]
    assert len(got) == len(set(got)) and sorted(got) == sorted(want)
    assert steps == sorted(steps, reverse=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [8192, 4136, 1024, 200])
def test_dq_list_at_512_covers_every_pair_once(s, causal):
    # dq_cta_512 walks dq_schedule's (row, 64-row q tile) items, two CTAs
    # each, against 64-row K/V tiles up to its causal bound (n_kt =
    # min(n_all, qt + 1)): every tile pair the JAX enumeration needs,
    # exactly once.
    n_rows, tile, inner = 3, fa_torch.CHUNKED_DQ_TILE, fa_torch.CHUNKED_INNER
    work = fa_torch.dq_schedule(n_rows, s, 512).tolist()
    nt, ni = _ceil(s, tile), _ceil(s, inner)
    assert sorted(map(tuple, work)) == [(r, t) for r in range(n_rows)
                                        for t in range(nt)]
    got = []
    for row, qt in work:
        n_kt = min(ni, (qt + 1) * (tile // inner)) if causal else ni
        got += [(row, qt, j) for j in range(n_kt)]
    assert tile == inner == 64  # dq_cta_512's 64-row q and K/V tiles
    if causal:
        tiles, inner_idx = fa_jax._tri_maps_row(nt, ni, tile, inner)
        want = [(r, t, i) for r in range(n_rows)
                for t, i in zip(tiles.tolist(), inner_idx.tolist())]
    else:
        want = [(r, t, i) for r in range(n_rows) for t in range(nt)
                for i in range(ni)]
    assert len(got) == len(set(got)) and sorted(got) == sorted(want)
    steps = [min(ni, (qt + 1) * (tile // inner)) for _, qt in work]
    assert steps == sorted(steps, reverse=True)
    # Below 512 the 128-row tiles of bwd_schedule.
    assert torch.equal(fa_torch.dq_schedule(n_rows, s, 256),
                       fa_torch.bwd_schedule("rows", n_rows, s))


@pytest.mark.parametrize("shape,causal", [
    ((1, 8192, 8, 1), True), ((1, 4096, 8, 1), False), ((8, 1024, 8, 1), True),
    ((1, 4160, 12, 2), True), ((1, 4136, 16, 16), False), ((1, 512, 8, 1),
                                                            True)])
def test_dkv_parts_and_list_at_512(shape, causal):
    # dkv_cta_512 walks dkv_wide_schedule's (row, 64-row kv tile, part)
    # items, out_chunks (2) CTAs an item, at P = dkv_parts(..., 512): a
    # divisor of the group up to MAX_PARTS, the least modelled cost; every
    # (row, kv tile, part) once, and each kv tile's parts cover the group's
    # heads once between them, from q tile 2 kt (causal: the diagonal's
    # 32-row tiles) on.
    b, s, h, kvh = shape
    groups = h // kvh
    parts = fa_torch.dkv_parts(b, s, kvh, groups, causal, 132, 512)
    assert groups % parts == 0 and 1 <= parts <= fa_torch.MAX_PARTS
    cost = {p: sum(fa_torch.dkv_parts_cost(b, s, kvh, groups, causal, 132,
                                           p, 512))
            for p in range(1, min(groups, fa_torch.MAX_PARTS) + 1)
            if groups % p == 0}
    assert cost[parts] == min(cost.values())
    assert fa_torch.chunks(512) == 2 and fa_torch.chunks(256) == 1
    work = fa_torch.dkv_wide_schedule(b * kvh, s, parts).tolist()
    nt = _ceil(s, fa_torch.WIDE_KV_TILE)
    assert sorted(map(tuple, work)) == [
        (r, t, p) for r in range(b * kvh) for t in range(nt)
        for p in range(parts)]
    heads = groups // parts
    covered = sorted(kv * groups + p * heads + i for kv in range(kvh)
                     for p in range(parts) for i in range(heads))
    assert covered == list(range(h))
    # A width-512 step costs WIDE_STEP_512 width-256 ones: at P = 1 the
    # model's makespan at 512 is at least the width-256 one's.
    assert (fa_torch.dkv_parts_cost(b, s, kvh, groups, causal, 132, 1, 512)[0]
            >= fa_torch.dkv_parts_cost(b, s, kvh, groups, causal, 132, 1)[0])


def _cluster_walk_512(q, k, v, o, lse, do, causal, scale, base, parts,
                      rounded=True):
    """What the width-512 dk/dv's clusters compute, item by item, on CPU
    tensors: for each (b * KVH + kvh, 64-row kv tile, part) item of
    dkv_wide_schedule's list, over the heads of its part of the group and
    the q rows of its BWD_INNER-row q tiles from its causal start,
    chunk c's partials S^T_c = K_c Q_c^T and dP^T_c = V_c dO_c^T over its
    CHUNK columns, summed chunk 0 + chunk 1; P^T = exp(S^T scale - lse) in
    the family's base (``base``), masked where q < k when causal, and
    dS^T = P^T (dP^T - delta), both rounded to bf16 as the kernel rounds
    them before its products (kept fp32 when not ``rounded``); chunk c's
    dv += P^T dO_c and dk += dS^T Q_c into the part's fp32 partials,
    summed in part order, dk times scale. (The kernel adds the q tiles
    one by one; here each item's tiles are one product.)"""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    heads = groups // parts
    exp, _, mul = fa_torch._BASES[base]
    kv_tile, q_tile = fa_torch.WIDE_KV_TILE, fa_torch.BWD_INNER
    chunks = [slice(c * fa_torch.CHUNK, (c + 1) * fa_torch.CHUNK)
              for c in range(fa_torch.chunks(d))]
    delta = (do * o).sum(-1)  # (b, s, h)
    ws = torch.zeros((2, parts, b, s, kvh, d))

    def bf16(x):
        return x.to(torch.bfloat16).float() if rounded else x

    for row, kt, part in fa_torch.dkv_wide_schedule(b * kvh, s,
                                                    parts).tolist():
        bb, j = divmod(row, kvh)
        ki = torch.arange(kt * kv_tile, min(s, kt * kv_tile + kv_tile))
        qi = torch.arange((kt * kv_tile // q_tile) * q_tile if causal else 0,
                          s)
        hs = slice(j * groups + part * heads, j * groups + (part + 1) * heads)
        qq, dd = q[bb][qi][:, hs], do[bb][qi][:, hs]     # (q, heads, d)
        st = dpt = 0
        for cols in chunks:
            st = st + torch.einsum("kd,qhd->hkq", k[bb, ki, j, cols],
                                   qq[..., cols])
            dpt = dpt + torch.einsum("kd,qhd->hkq", v[bb, ki, j, cols],
                                     dd[..., cols])
        pt = exp(st * scale * mul - lse[bb, hs][:, qi][:, None, :])
        if causal:
            pt = pt.masked_fill(ki[:, None] > qi[None], 0.0)
        dst = bf16(pt * (dpt - delta[bb][qi][:, hs].T[:, None, :]))
        pt = bf16(pt)
        for cols in chunks:
            ws[0, part, bb, ki, j, cols] += torch.einsum(
                "hkq,qhd->kd", pt, dd[..., cols])
            ws[1, part, bb, ki, j, cols] += torch.einsum(
                "hkq,qhd->kd", dst, qq[..., cols])
    dv, dk = ws[0, 0].clone(), ws[1, 0].clone()
    for part in range(1, parts):
        dv += ws[0, part]
        dk += ws[1, part]
    return dk * scale, dv


@pytest.mark.parametrize("h,kvh,parts", [(4, 4, 1), (6, 2, 3), (4, 1, 2)])
@pytest.mark.parametrize("fam,causal", [("triangular", True),
                                        ("resident", True),
                                        ("resident", False),
                                        ("streamed", False)])
def test_cluster_walk_matches_jax_at_512(fam, causal, h, kvh, parts):
    # The width-512 dk/dv's cluster walk from the family's own forward
    # (triangular base 2, resident and streamed natural) against JAX's
    # backward of that family at head_dim 512: MHA, a group of 3 in 3
    # parts, and MQA in 2; S 192, three kv tiles. In fp32 it holds the
    # JAX tests' gradient bound; with P^T and dS^T rounded to bf16, as the
    # kernel runs it, the bf16 kernels' bound.
    s, d = 192, 512
    q, k, v, do = _arrays(h + 10 * parts, s=s, h=h, kvh=kvh, d=d)
    scale = d ** -0.5
    fwd_j, bwd_j = _jax_family(fam, causal, scale)
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    o_j, lse_pad = fwd_j(qj, kj, vj, keep_lse_pad=True)
    _, dk_j, dv_j = bwd_j((qj, kj, vj, o_j, lse_pad), doj)
    fwd_t, _ = _torch_family(fam, causal, scale)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o_t, lse_t = fwd_t(qt, kt, vt)
    base = "2" if fam == "triangular" else "e"
    # The walk's products are small: one thread each, so they do not wait
    # on a thread pool that other test processes share.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        walks = [(_cluster_walk_512(qt, kt, vt, o_t, lse_t, dot, causal,
                                    scale, base, parts, rounded), tol)
                 for rounded, tol in ((False, GRAD_TOL),
                                      (True, BF16_GRAD_TOL))]
    finally:
        torch.set_num_threads(threads)
    for rounded, ((dk, dv), tol) in zip((False, True), walks):
        for name, a, b in (("dk", dk, dk_j), ("dv", dv, dv_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                       atol=tol, err_msg=f"{name} {rounded}")


def _chunks(d):
    return [slice(c * fa_torch.CHUNK, (c + 1) * fa_torch.CHUNK)
            for c in range(fa_torch.chunks(d))]


def _rank_sums(parts):
    """What each rank of a cluster forms from the chunks' partials: rank c
    adds the other's partial to its own (csrc add_part: own + other)."""
    return [parts[c] + parts[1 - c] for c in range(len(parts))]


def _fwd_cluster_walk_512(q, k, v, causal, scale, natural, rounded=True):
    """What the width-512 forward's clusters compute, item by item, on CPU
    tensors: for each (b * H + h, FWD_TILE-row q tile) item of the
    forward's list and each consumer's 64 rows, over the CHUNKED_INNER-row
    K/V tiles to its causal end, chunk c's partial S_c = Q_c K_c^T over
    its CHUNK columns, S as each rank forms it (own + other); the online
    softmax in base 2 (scale * log2 e folded in, the running max and sum
    rescaled tile by tile), P rounded to bf16 as the kernel rounds it
    before P V (kept fp32 when not ``rounded``); o_c += P V_c for each
    chunk c; o = o / l and lse = m + log2(l), times ln 2 for the
    natural-log families (``natural``). Returns (o, lse, ranks): ranks
    holds every tile's S as rank 0 and rank 1 formed it."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    tile, kv = fa_torch.FWD_TILE, fa_torch.CHUNKED_INNER
    sm = scale * fa_torch.LOG2E
    o = torch.zeros((b, s, h, d))
    lse = torch.zeros((b, h, s))
    ranks = []
    n_all = _ceil(s, kv)

    def bf16(x):
        return x.to(torch.bfloat16).float() if rounded else x

    for row, qt in fa_torch.tri_schedule("rows", b * h, s, tile=tile,
                                         inner=tile).tolist():
        bb, hh = divmod(row, h)
        j_kv = hh // g
        n_kt = min(n_all, (qt + 1) * (tile // kv)) if causal else n_all
        for cw in range(tile // kv):
            r0 = qt * tile + cw * kv
            qi = torch.arange(r0, min(s, r0 + kv))
            if not len(qi):
                continue
            j_last = (min(qt * (tile // kv) + cw, n_kt - 1) if causal
                      else n_kt - 1)
            m = torch.full((len(qi),), fa_torch.NEG_INF)
            lsum = torch.zeros(len(qi))
            acc = torch.zeros((len(qi), d))
            for j in range(j_last + 1):
                ki = torch.arange(j * kv, min(s, j * kv + kv))
                sums = _rank_sums([q[bb, qi, hh, cols] @ k[bb, ki, j_kv, cols].T
                                   for cols in _chunks(d)])
                ranks.append(sums)
                x = sums[0] * sm
                if causal:
                    x = x.masked_fill(ki[None] > qi[:, None], -math.inf)
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp2(m - m_new)
                pr = torch.exp2(x - m_new[:, None])
                lsum = lsum * alpha + pr.sum(-1)
                acc *= alpha[:, None]
                for cols in _chunks(d):
                    acc[:, cols] += bf16(pr) @ v[bb, ki, j_kv, cols]
                m = m_new
            o[bb, qi, hh] = acc / lsum[:, None]
            x = m + torch.log2(lsum)
            lse[bb, hh, qi] = x * math.log(2) if natural else x
    return o, lse, ranks


def _dq_cluster_walk_512(q, k, v, o, lse, do, causal, scale, base,
                         rounded=True):
    """What the width-512 dq's clusters compute, item by item, on CPU
    tensors: for each (b * H + h, CHUNKED_DQ_TILE-row q tile) item of
    dq_schedule's list, delta = part 0 + part 1 of the chunks' partials
    rowsum(dO_c * O_c); over the CHUNKED_INNER-row K/V tiles to the causal
    end, the chunks' partials of S = Q K^T and dP = dO V^T as each rank
    forms them (own + other); P = exp(S scale - lse) in the family's base
    (``base``), masked where q < k when causal, dS = P (dP - delta),
    rounded to bf16 as the kernel rounds it before dS K (kept fp32 when
    not ``rounded``); each half of each chunk's dq += dS K_half; dq times
    scale. Returns (dq, delta, ranks): ranks holds each item's delta and
    every tile's (S, dP) as rank 0 and rank 1 formed them."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    exp, _, mul = fa_torch._BASES[base]
    tile, kv = fa_torch.CHUNKED_DQ_TILE, fa_torch.CHUNKED_INNER
    dq = torch.zeros((b, s, h, d))
    delta = torch.zeros((b, h, s))
    ranks = []
    n_all = _ceil(s, kv)
    halves = [slice(x * fa_torch.CHUNK // 2, (x + 1) * fa_torch.CHUNK // 2)
              for x in range(2 * fa_torch.chunks(d))]
    for row, qt in fa_torch.dq_schedule(b * h, s, d).tolist():
        bb, hh = divmod(row, h)
        j_kv = hh // g
        qi = torch.arange(qt * tile, min(s, qt * tile + tile))
        parts = [(do[bb, qi, hh, cols] * o[bb, qi, hh, cols]).sum(-1)
                 for cols in _chunks(d)]
        dlt = [parts[0] + parts[1] for _ in parts]  # part 0 + part 1 in both
        ranks.append(("delta", dlt))
        delta[bb, hh, qi] = dlt[0]
        n_kt = min(n_all, qt + 1) if causal else n_all
        for j in range(n_kt):
            ki = torch.arange(j * kv, min(s, j * kv + kv))
            s_r = _rank_sums([q[bb, qi, hh, cols] @ k[bb, ki, j_kv, cols].T
                              for cols in _chunks(d)])
            dp_r = _rank_sums([do[bb, qi, hh, cols] @ v[bb, ki, j_kv, cols].T
                               for cols in _chunks(d)])
            ranks.append(("S", s_r))
            ranks.append(("dP", dp_r))
            pr = exp(s_r[0] * scale * mul - lse[bb, hh, qi][:, None])
            if causal:
                pr = pr.masked_fill(ki[None] > qi[:, None], 0.0)
            ds = pr * (dp_r[0] - dlt[0][:, None])
            if rounded:
                ds = ds.to(torch.bfloat16).float()
            for cols in halves:
                dq[bb, qi, hh, cols] += ds @ k[bb, ki, j_kv, cols]
    return dq * scale, delta, ranks


# (family, causal, S, H, KVH): each family in each causal mode it takes,
# MHA and a GQA group, a ragged S (200 against 64-row tiles).
WALKS_512 = [("triangular", True, 192, 4, 4), ("triangular", True, 200, 6, 2),
             ("resident", True, 200, 4, 4), ("resident", True, 128, 6, 2),
             ("resident", False, 128, 6, 2), ("resident", False, 200, 4, 4),
             ("streamed", False, 200, 6, 2), ("streamed", False, 192, 4, 4)]


def _jax_block(s):
    """JAX's block at S: BLOCK where it divides S, else S itself (JAX's
    kernels take only whole blocks; test_torch_flash_ragged.py)."""
    return BLOCK if s % BLOCK == 0 else s


def _one_thread(fn, *args):
    """fn(*args) with torch on one thread: the walks' products are small,
    and a thread pool that other test processes share only waits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("fam,causal,s,h,kvh", WALKS_512)
def test_fwd_cluster_walk_matches_jax_at_512(fam, causal, s, h, kvh):
    # The width-512 forward's cluster walk against JAX's forward of the
    # family (interpret mode, 64-row blocks) at head_dim 512: o in fp32 to
    # the JAX tests' bound, with P rounded to bf16 as the kernel runs it
    # to the bf16 kernels' bound; lse, in the family's base, to the JAX
    # tests' bound in both.
    d = 512
    q, k, v, _ = _arrays(s + h, s=s, h=h, kvh=kvh, d=d)
    scale = d ** -0.5
    fwd_j, _ = _jax_family(fam, causal, scale, _jax_block(s))
    o_j, lse_j = fwd_j(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    for rounded, tol in ((False, OUT_TOL), (True, BF16_OUT_TOL)):
        o, lse, _ = _one_thread(_fwd_cluster_walk_512, qt, kt, vt, causal,
                                scale, fam != "triangular", rounded)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=tol,
                                   atol=tol, err_msg=f"o {rounded}")
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                                   rtol=OUT_TOL, atol=OUT_TOL,
                                   err_msg=f"lse {rounded}")


@pytest.mark.parametrize("fam,causal,s,h,kvh", [
    w for w in WALKS_512 if w[0] != "resident"])
def test_dq_cluster_walk_matches_jax_at_512(fam, causal, s, h, kvh):
    # The width-512 dq's cluster walk (the triangular and streamed dq; the
    # resident one keeps a CTA an item) from JAX's own saved forward
    # against JAX's backward of the family at head_dim 512: dq in fp32 to
    # the JAX tests' bound, with dS rounded to bf16 to the bf16 kernels'
    # bound; delta against rowsum(dO * O) over all 512 columns.
    d = 512
    q, k, v, do = _arrays(2 * s + h, s=s, h=h, kvh=kvh, d=d)
    scale = d ** -0.5
    fwd_j, bwd_j = _jax_family(fam, causal, scale, _jax_block(s))
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    o_j, lse_pad = fwd_j(qj, kj, vj, keep_lse_pad=True)
    dq_j, _, _ = bwd_j((qj, kj, vj, o_j, lse_pad), doj)
    _, lse_j = fwd_j(qj, kj, vj)
    qt, kt, vt, ot, lset, dot = map(torch.from_numpy, (
        q, k, v, np.array(o_j), np.array(lse_j), do))
    base = "2" if fam == "triangular" else "e"
    for rounded, tol in ((False, GRAD_TOL), (True, BF16_GRAD_TOL)):
        dq, delta, _ = _one_thread(_dq_cluster_walk_512, qt, kt, vt, ot,
                                   lset, dot, causal, scale, base, rounded)
        np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), rtol=tol,
                                   atol=tol, err_msg=f"dq {rounded}")
    np.testing.assert_allclose(
        delta.numpy(), (dot * ot).sum(-1).permute(0, 2, 1).numpy(),
        rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_cluster_ranks_agree_bit_for_bit_at_512(causal):
    # Every S (forward and dq), dP and delta that the two ranks of a
    # width-512 cluster form from their chunks' partials is the same bit
    # for bit, so both take the same softmax and the same dS: o and dq
    # are deterministic. Ragged S, a GQA group.
    s, h, kvh, d = 200, 6, 2, 512
    q, k, v, do = map(torch.from_numpy,
                      _arrays(31 + causal, s=s, h=h, kvh=kvh, d=d))
    scale = d ** -0.5
    o, lse, fwd_ranks = _one_thread(_fwd_cluster_walk_512, q, k, v, causal,
                                    scale, True)
    _, _, dq_ranks = _one_thread(_dq_cluster_walk_512, q, k, v, o, lse, do,
                                 causal, scale, "e")
    kinds = collections.Counter(kind for kind, _ in dq_ranks)
    assert kinds["delta"] == _ceil(s, fa_torch.CHUNKED_DQ_TILE) * h
    assert kinds["S"] == kinds["dP"] > 0 and fwd_ranks
    for r0, r1 in fwd_ranks + [pair for _, pair in dq_ranks]:
        assert torch.equal(r0, r1)


# ----------------------------------------------------- the wrappers at 512

class _OnCard(torch.Tensor):
    is_cuda = True


def _spy_launches(monkeypatch):
    """Every launch on CPU tensors that claim to be on the card (every
    input check kept, 132 SMs): (name, source, pointers, head_dim,
    tail)."""
    launches = []
    check = fa_torch._check_inputs

    def on_card(*ts, **kw):
        check(*(t.as_subclass(_OnCard) for t in ts), **kw)

    monkeypatch.setattr(fa_torch, "_check_inputs", on_card)
    monkeypatch.setattr(fa_torch, "_sm_count", lambda device: 132)
    monkeypatch.setattr(fa_torch, "_launch", lambda name, source, ptrs,
                        strides, q, n_kv, *tail: launches.append(
                            (name, source, list(ptrs), q.shape[-1], tail)))
    return launches


_NAMES = {
    fa_torch.RESIDENT: ("flash_fwd", "flash_dq", "flash_dkv"),
    fa_torch.TRIANGULAR: ("flash_fwd_tri", "flash_dq_tri", "flash_dkv_tri"),
    fa_torch.STREAMED: ("flash_fwd_streamed", "flash_dq_streamed",
                        "flash_dkv_streamed"),
}


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("fam", [fa_torch.RESIDENT, fa_torch.TRIANGULAR,
                                 fa_torch.STREAMED])
def test_each_wrapper_launches_its_width_512_instance(monkeypatch, fam,
                                                      dtype, d):
    # flash_forward and flash_backward on "on-card" 16-bit tensors at a
    # head_dim that pads to 512: each of the family's three wrappers
    # launches once at width 512 (its instance of that width and dtype),
    # the forward over 128-row q tiles (2 CTAs each), dq over dq_schedule's
    # 64-row tiles, dk/dv over dkv_wide_schedule's list at dkv_parts' P at
    # 512, with P > 1 a (2, P, B, S, KVH, 512) fp32 workspace and two
    # zeroed tickets per kv tile and chunk; the outputs come back at d.
    launches = _spy_launches(monkeypatch)
    b, s, h, kvh, causal = 1, 512, 8, 1, fam != fa_torch.STREAMED
    rng = np.random.default_rng(21)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype).as_subclass(_OnCard)
        for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                      (b, s, h, d)))
    lse = torch.zeros(b, h, s)
    o, _ = fa_torch.flash_forward(q, k, v, causal, d ** -0.5, fam)
    grads = fa_torch.flash_backward(q, k, v, q, lse, do, causal, d ** -0.5,
                                    fam)
    assert o.shape[-1] == d and all(g.shape[-1] == d for g in grads)
    assert [(n, w) for n, _, _, w, _ in launches] == [
        (n, 512) for n in _NAMES[fam]]
    (_, _, fwd_ptrs, _, fwd_tail), (_, _, dq_ptrs, _, _), (
        _, _, dkv_ptrs, _, dkv_tail) = launches
    assert fwd_tail[0] == fa_torch._DTYPE_CODES[dtype]
    assert torch.equal(fwd_ptrs[-1], fa_torch.tri_schedule(
        "rows", b * h, s, tile=fa_torch.FWD_TILE, inner=fa_torch.FWD_TILE))
    assert torch.equal(dq_ptrs[-1], fa_torch.dq_schedule(b * h, s, 512))
    assert len(dq_ptrs[-1]) == b * h * s // fa_torch.CHUNKED_DQ_TILE
    parts = fa_torch.dkv_parts(b, s, kvh, h // kvh, causal, 132, 512)
    work, ws, tickets = dkv_ptrs[8:]
    assert dkv_tail[-1] == parts
    assert torch.equal(work, fa_torch.dkv_wide_schedule(b * kvh, s, parts))
    for t in fwd_ptrs[:3] + dq_ptrs[:5] + dkv_ptrs[:4]:
        if t.dim() == 4:
            assert t.shape[-1] == 512 and t.dtype == dtype
            assert torch.count_nonzero(t[..., d:]) == 0
    if parts == 1:
        assert ws is None and tickets is None
    else:
        assert ws.shape == (2, parts, b, s, kvh, 512)
        assert tickets.numel() == 2 * b * kvh * _ceil(
            s, fa_torch.WIDE_KV_TILE) * 2 and not tickets.any()


def test_f32_takes_the_fp32_kernels_at_512(monkeypatch):
    # f32 past 256 takes the fp32 kernels at width 512, whatever the
    # family, never a 16-bit instance.
    launches = _spy_launches(monkeypatch)
    q = torch.zeros(1, 64, 2, 392).as_subclass(_OnCard)
    lse = torch.zeros(1, 2, 64)
    for fam in (fa_torch.RESIDENT, fa_torch.TRIANGULAR, fa_torch.STREAMED):
        launches.clear()
        fa_torch.flash_forward(q, q, q, True, 0.05, fam)
        fa_torch.flash_backward(q, q, q, q, lse, q, True, 0.05, fam)
        assert [(n, w) for n, _, _, w, _ in launches] == [
            ("flash_fwd_f32", 512), ("flash_dq_f32", 512),
            ("flash_dkv_f32", 512)]


@pytest.mark.parametrize("wrapper,args", [
    ("flash_fwd", lambda q, lse: (q, q, q, True)),
    ("flash_dq_tri", lambda q, lse: (q, q, q, q, lse, q)),
    ("flash_dkv_streamed", lambda q, lse: (q, q, q, q, lse, lse, False))])
def test_wrappers_take_512_and_refuse_264(monkeypatch, wrapper, args):
    # Called directly, a wrapper takes only kernel widths: 512, 768 and
    # 1024 launch; 264 and 520 (which the op pads to 512 and 768) raise,
    # naming the head_dim, before any launch.
    launches = _spy_launches(monkeypatch)
    lse = torch.zeros(1, 2, 64)
    for width in (512, 768, 1024):
        getattr(fa_torch, wrapper)(*args(torch.zeros(
            1, 64, 2, width, dtype=torch.bfloat16), lse), 0.04)
    assert [(n, w) for n, _, _, w, _ in launches] == [
        (wrapper, 512), (wrapper, 768), (wrapper, 1024)]
    for d in (264, 520):
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            getattr(fa_torch, wrapper)(*args(torch.zeros(
                1, 64, 2, d, dtype=torch.bfloat16), lse), 0.04)
    assert len(launches) == 3


# ------------------------------------------- a Gemma at head_dim 512

def test_gemma_at_head_dim_512_steps_match_jax():
    # A tiny Gemma (2 layers, dim 128, 4 heads over 1 KV head) with
    # head_dim_ 512, two adamw steps through each package's
    # make_train_step from the same converted init and tokens, f32: JAX's
    # flash kernels in interpret mode, the port's op on the CPU (the plain
    # versions of the width it pads to). Loss and grad norm per step to
    # 2e-3, as test_torch_trainer.py holds the Llama step.
    fields = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                  n_kv_heads=1, head_dim_=512, mlp_dim=256)
    cfg_j = dataclasses.replace(gemma_jax.GemmaConfig.tiny(), **fields,
                                dtype=jnp.float32, attention_impl="pallas")
    cfg_t = dataclasses.replace(gemma_torch.GemmaConfig.tiny(), **fields,
                                dtype=torch.float32, attention_impl="kernel")
    tcfg = dict(warmup_steps=1, total_steps=10, learning_rate=1e-2)
    params_j = gemma_jax.init(cfg_j, jax.random.key(3))
    params_t = convert.gemma_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params_j), "cpu")
    tokens = np.random.default_rng(5).integers(0, 256, (2, 128),
                                               dtype=np.int32)
    mesh = mesh_lib.make_mesh({"dp": 1}, devices=[jax.devices()[0]])
    tx_j = trainer_jax.make_optimizer(trainer_jax.TrainConfig(**tcfg))
    state_j = trainer_jax.init_train_state(params_j, tx_j)
    step_j = trainer_jax.make_train_step(
        lambda p, t, constrain: gemma_jax.forward(cfg_j, p, t,
                                                  constrain=constrain),
        tx_j, mesh, mesh_lib.DEFAULT_RULES)
    tx_t = trainer_torch.make_optimizer(trainer_torch.TrainConfig(**tcfg))
    state_t = trainer_torch.init_train_state(params_t, tx_t)
    step_t = trainer_torch.make_train_step(
        lambda p, t: gemma_torch.forward(cfg_t, p, t), tx_t)
    batch_j = {"tokens": jnp.asarray(tokens)}
    batch_t = {"tokens": torch.from_numpy(tokens).long()}
    for i in range(2):
        state_j, m_j = step_j(state_j, batch_j)
        state_t, m_t = step_t(state_t, batch_t)
        np.testing.assert_allclose(m_t["loss"].item(), float(m_j["loss"]),
                                   rtol=OUT_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(m_t["grad_norm"].item(),
                                   float(m_j["grad_norm"]), rtol=OUT_TOL,
                                   err_msg=f"step {i}")
    assert state_t.step == int(state_j.step) == 2
