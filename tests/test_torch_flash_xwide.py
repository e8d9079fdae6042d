"""The port's flash attention past head_dim 512 (skypilot_tpu_torch.ops.
flash_attention at kernel widths 768 ... 2048) against the JAX package, on
the CPU.

JAX's kernels take any head_dim that is a multiple of 8; the port pads
each to the least kernel width at or above it: past 512 the next multiple
of 256 up to 2048, whose items run as clusters of n = width / 256 CTAs (3
... 8), every CTA one 256-column chunk of every operand, each reading the
n ranks' partials in rank order. Here:

* the width rule up to 2048 and the refusal past it;
* the work lists at widths 768, 1024 and 2048 (the forward's 128-row and
  dq's 64-row q tiles, dk/dv's (kv tile, part) items at dkv_parts' P of
  that width, the fp32 kernels' at their wide tiles), walked with the
  kernels' loop bounds against JAX's enumeration;
* the clusters' walks at n = 3, 4 and 8 (the forward's, dq's and dk/dv's:
  each rank's partials over its chunk, the sums every rank forms in rank
  order, P and dS rounded to bf16 as the kernels round them, each chunk's
  outputs) against JAX's kernels in interpret mode, and the ranks' sums
  bit-equal;
* JAX's families called directly at 1024 and 776 against the port's plain
  versions, and the op through autograd at 1024;
* each wrapper, on "on-card" tensors, launching its cluster instance at
  the width with the lists, workspace and tickets of n chunks; the fp32
  wrappers likewise; the C dispatch and the fp32 wide tiles read back from
  the sources;
* a tiny Gemma at head_dim 1024 through make_train_step, two steps, port
  against JAX.

Inputs come from numpy with a seed. Tolerances are the JAX flash tests'
own: 2e-3 for outputs and lse, 5e-3 for gradients (f32 on both sides; the
gap is summation order); with P and dS rounded to bf16 as the kernels
round them, the bf16 kernels' bounds against their plain versions (1e-2
outputs, 2e-2 gradients: chip_smoke.py OUT_REL_TOL, GRAD_REL_TOL).
"""
import dataclasses
import math
import pathlib
import re

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
BF16_OUT_TOL = 1e-2
BF16_GRAD_TOL = 2e-2
BLOCK = 64
_CSRC = pathlib.Path(fa_torch.__file__).resolve().parents[1] / "csrc"
# The cluster sizes the tests walk: the narrowest, a power of two, the
# widest (widths 768, 1024, 2048).
CLUSTERS = (3, 4, 8)


def _ceil(a, b):
    return -(-a // b)


def _arrays(seed, b=1, s=128, h=4, kvh=1, d=1024):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                          (b, s, h, d))]


def _one_thread(fn, *args):
    """fn(*args) with torch on one thread: the walks' products are small,
    and a thread pool that other test processes share only waits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


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


# --------------------------------------------------------- the width rule

@pytest.mark.parametrize("d", range(520, 2049, 8))
def test_every_head_dim_past_512_pads_to_its_cluster_width(d):
    # 520 ... 2048: the least multiple of 256 at or above d, a cluster of
    # width / 256 CTAs (3 ... 8), and no kernel width between d and it.
    width = fa_torch.kernel_head_dim(d)
    assert width in fa_torch.CLUSTER_WIDTHS and width == 256 * _ceil(d, 256)
    assert fa_torch.chunks(width) == width // 256 <= fa_torch.MAX_CLUSTER
    assert not [w for w in fa_torch.KERNEL_WIDTHS if d <= w < width]
    assert fa_torch.kernel_shape_error((1, 64, 4, width),
                                       (1, 64, 2, width)) is None
    err = fa_torch.kernel_shape_error((1, 64, 4, d), (1, 64, 2, d))
    assert (err is None) == (d == width)


@pytest.mark.parametrize("d", [2056, 2304, 4096])
def test_past_2048_is_refused_by_name(d):
    # Past 2048 a cluster would need more than the portable 8 CTAs: the
    # width rule raises, naming the head_dim and the limit, and no width
    # covers it.
    with pytest.raises(ValueError, match=f"head_dim {d}") as exc:
        fa_torch.kernel_head_dim(d)
    assert "8 CTAs" in str(exc.value)
    assert fa_torch.kernel_shape_error((1, 64, 4, d),
                                       (1, 64, 2, d)) is not None
    assert fa_torch.KERNEL_WIDTHS[-1] == fa_torch.CLUSTER_INSTANCE == 2048


# --------------------------------------------------------- the work lists

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [4136, 1024, 200])
@pytest.mark.parametrize("width", [768, 1024, 2048])
def test_fwd_and_dq_lists_cover_every_pair_once(width, s, causal):
    # The cluster forward walks the forward's (row, 128-row q tile) list,
    # n CTAs an item, consumer cw's 64 rows against 64-row K/V tiles to its
    # causal end; dq walks dq_schedule's (row, 64-row q tile) list at the
    # width, against 64-row K/V tiles to its causal bound. Both: every 64 x
    # 64 tile pair JAX's enumeration needs, exactly once, longest first.
    n_rows, tile, kv = 3, fa_torch.FWD_TILE, fa_torch.CHUNKED_INNER
    nk = _ceil(s, kv)
    if causal:
        qs, ks = fa_jax._tri_maps_row(nk, nk, kv, kv)
        want = sorted((r, qi, ki) for r in range(n_rows)
                      for qi, ki in zip(qs.tolist(), ks.tolist()))
    else:
        want = sorted((r, qi, ki) for r in range(n_rows) for qi in range(nk)
                      for ki in range(nk))
    work = fa_torch.tri_schedule("rows", n_rows, s, tile=tile,
                                 inner=tile).tolist()
    got, steps = [], []
    for row, qt in work:
        n_kt = min(nk, (qt + 1) * (tile // kv)) if causal else nk
        steps.append(n_kt)
        for cw in range(tile // kv):
            qb = qt * (tile // kv) + cw
            j_last = min(qb, n_kt - 1) if causal else n_kt - 1
            if qb < nk:
                got += [(row, qb, j) for j in range(j_last + 1)]
    assert len(got) == len(set(got)) and sorted(got) == want
    assert steps == sorted(steps, reverse=True)
    dq_work = fa_torch.dq_schedule(n_rows, s, width).tolist()
    assert dq_work == fa_torch.dq_schedule(n_rows, s, 512).tolist()
    got = [(row, qt, j) for row, qt in dq_work
           for j in range(min(nk, qt + 1) if causal else nk)]
    assert len(got) == len(set(got)) and sorted(got) == want
    assert fa_torch.chunks(width) == width // fa_torch.CHUNK


@pytest.mark.parametrize("shape,causal", [
    ((1, 8192, 8, 1), True), ((1, 4096, 8, 1), False),
    ((8, 512, 8, 1), True), ((1, 4160, 12, 2), True),
    ((1, 1000, 16, 16), False)])
@pytest.mark.parametrize("width", [768, 1024, 2048])
def test_dkv_parts_and_list_past_512(width, shape, causal):
    # dkv_cta_x walks dkv_wide_schedule's (row, 64-row kv tile, part)
    # items, n = width / 256 CTAs an item, at P = dkv_parts(..., width):
    # the least modelled cost among the group's divisors; every (row, kv
    # tile, part) once, each kv tile's parts covering the group's heads
    # once, and from the kv tile's diagonal q tile on every q tile once.
    b, s, h, kvh = shape
    groups = h // kvh
    parts = fa_torch.dkv_parts(b, s, kvh, groups, causal, 132, width)
    cost = {p: sum(fa_torch.dkv_parts_cost(b, s, kvh, groups, causal, 132,
                                           p, width))
            for p in range(1, min(groups, fa_torch.MAX_PARTS) + 1)
            if groups % p == 0}
    assert cost[parts] == min(cost.values())
    t = fa_torch.dkv_tiling(width)
    assert (t.ctas, t.tickets) == (width // 256, 2 * width // 256)
    work = fa_torch.dkv_wide_schedule(b * kvh, s, parts).tolist()
    nt, nq = _ceil(s, fa_torch.WIDE_KV_TILE), _ceil(s, fa_torch.BWD_INNER)
    assert sorted(map(tuple, work)) == [
        (r, kt, p) for r in range(b * kvh) for kt in range(nt)
        for p in range(parts)]
    heads = groups // parts
    got = [(r, p * heads + g, kt, qi) for r, kt, p in work
           for g in range(heads) for qi in range(kt if causal else 0, nq)]
    if causal:
        kvs, _, qs = fa_jax._tri_maps_col(nq, nt, fa_torch.BWD_INNER,
                                          fa_torch.WIDE_KV_TILE, 1)
        want = [(r, g, kt, qi) for r in range(b * kvh) for g in range(groups)
                for kt, qi in zip(kvs.tolist(), qs.tolist())]
    else:
        want = [(r, g, kt, qi) for r in range(b * kvh) for g in range(groups)
                for kt in range(nt) for qi in range(nq)]
    assert len(got) == len(set(got)) and sorted(got) == sorted(want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [200, 1000, 4136])
@pytest.mark.parametrize("width", [768, 1024, 2048])
def test_f32_lists_past_512_cover_every_pair_once(width, s, causal):
    # The fp32 kernels past 512 walk their (row, q tile) and (row, kv
    # tile, part) lists at the wide tiles, each item n CTAs (one per
    # output chunk, each the item's whole walk): every tile pair JAX's
    # enumeration needs once per chunk, and the dk/dv's tickets one per kv
    # tile and chunk.
    rows, inner = fa_torch.F32_FWD_TILES[width]
    assert (rows, inner) == fa_torch.F32_DQ_TILES[width] == \
        fa_torch.F32_DKV_TILES[width] == fa_torch.F32_WIDE_TILES
    n_rows = 2
    work = fa_torch.tri_schedule("rows", n_rows, s, tile=rows,
                                 inner=inner).tolist()
    nt, ni = _ceil(s, rows), _ceil(s, inner)
    got = [(row, qt, kt) for row, qt in work
           for kt in range(min(ni, (qt * rows + rows - 1) // inner + 1)
                           if causal else ni)]
    if causal:
        tiles, keys = fa_jax._tri_maps_row(nt, ni, rows, inner)
        want = [(r, t, k) for r in range(n_rows)
                for t, k in zip(tiles.tolist(), keys.tolist())]
    else:
        want = [(r, t, k) for r in range(n_rows) for t in range(nt)
                for k in range(ni)]
    assert len(got) == len(set(got)) and sorted(got) == sorted(want)
    t = fa_torch.dkv_tiling(width, f32=True)
    assert (t.kv_tile, t.q_tile) == (rows, inner)
    assert t.ctas == t.tickets == width // fa_torch.CHUNK


# ----------------------------------------------------- the cluster walks

def _chunks(n):
    return [slice(c * fa_torch.CHUNK, (c + 1) * fa_torch.CHUNK)
            for c in range(n)]


def _rank_sums(parts):
    """What each of the n ranks forms from the chunks' partials: every rank
    reads the n slots in rank order 0 .. n - 1 (csrc gather_parts), rank
    0's first."""
    out = []
    for _ in parts:
        x = parts[0]
        for p in parts[1:]:
            x = x + p
        out.append(x)
    return out


def _fwd_cluster_walk(q, k, v, causal, scale, natural, rounded=True):
    """What the forward's clusters past 512 compute, item by item, on CPU
    tensors: for each (b * H + h, FWD_TILE-row q tile) item and each
    consumer's 64 rows, over the CHUNKED_INNER-row K/V tiles to its causal
    end, chunk c's partial S_c = Q_c K_c^T over its CHUNK columns, S as
    every rank forms it (rank order); the online softmax in base 2, P
    rounded to bf16 as the kernel rounds it (fp32 when not ``rounded``);
    o_c += P V_c for each chunk; o / l and lse (natural when
    ``natural``). Returns (o, lse, ranks): every tile's S as each rank
    formed it."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    n = fa_torch.chunks(d)
    tile, kv = fa_torch.FWD_TILE, fa_torch.CHUNKED_INNER
    sm = scale * fa_torch.LOG2E
    o = torch.zeros((b, s, h, d))
    lse = torch.zeros((b, h, s))
    ranks = []
    n_all = _ceil(s, kv)
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
                sums = _rank_sums([q[bb, qi, hh, c] @ k[bb, ki, j_kv, c].T
                                   for c in _chunks(n)])
                ranks.append(sums)
                x = sums[0] * sm
                if causal:
                    x = x.masked_fill(ki[None] > qi[:, None], -math.inf)
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp2(m - m_new)
                pr = torch.exp2(x - m_new[:, None])
                lsum = lsum * alpha + pr.sum(-1)
                acc *= alpha[:, None]
                if rounded:
                    pr = pr.to(torch.bfloat16).float()
                for c in _chunks(n):
                    acc[:, c] += pr @ v[bb, ki, j_kv, c]
                m = m_new
            o[bb, qi, hh] = acc / lsum[:, None]
            x = m + torch.log2(lsum)
            lse[bb, hh, qi] = x * math.log(2) if natural else x
    return o, lse, ranks


def _dq_cluster_walk(q, k, v, o, lse, do, causal, scale, base,
                     rounded=True):
    """What dq's clusters past 512 compute, item by item: for each (b * H +
    h, CHUNKED_DQ_TILE-row q tile) item of dq_schedule's list, delta = the
    chunks' partials rowsum(dO_c * O_c) in rank order; over the K/V tiles
    to the causal end, the chunks' partials of S and dP as every rank
    forms them; P in the family's base, masked, dS = P (dP - delta)
    rounded to bf16 (fp32 when not ``rounded``); each half of each chunk's
    dq += dS K_half; dq times scale. Returns (dq, delta, ranks)."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    n = fa_torch.chunks(d)
    exp, _, mul = fa_torch._BASES[base]
    tile, kv = fa_torch.CHUNKED_DQ_TILE, fa_torch.CHUNKED_INNER
    dq = torch.zeros((b, s, h, d))
    delta = torch.zeros((b, h, s))
    ranks = []
    n_all = _ceil(s, kv)
    halves = [slice(x * fa_torch.CHUNK // 2, (x + 1) * fa_torch.CHUNK // 2)
              for x in range(2 * n)]
    for row, qt in fa_torch.dq_schedule(b * h, s, d).tolist():
        bb, hh = divmod(row, h)
        j_kv = hh // g
        qi = torch.arange(qt * tile, min(s, qt * tile + tile))
        dlt = _rank_sums([(do[bb, qi, hh, c] * o[bb, qi, hh, c]).sum(-1)
                          for c in _chunks(n)])
        ranks.append(dlt)
        delta[bb, hh, qi] = dlt[0]
        n_kt = min(n_all, qt + 1) if causal else n_all
        for j in range(n_kt):
            ki = torch.arange(j * kv, min(s, j * kv + kv))
            s_r = _rank_sums([q[bb, qi, hh, c] @ k[bb, ki, j_kv, c].T
                              for c in _chunks(n)])
            dp_r = _rank_sums([do[bb, qi, hh, c] @ v[bb, ki, j_kv, c].T
                               for c in _chunks(n)])
            ranks += [s_r, dp_r]
            pr = exp(s_r[0] * scale * mul - lse[bb, hh, qi][:, None])
            if causal:
                pr = pr.masked_fill(ki[None] > qi[:, None], 0.0)
            ds = pr * (dp_r[0] - dlt[0][:, None])
            if rounded:
                ds = ds.to(torch.bfloat16).float()
            for c in halves:
                dq[bb, qi, hh, c] += ds @ k[bb, ki, j_kv, c]
    return dq * scale, delta, ranks


def _dkv_cluster_walk(q, k, v, o, lse, do, causal, scale, base, parts,
                      rounded=True):
    """What dk/dv's clusters past 512 compute: for each (b * KVH + kvh,
    64-row kv tile, part) item of dkv_wide_schedule's list, over its part's
    heads and its BWD_INNER-row q tiles from the causal start, the chunks'
    partials S^T_c and dP^T_c as every rank forms them (rank order); P^T
    in the family's base, masked where q < k, dS^T = P^T (dP^T - delta),
    both rounded to bf16 (fp32 when not ``rounded``); each chunk's dv +=
    P^T dO_c and dk += dS^T Q_c into the part's fp32 partials, summed in
    part order, dk times scale. Returns (dk, dv, ranks)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    heads = groups // parts
    n = fa_torch.chunks(d)
    exp, _, mul = fa_torch._BASES[base]
    kv_tile, q_tile = fa_torch.WIDE_KV_TILE, fa_torch.BWD_INNER
    delta = (do * o).sum(-1)  # (b, s, h)
    ws = torch.zeros((2, parts, b, s, kvh, d))
    ranks = []

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
        st = _rank_sums([torch.einsum("kd,qhd->hkq", k[bb, ki, j, c],
                                      qq[..., c]) for c in _chunks(n)])
        dpt = _rank_sums([torch.einsum("kd,qhd->hkq", v[bb, ki, j, c],
                                       dd[..., c]) for c in _chunks(n)])
        ranks += [st, dpt]
        pt = exp(st[0] * scale * mul - lse[bb, hs][:, qi][:, None, :])
        if causal:
            pt = pt.masked_fill(ki[:, None] > qi[None], 0.0)
        dst = bf16(pt * (dpt[0] - delta[bb][qi][:, hs].T[:, None, :]))
        pt = bf16(pt)
        for c in _chunks(n):
            ws[0, part, bb, ki, j, c] += torch.einsum("hkq,qhd->kd", pt,
                                                      dd[..., c])
            ws[1, part, bb, ki, j, c] += torch.einsum("hkq,qhd->kd", dst,
                                                      qq[..., c])
    dv, dk = ws[0, 0].clone(), ws[1, 0].clone()
    for part in range(1, parts):
        dv += ws[0, part]
        dk += ws[1, part]
    return dk * scale, dv, ranks


def _jax_block(s):
    """JAX's block at S: BLOCK where it divides S, else S itself."""
    return BLOCK if s % BLOCK == 0 else s


# (family, causal, S, H, KVH): each family in a causal mode it takes, MHA
# or a GQA group, a ragged S (200 against 64-row tiles).
WALKS = [("triangular", True, 200, 6, 2), ("resident", True, 128, 4, 4),
         ("resident", False, 200, 4, 1), ("streamed", False, 192, 6, 2)]


@pytest.mark.parametrize("n", CLUSTERS)
@pytest.mark.parametrize("fam,causal,s,h,kvh", WALKS)
def test_fwd_cluster_walk_matches_jax(fam, causal, s, h, kvh, n):
    # The cluster forward's walk at width 256 n against JAX's forward of
    # the family (interpret mode, 64-row blocks): o in fp32 to the JAX
    # tests' bound, with P rounded to bf16 to the bf16 kernels' bound; lse
    # to the JAX tests' bound in both.
    d = 256 * n
    q, k, v, _ = _arrays(s + h + n, s=s, h=h, kvh=kvh, d=d)
    scale = d ** -0.5
    fwd_j, _ = _jax_family(fam, causal, scale, _jax_block(s))
    o_j, lse_j = fwd_j(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    for rounded, tol in ((False, OUT_TOL), (True, BF16_OUT_TOL)):
        o, lse, _ = _one_thread(_fwd_cluster_walk, qt, kt, vt, causal,
                                scale, fam != "triangular", rounded)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=tol,
                                   atol=tol, err_msg=f"o {rounded}")
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                                   rtol=OUT_TOL, atol=OUT_TOL,
                                   err_msg=f"lse {rounded}")


@pytest.mark.parametrize("n", CLUSTERS)
@pytest.mark.parametrize("fam,causal,s,h,kvh", WALKS)
def test_dq_cluster_walk_matches_jax(fam, causal, s, h, kvh, n):
    # The cluster dq's walk (every family's, the resident one included)
    # from JAX's own saved forward against JAX's backward of the family at
    # width 256 n: dq in fp32 to the JAX tests' bound, with dS rounded to
    # bf16 to the bf16 kernels' bound; delta against rowsum(dO * O) over
    # all the columns.
    d = 256 * n
    q, k, v, do = _arrays(2 * s + h + n, s=s, h=h, kvh=kvh, d=d)
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
        dq, delta, _ = _one_thread(_dq_cluster_walk, qt, kt, vt, ot, lset,
                                   dot, causal, scale, base, rounded)
        np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), rtol=tol,
                                   atol=tol, err_msg=f"dq {rounded}")
    np.testing.assert_allclose(
        delta.numpy(), (dot * ot).sum(-1).permute(0, 2, 1).numpy(),
        rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("n", CLUSTERS)
@pytest.mark.parametrize("h,kvh,parts", [(4, 4, 1), (6, 2, 3), (4, 1, 2)])
def test_dkv_cluster_walk_matches_jax(h, kvh, parts, n):
    # The cluster dk/dv's walk from each family's own forward (the
    # triangular family in base 2 with MHA, the resident one causal with a
    # group of 3 in 3 parts, the streamed one non-causal with MQA in 2)
    # against JAX's backward of that family at width 256 n, S 192 (three
    # kv tiles): in fp32 to the JAX tests' bound, with P^T and dS^T
    # rounded to bf16 to the bf16 kernels' bound.
    fam, causal = {1: ("triangular", True), 3: ("resident", True),
                   2: ("streamed", False)}[parts]
    s, d = 192, 256 * n
    q, k, v, do = _arrays(h + 10 * parts + n, s=s, h=h, kvh=kvh, d=d)
    scale = d ** -0.5
    fwd_j, bwd_j = _jax_family(fam, causal, scale)
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    o_j, lse_pad = fwd_j(qj, kj, vj, keep_lse_pad=True)
    _, dk_j, dv_j = bwd_j((qj, kj, vj, o_j, lse_pad), doj)
    fwd_t, _ = _torch_family(fam, causal, scale)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o_t, lse_t = fwd_t(qt, kt, vt)
    base = "2" if fam == "triangular" else "e"
    for rounded, tol in ((False, GRAD_TOL), (True, BF16_GRAD_TOL)):
        dk, dv, _ = _one_thread(_dkv_cluster_walk, qt, kt, vt, o_t, lse_t,
                                dot, causal, scale, base, parts, rounded)
        for name, a, b in (("dk", dk, dk_j), ("dv", dv, dv_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                       atol=tol, err_msg=f"{name} {rounded}")


@pytest.mark.parametrize("n", CLUSTERS)
def test_cluster_ranks_agree_bit_for_bit(n):
    # Every S, dP, delta, S^T and dP^T that the n ranks of a cluster form
    # from their chunks' partials is the same bit for bit, so all take the
    # same softmax and the same dS: o, dq, dk and dv are deterministic.
    # Each rank summing its own partial first (the width-512 push's order
    # generalised) would not be: ragged S, a GQA group, causal.
    s, h, kvh, d = 200, 6, 2, 256 * n
    q, k, v, do = map(torch.from_numpy, _arrays(31 + n, s=s, h=h, kvh=kvh,
                                                d=d))
    scale = d ** -0.5
    o, lse, fwd_ranks = _one_thread(_fwd_cluster_walk, q, k, v, True, scale,
                                    True)
    _, _, dq_ranks = _one_thread(_dq_cluster_walk, q, k, v, o, lse, do, True,
                                 scale, "e")
    _, _, dkv_ranks = _one_thread(_dkv_cluster_walk, q, k, v, o, lse, do,
                                  True, scale, "e", 3)
    assert fwd_ranks and dq_ranks and dkv_ranks
    for sums in fwd_ranks + dq_ranks + dkv_ranks:
        assert len(sums) == n
        assert all(torch.equal(x, sums[0]) for x in sums[1:])
    # The order matters: own partial first differs somewhere.
    i, j = 0, _ceil(200, fa_torch.CHUNKED_INNER) - 1
    qi, ki = torch.arange(64), torch.arange(j * 64, 200)
    parts = [q[0, qi, 0, c] @ k[0, ki, 0, c].T for c in _chunks(n)]
    own_first = []
    for r in range(n):
        x = parts[r]
        for p in parts[:r] + parts[r + 1:]:
            x = x + p
        own_first.append(x)
    assert not all(torch.equal(x, own_first[i]) for x in own_first)


# -------------------------------------- the plain versions and the op

@pytest.mark.parametrize("d", [1024, 776])
@pytest.mark.parametrize("fam", ["resident", "triangular", "streamed"])
def test_plain_versions_match_jax_past_512(fam, d):
    # JAX's families called directly (interpret mode, 64-row blocks) at
    # head_dim 1024 and 776 (which pads to 1024) against the port's plain
    # versions, forward and backward from JAX's saved forward: what a CPU
    # tensor gets, and what the cluster kernels hold to on the card.
    causal, s, h, kvh = {"resident": (True, 128, 4, 1),
                         "triangular": (True, 192, 4, 2),
                         "streamed": (False, 128, 4, 1)}[fam]
    q, k, v, do = _arrays(d + s, s=s, h=h, kvh=kvh, d=d)
    scale = d ** -0.5
    fwd_j, bwd_j = _jax_family(fam, causal, scale)
    fwd_t, bwd_t = _torch_family(fam, causal, scale)
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    o_j, lse_j = fwd_j(qj, kj, vj)
    o_t, lse_t = fwd_t(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    _, lse_pad = fwd_j(qj, kj, vj, keep_lse_pad=True)
    ref = bwd_j((qj, kj, vj, o_j, lse_pad), doj)
    got = bwd_t(*map(torch.from_numpy, (q, k, v, np.array(o_j),
                                        np.array(lse_j), do)))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("d", [1024, 1000])
def test_op_matches_jax_past_512(d):
    # The op through autograd at head_dim 1024 and 1000 (within the
    # resident budget at S 128), against JAX's flash_attention: outputs
    # and gradients of sum(out ** 2).
    q, k, v, _ = _arrays(17 + d, s=128, h=4, kvh=2, d=d)
    assert fa_torch.family(128, d, True) == fa_torch.RESIDENT

    def loss(q, k, v):
        out = fa_jax.flash_attention(q, k, v, causal=True, block_q=BLOCK,
                                     block_k=BLOCK)
        return jnp.sum(out ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out_t = fa_torch.flash_attention(*leaves, causal=True)
    g_t = torch.autograd.grad((out_t ** 2).sum(), leaves)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


# ------------------------------------------- the wrappers past 512

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


@pytest.mark.parametrize("d,width", [(520, 768), (1000, 1024),
                                     (1800, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("fam", [fa_torch.RESIDENT, fa_torch.TRIANGULAR,
                                 fa_torch.STREAMED])
def test_each_wrapper_launches_its_cluster_instance(monkeypatch, fam, dtype,
                                                    d, width):
    # flash_forward and flash_backward on "on-card" 16-bit tensors at a
    # head_dim past 512: each of the family's wrappers launches once at its
    # kernel width (the cluster instance, n = width / 256 CTAs an item,
    # the C entry taking n from it), the forward over 128-row q tiles, dq
    # over dq_schedule's 64-row tiles, dk/dv over dkv_wide_schedule's list
    # at dkv_parts' P of that width, with P > 1 a (2, P, B, S, KVH, width)
    # fp32 workspace and two zeroed tickets per kv tile and chunk; the
    # inputs zero-padded to the width, the outputs back at d.
    launches = _spy_launches(monkeypatch)
    b, s, h, kvh, causal = 1, 512, 8, 1, fam != fa_torch.STREAMED
    n = fa_torch.chunks(width)
    rng = np.random.default_rng(23)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype).as_subclass(_OnCard)
        for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                      (b, s, h, d)))
    lse = torch.zeros(b, h, s)
    o, _ = fa_torch.flash_forward(q, k, v, causal, d ** -0.5, fam)
    grads = fa_torch.flash_backward(q, k, v, q, lse, do, causal, d ** -0.5,
                                    fam)
    assert o.shape[-1] == d and all(g.shape[-1] == d for g in grads)
    assert [(nm, w) for nm, _, _, w, _ in launches] == [
        (nm, width) for nm in _NAMES[fam]]
    (_, _, fwd_ptrs, _, fwd_tail), (_, _, dq_ptrs, _, _), (
        _, _, dkv_ptrs, _, dkv_tail) = launches
    assert fwd_tail[0] == fa_torch._DTYPE_CODES[dtype] and n == width // 256
    assert torch.equal(fwd_ptrs[-1], fa_torch.tri_schedule(
        "rows", b * h, s, tile=fa_torch.FWD_TILE, inner=fa_torch.FWD_TILE))
    assert torch.equal(dq_ptrs[-1], fa_torch.dq_schedule(b * h, s, width))
    assert len(dq_ptrs[-1]) == b * h * s // fa_torch.CHUNKED_DQ_TILE
    parts = fa_torch.dkv_parts(b, s, kvh, h // kvh, causal, 132, width)
    work, ws, tickets = dkv_ptrs[8:]
    assert dkv_tail[-1] == parts
    assert torch.equal(work, fa_torch.dkv_wide_schedule(b * kvh, s, parts))
    for t in fwd_ptrs[:3] + dq_ptrs[:5] + dkv_ptrs[:4]:
        if t.dim() == 4:
            assert t.shape[-1] == width and t.dtype == dtype
            assert torch.count_nonzero(t[..., d:]) == 0
    if parts == 1:
        assert ws is None and tickets is None
    else:
        assert ws.shape == (2, parts, b, s, kvh, width)
        assert tickets.numel() == 2 * b * kvh * _ceil(
            s, fa_torch.WIDE_KV_TILE) * n and not tickets.any()


@pytest.mark.parametrize("d,width", [(640, 768), (1024, 1024),
                                     (2048, 2048)])
def test_f32_takes_the_fp32_kernels_past_512(monkeypatch, d, width):
    # f32 past 512 takes the fp32 kernels at its width, whatever the
    # family, their lists at the wide tiles, and with a split GQA group
    # one ticket per kv tile and chunk.
    launches = _spy_launches(monkeypatch)
    b, s, h, kvh = 1, 256, 8, 1
    q = torch.zeros(b, s, h, d).as_subclass(_OnCard)
    k = torch.zeros(b, s, kvh, d).as_subclass(_OnCard)
    lse = torch.zeros(b, h, s)
    rows, inner = fa_torch.F32_WIDE_TILES
    for fam in (fa_torch.RESIDENT, fa_torch.TRIANGULAR, fa_torch.STREAMED):
        launches.clear()
        fa_torch.flash_forward(q, k, k, True, 0.05, fam)
        fa_torch.flash_backward(q, k, k, q, lse, q, True, 0.05, fam)
        assert [(nm, w) for nm, _, _, w, _ in launches] == [
            ("flash_fwd_f32", width), ("flash_dq_f32", width),
            ("flash_dkv_f32", width)]
        fwd_ptrs, dq_ptrs, dkv_ptrs = (ptrs for _, _, ptrs, _, _ in launches)
        assert torch.equal(fwd_ptrs[5], fa_torch.tri_schedule(
            "rows", b * h, s, tile=rows, inner=inner))
        assert torch.equal(dq_ptrs[8], fwd_ptrs[5])
        parts = launches[2][4][-1]
        assert parts == fa_torch.dkv_parts(b, s, kvh, h, True, 132, width,
                                           True)
        work, ws, tickets = dkv_ptrs[8:]
        assert torch.equal(work, fa_torch.dkv_wide_schedule(
            b * kvh, s, parts, tile=rows, inner=inner))
        if parts > 1:
            assert ws.shape == (2, parts, b, s, kvh, width)
            assert tickets.numel() == b * kvh * _ceil(s, rows) * (
                width // fa_torch.CHUNK)


# ------------------------------------------------------------ the sources

def _code(text):
    """A source without its comments."""
    return re.sub(r"//[^\n]*", "", text)


def test_cluster_dispatch_matches_the_widths():
    # Every Hopper C entry's dispatch ends in the cluster instance at
    # template head_dim CLUSTER_INSTANCE, taken for every width past 512
    # that is a multiple of 256 up to it (cluster_width); the three
    # kernels' bodies there are the pulled exchange's (fwd_cta_x,
    # dq_cta_x, dkv_cta_x) in every family.
    header = (_CSRC / "flash_fwd_sm90.cuh").read_text()
    assert int(re.search(r"constexpr int kClusterD = (\d+);",
                         header).group(1)) == fa_torch.CLUSTER_INSTANCE
    assert int(re.search(r"constexpr int kChunk = (\d+);",
                         header).group(1)) == fa_torch.CHUNK
    body = re.search(r"#define STPU_SM90_BY_D\(.*?while \(0\)", header,
                     re.S).group(0)
    assert "STPU_SM90_CLUSTER(HEAD_DIM" in body
    rule = re.search(r"constexpr bool cluster_width\(int width\) \{(.*?)\}",
                     header, re.S).group(1)
    assert "width > 2 * kChunk" in rule and "width <= kClusterD" in rule
    assert "width % kChunk == 0" in rule
    widths = [w for w in range(8, 4097, 8)
              if w > 512 and w <= fa_torch.CLUSTER_INSTANCE and w % 256 == 0]
    assert tuple(widths) == fa_torch.CLUSTER_WIDTHS
    assert len(widths) + 2 <= fa_torch.MAX_CLUSTER
    for source, bodies in (("flash_fwd.cu", ()),
                           ("flash_bwd.cu", ("dq_cta_x", "dkv_cta_x")),
                           ("flash_tri.cu", ("dq_cta_x", "dkv_cta_x")),
                           ("flash_streamed.cu", ("dq_cta_x",
                                                  "dkv_cta_x"))):
        code = _code((_CSRC / source).read_text())
        for name in bodies:
            assert f"sm90::{name}<T, " in code, (source, name)
        assert code.count("D == sm90::kClusterD") == len(bodies)
    assert "fwd_cta_x<T, kNaturalLse>" in _code(header)


def test_f32_wide_tiles_match_the_source():
    # F32_WIDE_TILES (the fp32 tables past 512) is flash_f32.cu's
    # WideTiles (resident rows, rows of a streamed tile): a chunk of CHUNK
    # columns a CTA, the slabs dividing the chunk, the 8 warps tiling both
    # the scores (kRows x kInner in kSM x kSN blocks) and each output slab
    # (kRows x kSlab in kOM x kON blocks); the wide kernels take the Hopper
    # kernels' widths past 512 (sm90::cluster_width: CLUSTER_WIDTHS).
    source = (_CSRC / "flash_f32.cu").read_text()
    body = re.search(r"struct WideTiles \{(.*?)\};", source, re.S).group(1)
    tiles = {k: int(v) for k, v in re.findall(r"(k\w+) = (\d+)", body)}
    assert (tiles["kRows"], tiles["kInner"]) == fa_torch.F32_WIDE_TILES
    for width in fa_torch.CLUSTER_WIDTHS:
        assert fa_torch.F32_FWD_TILES[width] == fa_torch.F32_WIDE_TILES
        assert fa_torch.F32_DQ_TILES[width] == fa_torch.F32_WIDE_TILES
        assert fa_torch.F32_DKV_TILES[width] == fa_torch.F32_WIDE_TILES
    chunk = int(re.search(r"constexpr int kWideChunk = (\d+);",
                          source).group(1))
    assert chunk == fa_torch.CHUNK and chunk % tiles["kSlab"] == 0
    assert tiles["kStages"] >= 2
    for rows, cols, tm, tn in (
            (tiles["kRows"], tiles["kInner"], tiles["kSM"], tiles["kSN"]),
            (tiles["kRows"], tiles["kSlab"], tiles["kOM"], tiles["kON"])):
        assert (rows // (4 * tm)) * (cols // (8 * tn)) == 8
    code = _code(source)
    assert "static_assert(kWideChunk == sm90::kChunk" in code
    for kernel in ("flash_fwd_f32_wide_kernel", "flash_dq_f32_wide_kernel",
                   "flash_dkv_f32_wide_kernel"):
        assert re.search(r"__global__ void __launch_bounds__\(kThreads, "
                         rf"1\)\s*{kernel}\(", code), kernel
        assert code.count(kernel) >= 2, kernel  # defined and launched
    assert code.count("if (sm90::cluster_width(D))") == 3


# ------------------------------------------- a Gemma at head_dim 1024

def test_gemma_at_head_dim_1024_steps_match_jax():
    # A tiny Gemma (2 layers, dim 128, 4 heads over 1 KV head) with
    # head_dim_ 1024, two adamw steps through each package's
    # make_train_step from the same converted init and tokens, f32: JAX's
    # flash kernels in interpret mode, the port's op on the CPU (the plain
    # versions of the width it pads to). Loss and grad norm per step to
    # 2e-3, as test_torch_trainer.py holds the Llama step.
    fields = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                  n_kv_heads=1, head_dim_=1024, mlp_dim=256)
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
