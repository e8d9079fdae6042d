"""The fp32 kernels (csrc/flash_f32.cu: flash_fwd_f32, flash_dq_f32,
flash_dkv_f32) on the CPU: their work lists, the GQA parts rule, what
their wrappers hand their launches, their source, and their tiled walks
against the JAX package.

The three kernels are SGEMM-style FFMA bodies: the forward and dq over (b
* H + h, q tile) items, each walking the key tiles up to its causal bound
(the forward with an online maximum and sum in base 2); dk/dv over (b *
KVH + kvh, kv tile, part) items, each walking the q tiles from its causal
start for every query head of its part of the GQA group, the parts' fp32
partials summed in part order by the last CTA of each kv tile. What a CPU
run can hold of that: that the lists, walked with the kernels' loop
bounds, compute every tile pair the JAX enumeration needs exactly once,
longest first; that P divides the group and splits the card's work where
the shape alone leaves it idle; that the wrappers hand the launch the list,
workspace, tickets and P (spied on tensors that claim to be on the card);
that the source holds no tensor-core or TF32 instruction and that its tile
structs are the wrappers' tables; and that the same walks, done tile by
tile in fp32 here (the kernels' masks, base-2 exp, the online softmax's
rescales, the parts summed in order), give JAX's outputs and gradients.
Inputs come from numpy with a seed; tolerances are the JAX tests' own
(2e-3 outputs and lse, 5e-3 gradients).
"""
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
_CSRC = pathlib.Path(fa_torch.__file__).resolve().parents[1] / "csrc"
_SOURCE = (_CSRC / "flash_f32.cu").read_text()
_SEQS = [200, 1000, 4136, 4160]


def _ceil(a, b):
    return -(-a // b)


def _dq_walk(work, s, causal, rows, inner):
    """(row, q tile, key tile) triples the dq CTAs compute: item (row, qt)
    walks the key tiles below its causal bound (flash_dq_f32_kernel's
    n_kt)."""
    n_all = _ceil(s, inner)
    out = []
    for row, qt in work:
        n_kt = (min(n_all, (qt * rows + rows - 1) // inner + 1) if causal
                else n_all)
        out += [(row, qt, kt) for kt in range(n_kt)]
    return out


def _dkv_walk(work, s, causal, rows, inner, groups, parts):
    """(row, head of the group, kv tile, q tile) the dk/dv CTAs compute:
    item (row, kt, part) walks, for each of its part's groups / parts
    heads, the q tiles from its causal start (flash_dkv_f32_kernel's
    i0)."""
    n_all = _ceil(s, inner)
    heads = groups // parts
    out = []
    for row, kt, part in work:
        i0 = kt * rows // inner if causal else 0
        out += [(row, part * heads + g, kt, qt) for g in range(heads)
                for qt in range(i0, n_all)]
    return out


# ------------------------------------------------------------- work lists

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", _SEQS)
@pytest.mark.parametrize("width", fa_torch.HEAD_DIMS)
def test_fwd_f32_list_covers_every_tile_once(width, s, causal):
    # The forward walks the same (row, q tile) lists as dq, at its own
    # tiles: every (row, q tile) once, and with the kernel's loop bounds
    # every (q tile, key tile) pair JAX's enumeration needs (all of them
    # when not causal) exactly once; causal items longest first.
    rows, inner = fa_torch.F32_FWD_TILES[width]
    n_rows = 3
    work = fa_torch.tri_schedule("rows", n_rows, s, tile=rows,
                                 inner=inner).tolist()
    nt, ni = _ceil(s, rows), _ceil(s, inner)
    assert sorted(map(tuple, work)) == [(r, t) for r in range(n_rows)
                                        for t in range(nt)]
    got = _dq_walk(work, s, causal, rows, inner)
    if causal:
        tiles, keys = fa_jax._tri_maps_row(nt, ni, rows, inner)
        want = [(r, t, k) for r in range(n_rows)
                for t, k in zip(tiles.tolist(), keys.tolist())]
    else:
        want = [(r, t, k) for r in range(n_rows) for t in range(nt)
                for k in range(ni)]
    assert len(got) == len(set(got)) and sorted(got) == sorted(want)
    lengths = [len(_dq_walk([it], s, True, rows, inner)) for it in work]
    assert lengths == sorted(lengths, reverse=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", _SEQS)
@pytest.mark.parametrize("width", fa_torch.HEAD_DIMS)
def test_dq_f32_list_covers_every_tile_once(width, s, causal):
    # Every (row, q tile) once; walked with the kernel's loop bounds,
    # every (q tile, key tile) pair JAX's enumeration needs (all of them
    # when not causal) exactly once; causal items longest first.
    rows, inner = fa_torch.F32_DQ_TILES[width]
    n_rows = 3
    work = fa_torch.tri_schedule("rows", n_rows, s, tile=rows,
                                 inner=inner).tolist()
    nt, ni = _ceil(s, rows), _ceil(s, inner)
    assert sorted(map(tuple, work)) == [(r, t) for r in range(n_rows)
                                        for t in range(nt)]
    got = _dq_walk(work, s, causal, rows, inner)
    if causal:
        tiles, keys = fa_jax._tri_maps_row(nt, ni, rows, inner)
        want = [(r, t, k) for r in range(n_rows)
                for t, k in zip(tiles.tolist(), keys.tolist())]
    else:
        want = [(r, t, k) for r in range(n_rows) for t in range(nt)
                for k in range(ni)]
    assert len(got) == len(set(got)) and sorted(got) == sorted(want)
    lengths = [len(_dq_walk([it], s, True, rows, inner)) for it in work]
    assert lengths == sorted(lengths, reverse=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", _SEQS)
@pytest.mark.parametrize("width", fa_torch.HEAD_DIMS)
def test_dkv_f32_list_covers_every_tile_once(width, s, causal):
    # Every (row, kv tile, part) once, a tile's parts together; walked
    # with the kernel's loop bounds, every (head, kv tile, q tile) the JAX
    # enumeration needs exactly once across the parts; longest first.
    rows, inner = fa_torch.F32_DKV_TILES[width]
    n_rows, groups = 2, 6
    nt, ni = _ceil(s, rows), _ceil(s, inner)
    kvs, _, qs = fa_jax._tri_maps_col(ni, nt, inner, rows, 1)
    for parts in (1, 2, 3, 6):
        work = fa_torch.dkv_wide_schedule(n_rows, s, parts, tile=rows,
                                          inner=inner).tolist()
        assert sorted(map(tuple, work)) == [
            (r, t, p) for r in range(n_rows) for t in range(nt)
            for p in range(parts)]
        got = _dkv_walk(work, s, causal, rows, inner, groups, parts)
        if causal:
            want = [(r, g, t, q) for r in range(n_rows)
                    for g in range(groups)
                    for t, q in zip(kvs.tolist(), qs.tolist())]
        else:
            want = [(r, g, t, q) for r in range(n_rows)
                    for g in range(groups) for t in range(nt)
                    for q in range(ni)]
        assert len(got) == len(set(got)) and sorted(got) == sorted(want)
        lengths = [len(_dkv_walk([it], s, True, rows, inner, groups, parts))
                   for it in work]
        assert lengths == sorted(lengths, reverse=True)


# ------------------------------------------------------------ the parts rule

@pytest.mark.parametrize("shape", [
    (2, 2048, 32, 8, 128, True), (1, 4096, 8, 1, 256, True),
    (1, 1024, 8, 1, 512, True), (1, 1024, 8, 1, 512, False),
    (1, 4160, 6, 2, 64, True), (1, 1000, 6, 2, 256, False),
    (8, 2048, 8, 1, 256, True), (1, 200, 12, 2, 128, True)])
def test_f32_parts_divide_the_group(shape):
    # P is a divisor of the group, at most MAX_PARTS, the cheapest of them
    # in the fp32 body's cost model.
    b, s, h, kvh, d, causal = shape
    groups = h // kvh
    parts = fa_torch.dkv_parts(b, s, kvh, groups, causal, 132, d, True)
    assert groups % parts == 0 and 1 <= parts <= fa_torch.MAX_PARTS
    costs = {p: sum(fa_torch.dkv_parts_cost(b, s, kvh, groups, causal, 132,
                                            p, d, True))
             for p in range(1, min(groups, fa_torch.MAX_PARTS) + 1)
             if groups % p == 0}
    assert costs[parts] == min(costs.values())


@pytest.mark.parametrize("shape", [(1, 4096, 8, 1, 256, True),
                                   (1, 1024, 8, 1, 512, True)])
def test_f32_parts_split_the_timed_wide_shapes(shape):
    # MQA at widths 256 and 512: 64 and 32 kv tiles alone would leave
    # most of 132 SMs idle, so the group is split.
    b, s, h, kvh, d, causal = shape
    assert fa_torch.dkv_parts(b, s, kvh, h // kvh, causal, 132, d, True) > 1


def test_f32_mha_takes_one_part_without_asking_the_card(monkeypatch):
    # MHA has one head a group: P = 1 whatever the card, and the wrapper
    # never asks for the SM count.
    monkeypatch.setattr(fa_torch, "_sm_count", lambda device: pytest.fail(
        "asked the card"))
    q = torch.zeros(1, 200, 4, 128)
    work, ws, tickets, parts = fa_torch._dkv_split(q, 4, True, f32=True)
    assert (ws, tickets, parts) == (None, None, 1)
    assert torch.equal(work, fa_torch.dkv_wide_schedule(4, 200, 1, tile=64,
                                                        inner=64))


# ------------------------------------------------- what the wrappers launch

class _OnCard(torch.Tensor):
    is_cuda = True


def _spy(monkeypatch):
    launches = []
    check = fa_torch._check_inputs

    def on_card(*ts, **kw):
        check(*(t.as_subclass(_OnCard) for t in ts), **kw)

    monkeypatch.setattr(fa_torch, "_check_inputs", on_card)
    monkeypatch.setattr(fa_torch, "_sm_count", lambda device: 132)
    monkeypatch.setattr(fa_torch, "_launch", lambda name, source, ptrs,
                        strides, q, n_kv, *tail: launches.append(
                            (name, source, list(ptrs), n_kv, tail)))
    return launches


@pytest.mark.parametrize("shape", [(1, 4096, 8, 1, 256, True),
                                   (1, 1024, 8, 1, 512, False),
                                   (1, 200, 4, 4, 128, True),
                                   (2, 1000, 6, 2, 64, True)])
def test_f32_backward_hands_its_launch_lists_and_workspace(monkeypatch,
                                                           shape):
    # On the card, flash_backward on f32 tensors calls flash_dq_f32 and
    # flash_dkv_f32: dq's launch takes tri_schedule's "rows" list at
    # F32_DQ_TILES after its eight tensors; dk/dv's takes
    # dkv_wide_schedule's list at F32_DKV_TILES and P, with P > 1 an
    # fp32 workspace (2, P, B, S, KVH, D) and one zeroed int ticket a kv
    # tile (None, None at P = 1), and (scale, causal, P) as its tail.
    launches = _spy(monkeypatch)
    b, s, h, kvh, d, causal = shape
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(dims).astype(
        np.float32)).as_subclass(_OnCard)
        for dims in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                     (b, s, h, d)))
    lse = torch.zeros(b, h, s)
    fa_torch.flash_backward(q, k, v, q, lse, do, causal, d ** -0.5,
                            fa_torch.family(s, d, causal))
    (dq_name, dq_src, dq_ptrs, _, dq_tail), (
        dkv_name, dkv_src, dkv_ptrs, n_kv, dkv_tail) = launches
    assert (dq_name, dkv_name) == ("flash_dq_f32", "flash_dkv_f32")
    assert dq_src == dkv_src == "flash_f32" and n_kv == kvh
    rows, inner = fa_torch.F32_DQ_TILES[d]
    assert len(dq_ptrs) == 9 and dq_tail == (d ** -0.5, int(causal))
    assert torch.equal(dq_ptrs[8], fa_torch.tri_schedule(
        "rows", b * h, s, tile=rows, inner=inner))
    assert len(dq_ptrs[8]) == b * h * _ceil(s, rows)
    groups = h // kvh
    parts = 1 if groups == 1 else fa_torch.dkv_parts(b, s, kvh, groups,
                                                     causal, 132, d, True)
    rows, inner = fa_torch.F32_DKV_TILES[d]
    assert len(dkv_ptrs) == 11
    assert dkv_tail == (d ** -0.5, int(causal), parts)
    work, ws, tickets = dkv_ptrs[8:]
    assert torch.equal(work, fa_torch.dkv_wide_schedule(
        b * kvh, s, parts, tile=rows, inner=inner))
    assert len(work) == b * kvh * _ceil(s, rows) * parts
    if parts == 1:
        assert ws is None and tickets is None
    else:
        assert ws.shape == (2, parts, b, s, kvh, d)
        assert ws.dtype == torch.float32
        assert tickets.dtype == torch.int32 and not tickets.any()
        assert tickets.numel() == b * kvh * _ceil(s, rows)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", fa_torch.HEAD_DIMS)
def test_f32_forward_hands_its_launch_its_list(monkeypatch, d, causal):
    # On the card, flash_forward on f32 tensors launches flash_fwd_f32
    # once, whatever the family, with tri_schedule's "rows" list at
    # F32_FWD_TILES after its five tensors and (scale, causal) as its
    # tail.
    launches = _spy(monkeypatch)
    b, s, h, kvh = 2, 1000, 6, 2
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(dims).astype(
        np.float32)).as_subclass(_OnCard)
        for dims in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    fa_torch.flash_forward(q, k, v, causal, d ** -0.5,
                           fa_torch.family(s, d, causal))
    ((name, source, ptrs, n_kv, tail),) = launches
    assert (name, source, n_kv) == ("flash_fwd_f32", "flash_f32", kvh)
    assert len(ptrs) == 6 and tail == (d ** -0.5, int(causal))
    rows, inner = fa_torch.F32_FWD_TILES[d]
    assert torch.equal(ptrs[5], fa_torch.tri_schedule("rows", b * h, s,
                                                      tile=rows,
                                                      inner=inner))
    assert len(ptrs[5]) == b * h * _ceil(s, rows)


# ------------------------------------------------------------- the source

def _code(text):
    """The source without its comments."""
    return re.sub(r"//[^\n]*", "", text)


def test_f32_source_is_exact_fp32():
    # The fp32 kernels' products are FFMA on the CUDA cores: no wgmma, no
    # mma.sync, no TF32 conversion or type; of the Hopper header they take
    # the mbarrier and TMA helpers (the backward's ring) and the widths
    # past 512 (cluster_width, kChunk) alone, and their only atomic is the
    # integer ticket of the GQA parts' sum.
    code = _code(_SOURCE)
    for pattern in (r"wgmma", r"\bmma\.", r"tf32", r"HMMA", r"ldmatrix",
                    r"cvt\.rna"):
        assert not re.search(pattern, code, re.I), pattern
    assert set(re.findall(r"sm90::(\w+)", code)) == {
        "mbar_init", "mbar_expect_tx", "mbar_wait", "tma_load_4d",
        "tensor_map_encoder", "TensorMapEncodeTiled", "kTensorMapError",
        "cluster_width", "kChunk"}
    assert "CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in code
    assert "atomicAdd(a.tickets" in code
    assert not re.search(r"atomicAdd\((?!a\.tickets)", code)


def test_f32_tiles_match_the_source():
    # The wrappers' tile tables are the kernels' DqTiles and DkvTiles.
    for struct, table in (("DqTiles", fa_torch.F32_DQ_TILES),
                          ("DkvTiles", fa_torch.F32_DKV_TILES)):
        for d in fa_torch.HEAD_DIMS:
            body = re.search(rf"struct {struct}<{d}> {{(.*?)}};", _SOURCE,
                             re.S).group(1)
            vals = dict(re.findall(r"(k\w+) = (\d+)", body))
            assert (int(vals["kRows"]), int(vals["kInner"])) == table[d]
            assert d % int(vals["kSlab"]) == 0


@pytest.mark.parametrize("d", fa_torch.HEAD_DIMS)
def test_f32_fwd_tiles_match_the_source(d):
    # F32_FWD_TILES is the forward's FwdTiles<D> (resident q rows, keys of
    # a streamed tile); the slabs divide the row, and the 8 warps tile
    # both of its products: S (kRows x kInner in kSM x kSN blocks) and
    # each output slab (kRows x kSlab in kOM x kON blocks), a warp's
    # lanes 4 x 8 of them.
    body = re.search(rf"struct FwdTiles<{d}> {{(.*?)}};", _SOURCE,
                     re.S).group(1)
    tiles = {k: int(v) for k, v in re.findall(r"(k\w+) = (\d+)", body)}
    assert (tiles["kRows"], tiles["kInner"]) == fa_torch.F32_FWD_TILES[d]
    assert d % tiles["kSlab"] == 0 and tiles["kStages"] >= 2
    for rows, cols, tm, tn in (
            (tiles["kRows"], tiles["kInner"], tiles["kSM"], tiles["kSN"]),
            (tiles["kRows"], tiles["kSlab"], tiles["kOM"], tiles["kON"])):
        assert (rows // (4 * tm)) * (cols // (8 * tn)) == 8
        assert rows % (4 * tm) == 0 and cols % (8 * tn) == 0


# ------------------------------------------ the tiled walks against JAX

def _tiled_forward(q, k, v, causal, scale):
    """The fp32 forward as its kernel walks its list, on CPU tensors: item
    by item, each q tile over its key tiles up to the causal bound, with
    the online softmax in base 2 (scores times scale log2(e), masked past
    S and above the diagonal; the running maximum m, o and the sum l
    rescaled by exp2(m - m_new) each tile); then o / l and the natural-log
    lse (m + log2(l)) ln(2)."""
    b, s, h, d = q.shape
    groups = h // k.shape[2]
    rows, inner = fa_torch.F32_FWD_TILES[d]
    c2 = scale * fa_torch.LOG2E
    o = torch.zeros_like(q)
    lse = torch.zeros(b, h, s)
    n_all = _ceil(s, inner)
    for bh, qt in fa_torch.tri_schedule("rows", b * h, s, tile=rows,
                                        inner=inner).tolist():
        bb, hh = divmod(bh, h)
        qi = torch.arange(qt * rows, min(s, qt * rows + rows))
        n_kt = (min(n_all, (qt * rows + rows - 1) // inner + 1) if causal
                else n_all)
        m = torch.full((len(qi),), -float("inf"))
        l = torch.zeros(len(qi))
        acc = torch.zeros(len(qi), d)
        for kt in range(n_kt):
            ki = torch.arange(kt * inner, min(s, kt * inner + inner))
            sc = (q[bb, qi, hh] @ k[bb, ki, hh // groups].T) * c2
            if causal:
                sc = sc.masked_fill(ki[None] > qi[:, None], -float("inf"))
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(sc - m_new[:, None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + p @ v[bb, ki, hh // groups]
            m = m_new
        o[bb, qi, hh] = acc / l[:, None]
        lse[bb, hh, qi] = (m + torch.log2(l)) * np.log(2.0)
    return o, lse


# (JAX family, causal, S): ragged S (not a multiple of the 64- or 128-row
# tiles) in each family's own mode, the triangular family's base-2 lse
# taken to natural log.
_FWD_CASES = [("triangular", True, 200), ("streamed", False, 200),
              ("resident", True, 136), ("resident", False, 136)]


@pytest.mark.parametrize("fam,causal,s", _FWD_CASES)
@pytest.mark.parametrize("d", fa_torch.HEAD_DIMS)
def test_tiled_forward_matches_jax(d, fam, causal, s):
    # The fp32 forward's walk of its list (tiles, causal bounds, masks past
    # a ragged S, the online softmax's rescales, the natural-log lse)
    # against JAX's forward kernels in interpret mode, 8-row blocks.
    rng = np.random.default_rng(d + s)
    q, k, v = (rng.standard_normal(dims).astype(np.float32)
               for dims in ((1, s, 4, d), (1, s, 2, d), (1, s, 2, d)))
    scale = d ** -0.5
    kw = dict(scale=scale, block_q=8, block_k=8)
    args = tuple(map(jnp.asarray, (q, k, v)))
    if fam == "triangular":
        o_j, lse_j = fa_jax._flash_fwd_tri(*args, **kw)
        lse_j = np.asarray(lse_j) * np.log(2.0)
    else:
        fwd = (fa_jax._flash_fwd_resident if fam == "resident"
               else fa_jax._flash_fwd_streamed)
        o_j, lse_j = fwd(*args, causal=causal, **kw)
    o_t, lse_t = _tiled_forward(*map(torch.from_numpy, (q, k, v)), causal,
                                scale)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               rtol=OUT_TOL, atol=OUT_TOL)


def _tiled_backward(q, k, v, o, lse, do, causal, scale, parts):
    """The fp32 backward as the two kernels walk it, on CPU tensors: dq
    item by item over its key tiles, dk/dv item by item over its part's
    heads and q tiles, each part's partials summed in part order; P =
    exp2(S scale log2(e) - lse log2(e)), masked past S and above the
    diagonal."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    log2e = fa_torch.LOG2E
    rows, inner = fa_torch.F32_DQ_TILES[d]
    dq = torch.zeros_like(q)
    delta = (do * o).sum(-1).permute(0, 2, 1)              # (b, h, s)
    for bh, qt in fa_torch.tri_schedule("rows", b * h, s, tile=rows,
                                        inner=inner).tolist():
        bb, hh = divmod(bh, h)
        qi = torch.arange(qt * rows, min(s, qt * rows + rows))
        n_all = _ceil(s, inner)
        n_kt = (min(n_all, (qt * rows + rows - 1) // inner + 1) if causal
                else n_all)
        for kt in range(n_kt):
            ki = torch.arange(kt * inner, min(s, kt * inner + inner))
            kk, vv = k[bb, ki, hh // groups], v[bb, ki, hh // groups]
            sc = q[bb, qi, hh] @ kk.T
            p = torch.exp2(sc * scale * log2e
                           - lse[bb, hh, qi, None] * log2e)
            if causal:
                p = p.masked_fill(ki[None] > qi[:, None], 0.0)
            ds = p * (do[bb, qi, hh] @ vv.T - delta[bb, hh, qi, None])
            dq[bb, qi, hh] += ds @ kk
    dq *= scale
    rows, inner = fa_torch.F32_DKV_TILES[d]
    partial = torch.zeros((2, parts) + k.shape)
    heads = groups // parts
    for bkv, kt, part in fa_torch.dkv_wide_schedule(
            b * kvh, s, parts, tile=rows, inner=inner).tolist():
        bb, j = divmod(bkv, kvh)
        ki = torch.arange(kt * rows, min(s, kt * rows + rows))
        i0 = kt * rows // inner if causal else 0
        for hh in range(j * groups + part * heads,
                        j * groups + (part + 1) * heads):
            for qt in range(i0, _ceil(s, inner)):
                qi = torch.arange(qt * inner, min(s, qt * inner + inner))
                st = k[bb, ki, j] @ q[bb, qi, hh].T
                pt = torch.exp2(st * scale * log2e
                                - lse[bb, hh, None, qi] * log2e)
                if causal:
                    pt = pt.masked_fill(ki[:, None] > qi[None], 0.0)
                dpt = v[bb, ki, j] @ do[bb, qi, hh].T
                dst = pt * (dpt - delta[bb, hh, None, qi])
                partial[0, part, bb, ki, j] += pt @ do[bb, qi, hh]
                partial[1, part, bb, ki, j] += dst @ q[bb, qi, hh]
    dv, dk = partial[0, 0], partial[1, 0]
    for pp in range(1, parts):
        dv, dk = dv + partial[0, pp], dk + partial[1, pp]
    return dq, dk * scale, dv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,s,h,kvh,parts", [
    (64, 136, 6, 2, 3), (64, 72, 2, 2, 1), (128, 136, 4, 2, 2),
    (512, 104, 4, 1, 4)])
def test_tiled_walk_matches_jax(d, s, h, kvh, parts, causal):
    # The kernels' walk of their lists (tiles, causal bounds, masks past a
    # ragged S, base-2 exp of the natural-log lse, the group's parts
    # summed in order) gives JAX's gradients of sum(o ** 2).
    rng = np.random.default_rng(d + s + parts)
    q, k, v = (rng.standard_normal(dims).astype(np.float32)
               for dims in ((1, s, h, d), (1, s, kvh, d), (1, s, kvh, d)))
    scale = d ** -0.5

    def loss(q, k, v):
        return jnp.sum(fa_jax.flash_attention(q, k, v, causal=causal) ** 2)

    args = tuple(map(jnp.asarray, (q, k, v)))
    g_j = jax.grad(loss, argnums=(0, 1, 2))(*args)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    o, lse = fa_torch.flash_fwd_plain(qt, kt, vt, causal, scale)
    got = _tiled_backward(qt, kt, vt, o, lse, 2 * o, causal, scale, parts)
    for a, want in zip(got, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
