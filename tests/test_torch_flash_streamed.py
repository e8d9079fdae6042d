"""The port's streamed flash family (skypilot_tpu_torch.ops.flash_attention:
flash_fwd_streamed_plain, flash_bwd_streamed_plain and the non-causal
dispatch past the resident budget) against the JAX package's streamed
kernels, on the CPU.

Inputs come from numpy with a seed and go to both sides. The JAX side runs
``_flash_fwd_streamed`` / ``_flash_bwd_streamed`` in interpret mode, as
tests/test_flash_attention.py does, at two unequal block shapes, to show
the function does not depend on the TPU's blocks (S = 256 with 64-wide
blocks makes the JAX KV axis take several steps); the port side runs the
plain versions a CPU tensor gets. The kernels honour the causal flag as
the TPU ones do, so both modes are compared. The natural-log lse is
compared as it is. Tolerances are the JAX tests' own: 2e-3 for outputs and
lse, 5e-3 for gradients (f32 on both sides; the gap is summation order).
What a CPU run can hold of the kernels themselves: that the sources
instantiate the Hopper bodies and hold no mma.sync or non-bulk cp.async,
and that an on-card call reaches the three kernels with the work lists
their CTAs walk.
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
from skypilot_tpu_torch.ops import attention as attention_torch
from skypilot_tpu_torch.ops import flash_attention as fa_torch

OUT_TOL = 2e-3
GRAD_TOL = 5e-3
BLOCKS = [(128, 64), (64, 128)]
_CSRC = pathlib.Path(fa_torch.__file__).resolve().parents[1] / "csrc"


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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_q,block_k", BLOCKS)
def test_streamed_forward_matches_jax(causal, block_q, block_k):
    q, k, v, _ = _arrays(0)
    scale = q.shape[-1] ** -0.5
    o_j, lse_j = fa_jax._flash_fwd_streamed(
        *map(jnp.asarray, (q, k, v)), causal=causal, scale=scale,
        block_q=block_q, block_k=block_k)
    o_t, lse_t = fa_torch.flash_fwd_streamed_plain(
        *map(torch.from_numpy, (q, k, v)), causal, scale)
    assert lse_t.shape == lse_j.shape == (1, 4, 256)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=OUT_TOL,
                               atol=OUT_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_q,block_k", BLOCKS)
def test_streamed_backward_matches_jax(causal, block_q, block_k):
    q, k, v, do = _arrays(1, b=2, h=6)
    scale = q.shape[-1] ** -0.5
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    o_j, lse_pad = fa_jax._flash_fwd_streamed(
        qj, kj, vj, causal=causal, scale=scale, block_q=block_q,
        block_k=block_k, keep_lse_pad=True)
    ref = fa_jax._flash_bwd_streamed((qj, kj, vj, o_j, lse_pad), doj,
                                     causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o_t, lse_t = fa_torch.flash_fwd_streamed_plain(qt, kt, vt, causal, scale)
    got = fa_torch.flash_bwd_streamed_plain(qt, kt, vt, o_t, lse_t, dot,
                                            causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("entry", ["flash_attention", "attention"])
def test_noncausal_past_budget_takes_streamed_family(entry, monkeypatch,
                                                     past_budget):
    # Non-causal past the budget on both sides: JAX's flash_attention takes
    # its streamed kernels; the port's op (and the public attention op on
    # its kernel path) takes the streamed plain versions, carries the
    # streamed family from the forward to the backward, and matches output
    # and gradients.
    q, k, v, _ = _arrays(2, b=2, s=128)
    calls = collections.Counter()
    families = []

    def spy(name, record_family=False):
        fn = getattr(fa_torch, name)

        def wrapped(*args):
            calls[name] += 1
            if record_family:
                families.append((name, args[-1]))
            return fn(*args)
        monkeypatch.setattr(fa_torch, name, wrapped)

    for name in ("flash_fwd_plain", "flash_bwd_plain", "flash_fwd_tri_plain",
                 "flash_bwd_tri_plain", "flash_fwd_streamed_plain",
                 "flash_bwd_streamed_plain"):
        spy(name)
    spy("flash_forward", record_family=True)
    spy("flash_backward", record_family=True)

    def loss_jax(q, k, v):
        out = fa_jax.flash_attention(q, k, v, causal=False, block_q=64,
                                     block_k=64)
        return jnp.sum(out ** 2), out

    (_, out_j), g_j = jax.value_and_grad(loss_jax, argnums=(0, 1, 2),
                                         has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    if entry == "flash_attention":
        out_t = fa_torch.flash_attention(qt, kt, vt, causal=False)
    else:
        out_t = attention_torch.attention(qt, kt, vt, causal=False,
                                          impl="kernel")
    g_t = torch.autograd.grad((out_t ** 2).sum(), (qt, kt, vt))
    assert families == [("flash_forward", fa_torch.STREAMED),
                        ("flash_backward", fa_torch.STREAMED)]
    assert calls == {"flash_forward": 1, "flash_backward": 1,
                     "flash_fwd_streamed_plain": 1,
                     "flash_bwd_streamed_plain": 1}
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_streamed_plain_matches_resident_plain(causal):
    # The group-at-a-time plain versions compute the same function as the
    # resident family's all-heads-at-once ones (same natural-log lse), so
    # the kernels of both families can be held against each other where
    # the plain versions no longer fit.
    q, k, v, do = map(torch.from_numpy, _arrays(3, b=2, s=128, h=6))
    scale = q.shape[-1] ** -0.5
    o_s, lse_s = fa_torch.flash_fwd_streamed_plain(q, k, v, causal, scale)
    o_r, lse_r = fa_torch.flash_fwd_plain(q, k, v, causal, scale)
    torch.testing.assert_close(o_s, o_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse_s, lse_r, rtol=1e-5, atol=1e-5)
    got = fa_torch.flash_bwd_streamed_plain(q, k, v, o_s, lse_s, do, causal,
                                            scale)
    want = fa_torch.flash_bwd_plain(q, k, v, o_r, lse_r, do, causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


# ------------------------------------------------ the kernels on the card

@pytest.mark.parametrize("body", [
    "sm90::fwd_cta<D, T, /*kNaturalLse=*/true",
    "sm90::dq_cta<D, T, BaseE",
    "sm90::dkv_cta<D, T, BaseE",
])
def test_streamed_kernels_instantiate_the_hopper_bodies(body):
    # All three streamed kernels are instances of the Hopper bodies (the
    # forward in natural log, as the resident flash_fwd; dq and dk/dv in
    # natural exp, as the resident flash_dq and flash_dkv), with what the
    # bodies keep for long loops. The mma.sync steps and their cp.async
    # ring are gone.
    text = (_CSRC / "flash_streamed.cu").read_text()
    assert body in text
    assert "dq_step" not in text
    assert not re.search(r"flash_dq_streamed_kernel\(const BwdParams p\)",
                         text)
    common = (_CSRC / "flash_common.cuh").read_text()
    for gone in ("fwd_step", "store_o_lse", "dkv_step", "store_dkv",
                 "kDkvQ", "kPastLse", "dq_step", "tile_delta", "store_dq",
                 "load_tile_async", "kStages", "STPU_LAUNCH"):
        assert gone not in common


@pytest.mark.parametrize("source", sorted(p.name for p in _CSRC.iterdir()
                                          if p.suffix in (".cu", ".cuh")))
def test_no_kernel_source_holds_mma_sync_or_cp_async(source):
    # Every 16-bit product is a wgmma and every tile load a TMA bulk copy
    # (cp.async.bulk.tensor): no source keeps the pre-Hopper mma.sync
    # product or a non-bulk cp.async copy, in code or in a comment.
    text = (_CSRC / source).read_text()
    assert "mma.sync" not in text
    assert not re.search(r"cp\.async(?!\.bulk)", text)


class _OnCard(torch.Tensor):
    is_cuda = True


@pytest.mark.parametrize("causal", [False, True])
def test_streamed_family_reaches_its_kernels_with_work_lists(causal,
                                                            monkeypatch):
    # bf16 tensors on the card, streamed family: flash_forward and
    # flash_backward launch flash_fwd_streamed, flash_dq_streamed and
    # flash_dkv_streamed once each. The forward's launch carries the
    # Hopper forward's list (128-row q tiles, B * H rows), dq's the Hopper
    # backward's "rows" list (128-row q tiles, B * H rows) and dk/dv's its
    # "cols" list (128-row kv tiles, B * KVH rows), each every (row, tile)
    # once. Spied here on CPU tensors that claim to be on the card, every
    # other input check kept.
    b, s, h, kvh, d = 1, 200, 4, 2, 64
    launches = []
    check = fa_torch._check_inputs

    def on_card(*ts, **kw):
        check(*(t.as_subclass(_OnCard) for t in ts), **kw)

    def launch(name, source, ptrs, strides, q, n_kv, *tail):
        launches.append((name, source, list(ptrs), n_kv, tail))

    monkeypatch.setattr(fa_torch, "_check_inputs", on_card)
    monkeypatch.setattr(fa_torch, "_launch", launch)
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16).as_subclass(_OnCard)
        for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                      (b, s, h, d)))
    o, lse = fa_torch.flash_forward(q, k, v, causal, 0.125,
                                    fa_torch.STREAMED)
    fa_torch.flash_backward(q, k, v, o, lse, do, causal, 0.125,
                            fa_torch.STREAMED)
    assert [(n, src) for n, src, *_ in launches] == [
        ("flash_fwd_streamed", "flash_streamed"),
        ("flash_dq_streamed", "flash_streamed"),
        ("flash_dkv_streamed", "flash_streamed")]
    for _, _, ptrs, n_kv, tail in launches:
        assert n_kv == kvh
        assert tail == (fa_torch._DTYPE_CODES[torch.bfloat16], 0.125,
                        int(causal))
    # The work list is the last pointer, the only int32 one.
    lists = {n: [t for t in ptrs if t.dtype == torch.int32]
             for n, _, ptrs, _, _ in launches}
    (fwd_work,) = lists["flash_fwd_streamed"]
    (dq_work,) = lists["flash_dq_streamed"]
    (dkv_work,) = lists["flash_dkv_streamed"]
    assert all(work is launch[2][-1] for work, launch in
               zip((fwd_work, dq_work, dkv_work), launches))
    assert torch.equal(fwd_work, fa_torch.tri_schedule(
        "rows", b * h, s, tile=fa_torch.FWD_TILE, inner=fa_torch.FWD_TILE))
    assert torch.equal(dq_work, fa_torch.bwd_schedule("rows", b * h, s))
    assert torch.equal(dkv_work, fa_torch.bwd_schedule("cols", b * kvh, s))
    for work, n_rows, tile in ((fwd_work, b * h, fa_torch.FWD_TILE),
                               (dq_work, b * h, fa_torch.BWD_TILE),
                               (dkv_work, b * kvh, fa_torch.BWD_TILE)):
        assert sorted(map(tuple, work.tolist())) == [
            (r, t) for r in range(n_rows) for t in range(-(-s // tile))]
