"""The resident backward's work lists, and the rules by which the port's
flash attention (skypilot_tpu_torch.ops.flash_attention) brings any
head_dim up to 128 and bf16, f16 and f32 inputs to its kernels, against
the JAX package on the CPU.

The resident dq and dk/dv are the Hopper backward body's second instance
(csrc/flash_bwd.cu over csrc/flash_bwd_sm90.cuh, natural exp, the runtime
causal flag), walking the same work lists as the triangular pair in both
causal modes. What a CPU run can hold of that: that the lists, walked with
the kernels' loop bounds, compute every tile pair the JAX enumeration
needs exactly once, and that the sources instantiate the body. On the card
the op zero-pads head_dim to the kernels' 64 or 128, and f32 takes the
fp32 kernels; here the pad rule runs through the plain versions wrapped by
the op's own pad/slice functions, against JAX's flash_attention (Pallas in
interpret mode) at that head_dim. Inputs come from numpy with a seed.
Tolerances are the JAX tests' own: 2e-3 for outputs, 5e-3 for gradients
(f32 on both sides; the gap is summation order).
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.pallas import flash_attention as fa_jax
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import flash_attention as fa_torch

OUT_TOL = 2e-3
GRAD_TOL = 5e-3
_BT, _BI = fa_torch.BWD_TILE, fa_torch.BWD_INNER
_CSRC = pathlib.Path(fa_torch.__file__).resolve().parents[1] / "csrc"


def _ceil(a, b):
    return -(-a // b)


def _qkv(seed, b=2, s=128, h=4, kvh=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]


# ------------------------------------------------------------- work lists

def _dq_pairs(work, s, causal):
    """(row, q tile, kv tile) triples the dq CTAs compute: item (row, qt)
    walks the 64-row KV tiles below its causal bound (dq_cta's n_kt)."""
    n_all = _ceil(s, _BI)
    out = []
    for row, qt in work:
        n_kt = min(n_all, (qt + 1) * (_BT // _BI)) if causal else n_all
        out += [(row, qt, j) for j in range(n_kt)]
    return out


def _dkv_pairs(work, s, causal):
    """(row, kv tile, q tile) triples the dk/dv CTAs compute, per query
    head of the group: item (row, kt) walks the 64-row q tiles from its
    causal start (dkv_cta's i0)."""
    n_qt = _ceil(s, _BI)
    out = []
    for row, kt in work:
        i0 = kt * (_BT // _BI) if causal else 0
        out += [(row, kt, i) for i in range(i0, n_qt)]
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [2048, 1000, 200, 8192, 4136, 16384])
@pytest.mark.parametrize("kind", ["rows", "cols"])
def test_resident_work_lists_cover_every_tile_once(kind, s, causal):
    # The resident dq ("rows", over B * H) and dk/dv ("cols", over
    # B * KVH) walk bwd_schedule's list in both causal modes: every (row,
    # tile) once, and, with the kernels' loop bounds, every tile pair the
    # JAX enumeration needs (all of them when not causal) exactly once.
    # The streamed dk/dv walks the same "cols" list, at the streamed
    # family's lengths (8192, ragged 4136, 16384).
    n_rows = 3
    work = fa_torch.bwd_schedule(kind, n_rows, s).tolist()
    nt, ni = _ceil(s, _BT), _ceil(s, _BI)
    assert sorted(map(tuple, work)) == [(r, t) for r in range(n_rows)
                                        for t in range(nt)]
    if kind == "rows":
        got = _dq_pairs(work, s, causal)
        tiles, inner = fa_jax._tri_maps_row(nt, ni, _BT, _BI)
    else:
        got = _dkv_pairs(work, s, causal)
        tiles, _, inner = fa_jax._tri_maps_col(ni, nt, _BI, _BT, 1)
    if causal:
        want = [(r, t, i) for r in range(n_rows)
                for t, i in zip(tiles.tolist(), inner.tolist())]
    else:
        want = [(r, t, i) for r in range(n_rows) for t in range(nt)
                for i in range(ni)]
    assert len(got) == len(set(got))
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("kind,n_rows", [("rows", 2 * 32), ("cols", 2 * 8)])
def test_resident_lists_at_the_slice_shape(kind, n_rows):
    # At the training step's shape (2 x 2048, 32 heads, 8 KV heads): 1024
    # dq CTAs and 256 dk/dv CTAs, the heaviest causal items first.
    work = fa_torch.bwd_schedule(kind, n_rows, 2048).tolist()
    assert len(work) == n_rows * 2048 // _BT
    pairs = [len(_dq_pairs([it], 2048, True)) if kind == "rows"
             else len(_dkv_pairs([it], 2048, True)) for it in work]
    assert pairs == sorted(pairs, reverse=True)
    assert (pairs[0], pairs[-1]) == (32, 2)


@pytest.mark.parametrize("source,body", [
    ("flash_bwd.cu", "sm90::dq_cta<D, T, BaseE>"),
    ("flash_bwd.cu", "sm90::dkv_cta<D, T, BaseE>"),
    ("flash_tri.cu", "sm90::dq_cta<D, T, Base2>"),
    ("flash_tri.cu", "sm90::dkv_cta<D, T, Base2>"),
])
def test_backward_kernels_instantiate_the_hopper_body(source, body):
    # Both backward families are instances of flash_bwd_sm90.cuh's bodies
    # (the resident in natural exp, reading the resident forward's
    # natural-log lse; the triangular in base 2), at the tiles the wrappers
    # build their lists with (test_work_list_tiles_match_the_kernels);
    # the mma.sync resident tile bodies are gone.
    assert body in (_CSRC / source).read_text()
    common = (_CSRC / "flash_common.cuh").read_text()
    for gone in ("dq_tile", "dkv_tile", "dq_smem_bytes", "dkv_smem_bytes"):
        assert gone not in common


@pytest.mark.parametrize("tag,name", [("Bf16", "bf16"), ("F16", "f16")])
def test_dtype_codes_match_the_kernels(tag, name):
    # The wrappers pass an element type's code; the C entries dispatch on
    # the tags' kDtype.
    text = (_CSRC / "flash_common.cuh").read_text()
    got = re.search(rf"struct {tag} {{[^}}]*?kDtype = (\d+);", text, re.S)
    assert got is not None and int(got.group(1)) == _build.DTYPES[name]


def _c_kind(param):
    return ("ptr" if "*" in param else
            "float" if param.split()[0] == "float" else "int")


def _ctypes_kind(argtype):
    if argtype is _build.ctypes.c_float:
        return "float"
    return "int" if argtype is _build.ctypes.c_int else "ptr"


@pytest.mark.parametrize("source", sorted(_build.SIGNATURES))
def test_c_signatures_match_the_sources(source):
    # ctypes passes what SIGNATURES declares, whatever the C entry takes:
    # every extern "C" entry of a source is declared there, parameter by
    # parameter (pointer, int or float), and nothing else is.
    text = (_CSRC / f"{source}.cu").read_text()
    entries = {name: [p.strip() for p in params.split(",")]
               for name, params in re.findall(
                   r'extern "C" int (stpu_\w+)\(([^)]*)\)', text)}
    declared = _build.SIGNATURES[source]
    assert set(entries) == set(declared)
    for name, params in entries.items():
        assert [_c_kind(p) for p in params] == [
            _ctypes_kind(t) for t in declared[name]], name


# -------------------------------------------------------- the dtype rule

@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 0),
                                        (torch.float16, 1)])
def test_16_bit_inputs_reach_their_hopper_instance(dtype, code):
    # bf16 and f16 run as they are, each on its own instance of the Hopper
    # kernels (the code the C entries dispatch on).
    assert fa_torch.kernel_dtype(dtype) == dtype
    assert fa_torch._DTYPE_CODES[dtype] == code


def test_f32_inputs_reach_the_fp32_kernels(monkeypatch):
    # f32 is not rounded to a 16-bit type: it takes flash_*_f32 in every
    # family. On a CUDA tensor flash_forward / flash_backward call them;
    # spied here on CPU tensors that claim to be on the card.
    assert fa_torch.kernel_dtype(torch.float32) == torch.float32
    calls = []
    for name in ("flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32",
                 "flash_fwd", "flash_fwd_tri", "flash_fwd_streamed"):
        monkeypatch.setattr(fa_torch, name, lambda *a, _n=name: (
            calls.append(_n) or (a[0], a[0])))

    class OnCard(torch.Tensor):
        is_cuda = True

    q = torch.zeros(1, 64, 2, 16).as_subclass(OnCard)
    lse = torch.zeros(1, 2, 64)
    for fam in (fa_torch.RESIDENT, fa_torch.TRIANGULAR, fa_torch.STREAMED):
        calls.clear()
        o, _ = fa_torch.flash_forward(q, q, q, True, 0.25, fam)
        fa_torch.flash_backward(q, q, q, q, lse, q, True, 0.25, fam)
        assert calls == ["flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32"]
        assert o.shape[-1] == 16  # padded to 64 for the kernel, sliced back


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.int64,
                                   torch.bool])
def test_kernel_dtype_refuses(dtype):
    with pytest.raises(ValueError, match="bf16, f16 or f32"):
        fa_torch.kernel_dtype(dtype)


@pytest.mark.parametrize("wrapper", ["flash_fwd_f32", "flash_dq_f32",
                                     "flash_dkv_f32"])
def test_f32_wrappers_refuse_cpu_and_16_bit_tensors(wrapper):
    # A wrapper launches its kernel or raises: CPU tensors, and tensors of
    # another dtype than f32, never reach the fp32 kernels.
    q, k, v = map(torch.from_numpy, _qkv(6, s=64))
    lse = torch.zeros(2, 4, 64)
    args = {"flash_fwd_f32": (q, k, v, True),
            "flash_dq_f32": (q, k, v, q, lse, q, True),
            "flash_dkv_f32": (q, k, v, q, lse, lse, True)}[wrapper]
    for cast in (lambda t: t, lambda t: t.half() if t.dim() == 4 else t):
        with pytest.raises(ValueError):
            getattr(fa_torch, wrapper)(*map(cast, args[:-1]), args[-1],
                                       0.125)
    assert fa_torch.LAUNCHES[wrapper] == 0


# ------------------------------------------------------ the head_dim rule

@pytest.mark.parametrize("d,width", [(8, 64), (16, 64), (32, 64), (64, 64),
                                     (72, 128), (96, 128), (128, 128)])
def test_kernel_head_dim_pads_to_the_next_width(d, width):
    assert fa_torch.kernel_head_dim(d) == width
    assert fa_torch.kernel_shape_error((1, 256, 8, width),
                                       (1, 256, 2, width)) is None


@pytest.mark.parametrize("d", [136, 256])
def test_kernel_head_dim_refuses_past_128(d):
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        fa_torch.kernel_head_dim(d)


def _padded_plain(q, k, v, causal):
    """The CUDA path's arithmetic on the CPU: q, k, v zero-padded to the
    kernel width by the op's pad_head_dim, the plain forward and backward
    (of sum(o ** 2), the JAX tests' loss) at that width with the caller's
    scale, the outputs sliced back by unpad_head_dim. Returns (o, dq, dk,
    dv) and the padded results, whose extra columns must be exactly 0."""
    d = q.shape[3]
    width, scale = fa_torch.kernel_head_dim(d), d ** -0.5
    qp, kp, vp = (fa_torch.pad_head_dim(t, width) for t in (q, k, v))
    o_pad, lse = fa_torch.flash_fwd_plain(qp, kp, vp, causal, scale)
    o = fa_torch.unpad_head_dim(o_pad, d)
    do = fa_torch.pad_head_dim(2 * o, width)
    grads_pad = fa_torch.flash_bwd_plain(qp, kp, vp, o_pad, lse, do, causal,
                                         scale)
    grads = [fa_torch.unpad_head_dim(g, d) for g in grads_pad]
    return (o, *grads), (o_pad, *grads_pad)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 96])
def test_pad_rule_matches_jax(d, causal):
    q, k, v = _qkv(40 + d, d=d)

    def loss(q, k, v):
        return jnp.sum(fa_jax.flash_attention(q, k, v, causal=causal,
                                              block_q=64, block_k=64) ** 2)

    args = tuple(map(jnp.asarray, (q, k, v)))
    o_j = fa_jax.flash_attention(*args, causal=causal, block_q=64,
                                 block_k=64)
    g_j = jax.grad(loss, argnums=(0, 1, 2))(*args)
    got, padded = _padded_plain(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(o_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    for a, b in zip(got[1:], g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    # Zero columns change neither q k^T nor the lse: the padded columns of
    # o, dq, dk and dv are exactly 0.
    for t in padded:
        assert t.shape[-1] == fa_torch.kernel_head_dim(d)
        assert torch.count_nonzero(t[..., d:]) == 0


def test_family_is_decided_on_the_callers_head_dim(monkeypatch):
    # JAX's _use_resident sees the caller's d; so does the port's op,
    # whatever width the kernels pad it to. With a budget between 3 * S *
    # 16 * 4 and 3 * S * 64 * 4 bytes at S = 128, head_dim 16 is resident
    # and its padded 64 would not be.
    s, d, budget = 128, 16, 50_000
    monkeypatch.setattr(fa_jax, "_RESIDENT_MAX_BYTES", budget)
    monkeypatch.setattr(fa_torch, "_RESIDENT_MAX_BYTES", budget)
    assert fa_jax._use_resident(s, d) and not fa_jax._use_resident(s, 64)
    assert fa_torch.family(s, d, True) == fa_torch.RESIDENT
    assert fa_torch.family(s, fa_torch.kernel_head_dim(d), True) == (
        fa_torch.TRIANGULAR)
    seen = []
    real = fa_torch.flash_forward

    def spy(q, k, v, causal, scale, fam):
        seen.append(fam)
        return real(q, k, v, causal, scale, fam)

    monkeypatch.setattr(fa_torch, "flash_forward", spy)
    q, k, v = map(torch.from_numpy, _qkv(7, s=s, d=d))
    fa_torch.flash_attention(q, k, v, causal=True)
    assert seen == [fa_torch.RESIDENT]
