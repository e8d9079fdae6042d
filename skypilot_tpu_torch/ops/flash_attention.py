"""Flash attention, forward and backward, as hand-written Hopper kernels.

Counterpart of ``skypilot_tpu/ops/pallas/flash_attention.py`` and of its
dispatch by family (``_use_resident``, ``_flash_fwd``, ``_flash_bwd``).
Three families of three CUDA kernels for sm_90a, all nine Hopper-native
(wgmma + TMA, one producer and two consumer warpgroups): every forward is
an instance of one body (``csrc/flash_fwd_sm90.cuh``), every dq and dk/dv
of the backward's (``csrc/flash_bwd_sm90.cuh``); the streamed instances
take what their long loops need (the forward overlaps each consumer's
softmax with its own products; dq holds Q and dO in registers and takes
the natural-log lse into exp2). Every kernel takes any S that is a
multiple of 8 (a ragged last tile is masked), head_dim 64 or 128, and
bf16 or f16 (one instance each); f32 inputs take three fp32 kernels of
their own (``csrc/flash_f32.cu``: ``flash_fwd_f32``, ``flash_dq_f32``,
``flash_dkv_f32``, every family's shapes, natural-log lse):

* the resident family (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), for
  ``_fwd_kernel_resident``, ``_dq_kernel_resident`` and
  ``_dkv_kernel_resident``, natural-log lse:

  - ``flash_fwd``: o = softmax(scale * q k^T, causal) v and the lse,
    (B, H, S) fp32;
  - ``flash_dq``: dq = scale * sum_k (P * (dP - delta)) k, and delta =
    rowsum(dO * O), which it writes for the next kernel;
  - ``flash_dkv``: dv = sum P^T dO and dk = scale * sum dS^T q, the GQA
    group summed in the kernel, no atomics;

* the triangular family (``csrc/flash_tri.cu``), for ``_fwd_kernel_tri``,
  ``_dq_kernel_tri`` and ``_dkv_kernel_tri``: the same three functions,
  causal only, in exp2 with a base-2 lse, over a host-built tile schedule
  (``tri_schedule``): ``flash_fwd_tri``, ``flash_dq_tri``,
  ``flash_dkv_tri``;

* the streamed family (``csrc/flash_streamed.cu``), for ``_fwd_kernel``,
  ``_dq_kernel`` and ``_dkv_kernel``: the same three functions with the
  resident family's conventions (natural-log lse, causal flag):
  ``flash_fwd_streamed``, ``flash_dq_streamed`` and ``flash_dkv_streamed``
  over the resident work lists.

``family`` picks one from the shape, as the JAX dispatcher does: the
resident family while 3 * S * D * 4 bytes fit its 6 MiB budget, the
triangular family for causal attention past it, the streamed family for
non-causal attention past it. The choice is made once per call in the
forward, on the caller's head_dim, and carried to the backward, so the
base-2 lse never meets a natural-log kernel.

On the card, ``flash_forward`` and ``flash_backward`` (and so the op)
bring any head_dim up to 128 to the kernels: head_dim is zero-padded to
the next kernel width (``kernel_head_dim``, ``pad_head_dim``; zero columns
change neither q k^T nor the lse, and the padded columns of o, dq, dk and
dv come out 0 and are sliced off by ``unpad_head_dim``). ``kernel_dtype``
names the kernels an input dtype reaches.

Beside each family stand its plain PyTorch versions (``flash_fwd_plain``
and ``flash_bwd_plain``; ``flash_fwd_tri_plain`` and
``flash_bwd_tri_plain``; ``flash_fwd_streamed_plain`` and
``flash_bwd_streamed_plain``), written as the formulas, the last two
families one KV head's query group at a time; the CPU path runs them and
``chip_smoke.py`` holds the kernels against them on the card. Which one
runs depends only on where the tensors lie: a CUDA tensor launches a
kernel or raises.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# q rows per CTA of the Hopper forward (csrc/flash_fwd_sm90.cuh kBM).
FWD_TILE = 128
# The Hopper backward (csrc/flash_bwd_sm90.cuh): rows of the resident tile
# a CTA owns (dq: q rows, dk/dv: kv rows; kBwdRows) and of the tiles its
# ring streams against it (dq: K/V, dk/dv: q/dO, the streamed dk/dv's
# too; kBwdTile).
BWD_TILE = 128
BWD_INNER = 64
# S must be a multiple of this: the JAX package only sends such S to its
# kernels (its blocks are multiples of 8), and the dk/dv kernels read lse
# and delta through a tensor map whose rows (4 * S bytes) a TMA copy needs
# 16-byte aligned.
SEQ_MULTIPLE = 8
HEAD_DIMS = (64, 128)
# The kernels' element types, by the code their C entries take.
_DTYPE_CODES = {torch.bfloat16: _build.DTYPES["bf16"],
                torch.float16: _build.DTYPES["f16"]}
# JAX's default block, halved until it divides S: decides, as there, when
# a shape is too irregular for the kernel path (see flash_attention).
_JAX_DEFAULT_BLOCK = 1024

# The JAX dispatcher's budget: the resident family stages 3 full-sequence
# fp32 tensors of (S, D) and is picked while they fit.
_RESIDENT_MAX_BYTES = 6 * 1024 * 1024
RESIDENT, TRIANGULAR, STREAMED = "resident", "triangular", "streamed"

# Launch counts, one per kernel: each wrapper adds one where it launches.
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
            "flash_fwd_tri": 0, "flash_dq_tri": 0, "flash_dkv_tri": 0,
            "flash_fwd_streamed": 0, "flash_dq_streamed": 0,
            "flash_dkv_streamed": 0, "flash_fwd_f32": 0, "flash_dq_f32": 0,
            "flash_dkv_f32": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _use_resident(s: int, d: int) -> bool:
    return 3 * s * d * 4 <= _RESIDENT_MAX_BYTES


def family(s: int, d: int, causal: bool) -> str:
    """The kernel family for sequence length ``s`` and head_dim ``d``, the
    JAX dispatcher's choice: resident within the budget, triangular for
    causal attention past it, streamed for non-causal attention past it."""
    if _use_resident(s, d):
        return RESIDENT
    return TRIANGULAR if causal else STREAMED


# ----------------------------------------------------------- plain versions

def masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  scale: float) -> torch.Tensor:
    """fp32 scale * q k^T as (B, KVH, G, Sq, Sk): query head h reads KV
    head h // G; the causal mask is ``tril(k=sk-sq)`` (q is the trailing
    window of kv)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, s, kvh, h // kvh, d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if causal:
        sk = k.shape[1]
        mask = torch.ones(s, sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - s)
        sc = sc.masked_fill(~mask, NEG_INF)
    return sc


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype, lse (B, H, S) fp32, natural log)."""
    b, s, h, d = q.shape
    sc = masked_scores(q, k, causal, scale)
    lse = torch.logsumexp(sc, dim=-1)                     # (b, kvh, g, s)
    p = torch.exp(sc - lse[..., None])
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, s, h, d).to(q.dtype), lse.reshape(b, h, s)


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the saved forward, in fp32, cast once at the end:
    P = exp(S - lse), dP = dO v^T, delta = rowsum(dO * O),
    dS = P * (dP - delta); dq = scale dS k, dk = scale sum_g dS^T q,
    dv = sum_g P^T dO (the sum over the query heads of each KV group)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    sc = masked_scores(q, k, causal, scale)
    p = torch.exp(sc - lse.reshape(b, kvh, g, s)[..., None])
    dof = do.float().reshape(b, s, kvh, g, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    delta = (dof * o.float().reshape(b, s, kvh, g, d)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    qf = q.float().reshape(b, s, kvh, g, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# Group-at-a-time plain versions (the triangular and streamed families):
# one KV head's query group at a time, so at most one group's (B, G, S, S)
# scores are live, in the family's softmax base: natural exp with a
# natural-log lse, or exp2 with a base-2 lse (scores times log2(e)).
_BASES = {"e": (torch.exp, torch.log, 1.0),
          "2": (torch.exp2, torch.log2, LOG2E)}


def _group_scores(q: torch.Tensor, k: torch.Tensor, j: int, causal: bool,
                  mul: float) -> torch.Tensor:
    """KV head j's query group's scores, fp32 (B, G, S, S): mul * q k^T,
    masked above the diagonal when causal."""
    s, h = q.shape[1], q.shape[2]
    g = h // k.shape[2]
    qg = q[:, :, j * g:(j + 1) * g].float()
    sc = torch.einsum("bqgd,bkd->bgqk", qg, k[:, :, j].float()) * mul
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~mask, NEG_INF)
    return sc


def _fwd_by_group(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float, base: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    exp, log, mul = _BASES[base]
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for j in range(kvh):
        hs = slice(j * g, (j + 1) * g)
        sc = _group_scores(q, k, j, causal, scale * mul)
        m = sc.amax(dim=-1, keepdim=True)
        lse_j = m + log(exp(sc - m).sum(dim=-1, keepdim=True))
        p = exp(sc - lse_j)
        del sc
        o[:, :, hs] = torch.einsum("bgqk,bkd->bqgd", p,
                                   v[:, :, j].float()).to(q.dtype)
        lse[:, hs] = lse_j[..., 0]
    return o, lse


def _bwd_by_group(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool, scale: float, base: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h = q.shape[2]
    kvh = k.shape[2]
    g = h // kvh
    exp, _, mul = _BASES[base]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for j in range(kvh):
        hs = slice(j * g, (j + 1) * g)
        p = exp(_group_scores(q, k, j, causal, scale * mul)
                - lse[:, hs, :, None])
        dof = do[:, :, hs].float()
        dp = torch.einsum("bqgd,bkd->bgqk", dof, v[:, :, j].float())
        delta = (dof * o[:, :, hs].float()).sum(-1)          # (b, s, g)
        ds = p * (dp - delta.permute(0, 2, 1)[..., None])
        del dp
        dq[:, :, hs] = (torch.einsum("bgqk,bkd->bqgd", ds,
                                     k[:, :, j].float()) * scale).to(q.dtype)
        dk[:, :, j] = (torch.einsum("bgqk,bqgd->bkd", ds,
                                    q[:, :, hs].float()) * scale).to(k.dtype)
        dv[:, :, j] = torch.einsum("bgqk,bqgd->bkd", p, dof).to(v.dtype)
    return dq, dk, dv


def flash_fwd_tri_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal (o in q's dtype, lse (B, H, S) fp32 in base 2), the
    triangular family's convention, one KV head's query group at a
    time."""
    return _fwd_by_group(q, k, v, True, scale, "2")


def flash_bwd_tri_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the triangular forward's (o, base-2 lse), fp32
    until the final cast: P = exp2(S2 - lse), dP = dO v^T, delta =
    rowsum(dO * O), dS = P * (dP - delta); dq = scale dS k, dk = scale
    sum_g dS^T q, dv = sum_g P^T dO. One KV head's group at a time."""
    return _bwd_by_group(q, k, v, o, lse, do, True, scale, "2")


def flash_fwd_streamed_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool, scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype, lse (B, H, S) fp32 in natural log), the streamed
    family's convention, one KV head's query group at a time."""
    return _fwd_by_group(q, k, v, causal, scale, "e")


def flash_bwd_streamed_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool, scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) from the streamed forward's (o, natural-log lse), as
    ``flash_bwd_plain`` computes them, one KV head's group at a time."""
    return _bwd_by_group(q, k, v, o, lse, do, causal, scale, "e")


# ------------------------------------------------ triangular tile schedule

def _tri_maps_row(nq: int, nk: int, block_q: int, block_k: int):
    """Row-major (qi, ki) pairs with any unmasked element:
    k_start <= q_start + block_q - 1 (the JAX package's enumeration)."""
    qs, ks = [], []
    for qi in range(nq):
        bound = min(nk - 1, (qi * block_q + block_q - 1) // block_k)
        for ki in range(bound + 1):
            qs.append(qi)
            ks.append(ki)
    return qs, ks


def _tri_maps_col(nq: int, nk: int, block_q: int, block_k: int,
                  n_heads: int):
    """Column-major (ki, hi, qi) triples for dk/dv: for each KV block,
    every query head's unmasked q blocks, consecutive."""
    kks, hhs, qqs = [], [], []
    for ki in range(nk):
        lo = (ki * block_k) // block_q
        for hi in range(n_heads):
            for qi in range(lo, nq):
                kks.append(ki)
                hhs.append(hi)
                qqs.append(qi)
    return kks, hhs, qqs


_SCHEDULES: Dict[tuple, torch.Tensor] = {}


def tri_schedule(kind: str, n_rows: int, s: int,
                 device: Optional[torch.device] = None, *, tile: int,
                 inner: int) -> torch.Tensor:
    """A causal work list, (n_rows * ceil(S / tile), 2) int32: one (row,
    tile) item per block. "rows": a row is b * H + h and a tile is a q
    tile walked against ``inner``-row KV tiles (the Hopper forwards at
    FWD_TILE against FWD_TILE, the Hopper dq at BWD_TILE against
    BWD_INNER). "cols": a row is b * KVH + kvh and a tile is a kv tile
    walked against ``inner``-row q tiles (the Hopper dk/dv at BWD_TILE
    against BWD_INNER). Items are sorted by how many tile pairs they
    compute, from the JAX package's own enumeration (``_tri_maps_row``,
    ``_tri_maps_col``) at these tiles, longest first across all rows.
    Built once per shape and device."""
    key = (kind, n_rows, s, str(device), tile, inner)
    work = _SCHEDULES.get(key)
    if work is not None:
        return work
    nt, ni = -(-s // tile), -(-s // inner)
    if kind == "rows":
        tiles, _ = _tri_maps_row(nt, ni, tile, inner)
    elif kind == "cols":
        tiles, _, _ = _tri_maps_col(ni, nt, inner, tile, 1)
    else:
        raise ValueError(f"unknown schedule {kind!r}")
    pairs = collections.Counter(tiles)
    items = sorted(((r, t) for t in range(nt) for r in range(n_rows)),
                   key=lambda it: -pairs[it[1]])
    work = torch.tensor(items, dtype=torch.int32, device=device)
    _SCHEDULES[key] = work
    return work


def bwd_schedule(kind: str, n_rows: int, s: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """The Hopper backward's work list (every dq, "rows" over B * H, and
    every dk/dv, "cols" over B * KVH): BWD_TILE-row tiles
    against BWD_INNER-row ones. One list serves both causal modes: it holds
    every (row, tile) once, and a non-causal launch's items all cost the
    same, so its order only matters when causal."""
    return tri_schedule(kind, n_rows, s, device, tile=BWD_TILE,
                        inner=BWD_INNER)


# ------------------------------------------- the kernels' types and widths

def kernel_dtype(dtype: torch.dtype) -> torch.dtype:
    """The element type of the kernels inputs of ``dtype`` reach: bf16 and
    f16 the Hopper kernels' instances of that type (f16 holds |x| <=
    65504: a larger input, output or gradient becomes inf, and values under
    6.1e-5 keep fewer bits), f32 the fp32 kernels (``flash_*_f32``; the
    Hopper kernels' 16-bit operands would round it: rounding q, k and v to
    f16 alone puts causal gradients past the JAX reference tests' 5e-3).
    Nothing is cast. Any other dtype raises."""
    if dtype in _DTYPE_CODES or dtype == torch.float32:
        return dtype
    raise ValueError(f"flash kernels take bf16, f16 or f32; got {dtype}")


def kernel_head_dim(d: int) -> int:
    """The kernel width head_dim ``d`` is zero-padded to: the least of
    HEAD_DIMS at or above it. Past 128 it raises: the dk/dv kernel keeps dk
    and dv (2 x d / 2 fp32 a thread) in registers beside S^T and dP^T,
    past the 255 a thread has at d = 256, and no kernel splits them yet."""
    for width in HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"flash kernels take head_dim up to {HEAD_DIMS[-1]}; "
                     f"no kernel for head_dim {d} (its dk/dv accumulators "
                     "do not fit in registers)")


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (..., d) with its last dimension zero-padded to ``width``, as
    a kernel takes it; ``t`` itself when d is the width."""
    if t.shape[-1] == width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def unpad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """A kernel output (..., width) as the caller's: its first ``d``
    columns (the padded ones are 0)."""
    if t.shape[-1] == d:
        return t
    return t[..., :d].contiguous()


# --------------------------------------------------------- kernel wrappers

def _strides(*tensors):
    vals = []
    for t in tensors:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    return (ctypes.c_longlong * len(vals))(*vals)


def kernel_shape_error(q_shape, k_shape) -> Optional[str]:
    """Why the kernels cannot take q of shape (B,S,H,D) with k and v of
    shape (B,S,KVH,D), or None when they can: H % KVH == 0, head_dim in
    HEAD_DIMS, S a positive multiple of SEQ_MULTIPLE, B*H within the
    grid's y limit."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return f"bad shapes q {tuple(q_shape)} k {tuple(k_shape)}"
    b, s, h, d = q_shape
    kvh = k_shape[2]
    if (k_shape[0], k_shape[1], k_shape[3]) != (b, s, d) or h % kvh:
        return (f"k/v {tuple(k_shape)} do not match q {tuple(q_shape)} "
                "(need H % KVH == 0)")
    if d not in HEAD_DIMS:
        return (f"flash kernels take head_dim {HEAD_DIMS}; no kernel for "
                f"head_dim {d}")
    if s <= 0 or s % SEQ_MULTIPLE:
        return f"flash kernels take S a multiple of {SEQ_MULTIPLE}, got {s}"
    if b * h > 65535:
        return f"B*H = {b * h} exceeds the grid's y limit"
    return None


def _check_inputs(q, k, v, *rest, dtypes=tuple(_DTYPE_CODES)):
    """Raise on what the kernels do not take: the shapes
    ``kernel_shape_error`` refuses, and anything but (B,S,H,D) tensors of
    one dtype of ``dtypes`` (the Hopper kernels': bf16, f16), rows 16-byte
    aligned with a unit last stride, on one CUDA device."""
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    err = kernel_shape_error(tuple(q.shape), tuple(k.shape))
    if err:
        raise ValueError(err)
    b, s, h, _ = q.shape
    for t in rest:  # o and dO as q; lse and delta (B, H, S)
        want = q.shape if t.dim() == 4 else (b, h, s)
        if t.shape != want:
            raise ValueError(f"saved tensor {tuple(t.shape)}, expected "
                             f"{tuple(want)}")
    for t in (q, k, v) + rest:
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash kernels need all tensors on one CUDA "
                             f"device; got {t.device}")
        if t.dim() == 4:
            if t.dtype not in dtypes or t.dtype != q.dtype:
                raise ValueError(f"these flash kernels take tensors of one "
                                 f"dtype of {dtypes}; got {t.dtype} beside "
                                 f"{q.dtype}")
            if (t.stride(3) != 1 or any(x % 8 for x in t.stride()[:3])
                    or t.data_ptr() % 16):
                raise ValueError("flash kernels need 16-byte aligned rows "
                                 f"with unit last stride; got strides "
                                 f"{t.stride()}")
        elif (t.dtype != torch.float32 or not t.is_contiguous()
              or t.data_ptr() % 16):
            raise ValueError("lse/delta must be contiguous, 16-byte aligned "
                             "fp32 (B, H, S)")


def _raise_on(err: int, name: str) -> None:
    # Codes from 10000 up are cuTensorMapEncodeTiled's CUresult + 10000.
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# Every C entry takes (pointers..., strides, B, S, H, KVH, D, tail...,
# stream); the tail is (dtype, scale, causal) for the resident and streamed
# families, (dtype, scale) for the causal-only triangular one, (scale,
# causal) for the fp32 kernels. The Hopper kernels take their work list as
# their last pointer.

def _launch(name: str, source: str, ptrs, strides, q, kvh: int,
            *tail) -> None:
    b, s, h, d = q.shape
    lib = _build.library(source)
    with torch.cuda.device(q.device):
        err = getattr(lib, f"stpu_{name}")(
            *(t.data_ptr() for t in ptrs), strides, b, s, h, kvh, d, *tail,
            _stream(q))
    _raise_on(err, name)
    LAUNCHES[name] += 1


def _fwd_call(name: str, source: str, q, k, v, causal, scale,
              scheduled: bool = False):
    _check_inputs(q, k, v)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    ptrs = [q, k, v, o, lse]
    if scheduled:
        ptrs.append(tri_schedule("rows", b * h, s, q.device, tile=FWD_TILE,
                                 inner=FWD_TILE))
    _launch(name, source, ptrs, _strides(q, k, v), q, k.shape[2],
            _DTYPE_CODES[q.dtype], float(scale), int(causal))
    return o, lse


def _dq_call(name: str, source: str, q, k, v, o, lse, do, causal, scale,
             scheduled: bool = False):
    _check_inputs(q, k, v, o, do, lse)
    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    ptrs = [q, k, v, o, do, lse, dq, delta]
    if scheduled:
        ptrs.append(bwd_schedule("rows", b * h, s, q.device))
    _launch(name, source, ptrs, _strides(q, k, v, o, do), q, k.shape[2],
            _DTYPE_CODES[q.dtype], float(scale), int(causal))
    return dq, delta


def _dkv_call(name: str, source: str, q, k, v, do, lse, delta, causal,
              scale, scheduled: bool = False):
    _check_inputs(q, k, v, do, lse, delta)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    dk = torch.empty((b, s, kvh, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, kvh, d), dtype=v.dtype, device=q.device)
    ptrs = [q, k, v, do, lse, delta, dk, dv]
    if scheduled:
        ptrs.append(bwd_schedule("cols", b * kvh, s, q.device))
    _launch(name, source, ptrs, _strides(q, k, v, do), q, kvh,
            _DTYPE_CODES[q.dtype], float(scale), int(causal))
    return dk, dv


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel forward (the Hopper forward over 128-row q tiles,
    longest first): (o (B,S,H,D) of q's dtype, lse (B,H,S) fp32)."""
    return _fwd_call("flash_fwd", "flash_fwd", q, k, v, causal, scale,
                     scheduled=True)


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
             causal: bool, scale: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel dq (the Hopper dq over 128-row q tiles, longest first): (dq
    (B,S,H,D) of q's dtype, delta = rowsum(dO*O) (B,H,S) fp32)."""
    return _dq_call("flash_dq", "flash_bwd", q, k, v, o, lse, do, causal,
                    scale, scheduled=True)


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel dk/dv (the Hopper dk/dv over 128-row kv tiles, longest
    first): (dk, dv) (B,S,KVH,D) of k's dtype, the GQA group summed."""
    return _dkv_call("flash_dkv", "flash_bwd", q, k, v, do, lse, delta,
                     causal, scale, scheduled=True)


def flash_fwd_streamed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed-family kernel forward (the Hopper forward over 128-row q
    tiles, longest first, each consumer's softmax overlapped with its own
    P V): (o (B,S,H,D) of q's dtype, lse (B,H,S) fp32 in natural log)."""
    return _fwd_call("flash_fwd_streamed", "flash_streamed", q, k, v, causal,
                     scale, scheduled=True)


def flash_dq_streamed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      causal: bool, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed-family kernel dq (the Hopper dq over 128-row q tiles,
    longest first, each consumer's Q and dO held in registers, exp2 on
    the natural-log lse): (dq (B,S,H,D) of q's dtype, delta =
    rowsum(dO*O) (B,H,S) fp32)."""
    return _dq_call("flash_dq_streamed", "flash_streamed", q, k, v, o, lse,
                    do, causal, scale, scheduled=True)


def flash_dkv_streamed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, causal: bool, scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed-family kernel dk/dv (the Hopper dk/dv body, the resident
    instance's, in lockstep, over 128-row kv tiles, longest first): (dk,
    dv) (B,S,KVH,D) of k's dtype, the GQA group summed."""
    return _dkv_call("flash_dkv_streamed", "flash_streamed", q, k, v, do,
                     lse, delta, causal, scale, scheduled=True)


def _tri_call(fn: str, ptrs, strides, work: torch.Tensor,
              scale: float) -> None:
    """Launch triangular kernel ``fn`` on (q, k, ...) = ``ptrs``."""
    q = ptrs[0]
    _launch(fn, "flash_tri", (*ptrs, work), strides, q, ptrs[1].shape[2],
            _DTYPE_CODES[q.dtype], float(scale))


def flash_fwd_tri(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangular-family kernel forward (the Hopper forward over 128-row
    q tiles, longest first), causal: (o (B,S,H,D) of q's dtype, lse
    (B,H,S) fp32 in base 2)."""
    _check_inputs(q, k, v)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    work = tri_schedule("rows", b * h, s, q.device, tile=FWD_TILE,
                        inner=FWD_TILE)
    _tri_call("flash_fwd_tri", (q, k, v, o, lse), _strides(q, k, v), work,
              scale)
    return o, lse


def flash_dq_tri(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangular-family kernel dq from the base-2 lse (the Hopper dq over
    128-row q tiles, longest first): (dq (B,S,H,D) of q's dtype, delta =
    rowsum(dO*O) (B,H,S) fp32)."""
    _check_inputs(q, k, v, o, do, lse)
    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    work = bwd_schedule("rows", b * h, s, q.device)
    _tri_call("flash_dq_tri", (q, k, v, o, do, lse, dq, delta),
              _strides(q, k, v, o, do), work, scale)
    return dq, delta


def flash_dkv_tri(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangular-family kernel dk/dv (the Hopper dk/dv over 128-row kv
    tiles, longest first): (dk, dv) (B,S,KVH,D) of k's dtype, the GQA
    group summed."""
    _check_inputs(q, k, v, do, lse, delta)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    dk = torch.empty((b, s, kvh, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, kvh, d), dtype=v.dtype, device=q.device)
    work = bwd_schedule("cols", b * kvh, s, q.device)
    _tri_call("flash_dkv_tri", (q, k, v, do, lse, delta, dk, dv),
              _strides(q, k, v, do), work, scale)
    return dk, dv


def flash_fwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 kernel forward, any family's shape: (o (B,S,H,D) fp32, lse
    (B,H,S) fp32 in natural log)."""
    _check_inputs(q, k, v, dtypes=(torch.float32,))
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("flash_fwd_f32", "flash_f32", (q, k, v, o, lse),
            _strides(q, k, v), q, k.shape[2], float(scale), int(causal))
    return o, lse


def flash_dq_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 causal: bool, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 kernel dq from the natural-log lse: (dq (B,S,H,D) fp32, delta =
    rowsum(dO*O) (B,H,S) fp32)."""
    _check_inputs(q, k, v, o, do, lse, dtypes=(torch.float32,))
    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("flash_dq_f32", "flash_f32", (q, k, v, o, do, lse, dq, delta),
            _strides(q, k, v, o, do), q, k.shape[2], float(scale),
            int(causal))
    return dq, delta


def flash_dkv_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 kernel dk/dv: (dk, dv) (B,S,KVH,D) fp32, the GQA group
    summed."""
    _check_inputs(q, k, v, do, lse, delta, dtypes=(torch.float32,))
    b, s, h, d = q.shape
    kvh = k.shape[2]
    dk = torch.empty((b, s, kvh, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, kvh, d), dtype=v.dtype, device=q.device)
    _launch("flash_dkv_f32", "flash_f32", (q, k, v, do, lse, delta, dk, dv),
            _strides(q, k, v, do), q, kvh, float(scale), int(causal))
    return dk, dv


# ------------------------------------------------------------ the op

def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float, fam: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) through family ``fam``: the kernel for CUDA tensors (q, k
    and v padded to its head_dim first, o sliced back; f32 tensors take the
    fp32 kernel, whatever the family), the plain version for CPU tensors.
    lse is in the family's base (natural log from the fp32 kernel; its
    backward reads it so)."""
    if not q.is_cuda:
        if fam == TRIANGULAR:
            return flash_fwd_tri_plain(q, k, v, scale)
        if fam == STREAMED:
            return flash_fwd_streamed_plain(q, k, v, causal, scale)
        return flash_fwd_plain(q, k, v, causal, scale)
    d, width = q.shape[3], kernel_head_dim(q.shape[3])
    q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    if kernel_dtype(q.dtype) == torch.float32:
        o, lse = flash_fwd_f32(q, k, v, causal, scale)
    elif fam == TRIANGULAR:
        o, lse = flash_fwd_tri(q, k, v, scale)
    elif fam == STREAMED:
        o, lse = flash_fwd_streamed(q, k, v, causal, scale)
    else:
        o, lse = flash_fwd(q, k, v, causal, scale)
    return unpad_head_dim(o, d), lse


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   causal: bool, scale: float, fam: str
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from a forward of family ``fam``: its dq kernel then
    its dk/dv kernel on CUDA (on the kernels' head_dim and element type, as
    in ``flash_forward``), its plain backward on the CPU."""
    if not do.is_cuda:
        if fam == TRIANGULAR:
            return flash_bwd_tri_plain(q, k, v, o, lse, do, scale)
        if fam == STREAMED:
            return flash_bwd_streamed_plain(q, k, v, o, lse, do, causal,
                                            scale)
        return flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
    d, width = q.shape[3], kernel_head_dim(q.shape[3])
    q, k, v, o, do = (pad_head_dim(t, width) for t in (q, k, v, o, do))
    do = do.contiguous()
    if kernel_dtype(q.dtype) == torch.float32:
        dq, delta = flash_dq_f32(q, k, v, o, lse, do, causal, scale)
        dk, dv = flash_dkv_f32(q, k, v, do, lse, delta, causal, scale)
    elif fam == TRIANGULAR:
        dq, delta = flash_dq_tri(q, k, v, o, lse, do, scale)
        dk, dv = flash_dkv_tri(q, k, v, do, lse, delta, scale)
    elif fam == STREAMED:
        dq, delta = flash_dq_streamed(q, k, v, o, lse, do, causal, scale)
        dk, dv = flash_dkv_streamed(q, k, v, do, lse, delta, causal, scale)
    else:
        dq, delta = flash_dq(q, k, v, o, lse, do, causal, scale)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, causal, scale)
    return tuple(unpad_head_dim(t, d) for t in (dq, dk, dv))


class _FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, o, lse) as the JAX package's ``_flash_vjp_fwd``
    does, and the family the forward picked: the backward reads it from
    there and never re-derives it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        fam = family(q.shape[1], q.shape[3], causal)
        o, lse = flash_forward(q, k, v, causal, scale, fam)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.family = causal, scale, fam
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.causal,
                                    ctx.scale, ctx.family)
        return dq, dk, dv, None, None


def _fit_block(block: int, s: int) -> int:
    block = min(block, s)
    while block > 8 and s % block:
        block //= 2
    return block


def takes_kernel_path(q_shape, k_shape) -> bool:
    """False for the irregular shapes the JAX package sends to its
    reference (kv length != S, H % KVH != 0, d % 8 != 0, or no block of
    8k rows divides S). Shapes are q's (B,S,H,D) and k's (B,Sk,KVH,D)."""
    _, s, h, d = q_shape
    block = _fit_block(_JAX_DEFAULT_BLOCK, s)
    return not (k_shape[1] != s or s % block or h % k_shape[2] or block % 8
                or d % 8)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention. q: (B,S,H,D); k, v: (B,S,KVH,D).

    Irregular shapes go to the reference, exactly where the JAX package
    sends them (``takes_kernel_path``); every other S reaches the kernels,
    ragged tails included. On CUDA:

    * head_dim: any multiple of 8 up to 128; it is zero-padded to 64 or 128
      for the kernels, the scale stays ``D ** -0.5`` of the caller's D, and
      the output and gradients are sliced back. Past 128 it raises
      (``kernel_head_dim``: e.g. head_dim 256).
    * dtype: bf16 and f16 run on the Hopper kernels' instances of that
      type (fp32 sums inside, outputs in the input type); f16 holds |x|
      <= 65504: an input, output or gradient past that becomes inf (and
      the results inf or NaN; nothing clips or checks it), and values
      under 6.1e-5 keep fewer bits. f32 runs on the fp32 kernels, exact to
      fp32 rounding and far slower than the 16-bit ones. Other dtypes
      raise (``kernel_dtype``).

    Nothing on the card falls back to the plain versions."""
    if scale is None:
        scale = q.shape[3] ** -0.5
    if not takes_kernel_path(q.shape, k.shape):
        from skypilot_tpu_torch.ops import attention as attention_ops
        return attention_ops.reference_attention(q, k, v, causal=causal,
                                                 scale=scale)
    return _FlashAttention.apply(q, k, v, causal, scale)
