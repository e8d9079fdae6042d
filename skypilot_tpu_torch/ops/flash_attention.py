"""Flash attention, forward and backward, as hand-written Hopper kernels.

Counterpart of ``skypilot_tpu/ops/pallas/flash_attention.py`` (its
resident family, which the JAX dispatcher picks at the training shapes:
``_fwd_kernel_resident``, ``_dq_kernel_resident`` and
``_dkv_kernel_resident``). Three CUDA kernels for sm_90a live in
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``:

* ``flash_fwd``: o = softmax(scale * q k^T, causal) v and the natural-log
  lse, (B, H, S) fp32;
* ``flash_dq``: dq = scale * sum_k (P * (dP - delta)) k, and delta =
  rowsum(dO * O), which it writes for the next kernel;
* ``flash_dkv``: dv = sum P^T dO and dk = scale * sum dS^T q, the GQA
  group summed in the kernel, no atomics.

Beside them stand their plain PyTorch versions, ``flash_fwd_plain`` and
``flash_bwd_plain``, written as the formulas; the CPU path runs them and
``chip_smoke.py`` holds the kernels against them on the card. Which one
runs depends only on where the tensors lie: a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build

NEG_INF = -1e30
# The kernels' tile: q, kv rows per block. S must be a multiple of it.
TILE = 64
HEAD_DIMS = (64, 128)
# JAX's default block, halved until it divides S: decides, as there, when
# a shape is too irregular for the kernel path (see flash_attention).
_JAX_DEFAULT_BLOCK = 1024

# Launch counts, one per kernel: each wrapper adds one where it launches.
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


# --------------------------------------------------------- kernel wrappers

def _strides(*tensors):
    vals = []
    for t in tensors:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_inputs(q, k, v, *rest):
    """Raise on what the kernels do not take: they read bf16 (B,S,H,D)
    rows through strides, 16-byte aligned, at S a multiple of TILE and
    head_dim 64 or 128."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (need H % KVH == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim {HEAD_DIMS}, got {d}")
    if s % TILE:
        raise ValueError(f"flash kernels take S a multiple of {TILE}, "
                         f"got {s}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's y limit")
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
            if t.dtype != torch.bfloat16:
                raise ValueError(f"flash kernels take bf16, got {t.dtype}")
            if (t.stride(3) != 1 or any(x % 8 for x in t.stride()[:3])
                    or t.data_ptr() % 16):
                raise ValueError("flash kernels need 16-byte aligned rows "
                                 f"with unit last stride; got strides "
                                 f"{t.stride()}")
        elif t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("lse/delta must be contiguous fp32 (B, H, S)")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel forward: (o (B,S,H,D) bf16, lse (B,H,S) fp32)."""
    _check_inputs(q, k, v)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_fwd")
    with torch.cuda.device(q.device):
        err = lib.stpu_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _strides(q, k, v), b, s, h, k.shape[2], d,
            float(scale), int(causal), _stream(q))
    _raise_on(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
             causal: bool, scale: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel dq: (dq (B,S,H,D) bf16, delta = rowsum(dO*O) (B,H,S) fp32)."""
    _check_inputs(q, k, v, o, do, lse)
    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_bwd")
    with torch.cuda.device(q.device):
        err = lib.stpu_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            _strides(q, k, v, o, do), b, s, h, k.shape[2], d, float(scale),
            int(causal), _stream(q))
    _raise_on(err, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq, delta


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel dk/dv: (dk, dv) (B,S,KVH,D) bf16, the GQA group summed."""
    _check_inputs(q, k, v, do, lse, delta)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    dk = torch.empty((b, s, kvh, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, kvh, d), dtype=v.dtype, device=q.device)
    lib = _build.library("flash_bwd")
    with torch.cuda.device(q.device):
        err = lib.stpu_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do), b, s, h, kvh, d, float(scale),
            int(causal), _stream(q))
    _raise_on(err, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


# ------------------------------------------------------------ autograd op

class _FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, o, lse) as the JAX package's ``_flash_vjp_fwd``
    does; the backward is the dq kernel then the dk/dv kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.is_cuda:
            o, lse = flash_fwd(q, k, v, causal, scale)
        else:
            o, lse = flash_fwd_plain(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        if do.is_cuda:
            do = do.contiguous()
            dq, delta = flash_dq(q, k, v, o, lse, do, causal, scale)
            dk, dv = flash_dkv(q, k, v, do, lse, delta, causal, scale)
        else:
            dq, dk, dv = flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
        return dq, dk, dv, None, None


def _fit_block(block: int, s: int) -> int:
    block = min(block, s)
    while block > 8 and s % block:
        block //= 2
    return block


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention. q: (B,S,H,D); k, v: (B,S,KVH,D).

    Irregular shapes go to the reference, exactly where the JAX package
    sends them (kv length != S, H % KVH != 0, d % 8 != 0, or no block of
    8k rows divides S). Any other shape the kernels do not take raises on
    CUDA (e.g. head_dim 256)."""
    b, s, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    block = _fit_block(_JAX_DEFAULT_BLOCK, s)
    if (k.shape[1] != s or s % block or h % k.shape[2] or block % 8
            or d % 8):
        from skypilot_tpu_torch.ops import attention as attention_ops
        return attention_ops.reference_attention(q, k, v, causal=causal,
                                                 scale=scale)
    return _FlashAttention.apply(q, k, v, causal, scale)
