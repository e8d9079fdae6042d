"""Sequence parallelism without the ring: each process of an ``sp`` group
holds one contiguous chunk of the sequence, and attention alone sees the
whole of it. This is what XLA makes of the JAX package's layer when the
rules put ``act_seq`` on ``sp`` (``skypilot_tpu/parallel/mesh.py``) and
the attention is not the ring: the embedding, norms, projections, MLP
and loss run on the chunk, and the attention's inputs are gathered.

Forward: the roped q, k and v are all-gathered over ``sp`` into the
whole sequence, the attention runs there (the flash family picked on the
whole S, the causal mask the whole sequence's: the kernels take no query
offset) and this process keeps its rows of o. Backward: dO and the saved
rows are all-gathered, the backward runs on the whole sequence, and this
process keeps its rows of dq, dk and dv. Every process of the group
computes the whole attention from the same inputs, so those rows are
complete with no reduction. The attention runs sp times over, as XLA's
gather does: a cost of this layout, which the ring avoids
(``ring_attention.py``).

Only this process's rows are saved (q, k, v, o and the lse), and the
backward gathers them again: the memory of a saved layer stays that of
its chunk.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import flash_attention as flash_ops
from skypilot_tpu_torch.parallel import mesh as mesh_lib


def seq_chunk(mesh, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """This process's chunk of each (B, S, ...) tensor's sequence: the
    whole of it unless the mesh's ``sp`` > 1, where the S / sp rows at
    this process's ``sp`` coordinate (the sharded forwards' tokens and
    positions, the loss's targets)."""
    sp = mesh_lib.axis_size(mesh, mesh_lib.SP)
    if sp == 1:
        return tensors
    s = tensors[0].shape[1]
    if s % sp:
        raise ValueError(f"seq={s} not divisible by sp={sp}")
    c, sl = mesh_lib.axis_index(mesh, mesh_lib.SP), s // sp
    return tuple(t[:, c * sl:(c + 1) * sl] for t in tensors)


def gather_seq(t: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every process's chunk of ``t`` along ``dim``, in group order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def local_rows(t: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This process's chunk of a whole-sequence ``t`` along ``dim`` (a
    copy: it does not keep the whole alive)."""
    n = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * n, n).clone()


def flash_forward(q, k, v, causal: bool, scale: float, fam: str, group
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash op's forward half on the gathered sequence: this
    process's rows of (o, lse)."""
    o, lse = flash_ops.flash_forward(gather_seq(q, group),
                                     gather_seq(k, group),
                                     gather_seq(v, group), causal, scale, fam)
    return local_rows(o, group), local_rows(lse, group, dim=2)


def flash_backward(q, k, v, o, lse, do, causal: bool, scale: float,
                   fam: str, group
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash op's backward half on the gathered sequence from this
    process's rows of its inputs: this process's rows of (dq, dk, dv)."""
    whole = [gather_seq(t, group) for t in (q, k, v, o)]
    grads = flash_ops.flash_backward(*whole, gather_seq(lse, group, dim=2),
                                     gather_seq(do, group), causal, scale,
                                     fam)
    return tuple(local_rows(g, group) for g in grads)


class _GatheredAttention(torch.autograd.Function):
    """Attention of this process's query rows over the gathered sequence
    (module docstring). ``fam`` is the flash family (the kernels on CUDA,
    their plain versions on the CPU), or None for the reference
    attention, whose backward is its autograd on the whole sequence."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, scale: float,
                fam: Optional[str]):
        ctx.group, ctx.causal, ctx.scale, ctx.family = (group, causal,
                                                        scale, fam)
        if fam is None:
            ctx.save_for_backward(q, k, v)
            o = attention_ops.reference_attention(
                *(gather_seq(t, group) for t in (q, k, v)), causal=causal,
                scale=scale)
            return local_rows(o, group)
        o, lse = flash_forward(q, k, v, causal, scale, fam, group)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        group = ctx.group
        if ctx.family is not None:
            grads = flash_backward(*ctx.saved_tensors, do, ctx.causal,
                                   ctx.scale, ctx.family, group)
        else:
            with torch.enable_grad():
                whole = [gather_seq(t, group).requires_grad_()
                         for t in ctx.saved_tensors]
                o = attention_ops.reference_attention(
                    *whole, causal=ctx.causal, scale=ctx.scale)
                grads = torch.autograd.grad(o, whole, gather_seq(do, group))
            grads = [local_rows(g, group) for g in grads]
        return (*grads, None, None, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, *,
              causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """Attention of this process's chunk of the sequence (q (B, S/sp, H,
    D), k and v (B, S/sp, KVH, D)) over the whole sequence of ``group``.
    ``impl`` as ``ops.attention.attention``'s: the flash path where the
    whole sequence's shape takes it, else the reference."""
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "reference"
    if impl not in ("kernel", "reference"):
        raise ValueError(f"unknown attention impl {impl!r}; expected "
                         "'auto', 'kernel' or 'reference'")
    b, sl, h, d = q.shape
    s = sl * dist.get_world_size(group)
    fam = None
    if impl == "kernel" and flash_ops.takes_kernel_path(
            (b, s, h, d), (b, s, k.shape[2], d)):
        fam = flash_ops.family(s, d, causal)
    return _GatheredAttention.apply(q, k, v, group, causal, d ** -0.5, fam)


def sp_group_from_context():
    """The ``sp`` group of the ambient mesh (``mesh_lib.use_mesh``), None
    when there is none or it has one process."""
    pair = mesh_lib.current_mesh_rules()
    return None if pair is None else mesh_lib.axis_group(pair[0],
                                                         mesh_lib.SP)
