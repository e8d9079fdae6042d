"""GPipe pipeline parallelism over the ``pp`` mesh axis: counterpart of
``skypilot_tpu/parallel/pipeline.py``.

The layer stack is split into ``pp`` stages, each held by the processes
of its ``pp`` coordinate; microbatches flow stage to stage in a GPipe
schedule of M + P - 1 ticks, stage s working on microbatch t - s at tick
t. The final stage's outputs then reach every ``pp`` process, as the JAX
pipeline's psum does.

Autograd does not cross a send, so the boundaries are autograd
Functions: ``_Recv`` (its backward sends the activation's cotangent back
to the previous stage) and ``_Send`` (its backward receives the
cotangent from the next stage). Each Function also takes and returns a
token, chaining a stage's receives and sends in microbatch order, and the
chain's last token joins the output: the backward then visits the sends
and the receives of every stage in the same order (last microbatch
first), which NCCL's in-order pairing needs. ``_Broadcast`` hands the
last stage's outputs to every stage; its backward sums the stages'
cotangents onto the last one.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from skypilot_tpu_torch.parallel import mesh as mesh_lib


class _Recv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, token, like, src, group, tag):
        ctx.src, ctx.group, ctx.tag = src, group, tag
        out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        dist.recv(out, src, group=group, tag=tag)
        return out, token.clone()

    @staticmethod
    def backward(ctx, g, g_token):
        dist.send(g.contiguous(), ctx.src, group=ctx.group, tag=ctx.tag)
        return g_token, None, None, None, None


class _Send(torch.autograd.Function):

    @staticmethod
    def forward(ctx, token, y, dst, group, tag):
        ctx.dst, ctx.group, ctx.tag = dst, group, tag
        dist.send(y.contiguous(), dst, group=group, tag=tag)
        ctx.like = torch.empty(y.shape, dtype=y.dtype, device=y.device)
        return token.clone()

    @staticmethod
    def backward(ctx, g_token):
        g = ctx.like
        del ctx.like
        dist.recv(g, ctx.dst, group=ctx.group, tag=ctx.tag)
        return g_token, g, None, None, None


class _Broadcast(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        x = x.contiguous().clone()
        dist.broadcast(x, src, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        if dist.get_rank() != ctx.src:
            g.zero_()
        return g, None, None


def gpipe(stage_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor],
          stage_params: Sequence[Any], x: torch.Tensor,
          extras: Optional[torch.Tensor] = None, *, mesh,
          pp_axis: str = mesh_lib.PP,
          num_microbatches: int) -> torch.Tensor:
    """Run a staged computation as a GPipe pipeline.

    Args:
      stage_fn: (stage's params, x_mb, extras_mb) -> y_mb, y_mb the same
        shape and dtype as x_mb (residual-stream contract).
      stage_params: one entry per stage; a process reads its own stage's
        only (the others may be placeholders).
      x: (M, mb, ...) microbatched activations, the same on every pp
        process.
      extras: per-microbatch side inputs (M, ...), passed to stage_fn but
        never sent between stages.
      num_microbatches: M. Pipeline bubble fraction is (P-1)/(M+P-1).
    """
    m_total = num_microbatches
    if extras is None:
        extras = torch.zeros(x.shape[0], device=x.device)
    group = mesh_lib.axis_group(mesh, pp_axis)
    if group is None:
        # No pipeline axis: every stage in turn, microbatch by microbatch.
        outs = []
        for i in range(m_total):
            y = x[i]
            for lp in stage_params:
                y = stage_fn(lp, y, extras[i])
            outs.append(y)
        return torch.stack(outs)

    n_stages = dist.get_world_size(group)
    s = dist.get_rank(group)
    prev = mesh_lib.group_peer(group, -1)
    nxt = mesh_lib.group_peer(group, 1)
    last = dist.get_global_rank(group, n_stages - 1)
    token = torch.zeros((), device=x.device,
                        requires_grad=torch.is_grad_enabled())
    outputs = [torch.zeros_like(x[0])] * m_total
    for t in range(m_total + n_stages - 1):
        m = t - s
        if not 0 <= m < m_total:
            continue
        x_in = x[m]
        if s > 0:
            x_in, token = _Recv.apply(token, x[m].detach(), prev, group,
                                      m)
        y = stage_fn(stage_params[s], x_in, extras[m])
        if s < n_stages - 1:
            token = _Send.apply(token, y, nxt, group, m)
        else:
            outputs[m] = y
    out = torch.stack(outputs) + token.to(x.dtype) * 0
    return _Broadcast.apply(out, last, group)
