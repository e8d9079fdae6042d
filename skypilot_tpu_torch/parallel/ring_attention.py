"""Ring attention: context parallelism over the ``sp`` mesh axis;
counterpart of ``skypilot_tpu/parallel/ring_attention.py``.

Each process of an ``sp`` group holds one contiguous chunk of the
sequence. It computes blockwise attention of its local queries against
the K/V chunk it currently holds, accumulates with an online softmax, and
passes K/V to the next process of the ring (``batch_isend_irecv``); after
``sp`` steps every query chunk has seen every K/V chunk. The JAX ring is
plain einsums, not a Pallas kernel, and so is this one: bf16 products
with fp32 accumulation (``bmm_f32``).

Autograd does not cross a send. ``_RingShift`` is the shift as an
autograd Function whose backward passes the K/V cotangents the other
way round the ring, so each chunk's gradient comes home. Each ring step's
chunk update is checkpointed, as the JAX body is: its score blocks are
recomputed in the backward, and a step keeps only its inputs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch.parallel import mesh as mesh_lib

_NEG_INF = -1e30

# KV sub-block width inside one ring chunk: bounds the live score
# matrix to (B, H, Sl, _KV_BLOCK) regardless of per-shard length.
_KV_BLOCK = 512
# Below this block width the loop's per-step cost dominates the product;
# chunk lengths with no divisor >= the floor take the pad-and-mask path.
_KV_BLOCK_FLOOR = 128


class _BmmF32(torch.autograd.Function):
    """Batched a @ b with inputs in their dtype and an fp32 result (the
    einsums' ``preferred_element_type=f32``); on the CPU the operands are
    upcast. The backward runs in the inputs' dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda and a.dtype != torch.float32:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = g @ b.transpose(1, 2) if ctx.needs_input_grad[0] else None
        db = a.transpose(1, 2) @ g if ctx.needs_input_grad[1] else None
        return da, db


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _BmmF32.apply(a, b)


def _chunk_update(q, kc, vc, qpos, kpos0, m, l, acc, *, causal, scale):
    """One online-softmax update of local queries against one KV chunk,
    blockwise over the chunk's KV axis.

    q: (B, Sl, H, D); kc/vc: (B, Sl, KVH, D); m/l: (B, H, Sl, 1) f32;
    acc: (B, H, Sl, D) f32; qpos (Sl,) the queries' absolute positions,
    kpos0 the chunk's absolute start. Grouped-query form: K/V stay at
    KVH heads, the group folds into the product's rows.
    """
    b, sl, h, d = q.shape
    kvh = kc.shape[2]
    groups = h // kvh
    # Largest divisor of the chunk length <= _KV_BLOCK (any divisor, not
    # only powers of two).
    n = kc.shape[1]
    block = max(dv for dv in range(1, min(_KV_BLOCK, n) + 1) if n % dv == 0)
    if block < _KV_BLOCK_FLOOR and n > block:
        # Prime / small-odd-factor chunk lengths: pad the chunk to a
        # multiple of _KV_BLOCK and mask the tail slots out below.
        block = min(_KV_BLOCK, n)
        pad = (-n) % block
        if pad:
            kc = F.pad(kc, (0, 0, 0, 0, 0, pad))
            vc = F.pad(vc, (0, 0, 0, 0, 0, pad))
    n_blocks = kc.shape[1] // block
    padded = kc.shape[1] != n
    # (B*KVH, G*Sl, D): row (g, i) of a KV head's group is query i of
    # head kv * G + g.
    qg = q.reshape(b, sl, kvh, groups, d).permute(0, 2, 3, 1, 4).reshape(
        b * kvh, groups * sl, d)
    for j in range(n_blocks):
        kcj = kc[:, j * block:(j + 1) * block]
        vcj = vc[:, j * block:(j + 1) * block]
        kt = kcj.permute(0, 2, 3, 1).reshape(b * kvh, d, block)
        s = (bmm_f32(qg, kt) * scale).reshape(b, h, sl, block)
        idx = j * block + torch.arange(block, device=q.device)
        if causal:
            mask = qpos[:, None] >= (kpos0 + idx)[None, :]
            if padded:
                mask = mask & (idx < n)[None, :]
            s = torch.where(mask[None, None], s, _NEG_INF)
        elif padded:
            s = torch.where((idx < n)[None, None, None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        vv = vcj.permute(0, 2, 1, 3).reshape(b * kvh, block, d)
        av = bmm_f32(p.to(vcj.dtype).reshape(b * kvh, groups * sl, block),
                     vv)
        acc = acc * alpha + av.reshape(b, h, sl, d)
        m = m_new
    return m, l, acc


def _exchange(tensors, dst: int, src: int, group):
    """Send ``tensors`` to global rank dst and receive their likes from
    src, as one batch of point-to-point ops. Batched, NCCL runs them on
    the group's communicator; one at a time, it would make a two-rank
    communicator per pair on first use, and around a ring every process
    would wait for its next one to join its pair first."""
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, src, group) for o in outs]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return outs


class _RingShift(torch.autograd.Function):
    """K/V to the next process of the ring, theirs from the previous one;
    the backward sends the cotangents back the other way."""

    @staticmethod
    def forward(ctx, kc, vc, group):
        ctx.group = group
        return tuple(_exchange((kc, vc), mesh_lib.group_peer(group, 1),
                               mesh_lib.group_peer(group, -1), group))

    @staticmethod
    def backward(ctx, dk, dv):
        group = ctx.group
        dk, dv = _exchange((dk, dv), mesh_lib.group_peer(group, -1),
                           mesh_lib.group_peer(group, 1), group)
        return dk, dv, None


def _step_fn(causal, scale):
    def step(q, kc, vc, qpos, kpos0, m, l, acc):
        return _chunk_update(q, kc, vc, qpos, kpos0, m, l, acc,
                             causal=causal, scale=scale)
    return step


def _init_carry(q):
    b, sl, h, d = q.shape
    m0 = torch.full((b, h, sl, 1), _NEG_INF, dtype=torch.float32,
                    device=q.device)
    l0 = torch.zeros((b, h, sl, 1), dtype=torch.float32, device=q.device)
    acc0 = torch.zeros((b, h, sl, d), dtype=torch.float32, device=q.device)
    return m0, l0, acc0


def _finish(q, l, acc):
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # (B, Sl, H, D)


def _ring_local(q, k, v, *, group, causal: bool, scale: float):
    idx, size = dist.get_rank(group), dist.get_world_size(group)
    sl = q.shape[1]
    qpos = idx * sl + torch.arange(sl, device=q.device)
    m, l, acc = _init_carry(q)
    update = _step_fn(causal, scale)
    kc, vc = k, v
    for step in range(size):
        chunk_idx = (idx - step) % size
        m, l, acc = checkpoint(update, q, kc, vc, qpos, chunk_idx * sl,
                               m, l, acc, use_reentrant=False)
        if step < size - 1:
            kc, vc = _RingShift.apply(kc, vc, group)
    return _finish(q, l, acc)


def ring_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                n_chunks: int, *, causal: bool = True,
                scale: Optional[float] = None) -> torch.Tensor:
    """The ring's arithmetic on one device: q/k/v (B, S, ...) cut into
    ``n_chunks`` chunks, each query chunk updated, checkpointed step by
    step, over the K/V chunks in the order ``_ring_local`` visits them
    (its own first, then each previous one). Equal to the ring on
    ``n_chunks`` processes; for checking the ring's math at full size
    where there is one card."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    sl = q.shape[1] // n_chunks
    update = _step_fn(causal, scale)
    outs = []
    for idx in range(n_chunks):
        qc = q[:, idx * sl:(idx + 1) * sl]
        qpos = idx * sl + torch.arange(sl, device=q.device)
        m, l, acc = _init_carry(qc)
        for step in range(n_chunks):
            c = (idx - step) % n_chunks
            m, l, acc = checkpoint(update, qc, k[:, c * sl:(c + 1) * sl],
                                   v[:, c * sl:(c + 1) * sl], qpos, c * sl,
                                   m, l, acc, use_reentrant=False)
        outs.append(_finish(qc, l, acc))
    return torch.cat(outs, dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, sp_axis: str = mesh_lib.SP, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Context-parallel attention.

    q: (B, Sl, H, D); k/v: (B, Sl, KVH, D): this process's chunk of the
    sequence, the ``sp_axis`` coordinate's, chunks contiguous. Falls back
    to the flash op when the mesh has no sp axis or it is 1.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    group = mesh_lib.axis_group(mesh, sp_axis)
    if group is None:
        from skypilot_tpu_torch.ops import attention as attention_ops
        return attention_ops.attention(q, k, v, causal=causal, scale=scale)
    return _ring_local(q, k, v, group=group, causal=causal, scale=scale)


def ring_attention_from_context(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """Model-side entrypoint: resolve the mesh from the ambient context
    installed by the trainer (``mesh_lib.use_mesh``)."""
    pair = mesh_lib.current_mesh_rules()
    if pair is None:
        raise RuntimeError(
            "attention_impl='ring' requires an ambient mesh: wrap the "
            "forward call in `with mesh_lib.use_mesh(mesh, rules): ...` "
            "(make_train_step does this automatically).")
    mesh, _ = pair
    return ring_attention(q, k, v, mesh=mesh)
