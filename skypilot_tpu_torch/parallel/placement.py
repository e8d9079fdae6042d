"""Parameters on a mesh, and the collectives the sharded model and step
issue: what XLA's SPMD partitioner inserts in the JAX package.

Storage. ``param_shardings`` gives each parameter of a model module its
``Sharding`` from the model's logical specs and a rule table;
``place_module`` turns the module's parameters into DTensors so placed
(each process holds its shard). A layer whose rules put it on ``pp``
lives on the mesh without ``pp`` (on a mesh of ``pp`` alone, a
one-process mesh: ``stage_mesh``), on its stage's processes only; the
other stages hold a meta placeholder of its shape (``pp_stage`` on the
parameter names the stage). ``gather_tensor`` is the inverse: the whole
tensor on every process.

Compute. ``compute_view`` is FSDP's gather-at-use: a DTensor parameter
redistributed to the layout the model computes with (replicated on every
axis but ``tp``, where a weight the layer consumes column- or row-split
stays split, and ``ep``, where an expert tensor stays split) and handed to the model as its local tensor. Its backward is
the reduce: the local gradient is declared partial over the data axes
(dp, fsdp, sp), so DTensor reduce-scatters it onto a sharded dim or
all-reduces it onto a replicated one. Called inside a layer's
checkpoint, the gather is repeated in the backward, and the gathered
weights live one layer at a time (FSDP's reshard after forward).
``group_copy`` and ``group_reduce`` are Megatron's f and g over any
group: around a layer's column- and row-split products over ``tp``, and
around the MoE's local experts over ``ep``.

The ``ep`` axis is expert parallelism. Its ranks hold the same tokens
(the batch is split over dp and fsdp only, as JAX's ``batch`` rule
does), like tp ranks: an expert tensor stored split over ``ep`` stays
split at use (each rank computes with its own experts, and the MoE sums
their outputs over ``ep``), and no gradient is summed over ``ep``: a
parameter replicated over it gets the same gradient on every ep rank.

The ``pp`` axis is left out of those reductions: the pipelined step sums
the gradients of the parameters every stage holds over ``pp`` after the
backward (``reduce_pp_grads``), in one fixed order on every process,
since the stages' backwards do not run in step.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel.mesh import (EP, PP, TP, Sharding,
                                             ShardingRules)

# The axis of a stage's one-process mesh on a mesh of pp alone
# (``stage_mesh``): no rule names it, so nothing is split over it.
LOCAL = "local"


def specs_by_name(module: nn.Module, specs: dict) -> Dict[str, tuple]:
    """Each parameter name of ``module`` (``layers.<i>.<name>`` for a
    layer weight) with its logical axes from a ``param_specs`` tree,
    whose ``layers`` entry applies to every layer; a parameter the tree
    does not name (a LoRA adapter) is replicated, all axes None."""
    out = {}
    for name, p in module.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers" and len(parts) == 3:
            spec = specs.get("layers", {}).get(parts[2])
        else:
            spec = specs.get(name)
        out[name] = tuple(spec) if spec is not None else (None,) * p.dim()
    return out


def layer_stage(rules: ShardingRules, mesh, layer: int,
                n_layers: int) -> Optional[int]:
    """The pipeline stage that holds ``layer`` when the rules put layers
    on a ``pp`` axis of more than one stage, else None."""
    axis = rules.resolve_axis("layers", mesh)
    if axis != PP or mesh_lib.axis_size(mesh, PP) == 1:
        return None
    stages = mesh_lib.axis_size(mesh, PP)
    if n_layers % stages:
        raise ValueError(f"n_layers={n_layers} not divisible by "
                         f"pp={stages}")
    return layer // (n_layers // stages)


def stage_mesh(mesh):
    """The mesh without its ``pp`` axis, through this process. On a mesh
    of ``pp`` alone a stage is one process: a one-process mesh whose axis
    (``LOCAL``) splits nothing, built once per mesh (its groups are made
    by every process together, as a DeviceMesh's are)."""
    rest = tuple(n for n in mesh.mesh_dim_names if n != PP)
    if rest:
        return mesh[rest]
    sub = getattr(mesh, "_stpu_stage_mesh", None)
    if sub is None:
        sub = DeviceMesh(mesh.device_type, mesh.mesh.reshape(-1, 1),
                         mesh_dim_names=(PP, LOCAL))[LOCAL]
        mesh._stpu_stage_mesh = sub
    return sub


def param_shardings(module: nn.Module, mesh, rules: ShardingRules,
                    specs: dict) -> Dict[str, Sharding]:
    """{parameter name: Sharding} for ``module`` under ``rules``."""
    n_layers = len(getattr(module, "layers", ()))
    out = {}
    for name, spec in specs_by_name(module, specs).items():
        parts = name.split(".")
        stage = (layer_stage(rules, mesh, int(parts[1]), n_layers)
                 if parts[0] == "layers" and len(parts) == 3 else None)
        if stage is None:
            out[name] = rules.sharding(spec, mesh)
        else:
            sub = stage_mesh(mesh)
            out[name] = Sharding(sub, rules.placements(spec, sub), stage)
    return out


def holds(sharding: Sharding, mesh) -> bool:
    """Whether this process holds a tensor of that sharding."""
    return (sharding.stage is None
            or sharding.stage == mesh_lib.axis_index(mesh, PP))


def _set(module: nn.Module, name: str, value) -> None:
    *path, attr = name.split(".")
    for part in path:
        module = getattr(module, part)
    setattr(module, attr, value)


@torch.no_grad()
def place_module(module: nn.Module, shardings: Dict[str, Sharding],
                 mesh) -> nn.Module:
    """Turn ``module``'s parameters into DTensors placed by
    ``shardings`` (``param_shardings``), in place; every process passes
    the same whole tensors, and each keeps its shard without any
    communication. Returns ``module``."""
    for name, p in list(module.named_parameters()):
        sh = shardings[name]
        if not holds(sh, mesh):
            new = nn.Parameter(torch.empty(p.shape, dtype=p.dtype,
                                           device="meta"),
                               requires_grad=p.requires_grad)
        else:
            t = p.full_tensor() if isinstance(p, DTensor) else p.detach()
            d = distribute_tensor(t, sh.mesh, sh.placements,
                                  src_data_rank=None)
            local = d.to_local()
            if local.untyped_storage().nbytes() > local.nbytes:
                # A shard that is a view of the whole tensor (a split on
                # dim 0) would keep the whole alive: keep a copy.
                d = DTensor.from_local(local.clone(), sh.mesh,
                                       sh.placements, shape=d.shape,
                                       stride=d.stride())
            new = nn.Parameter(d, requires_grad=p.requires_grad)
        if sh.stage is not None:
            new.pp_stage = sh.stage
        _set(module, name, new)
    return module


def gather_tensor(p: torch.Tensor, mesh=None) -> torch.Tensor:
    """The whole tensor of a placed parameter on every process: a
    DTensor's ``full_tensor``, and a stage's layer broadcast from that
    stage over ``pp`` (every process calls this in the same order)."""
    stage = getattr(p, "pp_stage", None)
    full = p.full_tensor() if isinstance(p, DTensor) else p
    if stage is None:
        return full.detach()
    group = mesh.get_group(PP)
    if full.is_meta:
        device = torch.device(mesh.device_type, torch.cuda.current_device()
                              ) if mesh.device_type == "cuda" else "cpu"
        full = torch.empty(p.shape, dtype=p.dtype, device=device)
    full = full.detach().contiguous()
    dist.broadcast(full, dist.get_global_rank(group, stage), group=group)
    return full


def compute_view(p: torch.Tensor, keep_tp: Optional[int] = None,
                 tp_partial: bool = False) -> torch.Tensor:
    """The tensor the model computes with (module docstring). A plain
    tensor is returned as it is. ``keep_tp``: the dim the layer consumes
    split over ``tp`` (kept split when the parameter is stored so);
    ``tp_partial``: the parameter is gathered over ``tp`` but each tp
    rank's use of it gives only part of its gradient (a key/value weight
    whose heads are fewer than the tp ranks; a LoRA adapter beside a
    split weight, whole or cut to the rank's part), so its gradient is
    summed over ``tp`` too."""
    if not isinstance(p, DTensor):
        return p
    compute, grad = [], []
    for name, pl in zip(p.device_mesh.mesh_dim_names, p.placements):
        if name == TP and keep_tp is not None and pl == Shard(keep_tp):
            compute.append(pl)
            grad.append(pl)
        elif name == TP:
            compute.append(Replicate())
            grad.append(Partial() if tp_partial else Replicate())
        elif name == EP:
            # Experts stay on their rank; ep ranks see the same tokens.
            keep = pl if pl.is_shard() else Replicate()
            compute.append(keep)
            grad.append(keep)
        elif name == PP:
            compute.append(Replicate())
            grad.append(Replicate())
        else:
            compute.append(Replicate())
            grad.append(Partial())
    return p.redistribute(p.device_mesh, compute).to_local(
        grad_placements=grad)


def tp_sharded(p: torch.Tensor, dim: int) -> bool:
    """Whether a parameter is stored split over a ``tp`` axis of more than
    one rank along ``dim``."""
    if not isinstance(p, DTensor):
        return False
    mesh = p.device_mesh
    for name, pl in zip(mesh.mesh_dim_names, p.placements):
        if name == TP and mesh_lib.axis_size(mesh, TP) > 1:
            return pl == Shard(dim)
    return False


class _GroupCopy(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GroupReduce(torch.autograd.Function):
    """Megatron's g: the partial results summed over the group, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def group_copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``group`` (None: no
    group, ``x`` itself): the input of work split over the group."""
    return x if group is None else _GroupCopy.apply(x, group)


def group_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (None: ``x`` itself), its gradient
    passed through: the output of work split over the group."""
    return x if group is None else _GroupReduce.apply(x, group)


def held_params(module: nn.Module) -> List[nn.Parameter]:
    """The parameters this process holds (not another stage's)."""
    return [p for p in module.parameters() if not p.is_meta]


def local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def reduce_pp_grads(params: Iterable[torch.Tensor], mesh) -> None:
    """Sum over ``pp`` the gradients of the parameters every stage holds
    (a zero one where a stage's graph did not reach it)."""
    group = mesh_lib.axis_group(mesh, PP)
    if group is None:
        return
    for p in params:
        if getattr(p, "pp_stage", None) is not None or not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(local(p.grad), group=group)


def global_norm(grads: List[torch.Tensor], mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares over all gradients, in fp32: each local
    shard's square sum is summed over the mesh axes that split it, and
    those of a stage's layers (on the mesh without ``pp``) over ``pp``.
    The value is the same on every process; every process of a stage
    passes gradients of the same layouts in the same order."""
    sums: dict = {}
    for g in grads:
        sq = torch.linalg.vector_norm(local(g), dtype=torch.float32
                                      ).square()
        m = g.device_mesh if isinstance(g, DTensor) else None
        dims = () if m is None else tuple(
            i for i, pl in enumerate(g.placements) if pl.is_shard())
        staged = (m is not None and mesh is not None and
                  PP not in m.mesh_dim_names and
                  mesh_lib.axis_size(mesh, PP) > 1)
        key = (id(m), dims)
        if key in sums:
            sums[key][3] = sums[key][3] + sq
        else:
            sums[key] = [m, dims, staged, sq]
    total, staged_total = 0.0, 0.0
    for m, dims, staged, s in sums.values():
        for d in dims:
            dist.all_reduce(s, group=m.get_group(d))
        if staged:
            staged_total = staged_total + s
        else:
            total = total + s
    if isinstance(staged_total, torch.Tensor):
        dist.all_reduce(staged_total, group=mesh.get_group(PP))
    return torch.as_tensor(total + staged_total).sqrt()
