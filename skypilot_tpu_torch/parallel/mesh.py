"""Device meshes and logical-axis sharding rules: counterpart of
``skypilot_tpu/parallel/mesh.py``.

A mesh is a ``torch.distributed.DeviceMesh`` with named axes, one process
(one card) per position; the rule table maps *logical* tensor axes
(batch, embed, heads, ...) onto mesh axes, and a parameter's layout is
one DTensor placement per mesh axis (``ShardingRules.placements``).
Where XLA inserts the collectives in the JAX package, the port's model
and trainer issue them: ``parallel/placement.py``.

Canonical mesh axes:
  dp    data parallel (pure replication of params, batch-sharded)
  fsdp  fully-sharded data parallel (batch- AND param-sharded)
  pp    pipeline stage axis
  tp    tensor (model) parallel axis
  sp    context/sequence parallelism for ring attention (long context)
  ep    expert parallel axis for MoE
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard

from skypilot_tpu_torch import DeviceLike, resolve_device

AxisName = Union[str, Sequence[str], None]

DP = "dp"
FSDP = "fsdp"
PP = "pp"
TP = "tp"
SP = "sp"
EP = "ep"


def _resolve_axis_sizes(axes: Mapping[str, int], n: int,
                        what: str = "device count") -> dict:
    """Resolve one optional -1 axis against `n` and validate the product
    (shared by the flat and hybrid mesh builders)."""
    sizes = dict(axes)
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError(f"At most one axis may be -1, got {unknown}")
    known = math.prod(v for v in sizes.values() if v != -1)
    if unknown:
        if n % known:
            raise ValueError(
                f"{what} {n} not divisible by fixed axes {sizes}")
        sizes[unknown[0]] = n // known
    if math.prod(sizes.values()) != n:
        raise ValueError(
            f"Mesh axes {sizes} do not multiply to {what} {n}")
    return sizes


def _ensure_group(device: DeviceLike) -> str:
    """The mesh's device type. A process with no group gets a world-1
    group here (NCCL on the card, gloo on the CPU), what ``make_mesh``
    of size 1 is in JAX on one chip; an existing group's backend decides
    otherwise."""
    if dist.is_initialized():
        if device is not None:
            return resolve_device(device).type
        return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return dev.type


def make_mesh(axes: Mapping[str, int],
              device: DeviceLike = None) -> DeviceMesh:
    """A mesh with the given named axis sizes over every process of the
    group (world 1 when there is none: ``_ensure_group``).

    Axis sizes must multiply to the process count; an axis size of -1 is
    inferred. Axis order follows insertion order of `axes`, and the last
    axis is the fastest: consecutive ranks differ in it, so put the
    fastest-communicating axis (tp/sp) last to keep it inside a node.
    """
    device_type = _ensure_group(device)
    sizes = _resolve_axis_sizes(axes, dist.get_world_size())
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def make_multislice_mesh(ici_axes: Mapping[str, int], num_slices: int,
                         dcn_axis: str = DP,
                         device: DeviceLike = None) -> DeviceMesh:
    """Hybrid mesh for multi-slice (multi-node) training: the leading
    ``dcn_axis`` spans slices, so its collectives cross nodes, while
    ``ici_axes`` stay inside one slice.

    Torch has no device coordinates: ranks are laid out node-major (a
    slice is a block of consecutive ranks, ``initialize_from_env``'s
    ``node_rank * local_world + local_rank``), and the mesh is that
    rank order reshaped to (num_slices, *ici sizes).
    """
    device_type = _ensure_group(device)
    n = dist.get_world_size()
    if num_slices < 1 or n % num_slices:
        raise ValueError(
            f"{n} devices not divisible into {num_slices} slices")
    per_slice = n // num_slices
    sizes = _resolve_axis_sizes(ici_axes, per_slice,
                                "per-slice device count")
    if dcn_axis in sizes:
        raise ValueError(f"dcn axis {dcn_axis!r} also named in ici_axes")
    return init_device_mesh(device_type,
                            (num_slices,) + tuple(sizes.values()),
                            mesh_dim_names=(dcn_axis,) + tuple(sizes))


def axis_names(mesh: Any) -> Tuple[str, ...]:
    """A mesh's axis names: a DeviceMesh's, or the keys of a {name: size}
    mapping (the rules below need names only, so they can be asked
    without a process group)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names)
    if isinstance(mesh, Mapping):
        return tuple(mesh)
    return tuple(mesh.axis_names)


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """Size of a mesh axis; 1 when the mesh is None or has no such axis."""
    if mesh is None or name not in axis_names(mesh):
        return 1
    if isinstance(mesh, Mapping):
        return mesh[name]
    return mesh.size(axis_names(mesh).index(name))


def axis_index(mesh: Optional[DeviceMesh], name: str) -> int:
    """This process's coordinate on a mesh axis (0 if absent)."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh: Optional[DeviceMesh], name: str):
    """The process group of a mesh axis, None when it has size 1."""
    if axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def group_peer(group, offset: int) -> int:
    """Global rank of the member ``offset`` places after this process in
    ``group`` (cyclic)."""
    me = dist.get_rank(group)
    return dist.get_global_rank(group, (me + offset) % dist.get_world_size(
        group))


class Sharding(NamedTuple):
    """Where a tensor lives: its mesh and one placement per mesh axis
    (``NamedSharding``'s counterpart). ``stage`` is the pipeline stage
    that holds it when the rules put its layer on ``pp``: then ``mesh``
    is the mesh without ``pp``, and other stages hold no copy."""
    mesh: Any
    placements: Tuple[Placement, ...]
    stage: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-axis -> mesh-axis mapping.

    Any logical axis not listed resolves to None (replicated). A mesh axis
    named in a rule but absent from the mesh is dropped at resolution time,
    so one rule set works across meshes of different shapes (e.g. the same
    FSDP+TP rules on a ('dp','tp') mesh simply ignore 'fsdp').
    """
    rules: Mapping[str, AxisName]

    def resolve_axis(self, logical: Optional[str], mesh: Any) -> AxisName:
        if logical is None:
            return None
        axis = self.rules.get(logical)
        if axis is None:
            return None
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        present = tuple(a for a in names if a in axis_names(mesh))
        if not present:
            return None
        return present if len(present) > 1 else present[0]

    def spec(self, logical_axes: Sequence[Optional[str]],
             mesh: Any) -> tuple:
        """The PartitionSpec's entries (None, an axis name or a tuple of
        them per tensor dim, trailing Nones dropped)."""
        resolved = []
        used: set = set()
        for la in logical_axes:
            axis = self.resolve_axis(la, mesh)
            # A mesh axis can shard at most one tensor dim; later dims fall
            # back to replicated rather than erroring (matches t5x behavior).
            flat = ((axis,) if isinstance(axis, str) else
                    tuple(axis) if axis else ())
            if any(a in used for a in flat):
                axis = None
                flat = ()
            used.update(flat)
            resolved.append(axis)
        while resolved and resolved[-1] is None:
            resolved.pop()
        return tuple(resolved)

    def placements(self, logical_axes: Sequence[Optional[str]],
                   mesh: Any) -> Tuple[Placement, ...]:
        """One DTensor placement per mesh axis, in mesh order: Shard(d)
        on each axis that ``spec`` puts on tensor dim d, else Replicate.
        A dim over several axes, ("dp", "fsdp"), is Shard(d) on each of
        them: DTensor splits it in mesh order, the row-major layout of
        JAX's P(("dp", "fsdp")); so such an entry must list its axes in
        mesh order."""
        names = axis_names(mesh)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec(logical_axes, mesh)):
            axes = (entry,) if isinstance(entry, str) else entry or ()
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"spec entry {entry} is not in the mesh's "
                                 f"axis order {names}")
            for i in order:
                out[i] = Shard(d)
        return tuple(out)

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 mesh: Any) -> Sharding:
        return Sharding(mesh, self.placements(logical_axes, mesh))


# Preset rule tables ---------------------------------------------------------

# Llama-class dense model, DP/FSDP/TP (+ megatron-SP via 'act_seq').
DEFAULT_RULES = ShardingRules(rules={
    # activations
    "batch": (DP, FSDP),
    "act_seq": SP,          # ring/context parallel shards the sequence
    "act_embed": None,
    "heads": TP,
    "kv_heads": TP,
    # params
    "embed": FSDP,
    "mlp": TP,
    "q_heads_x_dim": TP,
    "kv_heads_x_dim": TP,
    "vocab": TP,
    # MoE
    "expert": EP,
    # pipeline: a layer's stage
    "stage": PP,
    "layers": None,
})

# Pipelined runs put each layer on its stage's processes (the port's
# counterpart of sharding the stored (L, ...) layer stack over pp).
PIPELINE_RULES = ShardingRules(rules={**DEFAULT_RULES.rules, "layers": PP})


def constrain(x: torch.Tensor, mesh: DeviceMesh, rules: ShardingRules,
              logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """A DTensor redistributed to the rules' layout; any other tensor as
    it is (the port's activations are plain per-process tensors)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, rules.placements(logical_axes, mesh))


_AMBIENT = threading.local()


class use_mesh:
    """Context manager installing (mesh, rules) as the ambient pair.

    Trainers enter this around the model forward; the model reads it to
    take its sharded path (``models/llama.py``), and ring attention finds
    its ``sp`` axis there. Thread-local so concurrent steps for different
    meshes don't cross-talk.
    """

    def __init__(self, mesh: DeviceMesh, rules: ShardingRules):
        self.pair = (mesh, rules)

    def __enter__(self):
        if not hasattr(_AMBIENT, "stack"):
            _AMBIENT.stack = []
        _AMBIENT.stack.append(self.pair)
        return self.pair

    def __exit__(self, *exc):
        _AMBIENT.stack.pop()
        return False


def current_mesh_rules() -> Optional[tuple]:
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(a is None or isinstance(a, str)
                                        for a in s)


def tree_shardings(mesh: Any, rules: ShardingRules, specs_tree: Any) -> Any:
    """Map a tree (dicts, lists) of logical-axis tuples to Shardings."""
    if _is_spec(specs_tree):
        return rules.sharding(specs_tree, mesh)
    if isinstance(specs_tree, dict):
        return {k: tree_shardings(mesh, rules, v)
                for k, v in specs_tree.items()}
    return type(specs_tree)(tree_shardings(mesh, rules, v)
                            for v in specs_tree)
