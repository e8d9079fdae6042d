"""Multi-process bootstrap from the framework env contract: counterpart of
``skypilot_tpu/train/distributed.py``.

Recipes call ``initialize_from_env()``, which reads the SKYPILOT_*
variables the gang executor exports and brings up
``torch.distributed``: the coordinator (head host) is the rendezvous,
``tcp://<SKYPILOT_COORDINATOR_ADDR>``, whose TCP store also carries the
barriers and the key-value store below.

One process per card. The JAX package runs one process per host, which
drives all of that host's chips; torch runs one process per card. A gang
host with several cards therefore launches one process per card with
torchrun under the SKYPILOT_* env:

    torchrun --nproc-per-node <cards> -m skypilot_tpu_torch.recipes.llama_lora ...

torchrun sets ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (defaults 0 and 1
here, for a plain ``python`` launch), and a process's global rank is
``node_rank * local_world + local_rank`` over ``num_nodes *
local_world`` processes. Its card is ``cuda:<LOCAL_RANK>``, set as the
current device before the group is made; the group is NCCL on the card
and gloo on the CPU (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Optional
from urllib.parse import urlsplit

import numpy as np
import torch
import torch.distributed as dist

from skypilot_tpu_torch import DeviceLike, resolve_device

# The env contract (skypilot_tpu/agent/constants.py:11-22), defined once
# in the port.
NODE_RANK = "SKYPILOT_NODE_RANK"
NUM_NODES = "SKYPILOT_NUM_NODES"
COORDINATOR_ADDR = "SKYPILOT_COORDINATOR_ADDR"
NUM_SLICES = "SKYPILOT_NUM_SLICES"
NODE_IPS = "SKYPILOT_NODE_IPS"
# torchrun's per-node process layout.
LOCAL_RANK = "LOCAL_RANK"
LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"

# The group's TCP store (barrier, kv_put, kv_get), kept by
# initialize_from_env.
_STORE: Optional[dist.Store] = None


@dataclasses.dataclass(frozen=True)
class DistContext:
    rank: int
    num_nodes: int
    coordinator: Optional[str]
    initialized: bool      # init_process_group was called
    federated: bool        # the group spans processes
    world_size: int = 1    # processes in the group (num_nodes * local)
    local_rank: int = 0

    @property
    def is_multiprocess(self) -> bool:
        return self.world_size > 1


def initialize_from_env(timeout_ms: int = 120_000,
                        device: DeviceLike = None) -> DistContext:
    """Read the env contract and bring up torch.distributed.

    One process in all (one node and one process per node), or no
    coordinator address, returns an uninitialised context and everything
    proceeds single-process, as in the JAX package. Otherwise: global
    rank ``node_rank * local_world + local_rank``; the card
    ``cuda:<local rank>`` (``device`` None) with an NCCL group, or the
    CPU with a gloo group (``device="cpu"``); rendezvous and store at
    ``tcp://<coordinator>``; ``timeout_ms`` for both.
    """
    global _STORE
    node_rank = int(os.environ.get(NODE_RANK, "0"))
    num_nodes = int(os.environ.get(NUM_NODES, "1"))
    coordinator = os.environ.get(COORDINATOR_ADDR)
    local_rank = int(os.environ.get(LOCAL_RANK, "0"))
    local_world = int(os.environ.get(LOCAL_WORLD_SIZE, "1"))
    world = num_nodes * local_world
    rank = node_rank * local_world + local_rank
    if world <= 1 or not coordinator:
        return DistContext(rank=node_rank, num_nodes=num_nodes,
                           coordinator=coordinator, initialized=False,
                           federated=False)
    dev = resolve_device(device if device is not None
                         else f"cuda:{local_rank}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, port = _split_addr(coordinator)
    timeout = timedelta(milliseconds=timeout_ms)
    _STORE = dist.TCPStore(host, port, world_size=world,
                           is_master=rank == 0, timeout=timeout)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=_STORE, rank=rank, world_size=world,
                            timeout=timeout)
    return DistContext(rank=rank, num_nodes=num_nodes,
                       coordinator=coordinator, initialized=True,
                       federated=dist.get_world_size() > 1,
                       world_size=world, local_rank=local_rank)


def initialize_tp_group(*, host: int, tp_rank: int, tp: int, addr: str,
                        device: DeviceLike = None,
                        backend: Optional[str] = None,
                        timeout_s: float = 120.0) -> DistContext:
    """The process group of one host's ``tp`` ranks, the serving replica's
    tensor-parallel group (``serve/gang_replica.py``): a replica of
    ``hosts`` x ``tp`` processes runs one such group per host, each its
    process's default group, with its own TCP store at ``addr``
    (``host:port``; tp rank 0 serves it). The context's ``rank`` is the
    process's global rank ``host * tp + tp_rank``. ``backend`` defaults to
    NCCL on the card and gloo on the CPU; gloo also carries CUDA tensors,
    which two ranks sharing one card need (NCCL refuses them). Every
    collective of the group, and its rendezvous, time out after
    ``timeout_s``. ``destroy_group`` ends it; a gang restart then calls
    this again on a fresh port."""
    global _STORE
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL tp group needs the card, not the CPU")
    host_name, port = _split_addr(addr)
    timeout = timedelta(seconds=timeout_s)
    _STORE = dist.TCPStore(host_name, port, world_size=tp,
                           is_master=tp_rank == 0, timeout=timeout)
    dist.init_process_group(backend, store=_STORE, rank=tp_rank,
                            world_size=tp, timeout=timeout)
    return DistContext(rank=host * tp + tp_rank, num_nodes=1,
                       coordinator=addr, initialized=True,
                       federated=tp > 1, world_size=tp,
                       local_rank=tp_rank)


def destroy_group() -> None:
    """End this process's default group: an NCCL group is aborted first,
    so a collective still waiting on a dead peer returns instead of
    hanging until the timeout; gloo's already fails on the closed
    connection. Its store goes with it."""
    global _STORE
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.distributed_c10d._abort_process_group()
        else:
            dist.destroy_process_group()
    _STORE = None


def _split_addr(addr: str) -> tuple:
    parts = urlsplit("tcp://" + addr.removeprefix("tcp://"))
    if parts.hostname is None or parts.port is None:
        raise ValueError(f"{COORDINATOR_ADDR}={addr!r}: expected host:port")
    return parts.hostname, parts.port


def make_mesh_from_env(ici_axes, dcn_axis: str = "dp",
                       device: DeviceLike = None):
    """Mesh for the launched topology: multi-slice (SKYPILOT_NUM_SLICES
    > 1) gets a hybrid mesh with ``dcn_axis`` across slices (nodes);
    single-slice gets a plain mesh. Call after initialize_from_env()."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    num_slices = int(os.environ.get(NUM_SLICES, "1"))
    if num_slices > 1:
        return mesh_lib.make_multislice_mesh(ici_axes, num_slices,
                                             dcn_axis=dcn_axis,
                                             device=device)
    return mesh_lib.make_mesh(dict(ici_axes), device=device)


def _store() -> dist.Store:
    if _STORE is None:
        raise RuntimeError("torch.distributed is not initialized from the "
                           "env contract (initialize_from_env)")
    return _STORE


def barrier(name: str, timeout_ms: int = 120_000) -> None:
    """Cross-process barrier through the group's store."""
    store, key = _store(), f"barrier/{name}"
    if store.add(key, 1) == dist.get_world_size():
        store.set(key + "/done", "1")
    store.wait([key + "/done"], timedelta(milliseconds=timeout_ms))


def kv_put(key: str, value: str) -> None:
    _store().set(key, value)


def kv_get(key: str, timeout_ms: int = 120_000) -> str:
    store = _store()
    store.wait([key], timedelta(milliseconds=timeout_ms))
    return store.get(key).decode()


def _flatten(tree: Any, out: list) -> Any:
    """The tree's structure with each leaf replaced by its index in out."""
    if isinstance(tree, dict):
        return {k: _flatten(v, out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, out) for v in tree)
    out.append(tree)
    return len(out) - 1


def _unflatten(skeleton: Any, leaves: list) -> Any:
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_unflatten(v, leaves) for v in skeleton)
    return leaves[skeleton]


def kv_allreduce_mean(tree: Any, ctx: DistContext, tag: str,
                      timeout_ms: int = 120_000) -> Any:
    """Mean over processes of a pytree (dicts, lists, tuples) of numpy
    arrays or tensors, as one all-reduce of the leaves flattened to f32;
    each leaf comes back in its own type, dtype and device. A
    single-process context returns the tree itself. ``tag`` and
    ``timeout_ms`` are the JAX signature's; the group's own timeout
    bounds the all-reduce."""
    del tag, timeout_ms
    if not ctx.is_multiprocess:
        return tree
    leaves: list = []
    skeleton = _flatten(tree, leaves)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    flat = torch.cat([torch.as_tensor(np.asarray(x) if not isinstance(
        x, torch.Tensor) else x).detach().to(dev, torch.float32).reshape(-1)
        for x in leaves])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    out, off = [], 0
    for x in leaves:
        n = int(np.prod(np.shape(x)))
        part = flat[off:off + n].reshape(np.shape(x))
        off += n
        if isinstance(x, torch.Tensor):
            out.append(part.to(x.device, x.dtype))
        else:
            out.append(part.cpu().numpy().astype(np.asarray(x).dtype))
    return _unflatten(skeleton, out)
