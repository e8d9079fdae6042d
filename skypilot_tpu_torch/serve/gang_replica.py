"""Multi-host and tensor-parallel serving: one replica = one gang of
processes. The port's counterpart of the JAX package's
``serve/gang_replica.py``, with the same topology contract, env names,
gang wire protocol, metrics, events and fault seam, so the JAX package's
controller, replica manager and load generator read the port's replicas
unchanged:

  * ``ReplicaTopology``: the per-replica slice shape declared in the
    service YAML (``replica_topology: {hosts: N, ici_axes: {tp: K}}``),
    carried replica-side in ``STPU_REPLICA_TOPOLOGY``;
  * ``TpGroup`` and ``build_mesh``: one host's ``tp`` ranks as a process
    group and a ``{"tp": K}`` DeviceMesh over it; ``shard_params`` places
    a tree by ``param_specs`` under ``DEFAULT_RULES`` (through
    ``convert.shard_params``) and returns the rank's serving tree
    (``TpParams``); ``cache_shardings`` gives a rank's local cache
    geometry;
  * ``GangLeader`` (host 0's rank 0): membership of every other process,
    the broadcast of admitted requests to the other hosts, /health, and
    the whole-gang restart under a capped fast-failure ladder;
  * ``follower_serve`` (every other host's tp rank 0) and
    ``tp_worker_serve`` (every tp rank but 0): the loops that run
    instead of HTTP.

How JAX's single-process tp maps onto one process per card. In JAX a
``--tp K`` replica is one process: GSPMD partitions one jitted step over
K chips and one scheduler drives them. In the port each card is a
process, and the model's collectives (``group_reduce`` after ``wo`` and
``w_down``, the vocab shards' sum and gather) run inside every layer, so
two ranks that schedule on their own would sooner or later call them on
different shapes. So, within a host's tp group, only tp rank 0 runs a
scheduler (the ``DecodeEngine`` with its pool, trie, host tier,
speculative drafting and supervisor). Before every model call it
broadcasts the call's plan over the group (``PlanChannel``, a gloo group
of its own): the entry point and its host values (tokens, positions,
valid lengths, block tables, write positions, logits_at, the sampling
temperatures and seeds). The other ranks run ``DecodeEngine.work``:
receive each plan and make exactly that call on their cache shard.
Host-tier spills and re-admits are plan entries too: each rank moves its
own shard. Every rank samples from the same whole logits (the vocab
shards' logits are all-gathered) with the same threefry keys, so every
rank's tokens are rank 0's; rank 0's are the ones it emits, and they
reach the other ranks as the next plan's inputs. This is the port's
counterpart of GSPMD's single program.

Across hosts (``hosts > 1``) JAX's semantics hold: each host's tp group
is a lockstep copy, as on JAX's non-federated platforms. Host 0's rank 0
is the ``GangLeader`` and fronts HTTP; every other host's rank 0 mirrors
the leader's broadcast admissions into its own group. The gang is ``hosts
x tp`` processes; global rank ``host * tp + tp_rank``. A tp group that
spans nodes (JAX's ICI-federated case) is not served: ``TpGroup`` joins
only a host's own ranks.

Membership covers every process: tp ranks connect to the leader's gang
channel and heartbeat as followers do. A dead process flips /health to
503 and drives the whole-gang restart: every member is killed and
respawned, and host 0's tp group is torn down (an NCCL group aborted, so
a survivor blocked in a collective returns) and rebuilt on a fresh store
port before its engine is rebuilt. In-flight requests end in
``EngineError``.

The KV cache under tp: each rank holds ``n_kv_heads / tp`` kv heads
when tp divides them, otherwise every rank holds the whole head its
query heads read (Gemma's single KV head; ``LayerView.kv_select``).
Where JAX splits such a cache on head_dim, the port keeps the whole
head: the numbers are equal, the bytes are not (each rank holds the full
single-head cache). The vocab projection is split over tp as JAX's rules
place it (a rank projects its vocab shard, then one all-gather of the
f32 logits a step), not gathered whole as training does: at Llama-3's
vocab the whole head would be 1.05 GB more on every rank.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import socket
import subprocess
import threading
import time
from datetime import timedelta
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from skypilot_tpu_torch import DeviceLike
from skypilot_tpu_torch.observability import events
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.train import distributed
from skypilot_tpu_torch.utils import fault_injection

# Env var carrying the replica's topology JSON from the replica manager
# to every host of the gang (next to SKYPILOT_SERVE_REPLICA_PORT).
TOPOLOGY_ENV = "STPU_REPLICA_TOPOLOGY"
# Where members find the leader's gang channel. Gang-launched hosts
# derive it (head ip from SKYPILOT_NODE_IPS + replica port + OFFSET);
# self-spawned dev members get it stamped explicitly.
GANG_ADDR_ENV = "STPU_GANG_SERVE_ADDR"
# The gang channel binds the replica's serving port + this offset on
# host 0.
GANG_PORT_OFFSET = 1
# A host's tp group rendezvous (``host:port``, served by its tp rank 0)
# and a process's rank in it: stamped on self-spawned ranks; a
# gang-launched host's ranks (torchrun: LOCAL_RANK) meet on their own
# host at the serving port + TP_PORT_OFFSET.
TP_ADDR_ENV = "STPU_TP_STORE_ADDR"
TP_RANK_ENV = "STPU_TP_RANK"
TP_PORT_OFFSET = 2
# Seconds every collective of a tp group (and its rendezvous) may take.
TP_TIMEOUT_SECONDS = 120.0

HEARTBEAT_SECONDS = float(os.environ.get("STPU_GANG_HB_SECONDS", "0.5"))
HEARTBEAT_TIMEOUT_SECONDS = float(
    os.environ.get("STPU_GANG_HB_TIMEOUT", "5"))
# Whole-gang restarts: this many consecutive FAST gang deaths (a member
# died within fast_failure_seconds of the gang coming up) leave the
# replica permanently unhealthy so the probe path replaces the gang.
MAX_GANG_RESTARTS = int(os.environ.get("STPU_GANG_MAX_RESTARTS", "3"))

_MEMBERS_ALIVE = metrics.gauge(
    "stpu_gang_members_alive",
    "Live hosts in this replica's serving gang (leader included).")
_GANG_RESTARTS = metrics.counter(
    "stpu_gang_restarts_total",
    "Whole-gang restarts after a member death.")
_GANG_UP = metrics.gauge(
    "stpu_gang_up",
    "1 while every gang member is alive; 0 while degraded/restarting.")


class GangError(RuntimeError):
    """Gang membership / topology failure."""


# ------------------------------------------------------------- topology
@dataclasses.dataclass(frozen=True)
class ReplicaTopology:
    """Per-replica slice shape: ``hosts`` gang members, ``ici_axes``
    named mesh axes over each host's cards (serving uses ``tp``)."""

    hosts: int = 1
    ici_axes: Mapping[str, int] = dataclasses.field(
        default_factory=dict)

    @property
    def tp(self) -> int:
        """Total model-parallel degree (product of the ICI axes)."""
        return int(math.prod(self.ici_axes.values())) or 1

    @property
    def is_sharded(self) -> bool:
        return self.hosts > 1 or self.tp > 1

    @property
    def processes(self) -> int:
        """The port's processes in the gang: one per card."""
        return self.hosts * self.tp

    def label(self) -> str:
        """``<hosts>x<tp>``: the topology tag metrics and loadgen
        reports attribute SLO shifts to."""
        return f"{self.hosts}x{self.tp}"

    @classmethod
    def from_config(cls, config: Optional[Mapping[str, Any]]
                    ) -> Optional["ReplicaTopology"]:
        """Parse and validate the ``replica_topology`` YAML block."""
        if not config:
            return None
        hosts = int(config.get("hosts", 1))
        axes = {str(k): int(v)
                for k, v in (config.get("ici_axes") or {}).items()}
        if hosts < 1:
            raise GangError(f"replica_topology.hosts must be >= 1, "
                            f"got {hosts}")
        for name, size in axes.items():
            if size < 1:
                raise GangError(
                    f"replica_topology.ici_axes.{name} must be >= 1, "
                    f"got {size}")
        return cls(hosts=hosts, ici_axes=axes)

    def to_config(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"hosts": self.hosts}
        if self.ici_axes:
            out["ici_axes"] = dict(self.ici_axes)
        return out

    @classmethod
    def from_env(cls) -> Optional["ReplicaTopology"]:
        raw = os.environ.get(TOPOLOGY_ENV)
        if not raw:
            return None
        try:
            return cls.from_config(json.loads(raw))
        except (ValueError, TypeError) as e:
            raise GangError(
                f"invalid {TOPOLOGY_ENV} JSON: {e}") from e

    def to_env_json(self) -> str:
        return json.dumps(self.to_config())


# ------------------------------------------------------------- tp group
class TpGroup:
    """One host's ``tp`` ranks as this process's default process group
    (``distributed.initialize_tp_group``), the ``{"tp": K}`` DeviceMesh
    over it and the gloo group the plans ride (``PlanChannel``).
    ``connect`` joins (every rank of the host calls it; the rendezvous
    waits for all of them); ``close`` tears it down, and a gang restart
    points ``addr`` at a fresh port before connecting again."""

    def __init__(self, *, tp: int, rank: int, addr: str, host: int = 0,
                 device: DeviceLike = None, backend: Optional[str] = None,
                 timeout_s: Optional[float] = None):
        if not 0 <= rank < tp:
            raise GangError(f"tp rank {rank} outside a group of {tp}")
        self.tp, self.rank, self.host = int(tp), int(rank), int(host)
        self.addr = addr
        self.device = device
        self.backend = backend
        self.timeout_s = (TP_TIMEOUT_SECONDS if timeout_s is None
                          else float(timeout_s))
        self.mesh = None
        self.plan_group = None

    @property
    def connected(self) -> bool:
        return self.mesh is not None

    def connect(self):
        """Join the host's group; returns the tp mesh."""
        from torch.distributed.device_mesh import init_device_mesh
        if self.connected:
            return self.mesh
        distributed.initialize_tp_group(
            host=self.host, tp_rank=self.rank, tp=self.tp, addr=self.addr,
            device=self.device, backend=self.backend,
            timeout_s=self.timeout_s)
        device_type = "cpu" if str(self.device) == "cpu" else "cuda"
        self.mesh = init_device_mesh(device_type, (self.tp,),
                                     mesh_dim_names=("tp",))
        # The plans' own group: gloo (host values, never the card), and
        # no timeout that an idle replica could reach between requests.
        self.plan_group = dist.new_group(backend="gloo",
                                         timeout=timedelta(days=365))
        _PLAN_GROUPS[id(self.mesh)] = self.plan_group
        return self.mesh

    def close(self) -> None:
        """Tear the group down (``distributed.destroy_group``)."""
        _PLAN_GROUPS.pop(id(self.mesh), None)
        self.mesh = None
        self.plan_group = None
        distributed.destroy_group()

    @classmethod
    def from_env(cls, topology: ReplicaTopology, *, host: int,
                 serving_port: int, device: DeviceLike = None,
                 backend: Optional[str] = None) -> "TpGroup":
        """This process's group: rank from STPU_TP_RANK (self-spawned) or
        LOCAL_RANK (torchrun on a gang-launched host), rendezvous at
        STPU_TP_STORE_ADDR, else on this host at the serving port +
        TP_PORT_OFFSET."""
        rank = int(os.environ.get(
            TP_RANK_ENV, os.environ.get(distributed.LOCAL_RANK, "0")))
        addr = os.environ.get(
            TP_ADDR_ENV, f"127.0.0.1:{int(serving_port) + TP_PORT_OFFSET}")
        if device is None and rank:
            device = f"cuda:{rank}"
        return cls(tp=topology.tp, rank=rank, addr=addr, host=host,
                   device=device, backend=backend)


def free_addr() -> str:
    """A ``127.0.0.1:<port>`` nothing listens on now: a self-spawned
    host's tp rendezvous (a fresh one at every gang restart)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


# The plan group of each mesh TpGroup.connect built, by the mesh's id.
_PLAN_GROUPS: Dict[int, Any] = {}


def plan_channel(mesh) -> "PlanChannel":
    """The plan channel of a tp mesh built by ``TpGroup.connect``."""
    group = _PLAN_GROUPS.get(id(mesh))
    if group is None:
        raise GangError("this mesh has no plan group: build it with "
                        "build_mesh / TpGroup.connect")
    return PlanChannel(group)


class PlanChannel:
    """Rank 0's plans to the other ranks of its tp group: one pickled
    object per model call, broadcast over the group's gloo plan group."""

    def __init__(self, group):
        self._group = group
        self._src = dist.get_global_rank(group, 0)

    def send(self, plan) -> None:
        dist.broadcast_object_list([plan], src=self._src,
                                   group=self._group)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=self._src, group=self._group)
        return box[0]


# -------------------------------------------------------- mesh building
def build_mesh(topology: ReplicaTopology,
               group: Optional[TpGroup] = None):
    """(mesh, rules) for the serving topology, or (None, None) for the
    unsharded tp=1 case. The mesh is ``group``'s (connected here when it
    is not yet): each host lays the same ``{"tp": K}`` axes over its own
    ranks, the identical-program half of the lockstep contract."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    if topology.tp <= 1:
        return None, None
    if group is None or group.tp != topology.tp:
        raise GangError(
            f"replica_topology tp={topology.tp} needs this host's tp group "
            f"(TpGroup with tp={topology.tp}), got {group}")
    return group.connect(), mesh_lib.DEFAULT_RULES


class TpParams:
    """A tp rank's serving tree: plain local tensors that the model's
    cache paths read like a parameter module's. ``layers`` are
    ``llama.LayerView``s (the rank's heads and MLP columns, int8 scales
    beside them, ``kv_select`` for a KV head fewer than the ranks); the
    embedding table and the head are the rank's vocab shard
    (``vocab_start`` on), which ``llama._decode_embed`` sums and
    ``llama._vocab_proj`` gathers over ``tp_group``."""

    def __init__(self, cfg, params, mesh, layers=None):
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        from skypilot_tpu_torch.parallel import placement
        tp = mesh_lib.axis_size(mesh, mesh_lib.TP)
        self.tp = tp
        self.layers = (layers if layers is not None else
                       [_layer_view(cfg, lp, mesh) for lp in params.layers])
        for name, dim in (("embed", 0), ("embed_scale", 0),
                          ("lm_head", 1), ("lm_head_scale", 0)):
            p = getattr(params, name, None)
            if p is not None and not placement.tp_sharded(p, dim):
                raise GangError(f"{name} is not split over tp on its vocab "
                                "axis")
            setattr(self, name,
                    None if p is None else _own(placement.local(p)))
        self.final_norm = _own(placement.local(params.final_norm))
        self.tp_rank = mesh_lib.axis_index(mesh, mesh_lib.TP)
        self.vocab_start = self.tp_rank * self.embed.shape[0]
        self.tp_group = mesh_lib.axis_group(mesh, mesh_lib.TP)

    def rebind(self, mesh) -> "TpParams":
        """Point the tree at a rebuilt group's mesh (a gang restart): the
        shards stay where they are, the collectives take the new group."""
        from skypilot_tpu_torch.parallel import mesh as mesh_lib
        group = mesh_lib.axis_group(mesh, mesh_lib.TP)
        self.tp_group = group
        for view in self.layers:
            view.tp_group = group
        return self


def _layer_view(cfg, layer, mesh):
    """A placed layer's ``LayerView`` with its shards in storage of their
    own."""
    from skypilot_tpu_torch.models import llama
    view = llama.LayerView(cfg, layer, mesh)
    if view.tp_group is None:
        raise GangError("a layer is not split over tp: place the tree with "
                        "shard_params")
    for n in view.param_names:
        setattr(view, n, _own(getattr(view, n)))
    return view


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t`` in storage of its own: a shard split on dim 0 is a view of
    the whole tensor, which it would otherwise keep alive."""
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        return t.clone()
    return t


def shard_params(cfg, params, mesh, rules) -> TpParams:
    """Place ``params`` by their logical ``param_specs`` under (mesh,
    rules) through ``convert.shard_params`` (in place: each rank keeps
    its shard) and return the rank's serving tree. An int8
    ``quantize_params`` tree (its ``embed_scale`` leaf) places by the
    quantized specs: codes shard like the weights they encode, scales
    ride their output channel's shard. Every rank passes the same whole
    tree; quantize before sharding (a row-split weight's scale reduces
    over all its rows)."""
    from skypilot_tpu_torch import convert
    from skypilot_tpu_torch.models import model_api
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    api = model_api(cfg)
    tp = mesh_lib.axis_size(mesh, mesh_lib.TP)
    if cfg.vocab_size % tp:
        raise GangError(f"vocab_size={cfg.vocab_size} not divisible by "
                        f"tp={tp}")
    specs = api.param_specs(cfg, quantized=api.params_quantized(params))
    convert.shard_params(params, mesh, rules, specs)
    return TpParams(cfg, params, mesh)


def shard_init(cfg, generator: torch.Generator, device: DeviceLike, mesh,
               rules, *, quantize: bool = False) -> TpParams:
    """A rank's serving tree drawn from ``generator`` as the family's
    ``init`` draws the whole tree (int8 with ``quantize``), equal to
    ``shard_params`` of that tree. Mixtral's tree is drawn a layer at a
    time, each layer sharded as soon as it is drawn, so a rank never
    holds more than one whole layer: Mixtral-8x7B is 93.4 GB in bf16,
    23.4 GB a rank at tp 4. The other families draw the whole tree (16 GB
    at Llama-3-8B) and shard it."""
    from skypilot_tpu_torch import convert
    from skypilot_tpu_torch.models import family_name, mixtral, model_api
    api = model_api(cfg)
    if family_name(cfg) != "mixtral":
        params = api.init(cfg, generator, device)
        if quantize:
            params = api.quantize_params(cfg, params)
        return shard_params(cfg, params, mesh, rules)
    specs = mixtral.param_specs(cfg, quantized=quantize)
    views = []

    def keep(i, layer):
        convert.shard_params(layer, mesh, rules, specs["layers"])
        views.append(_layer_view(cfg, layer, mesh))
        return mixtral.MixtralLayer(cfg, "meta", cfg.dtype)
    params = mixtral.init(cfg, generator, device, quantize=quantize,
                          layer_hook=keep)
    top = torch.nn.Module()
    for name in ("embed", "embed_scale", "final_norm", "lm_head",
                 "lm_head_scale"):
        if getattr(params, name, None) is not None:
            setattr(top, name, getattr(params, name))
    convert.shard_params(top, mesh, rules, specs)
    return TpParams(cfg, top, mesh, layers=views)


def local_kv_heads(cfg, tp: int) -> int:
    """KV heads a tp rank's cache holds: n_kv_heads / tp when tp divides
    them, else the one whole head its query heads read."""
    kvh = cfg.n_kv_heads
    if tp <= 1:
        return kvh
    if kvh % tp == 0:
        return kvh // tp
    if tp % kvh == 0:
        return 1
    raise GangError(f"n_kv_heads={kvh} neither divisible by nor dividing "
                    f"tp={tp}")


def cache_shardings(cfg, mesh, rules) -> Dict[str, Dict[str, Any]]:
    """Each cache leaf's local geometry on a rank of (mesh, rules): its
    logical spec (``cache_specs``, plus the int8 pool's
    ``k_scale``/``v_scale``), the kv heads the rank holds and how the
    leaf is split: ``"kv_heads"`` when tp divides n_kv_heads, else
    ``"whole_head"`` (every rank the whole head its queries read; JAX
    splits head_dim there: equal numbers, more bytes), None at tp 1."""
    from skypilot_tpu_torch.models import model_api
    specs = dict(model_api(cfg).cache_specs(cfg))
    specs.setdefault("k_scale", ("layers", None, "kv_heads"))
    specs.setdefault("v_scale", ("layers", None, "kv_heads"))
    axis = rules.resolve_axis("kv_heads", mesh) if mesh is not None \
        else None
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    tp = mesh_lib.axis_size(mesh, axis) if isinstance(axis, str) else 1
    kv = local_kv_heads(cfg, tp)
    split = (None if tp <= 1 else
             "kv_heads" if cfg.n_kv_heads % tp == 0 else "whole_head")
    return {name: {"spec": spec, "kv_heads": kv, "split": split}
            for name, spec in specs.items()}


# ------------------------------------------------------- wire protocol
def _send_line(sock_file, msg: Dict[str, Any]) -> None:
    sock_file.write((json.dumps(msg) + "\n").encode())
    sock_file.flush()


class _Member:
    __slots__ = ("rank", "pid", "role", "sock", "wfile", "last_hb",
                 "alive")

    def __init__(self, rank: int, pid: int, role: str, sock, wfile):
        self.rank = rank
        self.pid = pid
        self.role = role
        self.sock = sock
        self.wfile = wfile
        self.last_hb = time.monotonic()
        self.alive = True


class GangLeader:
    """Host 0's rank 0: membership, broadcast, restart.

    Its members are every other process of the gang: the other hosts'
    tp rank 0 (role ``follower``, mirroring broadcast admissions) and
    every tp rank but 0 (role ``tp``, running their rank 0's plans).
    ``spawn`` (optional) is a ``rank -> subprocess.Popen`` callable for
    the self-spawned dev gang (``serve_llm --replica-hosts N --tp K`` on
    one machine); gang-launched members are other machines' processes,
    owned by the gang driver, and the leader only flips health.
    ``teardown`` (optional) runs in a whole-gang restart after the
    members are killed and before they are respawned: host 0's tp group
    is torn down there, so the respawned ranks meet a fresh one, which
    ``engine_reset`` joins when it rebuilds host 0's engine."""

    def __init__(self, topology: ReplicaTopology, *, port: int = 0,
                 spawn: Optional[Callable[[int], Any]] = None,
                 engine_reset: Optional[Callable[[], None]] = None,
                 teardown: Optional[Callable[[], None]] = None,
                 hb_timeout: Optional[float] = None,
                 max_restarts: Optional[int] = None,
                 fast_failure_seconds: float = 30.0,
                 backoff_base: float = 0.5,
                 kv_config: Optional[Dict[str, Any]] = None):
        self.topology = topology
        # The KV geometry the leader's engine serves with, stamped into
        # every member's welcome: a member whose own differs dies at
        # join instead of falling out of lockstep mid-traffic.
        self.kv_config = dict(kv_config) if kv_config else None
        self._expected = max(topology.processes - 1, 0)
        self._spawn = spawn
        self._engine_reset = engine_reset
        self._teardown = teardown
        self._hb_timeout = (HEARTBEAT_TIMEOUT_SECONDS if hb_timeout is None
                            else float(hb_timeout))
        self.max_restarts = (MAX_GANG_RESTARTS if max_restarts is None
                             else int(max_restarts))
        self._fast = float(fast_failure_seconds)
        self._backoff_base = float(backoff_base)
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()  # serialize broadcasts
        self._members: Dict[int, _Member] = {}
        self._procs: Dict[int, Any] = {}
        # Membership is judged only once the gang has fully formed:
        # members joining one by one at startup is warm-up.
        self._armed = False
        self._degraded = False
        self._draining = False
        self._closed = False
        self.permanently_down = False
        self.restarts = 0
        self._consecutive = 0
        self._up_since = time.monotonic()
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", int(port)))
        self._listener.listen(max(self._expected, 1))
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="gang-accept").start()
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="gang-monitor")
        self._monitor_thread.start()
        _GANG_UP.set(1)

    # ---------------------------------------------------------- public
    def set_engine_reset(self, fn: Callable[[], None]) -> None:
        """Late-bind the host-0 engine rebuild hook (the engine
        supervisor is constructed after the leader)."""
        self._engine_reset = fn

    def set_teardown(self, fn: Callable[[], None]) -> None:
        """Late-bind the restart's host-0 teardown (it stops the engine
        the supervisor holds)."""
        self._teardown = fn

    def start_followers(self) -> None:
        """Self-spawn mode: launch every member process."""
        if self._spawn is None:
            return
        for rank in range(1, self.topology.processes):
            self._procs[rank] = self._spawn(rank)

    def wait_ready(self, timeout: float = 120.0) -> bool:
        """Block until every expected member has joined."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if (len([m for m in self._members.values() if m.alive])
                        >= self._expected):
                    self._up_since = time.monotonic()
                    self._armed = True
                    return True
            if self._closed:
                return False
            time.sleep(0.05)
        return False

    def healthy(self) -> bool:
        """True iff every gang member is alive RIGHT NOW: host 0's
        /health, so a dead member never hides behind a READY replica."""
        if self.permanently_down or self._closed:
            return False
        if self._degraded:
            return False
        with self._lock:
            alive = sum(1 for m in self._members.values() if m.alive)
        return alive >= self._expected

    def members_info(self) -> List[Dict[str, Any]]:
        out = [{"rank": 0, "pid": os.getpid(), "alive": True,
                "role": "leader"}]
        with self._lock:
            for rank in sorted(self._members):
                m = self._members[rank]
                out.append({"rank": m.rank, "pid": m.pid,
                            "alive": m.alive, "role": m.role})
        return out

    def broadcast_generate(self, prompt, max_tokens: int,
                           temperature: float, seed: int,
                           trace=None, resume=None) -> None:
        """Mirror one admitted request (and its sampling seed) to every
        follower host, so each host's group runs the identical
        submission; a resume admission rides the same message. Recorded
        as the request's ``gang.run`` hop when traced."""
        t0 = time.perf_counter()
        msg = {"op": "generate",
               "prompt": [int(t) for t in prompt],
               "max_tokens": int(max_tokens),
               "temperature": float(temperature),
               "seed": int(seed)}
        if resume:
            msg["resume"] = [int(t) for t in resume]
        if trace is not None:
            ctx = tracing.format_ctx(trace)
            if ctx:
                msg["trace"] = ctx
        self._broadcast(msg)
        if tracing.ENABLED and trace is not None and trace.sampled:
            tracing.record_span(
                "gang.run", "gang", trace, start_mono=t0,
                attrs={"hosts": self.topology.hosts,
                       "topology": self.topology.label()})

    def drain(self) -> None:
        """Propagate a replica drain to every follower host."""
        self._draining = True
        self._broadcast({"op": "drain"})

    def broadcast_restart(self) -> None:
        """Host 0's engine is being rebuilt (supervisor crash-restart):
        every follower host rebuilds too."""
        self._broadcast({"op": "restart"})

    def shutdown(self) -> None:
        """Tear the gang down: members get an explicit shutdown (and
        self-spawned ones a SIGTERM + reap): scale-down never orphans a
        member process."""
        self._closed = True
        self._broadcast({"op": "shutdown"})
        with self._lock:
            members = list(self._members.values())
            self._members.clear()
        for m in members:
            try:
                m.sock.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._reap(10.0)
        _GANG_UP.set(0)
        _MEMBERS_ALIVE.set(0)

    # -------------------------------------------------------- internals
    def _reap(self, grace: float) -> None:
        procs = list(self._procs.values())
        for proc in procs:
            if proc.poll() is None:
                try:
                    proc.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + grace
        for proc in procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    def _broadcast(self, msg: Dict[str, Any]) -> None:
        with self._lock:
            members = [m for m in self._members.values() if m.alive]
        with self._send_lock:
            for m in members:
                try:
                    _send_line(m.wfile, msg)
                except (OSError, ValueError):
                    m.alive = False

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_member,
                             args=(conn,), daemon=True).start()

    def _serve_member(self, conn) -> None:
        conn.settimeout(30.0)
        rfile = conn.makefile("rb")
        wfile = conn.makefile("wb")
        try:
            hello = json.loads(rfile.readline() or b"{}")
            if hello.get("op") != "hello":
                conn.close()
                return
        except (OSError, ValueError):
            conn.close()
            return
        member = _Member(int(hello.get("rank", -1)),
                         int(hello.get("pid", 0)),
                         str(hello.get("role", "follower")), conn, wfile)
        # The welcome goes out BEFORE the member is registered:
        # broadcasts only iterate registered members, so nothing else can
        # interleave bytes into this buffered wfile mid-welcome.
        welcome: Dict[str, Any] = {"op": "welcome",
                                   "hosts": self.topology.hosts}
        if self.kv_config is not None:
            welcome["kv"] = self.kv_config
        try:
            _send_line(wfile, welcome)
        except OSError:
            conn.close()
            return
        with self._lock:
            self._members[member.rank] = member
            alive = sum(1 for m in self._members.values() if m.alive)
        _MEMBERS_ALIVE.set(alive + 1)
        events.emit("gang_replica", f"rank-{member.rank}", "joined",
                    pid=member.pid, hosts=self.topology.hosts,
                    role=member.role)
        conn.settimeout(self._hb_timeout)
        while not self._closed:
            try:
                line = rfile.readline()
            except (OSError, ValueError):
                break
            if not line:
                break       # EOF: the member process died
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if msg.get("op") == "hb":
                member.last_hb = time.monotonic()
        member.alive = False

    def _alive_count(self) -> int:
        now = time.monotonic()
        with self._lock:
            n = 0
            for m in self._members.values():
                if m.alive and now - m.last_hb > self._hb_timeout:
                    m.alive = False    # hung, not just exited
                if m.alive:
                    n += 1
        return n

    def _monitor(self) -> None:
        """Membership watchdog: a member death flips health (503) and,
        when this leader owns the member processes, drives the
        whole-gang restart."""
        while not self._closed:
            time.sleep(0.1)
            if self._closed or self._draining:
                return
            if not self._armed:
                continue
            alive = self._alive_count()
            _MEMBERS_ALIVE.set(alive + 1)
            dead_procs = [r for r, p in self._procs.items()
                          if p.poll() is not None]
            if alive >= self._expected and not dead_procs:
                continue
            # Degraded: /health goes 503 FIRST, then the restart path.
            self._degraded = True
            _GANG_UP.set(0)
            fast = (time.monotonic() - self._up_since < self._fast)
            self._consecutive = self._consecutive + 1 if fast else 1
            events.emit("gang_replica", "gang", "member_lost",
                        alive=alive, expected=self._expected,
                        consecutive=self._consecutive)
            if self._consecutive > self.max_restarts:
                # Deterministic gang crash loop: stay down for good so
                # the probe path replaces the whole replica.
                self.permanently_down = True
                events.emit("gang_replica", "gang", "gang_down",
                            restarts=self.restarts)
                return
            if self._spawn is None:
                # Gang-launched: the gang driver and the replica manager
                # restart the gang from outside; stay degraded until the
                # members rejoin.
                self._await_rejoin()
                continue
            self._restart_gang()

    def _await_rejoin(self) -> None:
        while not self._closed and not self._draining:
            if self._alive_count() >= self._expected:
                if self._engine_reset is not None:
                    try:
                        self._engine_reset()
                    except Exception as e:  # noqa: BLE001 — a failed
                        # rebuild must not kill the monitor thread (the
                        # zombie-READY guard); the degraded gang retries.
                        events.emit("gang_replica", "gang",
                                    "engine_reset_failed",
                                    error=repr(e))
                        time.sleep(0.5)
                        continue
                self._degraded = False
                self._up_since = time.monotonic()
                _GANG_UP.set(1)
                events.emit("gang_replica", "gang", "recovered",
                            restarts=self.restarts)
                return
            time.sleep(0.1)

    def _restart_gang(self) -> None:
        """Whole-gang restart: every member is killed and respawned, host
        0's tp group torn down and rebuilt, and host 0's engine rebuilt:
        membership loss invalidates lockstep state on every process, so a
        partial restart would serve from desynchronized caches. (JAX
        rebuilds host 0's engine before respawning; here the rebuilt
        engine joins a group the respawned ranks must be in, so they
        come first.)"""
        delay = min(self._backoff_base * 2 ** (self._consecutive - 1),
                    30.0)
        deadline = time.monotonic() + delay
        while time.monotonic() < deadline:
            if self._closed or self._draining:
                return
            time.sleep(0.05)
        with self._lock:
            members = list(self._members.values())
            self._members.clear()
        for m in members:
            try:
                m.sock.close()
            except OSError:
                pass
        self._reap(10.0)
        try:
            if self._teardown is not None:
                self._teardown()
            for rank in range(1, self.topology.processes):
                self._procs[rank] = self._spawn(rank)
            if self._closed:
                self._reap(10.0)    # shutdown() landed meanwhile
                return
            if self._engine_reset is not None:
                self._engine_reset()
        except Exception as e:  # noqa: BLE001 — a failed rebuild counts
            # as another fast failure next tick, not a dead monitor.
            events.emit("gang_replica", "gang", "engine_reset_failed",
                        error=repr(e))
            return
        if self.wait_ready(timeout=60.0):
            self._degraded = False
            self.restarts += 1
            _GANG_RESTARTS.inc()
            _GANG_UP.set(1)
            events.emit("gang_replica", "gang", "restarted",
                        attempt=self._consecutive)
        # else: the next monitor tick counts another failure.


# ------------------------------------------------------------ members
def follower_addr(port: int) -> str:
    """Where a member finds the leader's gang channel: explicit
    STPU_GANG_SERVE_ADDR (self-spawn), else the head host's ip from the
    gang env contract + the serving port + offset."""
    explicit = os.environ.get(GANG_ADDR_ENV)
    if explicit:
        return explicit
    ips = (os.environ.get(distributed.NODE_IPS) or "").splitlines()
    if not ips:
        raise GangError(
            f"no {GANG_ADDR_ENV} and no {distributed.NODE_IPS}: a "
            "member host needs the gang env contract to find host 0")
    return f"{ips[0]}:{int(port) + GANG_PORT_OFFSET}"


def _drain_request(req) -> None:
    try:
        for _ in req.stream(timeout=600.0):
            pass
    except Exception:  # noqa: stpu-except — follower mirrors discard tokens; request-level failures surface on host 0
        pass


def _connect(addr: str, rank: int, role: str, connect_timeout: float):
    """Connect to the leader's channel and say hello; (sock, rfile,
    wfile)."""
    host, port_s = addr.rsplit(":", 1)
    deadline = time.monotonic() + connect_timeout
    sock = None
    while time.monotonic() < deadline:
        try:
            sock = socket.create_connection((host, int(port_s)),
                                            timeout=5.0)
            break
        except OSError:
            time.sleep(0.2)
    if sock is None:
        raise GangError(f"{role} rank {rank}: leader at {addr} "
                        f"unreachable for {connect_timeout:.0f}s")
    sock.settimeout(None)
    rfile = sock.makefile("rb")
    wfile = sock.makefile("wb")
    _send_line(wfile, {"op": "hello", "rank": rank, "pid": os.getpid(),
                       "role": role})
    return sock, rfile, wfile


def _heartbeat(wfile, rank: int, stop: threading.Event) -> None:
    while not stop.is_set():
        try:
            _send_line(wfile, {"op": "hb", "rank": rank})
        except (OSError, ValueError):
            stop.set()
            return
        stop.wait(HEARTBEAT_SECONDS)


def _kv_mismatch(msg: Dict[str, Any], kv_config, rank: int) -> bool:
    leader_kv = msg.get("kv")
    if (leader_kv is not None and kv_config is not None
            and dict(leader_kv) != dict(kv_config)):
        events.emit("gang_replica", f"rank-{rank}", "kv_config_mismatch",
                    leader=leader_kv, local=dict(kv_config))
        return True
    return False


def follower_serve(engine_factory: Callable[[], Any], topology:
                   ReplicaTopology, addr: str, rank: int,
                   connect_timeout: float = 60.0,
                   kv_config: Optional[Dict[str, Any]] = None) -> int:
    """The lockstep loop another host's tp rank 0 runs instead of HTTP.

    Connects to the leader's gang channel, heartbeats, and mirrors every
    broadcast: ``generate`` submits into the local engine (tokens
    discarded: host 0 owns the client stream; under tp the engine drives
    its host's group), ``drain`` stops admissions, ``restart`` rebuilds
    the engine with fresh state, ``shutdown``/EOF exits, so no
    scale-down or crash-restart can orphan this process. Returns the
    process exit code.

    ``kv_config`` is this host's KV geometry: when both sides declare
    one, the leader's welcome is cross-checked and a mismatch kills the
    follower at once (differently sized pools would make admission
    backpressure, and so slot state, diverge across the gang)."""
    sock, rfile, wfile = _connect(addr, rank, "follower", connect_timeout)
    engine = engine_factory()
    engine.start()
    stop = threading.Event()

    # SIGTERM (teardown / gang cancel) drains through the same clean-exit
    # path as a leader shutdown: shutting the socket down makes the
    # blocked readline return.
    def _on_term(*_a):
        stop.set()
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _on_term)

    threading.Thread(target=_heartbeat, args=(wfile, rank, stop),
                     daemon=True, name="gang-heartbeat").start()
    events.emit("gang_replica", f"rank-{rank}", "follower_up",
                leader=addr)
    rc = 0
    try:
        while not stop.is_set():
            try:
                line = rfile.readline()
            except (OSError, ValueError):
                break       # socket shut down (SIGTERM) or torn
            if not line:
                break           # leader gone: die with the gang
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            op = msg.get("op")
            if op == "welcome":
                if _kv_mismatch(msg, kv_config, rank):
                    rc = 1
                    break
                continue
            # Deterministic follower chaos (tests): the seam
            # host_wrapper fires post-barrier in the JAX package, so one
            # STPU_FAULTS grammar kills a gang member either way.
            if fault_injection.ENABLED:
                fault_injection.fire("gang.host", rank=rank, op=op)
            if op == "generate":
                try:
                    req = engine.submit(
                        msg["prompt"],
                        max_tokens=msg["max_tokens"],
                        temperature=msg.get("temperature", 0.0),
                        seed=msg.get("seed", 0),
                        trace=tracing.parse_ctx(msg.get("trace")),
                        resume=msg.get("resume"))
                except Exception:  # noqa: stpu-except — the leader's own submit failed identically and answered the client; the mirror must not die over it
                    continue
                threading.Thread(target=_drain_request, args=(req,),
                                 daemon=True).start()
            elif op == "drain":
                engine.drain()
            elif op == "restart":
                engine.shutdown()
                engine = engine_factory()
                engine.start()
            elif op == "shutdown":
                break
    finally:
        stop.set()
        engine.shutdown()
        try:
            sock.close()
        except OSError:
            pass
        events.emit("gang_replica", f"rank-{rank}", "follower_exit",
                    rc=rc)
    return rc


def tp_worker_serve(engine_factory: Callable[[], Any],
                    topology: ReplicaTopology, addr: str, rank: int,
                    connect_timeout: float = 60.0,
                    kv_config: Optional[Dict[str, Any]] = None,
                    exit_fn: Callable[[int], None] = os._exit) -> int:
    """The loop a tp rank other than 0 runs instead of HTTP.

    Joins the gang channel as a member (hello, the welcome's geometry
    check, heartbeats), then serves its tp rank 0's plans: each engine
    that rank 0 opens is matched by one from ``engine_factory`` (the
    same geometry, this rank's shard), whose ``work`` makes every call
    rank 0 plans, until rank 0 closes it. A leader ``shutdown`` or the
    channel's EOF ends the process through ``exit_fn`` (the plan loop
    may be blocked in a collective then); so does the plan group
    failing (its rank 0 died). Returns the exit code."""
    sock, rfile, wfile = _connect(addr, rank, "tp", connect_timeout)
    try:
        welcome = json.loads(rfile.readline() or b"{}")
    except (OSError, ValueError):
        welcome = {}
    if welcome.get("op") != "welcome" or _kv_mismatch(welcome, kv_config,
                                                      rank):
        sock.close()
        return 1
    stop = threading.Event()
    threading.Thread(target=_heartbeat, args=(wfile, rank, stop),
                     daemon=True, name="gang-heartbeat").start()

    def watch_leader():
        while True:
            try:
                line = rfile.readline()
            except (OSError, ValueError):
                line = b""
            if not line:
                break
            try:
                if json.loads(line).get("op") == "shutdown":
                    break
            except ValueError:
                continue
        stop.set()
        events.emit("gang_replica", f"rank-{rank}", "tp_exit", rc=0)
        exit_fn(0)

    threading.Thread(target=watch_leader, daemon=True,
                     name="gang-leader-watch").start()
    events.emit("gang_replica", f"rank-{rank}", "tp_up", leader=addr,
                tp=topology.tp)
    try:
        while not stop.is_set():
            # One engine per rank-0 session: it ends with rank 0's
            # close, or with a new open over a used cache.
            engine = engine_factory()
            engine.work()
            engine.release()
    except (RuntimeError, ValueError, ConnectionError) as e:
        # The plan group broke: its rank 0 died or tore it down.
        events.emit("gang_replica", f"rank-{rank}", "tp_exit", rc=1,
                    error=repr(e))
        return 1
    return 0
