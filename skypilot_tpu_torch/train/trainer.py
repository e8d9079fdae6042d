"""Training step: counterpart of ``skypilot_tpu/train/trainer.py``, on
one device, or on a mesh (``make_train_step(..., mesh=, rules=)``, see
``_make_sharded_step``).

The adamw optimizer mirrors the JAX package's optax chain,
``clip_by_global_norm`` then ``adamw`` under a warmup-cosine schedule,
term by term:

* the schedule is a plain function evaluated at the count *before* its
  increment, so the first step has lr 0 when ``warmup_steps > 0``;
* clipping scales by max_norm / norm with no epsilon, only when the norm
  reaches ``max_grad_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
  norm + 1e-6 always), as one in-place multiply by a device scalar;
* the update is ``torch.optim.AdamW(fused=True)``: its decoupled decay
  p * (1 - lr * wd) followed by lr * m_hat / (sqrt(v_hat) + eps) is
  optax's lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), with the bias
  correction at the incremented count and decay on every parameter,
  norms included; mu and nu stay in the parameter's dtype and the
  arithmetic runs in fp32. tests/test_torch_trainer.py holds it to optax
  at f32 rounding.

The adafactor optimizer (``TrainConfig(optimizer="adafactor")``) is
``clip_by_global_norm`` then ``optax.adafactor(schedule,
weight_decay_rate=wd * lr or None)`` stage by stage; see ``Adafactor``.

The step updates parameters and optimizer state in place, where JAX
returns new ones; it returns the same ``TrainState`` object.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch.ops.linear import matmul_f32
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import placement, seq_gather


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    # "adamw" (default) or "adafactor" (factored second moment: row and
    # column statistics in place of a full one for large matrices).
    optimizer: str = "adamw"


def warmup_cosine_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup+1)) as a function of the step count."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    decay = max(cfg.total_steps, cfg.warmup_steps + 1) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        c = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32, on device."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]))


def _clip_factor(g_norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # A device select, so clipping needs no host sync.
    return torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                       max_norm / g_norm)


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g unchanged while norm < max_norm, else
    g * max_norm / norm."""
    factor = _clip_factor(global_norm(grads), max_norm)
    return [g * factor for g in grads]


@dataclasses.dataclass
class AdamWState:
    count: int
    opt: torch.optim.AdamW


class AdamW:
    """optax.chain(clip_by_global_norm, adamw(schedule)) over a list of
    parameters, updating them (and their grads, clipped) in place."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.schedule = warmup_cosine_schedule(cfg)

    def init(self, params: Union[nn.Module, List[torch.Tensor]]
             ) -> AdamWState:
        cfg = self.cfg
        if isinstance(params, nn.Module):
            params = placement.held_params(params)
        return AdamWState(count=0, opt=torch.optim.AdamW(
            params, lr=0.0, betas=(cfg.b1, cfg.b2), eps=1e-8,
            weight_decay=cfg.weight_decay, fused=True))

    @torch.no_grad()
    def update_(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                state: AdamWState,
                g_norm: Optional[torch.Tensor] = None) -> None:
        """One step; ``g_norm`` is the grads' global norm if the caller
        already has it."""
        if g_norm is None:
            g_norm = global_norm(grads)
        factor = _clip_factor(g_norm, self.cfg.max_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g.mul_(factor)
        for group in state.opt.param_groups:
            group["lr"] = self.schedule(state.count)
        state.opt.step()
        state.count += 1


# optax.adafactor's defaults (optax 0.2.6), which the JAX package keeps.
FACTOR_MIN_DIM = 128      # min_dim_size_to_factor
DECAY_EXPONENT = 0.8      # decay_rate: 1 - (count + 1) ** -0.8
FACTORED_EPS = 1e-30      # added to g^2
CLIP_THRESHOLD = 1.0      # clip_by_block_rms
MIN_PARAM_SCALE = 1e-3    # scale_by_param_block_rms


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims(shape, True, 128)``: the second largest and
    the largest axis, or None when the second of them is under 128 (or
    the shape has fewer than two axes). numpy's argsort breaks ties as
    optax's does."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < FACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the JAX tree: the parameters at ``index`` (positions in
    the parameter list), stacked on a new axis 0 when ``stacked`` (a
    layer weight, one tensor per layer here, one (L, ...) array there),
    else a single tensor."""
    key: str
    index: Tuple[int, ...]
    stacked: bool

    def shape(self, params: List[torch.Tensor]) -> Tuple[int, ...]:
        first = tuple(params[self.index[0]].shape)
        return (len(self.index),) + first if self.stacked else first


def jax_leaves(module: nn.Module) -> List[Leaf]:
    """The module's parameters grouped as the JAX tree's leaves: every
    ``layers.<i>.<name>`` joins the other layers' ``<name>``, in
    ``parameters()`` order."""
    groups: Dict[Tuple[str, bool], List[int]] = {}
    for i, (name, _) in enumerate(module.named_parameters()):
        key = re.sub(r"\.\d+\.", ".", name)
        groups.setdefault((key, key != name), []).append(i)
    return [Leaf(key, tuple(idx), stacked)
            for (key, stacked), idx in groups.items()]


@dataclasses.dataclass
class AdafactorState:
    """optax's FactoredState as tensors in the JAX tree's layout (a
    stacked leaf's statistics are (L, ...)); a leaf's unused statistics
    are (1,) zeros, as there. ``params`` are the module's parameters,
    which ``leaves`` index; ``pp_group`` is the pipeline's group when
    some of them are another stage's layers (meta placeholders, whose
    rows of a statistic stay zeros)."""
    count: int
    leaves: List[Leaf]
    v_row: List[torch.Tensor]
    v_col: List[torch.Tensor]
    v: List[torch.Tensor]
    params: List[torch.Tensor]
    pp_group: Any = None


def _decay_rate(count: int) -> Tuple[float, float]:
    # optax computes 1 - t ** -0.8 in f32; so is its complement.
    decay = np.float32(1.0) - np.float32(count + 1) ** np.float32(
        -DECAY_EXPONENT)
    return float(decay), float(np.float32(1.0) - decay)


class _Shards:
    """Where a leaf's local tensors sit in the whole leaf on a mesh: the
    process groups that split each of its dims (a stacked leaf's dim 0,
    the layer axis, is never split), and the whole shape. ``sum``
    all-reduces a partial sum over the groups that split the given
    dims, so a mean over a dim is over the whole dim, never over a
    process's shard."""

    def __init__(self, p: torch.Tensor, stacked: bool, shape):
        self.shape = shape
        self.groups: Dict[int, list] = {}
        off = 1 if stacked else 0
        mesh = p.device_mesh
        for i, pl in enumerate(p.placements):
            if pl.is_shard():
                self.groups.setdefault(pl.dim + off, []).append(
                    mesh.get_group(i))

    def sum(self, t: torch.Tensor, dims) -> torch.Tensor:
        for d in dims:
            for group in self.groups.get(d, ()):
                torch.distributed.all_reduce(t, group=group)
        return t


def _factored_update(g: torch.Tensor, v_row: torch.Tensor,
                     v_col: torch.Tensor, d1: int, d0: int,
                     decay: Tuple[float, float],
                     shards: Optional[_Shards] = None) -> None:
    """Row and column statistics of g^2 + eps over axes d0 and d1, and g
    overwritten by g * row_factor * col_factor (optax's factored branch).

    Each mean of g^2 is a vector norm taken in fp32 straight from g,
    squared, plus eps (mean(g^2 + eps) = mean(g^2) + eps), and g is
    scaled in place: no fp32 copy of the leaf is made. With ``shards``
    g and the statistics are a process's shards, and each mean is summed
    over the processes that split its dim."""
    for v, dim in ((v_row, d0), (v_col, d1)):
        sq = torch.linalg.vector_norm(g, dim=dim,
                                      dtype=torch.float32).square_()
        if shards is None:
            mean_sq = sq.div_(g.shape[dim])
        else:
            mean_sq = shards.sum(sq, (dim,)).div_(shards.shape[dim])
        v.copy_(decay[0] * v.float() + decay[1] * (mean_sq + FACTORED_EPS))
    row, col = v_row.float(), v_col.float()
    reduced_d1 = d1 - 1 if d1 > d0 else d1
    if shards is None:
        row_mean = row.mean(dim=reduced_d1, keepdim=True)
    else:
        row_mean = shards.sum(row.sum(dim=reduced_d1, keepdim=True),
                              (d1,)) / shards.shape[d1]
    row_factor = (row / row_mean).rsqrt()
    g.mul_(row_factor.unsqueeze(d0)).mul_(col.rsqrt().unsqueeze(d1))


def _full_update(g: torch.Tensor, v: torch.Tensor,
                 decay: Tuple[float, float]) -> None:
    v.copy_(decay[0] * v.float() +
            decay[1] * (g.float().square() + FACTORED_EPS))
    g.copy_(g.float() * v.float().rsqrt())


class Adafactor:
    """optax.chain(clip_by_global_norm(max_grad_norm), adafactor(schedule,
    weight_decay_rate=wd * lr or None)) over a module's parameters,
    updating them (and overwriting their grads) in place. The stages,
    optax 0.2.6's, in order:

    1. scale_by_factored_rms: a leaf whose two largest axes are both at
       least 128 (``factored_dims`` of the JAX leaf's shape, the stacked
       one for a layer weight) keeps row and column means of g^2 + 1e-30,
       others a full one, each decayed by 1 - (count + 1) ** -0.8; the
       update is g over their root;
    2. clip_by_block_rms(1): the update over max(1, its rms);
    3. scale_by_learning_rate(schedule) at the count before the step;
    4. scale_by_param_block_rms: times max(rms(p), 1e-3);
    5. add_decayed_weights(weight_decay * learning_rate), skipped when that
       is 0 (the JAX package's ``or None``): decay added after the lr
       scaling, at the peak lr;
    6. scale(-1).

    A block in 2 and 4 is a JAX leaf: every layer's tensor of one name
    together, so both rms reductions run over all layers at once. The
    arithmetic runs in fp32; the statistics are stored in the parameter's
    dtype, as optax stores them.

    On a mesh (DTensor parameters, ``make_train_step(..., mesh=)``) the
    factoring is decided on the whole leaf's shape, each process keeps
    the statistics of its shard (the parameter's placement with the
    reduced dim dropped), and every mean and rms is over the whole leaf
    (``_Shards``): the same update as on one device. Under pipeline
    stages a stacked leaf's layers are split over ``pp`` like a dim split
    over a mesh axis: a stage updates its own layers' rows, and a mean or
    rms over the layer axis is summed over ``pp``.

    ``update_`` finds each leaf's parameters among those it is given by
    identity: a parameter it is not given (another stage's, or a frozen
    one) is skipped.
    """

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.schedule = warmup_cosine_schedule(cfg)
        self.weight_decay = cfg.weight_decay * cfg.learning_rate or None

    def init(self, module: nn.Module) -> AdafactorState:
        """One state per JAX leaf of ``module`` (``jax_leaves``)."""
        params = list(module.parameters())
        state = AdafactorState(count=0, leaves=jax_leaves(module), v_row=[],
                               v_col=[], v=[], params=params)
        if any(p.is_meta for p in params):
            state.pp_group = next(
                p.device_mesh.get_group(mesh_lib.PP) for p in params
                if isinstance(p, DTensor) and
                mesh_lib.PP in p.device_mesh.mesh_dim_names)
        for leaf in state.leaves:
            dims = factored_dims(leaf.shape(params))
            p = placement.local(next(params[i] for i in leaf.index
                                     if not params[i].is_meta))
            shape = ((len(leaf.index),) if leaf.stacked else ()) + tuple(
                p.shape)

            def zeros(s):
                return torch.zeros(s, dtype=p.dtype, device=p.device)
            if dims is None:
                state.v_row.append(zeros((1,)))
                state.v_col.append(zeros((1,)))
                state.v.append(zeros(shape))
            else:
                d1, d0 = dims
                state.v_row.append(zeros(shape[:d0] + shape[d0 + 1:]))
                state.v_col.append(zeros(shape[:d1] + shape[d1 + 1:]))
                state.v.append(zeros((1,)))
        return state

    def _scale_by_factored_rms(self, leaf: Leaf, k: int, rows: List[int],
                               gs: List[torch.Tensor],
                               state: AdafactorState,
                               decay: Tuple[float, float],
                               shards: Optional[_Shards] = None) -> None:
        """``gs``: the gradients of the leaf's layers at ``rows`` (all of
        them but under pipeline stages)."""
        dims = factored_dims(leaf.shape(state.params))
        if dims is None:
            for i, g in zip(rows, gs):
                _full_update(g, state.v[k][i] if leaf.stacked
                             else state.v[k], decay)
        elif leaf.stacked and 0 in dims:
            # The layer axis is one of the two: the statistics mix layers,
            # so the leaf is stacked as JAX holds it (a stage's rows of it,
            # its layer axis split over pp, ``shards``).
            stacked = torch.stack(gs)
            whole = len(rows) == len(leaf.index)
            # v_row drops d0, v_col d1: one that keeps the layer axis is
            # updated at the stage's rows.
            stats = [v if whole or d == 0 else v[rows]
                     for v, d in ((state.v_row[k], dims[1]),
                                  (state.v_col[k], dims[0]))]
            _factored_update(stacked, *stats, *dims, decay, shards)
            for v, sub in zip((state.v_row[k], state.v_col[k]), stats):
                if sub is not v:
                    v[rows] = sub
            for g, u in zip(gs, stacked.unbind(0)):
                g.copy_(u)
        else:
            off = 1 if leaf.stacked else 0
            for i, g in zip(rows, gs):
                v_row = state.v_row[k][i] if leaf.stacked else state.v_row[k]
                v_col = state.v_col[k][i] if leaf.stacked else state.v_col[k]
                _factored_update(g, v_row, v_col, dims[0] - off,
                                 dims[1] - off, decay,
                                 _unstacked(shards) if leaf.stacked
                                 else shards)

    @torch.no_grad()
    def update_(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                state: AdafactorState,
                g_norm: Optional[torch.Tensor] = None) -> None:
        """One step; ``g_norm`` is the grads' global norm if the caller
        already has it."""
        if g_norm is None:
            g_norm = global_norm(grads)
        factor = _clip_factor(g_norm, self.cfg.max_grad_norm)
        decay = _decay_rate(state.count)
        lr = self.schedule(state.count)
        given = {id(p): g for p, g in zip(params, grads)}
        for k, leaf in enumerate(state.leaves):
            rows = [j for j, i in enumerate(leaf.index)
                    if id(state.params[i]) in given]
            if not rows:
                continue
            ps = [state.params[leaf.index[j]] for j in rows]
            gs = [given[id(p)].mul_(factor) for p in ps]
            numel = math.prod(leaf.shape(state.params))
            shards = None
            if isinstance(ps[0], DTensor):
                shards = _Shards(ps[0], leaf.stacked,
                                 leaf.shape(state.params))
                if len(rows) < len(leaf.index):
                    shards.groups.setdefault(0, []).append(state.pp_group)
                ps = [placement.local(p) for p in ps]
                gs = [placement.local(g) for g in gs]
            self._scale_by_factored_rms(leaf, k, rows, gs, state, decay,
                                        shards)
            u_sq = sum(torch.linalg.vector_norm(
                g, dtype=torch.float32).square() for g in gs)
            p_sq = sum(torch.linalg.vector_norm(
                p, dtype=torch.float32).square() for p in ps)
            if shards is not None:
                every = range(len(shards.shape))
                u_sq, p_sq = shards.sum(u_sq, every), shards.sum(p_sq, every)
            u_rms = torch.sqrt(u_sq / numel)
            clip = torch.clamp(u_rms / CLIP_THRESHOLD, min=1.0)
            p_rms = torch.sqrt(p_sq / numel)
            p_scale = torch.where(p_rms <= MIN_PARAM_SCALE,
                                  torch.full_like(p_rms, MIN_PARAM_SCALE),
                                  p_rms)
            scale = p_scale * lr / clip
            for p, g in zip(ps, gs):
                u = g.float().mul_(scale)
                if self.weight_decay is not None:
                    u.add_(p, alpha=self.weight_decay)
                p.sub_(u.to(p.dtype))
        state.count += 1


def _unstacked(shards: Optional[_Shards]) -> Optional[_Shards]:
    """A stacked leaf's shards as one layer's tensor sees them."""
    if shards is None:
        return None
    out = _Shards.__new__(_Shards)
    out.shape = shards.shape[1:]
    out.groups = {d - 1: g for d, g in shards.groups.items() if d}
    return out


def make_optimizer(cfg: TrainConfig) -> Union[AdamW, Adafactor]:
    if cfg.optimizer == "adafactor":
        return Adafactor(cfg)
    if cfg.optimizer != "adamw":
        raise ValueError(
            f"Unknown TrainConfig.optimizer {cfg.optimizer!r}; "
            "expected 'adamw' or 'adafactor'.")
    return AdamW(cfg)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in fp32. logits (B,S,V), targets (B,S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None]).squeeze(-1)
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


# Sequence-chunk width for the fused head+CE loss (as in the JAX package).
CE_CHUNK = 1024


def _ce_chunk(x_c, head, t_c, m_c):
    logits = matmul_f32(x_c, head)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, t_c[..., None]).squeeze(-1)
    return ((logz - gold) * m_c).sum(), m_c.sum()


def chunked_cross_entropy_loss(hidden: torch.Tensor, head: torch.Tensor,
                               targets: torch.Tensor,
                               mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Next-token CE fused with the vocab projection, chunk by chunk; each
    chunk is recomputed in the backward, so the (B, S, vocab) fp32 logits
    never exist at once. ``hidden`` (B,S,D) is final-normed and aligned
    with ``targets`` (B,S); ``head`` is (D, V)."""
    b, s, _ = hidden.shape
    if mask is None:
        mask = torch.ones(b, s, dtype=torch.float32, device=hidden.device)
    nll, cnt = _chunked_nll_sums(hidden, head, targets, mask.float())
    return nll / cnt.clamp(min=1.0)


def _chunked_nll_sums(hidden, head, targets, weight):
    """(sum of weight * NLL, sum of weight), chunk by chunk. Slicing
    replaces the JAX version's zero padding: a padded row adds 0 to both
    sums there."""
    s = hidden.shape[1]
    chunk = min(CE_CHUNK, s)
    nll = hidden.new_zeros((), dtype=torch.float32)
    cnt = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        n_c, c_c = checkpoint(_ce_chunk, hidden[:, sl], head,
                              targets[:, sl], weight[:, sl],
                              use_reentrant=False)
        nll = nll + n_c
        cnt = cnt + c_c
    return nll, cnt


class DelayedFetch:
    """One-step-delayed device->host fetch for loop telemetry.

    Holds this step's device handle and hands back the previous one, so
    the caller's ``float(prev)`` waits on a step that has already been
    followed by the next one's launches. It never touches the device."""

    def __init__(self) -> None:
        self._held: Any = None

    def rotate(self, new: Any) -> Any:
        prev = self._held
        self._held = new
        return prev

    def drain(self) -> Any:
        prev = self._held
        self._held = None
        return prev


@dataclasses.dataclass
class TrainState:
    params: nn.Module
    opt_state: Union[AdamWState, AdafactorState]
    step: int


def init_train_state(params: nn.Module,
                     tx: Union[AdamW, Adafactor]) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0)


def make_train_step(
    forward_fn: Callable[..., Any],
    tx: Union[AdamW, Adafactor],
    trunk_fn: Optional[Callable[..., torch.Tensor]] = None,
    head_fn: Optional[Callable[..., torch.Tensor]] = None,
    with_grad_norm: bool = True,
    mesh=None,
    rules: Optional[mesh_lib.ShardingRules] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]],
              Tuple[TrainState, Dict[str, Any]]]:
    """The step: forward_fn(params, tokens) -> logits or (logits, aux).

    With ``trunk_fn`` (params, tokens) -> final hidden and ``head_fn``
    (params) -> (dim, vocab), the loss is chunked_cross_entropy_loss and
    full-sequence logits never materialize. Metrics stay on the device.
    With a ``mesh`` (and ``rules``, DEFAULT_RULES by default), the step
    on the mesh: ``_make_sharded_step``.
    """
    if mesh is not None:
        return _make_sharded_step(forward_fn, tx, mesh,
                                  rules or mesh_lib.DEFAULT_RULES, trunk_fn,
                                  head_fn, with_grad_norm)

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        mask = batch.get("loss_mask")
        mask = None if mask is None else mask[:, 1:]
        if trunk_fn is not None:
            hidden = trunk_fn(params, tokens)
            ce = chunked_cross_entropy_loss(hidden[:, :-1], head_fn(params),
                                            tokens[:, 1:], mask)
            return ce, ce, torch.zeros((), device=ce.device)
        out = forward_fn(params, tokens)
        logits, aux = out if isinstance(out, tuple) else (out, 0.0)
        ce = cross_entropy_loss(logits[:, :-1], tokens[:, 1:], mask)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        return ce + aux, ce, aux

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        # A frozen parameter (requires_grad=False) gets no gradient and no
        # update, and counts in no norm.
        plist = [p for p in state.params.parameters() if p.requires_grad]
        for p in plist:
            p.grad = None
        loss, ce, aux = loss_fn(state.params, batch)
        loss.backward()
        grads = [p.grad for p in plist]
        g_norm = global_norm(grads)
        metrics = {"loss": ce.detach(), "aux_loss": aux.detach(),
                   "total_loss": loss.detach(), "step": state.step}
        if with_grad_norm:
            metrics["grad_norm"] = g_norm
        tx.update_(plist, grads, state.opt_state, g_norm)
        for p in plist:
            p.grad = None
        state.step += 1
        return state, metrics

    return step


# ------------------------------------------------------------ on a mesh

def _opt_buffers(opt_state) -> Tuple[str, ...]:
    """The per-parameter tensors an optimizer state keeps beside each
    parameter, in its shape."""
    if isinstance(opt_state, AdamWState):
        return ("exp_avg", "exp_avg_sq")
    return ()


def state_shardings(mesh, rules: mesh_lib.ShardingRules,
                    param_specs: dict, state: TrainState) -> TrainState:
    """Shardings for a TrainState: params by their specs (one
    ``mesh_lib.Sharding`` per parameter name); each optimizer tensor that
    tracks a parameter takes that parameter's, matched by the longest
    suffix of its path (``<buffer>/<parameter path>``), never by shape;
    the rest (counts, adafactor's factored statistics, whose layout
    ``Adafactor`` derives from the parameter's) replicated."""
    p_shard = placement.param_shardings(state.params, mesh, rules,
                                        param_specs)
    param_paths = {tuple(n.split(".")): sh for n, sh in p_shard.items()}
    replicated = mesh_lib.Sharding(
        mesh, (Replicate(),) * len(mesh_lib.axis_names(mesh)))

    def opt_leaf(path):
        for start in range(len(path)):
            sh = param_paths.get(path[start:])
            if sh is not None:
                return sh
        return replicated

    o_shard = {f"{buf}/{name}": opt_leaf((buf,) + tuple(name.split(".")))
               for buf in _opt_buffers(state.opt_state) for name in p_shard}
    o_shard["count"] = replicated
    return TrainState(params=p_shard, opt_state=o_shard, step=replicated)


def place_state(state: TrainState, shardings: TrainState,
                tx: Union[AdamW, Adafactor]) -> TrainState:
    """``jax.device_put(state, state_shardings(...))``: the parameters
    become DTensors placed by ``shardings.params`` (in place), the
    optimizer is built anew over them and keeps its count and any
    buffers it had, placed by ``shardings.opt_state`` (adamw's), or by
    their parameter's placement (adafactor's statistics,
    ``_place_statistics``). ``state`` is one device's."""
    module, old = state.params, state.opt_state
    named = dict(module.named_parameters())
    saved = {}
    if isinstance(old, AdamWState):
        for name, p in named.items():
            st = old.opt.state.get(p)
            if st:
                saved[name] = st
    placement.place_module(module, shardings.params, shardings.step.mesh)
    new = tx.init(module)
    new.count = old.count
    if isinstance(new, AdamWState):
        for name, p in module.named_parameters():
            if name not in saved or p.is_meta:
                continue
            st = dict(saved[name])
            for buf in _opt_buffers(new):
                sh = shardings.opt_state[f"{buf}/{name}"]
                st[buf] = distribute_tensor(
                    st[buf].detach(), sh.mesh, sh.placements,
                    src_data_rank=None)
            new.opt.state[p] = st
    else:
        _place_statistics(old, new)
    return TrainState(params=module, opt_state=new, step=state.step)


def _place_statistics(old: AdafactorState, new: AdafactorState) -> None:
    """Each statistic of ``old`` (whole, as one device holds it) into
    ``new``'s (built on the placed module) at this process's part: the
    part its parameter's shard reads. A statistic is the parameter's
    shape with the reduced dim dropped, so it is split where the
    parameter is, on the dims it keeps: a factored row statistic
    follows the parameter's row dim, a column statistic its column dim,
    and one whose reduced dim is split is whole on every process of
    that split."""
    for k, leaf in enumerate(new.leaves):
        p = next(new.params[i] for i in leaf.index
                 if not new.params[i].is_meta)
        dims = factored_dims(leaf.shape(new.params))
        off = 1 if leaf.stacked else 0
        stats = ([(old.v, new.v, None)] if dims is None else
                 [(old.v_row, new.v_row, dims[1]),
                  (old.v_col, new.v_col, dims[0])])
        for src, dst, dropped in stats:
            if not isinstance(p, DTensor):
                dst[k].copy_(src[k])
                continue
            places = []
            for pl in p.placements:
                d = pl.dim + off if pl.is_shard() else None
                if d is None or d == dropped:
                    places.append(Replicate())
                else:
                    places.append(Shard(d if dropped is None or d < dropped
                                        else d - 1))
            dst[k].copy_(distribute_tensor(
                src[k].detach(), p.device_mesh, places,
                src_data_rank=None).to_local())


def _shifted_targets(tokens, mask, mesh):
    """Next-token targets and loss weights of this process's sequence
    chunk (the whole sequence unless sp > 1): position p predicts token
    p + 1; the last position of the sequence has no target."""
    b, s = tokens.shape
    zero = tokens.new_zeros((b, 1))
    targets = torch.cat([tokens[:, 1:], zero], dim=1)
    weight = (torch.ones((b, s - 1), dtype=torch.float32,
                         device=tokens.device) if mask is None
              else mask[:, 1:].float())
    weight = torch.cat([weight, weight.new_zeros((b, 1))], dim=1)
    return seq_gather.seq_chunk(mesh, targets, weight)


def _nll_sums(logits, targets, weight):
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(
        -1, targets[..., None]).squeeze(-1)
    return (nll * weight).sum(), weight.sum()


def _make_sharded_step(forward_fn, tx, mesh, rules, trunk_fn, head_fn,
                       with_grad_norm):
    """The step on a mesh. Parameters and optimizer state are DTensors
    (``state_shardings`` + ``place_state``); each process feeds its own
    (B / (dp * fsdp), S) shard of the global batch, the rows of its
    (dp, fsdp) coordinate in row-major order, and the same on every tp,
    ep, sp and pp process of that coordinate.

    The forward runs under ``use_mesh``: the model gathers each layer's
    weights at use and its backward reduce-scatters the gradients onto
    the shards (``parallel/placement.py``). The loss is the global
    batch's: each process's summed NLL over the global count of
    predicted tokens, so the gradients summed over the data axes are the
    global mean's; a pipeline's stages each weigh it by 1 / pp and the
    parameters every stage holds are summed over pp after the backward.
    A forward that returns (logits, aux) (Mixtral) adds its auxiliary
    loss, which every process holds whole and whose gradient the model
    gives each data rank its share of (``mixtral._BatchShare``): the
    loss is CE + aux, and ``loss``, ``aux_loss`` and ``total_loss`` are
    reported as the one-device step reports them. The gradient norm and
    the clip are global (``placement.global_norm``).
    """
    tp = mesh_lib.axis_size(mesh, mesh_lib.TP)
    pp = mesh_lib.axis_size(mesh, mesh_lib.PP)
    ep = mesh_lib.axis_size(mesh, mesh_lib.EP)
    # The tp, ep and pp processes of one batch and sequence shard see the
    # same data, so the all-reduced count holds each token tp * ep * pp
    # times.
    replicas = tp * ep * pp

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        plist = [p for p in placement.held_params(params)
                 if p.requires_grad]
        if any(not isinstance(p, DTensor) for p in plist):
            raise ValueError("the step on a mesh needs its parameters "
                             "placed: place_state(state, state_shardings("
                             "...), tx)")
        for p in plist:
            p.grad = None
        tokens = batch["tokens"]
        targets, weight = _shifted_targets(tokens, batch.get("loss_mask"),
                                           mesh)
        aux = None
        with mesh_lib.use_mesh(mesh, rules):
            if trunk_fn is not None:
                nll, cnt = _chunked_nll_sums(trunk_fn(params, tokens),
                                             head_fn(params), targets,
                                             weight)
            else:
                out = forward_fn(params, tokens)
                if isinstance(out, tuple):
                    out, aux = out
                nll, cnt = _nll_sums(out, targets, weight)
        total = cnt.detach().clone()
        torch.distributed.all_reduce(total)
        loss = nll / (total / replicas).clamp(min=1.0) / pp
        (loss if aux is None else loss + aux).backward()
        placement.reduce_pp_grads(plist, mesh)
        for p in plist:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in plist]
        g_norm = placement.global_norm(grads, mesh)
        reported = loss.detach().clone()
        torch.distributed.all_reduce(reported)
        reported = reported / (tp * ep)
        aux = (torch.zeros((), device=reported.device) if aux is None
               else aux.detach())
        metrics = {"loss": reported, "aux_loss": aux,
                   "total_loss": reported + aux, "step": state.step}
        if with_grad_norm:
            metrics["grad_norm"] = g_norm
        tx.update_(plist, grads, state.opt_state, g_norm)
        for p in plist:
            p.grad = None
        state.step += 1
        return state, metrics

    return step
