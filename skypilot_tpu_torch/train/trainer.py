"""Training step on one device: counterpart of
``skypilot_tpu/train/trainer.py`` (no mesh, no sharding rules).

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
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch.ops.linear import matmul_f32


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
            params = list(params.parameters())
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
    are (1,) zeros, as there."""
    count: int
    leaves: List[Leaf]
    v_row: List[torch.Tensor]
    v_col: List[torch.Tensor]
    v: List[torch.Tensor]


def _decay_rate(count: int) -> Tuple[float, float]:
    # optax computes 1 - t ** -0.8 in f32; so is its complement.
    decay = np.float32(1.0) - np.float32(count + 1) ** np.float32(
        -DECAY_EXPONENT)
    return float(decay), float(np.float32(1.0) - decay)


def _factored_update(g: torch.Tensor, v_row: torch.Tensor,
                     v_col: torch.Tensor, d1: int, d0: int,
                     decay: Tuple[float, float]) -> None:
    """Row and column statistics of g^2 + eps over axes d0 and d1, and g
    overwritten by g * row_factor * col_factor (optax's factored branch).

    Each mean of g^2 is a vector norm taken in fp32 straight from g,
    squared, plus eps (mean(g^2 + eps) = mean(g^2) + eps), and g is
    scaled in place: no fp32 copy of the leaf is made."""
    for v, dim in ((v_row, d0), (v_col, d1)):
        mean_sq = torch.linalg.vector_norm(
            g, dim=dim, dtype=torch.float32).square_().div_(g.shape[dim])
        v.copy_(decay[0] * v.float() + decay[1] * (mean_sq + FACTORED_EPS))
    row, col = v_row.float(), v_col.float()
    reduced_d1 = d1 - 1 if d1 > d0 else d1
    row_factor = (row / row.mean(dim=reduced_d1, keepdim=True)).rsqrt()
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
    """

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.schedule = warmup_cosine_schedule(cfg)
        self.weight_decay = cfg.weight_decay * cfg.learning_rate or None

    def init(self, module: nn.Module) -> AdafactorState:
        """One state per JAX leaf of ``module`` (``jax_leaves``)."""
        leaves = jax_leaves(module)
        params = list(module.parameters())
        state = AdafactorState(count=0, leaves=leaves, v_row=[], v_col=[],
                               v=[])
        for leaf in leaves:
            p = params[leaf.index[0]]
            shape = leaf.shape(params)
            dims = factored_dims(shape)

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

    def _scale_by_factored_rms(self, leaf: Leaf, k: int,
                               params: List[torch.Tensor],
                               gs: List[torch.Tensor],
                               state: AdafactorState,
                               decay: Tuple[float, float]) -> None:
        dims = factored_dims(leaf.shape(params))
        if dims is None:
            for i, g in enumerate(gs):
                _full_update(g, state.v[k][i] if leaf.stacked
                             else state.v[k], decay)
        elif leaf.stacked and 0 in dims:
            # The layer axis is one of the two: the statistics mix layers,
            # so the leaf is stacked as JAX holds it.
            stacked = torch.stack(gs)
            _factored_update(stacked, state.v_row[k], state.v_col[k], *dims,
                             decay)
            for g, u in zip(gs, stacked.unbind(0)):
                g.copy_(u)
        else:
            off = 1 if leaf.stacked else 0
            for i, g in enumerate(gs):
                v_row = state.v_row[k][i] if leaf.stacked else state.v_row[k]
                v_col = state.v_col[k][i] if leaf.stacked else state.v_col[k]
                _factored_update(g, v_row, v_col, dims[0] - off,
                                 dims[1] - off, decay)

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
        for k, leaf in enumerate(state.leaves):
            ps = [params[i] for i in leaf.index]
            gs = [grads[i].mul_(factor) for i in leaf.index]
            self._scale_by_factored_rms(leaf, k, params, gs, state, decay)
            numel = sum(g.numel() for g in gs)
            u_rms = torch.sqrt(sum(torch.linalg.vector_norm(
                g, dtype=torch.float32).square() for g in gs) / numel)
            clip = torch.clamp(u_rms / CLIP_THRESHOLD, min=1.0)
            p_rms = torch.sqrt(sum(torch.linalg.vector_norm(
                p, dtype=torch.float32).square() for p in ps) / numel)
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
    mask = mask.float()
    chunk = min(CE_CHUNK, s)
    nll = hidden.new_zeros((), dtype=torch.float32)
    cnt = hidden.new_zeros((), dtype=torch.float32)
    # Slicing replaces the JAX version's zero padding: a padded row adds
    # 0 to both sums there.
    for start in range(0, s, chunk):
        sl = slice(start, start + chunk)
        n_c, c_c = checkpoint(_ce_chunk, hidden[:, sl], head,
                              targets[:, sl], mask[:, sl],
                              use_reentrant=False)
        nll = nll + n_c
        cnt = cnt + c_c
    return nll / cnt.clamp(min=1.0)


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
) -> Callable[[TrainState, Dict[str, torch.Tensor]],
              Tuple[TrainState, Dict[str, Any]]]:
    """The step: forward_fn(params, tokens) -> logits or (logits, aux).

    With ``trunk_fn`` (params, tokens) -> final hidden and ``head_fn``
    (params) -> (dim, vocab), the loss is chunked_cross_entropy_loss and
    full-sequence logits never materialize. Metrics stay on the device.
    """

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
        plist = list(state.params.parameters())
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
