"""Training step on one device: counterpart of
``skypilot_tpu/train/trainer.py`` (no mesh, no sharding rules).

The optimizer mirrors the JAX package's optax chain,
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

The step updates parameters and optimizer state in place, where JAX
returns new ones; it returns the same ``TrainState`` object.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

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
    # "adamw" only in this slice; "adafactor" is recognised and raises.
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

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        cfg = self.cfg
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


def make_optimizer(cfg: TrainConfig) -> AdamW:
    if cfg.optimizer == "adafactor":
        raise NotImplementedError("adafactor is not ported yet; use adamw")
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
    opt_state: AdamWState
    step: int


def init_train_state(params: nn.Module, tx: AdamW) -> TrainState:
    return TrainState(params=params,
                      opt_state=tx.init(list(params.parameters())), step=0)


def make_train_step(
    forward_fn: Callable[..., Any],
    tx: AdamW,
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
