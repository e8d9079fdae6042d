"""Mixtral-class sparse MoE decoder, training half: the counterpart of
``skypilot_tpu/models/mixtral.py`` (config, init, top-2 capacity routing,
the MoE MLP, the layer and ``forward`` with the router's aux loss).

Attention is the port's llama ``attention_block`` (the flash kernels on
the card); only the MLP differs. Routing is GShard-style top-2 with a
capacity per expert, computed as one-hot dispatch and combine tensors and
applied as matmuls, as in the JAX package; its arithmetic is kept
exactly: first-max argmax, positions from a cumsum in the gates' f32,
``capacity = max(int(cf * top_k * t / e), top_k)``, the Switch aux loss
``sum(density * density_proxy) * e^2``. Weights keep the JAX layout:
router (dim, E) in f32, experts (E, dim, mlp) and (E, mlp, dim).

Not in this slice: the KV-cache decode half and ``quantize_params``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.02
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"  # auto|kernel|reference
    remat: bool = True            # full per-layer checkpoint

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def mixtral_8x7b() -> "MixtralConfig":
        return MixtralConfig()

    @staticmethod
    def tiny(vocab_size: int = 256) -> "MixtralConfig":
        return MixtralConfig(vocab_size=vocab_size, dim=64, n_layers=2,
                             n_heads=4, n_kv_heads=2, mlp_dim=128,
                             n_experts=4, top_k=2, max_seq_len=256)

    def flops_per_token(self) -> float:
        """6 x the parameters a token passes through (top_k experts)."""
        attn = self.dim * (self.n_heads + 2 * self.n_kv_heads) * \
            self.head_dim + self.n_heads * self.head_dim * self.dim
        moe = self.top_k * 3 * self.dim * self.mlp_dim
        router = self.dim * self.n_experts
        p_active = self.n_layers * (attn + moe + router) + \
            2 * self.vocab_size * self.dim
        return 6.0 * p_active

    def num_params(self) -> int:
        d, hd = self.dim, self.head_dim
        p_layer = (d * (self.n_heads + 2 * self.n_kv_heads) * hd +
                   self.n_heads * hd * d + 2 * d + d * self.n_experts +
                   3 * self.n_experts * d * self.mlp_dim)
        return self.n_layers * p_layer + d + 2 * self.vocab_size * d


def layer_shapes(cfg: MixtralConfig) -> dict:
    """(name, shape) of each layer weight, in the JAX tree's layout."""
    d, hd, e = cfg.dim, cfg.head_dim, cfg.n_experts
    return {
        "attn_norm": (d,),
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
        "mlp_norm": (d,),
        "router": (d, e),
        "w_gate": (e, d, cfg.mlp_dim),
        "w_up": (e, d, cfg.mlp_dim),
        "w_down": (e, cfg.mlp_dim, d),
    }


# The router stays f32 whatever the config dtype (routing is a discrete
# argmax).
ROUTER_DTYPE = torch.float32


class MixtralLayer(nn.Module):
    """One decoder layer's weights; ``forward`` is the JAX ``_layer``."""

    def __init__(self, cfg: MixtralConfig, device, dtype):
        super().__init__()
        for name, shape in layer_shapes(cfg).items():
            dt = ROUTER_DTYPE if name == "router" else dtype
            setattr(self, name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dt)))

    def forward(self, cfg: MixtralConfig, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _layer(cfg, x, self, positions)


class MixtralParams(nn.Module):
    """embed, layers[i], final_norm, lm_head."""

    def __init__(self, cfg: MixtralConfig, device, dtype):
        super().__init__()

        def empty(shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype))
        self.embed = empty((cfg.vocab_size, cfg.dim))
        self.layers = nn.ModuleList(
            MixtralLayer(cfg, device, dtype) for _ in range(cfg.n_layers))
        self.final_norm = empty((cfg.dim,))
        self.lm_head = empty((cfg.dim, cfg.vocab_size))


@torch.no_grad()
def init(cfg: MixtralConfig, generator: torch.Generator,
         device: DeviceLike = None) -> MixtralParams:
    """Random init as the JAX package draws it (normal * fan_in^-0.5,
    norms at one, the router in f32), from ``generator``; the numbers
    differ from JAX's PRNG. ``device`` defaults to the card."""
    device = resolve_device(device)
    params = MixtralParams(cfg, device, cfg.dtype)

    def dense(p: torch.Tensor, fan_in: int) -> None:
        x = torch.randn(p.shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        # Rounded through the config dtype first, as JAX casts the f32
        # router from a dtype-rounded draw.
        p.copy_((x * fan_in ** -0.5).to(cfg.dtype))

    dense(params.embed, cfg.dim)
    for lp in params.layers:
        lp.attn_norm.fill_(1.0)
        lp.mlp_norm.fill_(1.0)
        for name in ("wq", "wk", "wv", "router", "w_gate", "w_up"):
            dense(getattr(lp, name), cfg.dim)
        dense(lp.wo, cfg.n_heads * cfg.head_dim)
        dense(lp.w_down, cfg.mlp_dim)
    params.final_norm.fill_(1.0)
    dense(params.lm_head, cfg.dim)
    return params


def capacity(cfg: MixtralConfig, tokens: int) -> int:
    """Slots per expert: max(int(cf * top_k * t / e), top_k)."""
    return max(int(cfg.capacity_factor * cfg.top_k * tokens /
                   cfg.n_experts), cfg.top_k)


def _top2_dispatch(gates: torch.Tensor, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard-style top-2 capacity routing.

    gates: (T, E) softmax probabilities.
    Returns (dispatch (T, E, C) bool, combine (T, E, C) f32, aux_loss ()).
    """
    t, e = gates.shape
    idx1 = torch.argmax(gates, dim=-1)          # first max, as jnp.argmax
    mask1 = F.one_hot(idx1, e).to(gates.dtype)
    gates_no1 = gates * (1.0 - mask1)
    idx2 = torch.argmax(gates_no1, dim=-1)
    mask2 = F.one_hot(idx2, e).to(gates.dtype)

    # Switch load-balancing loss: the share of tokens whose first choice
    # is each expert times the mean router probability per expert.
    density = mask1.mean(dim=0)
    density_proxy = gates.mean(dim=0)
    aux = (density * density_proxy).sum() * (e ** 2) / 1.0

    # Positions within each expert's buffer; tokens past capacity dropped.
    pos1 = torch.cumsum(mask1, dim=0) * mask1 - mask1
    keep1 = (pos1 < capacity) * mask1
    pos2 = (torch.cumsum(mask2, dim=0) +
            mask1.sum(dim=0, keepdim=True)) * mask2 - mask2
    keep2 = (pos2 < capacity) * mask2

    g1 = (gates * keep1).sum(dim=-1)
    g2 = (gates * keep2).sum(dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom

    cap_iota = torch.arange(capacity, dtype=pos1.dtype, device=gates.device)
    # (T, E, C) one-hots of each token's slot in each expert buffer.
    slot1 = keep1[:, :, None] * (pos1[:, :, None] == cap_iota)
    slot2 = keep2[:, :, None] * (pos2[:, :, None] == cap_iota)
    combine = g1[:, None, None] * slot1 + g2[:, None, None] * slot2
    dispatch = (slot1 + slot2) > 0
    return dispatch, combine.float(), aux


def router_gates(y: torch.Tensor, lp: nn.Module) -> torch.Tensor:
    """(B, S, D) -> (T, E) softmax of the f32 router logits."""
    return torch.softmax(y.reshape(-1, y.shape[-1]).float() @ lp.router,
                         dim=-1)


def _moe_mlp(cfg: MixtralConfig, y: torch.Tensor, lp: nn.Module
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y: (B, S, D) -> (B, S, D), aux loss. The dispatch and combine
    einsums of the JAX package, as matmuls over the flattened (E * C)
    slots; the experts as batched matmuls over E."""
    b, s, d = y.shape
    t, e = b * s, cfg.n_experts
    cap = capacity(cfg, t)
    yt = y.reshape(t, d)
    dispatch, combine, aux = _top2_dispatch(router_gates(y, lp), cap)
    # "tec,td->ecd"
    xs = (dispatch.reshape(t, e * cap).to(y.dtype).t() @ yt).reshape(
        e, cap, d)
    gate = F.silu(torch.bmm(xs, lp.w_gate))                  # "ecd,edm->ecm"
    up = torch.bmm(xs, lp.w_up)
    out = torch.bmm(gate * up, lp.w_down)                    # "ecm,emd->ecd"
    # "tec,ecd->td"
    yo = combine.reshape(t, e * cap).to(y.dtype) @ out.reshape(e * cap, d)
    return yo.reshape(b, s, d), aux


def _layer(cfg: MixtralConfig, x: torch.Tensor, lp: nn.Module,
           positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = llama.attention_block(cfg, x, lp, positions)
    y = llama.rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    moe_out, aux = _moe_mlp(cfg, y, lp)
    return x + moe_out, aux


def forward(cfg: MixtralConfig, params: MixtralParams, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None):
    """Token ids (B, S) -> (fp32 logits (B, S, vocab), router aux loss
    scaled by router_aux_weight / n_layers): training without the aux loss
    collapses the router."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = llama.embed_tokens(params, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        if cfg.remat:
            x, aux = checkpoint(lp, cfg, x, positions, use_reentrant=False)
        else:
            x, aux = lp(cfg, x, positions)
        aux_total = aux_total + aux
    logits = llama.lm_head(cfg, params, x)
    return logits, cfg.router_aux_weight * aux_total / cfg.n_layers
