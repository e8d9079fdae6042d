"""Llama-3-class decoder, training half: counterpart of
``skypilot_tpu/models/llama.py`` (config, init, forward and its blocks).

Parameters live in an ``nn.Module`` with one submodule per layer; every
weight keeps the JAX package's (in, out) orientation and is applied as
``y @ w``, so converting a JAX tree (``convert.llama_params_from_jax``) is
a copy along the stacked layer axis, never a transpose. Matmuls run in the
config dtype, norms and softmax statistics in fp32, logits in fp32.

Not in this slice: the int8 ``_scale`` weights and LoRA adapters of
``lora_dense``, the KV-cache decode paths, and the remat policies other
than "full".
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops.linear import matmul_f32

REMAT_POLICIES = ("full", "save_flash", "save_flash_qkv",
                  "save_flash_offload_qkv")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    attention_impl: str = "auto"  # auto|kernel|reference
    remat: bool = True
    # Only "full" (per-layer checkpoint, everything recomputed in the
    # backward) runs in this slice; the other names are recognised and
    # raise NotImplementedError.
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, dim=128, n_layers=4,
                           n_heads=8, n_kv_heads=4, mlp_dim=256,
                           max_seq_len=512)

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """fwd+bwd FLOPs per token: 6N over the parameter matmuls, plus,
        with ``seq_len``, the causal attention score/value matmuls."""
        p_layer = (self.dim * (self.n_heads + 2 * self.n_kv_heads) *
                   self.head_dim + self.n_heads * self.head_dim * self.dim +
                   3 * self.dim * self.mlp_dim)
        p = self.n_layers * p_layer + self.vocab_size * self.dim * (
            1 if self.tie_embeddings else 2)
        flops = 6.0 * p
        if seq_len is not None:
            flops += 6.0 * self.n_layers * seq_len * self.dim
        return flops

    def num_params(self) -> int:
        p_layer = (self.dim * (self.n_heads + 2 * self.n_kv_heads) *
                   self.head_dim + self.n_heads * self.head_dim * self.dim +
                   3 * self.dim * self.mlp_dim + 2 * self.dim)
        return (self.n_layers * p_layer + self.dim +
                self.vocab_size * self.dim * (1 if self.tie_embeddings else 2))


# (name, shape) of each layer weight, in the JAX tree's (in, out) layout.
def layer_shapes(cfg: LlamaConfig) -> dict:
    d, hd = cfg.dim, cfg.head_dim
    return {
        "attn_norm": (d,),
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
        "mlp_norm": (d,),
        "w_gate": (d, cfg.mlp_dim),
        "w_up": (d, cfg.mlp_dim),
        "w_down": (cfg.mlp_dim, d),
    }


def _empty(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class LlamaLayer(nn.Module):
    """One decoder layer's weights; ``forward`` is the JAX ``_layer``."""

    def __init__(self, cfg: LlamaConfig, device, dtype):
        super().__init__()
        for name, shape in layer_shapes(cfg).items():
            setattr(self, name, _empty(shape, device, dtype))

    def forward(self, cfg: LlamaConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        x = attention_block(cfg, x, self, positions)
        return mlp_block(cfg, x, self)


class LlamaParams(nn.Module):
    """The parameter tree: embed, layers[i], final_norm, lm_head (absent
    when the embeddings are tied)."""

    def __init__(self, cfg: LlamaConfig, device, dtype):
        super().__init__()
        self.embed = _empty((cfg.vocab_size, cfg.dim), device, dtype)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device, dtype) for _ in range(cfg.n_layers))
        self.final_norm = _empty((cfg.dim,), device, dtype)
        self.lm_head = (None if cfg.tie_embeddings else
                        _empty((cfg.dim, cfg.vocab_size), device, dtype))


@torch.no_grad()
def init(cfg: LlamaConfig, generator: torch.Generator,
         device: DeviceLike = None) -> LlamaParams:
    """Random init as the JAX package draws it (normal * fan_in^-0.5,
    norms at one), from ``generator``; the numbers differ from JAX's
    PRNG. ``device`` defaults to the card."""
    device = resolve_device(device)
    params = LlamaParams(cfg, device, cfg.dtype)

    def dense(p: torch.Tensor, fan_in: int) -> None:
        x = torch.randn(p.shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        p.copy_((x * fan_in ** -0.5).to(cfg.dtype))

    dense(params.embed, cfg.dim)
    for lp in params.layers:
        lp.attn_norm.fill_(1.0)
        lp.mlp_norm.fill_(1.0)
        for name in ("wq", "wk", "wv", "w_gate", "w_up"):
            dense(getattr(lp, name), cfg.dim)
        dense(lp.wo, cfg.n_heads * cfg.head_dim)
        dense(lp.w_down, cfg.mlp_dim)
    params.final_norm.fill_(1.0)
    if params.lm_head is not None:
        dense(params.lm_head, cfg.dim)
    return params


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    """Scale ``offset + w``: llama uses offset 0 (cast, then multiply in
    the weight dtype, as the JAX package does); gemma's offset 1 applies
    the scale in fp32 so small norm deltas survive."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed32 = x32 * torch.rsqrt(var + eps)
    if offset:
        return (normed32 * (w.float() + offset)).to(x.dtype)
    return normed32.to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, split-half (not interleaved pairs), fp32 angles.
    x: (B, S, H, D), positions: (B, S)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., None].float() * freqs          # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def qkv_proj(cfg, y: torch.Tensor, lp: nn.Module, positions: torch.Tensor):
    """Projection + RoPE; returns (q, k, v), v unroped."""
    b, t = y.shape[0], y.shape[1]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (y @ lp.wq).reshape(b, t, h, hd)
    kk = (y @ lp.wk).reshape(b, t, kvh, hd)
    vv = (y @ lp.wv).reshape(b, t, kvh, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(kk, positions, cfg.rope_theta), vv)


def _mlp_activation(cfg):
    name = getattr(cfg, "mlp_activation", "silu")
    if name == "silu":
        return F.silu
    if name == "gelu_tanh":
        return lambda a: F.gelu(a, approximate="tanh")
    raise ValueError(f"unknown mlp_activation {name!r}")


def mlp_block(cfg, x: torch.Tensor, lp: nn.Module) -> torch.Tensor:
    """Pre-norm gated-MLP residual block (SwiGLU or GeGLU by config)."""
    y = rms_norm(x, lp.mlp_norm, cfg.norm_eps,
                 getattr(cfg, "norm_offset", 0.0))
    gate = _mlp_activation(cfg)(y @ lp.w_gate)
    return x + (gate * (y @ lp.w_up)) @ lp.w_down


def attention_block(cfg, x: torch.Tensor, lp: nn.Module,
                    positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm GQA attention residual block."""
    b, s, _ = x.shape
    y = rms_norm(x, lp.attn_norm, cfg.norm_eps,
                 getattr(cfg, "norm_offset", 0.0))
    q, kk, vv = qkv_proj(cfg, y, lp, positions)
    attn = attention_ops.attention(q, kk, vv, causal=True,
                                   impl=cfg.attention_impl)
    return x + attn.reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp.wo


def embed_tokens(params: LlamaParams, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding: a gather (single device)."""
    return F.embedding(tokens, params.embed)


def head_weights(params: LlamaParams) -> torch.Tensor:
    """(dim, vocab) output projection: the untied head or embed^T."""
    return params.embed.t() if params.lm_head is None else params.lm_head


def _vocab_proj(params: LlamaParams, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) hidden -> fp32 logits, inputs in the working dtype."""
    return matmul_f32(x, head_weights(params))


def lm_head(cfg, params: LlamaParams, x: torch.Tensor) -> torch.Tensor:
    """Final norm + output projection, fp32 logits."""
    x = rms_norm(x, params.final_norm, cfg.norm_eps,
                 getattr(cfg, "norm_offset", 0.0))
    return _vocab_proj(params, x)


def _check_remat_policy(cfg) -> None:
    name = getattr(cfg, "remat_policy", "full")
    if name == "full":
        return
    if name in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat_policy {name!r} is not ported yet; use 'full'")
    raise ValueError(
        f"Unknown remat_policy {name!r}; expected 'full', 'save_flash', "
        "'save_flash_qkv' or 'save_flash_offload_qkv'.")


def forward_trunk(cfg: LlamaConfig, params: LlamaParams,
                  tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids (B, S) -> final-normed hidden states (B, S, dim)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens(params, tokens)
    scale = getattr(cfg, "embed_multiplier", 1.0)
    if scale != 1.0:  # gemma: embeddings scaled by sqrt(dim)
        x = (x.float() * scale).to(x.dtype)
    if cfg.remat:
        _check_remat_policy(cfg)
    for lp in params.layers:
        if cfg.remat:
            x = checkpoint(lp, cfg, x, positions, use_reentrant=False)
        else:
            x = lp(cfg, x, positions)
    return rms_norm(x, params.final_norm, cfg.norm_eps,
                    getattr(cfg, "norm_offset", 0.0))


def forward(cfg: LlamaConfig, params: LlamaParams, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids (B, S) -> fp32 logits (B, S, vocab)."""
    return _vocab_proj(params, forward_trunk(cfg, params, tokens, positions))
