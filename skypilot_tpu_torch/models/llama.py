"""Llama-3-class decoder: counterpart of ``skypilot_tpu/models/llama.py``
(config, init, forward and its blocks; the int8 serving tree and the
KV-cache decode paths).

Parameters live in an ``nn.Module`` with one submodule per layer; every
weight keeps the JAX package's (in, out) orientation and is applied as
``y @ w`` through ``lora_dense``, so converting a JAX tree
(``convert.llama_params_from_jax``) is a copy along the stacked layer axis,
never a transpose. Matmuls run in the config dtype, norms and softmax
statistics in fp32, logits in fp32.

A layer may carry, beside a weight ``<name>``, LoRA adapters
``<name>_lora_a`` (in, r) and ``<name>_lora_b`` (r, out), registered on it
by ``recipes.llama_lora.merge_params``, and ``lora_dense`` adds y @ A @ B;
or an int8 ``<name>`` with a per-output-channel f32 ``<name>_scale``.

Remat policies (``LlamaConfig.remat_policy``), the counterparts of
``_remat_policy`` there, applied per layer in ``forward_trunk``:

* ``"full"``: ``torch.utils.checkpoint`` of the whole layer; the backward
  re-runs it, the flash forward included (2L flash forwards per step).
* ``"save_flash"``: the flash op's outputs o and lse stay on the device;
  the backward recomputes the norms, projections, rope and MLP around
  them but never the flash forward (L per step).
* ``"save_flash_qkv"``: as ``save_flash``, and the roped q/k/v stay too,
  so ``qkv_proj`` runs once per layer and step; the backward takes the
  projection's transposes from the saved q/k/v cotangents directly.
* ``"save_flash_offload_qkv"``: as ``save_flash_qkv``, but q/k/v wait in
  pinned host memory between the forward and the backward
  (``offload_to_host``); o and lse stay on the device.

All four take adapters: the save_flash* backward computes each adapter's
gradient (dA = y^T (g B^T), dB = (y A)^T g) and a frozen weight
(``requires_grad=False``) gets none.

The three ``save_flash*`` policies are one explicit per-layer
``autograd.Function`` (``_FlashRematLayer``) that calls the flash op's
forward and backward halves itself and recomputes exactly what its policy
drops. ``torch.utils.checkpoint``'s selective policy cannot do this: it
re-runs the whole layer function in the backward, returning cached
outputs only for the ops it saved, so ``qkv_proj`` would still run twice;
and it cannot offload. As in the JAX package, whose names live on its
flash path only, a layer whose attention takes the reference path (the
reference impl, or a shape the flash path refuses) has nothing to name and
runs the ``"full"`` policy.

Serving (below the training half): ``quantize_params`` (int8 codes plus
per-output-channel f32 scales), the dense KV cache (``init_cache``,
``forward_with_cache``), the paged block pool (``init_paged_cache``,
``forward_with_paged_cache``, int8 codes plus per-(layer, block, kv_head)
scales), the speculative verify window (``verify_step``,
``verify_step_paged``) and ``decode``. Their attention is the JAX
package's split-KV online softmax, written as torch ops as it is XLA
there: one tile function (``_attn_tile``) for the dense and the paged
loop, so paged output equals dense bit for bit when the tiles align.

Cache tensors are updated in place (the JAX package donates them), and
each forward returns the same cache it was given. The host-side values
of a forward (``start_pos``, ``valid_len``, ``logits_at``, ``write_pos``
and the block table) are read to the host once per forward, never per
layer: the split-KV loop bound and the write indices come from them, so
a caller that passes them as Python ints, lists or numpy arrays (as the
decode engine does) makes a forward that never waits on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch import DeviceLike, resolve_device, to_device
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops import flash_attention as flash_ops
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
    # One of REMAT_POLICIES; see the module docstring.
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
    """One decoder layer's weights (``layer_shapes``, and any adapters
    registered beside them); ``forward`` is the JAX ``_layer``."""

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


def lora_dense(y: torch.Tensor, lp: nn.Module, name: str) -> torch.Tensor:
    """y @ W, plus the low-rank path (y @ A) @ B when the layer carries
    ``<name>_lora_a`` / ``<name>_lora_b`` (never the full-rank delta).

    With a ``<name>_scale`` the weight is int8: the codes are cast to y's
    dtype, the product runs as usual and the per-output-channel f32 scale
    multiplies it in fp32, as the JAX package's ``lora_dense`` does."""
    w = getattr(lp, name)
    scale = getattr(lp, name + "_scale", None)
    if scale is None:
        out = y @ w
    else:
        out = ((y @ w.to(y.dtype)).float() * scale).to(y.dtype)
    a = getattr(lp, name + "_lora_a", None)
    if a is not None:
        out = out + (y @ a) @ getattr(lp, name + "_lora_b")
    return out


def qkv_proj(cfg, y: torch.Tensor, lp: nn.Module, positions: torch.Tensor):
    """Projection + RoPE; returns (q, k, v), v unroped."""
    b, t = y.shape[0], y.shape[1]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = lora_dense(y, lp, "wq").reshape(b, t, h, hd)
    kk = lora_dense(y, lp, "wk").reshape(b, t, kvh, hd)
    vv = lora_dense(y, lp, "wv").reshape(b, t, kvh, hd)
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
    gate = _mlp_activation(cfg)(lora_dense(y, lp, "w_gate"))
    return x + lora_dense(gate * lora_dense(y, lp, "w_up"), lp, "w_down")


def _attn_residual(cfg, x: torch.Tensor, attn: torch.Tensor,
                   lp: nn.Module) -> torch.Tensor:
    b, s, _ = x.shape
    return x + lora_dense(attn.reshape(b, s, cfg.n_heads * cfg.head_dim), lp,
                          "wo")


def _attn_norm(cfg, x: torch.Tensor, lp: nn.Module) -> torch.Tensor:
    return rms_norm(x, lp.attn_norm, cfg.norm_eps,
                    getattr(cfg, "norm_offset", 0.0))


def attention_block(cfg, x: torch.Tensor, lp: nn.Module,
                    positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm GQA attention residual block."""
    q, kk, vv = qkv_proj(cfg, _attn_norm(cfg, x, lp), lp, positions)
    attn = attention_ops.attention(q, kk, vv, causal=True,
                                   impl=cfg.attention_impl)
    return _attn_residual(cfg, x, attn, lp)


def embed_tokens(params: LlamaParams, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding: a gather (single device)."""
    return F.embedding(tokens, params.embed)


def head_weights(params: LlamaParams) -> torch.Tensor:
    """(dim, vocab) output projection: the untied head or embed^T."""
    return params.embed.t() if params.lm_head is None else params.lm_head


def _vocab_proj(params: LlamaParams, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) hidden -> fp32 logits, inputs in the working dtype. An
    int8 head's per-vocab-channel scale (``embed_scale`` for a tied head:
    the table's per-row scale is the head's per-column one) folds into
    the f32 logits."""
    logits = matmul_f32(x, head_weights(params))
    scale = getattr(params, "lm_head_scale" if params.lm_head is not None
                    else "embed_scale", None)
    if scale is not None:
        logits = logits * scale
    return logits


def lm_head(cfg, params: LlamaParams, x: torch.Tensor) -> torch.Tensor:
    """Final norm + output projection, fp32 logits."""
    x = rms_norm(x, params.final_norm, cfg.norm_eps,
                 getattr(cfg, "norm_offset", 0.0))
    return _vocab_proj(params, x)


def _remat_policy(cfg) -> str:
    name = getattr(cfg, "remat_policy", "full")
    if name not in REMAT_POLICIES:
        # A typo silently degrading to full remat would re-run the
        # quadratic kernel every backward: the cost the knob avoids.
        raise ValueError(
            f"Unknown remat_policy {name!r}; expected 'full', 'save_flash', "
            "'save_flash_qkv' or 'save_flash_offload_qkv'.")
    return name


# ------------------------------------------------ the save_flash* policies

_COPY_STREAMS: dict = {}


def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    stream = _COPY_STREAMS.get(device)
    if stream is None:
        stream = _COPY_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def offload_to_host(t: torch.Tensor) -> tuple:
    """Park a CUDA tensor in pinned host memory: the copy runs on a side
    stream after the producing work, so it overlaps the rest of the
    forward. A CPU tensor stays where it is (there is no pinned memory to
    move it to). Returns the handle ``reload_from_host`` takes."""
    if not t.is_cuda:
        return t, None
    main = torch.cuda.current_stream(t.device)
    side = _copy_stream(t.device)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        host.copy_(t, non_blocking=True)
    t.record_stream(side)  # its memory is not reused before the copy ends
    return host, t.device


def reload_from_host(handle: tuple) -> Tuple[torch.Tensor, object]:
    """Start copying a parked tensor back on the side stream, behind its
    copy out and ahead of the work already queued on the current stream:
    (tensor, event the current stream must wait for before reading it, or
    None)."""
    host, device = handle
    if device is None:
        return host, None
    side = _copy_stream(device)
    with torch.cuda.stream(side):
        t = host.to(device, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(side)
    t.record_stream(torch.cuda.current_stream(device))
    return t, ready


def _grads(outputs, inputs: dict, grad_outputs) -> dict:
    """{name: gradient} for the inputs that require one."""
    names = [n for n, t in inputs.items() if t.requires_grad]
    if not names:
        return {}
    got = torch.autograd.grad(outputs, [inputs[n] for n in names],
                              grad_outputs)
    return dict(zip(names, got))


def layer_param_names(lp: nn.Module) -> Tuple[str, ...]:
    """The layer's own parameters: its weights and any adapters."""
    return tuple(n for n, _ in lp.named_parameters(recurse=False))


# The weights of the norm + qkv_proj segment; the rest of a layer (wo and
# the MLP) is its residual + MLP segment.
_PRE_WEIGHTS = ("attn_norm", "wq", "wk", "wv")


def _in_pre(name: str) -> bool:
    """Whether a weight, its scale or its adapter belongs to the norm +
    qkv_proj segment."""
    return name.split("_lora_")[0].removesuffix("_scale") in _PRE_WEIGHTS


def _dense_backward(y2: torch.Tensor, g: torch.Tensor, lp: nn.Module,
                    name: str, out: dict) -> torch.Tensor:
    """The transpose of ``lora_dense`` at rows y2 (N, in) for the
    cotangent g (N, out): the gradients of the weight (an int8 one has
    none), its scale and its adapters that require one go into ``out``;
    returns y2's cotangent."""
    w = getattr(lp, name)
    scale = getattr(lp, name + "_scale", None)
    if scale is None:
        if w.requires_grad:
            out[name] = y2.t() @ g
        gy = g @ w.t()
    else:
        w = w.to(g.dtype)
        if scale.requires_grad:
            out[name + "_scale"] = ((y2 @ w).float() * g.float()).sum(0)
        gy = (g.float() * scale).to(g.dtype) @ w.t()
    a = getattr(lp, name + "_lora_a", None)
    if a is not None:
        b = getattr(lp, name + "_lora_b")
        gb = g @ b.t()
        if a.requires_grad:
            out[name + "_lora_a"] = y2.t() @ gb
        if b.requires_grad:
            out[name + "_lora_b"] = (y2 @ a).t() @ g
        gy = gy + gb @ a.t()
    return gy


def _qkv_proj_backward(cfg, lp: nn.Module, x: torch.Tensor,
                       positions: torch.Tensor, dq: torch.Tensor,
                       dk: torch.Tensor, dv: torch.Tensor) -> dict:
    """Gradients of the norm + qkv_proj segment from the cotangents of its
    saved outputs, without re-running the projections: rope is a rotation,
    so its transpose is rope at -positions; each projection's transpose is
    ``_dense_backward``; the norm is recomputed under autograd."""
    with torch.enable_grad():
        x_ = x.detach().requires_grad_(x.requires_grad)
        y = _attn_norm(cfg, x_, lp)
    b, s, dim = y.shape
    y2 = y.detach().reshape(b * s, dim)
    g = {"wq": rope(dq, -positions, cfg.rope_theta).reshape(b * s, -1),
         "wk": rope(dk, -positions, cfg.rope_theta).reshape(b * s, -1),
         "wv": dv.reshape(b * s, -1)}
    out: dict = {}
    gy = sum(_dense_backward(y2, g[n], lp, n, out) for n in g)
    out.update(_grads(y, {"x": x_, "attn_norm": lp.attn_norm},
                      gy.reshape(b, s, dim)))
    return out


class _FlashRematLayer(torch.autograd.Function):
    """One decoder layer under a save_flash* policy (module docstring).

    Forward, without a graph: norm, qkv_proj, the flash forward (its
    family picked from the shape), the residual and the MLP. Saved: the
    layer input, o and lse, and under *_qkv the roped q/k/v (on the device
    or parked on the host). Backward: recompute the residual + MLP from x
    and o under autograd for their gradients and dO; the flash backward of
    the same family; then the norm + qkv_proj segment, recomputed under
    autograd (save_flash) or from the saved q/k/v (``_qkv_proj_backward``).
    """

    @staticmethod
    def forward(ctx, cfg, policy: str, lp: nn.Module, x: torch.Tensor,
                positions: torch.Tensor, *weights: torch.Tensor):
        # ``weights`` are lp's parameters (``layer_param_names``), passed so
        # that autograd routes their gradients through backward; the body
        # reads them from lp.
        s, hd = x.shape[1], cfg.head_dim
        scale = hd ** -0.5
        fam = flash_ops.family(s, hd, True)
        q, k, v = qkv_proj(cfg, _attn_norm(cfg, x, lp), lp, positions)
        o, lse = flash_ops.flash_forward(q, k, v, True, scale, fam)
        out = mlp_block(cfg, _attn_residual(cfg, x, o, lp), lp)
        ctx.cfg, ctx.policy, ctx.lp = cfg, policy, lp
        ctx.scale, ctx.family = scale, fam
        ctx.parked = None
        if policy == "save_flash":
            ctx.save_for_backward(x, positions, o, lse)
        elif policy == "save_flash_qkv":
            ctx.save_for_backward(x, positions, o, lse, q, k, v)
        else:
            ctx.save_for_backward(x, positions, o, lse)
            ctx.parked = [offload_to_host(t) for t in (q, k, v)]
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        cfg, lp = ctx.cfg, ctx.lp
        x, positions, o, lse, *qkv = ctx.saved_tensors
        ready = []
        if ctx.parked is not None:  # the copies back overlap the MLP work
            qkv, ready = zip(*map(reload_from_host, ctx.parked))
            ctx.parked = None
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(x.requires_grad)
            o_ = o.detach().requires_grad_()
            out = mlp_block(cfg, _attn_residual(cfg, x_, o_, lp), lp)
        names = layer_param_names(lp)
        post = {"x": x_, "o": o_}
        post.update((n, getattr(lp, n)) for n in names if not _in_pre(n))
        grads = _grads(out, post, g)
        do = grads.pop("o")
        dx = grads.pop("x", None)

        if ctx.policy == "save_flash":
            with torch.enable_grad():
                x_ = x.detach().requires_grad_(x.requires_grad)
                qkv = qkv_proj(cfg, _attn_norm(cfg, x_, lp), lp, positions)
            dqkv = flash_ops.flash_backward(
                *(t.detach() for t in qkv), o, lse, do, True, ctx.scale,
                ctx.family)
            pre = {"x": x_}
            pre.update((n, getattr(lp, n)) for n in names if _in_pre(n))
            grads.update(_grads(qkv, pre, dqkv))
        else:
            for ev in ready:
                if ev is not None:
                    torch.cuda.current_stream(o.device).wait_event(ev)
            dqkv = flash_ops.flash_backward(*qkv, o, lse, do, True,
                                            ctx.scale, ctx.family)
            grads.update(_qkv_proj_backward(cfg, lp, x, positions, *dqkv))
        if dx is not None:
            dx = dx + grads.pop("x")
        return (None, None, None, dx, None, *(grads.get(n) for n in names))


def _flash_remat_applies(cfg, x: torch.Tensor) -> bool:
    impl = cfg.attention_impl
    if impl == "auto":
        impl = "kernel" if x.is_cuda else "reference"
    b, s = x.shape[0], x.shape[1]
    return impl == "kernel" and flash_ops.takes_kernel_path(
        (b, s, cfg.n_heads, cfg.head_dim),
        (b, s, cfg.n_kv_heads, cfg.head_dim))


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
    policy = _remat_policy(cfg) if cfg.remat else None
    if policy not in (None, "full") and not _flash_remat_applies(cfg, x):
        policy = "full"
    for lp in params.layers:
        if policy is None:
            x = lp(cfg, x, positions)
        elif policy == "full":
            x = checkpoint(lp, cfg, x, positions, use_reentrant=False)
        else:
            x = _FlashRematLayer.apply(
                cfg, policy, lp, x, positions,
                *(getattr(lp, n) for n in layer_param_names(lp)))
    return rms_norm(x, params.final_norm, cfg.norm_eps,
                    getattr(cfg, "norm_offset", 0.0))


def forward(cfg: LlamaConfig, params: LlamaParams, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids (B, S) -> fp32 logits (B, S, vocab)."""
    return _vocab_proj(params, forward_trunk(cfg, params, tokens, positions))


# ------------------------------------------------------ int8 serving tree

# Layer weights the int8 serving path quantizes (norms stay in their
# dtype, as in the JAX package).
QUANT_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                       "w_down")


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` rounded as a true division: CUDA divides by a host
    scalar as a multiply by its reciprocal, which can round otherwise."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _quantize_weight(w: torch.Tensor,
                     reduce_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8: absmax over the in-features axis
    (``reduce_axis``), one f32 scale per output channel, codes in
    [-127, 127]."""
    wf = w.float()
    scale = torch.clamp(_div(wf.abs().amax(dim=reduce_axis), 127.0),
                        min=1e-8)
    q = torch.round(wf / scale.unsqueeze(reduce_axis))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


@torch.no_grad()
def quantize_params(cfg: LlamaConfig, params: LlamaParams) -> LlamaParams:
    """The int8 serving tree: every matmul weight becomes int8 codes plus
    a per-output-channel f32 ``<name>_scale`` (the embed table's scale is
    per vocab row, which is also a tied head's per-column scale). A new
    module of ``params``' shape; norms are shared with ``params``, not
    copied. ``lora_dense``, ``_decode_embed`` and ``_vocab_proj`` read the
    scales."""
    out = LlamaParams(cfg, "meta", cfg.dtype)
    codes, scale = _quantize_weight(params.embed, -1)
    out.embed, out.embed_scale = _frozen(codes), _frozen(scale)
    out.final_norm = params.final_norm
    if params.lm_head is not None:
        codes, scale = _quantize_weight(params.lm_head, -2)
        out.lm_head, out.lm_head_scale = _frozen(codes), _frozen(scale)
    for src, dst in zip(params.layers, out.layers):
        dst.attn_norm, dst.mlp_norm = src.attn_norm, src.mlp_norm
        for name in QUANT_LAYER_WEIGHTS:
            codes, scale = _quantize_weight(getattr(src, name), -2)
            setattr(dst, name, _frozen(codes))
            setattr(dst, name + "_scale", _frozen(scale))
    return out


def params_quantized(params: nn.Module) -> bool:
    """True when ``params`` is a :func:`quantize_params` tree."""
    return getattr(params, "embed_scale", None) is not None


def _decode_embed(cfg, params: LlamaParams,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding gather for the serving paths, dequantizing the
    per-row scales of an int8 table and applying gemma's sqrt(dim) embed
    multiplier, rounded as the JAX package rounds them: the row scale
    times the multiplier in f32, then one cast."""
    x = params.embed[tokens]
    row_scale = getattr(params, "embed_scale", None)
    mult = getattr(cfg, "embed_multiplier", 1.0)
    if row_scale is not None:
        x = (x.float() * (row_scale[tokens][..., None] * mult)).to(cfg.dtype)
    elif mult != 1.0:
        x = (x.float() * mult).to(x.dtype)
    return x


# ----------------------------------------------------------- KV-cache decode

# KV rows read per split-KV tile.
SPLIT_KV_BLOCK = 256

Cache = Dict[str, torch.Tensor]


def init_cache(cfg, batch: int, max_seq: int,
               device: DeviceLike = None) -> Cache:
    """Per-layer KV cache (layers, batch, max_seq, kv_heads, head_dim),
    zeros in the config dtype; ``device`` defaults to the card."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def init_paged_cache(cfg, num_blocks: int, block_tokens: int, *,
                     quantized: bool = False,
                     device: DeviceLike = None) -> Cache:
    """ONE paged KV pool shared by every engine slot and the prefix
    cache: (layers, num_blocks, block_tokens, kv_heads, head_dim); block 0
    is the scratch block free slots write into. ``quantized`` stores int8
    codes plus per-(layer, block, kv_head) f32 ``k_scale``/``v_scale``."""
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_tokens, cfg.n_kv_heads,
             cfg.head_dim)
    if not quantized:
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    sshape = (cfg.n_layers, num_blocks, cfg.n_kv_heads)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device)}


def _attn_tile(qf, scale: float, kb, vb, msk, m, el, acc):
    """One online-softmax tile (running max / normalizer / accumulator),
    shared by the dense and paged loops so both are the same arithmetic
    term for term. qf: (B, T, KVH, G, D) f32; kb/vb: (B, W, KVH, D) f32;
    msk: (B, T, W) bool. Returns (m, el, acc) updated."""
    s_blk = torch.einsum("btkgd,bskd->bkgts", qf, kb) * scale
    mk = msk[:, None, None]
    s_blk = torch.where(mk, s_blk, -1e30)
    m_new = torch.maximum(m, s_blk.amax(dim=-1))
    corr = torch.exp(m - m_new)
    # Masked entries multiplied to exactly 0 (not just exp(-big)): a
    # fully-masked slot (a free engine slot) must stay finite.
    p = torch.exp(s_blk - m_new[..., None]) * mk
    el = el * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgts,bskd->btkgd", p, vb)
    corr_t = corr.permute(0, 3, 1, 2)[..., None]
    return m_new, el, acc * corr_t + pv


def _attn_carry(b: int, t: int, kvh: int, g: int, d: int, device):
    f32 = torch.float32
    return (torch.full((b, kvh, g, t), -1e30, dtype=f32, device=device),
            torch.zeros((b, kvh, g, t), dtype=f32, device=device),
            torch.zeros((b, t, kvh, g, d), dtype=f32, device=device))


def _attn_normalize(el: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    el_t = el.permute(0, 3, 1, 2)[..., None]
    return torch.where(el_t > 0, acc / torch.clamp(el_t, min=1e-30), 0.0)


def _tile_mask(s0: int, start: int, width: int, positions: torch.Tensor,
               valid_len: torch.Tensor) -> torch.Tensor:
    kpos = start + torch.arange(width, device=positions.device)
    return ((kpos >= s0) & (kpos <= positions[..., None]) &
            (kpos < valid_len[:, None, None]))


def _loop_limit(positions: np.ndarray, valid_len: np.ndarray,
                rows: int) -> int:
    """Rows any query of the batch can attend: the batch max of
    min(its last position + 1, valid_len), capped at ``rows``."""
    return int(min(np.max(np.minimum(positions[:, -1] + 1, valid_len)),
                   rows))


def _split_kv_attention(qg: torch.Tensor, ck: torch.Tensor,
                        cv: torch.Tensor, positions: torch.Tensor,
                        valid_len: torch.Tensor, limit: int,
                        block: Optional[int] = None) -> torch.Tensor:
    """Flash-decode attention against the ragged dense cache: key tiles
    of ``block`` rows with an online softmax, up to ``limit`` rows (the
    longest frontier in the batch, a host int). When ``block`` does not
    divide max_seq, the final tile clamps back to max_seq - block and the
    rows before its nominal start are masked. qg: (B, T, KVH, G, D);
    ck/cv: (B, max_seq, KVH, D); positions (B, T), valid_len (B,) on the
    device. Returns f32 (B, T, KVH, G, D)."""
    b, t, kvh, g, d = qg.shape
    max_seq = ck.shape[1]
    block = min(block or SPLIT_KV_BLOCK, max_seq)
    qf = qg.float()
    scale = d ** -0.5
    m, el, acc = _attn_carry(b, t, kvh, g, d, qg.device)
    for s0 in range(0, limit, block):
        start = min(s0, max_seq - block)
        kb = ck[:, start:start + block].float().contiguous()
        vb = cv[:, start:start + block].float().contiguous()
        msk = _tile_mask(s0, start, block, positions, valid_len)
        m, el, acc = _attn_tile(qf, scale, kb, vb, msk, m, el, acc)
    return _attn_normalize(el, acc)


def _paged_split_kv_attention(qg: torch.Tensor, pk: torch.Tensor,
                              pv: torch.Tensor, table: torch.Tensor,
                              positions: torch.Tensor,
                              valid_len: torch.Tensor, limit: int,
                              window: int,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Split-KV attention reading K/V through per-slot block tables:
    each tile gathers ``window // block_tokens`` blocks per slot
    (``table[b, j]`` names the physical block of slot b's logical chunk
    j), reassembles the (B, W, KVH, D) tile the dense loop slices, and
    runs the same ``_attn_tile`` (dequantized by the blocks' per-head
    scales when the pool is int8). pk/pv: one layer's pool (NB, BT, KVH,
    D); table (B, table_len) on the device; ``limit`` a host int."""
    b, t, kvh, g, d = qg.shape
    bt = pk.shape[1]
    nb_win = window // bt
    if nb_win * bt != window:
        raise ValueError(f"window {window} must be a multiple of the "
                         f"block size {bt}")
    qf = qg.float()
    scale = d ** -0.5
    m, el, acc = _attn_carry(b, t, kvh, g, d, qg.device)
    last = table.shape[1] - nb_win
    for s0 in range(0, limit, window):
        c = min(s0 // bt, last)
        phys = table[:, c:c + nb_win]                       # (B, nbw)
        kb = pk[phys].float()                  # (B, nbw, bt, KVH, D)
        vb = pv[phys].float()
        if k_scale is not None:
            kb = kb * k_scale[phys][:, :, None, :, None]
            vb = vb * v_scale[phys][:, :, None, :, None]
        kb = kb.reshape(b, window, kvh, d)
        vb = vb.reshape(b, window, kvh, d)
        msk = _tile_mask(s0, s0, window, positions, valid_len)
        m, el, acc = _attn_tile(qf, scale, kb, vb, msk, m, el, acc)
    return _attn_normalize(el, acc)


def _host_ints(v, b: int) -> np.ndarray:
    """A scalar or (B,) of ints (int, list, numpy or tensor) as a host
    (B,) int64 array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    v = np.asarray(v, dtype=np.int64)
    return np.broadcast_to(v, (b,)).copy() if v.ndim == 0 else v


def _host_array(v) -> Optional[np.ndarray]:
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.int64)


class _Step:
    """What one cached forward reads from the host, computed once so no
    layer does: per-slot start positions and valid lengths, the split-KV
    loop bound, and the write indices, uploaded without waiting on the
    device."""

    def __init__(self, tokens: torch.Tensor, start_pos, valid_len,
                 rows: int):
        b, t = tokens.shape
        self.device = tokens.device
        self.start = _host_ints(start_pos, b)
        self.valid = (self.start + t if valid_len is None
                      else _host_ints(valid_len, b))
        pos = self.start[:, None] + np.arange(t)[None, :]
        self.positions = to_device(pos, self.device)
        self.valid_dev = to_device(self.valid, self.device)
        self.limit = _loop_limit(pos, self.valid, rows)


class _DenseStep(_Step):
    """A forward against the dense cache: each token's (slot, column,
    row) write. Without ``write_pos`` a slot's T rows start at its start
    position, clamped so they fit (as ``dynamic_update_slice`` clamps);
    with it (the verify window) each token has its own row and rows
    outside the cache are dropped."""

    def __init__(self, tokens, start_pos, valid_len, write_pos,
                 max_seq: int):
        super().__init__(tokens, start_pos, valid_len, max_seq)
        b, t = tokens.shape
        if write_pos is None:
            rows = (np.minimum(self.start, max_seq - t)[:, None] +
                    np.arange(t)[None, :])
            bs, ts = np.divmod(np.arange(b * t), t)
        else:
            bs, ts = np.nonzero((write_pos >= 0) & (write_pos < max_seq))
            rows = write_pos
        rs = rows[bs, ts]
        self.write = tuple(to_device(a, self.device) for a in (bs, ts, rs))


def _residual_attn(cfg, x: torch.Tensor, attn: torch.Tensor,
                   lp: nn.Module) -> torch.Tensor:
    return _attn_residual(cfg, x, attn.to(x.dtype), lp)


def cached_attention_block(cfg, x: torch.Tensor, lp: nn.Module,
                           ck: torch.Tensor, cv: torch.Tensor,
                           step: _DenseStep,
                           block: Optional[int] = None) -> torch.Tensor:
    """One pre-norm GQA attention residual block against the dense
    cache: one layer's ck/cv, written in place at ``step``'s rows, then
    attended up to each slot's frontier. Returns x + attn_out."""
    b, t = x.shape[0], x.shape[1]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k_new, v_new = qkv_proj(cfg, _attn_norm(cfg, x, lp), lp,
                               step.positions)
    bi, ti, ri = step.write
    ck.index_put_((bi, ri), k_new[bi, ti].to(ck.dtype))
    cv.index_put_((bi, ri), v_new[bi, ti].to(cv.dtype))
    qg = q.reshape(b, t, kvh, h // kvh, hd)
    attn = _split_kv_attention(qg, ck, cv, step.positions, step.valid_dev,
                               step.limit, block)
    return _residual_attn(cfg, x, attn.reshape(b, t, h * hd), lp)


def _read_out(x: torch.Tensor, logits_at) -> torch.Tensor:
    """x (B, T, D) at the chunk-relative ``logits_at`` (a scalar or a
    per-slot (B,)): (B, 1, D)."""
    at = _host_array(logits_at)
    if at is None:
        return x
    if at.ndim == 0:
        return x[:, int(at):int(at) + 1]
    b = x.shape[0]
    return x[torch.arange(b, device=x.device), to_device(at, x.device)][
        :, None]


def forward_with_cache(cfg, params: LlamaParams, tokens: torch.Tensor,
                       cache: Cache, start_pos, valid_len=None,
                       logits_at=None, *, write_pos=None,
                       block: Optional[int] = None
                       ) -> Tuple[torch.Tensor, Cache]:
    """Incremental forward: tokens (B, T) at positions [start_pos,
    start_pos + T), reading and writing the dense cache in place.
    ``start_pos``, ``valid_len`` (default start_pos + T: cache rows at or
    past it are masked) and ``logits_at`` (chunk-relative read-out, (B,
    1, vocab)) take a scalar or a per-slot (B,). ``write_pos`` (B, T)
    selects the verify window's per-token writes; ``block`` the split-KV
    tile width (SPLIT_KV_BLOCK by default). Returns (fp32 logits, cache)."""
    step = _DenseStep(tokens, start_pos, valid_len, _host_array(write_pos),
                      cache["k"].shape[2])
    x = _decode_embed(cfg, params, tokens)
    for i, lp in enumerate(params.layers):
        x = cached_attention_block(cfg, x, lp, cache["k"][i],
                                   cache["v"][i], step, block)
        x = mlp_block(cfg, x, lp)
    return lm_head(cfg, params, _read_out(x, logits_at)), cache


def _quant_scatter_row(pk: torch.Tensor, ks: torch.Tensor,
                       blk: torch.Tensor, off: torch.Tensor,
                       row: torch.Tensor) -> None:
    """Scatter one new K/V row per slot into the int8 pool in place,
    keeping one scale per (block, head). In code space: the row's absmax
    can only grow the block's scale, and when it does not the rescale
    ratio is exactly 1, so resident codes round back to themselves.
    ``off == 0`` (a freshly granted block) resets the inherited scale.
    Free slots write to the scratch block (duplicates there: last write
    wins, never attended). pk: (NB, BT, KVH, D) int8; ks: (NB, KVH) f32;
    blk/off: (B,) on the device; row: (B, KVH, D)."""
    b = blk.shape[0]
    cur = pk[blk].float()                              # (B, BT, KVH, D)
    old_s = torch.where((off == 0)[:, None], 0.0, ks[blk])   # (B, KVH)
    rf = row.float()
    row_s = _div(rf.abs().amax(dim=-1), 127.0)
    new_s = torch.clamp(torch.maximum(old_s, row_s), min=1e-8)
    ratio = (old_s / new_s)[:, None, :, None]
    scaled = torch.round(cur * ratio)
    scaled[torch.arange(b, device=blk.device), off] = torch.round(
        rf / new_s[..., None])
    pk[blk] = torch.clamp(scaled, -127, 127).to(torch.int8)
    ks[blk] = new_s


def _quant_block_write(pk: torch.Tensor, ks: torch.Tensor,
                       write_block: int, rows: torch.Tensor,
                       valid_rows: torch.Tensor) -> None:
    """Whole-block int8 overwrite in place (single-slot chunk prefill): a
    fresh per-(block, head) scale from the chunk's valid rows only (a
    right-padded final chunk's junk rows never inflate it), then every
    row quantized under it. rows: (BT, KVH, D); valid_rows: (BT,) bool."""
    rf = rows.float()
    masked = torch.where(valid_rows[:, None, None], rf.abs(), 0.0)
    s = torch.clamp(_div(masked.amax(dim=(0, 2)), 127.0), min=1e-8)
    pk[write_block] = torch.clamp(torch.round(rf / s[None, :, None]),
                                  -127, 127).to(torch.int8)
    ks[write_block] = s


class _PagedStep(_Step):
    """A forward against the paged pool: the block table (on the device,
    for the gather) and each token's (block, offset) write. The verify
    window (``write_pos``) and T == 1 write rows through the table (junk
    columns and free slots to the scratch block 0); a longer T is the
    single-slot chunk prefill, which writes a whole block."""

    def __init__(self, tokens, table, start_pos, valid_len, write_pos,
                 block_tokens: int):
        table = _host_array(table)
        bt = block_tokens
        super().__init__(tokens, start_pos, valid_len, table.shape[1] * bt)
        self.table = to_device(table, self.device)
        b, t = tokens.shape
        self.rows = None
        if write_pos is not None:
            ok = write_pos < table.shape[1] * bt
            blk_idx = np.clip(write_pos // bt, 0, table.shape[1] - 1)
            blk = np.where(ok, np.take_along_axis(table, blk_idx, axis=1),
                           0)
            off = np.where(ok, write_pos % bt, 0)
        elif t == 1:
            blk = table[np.arange(b), self.start // bt][:, None]
            off = (self.start % bt)[:, None]
        else:
            return
        self.rows = (to_device(blk, self.device), to_device(off, self.device))


def paged_attention_block(cfg, x: torch.Tensor, lp: nn.Module,
                          pk: torch.Tensor, pv: torch.Tensor,
                          step: _PagedStep, window: int,
                          write_block: Optional[int],
                          ks: Optional[torch.Tensor] = None,
                          vs: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """One pre-norm GQA attention residual block against the paged pool
    (one layer's pk/pv and, int8, ks/vs; all written in place): row
    writes through the table (``step.rows``: each slot's new row, or a
    verify window's columns in order), or the single-slot chunk
    prefill's whole block ``write_block`` (B == 1, T == block_tokens).
    Returns x + attn_out."""
    b, t = x.shape[0], x.shape[1]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bt = pk.shape[1]
    quant = ks is not None
    q, k_new, v_new = qkv_proj(cfg, _attn_norm(cfg, x, lp), lp,
                               step.positions)
    if step.rows is not None:
        blk, off = step.rows
        if quant:
            # Columns in order: a verify window's positions are
            # consecutive, so a block boundary (off == 0, scale reset) is
            # crossed before that block's later offsets are written.
            for j in range(t):
                _quant_scatter_row(pk, ks, blk[:, j], off[:, j],
                                   k_new[:, j])
                _quant_scatter_row(pv, vs, blk[:, j], off[:, j],
                                   v_new[:, j])
        else:
            pk.index_put_((blk, off), k_new.to(pk.dtype))
            pv.index_put_((blk, off), v_new.to(pv.dtype))
    else:
        if b != 1 or t != bt or write_block is None:
            raise ValueError(
                "paged chunk prefill needs B == 1, T == block_tokens "
                "and a write_block (chunk-aligned whole-block write); "
                f"got B={b}, T={t}, block_tokens={bt}")
        if quant:
            valid_rows = step.positions[0] < int(step.valid[0])
            _quant_block_write(pk, ks, write_block, k_new[0], valid_rows)
            _quant_block_write(pv, vs, write_block, v_new[0], valid_rows)
        else:
            pk[write_block] = k_new[0].to(pk.dtype)
            pv[write_block] = v_new[0].to(pv.dtype)
    qg = q.reshape(b, t, kvh, h // kvh, hd)
    attn = _paged_split_kv_attention(qg, pk, pv, step.table,
                                     step.positions, step.valid_dev,
                                     step.limit, window, ks, vs)
    return _residual_attn(cfg, x, attn.reshape(b, t, h * hd), lp)


def forward_with_paged_cache(cfg, params: LlamaParams, tokens: torch.Tensor,
                             cache: Cache, table, start_pos,
                             valid_len=None, logits_at=None, *,
                             window: int, write_block: Optional[int] = None,
                             write_pos=None
                             ) -> Tuple[torch.Tensor, Cache]:
    """Incremental forward against the paged pool (``init_paged_cache``,
    updated in place) through ``table`` (B, table_len) block tables; the
    scalar-or-(B,) ``start_pos``/``valid_len``/``logits_at`` contract of
    :func:`forward_with_cache`. ``window`` is the attention tile width
    (match the dense ``min(SPLIT_KV_BLOCK, max_seq)`` for bit parity);
    ``write_block`` the single-slot prefill's target block. Returns (fp32
    logits, cache)."""
    step = _PagedStep(tokens, table, start_pos, valid_len,
                      _host_array(write_pos), cache["k"].shape[2])
    wb = None if write_block is None else int(write_block)
    quant = "k_scale" in cache
    x = _decode_embed(cfg, params, tokens)
    for i, lp in enumerate(params.layers):
        x = paged_attention_block(
            cfg, x, lp, cache["k"][i], cache["v"][i], step, window, wb,
            cache["k_scale"][i] if quant else None,
            cache["v_scale"][i] if quant else None)
        x = mlp_block(cfg, x, lp)
    return lm_head(cfg, params, _read_out(x, logits_at)), cache


def _verify_write_positions(t: int, start_pos: np.ndarray,
                            spec_len: np.ndarray, span: int) -> np.ndarray:
    """(B, T) cache-write positions of a speculative verify window:
    column j of slot b at start_pos[b] + j while j <= spec_len[b], and at
    the out-of-range sentinel ``span`` past its draft tail."""
    offs = np.arange(t)[None, :]
    return np.where(offs <= spec_len[:, None], start_pos[:, None] + offs,
                    span)


def verify_step(cfg, params: LlamaParams, tokens: torch.Tensor,
                cache: Cache, start_pos, spec_len, *,
                block: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """Multi-token speculative verification against the dense cache:
    ``tokens`` (B, T) is each slot's last token and up to T - 1 drafts
    (``spec_len`` real ones); logits at all T positions, writes per token
    with the junk columns dropped, ``valid_len = start_pos + spec_len +
    1``. Returns (logits (B, T, vocab), cache)."""
    b, t = tokens.shape
    start = _host_ints(start_pos, b)
    spec = _host_ints(spec_len, b)
    wpos = _verify_write_positions(t, start, spec, cache["k"].shape[2])
    return forward_with_cache(cfg, params, tokens, cache, start,
                              valid_len=start + spec + 1, write_pos=wpos,
                              block=block)


def verify_step_paged(cfg, params: LlamaParams, tokens: torch.Tensor,
                      cache: Cache, table, start_pos, spec_len, *,
                      window: int
                      ) -> Tuple[torch.Tensor, Cache]:
    """:func:`verify_step` against the paged pool: writes scatter through
    each slot's block table (junk columns to the scratch block)."""
    b, t = tokens.shape
    start = _host_ints(start_pos, b)
    spec = _host_ints(spec_len, b)
    span = np.shape(table)[1] * cache["k"].shape[2]
    wpos = _verify_write_positions(t, start, spec, span)
    return forward_with_paged_cache(
        cfg, params, tokens, cache, table, start,
        valid_len=start + spec + 1, window=window, write_pos=wpos)


def decode(cfg, params: LlamaParams, prompt: torch.Tensor, true_len,
           max_tokens: int, max_seq: int, temperature: float = 0.0,
           key: Optional[torch.Tensor] = None, *,
           cache: Optional[Cache] = None) -> torch.Tensor:
    """Prefill + cached decode: prompt (B, S_pad) -> (B, max_tokens)
    int64 tokens. ``true_len``: the un-padded prompt length, a scalar or a
    per-example (B,) (a ragged batch). temperature 0 is greedy; > 0
    samples from softmax(logits / T) with ``key`` (a ``serve.prng`` key,
    split before each token as ``jax.random.split`` splits it).
    ``cache``: an ``init_cache`` cache to fill in place (allocated on the
    prompt's device otherwise)."""
    from skypilot_tpu_torch.serve import prng
    b, s_pad = prompt.shape
    lens = _host_array(true_len)
    if lens.ndim and lens.shape != (b,):
        raise ValueError(
            f"true_len must be a scalar or a (batch,) vector of "
            f"un-padded prompt lengths; got shape {lens.shape} "
            f"for batch {b}.")
    lens = _host_ints(lens, b)
    if s_pad + max_tokens > max_seq:
        raise ValueError(
            f"prompt ({s_pad}) + max_tokens ({max_tokens}) exceeds the "
            f"cache (max_seq={max_seq}); the cache write would clamp and "
            f"corrupt the tail.")
    if temperature > 0.0 and key is None:
        raise ValueError("temperature > 0 needs a PRNG key")
    dev = prompt.device
    temp = torch.full((), temperature, dtype=torch.float32, device=dev)

    def pick(logits_row):
        nonlocal key
        if temperature <= 0.0:
            return torch.argmax(logits_row, dim=-1)
        key, sub = prng.split(key)
        return prng.categorical(sub, logits_row / temp)

    if cache is None:
        cache = init_cache(cfg, b, max_seq, dev)
    logits, cache = forward_with_cache(cfg, params, prompt, cache, 0,
                                       valid_len=lens, logits_at=lens - 1)
    tok = pick(logits[:, 0])
    toks = []
    for i in range(max_tokens):
        toks.append(tok)
        logits, cache = forward_with_cache(cfg, params, tok[:, None], cache,
                                           lens + i)
        tok = pick(logits[:, -1])
    return torch.stack(toks, dim=1)


def greedy_decode(cfg, params: LlamaParams, prompt: torch.Tensor, true_len,
                  max_tokens: int, max_seq: int) -> torch.Tensor:
    return decode(cfg, params, prompt, true_len, max_tokens, max_seq)
