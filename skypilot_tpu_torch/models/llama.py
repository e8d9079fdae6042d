"""Llama-3-class decoder, training half: counterpart of
``skypilot_tpu/models/llama.py`` (config, init, forward and its blocks).

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

Not in this slice: ``quantize_params`` (the int8 serving tree) and the
KV-cache decode paths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch import DeviceLike, resolve_device
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
    """(B, S, D) hidden -> fp32 logits, inputs in the working dtype."""
    return matmul_f32(x, head_weights(params))


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
