"""Gemma-class decoder: counterpart of ``skypilot_tpu/models/gemma.py``.

Gemma is the llama machinery driven by three knobs of its config, which
the port's llama blocks already read (``models/llama.py``):

* RMSNorm with a (1 + w) scale, weights initialised to zeros
  (``norm_offset = 1.0``);
* a GeGLU MLP, tanh-approximated gelu gate (``mlp_activation =
  "gelu_tanh"``);
* embeddings scaled by sqrt(dim) (``embed_multiplier``) and an LM head
  tied to the embedding table (``tie_embeddings``: no ``lm_head`` leaf).

Gemma-2B is multi-query (one KV head) with head_dim 256, decoupled from
dim / n_heads: its attention runs the flash kernels' width-256 resident
instances on the card (``ops/flash_attention.py``). The parameter tree is
llama's module (``llama.LlamaParams``) at this config's shapes, so
training, LoRA, int8 quantization and every KV-cache path are llama's
functions, bound here under the JAX module's names.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 256000
    dim: int = 2048
    n_layers: int = 18
    n_heads: int = 8
    n_kv_heads: int = 1          # MQA (gemma-2B); gemma-7B is MHA 16/16
    head_dim_: int = 256         # decoupled from dim // n_heads
    mlp_dim: int = 16384
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"  # auto|kernel|reference|ring
    remat: bool = True
    remat_policy: str = "full"   # one of llama.REMAT_POLICIES

    # Knobs the shared llama blocks read (module docstring).
    norm_offset: float = 1.0
    mlp_activation: str = "gelu_tanh"
    tie_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.head_dim_

    @property
    def embed_multiplier(self) -> float:
        return math.sqrt(self.dim)

    @staticmethod
    def gemma_2b() -> "GemmaConfig":
        return GemmaConfig()

    @staticmethod
    def gemma_7b() -> "GemmaConfig":
        return GemmaConfig(dim=3072, n_layers=28, n_heads=16,
                           n_kv_heads=16, mlp_dim=24576)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "GemmaConfig":
        return GemmaConfig(vocab_size=vocab_size, dim=128, n_layers=4,
                           n_heads=8, n_kv_heads=1, head_dim_=32,
                           mlp_dim=256, max_seq_len=512)

    @staticmethod
    def single_chip_bench() -> "GemmaConfig":
        """Gemma-2B's geometry with the vocabulary cut to 32768, as the
        JAX package's serving bench sizes it."""
        return GemmaConfig(vocab_size=32768, dim=2048, n_layers=18,
                           n_heads=8, n_kv_heads=1, head_dim_=256,
                           mlp_dim=16384, max_seq_len=2048)

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """fwd+bwd FLOPs per token: 6N over the parameter matmuls, plus,
        with ``seq_len``, the causal attention matmuls (n_heads x
        head_dim wide, which is not dim here)."""
        p_layer = (self.dim * (self.n_heads + 2 * self.n_kv_heads) *
                   self.head_dim +
                   self.n_heads * self.head_dim * self.dim +
                   3 * self.dim * self.mlp_dim)
        p = self.n_layers * p_layer + self.vocab_size * self.dim * (
            1 if self.tie_embeddings else 2)
        flops = 6.0 * p
        if seq_len is not None:
            flops += 6.0 * self.n_layers * seq_len * \
                self.n_heads * self.head_dim
        return flops

    def num_params(self) -> int:
        p_layer = (self.dim * (self.n_heads + 2 * self.n_kv_heads) *
                   self.head_dim +
                   self.n_heads * self.head_dim * self.dim +
                   3 * self.dim * self.mlp_dim + 2 * self.dim)
        return (self.n_layers * p_layer + self.dim +
                self.vocab_size * self.dim * (
                    1 if self.tie_embeddings else 2))


@torch.no_grad()
def init(cfg: GemmaConfig, generator: torch.Generator,
         device: DeviceLike = None) -> llama.LlamaParams:
    """Random init as the JAX package draws it: matmul weights normal *
    fan_in^-0.5, every norm weight ZERO (the (1 + w) scale starts at
    identity); the tied head has no ``lm_head`` leaf, and
    ``tie_embeddings=False`` adds one. From ``generator``; the numbers
    differ from JAX's PRNG. ``device`` defaults to the card."""
    params = llama.init(cfg, generator, resolve_device(device))
    for lp in params.layers:
        lp.attn_norm.zero_()
        lp.mlp_norm.zero_()
    params.final_norm.zero_()
    return params


# The forward and serving machinery is llama's, driven by this config's
# knobs: one implementation of attention, cache masking, remat and the
# serving loop across the dense families, as in the JAX package.
forward = llama.forward
forward_trunk = llama.forward_trunk
# llama's specs read the config's tie: no lm_head entry when tied.
param_specs = llama.param_specs
head_weights = llama.head_weights
init_cache = llama.init_cache
quantize_params = llama.quantize_params
params_quantized = llama.params_quantized
init_paged_cache = llama.init_paged_cache
cache_specs = llama.cache_specs
paged_cache_specs = llama.paged_cache_specs
forward_with_cache = llama.forward_with_cache
forward_with_paged_cache = llama.forward_with_paged_cache
verify_step = llama.verify_step
verify_step_paged = llama.verify_step_paged
decode = llama.decode
