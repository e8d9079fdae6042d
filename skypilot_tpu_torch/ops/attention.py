"""Attention dispatch: the Hopper flash kernels for CUDA tensors, the plain
reference elsewhere. Counterpart of ``skypilot_tpu/ops/attention.py``.

The public layout stays the JAX package's: q (B, S, H, D), k and v
(B, S, KVH, D) with H % KVH == 0 (GQA).
"""
from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.ops import flash_attention as flash_ops


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool,
                        scale: Optional[float]) -> torch.Tensor:
    """Plain attention in fp32: softmax over the masked scores."""
    b, sq, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    probs = torch.softmax(flash_ops.masked_scores(q, k, causal, scale),
                          dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """Multi-head / grouped-query attention.

    impl: 'auto' (the kernel for CUDA tensors, the reference for CPU
    tensors) | 'kernel' | 'reference'.

    The kernel path picks its family by shape, as the JAX dispatcher does
    (``flash_attention.family``): the resident kernels while 3 * S * D * 4
    bytes fit 6 MiB, past that the triangular kernels when ``causal`` and
    the streamed kernels when not (bidirectional attention at long
    context). Irregular shapes go to the reference
    (``flash_attention.takes_kernel_path``).
    """
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "reference"
    if impl == "kernel":
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         scale=scale)
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}; expected 'auto', "
                     "'kernel' or 'reference'")
