"""Matrix product with inputs in the working dtype and fp32 output.

The counterpart of ``jax.lax.dot_general(..., preferred_element_type=
jnp.float32)`` that the JAX package uses for the vocab projection and the
chunked loss. A plain bf16 ``torch.matmul`` rounds its output to bf16, and
upcasting the operands on the card runs the product outside the tensor
cores (fp32 is ~67 TFLOP/s on an H100 against 989 for bf16). So on CUDA
the forward is ``torch.mm(..., out_dtype=torch.float32)`` (bf16 inputs,
fp32 accumulation and output); that overload has no autograd formula,
hence this Function. On the CPU the operands are upcast.
"""
from __future__ import annotations

import torch


class _MatmulF32(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        if x.is_cuda and x.dtype != torch.float32:
            return torch.mm(x, w, out_dtype=torch.float32)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        # The cotangent goes back into the working dtype so both backward
        # products run on the tensor cores; f32 runs are exact.
        g = g.to(x.dtype)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = x.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., D) @ (D, N) -> (..., N) fp32; ``w`` is cast to x's dtype."""
    lead = x.shape[:-1]
    out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    return out.reshape(*lead, w.shape[-1])
