"""Parameters between the JAX package's tree and the port's modules.

The JAX tree (``skypilot_tpu.models.llama.init``) is a nested dict with
the layers stacked on axis 0 and every weight stored (in, out); the port
keeps that orientation, so each layer's tensor is a copy of one slice.
Arrays arrive as numpy. A bf16 array (numpy's ``ml_dtypes`` bfloat16,
``dtype.name == "bfloat16"``) crosses as its 16-bit pattern, which needs
no ``ml_dtypes`` import here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.models import llama


def to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    # Always a copy: the port updates its parameters in place, and a numpy
    # view of a JAX array must not change under JAX.
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 becomes ``ml_dtypes.bfloat16`` (imported
    only here, by the callers that hand arrays back to JAX)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@torch.no_grad()
def llama_params_from_jax(cfg: llama.LlamaConfig,
                          params_np: Dict[str, Any],
                          device: DeviceLike = None) -> llama.LlamaParams:
    """The port's parameters from a JAX llama tree of numpy arrays; each
    tensor keeps the array's dtype."""
    device = resolve_device(device)
    params = llama.LlamaParams(cfg, "meta", cfg.dtype)

    def put(module, name, arr):
        expected = tuple(getattr(module, name).shape)
        if tuple(arr.shape) != expected:
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected "
                             f"{expected}")
        setattr(module, name, torch.nn.Parameter(to_tensor(arr, device)))

    put(params, "embed", params_np["embed"])
    put(params, "final_norm", params_np["final_norm"])
    if params.lm_head is not None:
        put(params, "lm_head", params_np["lm_head"])
    stacked = params_np["layers"]
    for i, lp in enumerate(params.layers):
        for name in llama.layer_shapes(cfg):
            put(lp, name, stacked[name][i])
    return params


def llama_params_to_numpy(params: llama.LlamaParams) -> Dict[str, Any]:
    """The JAX tree layout (layers stacked on axis 0) as numpy arrays."""
    out = {"embed": to_numpy(params.embed),
           "final_norm": to_numpy(params.final_norm)}
    if params.lm_head is not None:
        out["lm_head"] = to_numpy(params.lm_head)
    names = params.layers[0].state_dict().keys()
    out["layers"] = {
        name: np.stack([to_numpy(getattr(lp, name)) for lp in params.layers])
        for name in names}
    return out
