"""Parameters between the JAX package's trees and the port's modules:
Llama's, Gemma's and Mixtral's parameters (Llama's and Gemma's also as
``quantize_params``' int8 tree: codes plus f32 ``<name>_scale`` leaves;
Gemma's is llama's tree at its shapes, tied: no ``lm_head`` unless
``tie_embeddings=False``), the LoRA adapter tree
(``{"layers": {"wq_lora_a": (L, in, r), "wq_lora_b": (L, r, out), ...}}``)
and the serving KV caches (dense and paged, int8 pools with their
scales).

A JAX tree (``skypilot_tpu.models.llama.init``, ``mixtral.init``) is a
nested dict with the layers stacked on axis 0 and every weight stored
(in, out); the port keeps that orientation, so each layer's tensor is a
copy of one slice. Arrays arrive as numpy. A bf16 array (numpy's
``ml_dtypes`` bfloat16, ``dtype.name == "bfloat16"``) crosses as its
16-bit pattern, which needs no ``ml_dtypes`` import here. Each leaf's
shape and dtype are checked against the port module's (the config dtype;
the Mixtral router's f32).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.models import gemma, llama, mixtral


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
    """The port's parameters from a JAX llama tree of numpy arrays in the
    config's dtype, or from a ``quantize_params`` tree (int8 codes and
    f32 scales, recognised by its ``embed_scale``)."""
    device = resolve_device(device)
    params = llama.LlamaParams(cfg, "meta", cfg.dtype)
    names = list(llama.layer_shapes(cfg))
    if "embed_scale" in params_np:
        _as_quantized(params)
        names += [n + "_scale" for n in llama.QUANT_LAYER_WEIGHTS]
    _put_tree(params, params_np, names, device)
    return params


def _frozen_meta(shape, dtype) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"),
                              requires_grad=False)


def _as_quantized(params: llama.LlamaParams) -> None:
    """Re-type a meta ``LlamaParams`` as ``quantize_params``' tree: int8
    codes, and per-output-channel f32 scales beside them."""
    heads = ["embed"] + (["lm_head"] if params.lm_head is not None else [])
    for name in heads:
        w = getattr(params, name)
        out = w.shape[0] if name == "embed" else w.shape[-1]
        setattr(params, name, _frozen_meta(w.shape, torch.int8))
        setattr(params, name + "_scale", _frozen_meta((out,), torch.float32))
    for lp in params.layers:
        for name in llama.QUANT_LAYER_WEIGHTS:
            w = getattr(lp, name)
            setattr(lp, name, _frozen_meta(w.shape, torch.int8))
            setattr(lp, name + "_scale",
                    _frozen_meta((w.shape[-1],), torch.float32))


def _put(module: torch.nn.Module, name: str, arr: Any,
         device: torch.device) -> None:
    """Replace ``module.<name>`` (a meta placeholder of the expected shape
    and dtype) by a copy of ``arr``."""
    like = getattr(module, name)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected "
                         f"{tuple(like.shape)}")
    t = to_tensor(arr, device)
    if t.dtype != like.dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {like.dtype}")
    setattr(module, name, torch.nn.Parameter(
        t, requires_grad=like.requires_grad))


def _put_tree(params: torch.nn.Module, params_np: Dict[str, Any],
              layer_names, device: torch.device) -> None:
    for name in ("embed", "embed_scale", "final_norm", "lm_head",
                 "lm_head_scale"):
        if getattr(params, name, None) is not None:
            _put(params, name, params_np[name], device)
    stacked = params_np["layers"]
    for i, lp in enumerate(params.layers):
        for name in layer_names:
            _put(lp, name, stacked[name][i], device)


def llama_params_to_numpy(params: torch.nn.Module) -> Dict[str, Any]:
    """The JAX tree layout (layers stacked on axis 0) as numpy arrays; also
    Mixtral's parameters and ``quantize_params``' tree."""
    out = {}
    for name in ("embed", "embed_scale", "final_norm", "lm_head",
                 "lm_head_scale"):
        if getattr(params, name, None) is not None:
            out[name] = to_numpy(getattr(params, name))
    out.update(_stacked_layers(params.layers))
    return out


@torch.no_grad()
def gemma_params_from_jax(cfg: gemma.GemmaConfig, params_np: Dict[str, Any],
                          device: DeviceLike = None) -> llama.LlamaParams:
    """The port's Gemma parameters from a JAX gemma tree of numpy arrays
    (or its ``quantize_params`` tree): llama's module at gemma's shapes.
    The tree's head must match the config's: an ``lm_head`` leaf exactly
    when ``tie_embeddings`` is False."""
    if ("lm_head" in params_np) == cfg.tie_embeddings:
        raise ValueError(
            f"tie_embeddings={cfg.tie_embeddings} but the tree "
            f"{'has' if 'lm_head' in params_np else 'has no'} lm_head")
    return llama_params_from_jax(cfg, params_np, device)


gemma_params_to_numpy = llama_params_to_numpy


def _stacked_layers(layers) -> Dict[str, Any]:
    names = [n for n, _ in layers[0].named_parameters()]
    return {"layers": {
        name: np.stack([to_numpy(getattr(lp, name)) for lp in layers])
        for name in names}}


@torch.no_grad()
def mixtral_params_from_jax(cfg: mixtral.MixtralConfig,
                            params_np: Dict[str, Any],
                            device: DeviceLike = None
                            ) -> mixtral.MixtralParams:
    """The port's Mixtral parameters from a JAX mixtral tree of numpy
    arrays; every leaf's dtype must be the config dtype's (the router's
    f32)."""
    device = resolve_device(device)
    params = mixtral.MixtralParams(cfg, "meta", cfg.dtype)
    _put_tree(params, params_np, mixtral.layer_shapes(cfg), device)
    return params


mixtral_params_to_numpy = llama_params_to_numpy


@torch.no_grad()
def lora_from_jax(cfg, lora_np: Dict[str, Any], device: DeviceLike = None):
    """The port's adapters (``recipes.llama_lora.LoraParams``) from a JAX
    adapter tree ``{"layers": {"<name>_lora_a": (L, in, r), "<name>_lora_b":
    (L, r, out)}}``; shapes are checked against the config's projections,
    dtypes against its dtype."""
    from skypilot_tpu_torch.recipes import llama_lora
    device = resolve_device(device)
    layers_np = dict(lora_np["layers"])
    lora = llama_lora.LoraParams(cfg.n_layers)
    for name, (fan_in, fan_out) in llama_lora.lora_shapes(cfg).items():
        if name + "_lora_a" not in layers_np:
            continue
        a = layers_np.pop(name + "_lora_a")
        b = layers_np.pop(name + "_lora_b")
        rank = a.shape[-1]
        for key, arr, shape in ((name + "_lora_a", a, (fan_in, rank)),
                                (name + "_lora_b", b, (rank, fan_out))):
            for lp in lora.layers:
                setattr(lp, key, torch.nn.Parameter(torch.empty(
                    shape, dtype=cfg.dtype, device="meta")))
            if len(arr) != cfg.n_layers:
                raise ValueError(f"{key}: {len(arr)} layers, expected "
                                 f"{cfg.n_layers}")
            for lp, arr_l in zip(lora.layers, arr):
                _put(lp, key, arr_l, device)
    if layers_np:
        raise ValueError(f"not adapters of {llama_lora.LORA_TARGETS}: "
                         f"{sorted(layers_np)}")
    return lora


def lora_to_numpy(lora) -> Dict[str, Any]:
    """The JAX adapter tree (layers stacked on axis 0) as numpy arrays."""
    return _stacked_layers(lora.layers)


def cache_from_jax(cache_np: Dict[str, Any],
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A serving cache (``init_cache``'s dense rows or
    ``init_paged_cache``'s pool, with ``k_scale``/``v_scale`` when int8)
    from the JAX package's dict of numpy arrays; the layouts are equal."""
    device = resolve_device(device)
    return {k: to_tensor(v, device) for k, v in cache_np.items()}


def cache_to_numpy(cache: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A serving cache as the JAX package's dict of numpy arrays."""
    return {k: to_numpy(v) for k, v in cache.items()}
