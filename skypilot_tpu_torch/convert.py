"""Parameters between the JAX package's trees and the port's modules:
Llama's, Gemma's and Mixtral's parameters (each also as
``quantize_params``' int8 tree: codes plus f32 ``<name>_scale`` leaves,
Mixtral's expert scales (E, out) and its router left f32;
Gemma's is llama's tree at its shapes, tied: no ``lm_head`` unless
``tie_embeddings=False``), the LoRA adapter tree
(``{"layers": {"wq_lora_a": (L, in, r), "wq_lora_b": (L, r, out), ...}}``)
and the serving KV caches (dense and paged, int8 pools with their
scales), and the small recipes' flax modules (``cnn_from_flax``,
``text_classifier_from_flax``, ``resnet_from_flax``: a flax ``Dense``
kernel (in, out) is torch's weight transposed, a ``Conv`` kernel HWIO is
torch's OIHW).

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
    _put_tree(params, params_np, _layer_names(params, params_np,
                                              llama.layer_shapes(cfg)),
              device)
    return params


def _layer_names(params: torch.nn.Module, params_np: Dict[str, Any],
                 shapes: dict) -> list:
    """The layer leaves to copy: the module's weights, and, for a
    ``quantize_params`` tree (recognised by its ``embed_scale``), their
    scales, after re-typing the meta module as that tree."""
    names = list(shapes)
    if "embed_scale" in params_np:
        _as_quantized(params)
        names += [n + "_scale" for n in llama.QUANT_LAYER_WEIGHTS]
    return names


def _frozen_meta(shape, dtype) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"),
                              requires_grad=False)


def _as_quantized(params: llama.LlamaParams) -> None:
    """Re-type a meta ``LlamaParams`` or ``MixtralParams`` as
    ``quantize_params``' tree: int8 codes, and per-output-channel f32
    scales beside them (a weight's shape without its in-features axis
    -2, so an expert tensor's scale keeps its expert axis)."""
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
                    _frozen_meta(w.shape[:-2] + w.shape[-1:],
                                 torch.float32))


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
    arrays, or from its ``quantize_params`` tree (int8 codes, f32 scales);
    every leaf's dtype must be the module's (the config dtype, int8
    codes, f32 scales, the router's f32)."""
    device = resolve_device(device)
    params = mixtral.MixtralParams(cfg, "meta", cfg.dtype)
    _put_tree(params, params_np, _layer_names(params, params_np,
                                              mixtral.layer_shapes(cfg)),
              device)
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


# ------------------------------------------- the small recipes' flax trees

def _leaf(param: torch.nn.Parameter, arr: Any) -> None:
    """Copy ``arr`` into ``param`` (same shape and dtype, checked)."""
    t = to_tensor(arr, param.device)
    if t.shape != param.shape or t.dtype != param.dtype:
        raise ValueError(f"flax leaf {tuple(t.shape)} {t.dtype} does not "
                         f"fit {tuple(param.shape)} {param.dtype}")
    param.copy_(t)


def _dense_from_flax(lin: torch.nn.Linear, tree: Dict[str, Any]) -> None:
    """A flax ``Dense``: kernel (in, out) is ``nn.Linear``'s weight^T."""
    _leaf(lin.weight, np.asarray(tree["kernel"]).T)
    _leaf(lin.bias, tree["bias"])


def _conv_from_flax(conv: torch.nn.Conv2d, tree: Dict[str, Any]) -> None:
    """A flax ``Conv``: kernel HWIO is ``nn.Conv2d``'s OIHW weight."""
    _leaf(conv.weight, np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
    if conv.bias is not None:
        _leaf(conv.bias, tree["bias"])


def _norm_from_flax(norm: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """A flax ``LayerNorm`` or ``GroupNorm``: scale and bias."""
    _leaf(norm.weight, tree["scale"])
    _leaf(norm.bias, tree["bias"])


def _flax_params(variables: Dict[str, Any]) -> Dict[str, Any]:
    """The ``params`` collection of flax variables (or the collection)."""
    return variables.get("params", variables)


@torch.no_grad()
def cnn_from_flax(model, variables: Dict[str, Any]):
    """``recipes/mnist.py``'s CNN loaded with the JAX recipe's flax CNN
    variables (numpy leaves); returns ``model``."""
    p = _flax_params(variables)
    _conv_from_flax(model.conv0, p["Conv_0"])
    _conv_from_flax(model.conv1, p["Conv_1"])
    _dense_from_flax(model.dense0, p["Dense_0"])
    _dense_from_flax(model.dense1, p["Dense_1"])
    return model


@torch.no_grad()
def text_classifier_from_flax(model, variables: Dict[str, Any]):
    """``recipes/glue_imdb.py``'s ``TextClassifier`` loaded with the flax
    one's variables: the MHA kernels keep flax's (dim, heads, head_dim)
    and (heads, head_dim, dim) layouts; returns ``model``."""
    p = _flax_params(variables)
    _leaf(model.embed.weight, p["Embed_0"]["embedding"])
    _leaf(model.pos, p["pos"])
    for i, block in enumerate(model.blocks):
        b = p[f"EncoderBlock_{i}"]
        _norm_from_flax(block.norm0, b["LayerNorm_0"])
        _norm_from_flax(block.norm1, b["LayerNorm_1"])
        mha = b["MultiHeadDotProductAttention_0"]
        for name in ("query", "key", "value", "out"):
            _leaf(getattr(block.attn, name + "_kernel"), mha[name]["kernel"])
            _leaf(getattr(block.attn, name + "_bias"), mha[name]["bias"])
        _dense_from_flax(block.dense0, b["Dense_0"])
        _dense_from_flax(block.dense1, b["Dense_1"])
    _norm_from_flax(model.norm, p["LayerNorm_0"])
    _dense_from_flax(model.head, p["Dense_0"])
    return model


@torch.no_grad()
def resnet_from_flax(model, variables: Dict[str, Any]):
    """``recipes/resnet_ddp.py``'s ``ResNet`` loaded with the flax one's
    variables (blocks numbered across stages, a block's residual
    projection its ``Conv_2``); returns ``model``."""
    p = _flax_params(variables)
    _conv_from_flax(model.stem, p["Conv_0"])
    _norm_from_flax(model.stem_norm, p["GroupNorm_0"])
    for i, block in enumerate(model.blocks):
        b = p[f"ResNetBlock_{i}"]
        _conv_from_flax(block.conv0, b["Conv_0"])
        _norm_from_flax(block.norm0, b["GroupNorm_0"])
        _conv_from_flax(block.conv1, b["Conv_1"])
        _norm_from_flax(block.norm1, b["GroupNorm_1"])
        if (block.proj is None) != ("Conv_2" not in b):
            raise ValueError(f"ResNetBlock_{i}: residual projection "
                             "differs from the flax block's")
        if block.proj is not None:
            _conv_from_flax(block.proj, b["Conv_2"])
    _dense_from_flax(model.head, p["Dense_0"])
    return model


def shard_params(module: torch.nn.Module, mesh, rules, specs) -> torch.nn.Module:
    """Place a port tree (``llama_params_from_jax``,
    ``gemma_params_from_jax``; every process builds the same one) onto
    ``mesh`` by ``rules`` and the model's ``param_specs``: its parameters
    become DTensors, each process keeping its shard, in place
    (``parallel/placement.py``)."""
    from skypilot_tpu_torch.parallel import placement
    return placement.place_module(
        module, placement.param_shardings(module, mesh, rules, specs), mesh)


def gather_params(module: torch.nn.Module, mesh=None) -> Dict[str, Any]:
    """The inverse of ``shard_params``: every parameter whole (a stage's
    layers broadcast from that stage), as numpy in the JAX tree's layout
    (``llama_params_to_numpy``'s), on every process; every process calls
    it."""
    from skypilot_tpu_torch.parallel import placement

    def whole(p):
        return to_numpy(placement.gather_tensor(p, mesh))
    out = {}
    for name in ("embed", "embed_scale", "final_norm", "lm_head",
                 "lm_head_scale"):
        if getattr(module, name, None) is not None:
            out[name] = whole(getattr(module, name))
    names = [n for n, _ in module.layers[0].named_parameters()]
    out["layers"] = {n: np.stack([whole(getattr(lp, n))
                                  for lp in module.layers]) for n in names}
    return out
