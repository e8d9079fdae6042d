"""Model families of the port (llama, mixtral; gemma is not ported yet) and
the dispatch the serving path shares, as in the JAX package's
``models/__init__.py``."""
from __future__ import annotations


def family_name(cfg) -> str:
    """Config type -> family string ("llama" / "mixtral"; the port has
    no gemma config yet)."""
    name = type(cfg).__name__
    families = {"LlamaConfig": "llama", "MixtralConfig": "mixtral"}
    if name not in families:
        raise ValueError(f"unknown model config {name}")
    return families[name]


def model_api(cfg):
    """Config type -> the model module whose KV-cache functions serve it
    (``init_cache``, ``forward_with_cache``, ``forward_with_paged_cache``,
    ``verify_step``, ``decode``, ``quantize_params``). Only llama's
    serving half is ported: the other families raise a ValueError here,
    before an engine or a replica allocates anything."""
    family = family_name(cfg)
    if family != "llama":
        raise ValueError(
            f"{family} serving is not ported yet: the port's KV-cache "
            "decode path, DecodeEngine and serve_llm take llama configs")
    from skypilot_tpu_torch.models import llama
    return llama
