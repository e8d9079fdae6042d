"""Model families of the port (llama, gemma, mixtral) and the dispatch the
serving path shares, as in the JAX package's ``models/__init__.py``."""
from __future__ import annotations


def family_name(cfg) -> str:
    """Config type -> family string ("llama" / "gemma" / "mixtral")."""
    name = type(cfg).__name__
    families = {"LlamaConfig": "llama", "GemmaConfig": "gemma",
                "MixtralConfig": "mixtral"}
    if name not in families:
        raise ValueError(f"unknown model config {name}")
    return families[name]


def model_api(cfg):
    """Config type -> the model module whose KV-cache functions serve it
    (``init``, ``init_cache``, ``forward_with_cache``,
    ``forward_with_paged_cache``, ``verify_step``, ``decode``,
    ``quantize_params``): llama's, or gemma's (llama's functions under
    gemma's names). Mixtral's serving half is not ported: it raises a
    ValueError here, before an engine or a replica allocates anything."""
    family = family_name(cfg)
    if family == "mixtral":
        raise ValueError(
            "mixtral serving is not ported yet: the port's KV-cache decode "
            "path, DecodeEngine and serve_llm take llama and gemma configs")
    if family == "gemma":
        from skypilot_tpu_torch.models import gemma
        return gemma
    from skypilot_tpu_torch.models import llama
    return llama
