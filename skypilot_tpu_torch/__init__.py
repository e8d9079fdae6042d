"""PyTorch/CUDA port of skypilot_tpu's compute path, for one NVIDIA H100.

The JAX package ``skypilot_tpu`` stays the reference; this package never
imports it (nor jax). It carries the training half of the JAX package on
one card: the Llama model with LoRA adapters and int8 weights in
``lora_dense`` (``models.llama``) and Mixtral's top-2 MoE
(``models.mixtral``); the trainer with adamw and adafactor
(``train.trainer``); crash-consistent checkpoints in the JAX package's
format (``train.checkpoint``); the LoRA recipe with bit-identical resume
(``recipes.llama_lora``, on ``recipes.synthetic_data``); and flash
attention as hand-written sm_90a CUDA kernels (``ops.flash_attention``,
sources under ``csrc/``). ``convert`` moves parameters and adapters
between the two packages. Across ranks (one process per card): the
process group on the env contract (``train.distributed``), the mesh,
sharding rules and placement (``parallel``), the sharded train step,
ring attention and the GPipe pipeline; Mixtral with expert parallelism
(``recipes.mixtral_ep``), and the small recipes (``recipes.mnist``,
``recipes.glue_imdb``, ``recipes.resnet_ddp`` on DDP) with the
step-callback integrations (``integrations``). The serving half: the models' KV-cache decode
(``models.llama``), the continuous-batching engine (``serve``) and its
HTTP replica (``recipes.serve_llm``), with the observability modules
they report through (``observability``).

Entry points run on the card: a caller that wants the CPU (the parity
tests) passes ``device="cpu"`` and gets the kernels' plain PyTorch
versions. Without a card and without that request they raise.
"""
from __future__ import annotations

import os
from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The process's card by default: ``cuda:<LOCAL_RANK>``, the card
    torchrun gives each process of a node (``cuda:0`` for a plain
    launch); raises when CUDA is absent. The CPU only on request
    (``device="cpu"``), never as a silent fallback. A card is returned
    with its index (``"cuda"`` -> ``cuda:<current>``), as a tensor's
    ``.device`` names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "skypilot_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain CPU path")
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:   # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(a, device: torch.device) -> torch.Tensor:
    """A copy of host array ``a`` on ``device`` that does not wait for the
    device: a CUDA copy is staged through pinned memory and queued on the
    current stream (a copy from pageable memory would synchronise the
    stream). Serving builds its per-step index tensors with it."""
    t = torch.from_numpy(np.array(a, copy=True))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
