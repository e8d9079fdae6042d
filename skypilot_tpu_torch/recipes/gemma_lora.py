"""Gemma LoRA finetune: the port of the JAX package's
``recipes/gemma_lora.py``, the LoRA loop of ``recipes.llama_lora`` on the
gemma family.

Adapters ride the same ``lora_dense`` seam in llama's blocks, checkpoints
keep the JAX package's format, and a preempted run resumes bit-identically
exactly as the llama recipe does (examples/gemma_lora.yaml: ``--model 2b
--batch-size 8 --seq-len 2048``, where every attention call takes the
width-256 resident flash kernels; a ``--seq-len`` past 2048, up to Gemma's
8192, takes the width-256 triangular kernels).

    python -m skypilot_tpu_torch.recipes.gemma_lora --device cpu \\
        --model tiny --steps 6 --checkpoint-dir /tmp/run1

Without ``--device`` it runs on the card, and raises when there is none.
"""
from __future__ import annotations

from skypilot_tpu_torch.models import gemma
from skypilot_tpu_torch.recipes import llama_lora

MODELS = {"tiny": gemma.GemmaConfig.tiny, "2b": gemma.GemmaConfig.gemma_2b,
          "7b": gemma.GemmaConfig.gemma_7b}


def main(argv=None) -> dict:
    args = llama_lora.build_arg_parser(list(MODELS), "tiny").parse_args(argv)
    return llama_lora.run_lora(gemma, MODELS[args.model](), args,
                               recipe_name="gemma_lora")


if __name__ == "__main__":
    main()
