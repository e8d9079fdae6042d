"""The port stands alone: no jax, no skypilot_tpu, no module-level
ml_dtypes in skypilot_tpu_torch/ or in its chip scripts (the machine with the
card has none of them), and its entry points refuse to run on a machine
without a card unless the caller asks for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from skypilot_tpu_torch import resolve_device
from skypilot_tpu_torch.models import llama as llama_torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "skypilot_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "torch_profile_step.py"]
BANNED = ("jax", "jaxlib", "skypilot_tpu", "flax", "optax")


def _banned(name: str) -> bool:
    return name.split(".")[0] in BANNED


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    top_level = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(map(_banned, names)), (path, node.lineno, names)
        if id(node) in top_level:
            assert "ml_dtypes" not in names, (path, node.lineno)


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "skypilot_tpu_torch").rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'skypilot_tpu', 'ml_dtypes'))\n"
            "assert not bad, bad\nprint('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_init_without_device_raises_on_cpu_only_machine(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama_torch.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        llama_torch.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    params = llama_torch.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params.embed.device.type == "cpu"
