"""The port stands alone: repro_torch imports neither jax nor any module of
the JAX package `repro`, checked at run time (a fresh interpreter imports
every module of the slice and inspects sys.modules) and in the source (an
AST scan of every file of the package)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"

SLICE_MODULES = [
    "repro_torch", "repro_torch.bridge", "repro_torch.configs",
    "repro_torch.data.tokenizer", "repro_torch.envs.base",
    "repro_torch.envs.tasks", "repro_torch.kernels",
    "repro_torch.kernels._build", "repro_torch.kernels.gqa_decode",
    "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.kernels.sgmv", "repro_torch.launch.serve",
    "repro_torch.lora.adapters", "repro_torch.lora.multilora",
    "repro_torch.models", "repro_torch.models.attention",
    "repro_torch.models.common", "repro_torch.models.mlp",
    "repro_torch.models.model", "repro_torch.rollout.engine",
    "repro_torch.rollout.prefill", "repro_torch.rollout.prng",
]


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(SRC).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def test_every_module_is_in_the_import_check():
    found = {_module_name(p) for p in PKG.rglob("*.py")}
    found -= {"repro_torch.configs.base", "repro_torch.configs.archs",
              "repro_torch.data", "repro_torch.envs", "repro_torch.lora",
              "repro_torch.rollout", "repro_torch.launch"}   # via the above
    assert found <= set(SLICE_MODULES), sorted(found - set(SLICE_MODULES))


def test_import_leaves_jax_and_repro_out():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_imports_no_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imports(tree):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
