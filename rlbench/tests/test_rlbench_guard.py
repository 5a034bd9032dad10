"""No module of the benchmark imports JAX or the JAX package (``repro``),
top-level names compared whole, and the reference imports nothing of the
program."""
import ast
import sys
from pathlib import Path

from rlbench import run as R

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_mod", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "repro" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    monkeypatch.setitem(sys.modules, "flax", object())
    assert {"repro", "flax"} <= set(R.forbidden_modules())


def test_no_module_of_the_benchmark_imports_jax_or_repro():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not _imports(p) & {"jax", "jaxlib", "flax", "repro"}, p


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        names = _imports(p)
        assert names <= {"__future__", "math", "typing", "dataclasses",
                         "torch", "rlbench"}, (p, names)
        text = p.read_text()
        assert "repro_torch" not in text.replace("``repro_torch``", "")
