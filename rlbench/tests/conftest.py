"""Puts the repository root and ``src`` on the path for the benchmark's
tests, and gives them the tiny configuration and traffic of ``tiny.json``
(a cell at a size a CPU test run holds)."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(scope="session")
def root():
    return ROOT


@pytest.fixture(scope="session")
def bench(root):
    return json.loads((root / "BENCHMARK.json").read_text())


@pytest.fixture()
def tiny_cell(bench):
    from rlbench.harness.cell import Cell
    tiny = json.loads((Path(__file__).parent / "tiny.json").read_text())
    limits = {k: {"limit": 1e-3} for k in
              ("greedy_gap", "logprob_gap", "loss_gap", "grad_gap", "update_gap")}
    return Cell("tiny.shared-prompt", tiny["config"], tiny["traffic"], limits,
                1, bench["end_to_end"], bench["per_layer"])
