"""Cells by name: ``BENCHMARK.json``'s workloads, each a configuration file
(``configs/<config>.json``) under a traffic file (``traffic/<mix>.json``),
with the limits its correctness check holds (``limits/<cell>.json``). A
configuration file names its family's builder (``builder``: the widths,
the weights from the seed, the program's view of them) and its plain
reference (``reference``: a module with ``RefModel``), each a path under
the benchmark's folder. Nothing here lists a cell, a configuration, a
family or a mix: a later change adds them as files and entries."""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path, PurePosixPath
from typing import Any, Dict, List

from .yardstick import Shape

BENCH_DIR = Path(__file__).resolve().parent.parent      # rlbench/


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    mix: str = ""                 # the traffic file's name

    @property
    def builder(self):
        return load_module(self.config["builder"])

    @property
    def reference(self):
        return load_module(self.config["reference"])

    @property
    def shape(self) -> Shape:
        return self.builder.shape(self.config)


def load_module(path: str):
    """The module at `path` (``rlbench/.../<name>.py``, relative to the
    checkout), imported under its dotted name."""
    p = PurePosixPath(path)
    if (p.is_absolute() or ".." in p.parts or p.suffix != ".py"
            or p.parts[0] != BENCH_DIR.name):
        raise ValueError(f"{path!r} is not a module under {BENCH_DIR.name}/")
    return importlib.import_module(".".join(p.with_suffix("").parts))


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def find_benchmark(root: Path) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json in {root}")
    return load_json(path)


def metrics_for(bench: Dict[str, Any], cell: str, kind: str):
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports: those
    without a ``workloads`` key, and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(root: Path, name: str) -> Cell:
    bench = find_benchmark(root)
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{[w['name'] for w in bench['workloads']]})")
    w = wl[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = load_json(root / conf["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
    return Cell(name=name, config=config, traffic=traffic, limits=limits,
                chips=int(w["chips"]),
                end_to_end=metrics_for(bench, name, "end_to_end"),
                per_layer=metrics_for(bench, name, "per_layer"),
                mix=w["traffic"])
