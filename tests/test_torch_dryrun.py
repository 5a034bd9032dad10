"""The port's dry run (``launch.dryrun``) on reduced fp32 configs of every
family (dense, vlm, moe, ssm, hybrid, encdec), for a train, a prefill and a
decode cell, on a fake 4×4 mesh and a fake 2×2×2 multi-pod mesh:

- every cell is ``ok`` and its record holds the reference's fields;
- ``argument_size_in_bytes`` equals the bytes of one rank's shards of the
  step's arguments, computed here from the JAX package's specs
  (``repro.launch.shardings`` on ``make_abstract_mesh``) and shape trees;
- a cell run twice gives the same record but for its timings;
- the JSONL's finished cells are the ``ok`` ones (the sweep resumes)."""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import tiny
from repro.configs import ShapeConfig as JShape
from repro.launch import shardings as j_sh, specs as j_specs
from repro.launch.mesh import make_abstract_mesh
from repro_torch.configs import REGISTRY, ShapeConfig, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh

FAMILIES = {"dense": "granite-3-2b", "vlm": "chameleon-34b",
            "moe": "deepseek-moe-16b", "ssm": "mamba2-780m",
            "hybrid": "zamba2-1.2b", "encdec": "seamless-m4t-large-v2"}
SHAPES = {"train": (64, 16), "prefill": (64, 8), "decode": (64, 8)}
MESHES = {"4x4": ((4, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
FIELDS = ("chips", "argument_size_in_bytes", "temp_size_in_bytes",
          "bytes_per_device", "collectives", "collective_bytes_per_chip",
          "compute_s", "memory_s", "collective_s", "dominant", "model_flops",
          "useful_ratio", "roofline_frac", "trace_s", "reshards", "card")


def _port_config(name):
    cfg = reduced(REGISTRY[name], dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def _cell(name, kind, mesh_name):
    cfg = _port_config(name)
    shape = ShapeConfig(kind, *SHAPES[kind], kind)
    mshape, axes = MESHES[mesh_name]
    with fake_world(math.prod(mshape)):
        mesh = make_mesh(mshape, axes, "cpu")
        return dryrun.cell_record(cfg, shape, mesh)


def _local_bytes(shapes, spec_tree, sizes):
    n = 0
    specs = j_sh._flatten_with_paths(spec_tree)
    for path, sds in j_sh._flatten_with_paths(shapes).items():
        dims = list(sds.shape)
        for i, entry in enumerate(specs[path]):
            if entry is not None:
                axes = (entry,) if isinstance(entry, str) else entry
                dims[i] //= math.prod(sizes[a] for a in axes)
        n += math.prod(dims) * np.dtype(sds.dtype).itemsize
    return n


def _reference_arg_bytes(name, kind, mesh_name):
    """One rank's argument bytes from the JAX package's specs and shapes."""
    cfg = tiny(name)
    shape = JShape(kind, *SHAPES[kind], kind)
    mshape, axes = MESHES[mesh_name]
    mesh = make_abstract_mesh(mshape, axes)
    sizes = dict(zip(axes, mshape))
    shapes = j_specs.eval_shapes(cfg)
    pspec = j_sh.param_specs(cfg, shapes["params"], mesh)
    n = _local_bytes(shapes["params"], pspec, sizes)
    if kind == "train":
        lspec = j_sh.lora_specs(cfg, shapes["lora"], mesh)
        batch = j_specs.train_batch_specs(cfg, shape)
        bspec = j_sh.batch_specs(batch, mesh, shape.global_batch,
                                 wide=cfg.family in ("ssm", "hybrid"))
        return (n + _local_bytes(shapes["lora"], lspec, sizes)
                + _local_bytes(shapes["opt"], j_sh.opt_specs(lspec), sizes)
                + _local_bytes(batch, bspec, sizes))
    lsspec = j_sh.lora_specs(cfg, shapes["lora_stacked"], mesh, batched=True)
    serve = j_specs.serve_specs(cfg, shape)
    cspec = j_sh.cache_specs(cfg, serve["cache"], mesh, shape.global_batch)
    rest = {k: v for k, v in serve.items() if k != "cache"}
    return (n + _local_bytes(shapes["lora_stacked"], lsspec, sizes)
            + _local_bytes(serve["cache"], cspec, sizes)
            + _local_bytes(rest, j_sh.batch_specs(rest, mesh, shape.global_batch),
                           sizes))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_cell_runs_and_counts_the_reference_arguments(family, kind, mesh_name):
    name = FAMILIES[family]
    rec = _cell(name, kind, mesh_name)
    assert rec["ok"], rec
    for k in FIELDS:
        assert k in rec, k
    mshape = MESHES[mesh_name][0]
    assert rec["chips"] == math.prod(mshape)
    assert rec["mesh"] == ("multipod" if len(mshape) == 3 else "single")
    assert rec["argument_size_in_bytes"] == _reference_arg_bytes(name, kind,
                                                                 mesh_name)
    assert rec["bytes_per_device"] == (rec["argument_size_in_bytes"]
                                       + rec["temp_size_in_bytes"])
    assert rec["temp_size_in_bytes"] > 0
    assert rec["collectives"], "a sharded step issues collectives"
    assert all(c > 0 and b > 0 for c, b in rec["collectives"].values())
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["model_flops"] > 0 and 0 < rec["roofline_frac"] <= 1


def test_a_cell_twice_gives_the_same_record():
    a, b = (_cell("granite-3-2b", "train", "4x4") for _ in range(2))
    for k in dryrun.TIMING_FIELDS:
        a.pop(k), b.pop(k)
    assert a == b


def test_finished_cells_are_the_ok_ones(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    rows = [{"arch": "a", "shape": "s", "mesh": "single", "tag": "base", "ok": True},
            {"arch": "b", "shape": "s", "mesh": "single", "tag": "base", "ok": False}]
    out.write_text("".join(json.dumps(r) + "\n" for r in rows) + "{torn\n")
    assert dryrun._done_cells(str(out)) == {("a", "s", "single", "base")}
    assert dryrun._done_cells(str(tmp_path / "none.jsonl")) == set()
