"""The port's sharding layer against the JAX package's: ``train.sharding``
(rules, ``resolve``, ``constrain``), ``launch.shardings`` (specs leaf by
leaf, local shapes) and ``launch.roofline``'s collective counter.

- Specs: for every arch in ``REGISTRY`` on the 16×16 train mesh, the
  2×16×16 multi-pod mesh and the 32×8 serve mesh, the port's specs on a
  mesh over torch's fake process group of that size against
  ``repro.launch.shardings`` on ``make_abstract_mesh``: params, LoRA
  (batched and not), optimizer state, the train batch (wide and not), and
  the cache and request arrays of each serving shape at batch 128 and 1.
  The same paths, and the same entries (JAX's PartitionSpec form), and
  every local shape the even division of the global one.
- ``resolve`` under both rule sets; ``constrain`` the identity with no mesh
  and on plain tensors; ``placements`` of a spec whose dim splits over two
  axes.
- The counter: an all-gather, a reduce-scatter, an all-reduce and an
  all-to-all on DTensors over a fake 256-rank mesh against
  ``parse_collectives`` of the HLO lines for the same ops; the all-to-all
  counted alike on a "cpu" mesh (which runs it as an all-gather and a
  chunk) and a "cuda" one."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import REGISTRY as J_REGISTRY, shapes_for as j_shapes_for
from repro.launch import shardings as j_sh, specs as j_specs
from repro.launch.mesh import make_abstract_mesh
from repro.launch.roofline import parse_collectives
from repro.train import sharding as j_sharding
from repro_torch.configs import REGISTRY, shapes_for
from repro_torch.launch import shardings as sh, specs
from repro_torch.launch.mesh import fake_world, make_mesh, production_shape
from repro_torch.launch.roofline import collective_counter
from repro_torch.train import sharding

MESHES = {"train": dict(multi_pod=False, kind="train"),
          "multipod": dict(multi_pod=True, kind="train"),
          "serve": dict(multi_pod=False, kind="serve")}


def _same_specs(port_tree, jax_tree, shapes, mesh, what):
    """Leaf by leaf: the same paths and entries; each local shape divides
    the global one evenly by the mesh's axis sizes."""
    got = sh._flatten_with_paths(port_tree)
    want = j_sh._flatten_with_paths(jax_tree)
    assert set(got) == set(want), what
    flat_shapes = sh._flatten_with_paths(shapes)
    sizes = sharding.axis_sizes(mesh)
    for path, spec in want.items():
        assert tuple(got[path]) == tuple(spec), (what, path, got[path], spec)
        shape = tuple(flat_shapes[path].shape)
        local = sh.local_shape(shape, got[path], mesh)
        for i, entry in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            assert local[i] * math.prod(sizes[a] for a in axes) == shape[i], \
                (what, path, shape, spec)


@pytest.mark.parametrize("name", list(REGISTRY))
def test_specs_equal_the_references(name):
    cfg, jcfg = REGISTRY[name], J_REGISTRY[name]
    shapes, jshapes = specs.eval_shapes(cfg), j_specs.eval_shapes(jcfg)
    train = [s for s in shapes_for(cfg) if s.kind == "train"][0]
    serve = [s for s in shapes_for(cfg) if s.kind != "train"]
    jtrain = [s for s in j_shapes_for(jcfg) if s.kind == "train"][0]
    jserve = [s for s in j_shapes_for(jcfg) if s.kind != "train"]
    for mesh_name, kw in MESHES.items():
        shape, axes = production_shape(**kw)
        amesh = make_abstract_mesh(shape, axes)
        with fake_world(math.prod(shape)):
            mesh = make_mesh(shape, axes, "cpu")
            pspec = sh.param_specs(cfg, shapes["params"], mesh)
            _same_specs(pspec, j_sh.param_specs(jcfg, jshapes["params"], amesh),
                        shapes["params"], mesh, (mesh_name, "params"))
            for key, batched in (("lora", False), ("lora_stacked", True)):
                lspec = sh.lora_specs(cfg, shapes[key], mesh, batched=batched)
                jl = j_sh.lora_specs(jcfg, jshapes[key], amesh, batched=batched)
                _same_specs(lspec, jl, shapes[key], mesh, (mesh_name, key))
            lspec = sh.lora_specs(cfg, shapes["lora"], mesh)
            jl = j_sh.lora_specs(jcfg, jshapes["lora"], amesh)
            _same_specs(sh.opt_specs(lspec), j_sh.opt_specs(jl), shapes["opt"],
                        mesh, (mesh_name, "opt"))
            batch = specs.train_batch_specs(cfg, train)
            jbatch = j_specs.train_batch_specs(jcfg, jtrain)
            for wide in (False, True):
                _same_specs(sh.batch_specs(batch, mesh, train.global_batch, wide=wide),
                            j_sh.batch_specs(jbatch, amesh, jtrain.global_batch,
                                             wide=wide),
                            batch, mesh, (mesh_name, "train batch", wide))
            for s, js in zip(serve, jserve):
                for b in (128, 1):
                    s_b = dataclasses.replace(s, global_batch=b)
                    js_b = dataclasses.replace(js, global_batch=b)
                    srv, jsrv = specs.serve_specs(cfg, s_b), j_specs.serve_specs(jcfg, js_b)
                    _same_specs(sh.cache_specs(cfg, srv["cache"], mesh, b),
                                j_sh.cache_specs(jcfg, jsrv["cache"], amesh, b),
                                srv["cache"], mesh, (mesh_name, s.name, b, "cache"))
                    rest = {k: v for k, v in srv.items() if k != "cache"}
                    jrest = {k: v for k, v in jsrv.items() if k != "cache"}
                    for wide in (False, True):
                        _same_specs(sh.batch_specs(rest, mesh, b, wide=wide),
                                    j_sh.batch_specs(jrest, amesh, b, wide=wide),
                                    rest, mesh, (mesh_name, s.name, b, wide))


LOGICAL = [("dp", "tp"), ("dp",), (None, "tp"), ("tp", None, None),
           ("sp", None), (("dp", "tp"),), (("dp", "sp"), "tp"), ("nope",),
           ((),), (None,), ()]


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "MULTIPOD_RULES"])
def test_resolve_equals_the_reference(rules):
    assert getattr(sharding, rules) == getattr(j_sharding, rules)
    with sharding.mesh_context(None, rules=getattr(sharding, rules)), \
            j_sharding.mesh_context(None, rules=getattr(j_sharding, rules)):
        for logical in LOGICAL:
            got, want = sharding.resolve(*logical), j_sharding.resolve(*logical)
            assert tuple(got) == tuple(want), (logical, got, want)
    assert sharding.current_mesh() is None


def test_constrain_is_the_identity_without_a_mesh_or_a_dtensor():
    x = torch.ones(4, 4)
    assert sharding.constrain(x, "dp", "tp") is x
    assert sharding.named_sharding("dp") is None
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        with sharding.mesh_context(mesh):
            assert sharding.constrain(x, "dp", "tp") is x
            from torch.distributed.tensor import DTensor, Replicate, Shard
            d = DTensor.from_local(torch.empty((2, 4), device="meta"), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            c = sharding.constrain(d, None, "tp", note="test")
            assert tuple(c.placements) == (Replicate(), Shard(1))
            assert sharding.reshard_log() == {"test": 1}
            assert sharding.named_sharding("dp", "tp") == (
                mesh, (Shard(0), Shard(1)))
        assert sharding.reshard_log() == {}


def test_placements_split_a_dim_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard
    with fake_world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        assert sharding.placements(sharding.P(("pod", "data"), "model"), mesh) \
            == (Shard(0), Shard(0), Shard(1))
        assert sharding.placements(sharding.P(None, None), mesh) \
            == (Replicate(),) * 3
        with pytest.raises(ValueError):
            sharding.placements(sharding.P(("data", "pod")), mesh)
        with pytest.raises(ValueError):
            sharding.placements(sharding.P("data", "data"), mesh)
        with pytest.raises(ValueError):
            sh.local_shape((6, 4), sharding.P(("pod", "data")), mesh)
        assert sh.local_shape((8, 4, 3), sharding.P(("pod", "data"), "model"),
                              mesh) == (2, 2, 3)
        # the spec type's normal form is JAX's
        assert tuple(sharding.P(("data",), (), ["pod", "data"])) \
            == ("data", None, ("pod", "data"))


def _hlo_stats(lines):
    return parse_collectives("\n".join(lines), default_group=256)


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_collective_counter_equals_the_hlo_parser(device_type):
    """Each op over the 16-rank "model" groups of a 16×16 fake mesh; the
    HLO lines as tests/test_sharding.py writes them (replica groups of 16)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    groups = "replica_groups=[16,16]<=[256]"
    with fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), device_type)

        def dt(shape, plc, dtype=torch.bfloat16):
            return DTensor.from_local(torch.empty(shape, dtype=dtype, device="meta"),
                                      mesh, plc, run_check=False)
        with collective_counter() as c:
            dt((1, 512), [Replicate(), Shard(0)]).full_tensor()          # all-gather
            dt((128,), [Replicate(), Partial()], torch.float32).redistribute(
                mesh, [Replicate(), Shard(0)])                             # reduce-scatter
            dt((128,), [Replicate(), Partial()], torch.float32).redistribute(
                mesh, [Replicate(), Replicate()])                          # all-reduce
            dt((1, 256), [Replicate(), Shard(0)]).redistribute(
                mesh, [Replicate(), Shard(1)])                             # all-to-all
    want = _hlo_stats([
        f"%ag = bf16[16,512]{{1,0}} all-gather(%x), {groups}, dimensions={{0}}",
        f"%rs = f32[8]{{0}} reduce-scatter(%y), {groups}, dimensions={{0}}, "
        f"to_apply=%sum",
        f"%ar = f32[128]{{0}} all-reduce(%z), {groups}, to_apply=%sum",
        f"%a2a = bf16[1,256]{{1,0}} all-to-all(%w), {groups}, dimensions={{1}}"])
    assert c.stats.count == want.count
    assert c.stats.per_op == pytest.approx(want.per_op, rel=1e-12)
    assert c.stats.total_per_chip == pytest.approx(want.total_per_chip, rel=1e-12)
    assert [r[0] for r in c.records] == ["all-gather", "reduce-scatter",
                                         "all-reduce", "all-to-all"]
