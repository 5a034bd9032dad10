"""Multi-pod dry run (port of ``repro.launch.dryrun``): run every
(architecture × input-shape × mesh) cell's step once on the production mesh,
prove the sharding config is coherent, and record its bytes per device, its
collectives and its roofline terms.

Where the JAX package lowers and compiles the step for 512 fake XLA host
devices, the port brings up torch's fake process group of the mesh's size
(``launch.mesh.fake_world``; this process is rank 0), places params, LoRA,
optimizer state, batch and cache by the specs of ``launch.shardings`` as
DTensors over meta tensors of their local shards' shapes, and runs the
step of ``launch.specs`` under ``mesh_context`` and
``implicit_replication()`` (training: forward and backward). Nothing is
allocated or computed, no kernel launches (the train step takes the chunked
logprob path, the one the JAX package's dry run lowers), and DTensor's
sharding rules and collectives run as they would on the chips.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k --mesh single            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

Results append to dryrun_out/dryrun.jsonl (``--out``; one JSON object per
cell); (arch, shape, mesh, tag) cells already done are skipped, so a sweep
resumes. A cell that fails records ``ok: false`` with its error.

A record holds, under the JAX package's names where the meaning is the same:
  argument_size_in_bytes  one rank's shards of the step's arguments, summed
                          exactly from the local shapes
  temp_size_in_bytes      the peak of the bytes of the other tensors alive
                          at once on that rank while the step runs (each
                          storage counted once, views included, freed when
                          the last reference goes), as the run tracks them:
                          a measurement of the program's tensors on the meta
                          device, not of an allocator's pools or workspaces
  bytes_per_device        the two summed
  collectives             {kind: [count, bytes a chip sends]} of every
                          collective DTensor issued (``launch.roofline``'s
                          counter and ring formulas)
  compute_s/memory_s/collective_s, dominant, model_flops, useful_ratio,
  roofline_frac           ``launch.analytic``'s terms over the card's peaks
                          (the H100 SXM's data sheet when no card is
                          present; ``card`` names the card and its power
                          limit when one is)
  trace_s                 the step's run on the meta device (in place of
                          lower_s/compile_s)
  temp_by_op              the largest parts of the temporaries' peak, by
                          the op that made them ("(backward)" for ops of
                          the backward)
  reshards                {name: count} of the port's reshards where DTensor
                          refuses what GSPMD does on its own
  mesh_device             the mesh's device type ("cuda" or "cpu"); the
                          collectives do not depend on it
  run_mesh_shape          the mesh the step ran on (below)

A multi-pod cell's specs are the 2×16×16 mesh's, with ("pod", "data")
splitting the batch; its step runs on the (pod×data, model) = 32×16 view of
the same 512 ranks, where that split is one 32-way "data" axis, pod-major as
in JAX (GSPMD too treats a dim split over two axes as one split over their
product). torch 2.11's DTensor ops refuse a dim split over two mesh axes
([Shard(0), Shard(0)]), and on three axes 2.13's sharding search takes
minutes an op.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch

from repro_torch.configs import REGISTRY, ModelConfig, ShapeConfig, shapes_for
from repro_torch.launch import roofline
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs as sp
from repro_torch.launch.analytic import analytic_terms
from repro_torch.launch.mesh import fake_world, make_mesh, make_production_mesh
from repro_torch.train import sharding

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "dryrun_out", "dryrun.jsonl")
# the fields that differ between two runs of one cell
TIMING_FIELDS = ("trace_s", "total_s")


def _done_cells(path: str):
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["shape"], r["mesh"],
                                  r.get("tag", "base")))
                except json.JSONDecodeError:
                    pass
    return done


def live_bytes_tracker():
    """A ``TorchDispatchMode`` that tracks the storages of this rank's
    tensors that the ops inside it return: plain tensors, and the local
    tensors of DTensors (a DTensor op runs whole inside the mode's call, so
    the global-shape meta tensors DTensor makes to infer its outputs are not
    counted; the collectives of a redistribute are plain ops and are).
    ``peak`` is the most bytes alive at once; a storage counts from the op
    that returns it until its last reference dies. ``peak_by_op`` splits
    the peak by the op that made each storage (its name, with
    " (backward)" for an op run by autograd's backward), and ``top(n)``
    gives its n largest parts. Enter it inside the collective counter,
    which must see DTensor's ops as they run."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class LiveBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = 0
            self.peak = 0
            self.peak_by_op = {}
            self._by_op = {}
            self._seen = set()

        def _free(self, key, n, op):
            self._seen.discard(key)
            self.live -= n
            self._by_op[op] -= n

        def top(self, n=8):
            parts = sorted(self.peak_by_op.items(), key=lambda kv: -kv[1])
            return {k: v for k, v in parts[:n] if v > 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            op = func.overloadpacket.__name__
            if torch._C._current_autograd_node() is not None:
                op += " (backward)"
            for t in tree_leaves(out):
                if isinstance(t, DTensor):
                    t = t._local_tensor
                if not isinstance(t, torch.Tensor):
                    continue
                st = t.untyped_storage()
                key = id(st)
                if key in self._seen:
                    continue
                n = st.nbytes()
                self._seen.add(key)
                self.live += n
                self._by_op[op] = self._by_op.get(op, 0) + n
                weakref.finalize(st, self._free, key, n, op)
                if self.live > self.peak:
                    self.peak = self.live
                    self.peak_by_op = dict(self._by_op)
            return out

    return LiveBytes()


def _peaks():
    """(the card's peaks, its card line), or the H100 SXM's data sheet and
    "" with no card."""
    if torch.cuda.is_available():
        return roofline.device_peaks(), roofline.card_line()
    return roofline.peaks_for("H100 SXM"), ""


def _merge_pod(spec_tree):
    """Specs for the multi-pod mesh's (pod×data, model) view: ("pod", "data")
    splits a dim over "data" of pod×data ranks, pod-major as in JAX."""
    def entry(e):
        if isinstance(e, tuple) and e[:2] == ("pod", "data"):
            return ("data",) + e[2:]
        if e == "pod" or (isinstance(e, tuple) and "pod" in e):
            raise ValueError(f"spec entry {e}: 'pod' without 'data' after it")
        return e
    flat = sh._flatten_with_paths(spec_tree)
    return sh._unflatten_like(spec_tree, {k: sharding.P(*map(entry, v))
                                          for k, v in flat.items()})


def _step_and_args(cfg: ModelConfig, shape: ShapeConfig, mesh, run_mesh):
    """(step fn, its arguments as DTensors on `run_mesh`) of one cell, placed
    by the specs of `mesh` (the same mesh, or the multi-pod mesh whose
    (pod×data, model) view `run_mesh` is)."""
    def place(tree, spec_tree):
        if run_mesh is not mesh:
            spec_tree = _merge_pod(spec_tree)
        return sh.with_shardings(tree, spec_tree, run_mesh)

    shapes = sp.eval_shapes(cfg)
    params_in = place(shapes["params"],
                      sh.param_specs(cfg, shapes["params"], mesh))
    if shape.kind == "train":
        lspec = sh.lora_specs(cfg, shapes["lora"], mesh)
        ospec = sh.opt_specs(lspec)
        batch = sp.train_batch_specs(cfg, shape)
        wide = cfg.family in ("ssm", "hybrid")   # tp-replicated weights
        bspec = sh.batch_specs(batch, mesh, shape.global_batch, wide=wide)
        fn = sp.build_train_step(cfg, shape, use_logprob_kernel=False)
        return fn, (params_in, place(shapes["lora"], lspec),
                    place(shapes["opt"], ospec), place(batch, bspec))
    lsspec = sh.lora_specs(cfg, shapes["lora_stacked"], mesh, batched=True)
    serve = sp.serve_specs(cfg, shape)
    cspec = sh.cache_specs(cfg, serve["cache"], mesh, shape.global_batch)
    rest = {k: v for k, v in serve.items() if k != "cache"}
    bsp = sh.batch_specs(rest, mesh, shape.global_batch)
    adapters_in = place(shapes["lora_stacked"], lsspec)
    cache_in = place(serve["cache"], cspec)
    rest = place(rest, bsp)
    if shape.kind == "prefill":
        args = [params_in, adapters_in, rest["row_ids"], rest["tokens"],
                rest["prompt_lens"], cache_in]
        if cfg.family == "encdec":
            args.append(rest["enc_embeds"])
        return sp.build_prefill_step(cfg), tuple(args)
    return sp.build_decode_step(cfg), (params_in, adapters_in,
                                       rest["row_ids"], rest["cur_tokens"],
                                       cache_in)


def cell_record(cfg: ModelConfig, shape: ShapeConfig, mesh,
                tag: str = "base") -> dict:
    """Run one cell's step on `mesh` (a mesh over a fake world) and return
    its record (module docstring). Raises where the step fails."""
    from torch.distributed.tensor.experimental import implicit_replication
    chips = mesh.size()
    sizes = sharding.axis_sizes(mesh)
    run_mesh = mesh
    if "pod" in sizes:
        run_mesh = make_mesh((sizes["pod"] * sizes["data"], sizes["model"]),
                             ("data", "model"), mesh.device_type)
    rec = {"arch": cfg.name, "shape": shape.name,
           "mesh": "multipod" if "pod" in sizes else "single",
           "chips": chips, "mesh_shape": list(mesh.shape),
           "run_mesh_shape": list(run_mesh.shape), "tag": tag,
           "mesh_device": mesh.device_type, "ok": False}
    t0 = time.time()
    fn, args = _step_and_args(cfg, shape, mesh, run_mesh)
    rec["argument_size_in_bytes"] = sum(sh.arg_bytes(a) for a in args)
    counter = roofline.collective_counter()
    live = live_bytes_tracker()
    t1 = time.time()
    with sharding.mesh_context(run_mesh), implicit_replication(), counter, \
            live:
        out = fn(*args)
        del out
        reshards = sharding.reshard_log()
    rec["trace_s"] = round(time.time() - t1, 1)
    rec["temp_size_in_bytes"] = live.peak
    rec["temp_by_op"] = live.top()
    rec["bytes_per_device"] = rec["argument_size_in_bytes"] + live.peak
    coll = counter.stats
    rec["collectives"] = {k: [coll.count[k], round(v, 1)]
                          for k, v in sorted(coll.per_op.items())}
    rec["collective_bytes_per_chip"] = coll.total_per_chip
    rec["reshards"] = dict(sorted(reshards.items()))

    peaks, card = _peaks()
    tp = sizes["model"]
    at = analytic_terms(cfg, shape, chips, chips // tp, tp,
                        accum=(sp.accum_steps(cfg, shape)
                               if shape.kind == "train" else 1),
                        vocab_parallel_loss=tag.startswith("vp"))
    rec.update(at.as_dict())
    rec["compute_s"] = at.flops / (chips * peaks.flops[cfg.dtype])
    rec["memory_s"] = at.hbm_bytes / (chips * peaks.hbm_bytes_per_s)
    rec["collective_s"] = at.collective_bytes / (chips
                                                 * peaks.link_bytes_per_s)
    terms = {"compute": rec["compute_s"], "memory": rec["memory_s"],
             "collective": rec["collective_s"]}
    rec["dominant"] = max(terms, key=terms.get)
    rec["model_flops"] = roofline.model_flops_for(cfg, shape)
    rec["useful_ratio"] = rec["model_flops"] / at.flops if at.flops else 0
    rec["roofline_frac"] = (rec["compute_s"]
                            / max(max(terms.values()), 1e-30))
    rec["peaks"] = peaks.name
    rec["card"] = card
    rec["ok"] = True
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             tag: str = "base", device_type: Optional[str] = None) -> dict:
    """One production cell: the fake world and mesh of its size ("servemesh"
    in `tag` picks the serve mesh), then ``cell_record``. The mesh is on
    `device_type`, "cuda" when a card is present and "cpu" when not by
    default (on the meta device it names the collectives' backend only)."""
    cfg = REGISTRY[arch]
    shape = {s.name: s for s in shapes_for(cfg)}[shape_name]
    kind = "serve" if (tag and "servemesh" in tag) else "train"
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    n = 512 if multi_pod else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, kind=kind,
                                    device_type=device_type)
        return cell_record(cfg, shape, mesh, tag)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="base")
    ap.add_argument("--out", default=None)
    ap.add_argument("--include-paper-models", action="store_true")
    ap.add_argument("--mesh-device", default=None, choices=["cuda", "cpu"],
                    help="the mesh's device type (default: cuda when a "
                         "card is present, else cpu)")
    args = ap.parse_args(argv)

    out_path = args.out or os.path.normpath(RESULTS)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    done = _done_cells(out_path)

    cells = []
    meshes = (["single", "multipod"] if args.mesh == "both" else [args.mesh])
    if args.all:
        from repro_torch.configs import ASSIGNED, PAPER_MODELS
        pool = ASSIGNED + (PAPER_MODELS if args.include_paper_models else ())
        for cfg in pool:
            for s in shapes_for(cfg):
                for m in meshes:
                    cells.append((cfg.name, s.name, m))
    else:
        for m in meshes:
            cells.append((args.arch, args.shape, m))

    for arch, shape, m in cells:
        key = (arch, shape, m, args.tag)
        if key in done:
            print(f"SKIP {key} (done)")
            continue
        print(f"RUN  {arch} × {shape} × {m} [{args.tag}] ...", flush=True)
        try:
            rec = run_cell(arch, shape, m == "multipod", tag=args.tag,
                           device_type=args.mesh_device)
            print(f"  ok: trace={rec['trace_s']}s "
                  f"compute={rec['compute_s']:.3e}s mem={rec['memory_s']:.3e}s "
                  f"coll={rec['collective_s']:.3e}s dom={rec['dominant']} "
                  f"roofline_frac={rec['roofline_frac']:.2f} "
                  f"bytes/dev={rec['bytes_per_device'] / 1e9:.2f}GB "
                  f"collectives={rec['collectives']}", flush=True)
        except Exception as e:     # a failed cell is recorded, the sweep goes on
            rec = {"arch": arch, "shape": shape, "mesh": m, "tag": args.tag,
                   "ok": False, "error": f"{type(e).__name__}: {e}"[:2000],
                   "trace": traceback.format_exc()[-2000:]}
            print(f"  FAIL: {rec['error'][:300]}", flush=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
