"""The benchmark of repro_torch, the MARLaaS runtime's PyTorch and CUDA port.

    python3 rlbench/run.py --workload <config>.<mix> --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``. One run: set-up
(the kernels, the weights and adapters from the seed, the runtime, the
pipeline's warm-up until every tenant has committed once), a window of S
seconds, the stop, the reference's check of what the window produced. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, and with ``--trace 1``
``breakdown``); with ``--trace 0`` the metrics are the cell's end-to-end
ones, with ``--trace 1`` its per-layer ones (the runtime's tracer and
``torch.profiler`` on). The numbers compared, each beside its limit, end
standard error and the result line. It needs as many CUDA cards as the
cell asks for and exits with 2 without a result otherwise.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths():
    for p in (str(BENCH.parent), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules():
    """Modules loaded whose top-level name is one of FORBIDDEN, compared as
    whole names (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reader(name: str):
    """The metric's reader: ``metrics/<name>.py``, or for a name split per
    cell (``<metric>.<mix>``) the reader of ``<metric>``."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"rlbench_metric_{stem.replace('.', '_').replace('-', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {BENCH / 'metrics'}")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def read_metrics(st, specs):
    out = {}
    for spec in specs:
        v = reader(spec["name"])(st)
        if v is None or not math.isfinite(v):
            continue
        out[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
    return out


def compared(readings, limits):
    return {k: {"value": readings.get(k), "limit": v.get("limit")}
            for k, v in limits.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch
    from rlbench.harness import cell as cells
    from rlbench.harness import correct, driver
    cell = cells.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rlbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {n}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    st = driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                    log=log)
    found = forbidden_modules()
    if found:
        print(f"rlbench: the process holds {found} after the window",
              file=sys.stderr)
        return 3
    specs = cell.per_layer if args.trace else cell.end_to_end
    metrics = read_metrics(st, specs)
    commits = [c for c in st.probes.commits if st.t_open <= c.t1 <= st.t_close]
    ok, readings, why = correct.check(st, cell.limits, log=log)
    if st.notes:
        why.extend(st.notes)
        ok = False
    log(f"[rlbench] setup split {json.dumps(st.setup)}")
    log(f"[rlbench] window {st.t_close - st.t_open:.3f} s, commits "
        f"{len(commits)}, run on past the close {st.check_wait_s:.1f} s, "
        f"counters open {st.counters_open} close "
        f"{st.counters_close}")
    log(f"[rlbench] readings {json.dumps(readings)}")
    if st.device_trace is not None:
        dt = st.device_trace
        log(f"[rlbench] trace kernels {dt.get('kernels')} attributed "
            f"{dt.get('attributed')} ranges {json.dumps(dt.get('range_s'))} "
            f"bounds {json.dumps(st.kprobes.bound)}")
    for reason in why:
        log(f"[rlbench] not correct: {reason}")
    checks = compared(readings, cell.limits)
    for k, v in checks.items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell.chips, "memory_peak_bytes": st.memory_peak_bytes}
    result = {"correct": ok, "attempted": len(commits),
              "failed": 0 if ok else max(1, len(commits)),
              "metrics": metrics, "device": dev}
    if args.trace and st.device_trace is not None:
        dev["busy_s"] = st.device_trace["busy_s"]
        dev["window_s"] = st.device_trace["window_s"]
        result["breakdown"] = {"device_ops": st.device_trace["device_ops"],
                               "idle_gaps": st.device_trace["idle_gaps"]}
    result["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
