"""The readings the correctness limits are set from (not run by the
benchmark's own runs).

    python3 rlbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 20

For each seed, one run of the cell as ``run.py`` makes it (a shorter
window), then, on the same served rows and the same batches:
  program   the program's numbers (``harness/correct.py``);
  control   the reference put in the program's place and computed with fp8
            (e4m3) base weights, the precision below the configuration's
            bf16: its own best token at each greedy position and its
            logprob of each served token (under the adapters the served
            rows were judged under), its three updates, with its own
            behaviour logprobs;
  half      the fp32 reference put in the program's place with half of each
            batch left out (the loss's mean over the other half).
A state left unchanged reads 1 on grad_gap and update_gap and needs no run.
One JSON line a seed on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent), str(Path.cwd() / "src")]


def readings(st, quant: str = "fp8"):
    """(program, control, half-batch) readings of one finished run."""
    from rlbench.harness import correct as C
    model = C.ref_model(st)
    tids = C.check_tenants(st)
    rows = C.pick_served(st, tids)
    prog = C.served_readings(st, model, rows)
    control = C.ref_model(st, quant=quant)
    ctrl = C.served_readings(st, model, rows, control=control)
    refs = {t: C.follow(st, model, t) for t in tids}
    prog.update(C.train_max(st, refs, {t: C.program_run(st, t) for t in tids}))
    ctrl.update(C.train_max(st, refs, {t: C.follow(st, control, t) for t in tids}))
    g = st.traffic.mix["group_size"]
    half = C.train_max(st, refs, {t: C.follow(st, model, t, keep_rows=list(range(g // 2)))
                                  for t in tids})
    return prog, ctrl, half


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    import torch
    from rlbench.harness import cell as cells
    from rlbench.harness import driver
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = cells.load_cell(Path.cwd(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        st = driver.run(cell, seed, args.seconds, False, "cuda",
                        log=lambda m: print(m, file=sys.stderr, flush=True))
        prog, ctrl, half = readings(st)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": prog, "control": ctrl, "half": half}),
              flush=True)
        del st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
