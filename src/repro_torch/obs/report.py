"""Critical-path latency attribution over an exported episode trace.

    PYTHONPATH=src python -m repro_torch.obs.report trace.json [--json out.json]

(A copy of ``repro.obs.report``, plain Python.)

Consumes the Chrome trace-event JSON written by ``Tracer.dump_json`` /
``Tracer.export_chrome`` (the ``cat == "episode"`` slices the exporter
synthesizes from the lifecycle marks) and answers the question aggregate
busy-seconds cannot: *where did each episode's submission→commit latency
go, and which stage is each tenant's bottleneck?*

Per episode it recovers the additive decomposition — queue_wait,
prefill, splice_wait, restore, decode, env_queue_wait, env, resume_wait,
preempt_wait, completed_wait, train — verifies the components sum to the
end-to-end latency (they do by construction; the check catches exporter
or clock regressions), then aggregates per tenant: episode count, E2E
p50/p95/p99, mean seconds per component, and the dominant (bottleneck)
component by total time.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (no numpy dependency needed here)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
    return s[k]


def load_episodes(trace: Dict) -> List[Dict]:
    """Rebuild per-episode records from the synthesized ``episode``
    slices: ``{trace, task, t0, t1, e2e, terminal, components}`` with
    times in seconds."""
    by_trace: Dict[int, Dict] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") != "episode" or ev.get("ph") != "X":
            continue
        args = ev.get("args", {})
        tr = args.get("trace")
        if tr is None:
            continue
        rec = by_trace.setdefault(tr, {
            "trace": tr, "task": args.get("task", "?"),
            "t0": None, "t1": None,
            "terminal": args.get("terminal", "?"), "components": {}})
        ts, dur = ev["ts"] / 1e6, ev["dur"] / 1e6
        rec["t0"] = ts if rec["t0"] is None else min(rec["t0"], ts)
        rec["t1"] = (ts + dur if rec["t1"] is None
                     else max(rec["t1"], ts + dur))
        comp = rec["components"]
        comp[ev["name"]] = comp.get(ev["name"], 0.0) + dur
    out = []
    for rec in by_trace.values():
        rec["e2e"] = rec["t1"] - rec["t0"]
        total = sum(rec["components"].values())
        rec["residual"] = abs(total - rec["e2e"])
        out.append(rec)
    out.sort(key=lambda r: r["trace"])
    return out


def load_faults(trace: Dict) -> Dict:
    """Fault/recovery attribution from the supervisor's instant
    marks: per-stage restart counts and the per-tenant circuit-breaker
    transition sequence (``<tenant>:<state>`` instants on the breaker
    thread)."""
    events = trace.get("traceEvents", [])
    # stage names live in thread_name metadata, keyed (pid, tid)
    names = {(ev.get("pid"), ev.get("tid")): ev.get("args", {}).get("name")
             for ev in events
             if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    restarts: Dict[str, int] = {}
    breaker: Dict[str, List[str]] = {}
    for ev in events:
        if ev.get("cat") != "supervisor" or ev.get("ph") != "i":
            continue
        name = ev.get("name", "")
        if ":" in name:
            tid, _, state = name.rpartition(":")
            breaker.setdefault(tid, []).append(state)
        elif name == "restart":
            stage = names.get((ev.get("pid"), ev.get("tid")), "?")
            restarts[stage] = restarts.get(stage, 0) + 1
    return {"stage_restarts": restarts,
            "breaker_transitions": {t: s for t, s in sorted(breaker.items())}}


def analyze(episodes: List[Dict]) -> Dict:
    """Per-tenant aggregation + global additivity check."""
    tenants: Dict[str, Dict] = {}
    worst_residual = 0.0
    for ep in episodes:
        t = tenants.setdefault(ep["task"], {"episodes": 0, "e2e": [],
                                            "components": {},
                                            "terminals": {}})
        t["episodes"] += 1
        t["e2e"].append(ep["e2e"])
        t["terminals"][ep["terminal"]] = t["terminals"].get(
            ep["terminal"], 0) + 1
        for name, sec in ep["components"].items():
            t["components"][name] = t["components"].get(name, 0.0) + sec
        if ep["e2e"] > 0:
            worst_residual = max(worst_residual,
                                 ep["residual"] / ep["e2e"])
    out = {"tenants": {}, "episodes": len(episodes),
           "max_relative_residual": worst_residual}
    for task, t in sorted(tenants.items()):
        comp = t["components"]
        bottleneck = (max(comp, key=comp.get) if comp else "none")
        out["tenants"][task] = {
            "episodes": t["episodes"],
            "e2e_p50": percentile(t["e2e"], 50),
            "e2e_p95": percentile(t["e2e"], 95),
            "e2e_p99": percentile(t["e2e"], 99),
            "components_mean": {k: v / t["episodes"]
                                for k, v in sorted(comp.items())},
            "bottleneck": bottleneck,
            "terminals": t["terminals"],
        }
    return out


def format_report(result: Dict) -> str:
    lines = [f"episodes: {result['episodes']}   "
             f"max component-sum residual: "
             f"{100 * result['max_relative_residual']:.3f}% of E2E"]
    faults = result.get("faults")
    if faults and (faults["stage_restarts"] or faults["breaker_transitions"]):
        lines.append("faults/recovery:")
        for stage, n in sorted(faults["stage_restarts"].items()):
            lines.append(f"  {stage}: {n} restart(s)")
        for tid, seq in faults["breaker_transitions"].items():
            lines.append(f"  breaker {tid}: {' -> '.join(seq)}")
    hdr = (f"{'tenant':20s} {'eps':>4s} {'e2e p50':>9s} {'p95':>9s} "
           f"{'p99':>9s}  bottleneck (mean seconds by component)")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for task, t in result["tenants"].items():
        comps = " ".join(f"{k}={v:.3f}"
                         for k, v in t["components_mean"].items())
        lines.append(f"{task:20s} {t['episodes']:4d} {t['e2e_p50']:9.3f} "
                     f"{t['e2e_p95']:9.3f} {t['e2e_p99']:9.3f}  "
                     f"{t['bottleneck']} [{comps}]")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="critical-path latency attribution over a trace")
    ap.add_argument("trace", help="Chrome trace-event JSON from Tracer")
    ap.add_argument("--json", default=None,
                    help="also write the aggregated report as JSON")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    episodes = load_episodes(trace)
    if not episodes:
        print("no episode slices in trace (was tracing enabled?)",
              file=sys.stderr)
        return 1
    result = analyze(episodes)
    result["faults"] = load_faults(trace)
    print(format_report(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
