"""CLI: ``python -m repro_torch.analysis [--check] [--write-baseline] PATHS``.

Default mode prints every finding. ``--check`` compares against the
committed baseline (``analysis/baseline.json``) and exits 1 only on NEW
findings — the CI gate. ``--write-baseline`` regenerates the baseline
from the current findings (review the diff before committing it).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .core import (RULES, analyze_paths, default_baseline_path,
                   diff_against_baseline, load_baseline, write_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis of the PyTorch port (lock discipline, "
                    "decode-step host syncs, CUDA launcher signatures)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--check", action="store_true",
                    help="fail (exit 1) on findings NOT in the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from current findings")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline path (default: analysis/baseline.json)")
    ap.add_argument("--report", type=Path, default=None,
                    help="write all findings as JSON to this path")
    args = ap.parse_args(argv)

    findings, _ = analyze_paths(args.paths or ["src/repro_torch"])

    if args.report:
        args.report.write_text(json.dumps(
            {"findings": [{"rule": f.rule, "file": f.file, "line": f.line,
                           "message": f.message} for f in findings]},
            indent=2) + "\n")

    if args.write_baseline:
        path = write_baseline(findings, args.baseline)
        print(f"wrote {len(findings)} finding(s) to {path}")
        return 0

    if args.check:
        baseline = load_baseline(args.baseline)
        new = diff_against_baseline(findings, baseline)
        known = len(findings) - len(new)
        for f in new:
            print(f.format())
        print(f"{len(new)} new finding(s); {known} baselined "
              f"({args.baseline or default_baseline_path()})")
        return 1 if new else 0

    for f in findings:
        print(f.format())
    by_rule = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    for rule in sorted(by_rule):
        print(f"  {rule} {RULES[rule]}: {by_rule[rule]}")
    print(f"{len(findings)} finding(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
