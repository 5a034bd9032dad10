"""Shared analysis infrastructure of the port's analyzer: source loading,
findings, suppression and the committed baseline (a copy of
``repro.analysis.core``, with the port's rule ids and paths).

A ``Finding`` is keyed for baseline purposes by ``(rule, file, message)``
— deliberately NOT by line number, so unrelated edits that shift code
don't invalidate the baseline. The baseline is a multiset: if the code
has two identical pre-existing findings and a third appears, the third is
NEW and fails ``--check``.

File paths are normalized to start at ``src/`` when they live under
``src/repro_torch`` (or ``src/repro``: stable keys regardless of the
invoking cwd); paths outside the tree (test fixtures) fall back to their
basename.

Rule ids: RA1xx are the reference's lock, phase and robustness rules,
unchanged; the torch rules take new ids, RT2xx (host syncs and
allocations on the decode step, ``analysis/tracing.py``) and RT3xx (the
CUDA launchers' C signatures, ``analysis/launch_rules.py``), because the
reference's analyzer also scans ``src/repro_torch`` and honours its
``# noqa: RA2xx`` marks.
"""
from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

RULES: Dict[str, str] = {
    "RA101": "lock-order cycle (potential deadlock)",
    "RA102": "guarded attribute accessed outside its lock",
    "RA103": "blocking call while holding a lock",
    "RA105": "rec.record() phase is not a PHASE_INTENSITY literal",
    "RA106": "swallowed exception in a stage worker run() loop",
    "RT201": "Python control flow on a tensor value in a decode-step function",
    "RT202": "host sync in a decode-step function",
    "RT203": "allocation with an unbucketed per-step shape in a decode-step "
             "function (CUDA-graph recapture hazard)",
    "RT301": "launcher argtypes vs its extern \"C\" declaration",
    "RT302": "launcher call arity vs its argtypes",
    "RT303": "launcher in a .cu file and SIGNATURES out of step",
}

_NOQA_RE = re.compile(
    r"noqa(?::\s*(R[AT]\d+(?:\s*,\s*R[AT]\d+)*))?", re.I)


@dataclass(frozen=True)
class Finding:
    rule: str
    file: str          # normalized path (see normalize_rel)
    line: int
    message: str

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.message)

    def format(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} {self.message}"


def normalize_rel(path: Path) -> str:
    posix = path.resolve().as_posix()
    for root in ("src/repro_torch/", "src/repro/"):
        idx = posix.find(root)
        if idx >= 0:
            return posix[idx:]
    return path.name


@dataclass
class SourceFile:
    path: Path
    rel: str
    text: str
    tree: ast.Module
    comments: Dict[int, str]       # line -> comment text (sans leading '#')
    comment_only: Set[int]         # lines that hold ONLY a comment
    noqa: Dict[int, Set[str]]      # line -> suppressed rule ids ({'*'}=all)

    def comment_at(self, line: int) -> str:
        """Comment on `line`, plus any immediately-following comment-only
        continuation lines (multi-line annotations)."""
        parts = []
        if line in self.comments:
            parts.append(self.comments[line])
            nxt = line + 1
            while nxt in self.comment_only:
                parts.append(self.comments[nxt])
                nxt += 1
        return " ".join(parts)


def _extract_comments(text: str):
    comments: Dict[int, str] = {}
    comment_only: Set[int] = set()
    code_lines: Set[int] = set()
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        return comments, comment_only
    for tok in toks:
        if tok.type == tokenize.COMMENT:
            comments[tok.start[0]] = tok.string.lstrip("#").strip()
        elif tok.type not in (tokenize.NL, tokenize.NEWLINE,
                              tokenize.INDENT, tokenize.DEDENT,
                              tokenize.ENDMARKER):
            for ln in range(tok.start[0], tok.end[0] + 1):
                code_lines.add(ln)
    comment_only.update(ln for ln in comments if ln not in code_lines)
    return comments, comment_only


def _extract_noqa(comments: Dict[int, str]) -> Dict[int, Set[str]]:
    noqa: Dict[int, Set[str]] = {}
    for ln, text in comments.items():
        m = _NOQA_RE.search(text)
        if not m:
            continue
        if m.group(1):
            noqa[ln] = {r.strip().upper() for r in m.group(1).split(",")}
        else:
            noqa[ln] = {"*"}
    return noqa


def load_source(path: Path) -> Optional[SourceFile]:
    try:
        text = path.read_text()
        tree = ast.parse(text)
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    comments, comment_only = _extract_comments(text)
    return SourceFile(path=path, rel=normalize_rel(path), text=text,
                      tree=tree, comments=comments,
                      comment_only=comment_only,
                      noqa=_extract_noqa(comments))


def collect_files(paths: Iterable[str]) -> List[SourceFile]:
    seen: Set[Path] = set()
    out: List[SourceFile] = []
    for p in paths:
        root = Path(p)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            f = f.resolve()
            if f in seen or "__pycache__" in f.parts:
                continue
            seen.add(f)
            src = load_source(f)
            if src is not None:
                out.append(src)
    return out


def _suppressed(finding: Finding, src: SourceFile) -> bool:
    rules = src.noqa.get(finding.line)
    return bool(rules) and ("*" in rules or finding.rule in rules)


def analyze_paths(paths: Iterable[str]):
    """Run every checker family; returns (findings, lock_model).

    ``lock_model`` is the cross-module lock graph (``locks.LockModel``)
    the runtime validator cross-checks against."""
    from . import launch_rules, locks, phases, robustness, tracing

    files = collect_files(paths)
    model = locks.build_model(files)
    findings: List[Finding] = []
    findings += locks.check(files, model)
    findings += tracing.check(files)
    findings += launch_rules.check(files)
    findings += phases.check(files)
    findings += robustness.check(files)
    by_rel = {f.rel: f for f in files}
    findings = [f for f in findings
                if f.file not in by_rel or not _suppressed(f, by_rel[f.file])]
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    return findings, model


# -- baseline ------------------------------------------------------------

def default_baseline_path() -> Path:
    return Path(__file__).parent / "baseline.json"


def load_baseline(path: Optional[Path] = None) -> Counter:
    path = path or default_baseline_path()
    if not path.exists():
        return Counter()
    data = json.loads(path.read_text())
    base: Counter = Counter()
    for e in data.get("findings", []):
        base[(e["rule"], e["file"], e["message"])] += int(e.get("count", 1))
    return base


def write_baseline(findings: List[Finding],
                   path: Optional[Path] = None) -> Path:
    path = path or default_baseline_path()
    counts = Counter(f.key for f in findings)
    entries = [{"rule": r, "file": f, "message": m, "count": c}
               for (r, f, m), c in sorted(counts.items())]
    path.write_text(json.dumps({"version": 1, "findings": entries},
                               indent=2) + "\n")
    return path


def diff_against_baseline(findings: List[Finding],
                          baseline: Counter) -> List[Finding]:
    """Findings NOT covered by the baseline multiset (the --check gate)."""
    budget = Counter(baseline)
    new: List[Finding] = []
    for f in findings:
        if budget[f.key] > 0:
            budget[f.key] -= 1
        else:
            new.append(f)
    return new
