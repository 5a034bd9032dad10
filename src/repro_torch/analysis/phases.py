"""RA105 — metrics phase-literal discipline, over the port's registry.

Every ``rec.record(pool, phase, ...)`` call site must pass the phase as a
string literal that exists in ``repro_torch.core.metrics.PHASE_INTENSITY``. The
recorder itself accepts any string — a typo'd or unregistered phase would
silently book intervals that ``utilization_pct`` weights with the default
intensity and the per-stage summaries never surface. Catch it statically:

  RA105  phase argument of ``.record(...)`` is not a literal, or is a
         literal missing from PHASE_INTENSITY

Receivers considered recorders: names ``rec`` / ``recorder`` / ``_rec``
and attribute chains ending in them (``self.rec``, ``sim.rec``). Call
sites that forward a *variable* phase (e.g. a validated hook parameter)
suppress with ``# noqa: RA105`` next to an explicit
``phase in PHASE_INTENSITY`` guard.
"""
from __future__ import annotations

import ast
from typing import List

from .core import Finding, SourceFile

_RECORDER_NAMES = {"rec", "recorder", "_rec"}

# keep the checker importable even if metrics grows exotic imports: the
# phase registry is the single source of truth, read at check time
from repro_torch.core.metrics import PHASE_INTENSITY


def _is_recorder(node: ast.expr) -> bool:
    """True for ``rec`` / ``self.rec`` / ``runtime.rec``-style receivers."""
    if isinstance(node, ast.Name):
        return node.id in _RECORDER_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in _RECORDER_NAMES
    return False


def check(files: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    known = ", ".join(sorted(PHASE_INTENSITY))
    for src in files:
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "record"
                    and _is_recorder(node.func.value)):
                continue
            if len(node.args) < 2:
                continue        # phase passed by keyword or not at all
            phase = node.args[1]
            if not (isinstance(phase, ast.Constant)
                    and isinstance(phase.value, str)):
                out.append(Finding(
                    "RA105", src.rel, node.lineno,
                    "phase argument of rec.record() is not a string "
                    "literal — pass a PHASE_INTENSITY key (or guard the "
                    "variable and suppress)"))
            elif phase.value not in PHASE_INTENSITY:
                out.append(Finding(
                    "RA105", src.rel, node.lineno,
                    f"phase {phase.value!r} is not in PHASE_INTENSITY "
                    f"(known: {known})"))
    return out
