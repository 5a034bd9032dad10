"""RA106 — no swallowed exceptions in stage-worker run() loops.

The threaded stages (prefill workers, env workers) are supervised: a
worker that dies is detected by liveness/heartbeat checks and restarted,
and its in-flight work is recovered. That whole story collapses if a
worker's ``run()`` swallows the exception instead of dying (or recording
it) — the supervisor sees a healthy thread spinning uselessly, nothing
restarts, and the fault surfaces as a silent throughput hole.

  RA106  in the ``run()`` method of a ``threading.Thread`` subclass: a
         bare ``except:``, or an ``except Exception/BaseException``
         handler that neither re-raises nor uses the caught exception
         (binds no name, or binds one the handler body never reads)

Using the exception means: a bare ``raise``, or any read of the bound
name (stashing it on ``self.error``, passing it to ``_finish``, logging
it). Narrow except types (``except ToolError``) are the stage's own
error taxonomy and are never flagged. Suppress a deliberate swallow with
``# noqa: RA106`` and a comment saying why.
"""
from __future__ import annotations

import ast
from typing import List

from .core import Finding, SourceFile

_BROAD = {"Exception", "BaseException"}


def _is_thread_base(base: ast.expr) -> bool:
    """True for ``threading.Thread`` / ``Thread`` base-class nodes."""
    if isinstance(base, ast.Name):
        return base.id == "Thread"
    if isinstance(base, ast.Attribute):
        return base.attr == "Thread"
    return False


def _broad_type(node: ast.expr) -> bool:
    """True if the except type catches Exception/BaseException (directly
    or anywhere in a tuple)."""
    if isinstance(node, ast.Tuple):
        return any(_broad_type(e) for e in node.elts)
    if isinstance(node, ast.Name):
        return node.id in _BROAD
    if isinstance(node, ast.Attribute):
        return node.attr in _BROAD
    return False


def _uses_exception(handler: ast.ExceptHandler) -> bool:
    """The handler re-raises or reads the caught exception."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True            # bare `raise` or `raise X from e`
        if (handler.name and isinstance(node, ast.Name)
                and node.id == handler.name
                and isinstance(node.ctx, ast.Load)):
            return True
    return False


def check(files: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for src in files:
        for cls in ast.walk(src.tree):
            if not (isinstance(cls, ast.ClassDef)
                    and any(_is_thread_base(b) for b in cls.bases)):
                continue
            run = next((n for n in cls.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and n.name == "run"), None)
            if run is None:
                continue
            for node in ast.walk(run):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                if node.type is None:
                    out.append(Finding(
                        "RA106", src.rel, node.lineno,
                        f"bare except in {cls.name}.run() — the supervisor "
                        "can't see a worker that swallows its own death; "
                        "catch narrowly or record/re-raise"))
                elif _broad_type(node.type) and not _uses_exception(node):
                    out.append(Finding(
                        "RA106", src.rel, node.lineno,
                        f"except {ast.unparse(node.type)} in "
                        f"{cls.name}.run() swallows the exception — "
                        "re-raise it or record it (self.error / _finish) "
                        "so the supervisor and caller can act"))
    return out
