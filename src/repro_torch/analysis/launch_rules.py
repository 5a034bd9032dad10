"""RT3xx — the CUDA launchers' C interface, the counterpart of the JAX
package's Pallas arity rules (RA3xx): contracts that otherwise fail
silently. The kernels are bound through ``ctypes``: ``kernels/_build.py``'s
``SIGNATURES`` gives each exported launcher of ``csrc/<source>.cu`` its
``argtypes``, and ctypes converts a call's Python arguments by them. An
``argtypes`` list one entry short shifts every later argument into the
wrong C parameter; a ``c_float`` where the C side takes an ``int`` passes
the float's bits. Neither raises.

  RT301  a launcher's ``argtypes`` against its ``extern "C"`` declaration
         in ``csrc/<source>.cu``: the count, and each argument's class
         (pointer, ``int``, ``float``, ``long long``; any other type by its
         name, so that it matches nothing but itself)
  RT302  each call of a loaded launcher (``<lib>.<launcher>(...)``) in the
         kernel modules beside ``_build.py`` against its ``argtypes``
         count (starred arguments are counted through tuple literals,
         comprehensions over them, and the tuples a module function
         returns)
  RT303  a launcher exported by a ``.cu`` source that ``SIGNATURES`` does
         not name, a ``SIGNATURES`` launcher the source does not export,
         or a ``SIGNATURES`` source with no ``.cu`` file

The rules run where a scanned file defines a module-level ``SIGNATURES``
dict; its ``.cu`` sources are read from ``csrc/`` beside that file.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .core import Finding, SourceFile, normalize_rel

_CTYPES = {"c_void_p": "pointer", "c_int": "int", "c_float": "float",
           "c_longlong": "long long"}
_C_TYPES = {"int": "int", "float": "float", "long long": "long long"}
_EXTERN_RE = re.compile(
    r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", " ", text)


def c_class(param: str) -> str:
    """The argument class of one C parameter declaration."""
    if "*" in param or "[" in param:
        return "pointer"
    words = [w for w in re.findall(r"[A-Za-z_]\w*", param)
             if w not in ("const", "volatile", "restrict", "__restrict__")]
    base = " ".join(words[:-1]) if len(words) > 1 else " ".join(words)
    return _C_TYPES.get(base, base)


def c_launchers(text: str) -> Dict[str, Tuple[List[str], int]]:
    """{launcher: ([argument classes], line)} of a .cu source's
    ``extern "C"`` definitions."""
    clean = _strip_comments(text)
    out = {}
    for m in _EXTERN_RE.finditer(clean):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        if params == ["void"]:
            params = []
        line = clean.count("\n", 0, m.start()) + 1
        out[m.group(1)] = ([c_class(p) for p in params], line)
    return out


def _aliases(tree: ast.Module) -> Dict[str, str]:
    """Module-level names bound to ctypes classes (``_I = ctypes.c_int``,
    ``_P, _I = ctypes.c_void_p, ctypes.c_int``) -> the class name."""
    out: Dict[str, str] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt, val = node.targets[0], node.value
        pairs = (zip(tgt.elts, val.elts)
                 if isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple)
                 and len(tgt.elts) == len(val.elts) else [(tgt, val)])
        for t, v in pairs:
            if isinstance(t, ast.Name) and isinstance(v, ast.Attribute) \
                    and v.attr.startswith("c_"):
                out[t.id] = v.attr
    return out


def _argtypes(node: ast.expr, aliases: Dict[str, str]) -> Optional[List[str]]:
    """A static argtypes expression (list literals, ``+``, ``* n``) as
    ctypes class names; None where it cannot be read."""
    if isinstance(node, ast.List):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Name) and e.id in aliases:
                out.append(aliases[e.id])
            elif isinstance(e, ast.Attribute) and e.attr.startswith("c_"):
                out.append(e.attr)
            else:
                return None
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _argtypes(node.left, aliases), _argtypes(node.right, aliases)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                a = _argtypes(seq, aliases)
                return None if a is None else a * n.value
    return None


def signatures(src: SourceFile):
    """{source: {launcher: (argtypes classes or None, line)}} of a module's
    ``SIGNATURES`` dict literal, or None when it defines none."""
    aliases = _aliases(src.tree)
    for node in src.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            tgts = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Name) and t.id == "SIGNATURES"
                   for t in tgts) and isinstance(node.value, ast.Dict):
                out = {}
                for k, v in zip(node.value.keys, node.value.values):
                    if not (isinstance(k, ast.Constant)
                            and isinstance(v, ast.Dict)):
                        continue
                    fns = {}
                    for fk, fv in zip(v.keys, v.values):
                        if isinstance(fk, ast.Constant):
                            fns[fk.value] = (_argtypes(fv, aliases),
                                             fk.lineno)
                    out[k.value] = fns
                return out
    return None


# -- RT302: counting a call's arguments -----------------------------------

def _module_returns(tree: ast.Module) -> Dict[str, ast.expr]:
    """Module functions whose every ``return`` gives one tuple shape."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            rets = [r.value for r in ast.walk(node)
                    if isinstance(r, ast.Return) and r.value is not None]
            if len(rets) == 1:
                out[node.name] = rets[0]
    return out


class _Counter:
    def __init__(self, fn: ast.FunctionDef, returns: Dict[str, ast.expr]):
        self.assign: Dict[str, ast.expr] = {}
        self.returns = returns
        for s in ast.walk(fn):
            if isinstance(s, ast.Assign) and len(s.targets) == 1:
                tgt = s.targets[0]
                if isinstance(tgt, ast.Name):
                    self.assign[tgt.id] = s.value
                elif isinstance(tgt, ast.Tuple):
                    for i, e in enumerate(tgt.elts):
                        if isinstance(e, ast.Name):
                            self.assign[e.id] = ast.Subscript(
                                value=s.value, slice=ast.Constant(i),
                                ctx=ast.Load())

    def length(self, node: ast.expr, depth: int = 0) -> Optional[int]:
        if depth > 6:
            return None
        if isinstance(node, (ast.Tuple, ast.List)):
            if any(isinstance(e, ast.Starred) for e in node.elts):
                return None
            return len(node.elts)
        if isinstance(node, (ast.GeneratorExp, ast.ListComp)) \
                and len(node.generators) == 1 \
                and not node.generators[0].ifs:
            return self.length(node.generators[0].iter, depth + 1)
        if isinstance(node, ast.Name) and node.id in self.assign:
            return self.length(self.assign[node.id], depth + 1)
        if isinstance(node, ast.Call):
            elts = self._tuple(node, depth + 1)
            return None if elts is None else len(elts)
        if isinstance(node, ast.Subscript) \
                and isinstance(node.slice, ast.Constant):
            inner = self._tuple(node.value, depth + 1)
            if inner is not None and 0 <= node.slice.value < len(inner):
                return self.length(inner[node.slice.value], depth + 1)
        return None

    def _tuple(self, node: ast.expr, depth: int):
        """The element expressions of a tuple-valued expression."""
        if isinstance(node, ast.Tuple):
            return node.elts
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in self.returns:
            ret = self.returns[node.func.id]
            return ret.elts if isinstance(ret, ast.Tuple) else None
        if isinstance(node, ast.Name) and node.id in self.assign \
                and depth < 6:
            return self._tuple(self.assign[node.id], depth + 1)
        return None

    def count(self, call: ast.Call) -> Optional[int]:
        n = 0
        for a in call.args:
            if isinstance(a, ast.Starred):
                k = self.length(a.value)
                if k is None:
                    return None
                n += k
            else:
                n += 1
        return n + len(call.keywords)


def _call_findings(src: SourceFile, launchers: Dict[str, int],
                   out: List[Finding]):
    returns = _module_returns(src.tree)
    for fn in ast.walk(src.tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        counter = None
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in launchers):
                continue
            counter = counter or _Counter(fn, returns)
            name, want = node.func.attr, launchers[node.func.attr]
            got = counter.count(node)
            if got is None:
                out.append(Finding(
                    "RT302", src.rel, node.lineno,
                    f"call of launcher `{name}`: its starred arguments "
                    f"cannot be counted against its {want} argtypes"))
            elif got != want:
                out.append(Finding(
                    "RT302", src.rel, node.lineno,
                    f"call of launcher `{name}` passes {got} arguments; "
                    f"its argtypes has {want}"))


def check(files: List[SourceFile]) -> List[Finding]:
    out: List[Finding] = []
    for src in files:
        sigs = signatures(src)
        if sigs is None:
            continue
        csrc = Path(src.path).parent / "csrc"
        counts: Dict[str, int] = {}
        for source, fns in sigs.items():
            cu = csrc / f"{source}.cu"
            for fn, (types, line) in fns.items():
                if types is not None:
                    counts[fn] = len(types)
            if not cu.exists():
                out.append(Finding(
                    "RT303", src.rel, min((ln for _, ln in fns.values()),
                                          default=1),
                    f"SIGNATURES names source `{source}`, which has no "
                    f"csrc/{source}.cu"))
                continue
            exported = c_launchers(cu.read_text())
            cu_rel = normalize_rel(cu)
            for fn, (c_args, c_line) in sorted(exported.items()):
                if fn not in fns:
                    out.append(Finding(
                        "RT303", cu_rel, c_line,
                        f"launcher `{fn}` is exported but SIGNATURES"
                        f"[{source!r}] does not name it (ctypes calls it "
                        f"without argtypes)"))
            for fn, (types, line) in sorted(fns.items()):
                if fn not in exported:
                    out.append(Finding(
                        "RT303", src.rel, line,
                        f"SIGNATURES[{source!r}] names `{fn}`, which "
                        f"csrc/{source}.cu does not export"))
                    continue
                if types is None:
                    out.append(Finding(
                        "RT301", src.rel, line,
                        f"argtypes of `{fn}` cannot be read statically"))
                    continue
                c_args = exported[fn][0]
                if len(types) != len(c_args):
                    out.append(Finding(
                        "RT301", src.rel, line,
                        f"argtypes of `{fn}` has {len(types)} entries; its "
                        f"extern \"C\" declaration in csrc/{source}.cu takes "
                        f"{len(c_args)}"))
                    continue
                for i, (t, c) in enumerate(zip(types, c_args)):
                    if _CTYPES.get(t, t) != c:
                        out.append(Finding(
                            "RT301", src.rel, line,
                            f"argtypes of `{fn}`: argument {i} is {t} "
                            f"({_CTYPES.get(t, t)}), its C declaration "
                            f"takes {c}"))
        folder = Path(src.path).parent
        for other in files:
            if Path(other.path).parent == folder and other is not src:
                _call_findings(other, counts, out)
    return out
