"""RA1xx — lock-discipline checks.

Discovers every ``threading.Lock/RLock/Condition`` attribute assigned in a
class (``self._x = threading.Lock()``), its guard set (from a
``# guards: _a/_b`` comment on the assignment line), and
``Condition(self._lock)`` aliases. Then walks every function tracking
which locks are held at each statement (``with <base>.<attr>:`` scopes
plus ``# held: _x`` function annotations) and emits:

  RA101  lock-order cycles in the cross-module acquisition graph
         (edges from lexically nested ``with`` blocks AND from calls made
         under a held lock to functions that acquire locks, resolved
         through a same-repo call-graph fixpoint)
  RA102  guarded attributes read/written outside a ``with`` on their lock
         (``__init__`` and the lock-creating function are exempt)
  RA103  blocking calls under a held lock: zero-arg ``.result()`` /
         ``.get()`` / ``.join()``, ``.wait()``/``.wait_for()`` with no or
         ``None`` timeout, ``.item()``, ``.block_until_ready()``,
         ``jax.block_until_ready``, ``jax.device_get``, ``np.asarray`` /
         ``np.array``, ``time.sleep``

The lock graph (``LockModel``) is exported for the runtime lock-order
recorder: lock ids are ``file:line`` of the creating assignment, exactly
what the recorder observes from patched ``threading`` factories.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, SourceFile

_LOCK_FACTORIES = ("Lock", "RLock", "Condition")
_GUARDS_RE = re.compile(r"guards:?\s*(.*)")
_HELD_RE = re.compile(r"held:\s*([A-Za-z_]\w*(?:\s*[/,]\s*[A-Za-z_]\w*)*)")


@dataclass
class LockDef:
    lock_id: str                 # "file:line" of the creating assignment
    cls: str                     # "file::ClassName"
    cls_name: str
    canonical: str               # primary attribute name
    attrs: Set[str]              # all aliases ({_lock, _cv})
    kind: str                    # Lock | RLock | Condition
    guards: Set[str]
    file: str
    line: int
    created_in: str              # method that assigned it (usually __init__)

    @property
    def display(self) -> str:
        return f"{self.cls_name}.{self.canonical}"


@dataclass
class LockModel:
    locks: Dict[str, LockDef] = field(default_factory=dict)
    # (cls_key, attr_alias) -> LockDef
    by_class_attr: Dict[Tuple[str, str], LockDef] = field(default_factory=dict)
    # guarded attr name -> lock defs claiming it
    guard_index: Dict[str, List[LockDef]] = field(default_factory=dict)
    # (a_id, b_id) -> (file, line) of one witness acquisition of b under a
    edges: Dict[Tuple[str, str], Tuple[str, int]] = field(default_factory=dict)
    # (cls_key, attr) -> cls_key of the object stored there
    attr_types: Dict[Tuple[str, str], str] = field(default_factory=dict)

    def resolve(self, cls_key: Optional[str], attr: str) -> Optional[LockDef]:
        """Lock def for `<something>.<attr>`: class-scoped when the class
        is known, else by (unique) attribute name across the repo."""
        if cls_key is not None:
            d = self.by_class_attr.get((cls_key, attr))
            if d is not None:
                return d
        cands = {d.lock_id: d for (_, a), d in self.by_class_attr.items()
                 if a == attr}
        if len(cands) == 1:
            return next(iter(cands.values()))
        return None

    def sites(self) -> Set[str]:
        return set(self.locks)

    def edge_pairs(self) -> Set[Tuple[str, str]]:
        return set(self.edges)

    def has_path(self, a: str, b: str) -> bool:
        seen, stack = set(), [a]
        while stack:
            n = stack.pop()
            if n == b:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(y for (x, y) in self.edges if x == n)
        return False


def _call_factory(node: ast.expr, threading_names: Set[str]) -> Optional[str]:
    """'Lock'/'RLock'/'Condition' if `node` is a call to that threading
    factory, else None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if (isinstance(f, ast.Attribute) and f.attr in _LOCK_FACTORIES
            and isinstance(f.value, ast.Name)
            and f.value.id == "threading"):
        return f.attr
    if (isinstance(f, ast.Name) and f.id in _LOCK_FACTORIES
            and f.id in threading_names):
        return f.id
    return None


def _parse_guards(comment: str) -> Set[str]:
    m = _GUARDS_RE.search(comment)
    if not m:
        return set()
    return set(re.findall(r"[A-Za-z_]\w*", m.group(1)))


def _self_attr(node: ast.expr) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _threading_imports(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.module == "threading":
            out.update(a.asname or a.name for a in n.names)
    return out


# -- model construction --------------------------------------------------

def build_model(files: List[SourceFile]) -> LockModel:
    model = LockModel()
    class_names: Dict[str, str] = {}          # simple name -> cls_key
    classes: List[Tuple[SourceFile, ast.ClassDef]] = []
    for src in files:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                key = f"{src.rel}::{node.name}"
                class_names[node.name] = key
                classes.append((src, node))

    for src, cls in classes:
        cls_key = f"{src.rel}::{cls.name}"
        tnames = _threading_imports(src.tree)
        for fn in [n for n in cls.body if isinstance(n, ast.FunctionDef)]:
            for stmt in ast.walk(fn):
                if not isinstance(stmt, ast.Assign):
                    continue
                attr = (_self_attr(stmt.targets[0])
                        if len(stmt.targets) == 1 else None)
                if attr is None:
                    continue
                kind = _call_factory(stmt.value, tnames)
                if kind is not None:
                    # Condition(self._x) aliases an existing lock
                    if kind == "Condition" and stmt.value.args:
                        base = _self_attr(stmt.value.args[0])
                        existing = model.by_class_attr.get((cls_key, base))
                        if existing is not None:
                            existing.attrs.add(attr)
                            model.by_class_attr[(cls_key, attr)] = existing
                            extra = _parse_guards(
                                src.comment_at(stmt.lineno))
                            existing.guards |= extra
                            continue
                    d = LockDef(
                        lock_id=f"{src.rel}:{stmt.lineno}",
                        cls=cls_key, cls_name=cls.name, canonical=attr,
                        attrs={attr}, kind=kind,
                        guards=_parse_guards(src.comment_at(stmt.lineno)),
                        file=src.rel, line=stmt.lineno, created_in=fn.name)
                    model.locks[d.lock_id] = d
                    model.by_class_attr[(cls_key, attr)] = d
                    continue
                # self.X = ClassName(...): object attr typing for the
                # cross-class call graph (also `x or ClassName()` defaults)
                vals = (stmt.value.values
                        if isinstance(stmt.value, ast.BoolOp)
                        else [stmt.value])
                for v in vals:
                    if not isinstance(v, ast.Call):
                        continue
                    f = v.func
                    name = (f.id if isinstance(f, ast.Name)
                            else f.attr if isinstance(f, ast.Attribute)
                            else None)
                    if name in class_names:
                        model.attr_types[(cls_key, attr)] = class_names[name]

    for d in model.locks.values():
        for g in d.guards:
            model.guard_index.setdefault(g, []).append(d)
    return model


# -- checking ------------------------------------------------------------

_HeldEntry = Tuple[str, str]            # (lock_id, base expr string)


@dataclass
class _FuncInfo:
    key: str                            # "file::Class.method" / "file::fn"
    cls_key: Optional[str]
    node: ast.FunctionDef
    src: SourceFile
    direct_acquires: Set[str] = field(default_factory=set)
    # (callee_key, (held lock_ids...), line)
    calls: List[Tuple[str, Tuple[str, ...], int]] = field(
        default_factory=list)


class _FuncWalker:
    """Single-function pass: held-lock tracking, RA102/RA103 findings,
    direct acquisitions, and call-graph edges for the fixpoint."""

    BLOCK_FUNCS = {"time.sleep", "jax.block_until_ready", "jax.device_get",
                   "np.asarray", "np.array", "numpy.asarray", "numpy.array"}

    def __init__(self, info: _FuncInfo, model: LockModel,
                 class_names: Dict[str, str], findings: List[Finding]):
        self.info = info
        self.model = model
        self.class_names = class_names
        self.findings = findings
        self.src = info.src
        self.cls_key = info.cls_key
        # local var -> cls_key (from `v = ClassName(...)` assignments and
        # parameter type annotations, incl. string annotations)
        self.local_types: Dict[str, str] = {}
        a = info.node.args
        for arg in (a.posonlyargs + a.args + a.kwonlyargs):
            ann = arg.annotation
            name = None
            if isinstance(ann, ast.Name):
                name = ann.id
            elif isinstance(ann, ast.Attribute):
                name = ann.attr
            elif isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                name = ann.value.strip('"\'')
            if name in class_names:
                self.local_types[arg.arg] = class_names[name]

    # entry -------------------------------------------------------------
    def run(self):
        fn = self.info.node
        held: List[_HeldEntry] = []
        note = _HELD_RE.search(self.src.comment_at(fn.lineno) or "")
        if note:
            for attr in re.findall(r"[A-Za-z_]\w*", note.group(1)):
                d = self.model.resolve(self.cls_key, attr)
                if d is not None:
                    held.append((d.lock_id, "self"))
        for stmt in fn.body:
            self._stmt(stmt, held)

    # helpers -----------------------------------------------------------
    def _resolve_lock_expr(self, expr: ast.expr
                           ) -> Optional[Tuple[str, str]]:
        """(lock_id, base_str) if `expr` is `<base>.<lock attr>`."""
        if not isinstance(expr, ast.Attribute):
            return None
        base_str = ast.unparse(expr.value)
        cls_key = None
        if base_str == "self":
            cls_key = self.cls_key
        else:
            cls_key = self._expr_cls(expr.value)
        d = self.model.resolve(cls_key, expr.attr)
        if d is None or expr.attr not in d.attrs:
            return None
        if base_str == "self" and cls_key is not None and d.cls != cls_key:
            return None          # same attr name, different class
        return d.lock_id, base_str

    def _expr_cls(self, expr: ast.expr) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return self.local_types.get(expr.id)
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and self.cls_key is not None:
            return self.model.attr_types.get((self.cls_key, expr.attr))
        return None

    def _lock_name(self, lock_id: str) -> str:
        return self.model.locks[lock_id].display

    def _emit(self, rule: str, line: int, msg: str):
        self.findings.append(Finding(rule, self.src.rel, line, msg))

    # statement walk ----------------------------------------------------
    def _stmt(self, stmt: ast.stmt, held: List[_HeldEntry]):
        if isinstance(stmt, ast.With):
            pushed = 0
            for item in stmt.items:
                r = self._resolve_lock_expr(item.context_expr)
                if r is None:
                    self._expr(item.context_expr, held)
                    continue
                lock_id, base = r
                self.info.direct_acquires.add(lock_id)
                self._note_acquire(lock_id, held, item.context_expr.lineno)
                held.append((lock_id, base))
                pushed += 1
            for s in stmt.body:
                self._stmt(s, held)
            for _ in range(pushed):
                held.pop()
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: body executes later; analyze with no held locks
            for s in stmt.body:
                self._stmt(s, [])
            return
        if isinstance(stmt, ast.Assign):
            # local object typing for callee resolution
            if (len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)):
                f = stmt.value.func
                name = (f.id if isinstance(f, ast.Name)
                        else f.attr if isinstance(f, ast.Attribute) else None)
                if name in self.class_names:
                    self.local_types[stmt.targets[0].id] = \
                        self.class_names[name]
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._stmt(child, held)
            elif isinstance(child, ast.expr):
                self._expr(child, held)
            elif isinstance(child, (ast.excepthandler, ast.match_case)):
                for s in child.body:
                    self._stmt(s, held)

    def _note_acquire(self, lock_id: str, held: List[_HeldEntry],
                      line: int):
        for h, _ in held:
            if h == lock_id:
                d = self.model.locks[lock_id]
                if d.kind == "Lock":       # non-reentrant: self-deadlock
                    self.model.edges.setdefault((h, lock_id),
                                                (self.src.rel, line))
                continue
            self.model.edges.setdefault((h, lock_id), (self.src.rel, line))

    # expression walk ----------------------------------------------------
    def _expr(self, expr: ast.expr, held: List[_HeldEntry]):
        # Lambdas are excluded from held-lock checks (their bodies run
        # later, maybe not under the locks held here) but still feed the
        # call graph: a sort-key lambda executes inside the enclosing
        # call, so `min(key=lambda i: self._key(...))` must contribute
        # pop -> _key for the lock-order fixpoint.
        stack: List[Tuple[ast.AST, bool]] = [(expr, False)]
        while stack:
            node, in_lambda = stack.pop()
            if isinstance(node, ast.Lambda):
                in_lambda = True
            elif isinstance(node, ast.Attribute) and not in_lambda:
                self._check_guarded(node, held)
            elif isinstance(node, ast.Call):
                if in_lambda:
                    callee = self._callee_key(node)
                    if callee is not None:
                        self.info.calls.append(
                            (callee, tuple(h for h, _ in held),
                             node.lineno))
                else:
                    self._check_call(node, held)
            stack.extend((c, in_lambda)
                         for c in ast.iter_child_nodes(node))

    def _check_guarded(self, node: ast.Attribute, held: List[_HeldEntry]):
        attr = node.attr
        defs = self.model.guard_index.get(attr)
        if not defs:
            return
        base_str = ast.unparse(node.value)
        if base_str == "self":
            cands = [d for d in defs if d.cls == self.cls_key]
        else:
            cands = defs if len({d.lock_id for d in defs}) == 1 else []
        if len(cands) != 1:
            return
        d = cands[0]
        fn = self.info.node.name
        if fn == "__init__" or fn == d.created_in:
            return
        # the guard is satisfied when the SAME lock def is held, taken on
        # the same base object (`with self._lock:` covers `self._x`;
        # `with eng._stage_lock:` covers `eng._sched`); base expressions
        # are compared textually
        if any(h == d.lock_id and b == base_str for h, b in held):
            return
        self._emit("RA102", node.lineno,
                   f"`{base_str}.{attr}` (guarded by `{d.display}`) "
                   f"accessed outside `with {d.canonical}`")

    def _check_call(self, node: ast.Call, held: List[_HeldEntry]):
        # call-graph edges recorded regardless of held (fixpoint input)
        callee = self._callee_key(node)
        if callee is not None:
            self.info.calls.append(
                (callee, tuple(h for h, _ in held), node.lineno))
        if not held:
            return
        inner = self._lock_name(held[-1][0])
        f = node.func
        dotted = ast.unparse(f) if isinstance(f, (ast.Attribute,
                                                  ast.Name)) else ""
        if dotted in self.BLOCK_FUNCS:
            self._emit("RA103", node.lineno,
                       f"blocking `{dotted}(...)` while holding `{inner}`")
            return
        if not isinstance(f, ast.Attribute):
            return
        m = f.attr
        nargs, kw = len(node.args), {k.arg for k in node.keywords}
        has_timeout = "timeout" in kw and not any(
            k.arg == "timeout" and isinstance(k.value, ast.Constant)
            and k.value.value is None for k in node.keywords)
        if m in ("result", "get", "join", "item") and nargs == 0 \
                and not has_timeout:
            what = {"result": "Future.result()", "get": "queue.get()",
                    "join": "join()", "item": ".item() device sync"}[m]
            self._emit("RA103", node.lineno,
                       f"blocking `{what}` with no timeout while "
                       f"holding `{inner}`")
        elif m == "wait" and nargs == 0 and not has_timeout:
            self._emit("RA103", node.lineno,
                       f"blocking `.wait()` with no timeout while "
                       f"holding `{inner}`")
        elif m == "wait_for" and nargs <= 1 and not has_timeout:
            self._emit("RA103", node.lineno,
                       f"blocking `.wait_for()` with no timeout while "
                       f"holding `{inner}`")
        elif m == "block_until_ready" and nargs == 0:
            self._emit("RA103", node.lineno,
                       f"blocking `.block_until_ready()` while "
                       f"holding `{inner}`")

    def _callee_key(self, node: ast.Call) -> Optional[str]:
        f = node.func
        if isinstance(f, ast.Name):
            return f"{self.src.rel}::{f.id}"
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and self.cls_key is not None:
                return f"{self.cls_key}.{f.attr}"
            ck = self._expr_cls(f.value)
            if ck is not None:
                return f"{ck}.{f.attr}"
        return None


def check(files: List[SourceFile], model: LockModel) -> List[Finding]:
    findings: List[Finding] = []
    class_names: Dict[str, str] = {}
    funcs: Dict[str, _FuncInfo] = {}
    for src in files:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                class_names[node.name] = f"{src.rel}::{node.name}"
    for src in files:
        for node in src.tree.body:
            if isinstance(node, ast.FunctionDef):
                key = f"{src.rel}::{node.name}"
                funcs[key] = _FuncInfo(key, None, node, src)
            elif isinstance(node, ast.ClassDef):
                cls_key = f"{src.rel}::{node.name}"
                for fn in node.body:
                    if isinstance(fn, ast.FunctionDef):
                        key = f"{cls_key}.{fn.name}"
                        funcs[key] = _FuncInfo(key, cls_key, fn, src)

    for info in funcs.values():
        _FuncWalker(info, model, class_names, findings).run()

    # `# held:` annotations also feed the call graph: calling an annotated
    # function means acquiring nothing, but a call made WHILE holding locks
    # into a function that acquires more is an ordering edge — fixpoint:
    eff: Dict[str, Set[str]] = {k: set(i.direct_acquires)
                                for k, i in funcs.items()}
    changed = True
    while changed:
        changed = False
        for k, info in funcs.items():
            for callee, _, _ in info.calls:
                extra = eff.get(callee)
                if extra and not extra <= eff[k]:
                    eff[k] |= extra
                    changed = True
    for info in funcs.values():
        for callee, held_ids, line in info.calls:
            if not held_ids:
                continue
            for b in eff.get(callee, ()):
                for a in held_ids:
                    if a == b:
                        d = model.locks[a]
                        if d.kind != "Lock":
                            continue       # reentrant re-acquire is fine
                    model.edges.setdefault((a, b), (info.src.rel, line))

    findings += _cycle_findings(model)
    return findings


def _cycle_findings(model: LockModel) -> List[Finding]:
    """One RA101 per strongly-connected component with a cycle."""
    nodes = sorted({n for e in model.edges for n in e})
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]
    adj = {n: sorted(y for (x, y) in model.edges if x == n) for n in nodes}

    def strongconnect(v: str):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in adj[v]:
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            sccs.append(comp)

    for n in nodes:
        if n not in index:
            strongconnect(n)

    out: List[Finding] = []
    for comp in sccs:
        cyclic = len(comp) > 1 or (comp[0], comp[0]) in model.edges
        if not cyclic:
            continue
        names = sorted(model.locks[c].display for c in comp)
        witness = min((model.edges[(a, b)] for a in comp for b in comp
                       if (a, b) in model.edges),
                      key=lambda t: (t[0], t[1]))
        out.append(Finding("RA101", witness[0], witness[1],
                           "lock-order cycle: " + " <-> ".join(names)))
    return out
